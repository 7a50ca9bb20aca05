// Sphere-pair probes: the pair issue ceiling and the cond-gated sweeps.
//
// Replaces exp/pair_ceiling.py:89 `measure` (its kernel
// `make_dyn_reps_kernel`, body micro_r2._sm_sweep_rows) and
// exp/micro_r2.py:1106 `run_gated` (W8 `make_kernel_w8`, C8
// `make_kernel_c8`, C9 `make_kernel_c9`).  The TPU kernels swept eight
// spheres on sublanes against 128 rays on lanes; here one thread carries
// one ray through every sphere, so the per-ray minimum that the TPU took
// across sublanes is the thread's own strict-< carry, which keeps the
// lowest index among equal t (the reference's min over t, then over i).
//
// What bounds them: FP32 issue.  Built -fmad=false (ops/_build.py), a
// pair is the instructions the production kernels issue: 18 FP32
// operations for the slimmed quadratic with both roots, 21 for the
// generic one, plus the IEEE square root's sequence, compares, selects
// and the table loads.  The table is 38.4 KB (400 x 24 floats) and every
// thread of a warp reads the same sphere, so a load is one broadcast from
// L1 (`__ldg`) or, for A2, an operand of the constant bank.  Each rep
// moves the ray by a bump, so nothing can be hoisted out of the rep loop.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kS = 400;            // spheres (micro_r2.S)
constexpr int kCols = 24;          // PACKED_SM columns
constexpr int kClusters = 25;      // run_gated: 25 clusters of 16
constexpr int kClusterSize = 16;
constexpr int kCondRows = 8;       // (cluster, row) conds: a row is 128 rays
constexpr int kRayTile = 1024;     // the reference's (8, 128) ray planes
constexpr int kThreads = 256;
constexpr float kTMin = 0.001f;
constexpr float kTFar = 1e30f;
constexpr unsigned kFull = 0xffffffffu;

// A2: tcx, tcy, tcz, kappa of each sphere (6.4 KB of the 64 KB bank).
__constant__ float4 c_spheres[kS];

// The ray terms of the slimmed quadratic (micro_r2._sm_sweep_rows).
struct SlimRay {
  float ox, oy, oz, hdx, hdy, hdz, dd_o, oo2;
};

__device__ __forceinline__ SlimRay slim_ray(float ox, float oy, float oz,
                                            float dx, float dy, float dz) {
  SlimRay r;
  r.ox = ox;
  r.oy = oy;
  r.oz = oz;
  r.hdx = 0.5f * dx;
  r.hdy = 0.5f * dy;
  r.hdz = 0.5f * dz;
  r.dd_o = dx * ox + dy * oy + dz * oz;
  r.oo2 = ox * ox + oy * oy + oz * oz;
  return r;
}

// The slimmed quadratic on (kappa, 2c): t, or kTFar for a miss (the square
// root of a negative disc is NaN, and both compares fail).
__device__ __forceinline__ float slim_t(const SlimRay& r, float tcx,
                                        float tcy, float tcz, float kappa) {
  const float nb = (r.hdx * tcx + r.hdy * tcy + r.hdz * tcz) - r.dd_o;
  const float c_q = (r.oo2 + kappa) - (r.ox * tcx + r.oy * tcy + r.oz * tcz);
  const float disc = nb * nb - c_q;
  const float sq = sqrtf(disc);
  const float t1 = nb - sq;
  const float t2 = nb + sq;
  return t1 > kTMin ? t1 : (t2 > kTMin ? t2 : kTFar);
}

// micro_r2.quadratic, the generic test on (c, r): t, or kTFar.
__device__ __forceinline__ float generic_t(float ox, float oy, float oz,
                                           float dx, float dy, float dz,
                                           float cx, float cy, float cz,
                                           float r) {
  const float ocx = ox - cx;
  const float ocy = oy - cy;
  const float ocz = oz - cz;
  const float b_q = dx * ocx + dy * ocy + dz * ocz;
  const float c_q = ocx * ocx + ocy * ocy + ocz * ocz - r * r;
  const float disc = b_q * b_q - c_q;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  const float t1 = -b_q - sq;
  const float t2 = -b_q + sq;
  const float t = t1 > kTMin ? t1 : (t2 > kTMin ? t2 : kTFar);
  return disc >= 0.0f ? t : kTFar;
}

// The pair ceiling: per ray, sum over reps of (t_min + i_min) over the 400
// spheres, dx bumped by 1e-6 a rep.  kConst: A2, the table in the constant
// bank, every sphere's terms one broadcast each (the TPU baked them as
// immediates); else C6, the table read through L1.  Unrolled in full, A2's
// sweep made ptxas hoist all 1,600 terms out of the rep loop into a 6.9 KB
// stack frame (7,844 bytes of spills; 69 Gpairs/s on an H100 80GB HBM3 at
// 700 W); unrolled by 8, its terms are read where they are used.
template <bool kConst>
__global__ void __launch_bounds__(kThreads)
probe_pair_sweep(const float* __restrict__ tab, const float* __restrict__ rays,
                 int n, int reps, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ox = rays[i], oy = rays[n + i], oz = rays[2 * n + i];
  const float dx0 = rays[3 * n + i], dy = rays[4 * n + i];
  const float dz = rays[5 * n + i];
  float acc = 0.0f;
  float bump = 0.0f;
  for (int rep = 0; rep < reps; ++rep) {
    bump = bump + 1e-6f;
    const SlimRay r = slim_ray(ox, oy, oz, dx0 + bump, dy, dz);
    float best = kTFar;
    float idx = -1.0f;
    if constexpr (kConst) {
#pragma unroll 8
      for (int s = 0; s < kS; ++s) {
        const float4 q = c_spheres[s];
        const float t = slim_t(r, q.x, q.y, q.z, q.w);
        if (t < best) {
          best = t;
          idx = static_cast<float>(s);
        }
      }
    } else {
#pragma unroll 4
      for (int s = 0; s < kS; ++s) {
        const float* row = tab + s * kCols;
        const float t = slim_t(r, __ldg(row + 16), __ldg(row + 17),
                               __ldg(row + 18), __ldg(row + 14));
        if (t < best) {
          best = t;
          idx = static_cast<float>(s);
        }
      }
    }
    acc = acc + (best + idx);
  }
  out[i] = acc;
}

// How a warp decides which clusters to sweep.  In these probes a warp's 32
// rays lie in one row of 128, which is the gates' granularity, so the
// three forms enter the same clusters: they differ in branch form and
// bookkeeping, not in pairs.
enum Gate : int {
  kPerThread = 0,   // each thread branches on its own cond (the shipped cull)
  kVote = 1,        // the warp enters a cluster if any lane's cond holds
  kWorklist = 2,    // the warp's entered clusters as a bit list, __ffs order
};

// Calls sweep(c, entered) for each cluster the warp enters, in ascending
// c; `entered` is the lane's own cond, which gates its updates.
template <int kGate, class Sweep>
__device__ __forceinline__ void gated_clusters(const int* __restrict__ cond,
                                               int row, Sweep&& sweep) {
  if constexpr (kGate == kPerThread) {
    for (int c = 0; c < kClusters; ++c) {
      if (__ldg(cond + c * kCondRows + row) != 0) sweep(c, true);
    }
  } else if constexpr (kGate == kVote) {
    for (int c = 0; c < kClusters; ++c) {
      const bool e = __ldg(cond + c * kCondRows + row) != 0;
      if (__any_sync(kFull, e)) sweep(c, e);
    }
  } else {
    unsigned mine = 0u;
    unsigned list = 0u;
    for (int c = 0; c < kClusters; ++c) {
      const bool e = __ldg(cond + c * kCondRows + row) != 0;
      mine |= static_cast<unsigned>(e) << c;
      if (__ballot_sync(kFull, e) != 0u) list |= 1u << c;
    }
    while (list != 0u) {
      const int c = __ffs(list) - 1;
      list &= list - 1u;
      sweep(c, ((mine >> c) & 1u) != 0u);
    }
  }
}

// run_gated's function: per ray, the nearest hit over the spheres of the
// clusters entered for the ray's row, its t + attr0 + attr9 summed over
// reps.  kGeneric: the W8 form (the generic quadratic, the winner's ten
// attributes carried by selects, dx moved 1e-6 a rep, (t + a0) + a9);
// else the C8/C9 form (the slimmed quadratic, a (t, index) carry and a
// decode of the two attributes, a bump added to dx, t + (a0 + a9)).  n is
// a multiple of 1024, so the grid holds whole warps of rays and every
// thread takes part in the votes.
template <bool kGeneric, int kGate>
__global__ void __launch_bounds__(kThreads)
probe_gated(const float* __restrict__ tab, const int* __restrict__ cond,
            const float* __restrict__ rays, int n, int reps,
            float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = (i % kRayTile) / 128;
  const float ox = rays[i], oy = rays[n + i], oz = rays[2 * n + i];
  const float dx0 = rays[3 * n + i], dy = rays[4 * n + i];
  const float dz = rays[5 * n + i];
  float acc = 0.0f;
  if constexpr (kGeneric) {
    float dxm = dx0;
    for (int rep = 0; rep < reps; ++rep) {
      dxm = dxm + 1e-6f;
      float best = kTFar;
      float b[10];
#pragma unroll
      for (int j = 0; j < 10; ++j) b[j] = 0.0f;
      gated_clusters<kGate>(cond, row, [&](int c, bool e) {
        for (int s = c * kClusterSize; s < (c + 1) * kClusterSize; ++s) {
          const float* q = tab + s * kCols;
          const float t = generic_t(ox, oy, oz, dxm, dy, dz, __ldg(q),
                                    __ldg(q + 1), __ldg(q + 2),
                                    __ldg(q + 3));
          if (e && t < best) {
            best = t;
#pragma unroll
            for (int j = 0; j < 10; ++j) b[j] = __ldg(q + 4 + j);
          }
        }
      });
      acc = acc + best + b[0] + b[9];
    }
  } else {
    float bump = 0.0f;
    for (int rep = 0; rep < reps; ++rep) {
      bump = bump + 1e-6f;
      const SlimRay r = slim_ray(ox, oy, oz, dx0 + bump, dy, dz);
      float best = kTFar;
      int idx = -1;
      gated_clusters<kGate>(cond, row, [&](int c, bool e) {
        for (int s = c * kClusterSize; s < (c + 1) * kClusterSize; ++s) {
          const float* q = tab + s * kCols;
          const float t = slim_t(r, __ldg(q + 16), __ldg(q + 17),
                                 __ldg(q + 18), __ldg(q + 14));
          if (e && t < best) {
            best = t;
            idx = s;
          }
        }
      });
      const float a0 = idx >= 0 ? __ldg(tab + idx * kCols + 4) : 0.0f;
      const float a9 = idx >= 0 ? __ldg(tab + idx * kCols + 13) : 0.0f;
      acc = acc + (best + (a0 + a9));
    }
  }
  out[i] = acc;
}

template <bool kGeneric>
cudaError_t launch_gated(int gate, const float* tab, const int* cond,
                         const float* rays, int n, int reps, float* out,
                         cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  switch (gate) {
    case kPerThread:
      probe_gated<kGeneric, kPerThread><<<blocks, kThreads, 0, stream>>>(
          tab, cond, rays, n, reps, out);
      break;
    case kVote:
      probe_gated<kGeneric, kVote><<<blocks, kThreads, 0, stream>>>(
          tab, cond, rays, n, reps, out);
      break;
    case kWorklist:
      probe_gated<kGeneric, kWorklist><<<blocks, kThreads, 0, stream>>>(
          tab, cond, rays, n, reps, out);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// The pair ceiling over `tab` (400, 24) f32 on the device and `rays` (6, n)
// f32 (o xyz, d xyz planes): C6.  With `tab4` (400, 4) f32, the columns
// tcx, tcy, tcz, kappa on the device, A2: copied into the constant bank on
// the stream first.  out (n,) f32.
extern "C" int wpt_probe_pair_launch(const float* tab, const float* tab4,
                                     const float* rays, int n, int reps,
                                     float* out, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (n + kThreads - 1) / kThreads;
  if (tab4 != nullptr) {
    const cudaError_t err = cudaMemcpyToSymbolAsync(
        c_spheres, tab4, sizeof(float4) * kS, 0, cudaMemcpyDeviceToDevice, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    probe_pair_sweep<true><<<blocks, kThreads, 0, s>>>(nullptr, rays, n, reps,
                                                       out);
  } else {
    probe_pair_sweep<false><<<blocks, kThreads, 0, s>>>(tab, rays, n, reps,
                                                        out);
  }
  return static_cast<int>(cudaGetLastError());
}

// run_gated's function over `tab` (400, 24) f32, `cond` (25 x 8) int32
// (cluster c, ray row r at c * 8 + r), `rays` (6, n) f32 with n a
// multiple of 1024; `generic` selects the W8 form, `gate` the gating.
extern "C" int wpt_probe_gated_launch(const float* tab, const int* cond,
                                      const float* rays, int n, int reps,
                                      int generic, int gate, float* out,
                                      void* stream) {
  if (n <= 0) return 0;
  if (n % kRayTile != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      generic ? launch_gated<true>(gate, tab, cond, rays, n, reps, out, s)
              : launch_gated<false>(gate, tab, cond, rays, n, reps, out, s);
  return static_cast<int>(err);
}
