// Sphere-pair probes: the pair issue ceiling and the cond-gated sweeps.
//
// Replaces exp/pair_ceiling.py:89 `measure` (its kernel
// `make_dyn_reps_kernel`, body micro_r2._sm_sweep_rows) and
// exp/micro_r2.py:1106 `run_gated` (W8 `make_kernel_w8`, C8
// `make_kernel_c8`, C9 `make_kernel_c9`).  The TPU kernels swept eight
// spheres on sublanes against 128 rays on lanes; here a thread carries
// several rays through every sphere, so the per-ray minimum that the TPU
// took across sublanes is each ray's own strict-< carry, which keeps the
// lowest index among equal t (the reference's min over t, then over i).
//
// What bounds them: instruction issue.  Built -fmad=false (ops/_build.py),
// a pair is the instructions the production kernels issue: 18 FP32
// operations for the slimmed quadratic with both roots, 21 for the
// generic one, plus the square root's sequence, compares, selects, the
// table loads, addressing and loop control.  So each thread carries kR
// rays (below): every table word it loads, and every address and
// loop-control instruction, serves kR pairs, and the sphere index stays
// warp-uniform.  A ray's own operations keep their order and its carry is
// its own, so its bits are those of one ray a thread.  The square root is
// probe_math.cuh's branchless `sqrt_rn` (nvcc's sqrtf branches to a slow
// path at every pair, which keeps ptxas from interleaving the rays).  The
// table is 38.4 KB (400 x 24 floats) and every thread of a warp reads the
// same sphere, so a load is one broadcast from L1 (`__ldg`) or, for A2,
// an operand of the constant bank.  Each rep moves the ray by a bump, so
// nothing can be hoisted out of the rep loop.
//
// Layout: a warp takes 32 * kR consecutive rays, lane l the rays l,
// l + 32, ...  With kR <= 4 a warp's rays lie in one row of 128, which is
// the gates' granularity (a (cluster, row) cond), so a thread's rays share
// one cond and the gatings enter exactly the clusters the row enters.  A
// block covers kThreads * kR rays, which divides the reference's tile of
// 1024, and a launch takes whole tiles.
#include <cuda_runtime.h>

#include <cstdint>

#include "probe_math.cuh"

namespace {

using namespace wpt::probe;

constexpr int kS = 400;            // spheres (micro_r2.S)
constexpr int kCols = 24;          // PACKED_SM columns
constexpr int kClusters = 25;      // run_gated: 25 clusters of 16
constexpr int kClusterSize = 16;
constexpr int kCondRows = 8;       // (cluster, row) conds: a row is 128 rays
constexpr int kRowRays = 128;
constexpr int kRayTile = 1024;     // the reference's (8, 128) ray planes
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// Rays a thread and the blocks an SM must hold (__launch_bounds__; ptxas
// -v: no spills), by form: C6, A2, the gated C8/C9 form (slimmed) and W8
// (generic, ten carried attributes a ray).  Chosen on the card against
// R = 1 and 2 and other block counts, in turns (PERF.md §6).
struct Form {
  int rays;
  int blocks;
};
constexpr Form kFormC6{4, 2};
constexpr Form kFormA2{4, 2};
constexpr Form kFormSlim{4, 2};
constexpr Form kFormGeneric{4, 2};

__host__ __device__ constexpr bool covers_tile(Form f) {
  return f.rays * 32 <= kRowRays && kRayTile % (kThreads * f.rays) == 0;
}
static_assert(covers_tile(kFormC6) && covers_tile(kFormA2) &&
                  covers_tile(kFormSlim) && covers_tile(kFormGeneric),
              "a warp's rays in one row, a tile in whole blocks");

__host__ __device__ constexpr Form pair_form(bool constant) {
  return constant ? kFormA2 : kFormC6;
}
__host__ __device__ constexpr Form gated_form(bool generic) {
  return generic ? kFormGeneric : kFormSlim;
}

// A2: tcx, tcy, tcz, kappa of each sphere (6.4 KB of the 64 KB bank).
__constant__ float4 c_spheres[kS];

// The thread's first ray (the layout above); its ray r is first + 32 * r.
template <int kR>
__device__ __forceinline__ int first_ray() {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  return blockIdx.x * (kThreads * kR) + warp * (32 * kR) + lane;
}

// Each ray's strict-< carry of (t, index): the first of equal minima.
template <int kR>
__device__ __forceinline__ void carry(const float (&t)[kR], int s,
                                      float (&best)[kR], int (&idx)[kR]) {
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const bool better = t[r] < best[r];
    best[r] = better ? t[r] : best[r];
    idx[r] = better ? s : idx[r];
  }
}

// The pair ceiling: per ray, sum over reps of (t_min + i_min) over the 400
// spheres, dx bumped by 1e-6 a rep.  kConst: A2, the table in the constant
// bank, every sphere's terms one broadcast each (the TPU baked them as
// immediates); else C6, the table read through L1.  Unrolled in full, A2's
// sweep made ptxas hoist all 1,600 terms out of the rep loop into a 6.9 KB
// stack frame (7,844 bytes of spills; 69 Gpairs/s on an H100 80GB HBM3 at
// 700 W); unrolled by 8, its terms are read where they are used.
template <bool kConst>
__global__ void __launch_bounds__(kThreads, pair_form(kConst).blocks)
probe_pair_sweep(const float* __restrict__ tab, const float* __restrict__ rays,
                 int n, int reps, float* __restrict__ out) {
  constexpr int kR = pair_form(kConst).rays;
  const int first = first_ray<kR>();
  const Rays<kR> ray(rays, n, first, 32);
  float acc[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) acc[r] = 0.0f;
  float bump = 0.0f;
  for (int rep = 0; rep < reps; ++rep) {
    bump = bump + 1e-6f;
    SlimRay sr[kR];
    float best[kR];
    int idx[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      sr[r] = slim_ray(ray.ox[r], ray.oy[r], ray.oz[r], ray.dx[r] + bump,
                       ray.dy[r], ray.dz[r]);
      best[r] = kTFar;
      idx[r] = -1;
    }
    if constexpr (kConst) {
#pragma unroll 8
      for (int s = 0; s < kS; ++s) {
        const float4 q = c_spheres[s];
        float t[kR];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          t[r] = slim_t(sr[r], q.x, q.y, q.z, q.w);
        }
        carry<kR>(t, s, best, idx);
      }
    } else {
#pragma unroll 4
      for (int s = 0; s < kS; ++s) {
        const float* row = tab + s * kCols;
        const float tcx = __ldg(row + 16), tcy = __ldg(row + 17);
        const float tcz = __ldg(row + 18), kappa = __ldg(row + 14);
        float t[kR];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          t[r] = slim_t(sr[r], tcx, tcy, tcz, kappa);
        }
        carry<kR>(t, s, best, idx);
      }
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      acc[r] = acc[r] + (best[r] + static_cast<float>(idx[r]));
    }
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) out[first + 32 * r] = acc[r];
}

// How a warp decides which clusters to sweep.  A warp's rays lie in one
// row of 128, which is the gates' granularity, so the three forms enter
// the same clusters: they differ in branch form and bookkeeping, not in
// pairs.
enum Gate : int {
  kPerThread = 0,   // each thread branches on its own cond (the shipped cull)
  kVote = 1,        // the warp enters a cluster if any lane's cond holds
  kWorklist = 2,    // the warp's entered clusters as a bit list, __ffs order
};

// Calls sweep(c, entered) for each cluster the warp enters, in ascending
// c; `entered` is the thread's cond (its rays' row's), which gates its
// updates.
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
// attributes carried by selects, loaded once a sphere for the thread's
// rays, dx moved 1e-6 a rep, (t + a0) + a9); else the C8/C9 form (the
// slimmed quadratic, a (t, index) carry and a decode of the two
// attributes, a bump added to dx, t + (a0 + a9)).  n is a multiple of
// 1024, so the grid holds whole warps of rays and every thread takes part
// in the votes.
template <bool kGeneric, int kGate>
__global__ void __launch_bounds__(kThreads, gated_form(kGeneric).blocks)
probe_gated(const float* __restrict__ tab, const int* __restrict__ cond,
            const float* __restrict__ rays, int n, int reps,
            float* __restrict__ out) {
  constexpr int kR = gated_form(kGeneric).rays;
  const int first = first_ray<kR>();
  const int row = (first % kRayTile) / kRowRays;   // all the thread's rays'
  Rays<kR> ray(rays, n, first, 32);
  float acc[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) acc[r] = 0.0f;
  if constexpr (kGeneric) {
    for (int rep = 0; rep < reps; ++rep) {
      float best[kR];
      float b[kR][10];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        ray.dx[r] = ray.dx[r] + 1e-6f;
        best[r] = kTFar;
#pragma unroll
        for (int j = 0; j < 10; ++j) b[r][j] = 0.0f;
      }
      gated_clusters<kGate>(cond, row, [&](int c, bool e) {
#pragma unroll 4
        for (int s = c * kClusterSize; s < (c + 1) * kClusterSize; ++s) {
          const float* q = tab + s * kCols;
          const float cx = __ldg(q), cy = __ldg(q + 1), cz = __ldg(q + 2);
          const float cr = __ldg(q + 3);
          float a[10];
#pragma unroll
          for (int j = 0; j < 10; ++j) a[j] = __ldg(q + 4 + j);
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            const float t = generic_t(ray.ox[r], ray.oy[r], ray.oz[r],
                                      ray.dx[r], ray.dy[r], ray.dz[r], cx,
                                      cy, cz, cr);
            const bool better = e && t < best[r];
            best[r] = better ? t : best[r];
#pragma unroll
            for (int j = 0; j < 10; ++j) b[r][j] = better ? a[j] : b[r][j];
          }
        }
      });
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        acc[r] = acc[r] + best[r] + b[r][0] + b[r][9];
      }
    }
  } else {
    float bump = 0.0f;
    for (int rep = 0; rep < reps; ++rep) {
      bump = bump + 1e-6f;
      SlimRay sr[kR];
      float best[kR];
      int idx[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        sr[r] = slim_ray(ray.ox[r], ray.oy[r], ray.oz[r], ray.dx[r] + bump,
                         ray.dy[r], ray.dz[r]);
        best[r] = kTFar;
        idx[r] = -1;
      }
      gated_clusters<kGate>(cond, row, [&](int c, bool e) {
#pragma unroll 4
        for (int s = c * kClusterSize; s < (c + 1) * kClusterSize; ++s) {
          const float* q = tab + s * kCols;
          const float tcx = __ldg(q + 16), tcy = __ldg(q + 17);
          const float tcz = __ldg(q + 18), kappa = __ldg(q + 14);
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            const float t = slim_t(sr[r], tcx, tcy, tcz, kappa);
            const bool better = e && t < best[r];
            best[r] = better ? t : best[r];
            idx[r] = better ? s : idx[r];
          }
        }
      });
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float* w = tab + idx[r] * kCols;
        const float a0 = idx[r] >= 0 ? __ldg(w + 4) : 0.0f;
        const float a9 = idx[r] >= 0 ? __ldg(w + 13) : 0.0f;
        acc[r] = acc[r] + (best[r] + (a0 + a9));
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) out[first + 32 * r] = acc[r];
}

template <bool kGen>
cudaError_t launch_gated(int gate, const float* tab, const int* cond,
                         const float* rays, int n, int reps, float* out,
                         cudaStream_t stream) {
  const int blocks = n / (kThreads * gated_form(kGen).rays);
  switch (gate) {
    case kPerThread:
      probe_gated<kGen, kPerThread><<<blocks, kThreads, 0, stream>>>(
          tab, cond, rays, n, reps, out);
      break;
    case kVote:
      probe_gated<kGen, kVote><<<blocks, kThreads, 0, stream>>>(
          tab, cond, rays, n, reps, out);
      break;
    case kWorklist:
      probe_gated<kGen, kWorklist><<<blocks, kThreads, 0, stream>>>(
          tab, cond, rays, n, reps, out);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// The pair ceiling over `tab` (400, 24) f32 on the device and `rays` (6, n)
// f32 (o xyz, d xyz planes), n a multiple of 1024: C6.  With `tab4`
// (400, 4) f32, the columns tcx, tcy, tcz, kappa on the device, A2: copied
// into the constant bank on the stream first.  out (n,) f32.
extern "C" int wpt_probe_pair_launch(const float* tab, const float* tab4,
                                     const float* rays, int n, int reps,
                                     float* out, void* stream) {
  if (n <= 0) return 0;
  if (n % kRayTile != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tab4 != nullptr) {
    const cudaError_t err = cudaMemcpyToSymbolAsync(
        c_spheres, tab4, sizeof(float4) * kS, 0, cudaMemcpyDeviceToDevice, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    probe_pair_sweep<true><<<n / (kThreads * kFormA2.rays), kThreads, 0,
                              s>>>(nullptr, rays, n, reps, out);
  } else {
    probe_pair_sweep<false><<<n / (kThreads * kFormC6.rays), kThreads, 0,
                               s>>>(tab, rays, n, reps, out);
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
