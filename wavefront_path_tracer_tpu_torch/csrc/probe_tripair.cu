// Triangle-pair probe: the pair test forms at the production carry.
//
// Replaces exp/tripair.py:233 `measure` (its kernel `make_kernel`, bodies
// `tri_mt` (90) and `tri_mx` (141)): T1, two-sided Moller-Trumbore over
// the 18-column table (the port's pair, common.cuh tri_test); T1p, T1 with
// the albedo and material packed 16:16 into a parallel int32 table; T2,
// the matrix form over rows of inv([e1, e2, n]); T2p, T2 packed.  Each
// carries the whole winner: 11 fields, 13 when packed.  The rep loop
// alternates table halves on the rep counter and moves the origin by
// rep * 1e-7, as the reference does, so no load and no test can be
// hoisted out of it.
//
// What bounds it: FP32 issue, with an IEEE divide a pair (T1 46 FP32
// operations and the divide, T2 39 and the divide), the carry compares,
// and 9 (T1) or 12 (T2) loads of the triangle's geometry a triangle.  The
// 512-triangle table (36 KB) sits in L1, and every thread of a warp reads
// the same row, so a load is one broadcast.
//
// The design for this card: each thread carries kRays rays, so a
// triangle's words are loaded once for kRays pairs, and ptxas
// interleaves the rays' independent arithmetic; each ray's operations
// keep their order, so its bits are those of one ray a thread.  The
// divide stays nvcc's (a fast path, and a branch to a slow path that
// these tables never take): a branchless reciprocal equal to 1.0f / x
// on all 2^32 floats cost more instructions than the branch did
// (PERF.md §6).  The carry is updated under one branch a triangle,
// taken where any of the thread's rays has a nearer hit (rare: a ray
// hits about one triangle of the table in a thousand), which loads the
// carry words once and hands them to each ray that took the hit.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCols = 18;
constexpr int kThreads = 256;
constexpr int kRays = 4;             // rays a thread
constexpr int kRaysBlock = kThreads * kRays;
constexpr float kTMin = 0.001f;
constexpr float kTFar = 1e30f;

struct Carry {
  float t = kTFar;
  float ar = 0.0f, ag = 0.0f, ab = 0.0f, fz = 0.0f, io = 0.0f, mt = 0.0f;
  float nx = 0.0f, ny = 0.0f, nz = 0.0f, it = 0.0f;
  int pk0 = 0, pk1 = 0;
};

// A ray: origin and direction.
struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// tri_mt's geometry words: v0, e1, e2 (columns 0-8).
struct MtTri {
  float v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z;
};

__device__ __forceinline__ MtTri load_mt(const float* __restrict__ row) {
  return {__ldg(row), __ldg(row + 1), __ldg(row + 2),
          __ldg(row + 3), __ldg(row + 4), __ldg(row + 5),
          __ldg(row + 6), __ldg(row + 7), __ldg(row + 8)};
}

// tri_mt: t of the two-sided Moller-Trumbore test, or kTFar; the normal
// carried is the table's (columns 9-11).
__device__ __forceinline__ float tri_t(const MtTri& g, const Ray& r) {
  const float pvx = r.dy * g.e2z - r.dz * g.e2y;
  const float pvy = r.dz * g.e2x - r.dx * g.e2z;
  const float pvz = r.dx * g.e2y - r.dy * g.e2x;
  const float det = g.e1x * pvx + g.e1y * pvy + g.e1z * pvz;
  const bool ok = fabsf(det) > 1e-9f;
  const float inv_det = ok ? 1.0f / det : 0.0f;
  const float tvx = r.ox - g.v0x;
  const float tvy = r.oy - g.v0y;
  const float tvz = r.oz - g.v0z;
  const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
  const float qvx = tvy * g.e1z - tvz * g.e1y;
  const float qvy = tvz * g.e1x - tvx * g.e1z;
  const float qvz = tvx * g.e1y - tvy * g.e1x;
  const float v = (r.dx * qvx + r.dy * qvy + r.dz * qvz) * inv_det;
  const float tt = (g.e2x * qvx + g.e2y * qvy + g.e2z * qvz) * inv_det;
  const bool valid = ok & (u >= 0.0f) & (v >= 0.0f) & (u + v <= 1.0f)
      & (tt > kTMin);
  return valid ? tt : kTFar;
}

// tri_mx's geometry words: v0 and the rows r0, r1, r2 (columns 0-11).
struct MxTri {
  float v0x, v0y, v0z, r0x, r0y, r0z, r1x, r1y, r1z, r2x, r2y, r2z;
};

__device__ __forceinline__ MxTri load_mx(const float* __restrict__ row) {
  return {__ldg(row), __ldg(row + 1), __ldg(row + 2),
          __ldg(row + 3), __ldg(row + 4), __ldg(row + 5),
          __ldg(row + 6), __ldg(row + 7), __ldg(row + 8),
          __ldg(row + 9), __ldg(row + 10), __ldg(row + 11)};
}

// tri_mx: the matrix form; the normal carried is r2 (columns 9-11).
__device__ __forceinline__ float tri_t(const MxTri& g, const Ray& r) {
  const float sx = r.ox - g.v0x;
  const float sy = r.oy - g.v0y;
  const float sz = r.oz - g.v0z;
  const float hd = g.r2x * r.dx + g.r2y * r.dy + g.r2z * r.dz;
  const float h0 = g.r2x * sx + g.r2y * sy + g.r2z * sz;
  const bool ok = fabsf(hd) > 1e-12f;
  const float tt = -h0 / (ok ? hd : 1.0f);
  const float u = (g.r0x * sx + g.r0y * sy + g.r0z * sz)
      + tt * (g.r0x * r.dx + g.r0y * r.dy + g.r0z * r.dz);
  const float v = (g.r1x * sx + g.r1y * sy + g.r1z * sz)
      + tt * (g.r1x * r.dx + g.r1y * r.dy + g.r1z * r.dz);
  const bool valid = ok & (u >= 0.0f) & (v >= 0.0f) & (u + v <= 1.0f)
      & (tt > kTMin);
  return valid ? tt : kTFar;
}

// One triangle against the thread's kRays rays, and the winner carry as
// tri_mt / tri_mx update it: unpacked, albedo, fuzz, ior and material
// from columns 12-17; packed, fuzz and ior from 15-16 and the two packed
// words, albedo and material left as they were.
template <bool kMatrix, bool kPacked>
__device__ __forceinline__ void triangle(const float* __restrict__ tab,
                                         const int* __restrict__ pk, int tri,
                                         const Ray (&ray)[kRays],
                                         Carry (&c)[kRays]) {
  const float* row = tab + tri * kCols;
  float tt[kRays];
  if constexpr (kMatrix) {
    const MxTri g = load_mx(row);
#pragma unroll
    for (int r = 0; r < kRays; ++r) tt[r] = tri_t(g, ray[r]);
  } else {
    const MtTri g = load_mt(row);
#pragma unroll
    for (int r = 0; r < kRays; ++r) tt[r] = tri_t(g, ray[r]);
  }
  bool take[kRays];
  bool any = false;
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    take[r] = tt[r] < c[r].t;
    any |= take[r];
  }
  if (any) {
    const float fz = __ldg(row + 15), io = __ldg(row + 16);
    const float nx = __ldg(row + 9), ny = __ldg(row + 10);
    const float nz = __ldg(row + 11);
    float ar = 0.0f, ag = 0.0f, ab = 0.0f, mt = 0.0f;
    int pk0 = 0, pk1 = 0;
    if constexpr (!kPacked) {
      ar = __ldg(row + 12);
      ag = __ldg(row + 13);
      ab = __ldg(row + 14);
      mt = __ldg(row + 17);
    } else {
      pk0 = __ldg(pk + 2 * tri);
      pk1 = __ldg(pk + 2 * tri + 1);
    }
#pragma unroll
    for (int r = 0; r < kRays; ++r) {
      if (!take[r]) continue;
      c[r].t = tt[r];
      if constexpr (!kPacked) {
        c[r].ar = ar;
        c[r].ag = ag;
        c[r].ab = ab;
        c[r].mt = mt;
      } else {
        c[r].pk0 = pk0;
        c[r].pk1 = pk1;
      }
      c[r].fz = fz;
      c[r].io = io;
      c[r].nx = nx;
      c[r].ny = ny;
      c[r].nz = nz;
      c[r].it = 1.0f;
    }
  }
}

// Per ray: `reps` sweeps of half the table (rep i sweeps triangles
// [(i % 2) * n_tri / 2, ... + n_tri / 2)), the carry kept across reps,
// then the sum of the carry's fields in the reference's order.  Thread t
// of block b carries rays b * kRaysBlock + r * kThreads + t, r < kRays;
// one past n repeats ray n - 1 and writes nothing.
template <bool kMatrix, bool kPacked>
__global__ void __launch_bounds__(kThreads, 2)
probe_tripair(const float* __restrict__ tab, const int* __restrict__ pk,
              int n_tri, const float* __restrict__ rays, int n, int reps,
              float* __restrict__ out) {
  const int first = blockIdx.x * kRaysBlock + threadIdx.x;
  Ray ray[kRays];
  float ox0[kRays];
  Carry c[kRays];
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const int i = min(first + r * kThreads, n - 1);
    ox0[r] = rays[i];
    ray[r].oy = rays[n + i];
    ray[r].oz = rays[2 * n + i];
    ray[r].dx = rays[3 * n + i];
    ray[r].dy = rays[4 * n + i];
    ray[r].dz = rays[5 * n + i];
  }
  const int half = n_tri / 2;
  for (int rep = 0; rep < reps; ++rep) {
    const int base = (rep % 2) * half;
#pragma unroll
    for (int r = 0; r < kRays; ++r) {
      ray[r].ox = ox0[r] + static_cast<float>(rep) * 1e-7f;
    }
#pragma unroll 1
    for (int k = 0; k < half; ++k) {
      triangle<kMatrix, kPacked>(tab, pk, base + k, ray, c);
    }
  }
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const int i = first + r * kThreads;
    if (i >= n) continue;
    float acc = c[r].t;
    acc = acc + c[r].ar;
    acc = acc + c[r].ag;
    acc = acc + c[r].ab;
    acc = acc + c[r].fz;
    acc = acc + c[r].io;
    acc = acc + c[r].mt;
    acc = acc + c[r].nx;
    acc = acc + c[r].ny;
    acc = acc + c[r].nz;
    acc = acc + c[r].it;
    if constexpr (kPacked) {
      acc = acc + static_cast<float>(c[r].pk0) * 1e-9f;
      acc = acc + static_cast<float>(c[r].pk1) * 1e-9f;
    }
    out[i] = acc;
  }
}

}  // namespace

// The triangle-pair forms over `tab` (n_tri, 18) f32, `pk` (n_tri, 2)
// int32 and `rays` (6, n) f32: `form` 0 T1, 1 T1p, 2 T2, 3 T2p (T2 takes
// the matrix table).  n_tri a multiple of 16.  out (n,) f32.
extern "C" int wpt_probe_tripair_launch(const float* tab, const int* pk,
                                        int n_tri, const float* rays, int n,
                                        int reps, int form, float* out,
                                        void* stream) {
  if (n <= 0) return 0;
  if (n_tri <= 0 || n_tri % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (n + kRaysBlock - 1) / kRaysBlock;
  switch (form) {
    case 0:
      probe_tripair<false, false><<<blocks, kThreads, 0, s>>>(
          tab, pk, n_tri, rays, n, reps, out);
      break;
    case 1:
      probe_tripair<false, true><<<blocks, kThreads, 0, s>>>(
          tab, pk, n_tri, rays, n, reps, out);
      break;
    case 2:
      probe_tripair<true, false><<<blocks, kThreads, 0, s>>>(
          tab, pk, n_tri, rays, n, reps, out);
      break;
    case 3:
      probe_tripair<true, true><<<blocks, kThreads, 0, s>>>(
          tab, pk, n_tri, rays, n, reps, out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
