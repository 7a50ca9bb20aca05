// Triangle-pair probe: the pair test forms at the production carry.
//
// Replaces exp/tripair.py:233 `measure` (its kernel `make_kernel`, bodies
// `tri_mt` (90) and `tri_mx` (141)): T1, two-sided Moller-Trumbore over
// the 18-column table (the port's pair, common.cuh tri_test); T1p, T1 with
// the albedo and material packed 16:16 into a parallel int32 table; T2,
// the matrix form over rows of inv([e1, e2, n]); T2p, T2 packed.  Each
// carries the whole winner: 11 fields, 13 when packed.  One thread carries
// one ray; the rep loop alternates table halves on the rep counter and
// moves the origin by rep * 1e-7, as the reference does, so no load and
// no test can be hoisted out of it.
//
// What bounds it: FP32 issue, with IEEE divides (T1 46 FP32 operations
// and one divide a pair, T2 39 and one), the carry selects, and 12 loads
// of the triangle's geometry a pair.  The 512-triangle table (36 KB) sits
// in L1, and every thread of a warp reads the same row, so a load is one
// broadcast.  The 11-13 carry fields and the ray stay in registers.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCols = 18;
constexpr int kThreads = 256;
constexpr float kTMin = 0.001f;
constexpr float kTFar = 1e30f;

struct Carry {
  float t = kTFar;
  float ar = 0.0f, ag = 0.0f, ab = 0.0f, fz = 0.0f, io = 0.0f, mt = 0.0f;
  float nx = 0.0f, ny = 0.0f, nz = 0.0f, it = 0.0f;
  int pk0 = 0, pk1 = 0;
};

// tri_mt: t of the two-sided Moller-Trumbore test, or kTFar; the normal
// carried is the table's (columns 9-11).
__device__ __forceinline__ float mt_t(const float* __restrict__ row, float ox,
                                      float oy, float oz, float dx, float dy,
                                      float dz) {
  const float v0x = __ldg(row), v0y = __ldg(row + 1), v0z = __ldg(row + 2);
  const float e1x = __ldg(row + 3), e1y = __ldg(row + 4);
  const float e1z = __ldg(row + 5);
  const float e2x = __ldg(row + 6), e2y = __ldg(row + 7);
  const float e2z = __ldg(row + 8);
  const float pvx = dy * e2z - dz * e2y;
  const float pvy = dz * e2x - dx * e2z;
  const float pvz = dx * e2y - dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const bool ok = fabsf(det) > 1e-9f;
  const float inv_det = ok ? 1.0f / det : 0.0f;
  const float tvx = ox - v0x;
  const float tvy = oy - v0y;
  const float tvz = oz - v0z;
  const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  const float v = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
  const float tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
  const bool valid = ok & (u >= 0.0f) & (v >= 0.0f) & (u + v <= 1.0f)
      & (tt > kTMin);
  return valid ? tt : kTFar;
}

// tri_mx: the matrix form; the normal carried is r2 (columns 9-11).
__device__ __forceinline__ float mx_t(const float* __restrict__ row, float ox,
                                      float oy, float oz, float dx, float dy,
                                      float dz) {
  const float v0x = __ldg(row), v0y = __ldg(row + 1), v0z = __ldg(row + 2);
  const float r0x = __ldg(row + 3), r0y = __ldg(row + 4);
  const float r0z = __ldg(row + 5);
  const float r1x = __ldg(row + 6), r1y = __ldg(row + 7);
  const float r1z = __ldg(row + 8);
  const float r2x = __ldg(row + 9), r2y = __ldg(row + 10);
  const float r2z = __ldg(row + 11);
  const float sx = ox - v0x;
  const float sy = oy - v0y;
  const float sz = oz - v0z;
  const float hd = r2x * dx + r2y * dy + r2z * dz;
  const float h0 = r2x * sx + r2y * sy + r2z * sz;
  const bool ok = fabsf(hd) > 1e-12f;
  const float tt = -h0 / (ok ? hd : 1.0f);
  const float u = (r0x * sx + r0y * sy + r0z * sz)
      + tt * (r0x * dx + r0y * dy + r0z * dz);
  const float v = (r1x * sx + r1y * sy + r1z * sz)
      + tt * (r1x * dx + r1y * dy + r1z * dz);
  const bool valid = ok & (u >= 0.0f) & (v >= 0.0f) & (u + v <= 1.0f)
      & (tt > kTMin);
  return valid ? tt : kTFar;
}

// One pair and the winner carry, as tri_mt / tri_mx update it: unpacked,
// albedo, fuzz, ior and material from columns 12-17; packed, fuzz and ior
// from 15-16 and the two packed words, albedo and material left as they
// were.
template <bool kMatrix, bool kPacked>
__device__ __forceinline__ void pair(const float* __restrict__ tab,
                                     const int* __restrict__ pk, int tri,
                                     float ox, float oy, float oz, float dx,
                                     float dy, float dz, Carry& c) {
  const float* row = tab + tri * kCols;
  const float tt = kMatrix ? mx_t(row, ox, oy, oz, dx, dy, dz)
                           : mt_t(row, ox, oy, oz, dx, dy, dz);
  if (tt < c.t) {
    c.t = tt;
    if constexpr (!kPacked) {
      c.ar = __ldg(row + 12);
      c.ag = __ldg(row + 13);
      c.ab = __ldg(row + 14);
      c.mt = __ldg(row + 17);
    } else {
      c.pk0 = __ldg(pk + 2 * tri);
      c.pk1 = __ldg(pk + 2 * tri + 1);
    }
    c.fz = __ldg(row + 15);
    c.io = __ldg(row + 16);
    c.nx = __ldg(row + 9);
    c.ny = __ldg(row + 10);
    c.nz = __ldg(row + 11);
    c.it = 1.0f;
  }
}

// Per ray: `reps` sweeps of half the table (rep i sweeps triangles
// [(i % 2) * n_tri / 2, ... + n_tri / 2)), the carry kept across reps,
// then the sum of the carry's fields in the reference's order.
template <bool kMatrix, bool kPacked>
__global__ void __launch_bounds__(kThreads)
probe_tripair(const float* __restrict__ tab, const int* __restrict__ pk,
              int n_tri, const float* __restrict__ rays, int n, int reps,
              float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ox0 = rays[i], oy = rays[n + i], oz = rays[2 * n + i];
  const float dx = rays[3 * n + i], dy = rays[4 * n + i];
  const float dz = rays[5 * n + i];
  const int half = n_tri / 2;
  Carry c;
  for (int rep = 0; rep < reps; ++rep) {
    const int base = (rep % 2) * half;
    const float ox = ox0 + static_cast<float>(rep) * 1e-7f;
#pragma unroll 4
    for (int k = 0; k < half; ++k) {
      pair<kMatrix, kPacked>(tab, pk, base + k, ox, oy, oz, dx, dy, dz, c);
    }
  }
  float acc = c.t;
  acc = acc + c.ar;
  acc = acc + c.ag;
  acc = acc + c.ab;
  acc = acc + c.fz;
  acc = acc + c.io;
  acc = acc + c.mt;
  acc = acc + c.nx;
  acc = acc + c.ny;
  acc = acc + c.nz;
  acc = acc + c.it;
  if constexpr (kPacked) {
    acc = acc + static_cast<float>(c.pk0) * 1e-9f;
    acc = acc + static_cast<float>(c.pk1) * 1e-9f;
  }
  out[i] = acc;
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
  const int blocks = (n + kThreads - 1) / kThreads;
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
