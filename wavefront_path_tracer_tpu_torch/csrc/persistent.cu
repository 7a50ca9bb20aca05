// Persistent-lane path-tracing kernel for Hopper (sm_90a).
//
// Replaces wavefront_path_tracer_tpu/ops/pallas_kernels.py:
// fused_render_persistent / make_persistent_tile(None) / _persistent_impl,
// with its inlined _intersect_tile here, and _raygen_tile, _shade_tile, the
// sky/miss accumulation, Russian roulette and the PCG helpers in
// common.cuh (shared with baked.cu).  It computes the same
// function: every sample and every bounce of each lane in one launch, with
// the same per-(pixel, sample, bounce) RNG streams, the same nearest-hit
// rule and the same shading formulas.
//
// Design.  One thread owns one lane and loops over its own samples and
// bounces: on SIMT hardware the persistent-lane idea is native, since a
// thread whose path ends regenerates its pixel's next sample with no
// cross-lane work.  Lanes arrive in the 32x32 image-block order of
// models/fused.py:_block_perm, so a warp traces a coherent 32-pixel row of
// one block.  Padding lanes (valid == 0) do no work.  The TPU kernel's lane
// rotation only reorders a pixel's sample sum, so it is not carried.  Each
// thread writes its own three radiance words and one ray counter once: no
// atomics, and the result is deterministic.
//
// What bounds it on this card: FP32 issue.  The brute-force nearest hit
// costs about 25 flops per ray-sphere pair, and every ray tests all spheres
// of the table (486 for book_one_final), so the intersect loop is nearly all
// of the work.  The second cost is divergence across a warp at path ends:
// a warp runs as long as its longest path chain.  The design answers the
// first by keeping the intersect loop lean (one 16-byte load of centre and
// radius per sphere, the winner carried as an index, attributes fetched once
// after the loop) and leaves the table to L1/L2 (486 x 64 B = 31 KB); the
// second by giving each thread its own sample loop, so a thread whose path
// ends early starts its next sample instead of idling until the warp's
// longest path ends.  Shared-memory staging of the table, culling and
// tensor-core work are later steps.
//
// Numerics.  Build without --use_fast_math: the nearest-hit select relies on
// a NaN padding row failing the strict `t < best_t`, and division and sqrt
// stay IEEE (-prec-div=true -prec-sqrt=true, the defaults).  The guards
// before rsqrtf are kept as in the reference.  The RNG is bit-exact with
// ops/rng.py.  The build turns FMA contraction off (-fmad=false): then every
// float result is bit-identical to the plain PyTorch version on the card,
// which is how the kernel is checked.  With contraction, a few deep bounces
// pick another sphere and those paths diverge from the plain version.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using wpt::Hit;
using wpt::kTFar;
using wpt::kTMin;
using wpt::kThreads;

// _intersect_tile (pallas_kernels.py:106): nearest hit over the (S, 16)
// table in table order, strict `<`, so the first index wins ties and a NaN
// padding row (every compare false) never wins.  The winner is carried as
// a row index and its attributes are fetched once after the loop.
struct TableIntersect {
  const float4* rows;
  int n_rows;

  __device__ __forceinline__ bool operator()(
      float ox, float oy, float oz, float dx, float dy, float dz, Hit& h,
      wpt::Counts&) const {
    const float a = dx * dx + dy * dy + dz * dz;
    const float inv_a = 1.0f / a;
    int best = -1;
    float best_t = kTFar;
#pragma unroll 4
    for (int i = 0; i < n_rows; ++i) {
      const float4 s = __ldg(rows + 4 * i);   // centre xyz, radius
      const float ocx = ox - s.x;
      const float ocy = oy - s.y;
      const float ocz = oz - s.z;
      const float b = dx * ocx + dy * ocy + dz * ocz;
      const float c = ocx * ocx + ocy * ocy + ocz * ocz - s.w * s.w;
      const float disc = b * b - a * c;
      const float sq = sqrtf(fmaxf(disc, 0.0f));
      const float t1 = (-b - sq) * inv_a;
      const float t2 = (-b + sq) * inv_a;
      float t = (t1 > kTMin) ? t1 : ((t2 > kTMin) ? t2 : kTFar);
      t = (disc >= 0.0f) ? t : kTFar;
      if (t < best_t) {
        best_t = t;
        best = i;
      }
    }
    if (best < 0) return false;
    const float4 geo = __ldg(rows + 4 * best);       // centre, radius
    const float4 alb = __ldg(rows + 4 * best + 1);   // albedo rgb, fuzz
    const float4 mat = __ldg(rows + 4 * best + 2);   // ior, mat_type
    h.t = best_t;
    h.cx = geo.x;
    h.cy = geo.y;
    h.cz = geo.z;
    h.inv_r = 1.0f / geo.w;
    h.ar = alb.x;
    h.ag = alb.y;
    h.ab = alb.z;
    h.fuzz = alb.w;
    h.ior = mat.x;
    h.mt = mat.y;
    return true;
  }
};

// Eight blocks per SM cap the kernel at 64 registers a thread.  Without
// the cap the loop of common.cuh takes 72, and the lower occupancy costs
// about 3% of kernel time (PERF.md).
__global__ void __launch_bounds__(kThreads, 8)
persistent_kernel(const wpt::LaneParams p, const TableIntersect isect) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= p.n_lanes) return;
  wpt::trace_lane(p, lane, isect);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The
// wrapper (ops/fused_kernels.py) checks shapes, types and alignment.
extern "C" int wpt_persistent_launch(
    const float* scene, int n_rows, const float* cam,
    const uint32_t* pix, const float* xs, const float* ys,
    const float* valid, const uint32_t* soff,
    float* rad_r, float* rad_g, float* rad_b, int* rays, int n_lanes,
    uint32_t frame, uint32_t sample_base, uint32_t max_bounces,
    uint32_t n_samples, uint32_t rr_start, float rr_floor, float clamp,
    int stratified, void* stream) {
  if (n_lanes <= 0) return 0;
  const wpt::LaneParams p{cam, pix, xs, ys, valid, soff,
                          rad_r, rad_g, rad_b, rays, nullptr, nullptr,
                          n_lanes, frame, sample_base, max_bounces,
                          n_samples, rr_start, rr_floor, clamp, stratified};
  const TableIntersect isect{reinterpret_cast<const float4*>(scene), n_rows};
  const int blocks = (n_lanes + kThreads - 1) / kThreads;
  persistent_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(p, isect);
  return static_cast<int>(cudaGetLastError());
}
