// Persistent-lane path tracing over a baked scene, for Hopper (sm_90a).
//
// Replaces wavefront_path_tracer_tpu/ops/pallas_kernels.py:
// fused_render_baked (3157) with either of its intersects,
// baked_culled_intersect (831) or baked_intersect (612), spheres only.
// The persistent body (samples, bounces, raygen, shade, sky, clamp,
// roulette) is common.cuh's, the same as persistent.cu's.
//
// "Baked" on Hopper is a table, not code.  The TPU unrolled the scene into
// the kernel as vector immediates because dynamic scalar loads from its
// vector memory cost about ten times the math.  Here a load from L1 is
// cheap, so ops/bake.py keeps what the bake computes (visit order, the
// globals split, cluster and super boxes, the slab, shifted centres and
// kappa, far-root elision flags, sign-only 1/r, decoded packed albedo) in
// device tables that the kernel reads with __ldg.  Book_one_final's item
// table is 39 KB; L1 and L2 hold it.
//
// Item table, (n_items, 20) f32, five float4 per item:
//   q0  culled: c' = c - shift (xyz), kappa = |c'|^2 - r^2
//       unculled: centre (xyz), r * r
//   q1  elide flag (1 = far root elided); culled: 2c' (xyz), the
//       reference's folded constant 2.0 * cxp; unculled: 0
//   q2  world centre (xyz), ior
//   q3  albedo rgb, fuzz
//   q4  1/r sign, mat_type, 0, 0
// The pair loop reads q0 and q1; q2-q4 are read once, for the winner.
// Boxes are (n, 8) f32 rows (lo xyz, 0, hi xyz, 0); ranges are (n, 2)
// int32 rows (first, count) into the item table (clusters) or the cluster
// table (supers).  consts: shift xyz, slab lo xyz, slab hi xyz.
//
// Culling is per thread.  A thread enters a cluster (or super) only when
// its own ray's box cond holds against its own current best_t:
//   (c_min <= c_max) & (c_max > T_MIN) & (max(c_min, 0) < min(best_t, t_exit))
// (pallas_kernels.py:1261-1272).  The TPU's whole-tile consensus and its
// one-batch-stale cap are TPU scheduling and are not carried, so a ray's
// result does not depend on which rays share its warp, and the kernel
// agrees bit for bit with its plain version (ops/baked_kernels.py).  The
// box min/max propagate NaN as jnp/torch minimum/maximum do: an
// axis-parallel ray can give (lo - o) * inf = NaN, and then the cond is
// false and the cluster is skipped, as in the reference.
//
// What bounds it on this card: FP32 issue over ray-primitive pairs plus
// the box tests, and warp divergence once the rays of a warp disagree on a
// cluster (a warp runs a cluster's 16 tests if any of its threads enters).
// The design keeps the pair loop lean (a 32-byte read per pair, the winner
// carried as an index, its attributes fetched once after the sweep) and
// leans on the 32x32 block lane order of models/fused.py, which puts rays
// of one image block, whose primary rays share a frustum, in one warp.
// Warp-vote consensus, shared-memory staging and generated per-scene
// source are later steps.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using wpt::Counts;
using wpt::Hit;
using wpt::kTFar;
using wpt::kTMin;
using wpt::kThreads;

constexpr int kItem = 5;  // float4 per item row

// jnp.minimum / jnp.maximum: NaN in, NaN out (fminf/fmaxf drop a NaN).
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ void fill_hit(const float4* __restrict__ items,
                                         int best, float best_t, Hit& h) {
  const float4 q2 = __ldg(items + kItem * best + 2);
  const float4 q3 = __ldg(items + kItem * best + 3);
  const float4 q4 = __ldg(items + kItem * best + 4);
  h.t = best_t;
  h.cx = q2.x;
  h.cy = q2.y;
  h.cz = q2.z;
  h.inv_r = q4.x;
  h.ar = q3.x;
  h.ag = q3.y;
  h.ab = q3.z;
  h.fuzz = q3.w;
  h.ior = q2.w;
  h.mt = q4.y;
}

// baked_intersect.intersect (pallas_kernels.py:672-745): the generic
// quadratic with inv_a and the disc >= 0 select, in scene order.
struct UnculledIntersect {
  const float4* items;
  int n_items;

  __device__ __forceinline__ bool operator()(
      float ox, float oy, float oz, float dx, float dy, float dz, Hit& h,
      Counts&) const {
    const float a = dx * dx + dy * dy + dz * dz;
    const float inv_a = 1.0f / a;
    int best = -1;
    float best_t = kTFar;
    for (int i = 0; i < n_items; ++i) {
      const float4 q = __ldg(items + kItem * i);
      const float elide = __ldg(items + kItem * i + 1).x;
      const float ocx = ox - q.x;
      const float ocy = oy - q.y;
      const float ocz = oz - q.z;
      const float b = dx * ocx + dy * ocy + dz * ocz;
      const float c = ocx * ocx + ocy * ocy + ocz * ocz - q.w;
      const float disc = b * b - a * c;
      const float sq = sqrtf(fmaxf(disc, 0.0f));
      const float t1 = (-b - sq) * inv_a;
      float t;
      if (t1 > kTMin) {
        t = t1;
      } else if (elide != 0.0f) {
        t = kTFar;
      } else {
        const float t2 = (-b + sq) * inv_a;
        t = (t2 > kTMin) ? t2 : kTFar;
      }
      t = (disc >= 0.0f) ? t : kTFar;
      if (t < best_t) {
        best_t = t;
        best = i;
      }
    }
    if (best < 0) return false;
    fill_hit(items, best, best_t, h);
    return true;
  }
};

// baked_culled_intersect.intersect (pallas_kernels.py:1063-1466).
struct CulledIntersect {
  const float4* items;
  int n_globals;
  const float4* cboxes;
  const int2* cranges;
  int n_clusters;
  const float4* sboxes;
  const int2* sranges;
  int n_supers;             // 0: one-level sweep
  float shx, shy, shz;
  float3 slab_lo, slab_hi;

  struct Ray {
    float ox, oy, oz, dx, dy, dz;
    float oxp, oyp, ozp, dd_o, oo2;
    float idx, idy, idz;
  };

  // The slimmed quadratic of sphere_tests (1090-1130), in its order of
  // operations: unit directions, NaN from sqrt of a negative disc falls
  // through both selects to T_FAR.
  __device__ __forceinline__ void test(const Ray& r, int i, float& best_t,
                                       int& best) const {
    const float4 q = __ldg(items + kItem * i);
    const float4 q1 = __ldg(items + kItem * i + 1);
    const float nb = (r.dx * q.x + r.dy * q.y + r.dz * q.z) - r.dd_o;
    const float c_q = (r.oo2 + q.w)
        - (r.oxp * q1.y + r.oyp * q1.z + r.ozp * q1.w);
    const float disc = nb * nb - c_q;
    const float sq = sqrtf(disc);
    const float t1 = nb - sq;
    float t;
    if (t1 > kTMin) {
      t = t1;
    } else if (q1.x != 0.0f) {
      t = kTFar;
    } else {
      const float t2 = nb + sq;
      t = (t2 > kTMin) ? t2 : kTFar;
    }
    if (t < best_t) {
      best_t = t;
      best = i;
    }
  }

  // box_range (1245-1259): (entry, exit) by the slab method.
  __device__ __forceinline__ void box_range(const Ray& r, float4 lo,
                                            float4 hi, float& tmin,
                                            float& tmax) const {
    const float tx0 = (lo.x - r.ox) * r.idx;
    const float tx1 = (hi.x - r.ox) * r.idx;
    tmin = nan_min(tx0, tx1);
    tmax = nan_max(tx0, tx1);
    const float ty0 = (lo.y - r.oy) * r.idy;
    const float ty1 = (hi.y - r.oy) * r.idy;
    tmin = nan_max(tmin, nan_min(ty0, ty1));
    tmax = nan_min(tmax, nan_max(ty0, ty1));
    const float tz0 = (lo.z - r.oz) * r.idz;
    const float tz1 = (hi.z - r.oz) * r.idz;
    tmin = nan_max(tmin, nan_min(tz0, tz1));
    tmax = nan_min(tmax, nan_max(tz0, tz1));
  }

  // cluster_cond (1269-1272) against this ray's own cap.
  __device__ __forceinline__ bool enters(const Ray& r, const float4* boxes,
                                         int k, float cap) const {
    float c_min, c_max;
    box_range(r, __ldg(boxes + 2 * k), __ldg(boxes + 2 * k + 1), c_min,
              c_max);
    return (c_min <= c_max) & (c_max > kTMin)
        & (nan_max(c_min, 0.0f) < cap);
  }

  __device__ __forceinline__ void sweep_cluster(const Ray& r, int c,
                                                float& best_t, int& best,
                                                Counts& counts) const {
    ++counts.clusters;
    const int2 range = __ldg(cranges + c);
    for (int i = range.x; i < range.x + range.y; ++i)
      test(r, i, best_t, best);
  }

  __device__ __forceinline__ bool operator()(
      float ox, float oy, float oz, float dx, float dy, float dz, Hit& h,
      Counts& counts) const {
    Ray r;
    r.ox = ox; r.oy = oy; r.oz = oz;
    r.dx = dx; r.dy = dy; r.dz = dz;
    r.oxp = ox - shx;
    r.oyp = oy - shy;
    r.ozp = oz - shz;
    r.dd_o = dx * r.oxp + dy * r.oyp + dz * r.ozp;
    r.oo2 = r.oxp * r.oxp + r.oyp * r.oyp + r.ozp * r.ozp;
    int best = -1;
    float best_t = kTFar;
    for (int i = 0; i < n_globals; ++i) test(r, i, best_t, best);
    if (n_clusters > 0) {
      r.idx = 1.0f / dx;
      r.idy = 1.0f / dy;
      r.idz = 1.0f / dz;
      // slab_exit (1261-1267): the exit bounds every clustered hit; a ray
      // that misses the slab gets -1, so no cluster passes its cond.
      float s_min, s_max;
      box_range(r, make_float4(slab_lo.x, slab_lo.y, slab_lo.z, 0.0f),
                make_float4(slab_hi.x, slab_hi.y, slab_hi.z, 0.0f),
                s_min, s_max);
      const float t_exit = ((s_min <= s_max) & (s_max > kTMin)) ? s_max
                                                                : -1.0f;
      if (n_supers > 0) {
        // Two-level sweep (1442-1453): supers front to back, and the
        // clusters of an entered super in their bake order.
        for (int s = 0; s < n_supers; ++s) {
          if (!enters(r, sboxes, s, nan_min(best_t, t_exit))) continue;
          ++counts.supers;
          const int2 range = __ldg(sranges + s);
          for (int c = range.x; c < range.x + range.y; ++c) {
            if (enters(r, cboxes, c, nan_min(best_t, t_exit)))
              sweep_cluster(r, c, best_t, best, counts);
          }
        }
      } else {
        for (int c = 0; c < n_clusters; ++c) {
          if (enters(r, cboxes, c, nan_min(best_t, t_exit)))
            sweep_cluster(r, c, best_t, best, counts);
        }
      }
    }
    if (best < 0) return false;
    fill_hit(items, best, best_t, h);
    return true;
  }
};

// Eight blocks per SM cap both kernels at 64 registers a thread (72 by
// default): the occupancy gained outweighs the extra spills, by 1.5% on
// the headline frame and 5% on the unculled one (PERF.md).
__global__ void __launch_bounds__(kThreads, 8)
baked_unculled_kernel(const wpt::LaneParams p, const UnculledIntersect isect) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= p.n_lanes) return;
  wpt::trace_lane(p, lane, isect);
}

__global__ void __launch_bounds__(kThreads, 8)
baked_culled_kernel(const wpt::LaneParams p, CulledIntersect isect,
                    const float* __restrict__ consts) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= p.n_lanes) return;
  isect.shx = __ldg(consts + 0);
  isect.shy = __ldg(consts + 1);
  isect.shz = __ldg(consts + 2);
  isect.slab_lo = make_float3(__ldg(consts + 3), __ldg(consts + 4),
                              __ldg(consts + 5));
  isect.slab_hi = make_float3(__ldg(consts + 6), __ldg(consts + 7),
                              __ldg(consts + 8));
  wpt::trace_lane(p, lane, isect);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  With
// culled == 0 the item table is swept in full (n_globals = its row count)
// with the generic quadratic, and the box tables are not read.  The
// wrapper (ops/baked_kernels.py) checks shapes, types and alignment.
extern "C" int wpt_baked_launch(
    const float* items, int n_globals,
    const float* cboxes, const int* cranges, int n_clusters,
    const float* sboxes, const int* sranges, int n_supers,
    const float* consts, int culled,
    const float* cam, const uint32_t* pix, const float* xs, const float* ys,
    const float* valid, const uint32_t* soff,
    float* rad_r, float* rad_g, float* rad_b, int* rays, int* supers,
    int* clusters, int n_lanes,
    uint32_t frame, uint32_t sample_base, uint32_t max_bounces,
    uint32_t n_samples, uint32_t rr_start, float rr_floor, float clamp,
    int stratified, void* stream) {
  if (n_lanes <= 0) return 0;
  const wpt::LaneParams p{cam, pix, xs, ys, valid, soff,
                          rad_r, rad_g, rad_b, rays, supers, clusters,
                          n_lanes, frame, sample_base, max_bounces,
                          n_samples, rr_start, rr_floor, clamp, stratified};
  const float4* item4 = reinterpret_cast<const float4*>(items);
  const int blocks = (n_lanes + kThreads - 1) / kThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (culled) {
    const CulledIntersect isect{
        item4, n_globals,
        reinterpret_cast<const float4*>(cboxes),
        reinterpret_cast<const int2*>(cranges), n_clusters,
        reinterpret_cast<const float4*>(sboxes),
        reinterpret_cast<const int2*>(sranges), n_supers,
        0.0f, 0.0f, 0.0f, make_float3(0.0f, 0.0f, 0.0f),
        make_float3(0.0f, 0.0f, 0.0f)};
    baked_culled_kernel<<<blocks, kThreads, 0, s>>>(p, isect, consts);
  } else {
    const UnculledIntersect isect{item4, n_globals};
    baked_unculled_kernel<<<blocks, kThreads, 0, s>>>(p, isect);
  }
  return static_cast<int>(cudaGetLastError());
}
