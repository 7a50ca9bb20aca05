// Persistent-lane path tracing over the dynamic culled tables, for Hopper
// (sm_90a).
//
// Replaces wavefront_path_tracer_tpu/ops/pallas_kernels.py:
// fused_render_dynculled (3211) with make_dynamic_culled_intersect (1772)
// as its nearest-hit function, over spheres and triangles, with checker
// and image textures.  The persistent body (samples, bounces, raygen,
// shade, sky, clamp, roulette, the texture step) is common.cuh's.  The
// same kernel, instantiated with common.cuh's SegParams, replaces
// fused_segment_dynculled (3027) under _segment_impl (2785): one recluster
// segment of at most K bounces of each live lane's stored path.
//
// Tables (ops/dyn_tables.py, derived row for row from pack_culled_scene):
//   spheres (N_pad, 16) f32, four float4 a row: 2c' xyz, kappa | centre,
//     1/r | albedo rgb, fuzz | ior, mat_type, image slot, 0.  The first
//     n_globals rows are the globals, then cluster_size rows per
//     cluster in visit order; NaN padding rows never win.
//   boxes / super boxes (C, 8) f32: lo xyz, hi xyz, 0, 0; NaN padding
//     boxes are never entered.
//   slab (2, 8): row 0 the sphere clusters' slab, row 1 the shift.
//   triangles: common.cuh's kTri rows, cluster_size rows per cluster;
//     tri_slab (1, 8).
//   textured scenes (kTex): sphere_tex (N_pad, 4), the reference table's
//     columns 16-19 (checker albedo2 rgb, scale), read for the winner
//     only, and common.cuh's image LUTs; a triangle win clears the
//     checker (pallas_kernels.py:1973-1981).
// The packed attribute words of the reference's tables are decoded on
// the host, so no float op here touches a bit pattern.
//
// What it computes, per thread (one lane): every global sphere, then the
// sphere hierarchy, then the triangle hierarchy, each capped by its own
// slab exit.  A hierarchy of at most 64 clusters is swept flat, clusters
// in visit order, in batches of kRefresh = 16 whose box conds are taken
// against the cap min(best_t, t_exit) at the batch's start (the
// reference refreshed its cap every 16 clusters, 2165-2185).  Above 64
// clusters the sweep is over supers of kSuper = 16 clusters (2297-2372):
// a super's cond against the running cap, its children's conds against
// the cap at its entry.  Inside a batch the conds are fixed, so the
// sequential strict `t < best_t` walk over the entered clusters equals
// the plain version's masked argmin (first minimum in visit order) over
// the batch: kernel and plain version (ops/dynculled_kernels.py) agree
// bit for bit, counters included.  The TPU's tile consensus is not
// carried; each thread decides against its own nearest hit.
//
// A sphere pair is the slimmed quadratic in the shifted frame with both
// roots (1854-1864): nb = hd.2c' - d.o' with hd = d / 2, c_q = (|o'|^2 +
// kappa) - o'.2c'.  A triangle pair is common.cuh's tri_test.
//
// What bounds it on this card: FP32 issue over ray-primitive pairs and
// box tests, and warp divergence once the threads of a warp disagree on
// a cluster (the warp runs a cluster if any of its threads enters).  The
// design keeps the sphere pair at one 16-byte load (2c', kappa), the
// triangle pair at three, and the winner as an index whose attributes are
// fetched once after the sweep.  The tables stay in L2 (the 50k-triangle
// knot's triangle table is 4.8 MB).  Warp-vote culling, shared-memory
// staging and FMA contraction with pinned rounding are later steps.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using wpt::BoxRay;
using wpt::Counts;
using wpt::Hit;
using wpt::kTFar;
using wpt::kThreads;
using wpt::kTMin;
using wpt::kTri;
using wpt::kTriBit;
using wpt::nan_min;

constexpr int kSphere = 4;    // float4 per sphere row
constexpr int kRefresh = 16;  // clusters per cond batch, flat sweep
constexpr int kSuper = 16;    // clusters per super, rolled sweep

// One hierarchy: boxes of its clusters and supers (as float4 pairs) and
// the slab that holds it.
struct Level {
  const float4* boxes;
  const float4* sboxes;
  int n_clusters;
  int n_supers;
  float lo[3], hi[3];

  static __device__ __forceinline__ bool enters(const BoxRay& r,
                                                const float4* b, int k,
                                                float cap) {
    const float4 q0 = __ldg(b + 2 * k);       // lo xyz, hi.x
    const float4 q1 = __ldg(b + 2 * k + 1);   // hi.y, hi.z, 0, 0
    return wpt::box_enters(r, q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, cap);
  }

  // `fold(k)` tests cluster k's items against the running best_t.
  template <class Fold>
  __device__ __forceinline__ void sweep(const BoxRay& r, const float& best_t,
                                        Counts& counts, Fold fold) const {
    const float t_exit = wpt::slab_exit(r, lo[0], lo[1], lo[2], hi[0],
                                        hi[1], hi[2]);
    if (n_supers == 0) {
      for (int k0 = 0; k0 < n_clusters; k0 += kRefresh) {
        const float cap = nan_min(best_t, t_exit);
        const int k1 = min(n_clusters, k0 + kRefresh);
        for (int k = k0; k < k1; ++k) {
          if (enters(r, boxes, k, cap)) {
            ++counts.clusters;
            fold(k);
          }
        }
      }
      return;
    }
    for (int s = 0; s < n_supers; ++s) {
      const float cap = nan_min(best_t, t_exit);
      if (!enters(r, sboxes, s, cap)) continue;
      ++counts.supers;
      for (int k = s * kSuper; k < (s + 1) * kSuper; ++k) {
        if (enters(r, boxes, k, cap)) {
          ++counts.clusters;
          fold(k);
        }
      }
    }
  }
};

template <bool kTris, bool kTex>
struct DynIntersect {
  static constexpr bool kTriangles = kTris;
  static constexpr bool kTextured = kTex;
  const float4* spheres;
  const float4* tris;
  const float4* sphere_tex;
  wpt::TexTables tex;
  Level sph;
  Level tri;
  int n_globals;      // global rows, NaN padding included
  int cluster_size;   // rows per cluster
  float shx, shy, shz;

  struct Ray {
    float oxp, oyp, ozp, hdx, hdy, hdz, dd_o, oo2;
  };

  __device__ __forceinline__ void test(const Ray& r, int i, float& best_t,
                                       int& best) const {
    const float4 q = __ldg(spheres + kSphere * i);   // 2c' xyz, kappa
    const float nb = (r.hdx * q.x + r.hdy * q.y + r.hdz * q.z) - r.dd_o;
    const float c_q = (r.oo2 + q.w) - (r.oxp * q.x + r.oyp * q.y
                                       + r.ozp * q.z);
    const float disc = nb * nb - c_q;
    const float sq = sqrtf(disc);   // NaN when disc < 0: falls to T_FAR
    const float t1 = nb - sq;
    const float t2 = nb + sq;
    const float t = (t1 > kTMin) ? t1 : ((t2 > kTMin) ? t2 : kTFar);
    if (t < best_t) {
      best_t = t;
      best = i;
    }
  }

  __device__ __forceinline__ bool operator()(
      float ox, float oy, float oz, float dx, float dy, float dz, Hit& h,
      Counts& counts, int&) const {
    Ray r;
    r.oxp = ox - shx;
    r.oyp = oy - shy;
    r.ozp = oz - shz;
    r.hdx = 0.5f * dx;
    r.hdy = 0.5f * dy;
    r.hdz = 0.5f * dz;
    r.dd_o = dx * r.oxp + dy * r.oyp + dz * r.ozp;
    r.oo2 = r.oxp * r.oxp + r.oyp * r.oyp + r.ozp * r.ozp;
    int best = -1;
    float best_t = kTFar;
    for (int i = 0; i < n_globals; ++i) test(r, i, best_t, best);
    if (sph.n_clusters > 0 || (kTris && tri.n_clusters > 0)) {
      const BoxRay br{ox, oy, oz, 1.0f / dx, 1.0f / dy, 1.0f / dz};
      if (sph.n_clusters > 0) {
        sph.sweep(br, best_t, counts, [&](int k) {
          const int first = n_globals + k * cluster_size;
          for (int i = first; i < first + cluster_size; ++i)
            test(r, i, best_t, best);
        });
      }
      if (kTris && tri.n_clusters > 0) {
        tri.sweep(br, best_t, counts, [&](int k) {
          const int first = k * cluster_size;
          for (int j = first; j < first + cluster_size; ++j) {
            const float t = wpt::tri_test(tris + kTri * j, ox, oy, oz, dx,
                                          dy, dz);
            if (t < best_t) {
              best_t = t;
              best = kTriBit | j;
            }
          }
        });
      }
    }
    if (best < 0) return false;
    if (kTris && (best & kTriBit)) {
      wpt::fill_tri_hit(tris, best & ~kTriBit, best_t, h);
      return true;
    }
    const float4 q1 = __ldg(spheres + kSphere * best + 1);
    const float4 q2 = __ldg(spheres + kSphere * best + 2);
    const float4 q3 = __ldg(spheres + kSphere * best + 3);
    h.t = best_t;
    h.cx = q1.x;
    h.cy = q1.y;
    h.cz = q1.z;
    h.inv_r = q1.w;
    h.ar = q2.x;
    h.ag = q2.y;
    h.ab = q2.z;
    h.fuzz = q2.w;
    h.ior = q3.x;
    h.mt = q3.y;
    h.nx = 0.0f;
    h.ny = 0.0f;
    h.nz = 0.0f;
    h.is_tri = false;
    if (kTex) {
      const float4 c = __ldg(sphere_tex + best);
      h.a2r = c.x;
      h.a2g = c.y;
      h.a2b = c.z;
      h.ts = c.w;
      h.slot = static_cast<int>(q3.z);
    }
    return true;
  }
};

// Eight blocks per SM cap the kernel at 64 registers a thread, as the
// other kernels are (PERF.md).  `P` is LaneParams (the persistent loop) or
// SegParams (one recluster segment).
template <class P, bool kTris, bool kTex>
__global__ void __launch_bounds__(kThreads, 8)
dynculled_kernel(const P p, DynIntersect<kTris, kTex> isect,
                 const float* __restrict__ slab,
                 const float* __restrict__ tri_slab) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  isect.shx = __ldg(slab + 8);
  isect.shy = __ldg(slab + 9);
  isect.shz = __ldg(slab + 10);
  for (int k = 0; k < 3; ++k) {
    isect.sph.lo[k] = __ldg(slab + k);
    isect.sph.hi[k] = __ldg(slab + 3 + k);
    if (kTris) {
      isect.tri.lo[k] = __ldg(tri_slab + k);
      isect.tri.hi[k] = __ldg(tri_slab + 3 + k);
    }
  }
  wpt::trace(p, lane, isect);
}

Level level(const float* boxes, const float* sboxes, int n_clusters,
            int n_supers) {
  return Level{reinterpret_cast<const float4*>(boxes),
               reinterpret_cast<const float4*>(sboxes), n_clusters,
               n_supers, {0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
}

template <class P, bool kTris, bool kTex>
void launch(const P& p, const DynIntersect<kTris, kTex>& isect,
            const float* slab, const float* tri_slab, cudaStream_t s) {
  const int blocks = (p.n_lanes + kThreads - 1) / kThreads;
  dynculled_kernel<P, kTris, kTex><<<blocks, kThreads, 0, s>>>(p, isect,
                                                              slab, tri_slab);
}

// The tables of one launch, and the instantiation for the scene's kinds
// (triangles, textures); returns cudaGetLastError().
template <class P>
int dispatch(const P& p, const float* spheres, const float* boxes,
             const float* sboxes, const float* slab, const float* tris,
             const float* tboxes, const float* tsboxes,
             const float* tri_slab, int n_globals, int n_clusters,
             int n_supers, int n_tri_clusters, int n_tri_supers,
             int cluster_size, const float* sphere_tex,
             const float* img_centres, const int* img_words, int img_h,
             int img_w, int textured, void* stream) {
  const float4* sph4 = reinterpret_cast<const float4*>(spheres);
  const float4* tri4 = reinterpret_cast<const float4*>(tris);
  const Level sph = level(boxes, sboxes, n_clusters, n_supers);
  const Level tri = level(tboxes, tsboxes, n_tri_clusters, n_tri_supers);
  const float4* tex4 = reinterpret_cast<const float4*>(sphere_tex);
  const wpt::TexTables tex{reinterpret_cast<const float4*>(img_centres),
                           img_words, img_h, img_w};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_tri_clusters > 0 && textured) {
    launch<P, true, true>(p, {sph4, tri4, tex4, tex, sph, tri, n_globals,
                              cluster_size, 0.0f, 0.0f, 0.0f}, slab,
                          tri_slab, s);
  } else if (n_tri_clusters > 0) {
    launch<P, true, false>(p, {sph4, tri4, tex4, tex, sph, tri, n_globals,
                               cluster_size, 0.0f, 0.0f, 0.0f}, slab,
                           tri_slab, s);
  } else if (textured) {
    launch<P, false, true>(p, {sph4, tri4, tex4, tex, sph, tri, n_globals,
                               cluster_size, 0.0f, 0.0f, 0.0f}, slab,
                           tri_slab, s);
  } else {
    launch<P, false, false>(p, {sph4, tri4, tex4, tex, sph, tri, n_globals,
                                cluster_size, 0.0f, 0.0f, 0.0f}, slab,
                            tri_slab, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// n_tri_clusters == 0 launches the sphere-only kernel, textured == 0 the
// untextured one (the texture tables are not read).  The wrapper
// (ops/dynculled_kernels.py) checks shapes, types and alignment.
extern "C" int wpt_dynculled_launch(
    const float* spheres, const float* boxes, const float* sboxes,
    const float* slab, const float* tris, const float* tboxes,
    const float* tsboxes, const float* tri_slab,
    int n_globals, int n_clusters, int n_supers, int n_tri_clusters,
    int n_tri_supers, int cluster_size,
    const float* sphere_tex, const float* img_centres, const int* img_words,
    int img_h, int img_w, int textured,
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
  return dispatch(p, spheres, boxes, sboxes, slab, tris, tboxes, tsboxes,
                  tri_slab, n_globals, n_clusters, n_supers, n_tri_clusters,
                  n_tri_supers, cluster_size, sphere_tex, img_centres,
                  img_words, img_h, img_w, textured, stream);
}

// One recluster segment (fused_segment_dynculled, pallas_kernels.py:3027)
// over the same tables: at most k_iters bounces of every live lane of the
// state planes, updated in place (common.cuh's SegParams).  Returns
// cudaGetLastError().
extern "C" int wpt_dynculled_segment_launch(
    const float* spheres, const float* boxes, const float* sboxes,
    const float* slab, const float* tris, const float* tboxes,
    const float* tsboxes, const float* tri_slab,
    int n_globals, int n_clusters, int n_supers, int n_tri_clusters,
    int n_tri_supers, int cluster_size,
    const float* sphere_tex, const float* img_centres, const int* img_words,
    int img_h, int img_w, int textured,
    float* state, uint32_t* ids, int* counts, int n_lanes,
    uint32_t frame, uint32_t max_bounces, uint32_t k_iters,
    uint32_t rr_start, float rr_floor, float clamp, void* stream) {
  if (n_lanes <= 0) return 0;
  const wpt::SegParams p{state, ids, counts, n_lanes, frame, max_bounces,
                         k_iters, rr_start, rr_floor, clamp};
  return dispatch(p, spheres, boxes, sboxes, slab, tris, tboxes, tsboxes,
                  tri_slab, n_globals, n_clusters, n_supers, n_tri_clusters,
                  n_tri_supers, cluster_size, sphere_tex, img_centres,
                  img_words, img_h, img_w, textured, stream);
}
