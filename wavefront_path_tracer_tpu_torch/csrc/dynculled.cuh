// Persistent-lane path tracing over the dynamic culled tables, for Hopper
// (sm_90a): the kernel, its intersect and its launch helpers.  Its entry
// points are in dynculled.cu; the differential stage probes'
// instantiations (common.cuh kProbe) in dynculled_probe.cu (spheres) and
// dynculled_probe_tris.cu (triangles), and for the segment in
// dynculled_probe_seg.cu and dynculled_probe_seg_tris.cu, translation
// units of their own, built into the stage probes' library
// (ops/_build.py).
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
// What it computes, per ray: every global sphere, then the sphere
// hierarchy, then the triangle hierarchy, each capped by its own slab
// exit.  A hierarchy of at most 64 clusters is swept flat, clusters in
// visit order, in batches of kRefresh = 16 whose box conds are taken
// against the cap min(best_t, t_exit) at the batch's start (the
// reference refreshed its cap every 16 clusters, 2165-2185).  Above 64
// clusters the sweep is over supers of kSuper = 16 clusters (2297-2372):
// a super's cond against the running cap, its children's conds against
// the cap at its entry.  Inside a batch the conds are fixed, so the
// sequential strict `t < best_t` walk over the entered clusters equals
// the plain version's masked argmin (first minimum in visit order) over
// the batch: kernel and plain version (ops/dynculled_kernels.py) agree
// bit for bit, counters included.  The TPU's tile consensus is not
// carried; each ray decides against its own nearest hit.
//
// A sphere pair is the slimmed quadratic in the shifted frame with both
// roots (1854-1864): nb = hd.2c' - d.o' with hd = d / 2, c_q = (|o'|^2 +
// kappa) - o'.2c'.  A triangle pair is common.cuh's tri_test.
//
// What bounds it on this card: FP32 issue over ray-primitive pairs and
// box tests, multiplied by warp divergence: a warp runs a cluster's pair
// tests on all 32 lanes when any of its lanes enters it.  The design is
// baked.cu's culled sweep's (PERF.md section 6).  In the persistent loop
// the warp's lanes run in step (common.cuh trace_warp, sweep form Coop);
// each lane takes its box conds against its own cap, as above, and per
// cluster a vote of those conds sends the cluster, where at most T lanes
// enter it, to the cooperative fold (common.cuh coop_fold: G lanes share
// one entering ray's pairs, broadcast by shuffle), and where more enter,
// to each entering lane's serial fold.  In the rolled sweep a super that
// no lane of the warp enters is skipped, and a lane that did not enter it
// has no cond for its children.  Which rays enter which cluster, and which
// item wins (least t, then least index, taken only below the ray's best),
// are the per-thread sweep's, so both forms give the same bits.  A
// segment runs the same way (common.cuh trace_segment_warp: the warp's
// lanes in step from their stored state, the reference's whole-tile early
// exit at 32 lanes).  Sweep form Serial runs the per-thread sweep
// (trace_lane, trace_segment).  Box tests stay per thread; the tables
// stay in L1 (__ldg, read warp-uniformly); the sphere pair is one 16-byte
// load (2c', kappa), the triangle pair three; the winner is an index
// whose attributes are fetched once after the sweep.  The 50k-triangle
// knot's triangle table (4.8 MB) stays in L2.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace wpt::dyn {

using wpt::BoxRay;
using wpt::CondDup;
using wpt::Coop;
using wpt::coop_fold;
using wpt::Counts;
using wpt::Hit;
using wpt::kFullMask;
using wpt::kTFar;
using wpt::kThreads;
using wpt::kTMin;
using wpt::kTri;
using wpt::kTriBit;
using wpt::nan_min;
using wpt::Serial;

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

  // The cond of box k; with kDup (the dyn_dbl_cond probe) evaluated
  // twice, the second time from `dup` (common.cuh box_enters_dup).
  template <bool kDup>
  static __device__ __forceinline__ bool enters(const BoxRay& r,
                                                const CondDup& dup,
                                                const float4* b, int k,
                                                float cap) {
    const float4 q0 = __ldg(b + 2 * k);       // lo xyz, hi.x
    const float4 q1 = __ldg(b + 2 * k + 1);   // hi.y, hi.z, 0, 0
    return wpt::box_enters_dup<kDup>(r, dup, q0.x, q0.y, q0.z, q0.w, q1.x,
                                     q1.y, cap);
  }

  // The sweep with the thread's own conds: `visit(k, enter)` is called
  // for every cluster the sweep reaches, `enter` being the thread's cond
  // (false for a thread that is not `live`); it tests cluster k's items
  // against the running best_t where it enters.  With kWarp every lane of
  // the warp runs the sweep together: the children of a super are walked
  // when any lane entered it, and a lane that did not has enter = false
  // for them.  Without it a thread walks only its own supers.  With kDup
  // every cond is evaluated twice (enters).
  template <bool kWarp, bool kDup, class Visit>
  __device__ __forceinline__ void sweep(bool live, const BoxRay& r,
                                        const CondDup& dup,
                                        const float& best_t, Counts& counts,
                                        Visit visit) const {
    const float t_exit = wpt::slab_exit(r, lo[0], lo[1], lo[2], hi[0],
                                        hi[1], hi[2]);
    if (n_supers == 0) {
      for (int k0 = 0; k0 < n_clusters; k0 += kRefresh) {
        const float cap = nan_min(best_t, t_exit);
        const int k1 = min(n_clusters, k0 + kRefresh);
        for (int k = k0; k < k1; ++k)
          visit(k, live && enters<kDup>(r, dup, boxes, k, cap));
      }
      return;
    }
    for (int s = 0; s < n_supers; ++s) {
      const float cap = nan_min(best_t, t_exit);
      const bool es = live && enters<kDup>(r, dup, sboxes, s, cap);
      if (es) ++counts.supers;
      if (kWarp ? !__any_sync(kFullMask, es) : !es) continue;
      for (int k = s * kSuper; k < (s + 1) * kSuper; ++k)
        visit(k, es && enters<kDup>(r, dup, boxes, k, cap));
    }
  }
};

// make_dynamic_culled_intersect.intersect (pallas_kernels.py:1983-2408),
// with the sweep form S.  kProbe (common.cuh; 0 in the shipped kernels)
// may hold kDynDblEntry: every entered cluster is tested twice, the
// second time from the ray's |o'|^2 (spheres) or origin (triangles) plus
// an opaque zero, in the same fold (serial or cooperative; the same t
// never wins under the strict `<`; pallas_kernels.py:2219-2229,
// 2355-2362); kDynDblCond: every cluster and super cond is evaluated
// twice (Level::enters; 2128-2135, 2310-2330); or kDynDblGlobal: the
// globals are swept twice, the second time from |o'|^2 plus an opaque
// zero (2074-2080).  The counters count the first evaluation only.
template <bool kTris, bool kTex, class S, int kProbe = 0>
struct DynIntersect {
  static constexpr bool kTriangles = kTris;
  static constexpr bool kTextured = kTex;
  static constexpr bool kDupEntry = (kProbe & wpt::kDynDblEntry) != 0;
  static constexpr bool kDupCond = (kProbe & wpt::kDynDblCond) != 0;
  static constexpr bool kDupGlobal = (kProbe & wpt::kDynDblGlobal) != 0;
  const float4* spheres;
  const float4* tris;
  const float4* sphere_tex;
  wpt::TexTables tex;
  Level sph;
  Level tri;
  int n_globals;      // global rows, NaN padding included
  int cluster_size;   // rows per cluster
  float shx, shy, shz;

  // The ray in the shifted frame, as the sphere pair reads it.
  struct Ray {
    float oxp, oyp, ozp, hdx, hdy, hdz, dd_o, oo2;
  };

  // t of sphere row i, or kTFar: NaN from a negative disc or a padding
  // row falls through both selects.
  __device__ __forceinline__ float sphere_t(float oxp, float oyp, float ozp,
                                            float hdx, float hdy, float hdz,
                                            float dd_o, float oo2,
                                            int i) const {
    const float4 q = __ldg(spheres + kSphere * i);   // 2c' xyz, kappa
    const float nb = (hdx * q.x + hdy * q.y + hdz * q.z) - dd_o;
    const float c_q = (oo2 + q.w) - (oxp * q.x + oyp * q.y + ozp * q.z);
    const float disc = nb * nb - c_q;
    const float sq = sqrtf(disc);
    const float t1 = nb - sq;
    const float t2 = nb + sq;
    return (t1 > kTMin) ? t1 : ((t2 > kTMin) ? t2 : kTFar);
  }

  __device__ __forceinline__ void test(const Ray& r, int i, float& best_t,
                                       int& best) const {
    const float t = sphere_t(r.oxp, r.oyp, r.ozp, r.hdx, r.hdy, r.hdz,
                             r.dd_o, r.oo2, i);
    if (t < best_t) {
      best_t = t;
      best = i;
    }
  }

  // The call of trace_lane and trace_segment: a per-thread sweep.
  __device__ __forceinline__ bool operator()(
      float ox, float oy, float oz, float dx, float dy, float dz, Hit& h,
      Counts& counts, int&) const {
    return nearest<false>(true, ox, oy, oz, dx, dy, dz, h, counts);
  }

  // The call of trace_warp and trace_segment_warp: every lane of the
  // warp, live or not.
  __device__ __forceinline__ bool operator()(
      bool live, float ox, float oy, float oz, float dx, float dy, float dz,
      Hit& h, Counts& counts, int&) const {
    return nearest<S::kWarp>(live, ox, oy, oz, dx, dy, dz, h, counts);
  }

  // The nearest hit of the thread's ray (if `live`).  With kW the warp's
  // lanes are in step, and each cluster that some lane enters takes the
  // serial fold where more than T lanes enter it and the cooperative fold
  // where at most T do (a vote per cluster).
  template <bool kW>
  __device__ __forceinline__ bool nearest(
      bool live, float ox, float oy, float oz, float dx, float dy, float dz,
      Hit& h, Counts& counts) const {
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
    if (live) {
      for (int i = 0; i < n_globals; ++i) test(r, i, best_t, best);
      if constexpr (kDupGlobal) {
        Ray rg = r;
        rg.oo2 = r.oo2 + wpt::opaque_zero();
        for (int i = 0; i < n_globals; ++i) test(rg, i, best_t, best);
      }
    }
    if (sph.n_clusters > 0 || (kTris && tri.n_clusters > 0)) {
      const BoxRay br{ox, oy, oz, 1.0f / dx, 1.0f / dy, 1.0f / dz};
      CondDup dup{br, 0.0f};
      if constexpr (kDupCond) dup = wpt::cond_dup(br);
      float ze = 0.0f;    // the entry probe's zero
      if constexpr (kDupEntry) ze = wpt::opaque_zero();
      Ray rz = r;
      rz.oo2 = r.oo2 + ze;
      // The cooperative folds' ray fetches and item tests.
      const auto fetch_sph = [&](int owner, float (&v)[8]) {
        const float mine[8] = {r.oxp, r.oyp, r.ozp, r.hdx, r.hdy, r.hdz,
                               r.dd_o, r.oo2};
#pragma unroll
        for (int f = 0; f < 8; ++f)
          v[f] = __shfl_sync(kFullMask, mine[f], owner);
      };
      const auto sph_t = [&](const float (&v)[8], int i) {
        return sphere_t(v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], i);
      };
      const auto fetch_tri = [&](int owner, float (&v)[6]) {
        const float mine[6] = {ox, oy, oz, dx, dy, dz};
#pragma unroll
        for (int f = 0; f < 6; ++f)
          v[f] = __shfl_sync(kFullMask, mine[f], owner);
      };
      const auto tri_t = [&](const float (&v)[6], int j) {
        return wpt::tri_test(tris + kTri * j, v[0], v[1], v[2], v[3], v[4],
                             v[5]);
      };
      // The entry probe's second tests (v[7] is |o'|^2, v[0] the origin's
      // x).
      const auto sph_tz = [&](const float (&v)[8], int i) {
        return sphere_t(v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7] + ze,
                        i);
      };
      const auto tri_tz = [&](const float (&v)[6], int j) {
        return wpt::tri_test(tris + kTri * j, v[0] + ze, v[1], v[2], v[3],
                             v[4], v[5]);
      };
      // One cluster of each hierarchy, as the sweep reaches it.
      const auto visit_spheres = [&](int k, bool enter) {
        if (enter) ++counts.clusters;
        const int first = n_globals + k * cluster_size;
        if constexpr (kW) {
          const unsigned m = __ballot_sync(kFullMask, enter);
          if (m == 0u) return;
          if (__popc(m) <= S::kT) {
            coop_fold<S::kG, 8>(m, first, cluster_size, 0, fetch_sph, sph_t,
                                best_t, best);
            if constexpr (kDupEntry) {
              coop_fold<S::kG, 8>(m, first, cluster_size, 0, fetch_sph,
                                  sph_tz, best_t, best);
            }
            return;
          }
        }
        if (enter) {
          for (int i = first; i < first + cluster_size; ++i)
            test(r, i, best_t, best);
          if constexpr (kDupEntry) {
            for (int i = first; i < first + cluster_size; ++i)
              test(rz, i, best_t, best);
          }
        }
      };
      const auto visit_triangles = [&](int k, bool enter) {
        if (enter) ++counts.clusters;
        const int first = k * cluster_size;
        if constexpr (kW) {
          const unsigned m = __ballot_sync(kFullMask, enter);
          if (m == 0u) return;
          if (__popc(m) <= S::kT) {
            coop_fold<S::kG, 6>(m, first, cluster_size, kTriBit, fetch_tri,
                                tri_t, best_t, best);
            if constexpr (kDupEntry) {
              coop_fold<S::kG, 6>(m, first, cluster_size, kTriBit,
                                  fetch_tri, tri_tz, best_t, best);
            }
            return;
          }
        }
        if (enter) {
          for (int j = first; j < first + cluster_size; ++j) {
            const float t = wpt::tri_test(tris + kTri * j, ox, oy, oz, dx,
                                          dy, dz);
            if (t < best_t) {
              best_t = t;
              best = kTriBit | j;
            }
          }
          if constexpr (kDupEntry) {
            for (int j = first; j < first + cluster_size; ++j) {
              const float t = wpt::tri_test(tris + kTri * j, ox + ze, oy, oz,
                                            dx, dy, dz);
              if (t < best_t) {
                best_t = t;
                best = kTriBit | j;
              }
            }
          }
        }
      };
      if (sph.n_clusters > 0) {
        sph.sweep<kW, kDupCond>(live, br, dup, best_t, counts,
                                visit_spheres);
      }
      if (kTris && tri.n_clusters > 0) {
        tri.sweep<kW, kDupCond>(live, br, dup, best_t, counts,
                                visit_triangles);
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
// SegParams (one recluster segment).  A sweep form that votes (S::kWarp)
// runs the warp's lanes in step (trace_warp, trace_segment_warp); the
// serial form runs them per thread (trace_lane, trace_segment).  kProbe:
// the probes of the warp's loop and of the intersect (0 in the shipped
// kernels).
template <class P, bool kTris, bool kTex, class S, int kProbe = 0>
__global__ void __launch_bounds__(kThreads, 8)
dynculled_kernel(const P p, DynIntersect<kTris, kTex, S, kProbe> isect,
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
  if constexpr (S::kWarp) {
    wpt::trace_in_step<kProbe>(p, lane, isect);
  } else {
    static_assert(kProbe == 0, "probes run in the warp's loop");
    wpt::trace(p, lane, isect);
  }
}

inline Level level(const float* boxes, const float* sboxes, int n_clusters,
            int n_supers) {
  return Level{reinterpret_cast<const float4*>(boxes),
               reinterpret_cast<const float4*>(sboxes), n_clusters,
               n_supers, {0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
}

// The tables of one launch.
struct Tables {
  const float4* spheres;
  const float4* tris;
  const float4* sphere_tex;
  wpt::TexTables tex;
  Level sph;
  Level tri;
  int n_globals;
  int cluster_size;
  const float* slab;
  const float* tri_slab;
};

inline Tables tables(const float* spheres, const float* boxes, const float* sboxes,
              const float* slab, const float* tris, const float* tboxes,
              const float* tsboxes, const float* tri_slab, int n_globals,
              int n_clusters, int n_supers, int n_tri_clusters,
              int n_tri_supers, int cluster_size, const float* sphere_tex,
              const float* img_centres, const int* img_words, int img_h,
              int img_w) {
  return Tables{reinterpret_cast<const float4*>(spheres),
                reinterpret_cast<const float4*>(tris),
                reinterpret_cast<const float4*>(sphere_tex),
                {reinterpret_cast<const float4*>(img_centres), img_words,
                 img_h, img_w},
                level(boxes, sboxes, n_clusters, n_supers),
                level(tboxes, tsboxes, n_tri_clusters, n_tri_supers),
                n_globals, cluster_size, slab, tri_slab};
}

template <class P, bool kTris, bool kTex, class S, int kProbe = 0>
void launch(const P& p, const Tables& t, cudaStream_t s) {
  const int blocks = (p.n_lanes + kThreads - 1) / kThreads;
  const DynIntersect<kTris, kTex, S, kProbe> isect{
      t.spheres, t.tris, t.sphere_tex, t.tex, t.sph, t.tri, t.n_globals,
      t.cluster_size, 0.0f, 0.0f, 0.0f};
  dynculled_kernel<P, kTris, kTex, S, kProbe><<<blocks, kThreads, 0, s>>>(
      p, isect, t.slab, t.tri_slab);
}

// The kernel of sweep form `sweep`: 0 Serial, 1 Coop.  False for any
// other form.
template <class P, bool kTris, bool kTex>
bool launch_sweep(const P& p, int sweep, const Tables& t, cudaStream_t s) {
  if (sweep == 0) {
    launch<P, kTris, kTex, Serial>(p, t, s);
    return true;
  }
  if (sweep == 1) {
    launch<P, kTris, kTex, Coop>(p, t, s);
    return true;
  }
  return false;
}

// The instantiation for the scene's kinds (triangles, textures); returns
// cudaGetLastError(), or cudaErrorInvalidValue for an unknown sweep form.
template <class P>
int dispatch(const P& p, int sweep, const Tables& t, int textured,
             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tris = t.tri.n_clusters > 0;
  bool ok;
  if (tris && textured) {
    ok = launch_sweep<P, true, true>(p, sweep, t, s);
  } else if (tris) {
    ok = launch_sweep<P, true, false>(p, sweep, t, s);
  } else if (textured) {
    ok = launch_sweep<P, false, true>(p, sweep, t, s);
  } else {
    ok = launch_sweep<P, false, false>(p, sweep, t, s);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The probe kernels' launchers: one bit of common.cuh's probes for the
// tables' kinds, in the shipped form (sweep Coop).  The persistent loop:
// without triangles dynculled_probe.cu's, with them
// dynculled_probe_tris.cu's.  One segment (the intersect's probes only:
// _segment_impl has none of its own): dynculled_probe_seg.cu's and
// dynculled_probe_seg_tris.cu's.  False for a bitmask with no
// instantiation.
bool probe_launch_spheres(const wpt::LaneParams& p, bool tex, int probe,
                          const Tables& t, cudaStream_t s);
bool probe_launch_triangles(const wpt::LaneParams& p, bool tex, int probe,
                            const Tables& t, cudaStream_t s);
bool segment_probe_launch_spheres(const wpt::SegParams& p, bool tex,
                                  int probe, const Tables& t,
                                  cudaStream_t s);
bool segment_probe_launch_triangles(const wpt::SegParams& p, bool tex,
                                    int probe, const Tables& t,
                                    cudaStream_t s);

// The stage probes' dispatch (dynculled_probe.cu's
// wpt_dynculled_probe_dispatch and wpt_dynculled_segment_probe_dispatch),
// which dynculled.cu's entry points call for a non-zero `probe`: the probe
// kernels are built into a library of their own (ops/_build.py), so that
// the shipped library's build does not carry them.  Each returns
// cudaGetLastError(), or cudaErrorInvalidValue for a probe or a form that
// has no instantiation.
using ProbeDispatch = int (*)(const wpt::LaneParams& p, int sweep,
                              int probe, const Tables& t, int textured,
                              void* stream);
using SegmentProbeDispatch = int (*)(const wpt::SegParams& p, int sweep,
                                     int probe, const Tables& t,
                                     int textured, void* stream);

// The kernel of the listed bit that equals `probe`, for the launchers.
template <class P, bool kTris, bool kTex, int... kBits>
bool launch_probe_of(const P& p, int probe, const Tables& t,
                     cudaStream_t s) {
  return wpt::with_probe_bit<kBits...>(probe, [&](auto bit) {
    launch<P, kTris, kTex, Coop, decltype(bit)::value>(p, t, s);
  });
}

// The persistent kernel's probes.
template <bool kTris, bool kTex>
bool launch_probe(const wpt::LaneParams& p, int probe, const Tables& t,
                  cudaStream_t s) {
  return launch_probe_of<wpt::LaneParams, kTris, kTex, wpt::kDblRaygen,
                         wpt::kDblShade, wpt::kDblAccum, wpt::kDblLoopcond,
                         wpt::kDynDblEntry, wpt::kDynDblCond,
                         wpt::kDynDblGlobal>(p, probe, t, s);
}

// The segment kernel's probes: its intersect's.
template <bool kTris, bool kTex>
bool launch_segment_probe(const wpt::SegParams& p, int probe,
                          const Tables& t, cudaStream_t s) {
  return launch_probe_of<wpt::SegParams, kTris, kTex, wpt::kDynDblEntry,
                         wpt::kDynDblCond, wpt::kDynDblGlobal>(p, probe, t,
                                                               s);
}

}  // namespace wpt::dyn
