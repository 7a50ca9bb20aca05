// Persistent-lane path tracing over a baked scene, for Hopper (sm_90a):
// the kernels, their intersects and their launch helpers.  Their entry
// points are in baked.cu; the differential stage probes' instantiations
// (common.cuh kProbe) in baked_probe.cu and baked_probe2.cu (culled, the
// persistent loop), baked_probe_unculled.cu, and baked_probe_seg.cu and
// baked_probe_seg2.cu (the culled segment), translation units of their
// own, built into the stage probes' library (ops/_build.py).
//
// Replaces wavefront_path_tracer_tpu/ops/pallas_kernels.py:
// fused_render_baked (3157) with either of its intersects,
// baked_culled_intersect (831) or baked_intersect (612), over spheres and
// triangles, with checker and image textures and, for the culled one, the
// winner hint.  The persistent body (samples, bounces, raygen, shade, sky,
// clamp, roulette, the texture step) is common.cuh's, the same as
// persistent.cu's.
//
// The same kernels, instantiated with common.cuh's SegParams, replace
// fused_segment_baked (2997) under _segment_impl (2785): one recluster
// segment of at most K bounces of each live lane's stored path, culled or
// unculled, with the persistent body's bounce step.  What bounds a segment
// is what bounds the persistent kernel, plus reading and writing 17 words
// of state a lane; the coherence sort between segments (models/fused.py)
// is what may win warp coherence back.  The shipped forms run a segment
// with the warp's lanes in step (common.cuh trace_segment_warp), as they
// run the persistent loop (trace_warp): the culled kernel with its vote
// and cooperative fold, the unculled one with its staged triangle rows.
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
//   q4  1/r sign (the true 1/r with image textures), mat_type, image
//       slot (textured bakes), 0
// The pair loop reads q0 and q1; q2-q4 are read once, for the winner.
// A textured bake adds a float4 per item (checker albedo2 rgb, scale),
// also read once for the winner, and common.cuh's image LUTs.
// Boxes are (n, 8) f32 rows (lo xyz, 0, hi xyz, 0); ranges are (n, 2)
// int32 rows (first, count) into the item table (clusters) or the cluster
// table (supers).  consts: shift xyz, slab lo xyz, slab hi xyz, triangle
// slab lo xyz, hi xyz.
//
// Triangles (common.cuh's kTri rows) are a second item type: the
// unculled sweep tests them after the spheres, the culled one sweeps
// their own hierarchy (clusters, supers, slab) after the sphere
// hierarchy, as the reference does (pallas_kernels.py:1310).  The winner
// is one index, with kTriBit set for a triangle.  Both intersects are
// templates on kTris and kTex (textures), the culled one on kHint too: a
// sphere-only untextured bake launches the instantiation whose code is
// that of the sphere-only kernel.
//
// The winner hint (pallas_kernels.py:892-904, 1330-1367) is per thread:
// the thread keeps the cluster of its previous ray's winner (-1 after a
// global win, a miss, or at the lane's start; it carries over samples),
// tests that cluster first, counted as a cluster entered, and skips it in
// the main sweep, so each cluster is tested at most once.  Clusters are
// numbered in sweep order, the triangle hierarchy's after the spheres'.
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
// What bounds it on this card: FP32 issue over ray-primitive pairs and
// box tests, multiplied by warp divergence.  A warp runs a cluster's pair
// tests on all 32 lanes when any of its lanes enters the cluster.  On the
// headline (book_one_final at 1080p@32 spp; chip_smoke.py phase sweep
// counts it from the plain version over 16 image blocks) a warp trip runs
// 6.43 clusters where a ray enters 3.68, 41.5% of the lane-pairs issued
// test a pair that a lane needs, and of the (trip, cluster) pairs that
// some lane enters, 24.7% have one lane entering and 18.3% have 28-32.
// The design: in the persistent loop the warp's lanes run in step
// (common.cuh trace_warp), each cluster takes a vote of the lanes' own
// conds, and where at most T lanes enter, the warp's lanes share their
// rays, G lanes a ray (common.cuh coop_fold, with G = 8 and T = 12: a
// lone entering ray's 16 pairs take 2 steps of the warp, not 16); where
// more enter, each tests its own (the serial fold).  Which rays enter which cluster, and
// which item wins, are the per-thread sweep's, so the kernel stays bit for
// bit equal to its plain version.  Box tests stay per thread; the tables
// stay in L1 (__ldg, read warp-uniformly, which probes showed as fast as
// shared memory); the pair loop stays lean (a 32-byte read a pair, the
// winner carried as an index and its attributes fetched once after the
// sweep); and the 32x32 block lane order of models/fused.py puts rays of
// one image block, whose primary rays share a frustum, in one warp.
//
// The unculled kernel tests every row for every ray, so its lanes need no
// vote: in the persistent loop they run in step (trace_warp), every lane
// with a ray sweeping the whole table in the same trip, one broadcast
// read a row, and a lane whose path ends starts its next sample on the
// next trip (per thread, the warp regrouped at every sample end and ran
// 1.6-2.0 times the trips: chip_smoke.py phase loop).  The triangle
// table is staged a warp at a time in shared memory (stage_triangles):
// terrain's 5,000 rows are 240 KB of what the pair test reads, more than
// L1 keeps, and one coalesced cp.async of 32 rows, two chunks in flight,
// beat 32 broadcast reads from L2 (0.69x of their time on terrain).

#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "common.cuh"

namespace wpt::baked {

using wpt::BoxRay;
using wpt::CondDup;
using wpt::Coop;
using wpt::coop_fold;
using wpt::Counts;
using wpt::Hit;
using wpt::kTFar;
using wpt::kThreads;
using wpt::kTMin;
using wpt::kTri;
using wpt::kTriBit;
using wpt::nan_min;
using wpt::Serial;

constexpr int kItem = 5;  // float4 per item row

template <bool kTex>
__device__ __forceinline__ void fill_hit(const float4* __restrict__ items,
                                         const float4* __restrict__ tex,
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
  h.nx = 0.0f;
  h.ny = 0.0f;
  h.nz = 0.0f;
  h.is_tri = false;
  if (kTex) {
    const float4 c = __ldg(tex + best);
    h.a2r = c.x;
    h.a2g = c.y;
    h.a2b = c.z;
    h.ts = c.w;
    h.slot = static_cast<int>(q4.z);
  }
}

// The triangles of rows first..first+count-1 against the running best.
__device__ __forceinline__ void test_triangles(
    const float4* __restrict__ tris, int first, int count, float ox,
    float oy, float oz, float dx, float dy, float dz, float& best_t,
    int& best) {
  for (int j = first; j < first + count; ++j) {
    const float t = wpt::tri_test(tris + kTri * j, ox, oy, oz, dx, dy, dz);
    if (t < best_t) {
      best_t = t;
      best = kTriBit | j;
    }
  }
}

template <bool kTris, bool kTex>
__device__ __forceinline__ bool finish(const float4* items,
                                       const float4* tex, const float4* tris,
                                       int best, float best_t, Hit& h) {
  if (best < 0) return false;
  if (kTris && (best & kTriBit)) {
    wpt::fill_tri_hit(tris, best & ~kTriBit, best_t, h);
  } else {
    fill_hit<kTex>(items, tex, best, best_t, h);
  }
  return true;
}

// baked_intersect.intersect (pallas_kernels.py:672-797): the generic
// quadratic with inv_a and the disc >= 0 select, in scene order; then the
// triangles in scene order.  The call of trace_warp reads the triangle
// table a warp at a time through shared memory (stage_triangles).
template <bool kTris, bool kTex>
struct UnculledIntersect {
  static constexpr bool kTriangles = kTris;
  static constexpr bool kTextured = kTex;
  const float4* items;
  int n_items;
  const float4* tris;
  int n_tris;
  const float4* tex_items;
  wpt::TexTables tex;

  // The call of trace_lane and trace_segment: a per-thread sweep.
  __device__ __forceinline__ bool operator()(
      float ox, float oy, float oz, float dx, float dy, float dz, Hit& h,
      Counts&, int&) const {
    int best = -1;
    float best_t = kTFar;
    spheres(ox, oy, oz, dx, dy, dz, best_t, best);
    if (kTris)
      test_triangles(tris, 0, n_tris, ox, oy, oz, dx, dy, dz, best_t, best);
    return finish<kTris, kTex>(items, tex_items, tris, best, best_t, h);
  }

  // The call of trace_warp and trace_segment_warp: every lane of the
  // warp; a lane that is not `live` tests nothing (but joins the warp's
  // staging).
  __device__ __forceinline__ bool operator()(
      bool live, float ox, float oy, float oz, float dx, float dy, float dz,
      Hit& h, Counts&, int&) const {
    int best = -1;
    float best_t = kTFar;
    if (live) spheres(ox, oy, oz, dx, dy, dz, best_t, best);
    if (kTris) stage_triangles(live, ox, oy, oz, dx, dy, dz, best_t, best);
    return finish<kTris, kTex>(items, tex_items, tris, best, best_t, h);
  }

  __device__ __forceinline__ void spheres(float ox, float oy, float oz,
                                          float dx, float dy, float dz,
                                          float& best_t, int& best) const {
    const float a = dx * dx + dy * dy + dz * dz;
    const float inv_a = 1.0f / a;
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
  }

  // The triangle rows a warp at a time, every lane of the warp together:
  // lane k copies the three float4 of row c0 + k that tri_t reads into
  // the warp's slice of shared memory (cp.async, two chunks in flight),
  // then every live lane tests rows c0 .. c0 + 31 from there in index
  // order with tri_t's arithmetic and the strict `<`, so its winner is
  // test_triangles' bit for bit (first index on ties; a NaN pad row never
  // wins).  The last chunk stops at n_tris.
  __device__ __forceinline__ void stage_triangles(
      bool live, float ox, float oy, float oz, float dx, float dy, float dz,
      float& best_t, int& best) const {
    constexpr int kRow = 3;   // float4 of a row that tri_t reads
    __shared__ float4 stage[kThreads / 32][2][32 * kRow];
    const int me = static_cast<int>(threadIdx.x & 31u);
    float4(*slots)[32 * kRow] = stage[threadIdx.x >> 5];
    const auto copy = [&](int c0, int slot) {
      if (c0 + me < n_tris) {
        const float4* src = tris + kTri * (c0 + me);
#pragma unroll
        for (int k = 0; k < kRow; ++k) {
          const unsigned dst = static_cast<unsigned>(
              __cvta_generic_to_shared(&slots[slot][kRow * me + k]));
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                       :: "r"(dst), "l"(src + k));
        }
      }
      asm volatile("cp.async.commit_group;\n" ::);
    };
    copy(0, 0);
    int slot = 0;
    for (int c0 = 0; c0 < n_tris; c0 += 32) {
      if (c0 + 32 < n_tris) {
        copy(c0 + 32, slot ^ 1);
        asm volatile("cp.async.wait_group 1;\n" ::);
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::);
      }
      __syncwarp();
      if (live) {
        const int n = min(32, n_tris - c0);
        const float4* rows = slots[slot];
        for (int k = 0; k < n; ++k) {
          const float t = wpt::tri_t(rows[kRow * k], rows[kRow * k + 1],
                                     rows[kRow * k + 2], ox, oy, oz, dx, dy,
                                     dz);
          if (t < best_t) {
            best_t = t;
            best = kTriBit | (c0 + k);
          }
        }
      }
      __syncwarp();           // the slot is refilled by the next copy
      slot ^= 1;
    }
  }
};

// One hierarchy of a culled bake: cluster boxes and item ranges, super
// boxes and cluster ranges (n_supers == 0: one-level sweep), and the
// slab that holds it.
struct Hierarchy {
  const float4* boxes;
  const int2* ranges;
  int n_clusters;
  const float4* sboxes;
  const int2* sranges;
  int n_supers;
  float lo[3], hi[3];

  // The cond of box k; with kDup (the dbl_cond probe) evaluated twice,
  // the second time from `dup` (common.cuh box_enters_dup); with kShift
  // (dbl_cond2) a second time from the box's corners plus an opaque zero,
  // which recomputes the whole slab test (pallas_kernels.py:1385-1392).
  // The second evaluations agree with the first, so the cond is
  // box_enters'.
  template <bool kDup, bool kShift = false>
  __device__ __forceinline__ bool enters(const BoxRay& r, const CondDup& dup,
                                         const float4* b, int k,
                                         float cap) const {
    const float4 lo4 = __ldg(b + 2 * k);
    const float4 hi4 = __ldg(b + 2 * k + 1);
    const bool e = wpt::box_enters_dup<kDup>(r, dup, lo4.x, lo4.y, lo4.z,
                                             hi4.x, hi4.y, hi4.z, cap);
    if constexpr (kShift) {
      const float z = wpt::opaque_zero();
      return e & wpt::box_enters(r, lo4.x + z, lo4.y + z, lo4.z + z,
                                 hi4.x + z, hi4.y + z, hi4.z + z, cap);
    }
    return e;
  }

  // The sweep (pallas_kernels.py:1362-1455) with per-thread conds:
  // supers front to back and the clusters of an entered super in their
  // bake order, or the flat sorted clusters.  `visit(c, enter)` is called
  // for every cluster the sweep reaches, `enter` being the thread's cond
  // (false for a thread that is not `live`); it tests cluster c's items
  // against the running best_t where it enters.  With kSkip, cluster
  // `skip` (the hint's, already tested) is passed over.  With kWarp every
  // lane of the warp runs the sweep together: the clusters of a super are
  // walked when any lane entered it, and a lane that did not has enter =
  // false for them.  Without it a thread walks only its own supers.  With
  // kDup every cond is evaluated twice (enters), with kShift every cluster
  // cond (not the supers').
  template <bool kSkip, bool kWarp, bool kDup, bool kShift, class Visit>
  __device__ __forceinline__ void sweep(bool live, const BoxRay& r,
                                        const CondDup& dup,
                                        const float& best_t, Counts& counts,
                                        int skip, Visit visit) const {
    const float t_exit = wpt::slab_exit(r, lo[0], lo[1], lo[2], hi[0],
                                        hi[1], hi[2]);
    if (n_supers > 0) {
      for (int s = 0; s < n_supers; ++s) {
        const bool es = live
            && enters<kDup>(r, dup, sboxes, s, nan_min(best_t, t_exit));
        if (es) ++counts.supers;
        if (kWarp ? !__any_sync(wpt::kFullMask, es) : !es) continue;
        const int2 range = __ldg(sranges + s);
        for (int c = range.x; c < range.x + range.y; ++c) {
          visit(c, es && (!kSkip || c != skip)
                       && enters<kDup, kShift>(r, dup, boxes, c,
                                               nan_min(best_t, t_exit)));
        }
      }
    } else {
      for (int c = 0; c < n_clusters; ++c) {
        visit(c, live && (!kSkip || c != skip)
                     && enters<kDup, kShift>(r, dup, boxes, c,
                                             nan_min(best_t, t_exit)));
      }
    }
  }
};

// baked_culled_intersect.intersect (pallas_kernels.py:1063-1466), with
// the sweep form S.  kProbe (common.cuh; 0 in the shipped kernels) may
// hold kDblEntry: every entered cluster is tested twice, the second time
// from the ray's |o'|^2 (spheres) or origin (triangles) plus an opaque
// zero, in the same fold (serial or cooperative); the second test gives
// the same t, which never wins under the strict `<`
// (pallas_kernels.py:1423-1425); kDblEntry2: every entered sphere cluster
// is tested a second time from the ray's origin plus an opaque zero, from
// which o', d.o' and |o'|^2 are recomputed, so that nvcc shares nothing of
// the quadratic with the first test (1426-1434; triangle clusters are not
// re-tested); kDblCond: every cluster and super cond is evaluated twice
// (Hierarchy::enters; 1379-1383); kDblCond2: every cluster cond a second
// time from the box's corners plus an opaque zero (1385-1392; the super
// conds once); or, with the winner hint, kHintCount: each prepass entry
// is also added to the supers counter (1353-1354), so that a hinted
// render reads its prepass entries as supers(probed) - supers(base).
// The counters count the first evaluation only.
template <bool kTris, bool kTex, bool kHint, class S, int kProbe = 0>
struct CulledIntersect {
  static constexpr bool kTriangles = kTris;
  static constexpr bool kTextured = kTex;
  static constexpr bool kDupEntry = (kProbe & wpt::kDblEntry) != 0;
  static constexpr bool kDupCond = (kProbe & wpt::kDblCond) != 0;
  static constexpr bool kDupEntry2 = (kProbe & wpt::kDblEntry2) != 0;
  static constexpr bool kDupCond2 = (kProbe & wpt::kDblCond2) != 0;
  static constexpr bool kCountHint = (kProbe & wpt::kHintCount) != 0;
  static_assert(kHint || !kCountHint,
                "hint_count counts the winner hint's prepass");
  const float4* items;
  int n_globals;
  Hierarchy spheres;
  const float4* tris;
  Hierarchy triangles;
  const float4* tex_items;
  wpt::TexTables tex;
  float shx, shy, shz;

  struct Ray {
    float oxp, oyp, ozp, dd_o, oo2;
    float dx, dy, dz;
  };

  // The ray in the shifted frame (sphere_tests' per-ray terms, 1087-1091).
  __device__ __forceinline__ Ray ray(float ox, float oy, float oz, float dx,
                                     float dy, float dz) const {
    Ray r;
    r.dx = dx; r.dy = dy; r.dz = dz;
    r.oxp = ox - shx;
    r.oyp = oy - shy;
    r.ozp = oz - shz;
    r.dd_o = dx * r.oxp + dy * r.oyp + dz * r.ozp;
    r.oo2 = r.oxp * r.oxp + r.oyp * r.oyp + r.ozp * r.ozp;
    return r;
  }

  // The slimmed quadratic of sphere_tests (1090-1130), in its order of
  // operations: unit directions, NaN from sqrt of a negative disc falls
  // through both selects to T_FAR.
  __device__ __forceinline__ float sphere_t(float oxp, float oyp, float ozp,
                                            float dd_o, float oo2, float dx,
                                            float dy, float dz,
                                            int i) const {
    const float4 q = __ldg(items + kItem * i);
    const float4 q1 = __ldg(items + kItem * i + 1);
    const float nb = (dx * q.x + dy * q.y + dz * q.z) - dd_o;
    const float c_q = (oo2 + q.w) - (oxp * q1.y + oyp * q1.z + ozp * q1.w);
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
    return t;
  }

  __device__ __forceinline__ void test(const Ray& r, int i, float& best_t,
                                       int& best) const {
    const float t = sphere_t(r.oxp, r.oyp, r.ozp, r.dd_o, r.oo2, r.dx, r.dy,
                             r.dz, i);
    if (t < best_t) {
      best_t = t;
      best = i;
    }
  }

  // The call of trace_lane and trace_segment: a per-thread sweep.
  __device__ __forceinline__ bool operator()(
      float ox, float oy, float oz, float dx, float dy, float dz, Hit& h,
      Counts& counts, int& hint) const {
    return nearest<false>(true, ox, oy, oz, dx, dy, dz, h, counts, hint);
  }

  // The call of trace_warp and trace_segment_warp: every lane of the
  // warp, live or not.
  __device__ __forceinline__ bool operator()(
      bool live, float ox, float oy, float oz, float dx, float dy, float dz,
      Hit& h, Counts& counts, int& hint) const {
    return nearest<S::kWarp>(live, ox, oy, oz, dx, dy, dz, h, counts, hint);
  }

  // The nearest hit of the thread's ray (if `live`).  With kW the warp's
  // lanes are in step, and each cluster that some lane enters takes the
  // serial fold where more than T lanes enter it and the cooperative fold
  // where at most T do (a vote per cluster).
  template <bool kW>
  __device__ __forceinline__ bool nearest(
      bool live, float ox, float oy, float oz, float dx, float dy, float dz,
      Hit& h, Counts& counts, int& hint) const {
    const Ray r = ray(ox, oy, oz, dx, dy, dz);
    int best = -1;
    float best_t = kTFar;
    if (live) {
      for (int i = 0; i < n_globals; ++i) test(r, i, best_t, best);
    }
    int best_c = -1;   // the winner's cluster (kHint)
    if (spheres.n_clusters > 0 || (kTris && triangles.n_clusters > 0)) {
      const BoxRay br{ox, oy, oz, 1.0f / dx, 1.0f / dy, 1.0f / dz};
      CondDup dup{br, 0.0f};
      if constexpr (kDupCond) dup = wpt::cond_dup(br);
      float ze = 0.0f;    // the entry probe's zero
      if constexpr (kDupEntry) ze = wpt::opaque_zero();
      Ray rz = r;
      rz.oo2 = r.oo2 + ze;
      const int n_sph = spheres.n_clusters;
      const auto fold_spheres = [&](int c, int first, int count) {
        const int before = best;
        for (int i = first; i < first + count; ++i)
          test(r, i, best_t, best);
        if constexpr (kDupEntry) {
          for (int i = first; i < first + count; ++i)
            test(rz, i, best_t, best);
        }
        if constexpr (kDupEntry2) {
          const float z = wpt::opaque_zero();
          const Ray r2 = ray(ox + z, oy + z, oz + z, dx, dy, dz);
          for (int i = first; i < first + count; ++i)
            test(r2, i, best_t, best);
        }
        if (kHint && best != before) best_c = c;
      };
      const auto fold_triangles = [&](int c, int first, int count) {
        const int before = best;
        test_triangles(tris, first, count, ox, oy, oz, dx, dy, dz, best_t,
                       best);
        if constexpr (kDupEntry) {
          test_triangles(tris, first, count, ox + ze, oy, oz, dx, dy, dz,
                         best_t, best);
        }
        if (kHint && best != before) best_c = n_sph + c;
      };
      // The cooperative folds' ray fetches and item tests.
      const auto fetch_sph = [&](int owner, float (&v)[8]) {
        const float mine[8] = {r.oxp, r.oyp, r.ozp, r.dd_o, r.oo2, dx, dy, dz};
#pragma unroll
        for (int f = 0; f < 8; ++f)
          v[f] = __shfl_sync(wpt::kFullMask, mine[f], owner);
      };
      const auto sph_t = [&](const float (&v)[8], int i) {
        return sphere_t(v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], i);
      };
      const auto fetch_tri = [&](int owner, float (&v)[6]) {
        const float mine[6] = {ox, oy, oz, dx, dy, dz};
#pragma unroll
        for (int f = 0; f < 6; ++f)
          v[f] = __shfl_sync(wpt::kFullMask, mine[f], owner);
      };
      const auto tri_t = [&](const float (&v)[6], int i) {
        return wpt::tri_test(tris + kTri * i, v[0], v[1], v[2], v[3], v[4],
                             v[5]);
      };
      // dbl_entry2's fetch: the owner's origin and direction, and from
      // the origin plus an opaque zero the shifted frame, recomputed.
      const auto fetch_sph2 = [&](int owner, float (&v)[8]) {
        float o[6];
        fetch_tri(owner, o);
        const float z = wpt::opaque_zero();
        const Ray r2 = ray(o[0] + z, o[1] + z, o[2] + z, o[3], o[4], o[5]);
        const float mine[8] = {r2.oxp, r2.oyp, r2.ozp, r2.dd_o, r2.oo2,
                               r2.dx, r2.dy, r2.dz};
#pragma unroll
        for (int f = 0; f < 8; ++f) v[f] = mine[f];
      };
      // The entry probe's second tests (v[4] is |o'|^2, v[0] the origin's
      // x).
      const auto sph_tz = [&](const float (&v)[8], int i) {
        return sphere_t(v[0], v[1], v[2], v[3], v[4] + ze, v[5], v[6], v[7],
                        i);
      };
      const auto tri_tz = [&](const float (&v)[6], int i) {
        return wpt::tri_test(tris + kTri * i, v[0] + ze, v[1], v[2], v[3],
                             v[4], v[5]);
      };
      // One cluster of each hierarchy, as the sweep reaches it.
      const auto visit_spheres = [&](int c, bool enter) {
        if (enter) ++counts.clusters;
        if constexpr (kW) {
          const unsigned m = __ballot_sync(wpt::kFullMask, enter);
          if (m == 0u) return;
          const int2 range = __ldg(spheres.ranges + c);
          if (__popc(m) > S::kT) {
            if (enter) fold_spheres(c, range.x, range.y);
          } else {
            const bool took = coop_fold<S::kG, 8>(
                m, range.x, range.y, 0, fetch_sph, sph_t, best_t, best);
            if constexpr (kDupEntry) {
              coop_fold<S::kG, 8>(m, range.x, range.y, 0, fetch_sph, sph_tz,
                                  best_t, best);
            }
            if constexpr (kDupEntry2) {
              coop_fold<S::kG, 8>(m, range.x, range.y, 0, fetch_sph2, sph_t,
                                  best_t, best);
            }
            if (kHint && took) best_c = c;
          }
        } else if (enter) {
          const int2 range = __ldg(spheres.ranges + c);
          fold_spheres(c, range.x, range.y);
        }
      };
      const auto visit_triangles = [&](int c, bool enter) {
        if (enter) ++counts.clusters;
        if constexpr (kW) {
          const unsigned m = __ballot_sync(wpt::kFullMask, enter);
          if (m == 0u) return;
          const int2 range = __ldg(triangles.ranges + c);
          if (__popc(m) > S::kT) {
            if (enter) fold_triangles(c, range.x, range.y);
          } else {
            const bool took = coop_fold<S::kG, 6>(
                m, range.x, range.y, kTriBit, fetch_tri, tri_t, best_t,
                best);
            if constexpr (kDupEntry) {
              coop_fold<S::kG, 6>(m, range.x, range.y, kTriBit, fetch_tri,
                                  tri_tz, best_t, best);
            }
            if (kHint && took) best_c = n_sph + c;
          }
        } else if (enter) {
          const int2 range = __ldg(triangles.ranges + c);
          fold_triangles(c, range.x, range.y);
        }
      };
      if (kHint && live && hint >= 0) {
        // The prepass: the previous winner's cluster, unconditionally.
        ++counts.clusters;
        if constexpr (kCountHint) ++counts.supers;
        if (hint < n_sph) {
          const int2 range = __ldg(spheres.ranges + hint);
          fold_spheres(hint, range.x, range.y);
        } else if (kTris) {
          const int2 range = __ldg(triangles.ranges + hint - n_sph);
          fold_triangles(hint - n_sph, range.x, range.y);
        }
      }
      const int skip = kHint ? hint : -1;
      if (n_sph > 0) {
        spheres.sweep<kHint, kW, kDupCond, kDupCond2>(
            live, br, dup, best_t, counts, skip, visit_spheres);
      }
      if (kTris && triangles.n_clusters > 0) {
        triangles.sweep<kHint, kW, kDupCond, kDupCond2>(
            live, br, dup, best_t, counts, skip - n_sph, visit_triangles);
      }
    }
    if (kHint && live) hint = best_c;
    return finish<kTris, kTex>(items, tex_items, tris, best, best_t, h);
  }
};

// Eight blocks per SM cap both kernels at 64 registers a thread (72 by
// default): the occupancy gained outweighs the extra spills, by 1.5% on
// the headline frame and 5% on the unculled one (PERF.md).  `P` is
// LaneParams (the persistent loop) or SegParams (one recluster segment).
// kWarp: the warp's lanes in step (trace_warp, trace_segment_warp; every
// thread of the grid joins its warp's loop, those past the last lane
// too), the shipped loop form; otherwise the per-thread loop (trace_lane,
// trace_segment).  kProbe: common.cuh's probes of the warp's loop (0 in
// the shipped kernels; in step only).
template <class P, bool kTris, bool kTex, bool kWarp, int kProbe = 0>
__global__ void __launch_bounds__(kThreads, 8)
baked_unculled_kernel(const P p, const UnculledIntersect<kTris, kTex> isect) {
  static_assert((kProbe & ~wpt::kLoopProbes) == 0,
                "the unculled intersect has no probe points");
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (kWarp) {
    wpt::trace_in_step<kProbe>(p, lane, isect);
  } else {
    static_assert(kProbe == 0, "probes run in the warp's loop");
    wpt::trace(p, lane, isect);
  }
}

// A sweep form that votes (S::kWarp) runs the warp's lanes in step
// (trace_warp, trace_segment_warp); the serial form runs them per thread
// (trace_lane, trace_segment).  kProbe: the probes of the warp's loop and
// of the intersect (0 in the shipped kernels).
template <class P, bool kTris, bool kTex, bool kHint, class S, int kProbe = 0>
__global__ void __launch_bounds__(kThreads, 8)
baked_culled_kernel(const P p,
                    CulledIntersect<kTris, kTex, kHint, S, kProbe> isect,
                    const float* __restrict__ consts) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  isect.shx = __ldg(consts + 0);
  isect.shy = __ldg(consts + 1);
  isect.shz = __ldg(consts + 2);
  for (int k = 0; k < 3; ++k) {
    isect.spheres.lo[k] = __ldg(consts + 3 + k);
    isect.spheres.hi[k] = __ldg(consts + 6 + k);
    if (kTris) {
      isect.triangles.lo[k] = __ldg(consts + 9 + k);
      isect.triangles.hi[k] = __ldg(consts + 12 + k);
    }
  }
  if constexpr (S::kWarp) {
    wpt::trace_in_step<kProbe>(p, lane, isect);
  } else {
    static_assert(kProbe == 0, "probes run in the warp's loop");
    wpt::trace(p, lane, isect);
  }
}

inline Hierarchy hierarchy(const float* boxes, const int* ranges, int n_clusters,
                    const float* sboxes, const int* sranges, int n_supers) {
  return Hierarchy{reinterpret_cast<const float4*>(boxes),
                   reinterpret_cast<const int2*>(ranges), n_clusters,
                   reinterpret_cast<const float4*>(sboxes),
                   reinterpret_cast<const int2*>(sranges), n_supers,
                   {0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
}

// The tables of one launch.
struct Tables {
  const float4* items;
  int n_globals;
  Hierarchy spheres;
  const float4* tris;
  int n_tris;
  Hierarchy triangles;
  const float* consts;
  const float4* tex_items;
  wpt::TexTables tex;
};

template <class P, bool kTris, bool kTex, bool kHint, class S,
          int kProbe = 0>
void launch_culled(const P& p, const Tables& t, cudaStream_t s) {
  const int blocks = (p.n_lanes + kThreads - 1) / kThreads;
  const CulledIntersect<kTris, kTex, kHint, S, kProbe> isect{
      t.items, t.n_globals, t.spheres, t.tris, t.triangles, t.tex_items,
      t.tex, 0.0f, 0.0f, 0.0f};
  baked_culled_kernel<P, kTris, kTex, kHint, S, kProbe>
      <<<blocks, kThreads, 0, s>>>(p, isect, t.consts);
}

// The culled kernel of sweep form `sweep`: 0 Serial, 1 Coop.  False for
// any other form.
template <class P, bool kTris, bool kTex, bool kHint>
bool launch_sweep(const P& p, int sweep, const Tables& t, cudaStream_t s) {
  if (sweep == 0) {
    launch_culled<P, kTris, kTex, kHint, Serial>(p, t, s);
    return true;
  }
  if (sweep == 1) {
    launch_culled<P, kTris, kTex, kHint, Coop>(p, t, s);
    return true;
  }
  return false;
}

template <class P, bool kTris, bool kTex, bool kWarp, int kProbe = 0>
void launch_unculled(const P& p, const Tables& t, cudaStream_t s) {
  const int blocks = (p.n_lanes + kThreads - 1) / kThreads;
  const UnculledIntersect<kTris, kTex> isect{t.items, t.n_globals, t.tris,
                                             t.n_tris, t.tex_items, t.tex};
  baked_unculled_kernel<P, kTris, kTex, kWarp, kProbe>
      <<<blocks, kThreads, 0, s>>>(p, isect);
}

// A segment never runs the winner hint (recluster and the hint exclude
// each other, utils/config.py), so only LaneParams instantiates it.  The
// unculled kernel takes `sweep` as its loop form: 0 per thread, 1 the
// warp's lanes in step.
template <class P, bool kTris, bool kTex>
bool launch(const P& p, int culled, int hint, int sweep, const Tables& t,
            cudaStream_t s) {
  if constexpr (std::is_same_v<P, wpt::LaneParams>) {
    if (culled && hint) {
      return launch_sweep<P, kTris, kTex, true>(p, sweep, t, s);
    }
  }
  if (culled) return launch_sweep<P, kTris, kTex, false>(p, sweep, t, s);
  if (sweep == 0) {
    launch_unculled<P, kTris, kTex, false>(p, t, s);
    return true;
  }
  if (sweep == 1) {
    launch_unculled<P, kTris, kTex, true>(p, t, s);
    return true;
  }
  return false;
}

// The instantiation for the scene's kinds (triangles, textures); returns
// cudaGetLastError(), or cudaErrorInvalidValue for an unknown sweep or
// loop form.
template <class P>
int dispatch(const P& p, int n_tris, int culled, int textured, int hint,
             int sweep, const Tables& t, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok;
  if (n_tris > 0 && textured) {
    ok = launch<P, true, true>(p, culled, hint, sweep, t, s);
  } else if (n_tris > 0) {
    ok = launch<P, true, false>(p, culled, hint, sweep, t, s);
  } else if (textured) {
    ok = launch<P, false, true>(p, culled, hint, sweep, t, s);
  } else {
    ok = launch<P, false, false>(p, culled, hint, sweep, t, s);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The culled kernel's probe kernel of the listed bit that equals
// `probe`, in sweep form Coop, for the scene's kinds (triangles,
// textures): the launchers of baked_probe.cu, baked_probe2.cu and
// baked_probe_seg*.cu.  False for a bitmask with no instantiation.
template <class P, bool kTris, bool kTex, bool kHint, int... kBits>
bool launch_culled_probe(const P& p, int probe, const Tables& t,
                         cudaStream_t s) {
  return wpt::with_probe_bit<kBits...>(probe, [&](auto bit) {
    launch_culled<P, kTris, kTex, kHint, Coop, decltype(bit)::value>(p, t,
                                                                     s);
  });
}

template <class P, bool kHint, int... kBits>
bool culled_probe(const P& p, bool tris, bool tex, int probe,
                  const Tables& t, cudaStream_t s) {
  if (tris) {
    return tex ? launch_culled_probe<P, true, true, kHint, kBits...>(
                     p, probe, t, s)
               : launch_culled_probe<P, true, false, kHint, kBits...>(
                     p, probe, t, s);
  }
  return tex ? launch_culled_probe<P, false, true, kHint, kBits...>(
                   p, probe, t, s)
             : launch_culled_probe<P, false, false, kHint, kBits...>(
                   p, probe, t, s);
}

// The probe kernels' launchers: one bit of common.cuh's probes for the
// scene's kinds, in the shipped forms (culled: Coop; unculled: in step).
// The persistent loop without the winner hint: the loop's probes, entry
// and cond (baked_probe.cu), entry2 and cond2 (baked_probe2.cu, with
// hint_count on the hinted kernel); unculled, the loop's probes
// (baked_probe_unculled.cu).  One culled segment: entry and cond
// (baked_probe_seg.cu), entry2 and cond2 (baked_probe_seg2.cu); a segment
// has no loop probes and never the hint.  False for a bitmask with no
// instantiation.
bool probe_launch_culled(const wpt::LaneParams& p, bool tris, bool tex,
                         int probe, const Tables& t, cudaStream_t s);
bool probe_launch_culled2(const wpt::LaneParams& p, bool tris, bool tex,
                          int probe, const Tables& t, cudaStream_t s);
bool probe_launch_hinted(const wpt::LaneParams& p, bool tris, bool tex,
                         int probe, const Tables& t, cudaStream_t s);
bool probe_launch_unculled(const wpt::LaneParams& p, bool tris, bool tex,
                           int probe, const Tables& t, cudaStream_t s);
bool probe_launch_segment(const wpt::SegParams& p, bool tris, bool tex,
                          int probe, const Tables& t, cudaStream_t s);
bool probe_launch_segment2(const wpt::SegParams& p, bool tris, bool tex,
                           int probe, const Tables& t, cudaStream_t s);

// The stage probes' dispatch (baked_probe.cu's wpt_baked_probe_dispatch
// and wpt_baked_segment_probe_dispatch), which baked.cu's entry points
// call for a non-zero `probe`: the probe kernels are built into a library
// of their own (ops/_build.py), so that the shipped library's build does
// not carry them.  Each returns cudaGetLastError(), or
// cudaErrorInvalidValue for a probe, a form or a hint that has no
// instantiation.
using ProbeDispatch = int (*)(const wpt::LaneParams& p, int n_tris,
                              int culled, int textured, int hint, int sweep,
                              int probe, const Tables& t, void* stream);
using SegmentProbeDispatch = int (*)(const wpt::SegParams& p, int n_tris,
                                     int culled, int textured, int sweep,
                                     int probe, const Tables& t,
                                     void* stream);

}  // namespace wpt::baked
