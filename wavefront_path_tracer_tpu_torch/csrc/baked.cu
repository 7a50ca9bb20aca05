// Persistent-lane path tracing over a baked scene, for Hopper (sm_90a):
// the C entry points.  The kernels, what they replace and their design
// are baked.cuh's; this file instantiates the shipped ones (and the
// comparators of their forms), baked_probe*.cu the stage probes' (a
// library of their own, ops/_build.py).

#include <cstdint>
#include <cuda_runtime.h>

#include "baked.cuh"

using namespace wpt::baked;

namespace {

// The stage probes' dispatch (baked_probe.cu), in a library of its own
// (ops/_build.py); null until that library is loaded and hands it over
// through wpt_baked_set_probes.
ProbeDispatch probes = nullptr;
SegmentProbeDispatch segment_probes = nullptr;

}  // namespace

// Called once, where the stage probes' library is loaded, with its
// wpt_baked_probe_dispatch and wpt_baked_segment_probe_dispatch.
extern "C" void wpt_baked_set_probes(void* lane, void* segment) {
  probes = reinterpret_cast<ProbeDispatch>(lane);
  segment_probes = reinterpret_cast<SegmentProbeDispatch>(segment);
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).  With
// culled == 0 the item and triangle tables are swept in full (n_globals =
// the item table's row count) with the generic quadratic, and the box
// tables are not read.  n_tris == 0 launches the sphere-only kernels,
// textured == 0 the untextured ones (the texture tables are not read),
// hint != 0 (culled only) the winner-hint ones.  `sweep` picks the
// culled sweep's form (launch_sweep: 0 the serial fold of every cluster,
// 1 the shipped per-cluster choice), or the unculled kernel's loop form
// (0 per thread, 1 the shipped form: the warp's lanes in step, the
// triangles staged).  `probe` 0 launches the shipped kernels; one bit of
// common.cuh's probes launches that probe's kernel (`probes`: the shipped
// forms, with the hint hint_count only; any other bitmask or form, or no
// probes' library loaded, returns cudaErrorInvalidValue).  The wrapper
// (ops/baked_kernels.py) checks shapes, types, alignment and the probe's
// names.
extern "C" int wpt_baked_launch(
    const float* items, int n_globals,
    const float* cboxes, const int* cranges, int n_clusters,
    const float* sboxes, const int* sranges, int n_supers,
    const float* tris, int n_tris,
    const float* tcboxes, const int* tcranges, int n_tri_clusters,
    const float* tsboxes, const int* tsranges, int n_tri_supers,
    const float* consts, int culled,
    const float* tex_items, const float* img_centres, const int* img_words,
    int img_h, int img_w, int textured, int hint, int sweep, int probe,
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
  const Tables t{
      reinterpret_cast<const float4*>(items), n_globals,
      hierarchy(cboxes, cranges, n_clusters, sboxes, sranges, n_supers),
      reinterpret_cast<const float4*>(tris), n_tris,
      hierarchy(tcboxes, tcranges, n_tri_clusters, tsboxes, tsranges,
                n_tri_supers),
      consts, reinterpret_cast<const float4*>(tex_items),
      {reinterpret_cast<const float4*>(img_centres), img_words, img_h,
       img_w}};
  if (probe != 0) {
    return probes == nullptr
        ? static_cast<int>(cudaErrorInvalidValue)
        : probes(p, n_tris, culled, textured, hint, sweep, probe, t, stream);
  }
  return dispatch(p, n_tris, culled, textured, hint, sweep, t, stream);
}

// One recluster segment (fused_segment_baked, pallas_kernels.py:2997) over
// the same tables, culled or unculled, never with the winner hint: at
// most k_iters bounces of every live lane of the state planes, updated in
// place (common.cuh's SegParams).  `sweep` picks the form as for
// wpt_baked_launch: 0 each lane on its own thread (trace_segment), 1 the
// shipped form, the warp's lanes in step (trace_segment_warp).  `probe`
// 0 launches the shipped kernels; one bit of the culled intersect's probes
// launches that probe's segment kernel (`segment_probes`: culled, the
// shipped form).  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for an unknown form or a probe with no
// instantiation.
extern "C" int wpt_baked_segment_launch(
    const float* items, int n_globals,
    const float* cboxes, const int* cranges, int n_clusters,
    const float* sboxes, const int* sranges, int n_supers,
    const float* tris, int n_tris,
    const float* tcboxes, const int* tcranges, int n_tri_clusters,
    const float* tsboxes, const int* tsranges, int n_tri_supers,
    const float* consts, int culled,
    const float* tex_items, const float* img_centres, const int* img_words,
    int img_h, int img_w, int textured, int sweep, int probe,
    float* state, uint32_t* ids, int* counts, int n_lanes,
    uint32_t frame, uint32_t max_bounces, uint32_t k_iters,
    uint32_t rr_start, float rr_floor, float clamp, void* stream) {
  if (n_lanes <= 0) return 0;
  const wpt::SegParams p{state, ids, counts, n_lanes, frame, max_bounces,
                         k_iters, rr_start, rr_floor, clamp};
  const Tables t{
      reinterpret_cast<const float4*>(items), n_globals,
      hierarchy(cboxes, cranges, n_clusters, sboxes, sranges, n_supers),
      reinterpret_cast<const float4*>(tris), n_tris,
      hierarchy(tcboxes, tcranges, n_tri_clusters, tsboxes, tsranges,
                n_tri_supers),
      consts, reinterpret_cast<const float4*>(tex_items),
      {reinterpret_cast<const float4*>(img_centres), img_words, img_h,
       img_w}};
  if (probe != 0) {
    return segment_probes == nullptr
        ? static_cast<int>(cudaErrorInvalidValue)
        : segment_probes(p, n_tris, culled, textured, sweep, probe, t,
                         stream);
  }
  return dispatch(p, n_tris, culled, textured, 0, sweep, t, stream);
}
