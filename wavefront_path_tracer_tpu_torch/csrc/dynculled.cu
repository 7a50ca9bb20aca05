// Persistent-lane path tracing over the dynamic culled tables, for Hopper
// (sm_90a): the C entry points.  The kernel, what it replaces and its
// design are dynculled.cuh's; this file instantiates the shipped one (and
// the serial form, its comparator), dynculled_probe*.cu the stage
// probes' (a library of their own, ops/_build.py).

#include <cstdint>
#include <cuda_runtime.h>

#include "dynculled.cuh"

using namespace wpt::dyn;

namespace {

// The stage probes' dispatch (dynculled_probe.cu), in a library of its
// own (ops/_build.py); null until that library is loaded and hands it
// over through wpt_dynculled_set_probes.
ProbeDispatch probes = nullptr;
SegmentProbeDispatch segment_probes = nullptr;

}  // namespace

// Called once, where the stage probes' library is loaded, with its
// wpt_dynculled_probe_dispatch and wpt_dynculled_segment_probe_dispatch.
extern "C" void wpt_dynculled_set_probes(void* lane, void* segment) {
  probes = reinterpret_cast<ProbeDispatch>(lane);
  segment_probes = reinterpret_cast<SegmentProbeDispatch>(segment);
}

// Launch on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for an unknown sweep form.  n_tri_clusters == 0
// launches the sphere-only kernel, textured == 0 the untextured one (the
// texture tables are not read).  `sweep` picks the sweep's form
// (launch_sweep: 0 the per-thread serial fold of every cluster, 1 the
// shipped per-cluster choice).  `probe` 0 launches the shipped kernels;
// one bit of common.cuh's probes launches that probe's kernel
// (`probes`: the shipped form; any other bitmask or form, or no probes'
// library loaded, returns cudaErrorInvalidValue).  The wrapper
// (ops/dynculled_kernels.py) checks shapes, types, alignment and the
// probe's names.
extern "C" int wpt_dynculled_launch(
    const float* spheres, const float* boxes, const float* sboxes,
    const float* slab, const float* tris, const float* tboxes,
    const float* tsboxes, const float* tri_slab,
    int n_globals, int n_clusters, int n_supers, int n_tri_clusters,
    int n_tri_supers, int cluster_size,
    const float* sphere_tex, const float* img_centres, const int* img_words,
    int img_h, int img_w, int textured, int sweep, int probe,
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
  const Tables t = tables(spheres, boxes, sboxes, slab, tris, tboxes,
                          tsboxes, tri_slab, n_globals, n_clusters, n_supers,
                          n_tri_clusters, n_tri_supers, cluster_size,
                          sphere_tex, img_centres, img_words, img_h, img_w);
  if (probe != 0) {
    return probes == nullptr ? static_cast<int>(cudaErrorInvalidValue)
                             : probes(p, sweep, probe, t, textured, stream);
  }
  return dispatch(p, sweep, t, textured, stream);
}

// One recluster segment (fused_segment_dynculled, pallas_kernels.py:3027)
// over the same tables: at most k_iters bounces of every live lane of the
// state planes, updated in place (common.cuh's SegParams).  `sweep` picks
// the form as for wpt_dynculled_launch: 0 each lane on its own thread
// with the serial fold (trace_segment), 1 the shipped form, the warp's
// lanes in step with a vote per cluster (trace_segment_warp).  `probe` 0
// launches the shipped kernels; one bit of the intersect's probes launches
// that probe's segment kernel (`segment_probes`: the shipped form).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for an unknown form
// or a probe with no instantiation.
extern "C" int wpt_dynculled_segment_launch(
    const float* spheres, const float* boxes, const float* sboxes,
    const float* slab, const float* tris, const float* tboxes,
    const float* tsboxes, const float* tri_slab,
    int n_globals, int n_clusters, int n_supers, int n_tri_clusters,
    int n_tri_supers, int cluster_size,
    const float* sphere_tex, const float* img_centres, const int* img_words,
    int img_h, int img_w, int textured, int sweep, int probe,
    float* state, uint32_t* ids, int* counts, int n_lanes,
    uint32_t frame, uint32_t max_bounces, uint32_t k_iters,
    uint32_t rr_start, float rr_floor, float clamp, void* stream) {
  if (n_lanes <= 0) return 0;
  const wpt::SegParams p{state, ids, counts, n_lanes, frame, max_bounces,
                         k_iters, rr_start, rr_floor, clamp};
  const Tables t = tables(spheres, boxes, sboxes, slab, tris, tboxes,
                          tsboxes, tri_slab, n_globals, n_clusters, n_supers,
                          n_tri_clusters, n_tri_supers, cluster_size,
                          sphere_tex, img_centres, img_words, img_h, img_w);
  if (probe != 0) {
    return segment_probes == nullptr
        ? static_cast<int>(cudaErrorInvalidValue)
        : segment_probes(p, sweep, probe, t, textured, stream);
  }
  return dispatch(p, sweep, t, textured, stream);
}
