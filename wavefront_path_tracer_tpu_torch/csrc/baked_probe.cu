// The differential stage probes' instantiations of baked.cuh's culled
// kernel (common.cuh kProbe): one bit each, in the shipped form only (the
// persistent loop, no winner hint, sweep Coop) and for every kind
// (triangles, textures): six probes (raygen, shade, accum, loopcond,
// entry, cond), 24 kernels, in a translation unit of their own so that
// their build runs beside the other probes'.  models/fused.py stage_timing
// times them against the shipped kernel.  With the other baked_probe*.cu
// and dynculled_probe*.cu they make the stage probes' library
// (ops/_build.py), which hands baked.cu the two dispatch functions below
// (wpt_baked_set_probes) when it is loaded.

#include <cuda_runtime.h>

#include "baked.cuh"

namespace wpt::baked {

bool probe_launch_culled(const wpt::LaneParams& p, bool tris, bool tex,
                         int probe, const Tables& t, cudaStream_t s) {
  return culled_probe<wpt::LaneParams, false, wpt::kDblRaygen,
                      wpt::kDblShade, wpt::kDblAccum, wpt::kDblLoopcond,
                      wpt::kDblEntry, wpt::kDblCond>(p, tris, tex, probe, t,
                                                     s);
}

}  // namespace wpt::baked

using namespace wpt::baked;

// A stage probe's kernel in the persistent loop (baked_probe.cu,
// baked_probe2.cu, baked_probe_unculled.cu): one bit of common.cuh's
// probes, in the shipped forms only (culled: Coop; unculled: in step);
// with the winner hint, hint_count alone.  A ProbeDispatch (baked.cuh).
extern "C" int wpt_baked_probe_dispatch(const wpt::LaneParams& p, int n_tris,
                                        int culled, int textured, int hint,
                                        int sweep, int probe, const Tables& t,
                                        void* stream) {
  if (sweep != 1 || (hint != 0 && !culled)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tris = n_tris > 0, tex = textured != 0;
  bool ok;
  if (hint != 0) {
    ok = probe_launch_hinted(p, tris, tex, probe, t, s);
  } else if (culled) {
    ok = probe_launch_culled(p, tris, tex, probe, t, s)
        || probe_launch_culled2(p, tris, tex, probe, t, s);
  } else {
    ok = probe_launch_unculled(p, tris, tex, probe, t, s);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// A stage probe's kernel for one segment (baked_probe_seg*.cu): one bit
// of the culled intersect's probes, in the shipped form (Coop, the warp's
// lanes in step).  The unculled segment has none (baked_intersect has no
// probe point).  A SegmentProbeDispatch (baked.cuh).
extern "C" int wpt_baked_segment_probe_dispatch(
    const wpt::SegParams& p, int n_tris, int culled, int textured, int sweep,
    int probe, const Tables& t, void* stream) {
  if (!culled || sweep != 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tris = n_tris > 0, tex = textured != 0;
  const bool ok = probe_launch_segment(p, tris, tex, probe, t, s)
      || probe_launch_segment2(p, tris, tex, probe, t, s);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
