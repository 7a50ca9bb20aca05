// The differential stage probes' instantiations of dynculled.cuh's kernel
// (common.cuh kProbe) over tables without triangles: one bit each, in the
// shipped form only (the persistent loop, sweep Coop), untextured and
// textured: seven probes (raygen, shade, accum, loopcond, entry, cond,
// global), 14 kernels, in a translation unit of their own so that their
// build runs beside the other probes'.  models/fused.py stage_timing
// times them against the shipped kernel.  With the other
// dynculled_probe*.cu and baked_probe*.cu they make the stage probes'
// library (ops/_build.py), which hands dynculled.cu the two dispatch
// functions below (wpt_dynculled_set_probes) when it is loaded.

#include <cuda_runtime.h>

#include "dynculled.cuh"

namespace wpt::dyn {

bool probe_launch_spheres(const wpt::LaneParams& p, bool tex, int probe,
                          const Tables& t, cudaStream_t s) {
  return tex ? launch_probe<false, true>(p, probe, t, s)
             : launch_probe<false, false>(p, probe, t, s);
}

}  // namespace wpt::dyn

using namespace wpt::dyn;

// A stage probe's kernel (dynculled_probe.cu, dynculled_probe_tris.cu):
// one bit of common.cuh's probes, in the shipped form only (the
// persistent loop, sweep Coop).  A ProbeDispatch (dynculled.cuh).
extern "C" int wpt_dynculled_probe_dispatch(const wpt::LaneParams& p,
                                            int sweep, int probe,
                                            const Tables& t, int textured,
                                            void* stream) {
  if (sweep != 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok = t.tri.n_clusters > 0
      ? probe_launch_triangles(p, textured != 0, probe, t, s)
      : probe_launch_spheres(p, textured != 0, probe, t, s);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// A stage probe's kernel for one segment (dynculled_probe_seg*.cu): one
// bit of the intersect's probes, in the shipped form (Coop, the warp's
// lanes in step).  A SegmentProbeDispatch (dynculled.cuh).
extern "C" int wpt_dynculled_segment_probe_dispatch(
    const wpt::SegParams& p, int sweep, int probe, const Tables& t,
    int textured, void* stream) {
  if (sweep != 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok = t.tri.n_clusters > 0
      ? segment_probe_launch_triangles(p, textured != 0, probe, t, s)
      : segment_probe_launch_spheres(p, textured != 0, probe, t, s);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
