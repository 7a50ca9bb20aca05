// The differential stage probes' instantiations of baked.cuh's culled
// kernel for one recluster segment (SegParams, sweep Coop, the warp's
// lanes in step): the intersect's dbl_entry and dbl_cond, the probe
// points that fused_segment_baked reaches through its intersect
// (pallas_kernels.py:2997; _segment_impl has none of its own), for every
// kind (triangles, textures): 8 kernels, in a translation unit of their
// own.

#include <cuda_runtime.h>

#include "baked.cuh"

namespace wpt::baked {

bool probe_launch_segment(const wpt::SegParams& p, bool tris, bool tex,
                          int probe, const Tables& t, cudaStream_t s) {
  return culled_probe<wpt::SegParams, false, wpt::kDblEntry,
                      wpt::kDblCond>(p, tris, tex, probe, t, s);
}

}  // namespace wpt::baked
