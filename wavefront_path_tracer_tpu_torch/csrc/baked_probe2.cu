// The differential stage probes' instantiations of baked.cuh's culled
// kernel in the persistent loop (sweep Coop) that time or count the
// intersect beyond baked_probe.cu's: without the winner hint, dbl_entry2
// (an entered sphere cluster re-tested from a shifted origin) and
// dbl_cond2 (the cluster conds from shifted corners); with it, hint_count
// (the prepass counted in the supers counter).  Every kind (triangles,
// textures): 12 kernels, in a translation unit of their own.

#include <cuda_runtime.h>

#include "baked.cuh"

namespace wpt::baked {

bool probe_launch_culled2(const wpt::LaneParams& p, bool tris, bool tex,
                          int probe, const Tables& t, cudaStream_t s) {
  return culled_probe<wpt::LaneParams, false, wpt::kDblEntry2,
                      wpt::kDblCond2>(p, tris, tex, probe, t, s);
}

bool probe_launch_hinted(const wpt::LaneParams& p, bool tris, bool tex,
                         int probe, const Tables& t, cudaStream_t s) {
  return culled_probe<wpt::LaneParams, true, wpt::kHintCount>(p, tris, tex,
                                                              probe, t, s);
}

}  // namespace wpt::baked
