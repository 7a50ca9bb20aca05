// The differential stage probes' instantiations of baked.cuh's culled
// segment kernel (SegParams, sweep Coop) for dbl_entry2 and dbl_cond2,
// the other two probe points of its intersect (baked_probe_seg.cu has the
// first two), for every kind: 8 kernels, in a translation unit of their
// own.

#include <cuda_runtime.h>

#include "baked.cuh"

namespace wpt::baked {

bool probe_launch_segment2(const wpt::SegParams& p, bool tris, bool tex,
                           int probe, const Tables& t, cudaStream_t s) {
  return culled_probe<wpt::SegParams, false, wpt::kDblEntry2,
                      wpt::kDblCond2>(p, tris, tex, probe, t, s);
}

}  // namespace wpt::baked
