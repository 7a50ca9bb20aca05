// The differential stage probes' instantiations of dynculled.cuh's kernel
// (common.cuh kProbe) over tables without triangles: one bit each, in the
// shipped form only (the persistent loop, sweep Coop), untextured and
// textured: seven probes (raygen, shade, accum, loopcond, entry, cond,
// global), 14 kernels, in a translation unit of their own so that their
// build runs beside dynculled.cu's.  models/fused.py stage_timing times
// them against the shipped kernel.

#include <cuda_runtime.h>

#include "dynculled.cuh"

namespace wpt::dyn {

bool probe_launch_spheres(const wpt::LaneParams& p, bool tex, int probe,
                          const Tables& t, cudaStream_t s) {
  return tex ? launch_probe<false, true>(p, probe, t, s)
             : launch_probe<false, false>(p, probe, t, s);
}

}  // namespace wpt::dyn
