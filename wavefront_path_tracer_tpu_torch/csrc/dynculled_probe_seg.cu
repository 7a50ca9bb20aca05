// The differential stage probes' instantiations of dynculled.cuh's kernel
// for one recluster segment (SegParams, sweep Coop, the warp's lanes in
// step) over tables without triangles: the intersect's three probes
// (entry, cond, global), the probe points that fused_segment_dynculled
// reaches through its static `probe` (pallas_kernels.py:3027, 3043-3051;
// _segment_impl has none of its own), untextured and textured: 6 kernels,
// in a translation unit of their own.

#include <cuda_runtime.h>

#include "dynculled.cuh"

namespace wpt::dyn {

bool segment_probe_launch_spheres(const wpt::SegParams& p, bool tex,
                                  int probe, const Tables& t,
                                  cudaStream_t s) {
  return tex ? launch_segment_probe<false, true>(p, probe, t, s)
             : launch_segment_probe<false, false>(p, probe, t, s);
}

}  // namespace wpt::dyn
