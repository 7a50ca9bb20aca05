// The differential stage probes' instantiations of dynculled.cuh's
// segment kernel over tables with triangles: the three probes of
// dynculled_probe_seg.cu, untextured and textured, 6 kernels in a
// translation unit of their own.

#include <cuda_runtime.h>

#include "dynculled.cuh"

namespace wpt::dyn {

bool segment_probe_launch_triangles(const wpt::SegParams& p, bool tex,
                                    int probe, const Tables& t,
                                    cudaStream_t s) {
  return tex ? launch_segment_probe<true, true>(p, probe, t, s)
             : launch_segment_probe<true, false>(p, probe, t, s);
}

}  // namespace wpt::dyn
