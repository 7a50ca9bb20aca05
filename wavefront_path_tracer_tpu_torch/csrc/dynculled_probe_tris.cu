// The differential stage probes' instantiations of dynculled.cuh's kernel
// (common.cuh kProbe) over tables with triangles: the seven probes of
// dynculled_probe.cu, untextured and textured, 14 kernels in a
// translation unit of their own.

#include <cuda_runtime.h>

#include "dynculled.cuh"

namespace wpt::dyn {

bool probe_launch_triangles(const wpt::LaneParams& p, bool tex, int probe,
                            const Tables& t, cudaStream_t s) {
  return tex ? launch_probe<true, true>(p, probe, t, s)
             : launch_probe<true, false>(p, probe, t, s);
}

}  // namespace wpt::dyn
