// The differential stage probes' instantiations of baked.cuh's unculled
// kernel (common.cuh kProbe): one bit each, in the shipped form only (the
// persistent loop with the warp's lanes in step) and for every kind
// (triangles, textures): four probes (raygen, shade, accum, loopcond), 16
// kernels, in a translation unit of their own so that their build runs
// beside baked.cu's.

#include <cuda_runtime.h>

#include "baked.cuh"

namespace wpt::baked {

namespace {

template <bool kTris, bool kTex>
bool launch(const wpt::LaneParams& p, int probe, const Tables& t,
            cudaStream_t s) {
  return wpt::with_probe_bit<wpt::kDblRaygen, wpt::kDblShade, wpt::kDblAccum,
                             wpt::kDblLoopcond>(probe, [&](auto bit) {
    launch_unculled<wpt::LaneParams, kTris, kTex, true,
                    decltype(bit)::value>(p, t, s);
  });
}

}  // namespace

bool probe_launch_unculled(const wpt::LaneParams& p, bool tris, bool tex,
                           int probe, const Tables& t, cudaStream_t s) {
  if (tris) {
    return tex ? launch<true, true>(p, probe, t, s)
               : launch<true, false>(p, probe, t, s);
  }
  return tex ? launch<false, true>(p, probe, t, s)
             : launch<false, false>(p, probe, t, s);
}

}  // namespace wpt::baked
