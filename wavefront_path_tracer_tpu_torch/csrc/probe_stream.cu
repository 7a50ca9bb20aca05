// Device-memory stream probe.
//
// Replaces exp/hbm_bw.py:108 `_stream_fn` (its kernel `stream_kernel`,
// 46): stream a (rows, 128) f32 buffer `passes` times, sum every row into
// an (8, 128) accumulator by row % 8, and run a dependent FMA chain of
// `fmas` a chunk beside the stream.  The TPU kernel double-buffered
// HBM -> VMEM chunks of 64 KB-4 MB on one core; here the buffer's chunks
// (8-64 KB) are split evenly over the blocks, and each block streams its
// own run of chunks in order once a pass, with one of two loads:
//
// - plain: 16-byte loads straight to registers (`probe_stream_plain`);
// - async: a two-stage `cp.async` double buffer in shared memory, the
//   next chunk in flight while this one is summed (`probe_stream_async`),
//   the analog of pltpu.make_async_copy with two slots.
//
// What bounds it: device-memory bytes (the buffer is 256 MB, five times
// the 50 MB L2).  A block owns its chunks, so between two reads of a chunk
// every block streams one pass: the whole buffer goes through L2.  Dealt
// out round-robin instead (chunk j to block j % grid), a 256 MB buffer read
// at 4.3-12.2 TB/s over hundreds of passes on an H100 80GB HBM3 at 700 W,
// above its 3.35 TB/s spec, so from L2.  A block has 256 threads; thread t always reads the 16
// bytes at column group t % 32 of a row with row % 8 == t / 32 (chunks
// start on 8-row boundaries), so it keeps one float4 partial sum.  The
// blocks' partials and chains are summed by a second kernel in block
// order, with no float atomics, so the result does not depend on timing.
// The FMA chain is __fmaf_rn: the library is built -fmad=false, so a
// written x * a + b would be two instructions, not the reference's chain.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;      // 8 row classes x 32 float4 columns
constexpr int kRowF4 = 32;         // a 128-float row is 32 float4
constexpr int kMaxBlocksPerSm = 8;

__device__ __forceinline__ void add4(float4& a, const float4& v) {
  a.x += v.x;
  a.y += v.y;
  a.z += v.z;
  a.w += v.w;
}

__device__ __forceinline__ float chain(float x, int fmas) {
  for (int f = 0; f < fmas; ++f) x = __fmaf_rn(x, 1.0000001f, 0.5f);
  return x;
}

// Block b owns chunks [b * per, (b + 1) * per), per = n_chunks / grid.
__global__ void __launch_bounds__(kThreads)
probe_stream_plain(const float4* __restrict__ data, int64_t per,
                   int chunk_f4, int passes, int fmas,
                   float4* __restrict__ part, float* __restrict__ xs) {
  const int t = threadIdx.x;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float x = 0.1f;
  const float4* mine = data + blockIdx.x * per * chunk_f4;
  for (int p = 0; p < passes; ++p) {
    for (int64_t j = 0; j < per; ++j) {
      const float4* src = mine + j * chunk_f4;
      for (int e = t; e < chunk_f4; e += kThreads) add4(acc, src[e]);
      x = chain(x, fmas);
    }
  }
  part[blockIdx.x * kThreads + t] = acc;
  xs[blockIdx.x * kThreads + t] = x;
}

__device__ __forceinline__ void copy_chunk(float4* stage, const float4* src,
                                           int chunk_f4) {
  for (int e = threadIdx.x; e < chunk_f4; e += kThreads) {
    const unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(stage + e));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(dst), "l"(src + e));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// The block's chunks as above, pass after pass: step j of the block's
// sequence reads its chunk j % per.
__global__ void __launch_bounds__(kThreads)
probe_stream_async(const float4* __restrict__ data, int64_t per,
                   int chunk_f4, int passes, int fmas,
                   float4* __restrict__ part, float* __restrict__ xs) {
  extern __shared__ float4 stage[];          // two stages of chunk_f4
  const int t = threadIdx.x;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float x = 0.1f;
  const float4* mine = data + blockIdx.x * per * chunk_f4;
  const int64_t total = per * passes;
  int slot = 0;
  if (total > 0) copy_chunk(stage, mine, chunk_f4);
  for (int64_t j = 0; j < total; ++j) {
    const int64_t next = j + 1;
    if (next < total) {
      copy_chunk(stage + (slot ^ 1) * chunk_f4,
                 mine + (next % per) * chunk_f4, chunk_f4);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const float4* cur = stage + slot * chunk_f4;
    for (int e = t; e < chunk_f4; e += kThreads) add4(acc, cur[e]);
    x = chain(x, fmas);
    __syncthreads();                          // the stage is refilled next
    slot ^= 1;
  }
  part[blockIdx.x * kThreads + t] = acc;
  xs[blockIdx.x * kThreads + t] = x;
}

// out[i * 128 + c]: the blocks' partials of class (i, c / 4) summed in
// block order, plus their chains' sum times 1e-30.
__global__ void probe_stream_reduce(const float4* __restrict__ part,
                                    const float* __restrict__ xs, int blocks,
                                    float* __restrict__ out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= 8 * 128) return;
  const int cls = (k / 128) * kRowF4 + (k % 128) / 4;
  const int comp = k % 4;
  float s = 0.0f;
  float x = 0.0f;
  for (int b = 0; b < blocks; ++b) {
    const float4 v = part[b * kThreads + cls];
    s += comp == 0 ? v.x : comp == 1 ? v.y : comp == 2 ? v.z : v.w;
    x += xs[b * kThreads + cls];
  }
  out[k] = s + x * 1e-30f;
}

int shared_bytes(int async, int chunk_f4) {
  return async ? 2 * chunk_f4 * static_cast<int>(sizeof(float4)) : 0;
}

}  // namespace

// The grid the stream launch uses for this kernel, chunk and buffer of
// n_chunks chunks: the largest divisor of n_chunks that fits on the SMs
// at once (at most 8 blocks an SM), so every block owns as many chunks;
// or a negative CUDA error.  The caller sizes the partials (grid x 256
// float4 and floats).
extern "C" int wpt_probe_stream_grid(int async, int chunk_f4,
                                     int64_t n_chunks) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  int sms = 0;
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  const int smem = shared_bytes(async, chunk_f4);
  if (err == cudaSuccess && async) {
    err = cudaFuncSetAttribute(probe_stream_async,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  }
  int per_sm = 0;
  if (err == cudaSuccess) {
    err = async ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &per_sm, probe_stream_async, kThreads, smem)
                : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &per_sm, probe_stream_plain, kThreads, 0);
  }
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (per_sm > kMaxBlocksPerSm) per_sm = kMaxBlocksPerSm;
  for (int64_t grid = per_sm * sms; grid > 0; --grid) {
    if (n_chunks % grid == 0) return static_cast<int>(grid);
  }
  return -static_cast<int>(cudaErrorInvalidValue);
}

// Stream `data` (n_chunks x chunk_f4 float4, chunk_f4 a multiple of 256)
// `passes` times with `grid` blocks of the plain or the async kernel (grid
// divides n_chunks), then reduce into out (8, 128) f32.  part and xs hold
// grid x 256 each.
extern "C" int wpt_probe_stream_launch(const float* data, int64_t n_chunks,
                                       int chunk_f4, int passes, int fmas,
                                       int async, int grid, float* part,
                                       float* xs, float* out, void* stream) {
  if (chunk_f4 <= 0 || chunk_f4 % kThreads != 0 || n_chunks <= 0
      || grid <= 0 || n_chunks % grid != 0 || passes < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t per = n_chunks / grid;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* src = reinterpret_cast<const float4*>(data);
  float4* p = reinterpret_cast<float4*>(part);
  if (async) {
    const int smem = shared_bytes(1, chunk_f4);
    const cudaError_t attr = cudaFuncSetAttribute(
        probe_stream_async, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    probe_stream_async<<<grid, kThreads, smem, s>>>(
        src, per, chunk_f4, passes, fmas, p, xs);
  } else {
    probe_stream_plain<<<grid, kThreads, 0, s>>>(src, per, chunk_f4,
                                                 passes, fmas, p, xs);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  probe_stream_reduce<<<4, 256, 0, s>>>(p, xs, grid, out);
  return static_cast<int>(cudaGetLastError());
}
