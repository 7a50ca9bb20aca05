// Issue-rate chains: exp/bf16_issue.py:66 `measure` (kernel `make_kernel`,
// line 41).
//
// Per element of x, two dependent chains: each rep 32 steps of
//   a = a * one + half;   b = b * half + one
// from (x, x + one), the output a + b, in the element's type (f32: one =
// 1.0000001, half = 0.4999999; bf16: 1.0 and 0.5; int16 and int8: 3 and 1,
// wrapping).  The TPU kernel ran them on a (256, 128) block of one core;
// here one thread carries one element (two for the packed bf16 forms) and
// copies of the block fill the card.  `one` and `half` are kernel
// arguments: as constants nvcc would fold bf16's a * 1.0 away and measure
// nothing.
//
// Forms: the reference's function with a rounding after each op (f32
// __fmul_rn then __fadd_rn; packed __hmul2 then __hadd2 on two bf16; scalar
// __hmul then __hadd; 32-bit IMAD then the wrap for int16 and int8), and
// the fused forms a prefilter would use, each a different rounding
// (__fmaf_rn; packed __hfma2).  What bounds them: instruction issue, 4 warp
// instructions a clock on each SM; a form's element rate is at most that
// times its elements an instruction (1, or 2 packed) times its operations
// an instruction (1, or 2 fused).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kSteps = 32;         // CHAIN / 2 steps of each chain a rep

enum Form : int {
  kF32 = 0, kF32Fma, kBf16x2, kBf16, kBf16x2Fma, kI16, kI8,
};

// f32 forms: x, out (n,) f32.
template <bool kFused>
__global__ void __launch_bounds__(kThreads)
issue_f32(const float* __restrict__ x, int n, int reps, float one,
          float half, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float a = x[i];
  float b = __fadd_rn(a, one);
  for (int rep = 0; rep < reps; ++rep) {
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      if constexpr (kFused) {
        a = __fmaf_rn(a, one, half);
        b = __fmaf_rn(b, half, one);
      } else {
        a = __fadd_rn(__fmul_rn(a, one), half);
        b = __fadd_rn(__fmul_rn(b, half), one);
      }
    }
  }
  out[i] = __fadd_rn(a, b);
}

// Packed bf16 forms: x, out (2n,) bf16, two elements a thread.
template <bool kFused>
__global__ void __launch_bounds__(kThreads)
issue_bf16x2(const __nv_bfloat162* __restrict__ x, int n, int reps,
             float one_f, float half_f, __nv_bfloat162* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const __nv_bfloat162 one = __float2bfloat162_rn(one_f);
  const __nv_bfloat162 half = __float2bfloat162_rn(half_f);
  __nv_bfloat162 a = x[i];
  __nv_bfloat162 b = __hadd2(a, one);
  for (int rep = 0; rep < reps; ++rep) {
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      if constexpr (kFused) {
        a = __hfma2(a, one, half);
        b = __hfma2(b, half, one);
      } else {
        a = __hadd2(__hmul2(a, one), half);
        b = __hadd2(__hmul2(b, half), one);
      }
    }
  }
  out[i] = __hadd2(a, b);
}

// Scalar bf16: x, out (n,) bf16.
__global__ void __launch_bounds__(kThreads)
issue_bf16(const __nv_bfloat16* __restrict__ x, int n, int reps,
           float one_f, float half_f, __nv_bfloat16* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const __nv_bfloat16 one = __float2bfloat16_rn(one_f);
  const __nv_bfloat16 half = __float2bfloat16_rn(half_f);
  __nv_bfloat16 a = x[i];
  __nv_bfloat16 b = __hadd(a, one);
  for (int rep = 0; rep < reps; ++rep) {
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      a = __hadd(__hmul(a, one), half);
      b = __hadd(__hmul(b, half), one);
    }
  }
  out[i] = __hadd(a, b);
}

// int16 / int8 (T): a 32-bit multiply-add, then the wrap to T.
template <class T>
__global__ void __launch_bounds__(kThreads)
issue_int(const T* __restrict__ x, int n, int reps, int one, int half,
          T* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int a = x[i];
  int b = static_cast<T>(a + one);
  for (int rep = 0; rep < reps; ++rep) {
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      a = static_cast<T>(a * one + half);
      b = static_cast<T>(b * half + one);
    }
  }
  out[i] = static_cast<T>(a + b);
}

}  // namespace

// Form `form` over `x` (n_elems elements of the form's type on the
// device) for `reps` reps with the constants `one` and `half`; out the
// same shape and type.  The packed forms take n_elems even.
extern "C" int wpt_probe_issue_launch(int form, const void* x, int n_elems,
                                      int reps, float one, float half,
                                      void* out, void* stream) {
  if (n_elems <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool packed = form == kBf16x2 || form == kBf16x2Fma;
  if (packed && n_elems % 2 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n = packed ? n_elems / 2 : n_elems;
  const int blocks = (n + kThreads - 1) / kThreads;
  switch (form) {
    case kF32:
    case kF32Fma: {
      const float* xf = static_cast<const float*>(x);
      float* of = static_cast<float*>(out);
      if (form == kF32) {
        issue_f32<false><<<blocks, kThreads, 0, s>>>(xf, n, reps, one, half,
                                                     of);
      } else {
        issue_f32<true><<<blocks, kThreads, 0, s>>>(xf, n, reps, one, half,
                                                    of);
      }
      break;
    }
    case kBf16x2:
    case kBf16x2Fma: {
      const auto* xb = static_cast<const __nv_bfloat162*>(x);
      auto* ob = static_cast<__nv_bfloat162*>(out);
      if (form == kBf16x2) {
        issue_bf16x2<false><<<blocks, kThreads, 0, s>>>(xb, n, reps, one,
                                                        half, ob);
      } else {
        issue_bf16x2<true><<<blocks, kThreads, 0, s>>>(xb, n, reps, one,
                                                       half, ob);
      }
      break;
    }
    case kBf16:
      issue_bf16<<<blocks, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), n, reps, one, half,
          static_cast<__nv_bfloat16*>(out));
      break;
    case kI16:
      issue_int<int16_t><<<blocks, kThreads, 0, s>>>(
          static_cast<const int16_t*>(x), n, reps, static_cast<int>(one),
          static_cast<int>(half), static_cast<int16_t*>(out));
      break;
    case kI8:
      issue_int<int8_t><<<blocks, kThreads, 0, s>>>(
          static_cast<const int8_t*>(x), n, reps, static_cast<int>(one),
          static_cast<int>(half), static_cast<int8_t*>(out));
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
