// In-kernel matrix products: exp/micro_r2.py:301 `matmul_bench`, its inner
// `kern` (315).
//
// The TPU kernel runs REPS x 4 dependent products
//   acc = acc + (a + acc[0, 0] * 1e-9) @ b
// on one core's VMEM, at seven (shape, precision) rows.  Every product
// depends on one scalar of the previous product's whole accumulator.  A
// (128, 1024) f32 accumulator is 512 KB and a (256, 256) one 256 KB, more
// than one SM holds, so here each copy of the product is a set of
// independent blocks, each owning one tile of acc in registers.  The
// scalar that couples them is not exchanged: every block also runs, in
// one more warp (the shadow), the very instruction sequence by which the
// tile holding acc[0, 0] computes its first 16 x 8 fragment (its first
// element, for FP32), from its own copy of a's first rows and b's first
// columns; the instructions are deterministic, so every block holds the
// same bits of acc[0, 0] and no block waits on another.  Copies of the
// product fill the card; copy c writes out[c].
//
// Precisions: the DEFAULT rows as TF32 `mma.sync` m16n8k8 (inputs rounded
// by cvt.rna.tf32.f32: the card's reduced-precision f32 pass, as bf16
// passes were the TPU's DEFAULT), the bf16 row as bf16 m16n8k16 with f32
// accumulation (a + s rounded to bf16), HIGHEST as FP32 __fmaf_rn chains
// (one instruction a multiply-add under -fmad=false).  Each product sums
// into a fresh f32 value that is then added to acc, as the reference's
// `acc + out`.
//
// What bounds them: the tensor cores' peak (2mkn a product at 495 TF32
// or 989 bf16 TFLOP/s dense, 67 TFLOP/s FP32) only where enough
// independent work is in flight, since every product waits on the last.
// So a product is two phases between block barriers: a + s rounded once
// an element into shared memory (tf32 words or bf16 pairs; f32 sums for
// FP32), then the products, a warp stepping k in its outer loop and its
// fragments in its inner one, so that every fragment's mma.sync chain
// (kSplit chains a fragment where K is long) is in flight at once, the
// fragments loaded by ldmatrix, each B fragment once a k step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

enum Prec : int { kTf32 = 0, kFp32 = 1, kBf16 = 2 };

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

template <int kPrec>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  if constexpr (kPrec == kTf32) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
          "r"(b[1]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
          "r"(b[1]));
  }
}

// One row of matmul_bench: (kM, kK) @ (kK, kN), each block a (kMT, kNT)
// tile of acc.  mma rows: kWarpsM x kWarpsN warps, each a (kMT / kWarpsM,
// kNT / kWarpsN) part of the tile, kSplit accumulators a fragment (k step
// j into j % kSplit, summed in order at the product's end).  FP32 rows: a
// thread a (kRM, kRN) block of the tile.  One more warp, the shadow.
//
// Shared memory, mma rows: a's rows of the tile as f32 (kMT x kK), then
// a + s rounded (kMT rows of kRowBytes: tf32 words or bf16 halves, 16
// bytes of padding so that ldmatrix's 8 rows fall in distinct banks),
// then b's columns rounded once ([n][k], kNT rows of kRowBytes); where the
// tile is not the first, the shadow's own a rows 0-15 (f32 and rounded)
// and b columns 0-7.  FP32 rows: a's tile as f32 [k][m], a + s [k][m], b
// [k][n], a's row 0 and b's column 0.  Last, acc[0, 0].
template <int kM, int kK, int kN, int kMT, int kNT, int kPrec, int kWarpsM,
          int kWarpsN, int kSplit, int kRM, int kRN>
struct Row {
  using In = typename std::conditional<kPrec == kBf16, __nv_bfloat16,
                                       float>::type;
  static constexpr int kPrecision = kPrec;
  static constexpr int kMRows = kM, kKDepth = kK, kNCols = kN;
  static constexpr int kTileM = kMT, kTileN = kNT;
  static constexpr int kTilesM = kM / kMT;
  static constexpr int kTilesN = kN / kNT;
  static constexpr int kTiles = kTilesM * kTilesN;
  static constexpr bool kMma = kPrec != kFp32;
  static constexpr int kTileThreads =
      kMma ? 32 * kWarpsM * kWarpsN : (kMT / kRM) * (kNT / kRN);
  static_assert(kMma ? kRM == 0 && kRN == 0 : kRM > 0 && kRN > 0 &&
                kWarpsM == 0 && kWarpsN == 0, "one layout a precision");
  static constexpr int kThreads = kTileThreads + 32;
  static constexpr int kShadowWarp = kTileThreads / 32;
  static constexpr int kFragM = kMma ? kMT / kWarpsM / 16 : 1;  // a warp's
  static constexpr int kFragN = kMma ? kNT / kWarpsN / 8 : 1;   // fragments
  static constexpr int kStepK = kPrec == kBf16 ? 16 : 8;   // k of one mma
  static constexpr int kSteps = kK / kStepK;
  static constexpr int kSplits = kSplit;
  static constexpr int kBlockM = kRM, kBlockN = kRN;
  static constexpr int kBlocksN = kMma ? 1 : kNT / kRN;   // FP32, along n
  static constexpr int kElem = kPrec == kBf16 ? 2 : 4;
  static constexpr int kRowBytes = kK * kElem + 16;
  static constexpr int kShadowA = kMma && kTilesM > 1;
  static constexpr int kShadowB = kMma && kTilesN > 1;
  // Byte offsets.
  static constexpr int kRaw = 0;
  static constexpr int kRound = kRaw + kMT * kK * 4;
  static constexpr int kB = kRound + (kMma ? kMT * kRowBytes : kMT * kK * 4);
  static constexpr int kShRaw = kB + (kMma ? kNT * kRowBytes : kK * kNT * 4);
  static constexpr int kShRound =
      kShRaw + (kShadowA ? 16 * kK * 4 : (kMma ? 0 : kK * 4));
  static constexpr int kShB = kShRound + (kShadowA ? 16 * kRowBytes : 0);
  static constexpr int kSlot =
      kShB + (kShadowB ? 8 * kRowBytes : (kMma ? 0 : kK * 4));
  static constexpr int kSmem = kSlot + 16;
  static_assert(!kMma || (kFragM * 16 * kWarpsM == kMT &&
                          kFragN * 8 * kWarpsN == kNT), "whole fragments");
  static_assert(!kMma || kFragN % 2 == 0 || kFragN == 1,
                "B fragments loaded in pairs");
  static_assert(kMma || (kTileThreads * kRM * kRN == kMT * kNT &&
                         kRM % 2 == 0 && kRN % 2 == 0 && kMT % 4 == 0),
                "whole FP32 blocks, loaded as pairs");
  static_assert(kK % kStepK == 0 && kK % 4 == 0, "whole mma steps");
  static_assert(kSmem <= 232448, "shared memory of one block");
};

// a + s rounded, 4 consecutive k of one row: f32 `raw` to `dst`.
template <int kPrec>
__device__ __forceinline__ void round4(const float* raw, unsigned char* dst,
                                       float s) {
  const float4 v = *reinterpret_cast<const float4*>(raw);
  if constexpr (kPrec == kTf32) {
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(to_tf32(v.x + s), to_tf32(v.y + s), to_tf32(v.z + s),
                   to_tf32(v.w + s));
  } else {
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(pack_bf16(v.x + s, v.y + s), pack_bf16(v.z + s, v.w + s));
  }
}

// kRows rows of kK f32 at `raw` (row stride kK), a + s rounded into
// `dst` (row stride kRowBytes), by kCount threads, this one `first`.
template <class R, int kRows, int kCount>
__device__ __forceinline__ void round_rows(const float* raw,
                                           unsigned char* dst, float s,
                                           int first) {
  constexpr int kGroups = R::kKDepth / 4;
#pragma unroll 8
  for (int g = first; g < kRows * kGroups; g += kCount) {
    const int m = g / kGroups, k4 = g % kGroups;
    round4<R::kPrecision>(raw + m * R::kKDepth + 4 * k4,
                          dst + m * R::kRowBytes + 4 * k4 * R::kElem, s);
  }
}

// One warp's product over the rounded a rows at `a` and b columns at `b`
// (shared memory addresses of the warp's first row and column): kFM x kFN
// fragments, k steps in the outer loop, each fragment's steps into
// kSplits accumulators, summed in order into acc.  The shadow runs it at
// 1 x 1 over the first rows and columns: the same instructions, in the
// same order, for that fragment.
template <class R, int kFM, int kFN>
__device__ __forceinline__ void warp_product(uint32_t a, uint32_t b,
                                             int lane,
                                             float (&acc)[kFM][kFN][4]) {
  constexpr int kS = R::kSplits;
  float d[kS][kFM][kFN][4];
#pragma unroll
  for (int s = 0; s < kS; ++s)
#pragma unroll
    for (int i = 0; i < kFM; ++i)
#pragma unroll
      for (int j = 0; j < kFN; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) d[s][i][j][q] = 0.0f;
  // ldmatrix: lane l gives the address of row l % 8 of matrix l / 8.
  const int mat = lane >> 3;
  const uint32_t a_lane =
      a + ((lane & 7) + ((mat & 1) << 3)) * R::kRowBytes + ((mat >> 1) << 4);
  const uint32_t b_lane =
      b + ((lane & 7) + ((mat >> 1) << 3)) * R::kRowBytes + ((mat & 1) << 4);
#pragma unroll(kS == 1 ? R::kSteps : 1)
  for (int j0 = 0; j0 < R::kSteps; j0 += kS) {
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      const int j = j0 + s;
      if (j < R::kSteps) {
        uint32_t af[kFM][4], bf[kFN][2];
#pragma unroll
        for (int i = 0; i < kFM; ++i) {
          ldsm_x4(af[i], a_lane + i * 16 * R::kRowBytes + j * 32);
        }
        if constexpr (kFN == 1) {
          ldsm_x2(bf[0], b_lane + j * 32);
        } else {
#pragma unroll
          for (int f = 0; f < kFN; f += 2) {
            uint32_t r[4];
            ldsm_x4(r, b_lane + f * 8 * R::kRowBytes + j * 32);
            bf[f][0] = r[0];
            bf[f][1] = r[1];
            bf[f + 1][0] = r[2];
            bf[f + 1][1] = r[3];
          }
        }
#pragma unroll
        for (int i = 0; i < kFM; ++i)
#pragma unroll
          for (int f = 0; f < kFN; ++f)
            mma<R::kPrecision>(d[s][i][f], af[i], bf[f]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kFM; ++i)
#pragma unroll
    for (int f = 0; f < kFN; ++f)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float t = d[0][i][f][q];
#pragma unroll
        for (int s = 1; s < kS; ++s) t = t + d[s][i][f][q];
        acc[i][f][q] = acc[i][f][q] + t;
      }
}

// `n` floats from shared memory at p (8-byte aligned, n even).
template <int kN>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; i += (kN % 4 == 0 ? 4 : 2)) {
    if constexpr (kN % 4 == 0) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      v[i] = t.x;
      v[i + 1] = t.y;
      v[i + 2] = t.z;
      v[i + 3] = t.w;
    } else {
      const float2 t = *reinterpret_cast<const float2*>(p + i);
      v[i] = t.x;
      v[i + 1] = t.y;
    }
  }
}

template <class R>
__global__ void __launch_bounds__(R::kThreads, 1)
probe_mma(const typename R::In* __restrict__ a,
          const typename R::In* __restrict__ b, int products,
          float* __restrict__ out) {
  constexpr int kK = R::kKDepth, kN = R::kNCols;
  constexpr int kMT = R::kTileM, kNT = R::kTileN;
  extern __shared__ __align__(16) unsigned char smem[];
  float* raw = reinterpret_cast<float*>(smem + R::kRaw);
  unsigned char* rounded = smem + R::kRound;
  unsigned char* sb = smem + R::kB;
  float* sh_raw = reinterpret_cast<float*>(smem + R::kShRaw);
  unsigned char* sh_round = smem + R::kShRound;
  unsigned char* sh_b = smem + R::kShB;
  float* slot = reinterpret_cast<float*>(smem + R::kSlot);
  const int tile = blockIdx.x % R::kTiles;
  const int copy = blockIdx.x / R::kTiles;
  const int m0 = (tile / R::kTilesN) * kMT;
  const int n0 = (tile % R::kTilesN) * kNT;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const bool shadow = warp == R::kShadowWarp;

  auto load = [](const typename R::In* p, int k) -> float {
    if constexpr (R::kPrecision == kBf16) {
      return __bfloat162float(p[k]);
    } else {
      return p[k];
    }
  };
  // b's columns, rounded once: TF32 words or bf16 halves [n][k], FP32
  // f32 [k][n].
  auto put_b = [&](unsigned char* dst, int n, int k, int col) {
    if constexpr (R::kPrecision == kTf32) {
      *reinterpret_cast<uint32_t*>(dst + n * R::kRowBytes + 4 * k) =
          to_tf32(b[k * kN + col]);
    } else if constexpr (R::kPrecision == kBf16) {
      *reinterpret_cast<__nv_bfloat16*>(dst + n * R::kRowBytes + 2 * k) =
          b[k * kN + col];
    } else {
      reinterpret_cast<float*>(dst)[k * kNT + n] = b[k * kN + col];
    }
  };
  for (int e = tid; e < kMT * kK; e += R::kThreads) {
    const int m = e / kK, k = e % kK;
    const float v = load(a + static_cast<size_t>(m0) * kK, e);
    if constexpr (R::kMma) {
      raw[e] = v;
    } else {
      raw[k * kMT + m] = v;
    }
  }
  for (int e = tid; e < kK * kNT; e += R::kThreads) {
    put_b(sb, e % kNT, e / kNT, n0 + e % kNT);
  }
  if constexpr (R::kShadowA) {
    for (int e = tid; e < 16 * kK; e += R::kThreads) sh_raw[e] = load(a, e);
  }
  if constexpr (R::kShadowB) {
    for (int e = tid; e < kK * 8; e += R::kThreads) {
      put_b(sh_b, e % 8, e / 8, e % 8);
    }
  }
  if constexpr (!R::kMma) {
    for (int k = tid; k < kK; k += R::kThreads) {
      sh_raw[k] = a[k];
      reinterpret_cast<float*>(sh_b)[k] = b[k * kN];
    }
  }
  if (tid == 0) slot[0] = 0.0f;
  __syncthreads();

  // The shadow's a rows and b columns: the tile's own where it is first.
  const bool own_a = m0 == 0, own_b = n0 == 0;
  const uint32_t sh_a_addr =
      smem_addr(R::kShadowA && !own_a ? sh_round : rounded);
  const uint32_t sh_b_addr = smem_addr(R::kShadowB && !own_b ? sh_b : sb);

  constexpr int kFM = R::kFragM, kFN = R::kFragN;
  constexpr int kRM = R::kBlockM, kRN = R::kBlockN;
  float acc[R::kMma ? kFM : kRM][R::kMma ? kFN : kRN]
           [R::kMma ? 4 : 1] = {};
  float shadow_acc[1][1][4] = {};
  const int wm = R::kMma ? (warp / (kNT / 8 / kFN)) * kFM * 16 : 0;
  const int wn = R::kMma ? (warp % (kNT / 8 / kFN)) * kFN * 8 : 0;
  // FP32: this thread's block of the tile.
  const int rm0 = (tid / R::kBlocksN) * kRM;
  const int rn0 = (tid % R::kBlocksN) * kRN;

  for (int p = 0; p < products; ++p) {
    const float s = slot[0] * 1e-9f;
    // Phase 1: a + s, once an element.
    if constexpr (R::kMma) {
      if (!shadow) {
        round_rows<R, kMT, R::kTileThreads>(raw, rounded, s, tid);
      } else if (R::kShadowA && !own_a) {
        round_rows<R, 16, 32>(sh_raw, sh_round, s, lane);
      }
    } else if (!shadow) {
      for (int g = tid; g < kMT * kK / 4; g += R::kTileThreads) {
        float4 v = reinterpret_cast<const float4*>(raw)[g];
        v.x = v.x + s;
        v.y = v.y + s;
        v.z = v.z + s;
        v.w = v.w + s;
        reinterpret_cast<float4*>(rounded)[g] = v;
      }
    }
    __syncthreads();
    // Phase 2: the products.
    if constexpr (R::kMma) {
      if (!shadow) {
        warp_product<R, kFM, kFN>(
            smem_addr(rounded) + wm * R::kRowBytes,
            smem_addr(sb) + wn * R::kRowBytes, lane, acc);
      } else {
        warp_product<R, 1, 1>(sh_a_addr, sh_b_addr, lane, shadow_acc);
        if (lane == 0) slot[0] = shadow_acc[0][0][0];
      }
    } else if (!shadow) {
      const float* ar = reinterpret_cast<const float*>(rounded);
      const float* br = reinterpret_cast<const float*>(sb);
      float d[kRM][kRN];
#pragma unroll
      for (int i = 0; i < kRM; ++i)
#pragma unroll
        for (int j = 0; j < kRN; ++j) d[i][j] = 0.0f;
#pragma unroll 4
      for (int k = 0; k < kK; ++k) {
        float av[kRM], bv[kRN];
        load_vec(ar + k * kMT + rm0, av);
        load_vec(br + k * kNT + rn0, bv);
#pragma unroll
        for (int i = 0; i < kRM; ++i)
#pragma unroll
          for (int j = 0; j < kRN; ++j)
            d[i][j] = __fmaf_rn(av[i], bv[j], d[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kRM; ++i)
#pragma unroll
        for (int j = 0; j < kRN; ++j) acc[i][j][0] = acc[i][j][0] + d[i][j];
    } else if (lane == 0) {
      // The chain of the tile thread that holds acc[0, 0]: its first
      // element, k in order.
      const float* sa0 = sh_raw;
      const float* sb0 = reinterpret_cast<const float*>(sh_b);
      float d = 0.0f;
      for (int k = 0; k < kK; ++k) d = __fmaf_rn(sa0[k] + s, sb0[k], d);
      shadow_acc[0][0][0] = shadow_acc[0][0][0] + d;
      slot[0] = shadow_acc[0][0][0];
    }
    __syncthreads();
  }

  if (shadow) return;
  float* o = out + static_cast<size_t>(copy) * R::kMRows * kN;
  if constexpr (R::kMma) {
    const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int i = 0; i < kFM; ++i)
#pragma unroll
      for (int f = 0; f < kFN; ++f) {
        const int r = m0 + wm + i * 16 + gid;
        const int c = n0 + wn + f * 8 + 2 * tig;
        *reinterpret_cast<float2*>(o + r * kN + c) =
            make_float2(acc[i][f][0], acc[i][f][1]);
        *reinterpret_cast<float2*>(o + (r + 8) * kN + c) =
            make_float2(acc[i][f][2], acc[i][f][3]);
      }
  } else {
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < kRN; ++j)
        o[(m0 + rm0 + i) * kN + n0 + rn0 + j] = acc[i][j][0];
  }
}

// Copies of the row's product that fit on the card at once (copies <= 0:
// query only: whole accumulators, kTiles blocks each) and, with copies >
// 0, the launch of that many.
template <class R>
cudaError_t row(const void* a, const void* b, int products, float* out,
                int copies, int* fit, cudaStream_t stream) {
  auto kernel = probe_mma<R>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::kSmem);
  if (err != cudaSuccess) return err;
  if (copies <= 0) {
    int device = 0, sms = 0, per_sm = 0;
    err = cudaGetDevice(&device);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, R::kThreads, R::kSmem);
    }
    *fit = per_sm * sms / R::kTiles;
    return err;
  }
  kernel<<<R::kTiles * copies, R::kThreads, R::kSmem, stream>>>(
      static_cast<const typename R::In*>(a),
      static_cast<const typename R::In*>(b), products, out);
  return cudaGetLastError();
}

// matmul_bench's seven rows, in its order: shape, tile, precision, warps
// (M x N), accumulators a fragment, FP32 block.
using Row0 = Row<128, 8, 1024, 128, 128, kTf32, 4, 2, 1, 0, 0>;
using Row1 = Row<128, 8, 1024, 128, 128, kFp32, 0, 0, 1, 8, 8>;
using Row2 = Row<16, 400, 128, 16, 64, kTf32, 1, 4, 2, 0, 0>;
using Row3 = Row<16, 400, 128, 16, 32, kFp32, 0, 0, 1, 2, 2>;
using Row4 = Row<256, 128, 256, 128, 64, kTf32, 4, 2, 1, 0, 0>;
using Row5 = Row<256, 128, 256, 128, 64, kFp32, 0, 0, 1, 8, 4>;
using Row6 = Row<256, 128, 256, 128, 64, kBf16, 4, 2, 1, 0, 0>;

cudaError_t dispatch(int r, const void* a, const void* b, int products,
                     float* out, int copies, int* fit, cudaStream_t s) {
  switch (r) {
    case 0: return row<Row0>(a, b, products, out, copies, fit, s);
    case 1: return row<Row1>(a, b, products, out, copies, fit, s);
    case 2: return row<Row2>(a, b, products, out, copies, fit, s);
    case 3: return row<Row3>(a, b, products, out, copies, fit, s);
    case 4: return row<Row4>(a, b, products, out, copies, fit, s);
    case 5: return row<Row5>(a, b, products, out, copies, fit, s);
    case 6: return row<Row6>(a, b, products, out, copies, fit, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The copies of row `r`'s product that run on the card at once.
extern "C" int wpt_probe_mma_copies(int r, int* copies) {
  *copies = 0;
  return static_cast<int>(dispatch(r, nullptr, nullptr, 0, nullptr, 0,
                                   copies, nullptr));
}

// Row `r` of matmul_bench: `products` dependent products of `a` (M, K) and
// `b` (K, N) on the device (f32, or bf16 for row 6) by `copies` copies;
// out (copies, M, N) f32.
extern "C" int wpt_probe_mma_launch(int r, const void* a, const void* b,
                                    int products, int copies, float* out,
                                    void* stream) {
  if (copies <= 0 || products < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(dispatch(r, a, b, products, out, copies, nullptr,
                                   static_cast<cudaStream_t>(stream)));
}
