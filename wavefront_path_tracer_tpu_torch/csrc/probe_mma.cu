// In-kernel matrix products: exp/micro_r2.py:301 `matmul_bench`, its inner
// `kern` (315).
//
// The TPU kernel runs REPS x 4 dependent products
//   acc = acc + (a + acc[0, 0] * 1e-9) @ b
// on one core's VMEM, at seven (shape, precision) rows.  Every product
// depends on one scalar of the previous product's whole accumulator.  A
// (128, 1024) f32 accumulator is 512 KB and a (256, 256) one 256 KB, more
// than one SM holds, so here a thread block cluster shares it: each CTA
// owns one tile of acc in registers, the CTA holding acc[0, 0] writes it
// into its shared memory after each product, and every CTA reads it
// through distributed shared memory behind one cluster barrier a product
// (two slots, alternating, so one barrier suffices).  Independent cluster
// copies of the same product fill the card; copy c writes out[c].
//
// Precisions: the DEFAULT rows as TF32 `mma.sync` m16n8k8 (inputs rounded
// by cvt.rna.tf32.f32: the card's reduced-precision f32 pass, as bf16
// passes were the TPU's DEFAULT), the bf16 row as bf16 m16n8k16 with f32
// accumulation (a + s rounded to bf16), HIGHEST as FP32 __fmaf_rn chains
// (one instruction a multiply-add under -fmad=false).  Each product sums
// into a fresh f32 value that is then added to acc, as the reference's
// `acc + out`.  What bounds them: not the tensor cores' peak (2mkn a
// product at 495 TF32 or 989 bf16 TFLOP/s dense, 67 TFLOP/s FP32) but the
// product's latency and the cluster barrier a product: the shapes are
// small and every product waits on the last.  A simple mma.sync kernel,
// right first; wgmma and TMA are later work.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

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

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One row of matmul_bench: (kM, kK) @ (kK, kN), each CTA a (kMT, kNT) tile
// of acc, kThreads threads.  FP32 rows: a thread a (kRM, kRN) block of its
// tile.  Shared memory: a's rows of the tile as f32 (kMT x kK), then b's
// columns (TF32: f32 rounded once, [k][n]; bf16: [n][k] so that a k pair
// is one word; FP32: f32 [k][n]), then the two acc[0, 0] slots.
template <int kM, int kK, int kN, int kMT, int kNT, int kPrec, int kThreads,
          int kRM, int kRN>
struct Row {
  static constexpr int kTilesM = kM / kMT;
  static constexpr int kTilesN = kN / kNT;
  static constexpr int kCluster = kTilesM * kTilesN;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kMma = kPrec == kBf16 ? 16 : 8;   // k of one mma
  static constexpr int kFrags = (kMT / 16) * (kNT / 8) / kWarps;
  // Row strides in shared memory, padded so that a fragment's 32 loads
  // fall in distinct banks (unpadded, rows of 128 floats put a
  // fragment's 8 rows in one bank).
  static constexpr int kAS = kK + 4;                       // floats
  static constexpr int kBS = kPrec == kBf16 ? kK + 8 : kNT + 8;
  static constexpr int kABytes = kMT * kAS * 4;
  static constexpr int kBBytes =
      kPrec == kBf16 ? kNT * kBS * 2 : kK * kBS * 4;
  static constexpr int kSmem = kABytes + kBBytes + 16;
  static_assert(kPrec == kFp32 || (kMT / 16) * (kNT / 8) % kWarps == 0,
                "whole mma tiles a warp");
  static_assert(kPrec != kFp32 || (kMT / kRM) * (kNT / kRN) == kThreads,
                "one FP32 block a thread");
  static_assert(kK % kMma == 0, "whole mma steps");
};

template <class R, int kM, int kK, int kN, int kMT, int kNT, int kPrec,
          int kThreads, int kRM, int kRN, class In>
__global__ void __launch_bounds__(kThreads)
probe_mma(const In* __restrict__ a, const In* __restrict__ b, int products,
          float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sa = reinterpret_cast<float*>(smem);
  unsigned char* sb = smem + R::kABytes;
  float* slots = reinterpret_cast<float*>(smem + R::kABytes + R::kBBytes);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int copy = blockIdx.x / R::kCluster;
  const int m0 = (rank / R::kTilesN) * kMT;
  const int n0 = (rank % R::kTilesN) * kNT;
  const int tid = threadIdx.x;

  auto load = [](const In* p, int k) -> float {
    if constexpr (kPrec == kBf16) {
      return __bfloat162float(p[k]);
    } else {
      return p[k];
    }
  };
  for (int e = tid; e < kMT * kK; e += kThreads) {
    sa[(e / kK) * R::kAS + e % kK] =
        load(a + static_cast<size_t>(m0) * kK, e);
  }
  for (int e = tid; e < kK * kNT; e += kThreads) {
    const int k = e / kNT, n = e % kNT;
    const float v = load(b, k * kN + n0 + n);
    if constexpr (kPrec == kTf32) {
      reinterpret_cast<uint32_t*>(sb)[k * R::kBS + n] = to_tf32(v);
    } else if constexpr (kPrec == kBf16) {
      reinterpret_cast<__nv_bfloat16*>(sb)[n * R::kBS + k] =
          b[k * kN + n0 + n];
    } else {
      reinterpret_cast<float*>(sb)[k * R::kBS + n] = v;
    }
  }
  if (tid == 0) {
    slots[0] = 0.0f;
    slots[1] = 0.0f;
  }
  const float* s_owner = cluster.map_shared_rank(slots, 0);

  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  // FP32: this thread's block of the tile.
  const int rm0 = (tid / (kNT / kRN)) * kRM;
  const int rn0 = (tid % (kNT / kRN)) * kRN;
  constexpr int kAcc = kPrec == kFp32 ? kRM * kRN : R::kFrags * 4;
  float acc[kAcc];
#pragma unroll
  for (int q = 0; q < kAcc; ++q) acc[q] = 0.0f;
  // Does this thread hold acc[0, 0]?  (rank 0: FP32 thread 0's first
  // element; mma: warp 0's first tile, lane 0, c0.)
  const bool owner = rank == 0 && tid == 0;

  for (int p = 0; p < products; ++p) {
    cluster.sync();
    const float s = s_owner[p & 1] * 1e-9f;
    if constexpr (kPrec == kFp32) {
      float d[kRM * kRN];
#pragma unroll
      for (int q = 0; q < kRM * kRN; ++q) d[q] = 0.0f;
      const float* fb = reinterpret_cast<const float*>(sb);
#pragma unroll 4
      for (int k = 0; k < kK; ++k) {
        float av[kRM], bv[kRN];
#pragma unroll
        for (int i = 0; i < kRM; ++i) av[i] = sa[(rm0 + i) * R::kAS + k] + s;
#pragma unroll
        for (int j = 0; j < kRN; ++j) bv[j] = fb[k * R::kBS + rn0 + j];
#pragma unroll
        for (int i = 0; i < kRM; ++i) {
#pragma unroll
          for (int j = 0; j < kRN; ++j) {
            d[i * kRN + j] = __fmaf_rn(av[i], bv[j], d[i * kRN + j]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kRM * kRN; ++q) acc[q] = acc[q] + d[q];
    } else {
#pragma unroll
      for (int f = 0; f < R::kFrags; ++f) {
        const int t = warp + f * R::kWarps;
        const int tm = (t / (kNT / 8)) * 16, tn = (t % (kNT / 8)) * 8;
        float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        const float* ar0 = sa + (tm + gid) * R::kAS;
        const float* ar1 = ar0 + 8 * R::kAS;
#pragma unroll 2
        for (int k0 = 0; k0 < kK; k0 += R::kMma) {
          uint32_t af[4], bf[2];
          if constexpr (kPrec == kTf32) {
            const uint32_t* fb = reinterpret_cast<const uint32_t*>(sb);
            af[0] = to_tf32(ar0[k0 + tig] + s);
            af[1] = to_tf32(ar1[k0 + tig] + s);
            af[2] = to_tf32(ar0[k0 + tig + 4] + s);
            af[3] = to_tf32(ar1[k0 + tig + 4] + s);
            bf[0] = fb[(k0 + tig) * R::kBS + tn + gid];
            bf[1] = fb[(k0 + tig + 4) * R::kBS + tn + gid];
            mma_tf32(d, af, bf);
          } else {
            const int c = k0 + 2 * tig;
            af[0] = pack_bf16(ar0[c] + s, ar0[c + 1] + s);
            af[1] = pack_bf16(ar1[c] + s, ar1[c + 1] + s);
            af[2] = pack_bf16(ar0[c + 8] + s, ar0[c + 9] + s);
            af[3] = pack_bf16(ar1[c + 8] + s, ar1[c + 9] + s);
            const uint32_t* wb = reinterpret_cast<const uint32_t*>(sb) +
                                 ((tn + gid) * R::kBS + c) / 2;
            bf[0] = wb[0];
            bf[1] = wb[4];
            mma_bf16(d, af, bf);
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[f * 4 + q] = acc[f * 4 + q] + d[q];
      }
    }
    if (owner) slots[(p + 1) & 1] = acc[0];
  }
  // No CTA leaves while another may still read its shared memory.
  cluster.sync();

  float* o = out + static_cast<size_t>(copy) * kM * kN;
  if constexpr (kPrec == kFp32) {
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
#pragma unroll
      for (int j = 0; j < kRN; ++j) {
        o[(m0 + rm0 + i) * kN + n0 + rn0 + j] = acc[i * kRN + j];
      }
    }
  } else {
#pragma unroll
    for (int f = 0; f < R::kFrags; ++f) {
      const int t = warp + f * R::kWarps;
      const int r = m0 + (t / (kNT / 8)) * 16 + gid;
      const int c = n0 + (t % (kNT / 8)) * 8 + 2 * tig;
      o[r * kN + c] = acc[f * 4];
      o[r * kN + c + 1] = acc[f * 4 + 1];
      o[(r + 8) * kN + c] = acc[f * 4 + 2];
      o[(r + 8) * kN + c + 1] = acc[f * 4 + 3];
    }
  }
}

// Clusters of the row's kernel that fit on the card at once (copies <= 0:
// query only) and, with copies > 0, the launch of that many.
template <int kM, int kK, int kN, int kMT, int kNT, int kPrec, int kThreads,
          int kRM, int kRN>
cudaError_t row(const void* a, const void* b, int products, float* out,
                int copies, int* fit, cudaStream_t stream) {
  using R = Row<kM, kK, kN, kMT, kNT, kPrec, kThreads, kRM, kRN>;
  using In = typename std::conditional<kPrec == kBf16, __nv_bfloat16,
                                       float>::type;
  auto kernel = probe_mma<R, kM, kK, kN, kMT, kNT, kPrec, kThreads, kRM, kRN,
                          In>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::kSmem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = R::kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = R::kSmem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (copies <= 0) {
    cfg.gridDim = dim3(R::kCluster);
    return cudaOccupancyMaxActiveClusters(fit, kernel, &cfg);
  }
  cfg.gridDim = dim3(R::kCluster * copies);
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const In*>(a),
                           static_cast<const In*>(b), products, out);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// matmul_bench's seven rows, in its order.
cudaError_t dispatch(int r, const void* a, const void* b, int products,
                     float* out, int copies, int* fit, cudaStream_t s) {
  switch (r) {
    case 0: return row<128, 8, 1024, 128, 128, kTf32, 256, 1, 1>(
        a, b, products, out, copies, fit, s);
    case 1: return row<128, 8, 1024, 128, 128, kFp32, 256, 8, 8>(
        a, b, products, out, copies, fit, s);
    case 2: return row<16, 400, 128, 16, 32, kTf32, 128, 1, 1>(
        a, b, products, out, copies, fit, s);
    case 3: return row<16, 400, 128, 16, 32, kFp32, 128, 2, 2>(
        a, b, products, out, copies, fit, s);
    case 4: return row<256, 128, 256, 128, 64, kTf32, 256, 1, 1>(
        a, b, products, out, copies, fit, s);
    case 5: return row<256, 128, 256, 128, 64, kFp32, 256, 8, 4>(
        a, b, products, out, copies, fit, s);
    case 6: return row<256, 128, 256, 128, 64, kBf16, 256, 1, 1>(
        a, b, products, out, copies, fit, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The clusters of row `r`'s kernel that run on the card at once.
extern "C" int wpt_probe_mma_copies(int r, int* copies) {
  *copies = 0;
  return static_cast<int>(dispatch(r, nullptr, nullptr, 0, nullptr, 0,
                                   copies, nullptr));
}

// Row `r` of matmul_bench: `products` dependent products of `a` (M, K) and
// `b` (K, N) on the device (f32, or bf16 for row 6) by `copies` cluster
// copies; out (copies, M, N) f32.
extern "C" int wpt_probe_mma_launch(int r, const void* a, const void* b,
                                    int products, int copies, float* out,
                                    void* stream) {
  if (copies <= 0 || products < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(dispatch(r, a, b, products, out, copies, nullptr,
                                   static_cast<cudaStream_t>(stream)));
}
