// Int8 weight-streaming matvecs of decode, on the tensor cores:
//   out[B, N] = bf16((x[B, K] @ q[K, N]) * s[N]), fp32 accumulation, B <= 32
// (or the same product unrounded, as fp32: a tensor-parallel rank's
// row-parallel partial, summed over the ranks before it is rounded).
//
// Replaces two TPU kernels that compute the same function:
//   * macaw_llm_tpu/ops/pallas/matvec.py:79, matvec_int8 / _kernel (the
//     packed qkv, wo, gateup, down and lm_head matvecs of `generate`, up to
//     8 rows, Pallas's automatic double buffering of the weight tiles):
//     C entry macaw_matvec_int8, a fixed ring of kMatvecDepth stages;
//   * macaw_llm_tpu/ops/pallas/matvec.py:175, matvec_int8_pipelined /
//     _kernel_pipelined (the engine's 9 to 32 slots, ``depth`` weight tiles
//     in flight): C entry macaw_matvec_int8_pipelined, ``depth`` stages.
//
// Bound on the H100: bytes. A 7b decode step streams 6.6e9 int8 weights
// (1.98 ms at 3.35 TB/s); at 32 rows its 0.42 TFLOP take 0.43 ms on the
// bf16 tensor cores but 6.3 ms as fp32 FMAs on the CUDA cores. So every
// int8 weight is converted to bf16 exactly once, whatever the row count
// (about 2.75 instructions a weight), and the product runs on wgmma.
//
// Design. A and B are swapped so that the weights fill wgmma's 64-row
// side: out^T[128 columns, R] = W^T[128, K] . x^T[K, R], with R the row
// count rounded up to 8 (8, 16, 24 or 32) as the N of m64nRk16. The grid is
// (column tiles of 128, K ranges). A block is a producer warp and two
// consumer warpgroups, each of which owns 64 columns:
//   * one producer thread keeps a ring of ``depth`` stages full: per k tile
//     of 64 rows the int8 weights [64 k][128 n] (one TMA box, 128-byte
//     swizzled) and x [R][64 k] bf16 (its own TMA box, 128-byte swizzled,
//     the K-major B operand; rows past B and k past K arrive as zeros);
//   * a consumer warpgroup reads its 64 columns of the stage with 16-byte
//     shared loads (16 n at one k), converts them exactly (the byte, xor
//     0x80, under the exponent of 2^23 gives 2^23 + v + 128 as fp32; minus
//     2^23 + 128 is v; the high half of that fp32 is v as bf16), stores
//     them into a 128-byte-swizzled bf16 panel [k][64 n], which wgmma reads
//     as an MN-major A operand (the transpose bit), and releases the stage
//     once its m64nRk16 products are done. The TMA of the next stages and
//     the other resident blocks (up to three an SM) overlap each block's
//     conversion and products: on an H100 more resident blocks beat a
//     second panel that would overlap them inside a block, and a ring of 3
//     to 4 stages beats deeper ones, whose shared memory cuts the blocks
//     an SM holds.
// A ragged N (the 32007-wide lm_head: rows 32007 bytes apart, which no 2-D
// TMA map takes) uses one map per class of rows k = j (mod P) (QMaps
// below) and stages of 128 rows; the conversion shifts each row's byte
// offset out with funnel shifts.
// Each K range writes fp32 partials [splits, B, N]; a second kernel,
// launched as a programmatic dependent so that its launch overlaps this
// one's run, adds them in split order, applies the scale once and rounds
// to bf16 or writes fp32 (one range writes the output directly). No
// atomics: the same
// bits on every run and at every depth (the grid does not depend on it).
#include <cuda.h>

#include <algorithm>

#include "hopper.cuh"

namespace macaw {
namespace {

constexpr int kTileN = 128;   // columns per block, 64 per consumer warpgroup
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kRaggedRow = 144;  // a ragged stage row: 128 bytes + 16 slack
constexpr int kMatvecDepth = 3;  // macaw_matvec_int8's ring
constexpr int kMaxDepth = 8;
constexpr int kSmemMax = 232448;  // dynamic shared memory of one block
constexpr int kMaxSplits = 8;  // K ranges: bounds the fp32 workspace

// bytes between the row classes of a ragged stage of KT rows: KT / P rows
// of 144 bytes, rounded up to 128 (the alignment of a TMA box)
__host__ __device__ constexpr int class_bytes(int kt, int log_p) {
  return (((kt >> log_p) * kRaggedRow) + 127) & ~127;
}

// A stage holds KT weight rows: 64 on the TMA path; 128 on the ragged one,
// whose 16 row classes then take boxes of 8 rows (half the TMA operations
// a byte that 4-row boxes take, which was faster at the lm_head).
template <int R, bool VEC>
struct MvLayout {
  static constexpr int KT = VEC ? 64 : 128;
  static constexpr int kPanel = KT * 128;  // a warpgroup's bf16 [KT][64 n]
  static constexpr int kQBytes = VEC ? KT * kTileN : 16 * class_bytes(KT, 4);
  static constexpr int kXBytes = R * 2 * KT;  // KT / 64 panels [R][64] bf16
  static constexpr int kStage = kQBytes + kXBytes;  // a multiple of 1024
  static constexpr int bytes(int depth) {
    return depth * kStage + 2 * kPanel + 16 * depth + 1024;
  }
  // the deepest ring that fits (deeper requests are clamped: the output
  // does not depend on the depth)
  static constexpr int kDepth =
      bytes(kMaxDepth) <= kSmemMax ? kMaxDepth
                                   : (kSmemMax - 2 * kPanel - 1024 - 16 *
                                      kMaxDepth) / kStage;
};

// wgmma m64nRk16, A and B from shared memory: A MN-major (transposed), B
// K-major; D += A B
template <int R>
struct Mma;

template <>
struct Mma<8> {
  static __device__ __forceinline__ void run(float (&d)[4], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Mma<16> {
  static __device__ __forceinline__ void run(float (&d)[8], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Mma<24> {
  static __device__ __forceinline__ void run(float (&d)[12], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, %12, %13, "
        "p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Mma<32> {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, %16, %17, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(da), "l"(db), "r"(1));
  }
};

// a box of a 2-D tensor map at (c0 innermost, c1)
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// this thread's shared-memory stores visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 16 int8 weights -> 16 bf16, exact
__device__ __forceinline__ void int8x16_to_bf16(const uint32_t (&w)[4],
                                                uint4 (&out)[2]) {
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t u = w[i] ^ 0x80808080u;
    float f[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + j)) -
             8388736.f;
    }
    o[2 * i] = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]),
                           0x7632);
    o[2 * i + 1] = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]),
                               0x7632);
  }
  out[0] = make_uint4(o[0], o[1], o[2], o[3]);
  out[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

// The weight maps of a launch: one 2-D map over q [K, N] (VEC), or, for a
// ragged N, one map per class of rows k = j (mod P), P = 16 / gcd(N, 16):
// such rows lie P N bytes apart (a multiple of 16) and share the offset
// o_j = (q + j N) mod 16 from the 16-byte-aligned address below them, so
// map j starts there and reads each row's window as 144 bytes from the
// window's column c0, rows and bytes past the class's end read as zeros.
template <bool VEC>
struct QMaps {
  CUtensorMap m[VEC ? 1 : 16];
};

template <int R, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
    matvec_wgmma(const __grid_constant__ QMaps<VEC> tm_q,
                 const __grid_constant__ CUtensorMap tm_x,
                 const int8_t* __restrict__ q, float* __restrict__ ws,
                 const float* __restrict__ s, bf16* __restrict__ out,
                 float* __restrict__ out32, int B, int K, int N,
                 int tiles_per_split, int depth, int log_p) {
  using L = MvLayout<R, VEC>;
  constexpr int KT = L::KT;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* const base_ptr = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t panels = base + depth * L::kStage;
  const uint32_t full = panels + 2 * L::kPanel, empty = full + 8 * depth;
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kTileN;
  const int kt = (K + KT - 1) / KT;
  const int t0 = blockIdx.y * tiles_per_split;
  const int ntiles = max(min(t0 + tiles_per_split, kt) - t0, 0);
  // the reduce kernel may launch now: it waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  if (tid == 0) {
    for (int i = 0; i < depth; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // the producer: one lane posts each stage's bytes and issues its TMA
    // loads, ``depth`` stages ahead of the consumers
    if (tid != kConsumers) return;
    const int per_class = KT >> log_p;  // tile rows of a row class
    for (int i = 0; i < ntiles; ++i) {
      const int st = i % depth;
      if (i >= depth) mbar_wait(empty + 8 * st, ((i / depth) - 1) & 1);
      const uint32_t stage = base + st * L::kStage, bar = full + 8 * st;
      const int k0 = (t0 + i) * KT;
      if (VEC) {
        mbar_arrive_expect_tx(bar, L::kQBytes + L::kXBytes);
        tma_load_2d(stage, &tm_q.m[0], bar, c0, k0);
      } else {
        // classes with no row left in this tile are not loaded (their map
        // may be empty); the stage's rows there stay as they are: finite
        // int8 bytes that meet zero activations
        const int classes = min(1 << log_p, K - k0);
        mbar_arrive_expect_tx(
            bar, classes * per_class * kRaggedRow + L::kXBytes);
        for (int j = 0; j < classes; ++j) {
          tma_load_2d(stage + j * class_bytes(KT, log_p), &tm_q.m[j], bar,
                      c0, k0 >> log_p);
        }
      }
#pragma unroll
      for (int h = 0; h < KT / 64; ++h) {
        tma_load_2d(stage + L::kQBytes + h * R * 128, &tm_x, bar, k0 + 64 * h,
                    0);
      }
    }
    return;
  }

  // consumer warpgroup c: columns c0 + 64 c .. + 63. Conversion items: 16
  // columns (j16) at one k; a quarter warp takes eight consecutive k, so
  // its 16-byte loads and stores fall in eight distinct swizzled chunks.
  const int c = tid >> 7, w = (tid >> 5) & 3, lane = tid & 31;
  const uint32_t panel = panels + c * L::kPanel;
  unsigned char* const panel_ptr = base_ptr + (panel - base);
  const int j16 = lane >> 3;
  const uintptr_t q0 = reinterpret_cast<uintptr_t>(q);
  float d[R / 2];
#pragma unroll
  for (int i = 0; i < R / 2; ++i) d[i] = 0.f;
  for (int i = 0; i < ntiles; ++i) {
    const int st = i % depth;
    const uint32_t stage = base + st * L::kStage;
    const unsigned char* const stage_ptr = base_ptr + (stage - base);
    mbar_wait(full + 8 * st, (i / depth) & 1);
#pragma unroll
    for (int m = 0; m < KT / 32; ++m) {
      const int k = 8 * (KT / 32 * w + m) + (lane & 7);
      uint32_t raw[4];
      if (VEC) {
        const int chunk = (4 * c + j16) ^ (k & 7);
        const uint4 v = *reinterpret_cast<const uint4*>(
            stage_ptr + k * kTileN + 16 * chunk);
        raw[0] = v.x, raw[1] = v.y, raw[2] = v.z, raw[3] = v.w;
      } else {
        // row k of the tile is row k >> log_p of its class's box; its
        // window starts o_j bytes before the row's column c0
        const int at = (k & ((1 << log_p) - 1)) * class_bytes(KT, log_p) +
                       (k >> log_p) * kRaggedRow;
        const int off = static_cast<int>(
            (q0 + static_cast<uintptr_t>((t0 + i) * KT + k) * N) & 15);
        const int byte = off + 64 * c + 16 * j16;
        const uint32_t* row = reinterpret_cast<const uint32_t*>(
            stage_ptr + at);
        uint32_t wd[5];
#pragma unroll
        for (int e = 0; e < 5; ++e) wd[e] = row[(byte >> 2) + e];
        const int sh = (byte & 3) * 8;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          raw[e] = __funnelshift_r(wd[e], wd[e + 1], sh);
        }
      }
      uint4 o[2];
      int8x16_to_bf16(raw, o);
      unsigned char* prow = panel_ptr + k * 128;
      *reinterpret_cast<uint4*>(prow + 16 * ((2 * j16) ^ (k & 7))) = o[0];
      *reinterpret_cast<uint4*>(prow + 16 * ((2 * j16 + 1) ^ (k & 7))) =
          o[1];
    }
    fence_async_shared();
    warpgroup_sync(c);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      Mma<R>::run(d, desc_mnmajor(panel + kk * 2048, L::kPanel),
                  desc_kmajor(stage + L::kQBytes + (kk / 4) * R * 128 +
                              (kk % 4) * 32));
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(d);
    mbar_arrive(empty + 8 * st);
  }

  // lane 4 g + t of warp w holds columns 16 w + g (+ 8) and rows 8 j + 2 t
  // (+ 1) in d[4 j + 2 r + h]; one K range writes the output itself
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < R / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int col = c0 + 64 * c + 16 * w + g + 8 * r;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 8 * j + 2 * t + h;
        if (row < B && col < N) {
          const float v = d[4 * j + 2 * r + h];
          if (gridDim.y == 1) {
            const size_t at = static_cast<size_t>(row) * N + col;
            if (out32 != nullptr) {
              out32[at] = v * s[col];
            } else {
              out[at] = f2bf(v * s[col]);
            }
          } else {
            ws[(static_cast<size_t>(blockIdx.y) * B + row) * N + col] = v;
          }
        }
      }
    }
  }
}

// out = bf16(sum of the K ranges' partials, in range order, * s), or the
// same unrounded into out32 when it is given; launched as a programmatic
// dependent of the main kernel, so its launch overlaps the main kernel's
// run
__global__ void __launch_bounds__(256)
    matvec_reduce_kernel(const float* __restrict__ ws,
                         const float* __restrict__ s, bf16* __restrict__ out,
                         float* __restrict__ out32, int B, int N,
                         int splits) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const size_t total = static_cast<size_t>(B) * N;
  for (size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
       idx < total; idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float acc = 0.f;
    for (int sp = 0; sp < splits; ++sp) acc += ws[sp * total + idx];
    if (out32 != nullptr) {
      out32[idx] = acc * s[idx % N];
    } else {
      out[idx] = f2bf(acc * s[idx % N]);
    }
  }
}

bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
               uint64_t width, uint64_t height, uint64_t stride_bytes,
               uint32_t box_w, uint32_t box_h, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {width, height};
  const cuuint64_t strides[1] = {stride_bytes};
  const cuuint32_t box[2] = {box_w, box_h};
  const cuuint32_t elem[2] = {1, 1};
  return cuTensorMapEncodeTiled(
             map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int R, bool VEC>
cudaError_t launch(const void* x, const void* q, const void* s, void* ws,
                   void* out, int f32, int B, int K, int N, int splits,
                   int depth, cudaStream_t stream) {
  using L = MvLayout<R, VEC>;
  static const cudaError_t configured = [] {
    cudaError_t err = cudaFuncSetAttribute(
        matvec_wgmma<R, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L::bytes(L::kDepth));
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(
        matvec_wgmma<R, VEC>, cudaFuncAttributePreferredSharedMemoryCarveout,
        static_cast<int>(cudaSharedmemCarveoutMaxShared));
  }();
  if (configured != cudaSuccess) return configured;
  QMaps<VEC> mq{};
  int log_p = 0;
  const uintptr_t q0 = reinterpret_cast<uintptr_t>(q);
  if (VEC) {
    if (!encode_2d(&mq.m[0], CU_TENSOR_MAP_DATA_TYPE_UINT8, q, N, K, N,
                   kTileN, L::KT, CU_TENSOR_MAP_SWIZZLE_128B)) {
      return cudaErrorInvalidValue;
    }
  } else {
    while ((static_cast<uint64_t>(N) << log_p) % 16 != 0) ++log_p;
    const int p = 1 << log_p;
    for (int j = 0; j < p; ++j) {
      const uintptr_t row = q0 + static_cast<uintptr_t>(j) * N;
      const uintptr_t start = row & ~uintptr_t(15);
      const int rows = j < K ? (K - j + p - 1) / p : 1;  // 1: never read
      if (!encode_2d(&mq.m[j], CU_TENSOR_MAP_DATA_TYPE_UINT8,
                     reinterpret_cast<const void*>(start),
                     N + (row - start), rows,
                     static_cast<uint64_t>(p) * N, kRaggedRow, L::KT / p,
                     CU_TENSOR_MAP_SWIZZLE_NONE)) {
        return cudaErrorInvalidValue;
      }
    }
  }
  CUtensorMap mx;
  if (!encode_2d(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, B,
                 static_cast<uint64_t>(K) * 2, 64, R,
                 CU_TENSOR_MAP_SWIZZLE_128B)) {
    return cudaErrorInvalidValue;
  }
  const int kt = (K + L::KT - 1) / L::KT;
  if (splits > kt) return cudaErrorInvalidValue;
  // ``depth`` counts 64-row tiles in flight: a ragged stage holds two
  depth = std::min((depth + L::KT / 64 - 1) / (L::KT / 64), L::kDepth);
  const dim3 grid((N + kTileN - 1) / kTileN, splits);
  bf16* const out16 = f32 ? nullptr : static_cast<bf16*>(out);
  float* const out32 = f32 ? static_cast<float*>(out) : nullptr;
  matvec_wgmma<R, VEC><<<grid, kThreads, L::bytes(depth), stream>>>(
      mq, mx, static_cast<const int8_t*>(q), static_cast<float*>(ws),
      static_cast<const float*>(s), out16, out32, B, K, N,
      (kt + splits - 1) / splits, depth, log_p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  cudaLaunchConfig_t cfg = {};
  const size_t total = static_cast<size_t>(B) * N;
  cfg.gridDim = dim3(static_cast<unsigned int>(
      std::min<size_t>((total + 255) / 256, 1024)));
  cfg.blockDim = dim3(256);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, matvec_reduce_kernel,
                           static_cast<const float*>(ws),
                           static_cast<const float*>(s), out16, out32, B, N,
                           splits);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int R>
cudaError_t launch_rows(const void* x, const void* q, const void* s,
                        void* ws, void* out, int f32, int B, int K, int N,
                        int splits, int depth, cudaStream_t stream) {
  const bool vec = N % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  return vec ? launch<R, true>(x, q, s, ws, out, f32, B, K, N, splits,
                               depth, stream)
             : launch<R, false>(x, q, s, ws, out, f32, B, K, N, splits,
                                depth, stream);
}

cudaError_t run(const void* x, const void* q, const void* s, void* ws,
                void* out, int f32, int B, int K, int N, int splits,
                int depth, void* stream) {
  if (B < 1 || B > 32 || K < 1 || N < 1 || K % 8 != 0 || depth < 1 ||
      depth > kMaxDepth || splits < 1 || splits > kMaxSplits ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 8) {
    return launch_rows<8>(x, q, s, ws, out, f32, B, K, N, splits, depth,
                        st);
  }
  if (B <= 16) {
    return launch_rows<16>(x, q, s, ws, out, f32, B, K, N, splits, depth,
                         st);
  }
  if (B <= 24) {
    return launch_rows<24>(x, q, s, ws, out, f32, B, K, N, splits, depth,
                         st);
  }
  return launch_rows<32>(x, q, s, ws, out, f32, B, K, N, splits, depth,
                         st);
}

}  // namespace
}  // namespace macaw

// x bf16 [B, K] (K % 8 == 0, 16-byte aligned), q int8 [K, N], s fp32 [N],
// ws fp32 [splits, B, N] (unused for one split), out [B, N]: bf16, or fp32
// unrounded when ``f32`` is set; the K tiles of 64 rows split into
// ``splits`` (1 to 8) ranges of ceil(tiles / splits).
extern "C" int macaw_matvec_int8(const void* x, const void* q, const void* s,
                                 void* ws, void* out, int f32, int B, int K,
                                 int N, int splits, void* stream) {
  return static_cast<int>(macaw::run(x, q, s, ws, out, f32, B, K, N, splits,
                                     macaw::kMatvecDepth, stream));
}

// The same with ``depth`` (1 to 8) 64-row weight tiles in flight: a ring of
// ``depth`` stages, or of ceil(depth / 2) stages of 128 rows on the ragged
// path (clamped to what fits the shared memory); the output does not
// depend on the depth.
extern "C" int macaw_matvec_int8_pipelined(const void* x, const void* q,
                                           const void* s, void* ws, void* out,
                                           int f32, int B, int K, int N,
                                           int splits, int depth,
                                           void* stream) {
  return static_cast<int>(
      macaw::run(x, q, s, ws, out, f32, B, K, N, splits, depth, stream));
}

// Dynamic shared memory of one block for ``rows`` rows (rounded up to 8),
// the TMA (vec 1) or the ragged copy path and a ring of ``depth`` stages
// (clamped to the deepest that fits).
extern "C" int macaw_matvec_smem_bytes(int rows, int vec, int depth) {
  using namespace macaw;
  auto get = [&](auto layout) {
    using L = decltype(layout);
    return L::bytes(
        std::min((depth + L::KT / 64 - 1) / (L::KT / 64), L::kDepth));
  };
  if (rows <= 8) {
    return vec ? get(MvLayout<8, true>{}) : get(MvLayout<8, false>{});
  }
  if (rows <= 16) {
    return vec ? get(MvLayout<16, true>{}) : get(MvLayout<16, false>{});
  }
  if (rows <= 24) {
    return vec ? get(MvLayout<24, true>{}) : get(MvLayout<24, false>{});
  }
  return vec ? get(MvLayout<32, true>{}) : get(MvLayout<32, false>{});
}
