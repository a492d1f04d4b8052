// Int8 weight-streaming matvec for multi-slot decode, all rows against each
// weight tile through an explicit multistage asynchronous copy pipeline:
//   out[B, N] = bf16((x[B, K] @ q[K, N]) * s[N]), fp32 accumulation, B <= 32.
//
// Replaces: macaw_llm_tpu/ops/pallas/matvec.py:175, matvec_int8_pipelined /
// _kernel_pipelined (x resident, ``depth`` weight tiles in flight on the
// DMA engine, one full-K dot per column tile).
//
// Bound on the H100: bytes up to about 10 rows, then the fp32 FMA rate. A 7b
// decode step streams 6.6e9 int8 weights (1.98 ms at 3.35 TB/s); at 32 rows
// it is 2 x 32 x 6.6e9 = 0.42 TFLOP, about 6.3 ms at 67 TFLOP/s of fp32 FMA
// (0.43 ms on the bf16 tensor cores, which this first version does not use).
// In practice the limit is instruction throughput: beside its 32 FMAs a
// thread executes about 13 more instructions per k (loads, the
// conversion), so the ring depth hardly shows in the time. matvec.cu keeps
// 8 rows per block and puts further rows on the grid, so at 16 or 32 rows
// it streams every weight 2 or 4 times; here every weight byte is read from
// device memory once for all rows.
//
// Design. The grid is (column tiles of 256, K ranges), sized by the wrapper
// to one wave of the blocks the card holds at once. A block of 8 warps
// owns 256 columns of one K range and walks it in chunks of 32 weight rows
// through a ring of ``depth`` shared-memory stages. A stage holds the
// chunk's int8 weights [32][256] and the activations of the same 32 k as
// fp32 [32][ROWS] (x does not fit shared memory whole: 32 rows x K = 11008
// is 704 KB as bf16). Both arrive by 16-byte cp.async: at iteration i the
// copies of chunk i + depth - 1 are started and committed as one group, then
// cp.async.wait_group(depth - 1) and a barrier hand chunk i to the math, so
// depth - 1 chunks are in flight while one is consumed (depth 1: copy,
// wait, compute, no overlap). A small first kernel lays x out as fp32
// [K][ROWS] (zero rows past B) so that a stage's activations are one
// contiguous, aligned copy and a thread reads the 8 rows it owns at one k
// as two 16-byte broadcast loads.
//
// Each thread owns 8 rows x 4 adjacent columns (32 fp32 sums): per k one
// 32-bit shared load of weights, converted exactly by the mantissa trick
// (byte ^ 0x80 placed under the exponent of 2^23, minus 2^23 + 128), and
// 32 FMAs. Warps split into ROWS/8 row groups x 2 column halves x the
// remaining factor as interleaved k slices, whose sums are added in a fixed
// order in shared memory. Each K range writes its partial [B, N] to a
// workspace and a last kernel adds the ranges in order, applies the scale
// once and rounds to bf16: no atomics, bit-identical from run to run.
//
// A ragged N (the 32007-wide lm_head: rows are not 16-byte aligned) cannot
// use 16-byte cp.async on the weights; that case fills the same ring with
// byte loads (the activations still arrive by cp.async).
#include <algorithm>

#include "kernels.cuh"

namespace macaw {
namespace {

constexpr int kTileN = 256;    // columns per block
constexpr int kChunkK = 32;    // weight rows per pipeline stage
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned int dst =
      static_cast<unsigned int>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most ``pending`` of this thread's committed groups are
// still in flight (the instruction takes an immediate).
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

template <int ROWS>
__host__ __device__ constexpr int stage_bytes() {
  return kChunkK * kTileN + kChunkK * ROWS * static_cast<int>(sizeof(float));
}

// x bf16 [B, K] -> xt fp32 [K, ROWS], rows past B zero. One block per 32 k.
template <int ROWS>
__global__ void __launch_bounds__(256)
    pipelined_transpose_kernel(const bf16* __restrict__ x,
                               float* __restrict__ xt, int B, int K) {
  __shared__ float tile[ROWS][33];
  const int k0 = blockIdx.x * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int r = ty; r < ROWS; r += 8) {
    const int k = k0 + tx;
    tile[r][tx] = (r < B && k < K)
                      ? bf2f(x[static_cast<size_t>(r) * K + k])
                      : 0.f;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < 32 * ROWS; idx += 256) {
    const int kk = idx / ROWS, r = idx % ROWS;
    if (k0 + kk < K) {
      xt[static_cast<size_t>(k0 + kk) * ROWS + r] = tile[r][kk];
    }
  }
}

// Start the copies of one chunk (weight rows k0 .. k0 + 31 of this block's
// columns, and the activations of the same k) into one stage.
template <int ROWS, bool VEC>
__device__ __forceinline__ void fill_stage(unsigned char* stage,
                                           const int8_t* __restrict__ q,
                                           const float* __restrict__ xt,
                                           int k0, int kend, int cbase,
                                           int N) {
  const int tid = threadIdx.x;
  if (VEC) {
    // 32 rows x 16 segments of 16 bytes
#pragma unroll
    for (int j = 0; j < (kChunkK * kTileN / 16) / kThreads; ++j) {
      const int seg = tid + j * kThreads;
      const int r = seg >> 4, c = (seg & 15) * 16;
      unsigned char* dst = stage + r * kTileN + c;
      if (k0 + r < kend && cbase + c < N) {
        cp_async16(dst, q + static_cast<size_t>(k0 + r) * N + cbase + c);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  } else {
    // one column per thread, byte loads
    const int col = cbase + tid;
    int8_t v[kChunkK];
#pragma unroll
    for (int r = 0; r < kChunkK; ++r) {
      v[r] = (k0 + r < kend && col < N)
                 ? q[static_cast<size_t>(k0 + r) * N + col]
                 : static_cast<int8_t>(0);
    }
#pragma unroll
    for (int r = 0; r < kChunkK; ++r) {
      stage[r * kTileN + tid] = static_cast<unsigned char>(v[r]);
    }
  }
  float* xs = reinterpret_cast<float*>(stage + kChunkK * kTileN);
  constexpr int kSegPerK = ROWS / 4;  // 16-byte segments per k
  for (int seg = tid; seg < kChunkK * kSegPerK; seg += kThreads) {
    const int r = seg / kSegPerK, part = seg % kSegPerK;
    float* dst = xs + r * ROWS + part * 4;
    if (k0 + r < kend) {
      cp_async16(dst, xt + static_cast<size_t>(k0 + r) * ROWS + part * 4);
    } else {
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

template <int ROWS, bool VEC>
__global__ void __launch_bounds__(kThreads)
    matvec_pipelined_kernel(const float* __restrict__ xt,
                            const int8_t* __restrict__ q,
                            float* __restrict__ ws, int B, int K, int N,
                            int rps, int depth) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kStage = stage_bytes<ROWS>();
  constexpr int RG = ROWS / 8;             // row groups of 8
  constexpr int KS = kWarps / (RG * 2);    // interleaved k slices
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = warp % RG, ch = (warp / RG) & 1, ks = warp / (RG * 2);
  const int cbase = blockIdx.x * kTileN;
  const int kbeg = blockIdx.y * rps;
  const int kend = min(K, kbeg + rps);
  const int nchunks = (kend - kbeg + kChunkK - 1) / kChunkK;

  float acc[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
  }

  // prologue: chunks 0 .. depth - 2, one committed group each
  for (int c = 0; c < depth - 1; ++c) {
    if (c < nchunks) {
      fill_stage<ROWS, VEC>(smem + c * kStage, q, xt, kbeg + c * kChunkK,
                            kend, cbase, N);
    }
    cp_async_commit();
  }
  for (int i = 0; i < nchunks; ++i) {
    const int nxt = i + depth - 1;
    if (nxt < nchunks) {
      // the stage consumed in iteration i - 1 (freed by its last barrier)
      fill_stage<ROWS, VEC>(smem + (nxt % depth) * kStage, q, xt,
                            kbeg + nxt * kChunkK, kend, cbase, N);
    }
    cp_async_commit();
    cp_async_wait(depth - 1);  // chunk i's group has landed
    __syncthreads();
    const unsigned char* stage = smem + (i % depth) * kStage;
    const unsigned char* wp = stage + ch * 128 + lane * 4;
    const float* xp =
        reinterpret_cast<const float*>(stage + kChunkK * kTileN) + rg * 8;
#pragma unroll 4
    for (int kk = ks; kk < kChunkK; kk += KS) {
      const unsigned int word =
          *reinterpret_cast<const unsigned int*>(wp + kk * kTileN) ^
          0x80808080u;
      const float4 xa = *reinterpret_cast<const float4*>(xp + kk * ROWS);
      const float4 xb = *reinterpret_cast<const float4*>(xp + kk * ROWS + 4);
      // int8 -> fp32, exact: 2^23 + (v + 128) has v + 128 in its low
      // mantissa byte
      float w[4];
      w[0] = __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7540)) -
             8388736.f;
      w[1] = __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7541)) -
             8388736.f;
      w[2] = __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7542)) -
             8388736.f;
      w[3] = __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7543)) -
             8388736.f;
      const float xr[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
      for (int r = 0; r < 8; ++r) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(xr[r], w[j], acc[r][j]);
      }
    }
    __syncthreads();
  }
  cp_async_wait(0);

  // add the k slices in order and write this K range's partial sums
  float* red = reinterpret_cast<float*>(smem);  // [KS][ROWS][kTileN]
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    *reinterpret_cast<float4*>(
        red + (static_cast<size_t>(ks) * ROWS + rg * 8 + r) * kTileN +
        ch * 128 + lane * 4) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  __syncthreads();
  for (int idx = tid; idx < ROWS * kTileN; idx += kThreads) {
    const int row = idx / kTileN, col = cbase + idx % kTileN;
    if (row < B && col < N) {
      float sum = red[idx];
#pragma unroll
      for (int sl = 1; sl < KS; ++sl) sum += red[sl * ROWS * kTileN + idx];
      ws[(static_cast<size_t>(blockIdx.y) * B + row) * N + col] = sum;
    }
  }
}

__global__ void pipelined_reduce_kernel(const float* __restrict__ ws,
                                        const float* __restrict__ s,
                                        bf16* __restrict__ out, int B, int N,
                                        int splits) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  const size_t total = static_cast<size_t>(B) * N;
  if (idx >= total) return;
  float acc = 0.f;
  for (int sp = 0; sp < splits; ++sp) acc += ws[sp * total + idx];
  out[idx] = f2bf(acc * s[idx % N]);
}

// Dynamic shared memory of a launch: the ring, or the [KS][ROWS][kTileN]
// fp32 sums of the epilogue. Also asks for the largest shared-memory
// carveout, so that the ring does not cut the resident blocks per SM.
template <int ROWS, bool VEC>
cudaError_t configure(int depth, int* bytes) {
  const int red_bytes = (kWarps / (ROWS / 8 * 2)) * ROWS * kTileN *
                        static_cast<int>(sizeof(float));
  *bytes = std::max(depth * stage_bytes<ROWS>(), red_bytes);
  cudaError_t err = cudaFuncSetAttribute(
      matvec_pipelined_kernel<ROWS, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, *bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      matvec_pipelined_kernel<ROWS, VEC>,
      cudaFuncAttributePreferredSharedMemoryCarveout,
      static_cast<int>(cudaSharedmemCarveoutMaxShared));
}

template <int ROWS, bool VEC>
cudaError_t launch_main(const float* xt, const void* q, void* ws, int B,
                        int K, int N, int splits, int rps, int depth,
                        cudaStream_t stream) {
  int bytes = 0;
  cudaError_t err = configure<ROWS, VEC>(depth, &bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kTileN - 1) / kTileN, splits);
  matvec_pipelined_kernel<ROWS, VEC><<<grid, kThreads, bytes, stream>>>(
      xt, static_cast<const int8_t*>(q), static_cast<float*>(ws), B, K, N,
      rps, depth);
  return cudaGetLastError();
}

template <int ROWS, bool VEC>
int resident_blocks(int depth) {
  int bytes = 0, blocks = 0;
  if (configure<ROWS, VEC>(depth, &bytes) != cudaSuccess) return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, matvec_pipelined_kernel<ROWS, VEC>, kThreads, bytes) !=
      cudaSuccess) {
    return -1;
  }
  return blocks;
}

template <int ROWS>
cudaError_t launch_rows(bool vec, const void* x, const void* q, void* xt,
                        void* ws, int B, int K, int N, int splits, int rps,
                        int depth, cudaStream_t stream) {
  pipelined_transpose_kernel<ROWS><<<(K + 31) / 32, 256, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<float*>(xt), B, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float* xtf = static_cast<const float*>(xt);
  return vec ? launch_main<ROWS, true>(xtf, q, ws, B, K, N, splits, rps,
                                       depth, stream)
             : launch_main<ROWS, false>(xtf, q, ws, B, K, N, splits, rps,
                                        depth, stream);
}

}  // namespace
}  // namespace macaw

// Blocks of the main kernel that one SM holds at once, for the row-block
// instance that takes ``rows`` rows (8, 16 or 32), the 16-byte or the byte
// copy path and a ring of ``depth`` stages; -1 on error. The wrapper sizes
// its grid to one such wave.
extern "C" int macaw_matvec_int8_pipelined_blocks_per_sm(int rows, int vec,
                                                         int depth) {
  if (rows <= 8) {
    return vec ? macaw::resident_blocks<8, true>(depth)
               : macaw::resident_blocks<8, false>(depth);
  }
  if (rows <= 16) {
    return vec ? macaw::resident_blocks<16, true>(depth)
               : macaw::resident_blocks<16, false>(depth);
  }
  return vec ? macaw::resident_blocks<32, true>(depth)
             : macaw::resident_blocks<32, false>(depth);
}

// xt: fp32 scratch of K x ROWS (ROWS = 8, 16 or 32, the row count rounded
// up); ws: fp32 scratch of splits x B x N. rps, the rows of K per range, is
// a multiple of 32 with splits = ceil(K / rps); 1 <= depth <= 8.
extern "C" int macaw_matvec_int8_pipelined(const void* x, const void* q,
                                           const void* s, void* xt, void* ws,
                                           void* out, int B, int K, int N,
                                           int splits, int rps, int depth,
                                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > 32 || depth < 1 || depth > 8 || rps % 32 != 0 ||
      static_cast<long long>(splits) * rps < K) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec =
      N % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  cudaError_t err;
  if (B <= 8) {
    err = macaw::launch_rows<8>(vec, x, q, xt, ws, B, K, N, splits, rps,
                                depth, st);
  } else if (B <= 16) {
    err = macaw::launch_rows<16>(vec, x, q, xt, ws, B, K, N, splits, rps,
                                 depth, st);
  } else {
    err = macaw::launch_rows<32>(vec, x, q, xt, ws, B, K, N, splits, rps,
                                 depth, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(B) * N;
  macaw::pipelined_reduce_kernel<<<
      static_cast<unsigned int>((total + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(ws), static_cast<const float*>(s),
      static_cast<macaw::bf16*>(out), B, N, splits);
  return static_cast<int>(cudaGetLastError());
}
