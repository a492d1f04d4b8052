// Int8 weight-streaming matvec for single-token decode:
//   out[B, N] = bf16((x[B, K] @ q[K, N]) * s[N]), fp32 accumulation.
//
// Replaces: macaw_llm_tpu/ops/pallas/matvec.py:79, matvec_int8 / _kernel
// (the packed qkv, wo, gateup, down and lm_head matvecs of int8 decode).
//
// Bound on the H100: bytes. At decode batch 4 the packed qkv weight
// [4096, 12288] is 50 MB of int8 against 0.4 GFLOP, 15 us at 3.35 TB/s
// against 0.4 us at 989 TFLOP/s. So every weight byte is read once, with
// 16-byte loads, and converted to float in registers; the activations
// are tiny and sit in shared memory.
//
// Design: the TPU kernel streams column tiles through one core; here the
// grid is (column tiles of 512, K splits, row chunks). A block of four
// warps owns 512 columns of one K range: each lane owns 16 adjacent
// columns, loads them as one 16-byte vector per K row (N % 16 == 0; a
// ragged N such as the 32007-wide lm_head takes byte loads), and keeps
// RB x 16 fp32 sums for the RB activation rows of its chunk. The four warps
// take interleaved K rows and add their sums in shared memory; each split
// writes its partial [B, N] to a workspace, and a second kernel adds the
// splits, applies the per-column scale once and rounds to bf16. No atomics:
// the sum order is fixed.
#include "kernels.cuh"

namespace macaw {
namespace {

constexpr int kCols = 512;   // columns per block: 32 lanes x 16
constexpr int kWarps = 4;

__device__ __forceinline__ void unpack16(const uint4& raw, float (&w)[16]) {
  const unsigned int words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w[i * 4 + j] =
          static_cast<float>(static_cast<signed char>(words[i] >> (8 * j)));
    }
  }
}

template <int RB, bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
    matvec_partial_kernel(const bf16* __restrict__ x,
                          const int8_t* __restrict__ q,
                          float* __restrict__ ws, int B, int K, int N,
                          int rps) {
  extern __shared__ __align__(16) float sm[];
  float* xs = sm;              // [RB][rps] activations of this K range
  float* red = sm + RB * rps;  // [kWarps][kCols] per-warp sums
  const int kbeg = blockIdx.y * rps;
  const int nk = min(K - kbeg, rps);
  const int r0 = blockIdx.z * RB;
  const int cbase = blockIdx.x * kCols;

  for (int i = threadIdx.x; i < RB * rps; i += blockDim.x) {
    const int r = i / rps, kk = i % rps;
    xs[i] = (r0 + r < B && kk < nk)
                ? bf2f(x[static_cast<size_t>(r0 + r) * K + kbeg + kk])
                : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[RB][16];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[r][j] = 0.f;
  }
  for (int kk = warp; kk < nk; kk += kWarps) {
    const int8_t* rowp = q + static_cast<size_t>(kbeg + kk) * N;
    float w[16];
    if (VEC) {
      const int c = cbase + lane * 16;
      if (c < N) {
        unpack16(__ldg(reinterpret_cast<const uint4*>(rowp + c)), w);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) w[j] = 0.f;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = cbase + lane + 32 * j;
        w[j] = c < N ? static_cast<float>(rowp[c]) : 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const float xv = xs[r * rps + kk];
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[r][j] = fmaf(xv, w[j], acc[r][j]);
    }
  }

#pragma unroll
  for (int r = 0; r < RB; ++r) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = VEC ? lane * 16 + j : lane + 32 * j;
      red[warp * kCols + col] = acc[r][j];
    }
    __syncthreads();
    if (r0 + r < B) {
      for (int c = threadIdx.x; c < kCols; c += blockDim.x) {
        const int col = cbase + c;
        if (col < N) {
          ws[(static_cast<size_t>(blockIdx.y) * B + r0 + r) * N + col] =
              red[c] + red[kCols + c] + red[2 * kCols + c] +
              red[3 * kCols + c];
        }
      }
    }
  }
}

__global__ void matvec_reduce_kernel(const float* __restrict__ ws,
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

template <int RB, bool VEC>
cudaError_t launch_partial(const void* x, const void* q, void* ws, int B,
                           int K, int N, int splits, cudaStream_t stream) {
  const int rps = (K + splits - 1) / splits;
  const size_t bytes = (static_cast<size_t>(RB) * rps + kWarps * kCols) *
                       sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      matvec_partial_kernel<RB, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kCols - 1) / kCols, splits, (B + RB - 1) / RB);
  matvec_partial_kernel<RB, VEC><<<grid, kWarps * 32, bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(q),
      static_cast<float*>(ws), B, K, N, rps);
  return cudaGetLastError();
}

template <int RB>
cudaError_t launch_rows(bool vec, const void* x, const void* q, void* ws,
                        int B, int K, int N, int splits,
                        cudaStream_t stream) {
  return vec ? launch_partial<RB, true>(x, q, ws, B, K, N, splits, stream)
             : launch_partial<RB, false>(x, q, ws, B, K, N, splits, stream);
}

}  // namespace
}  // namespace macaw

extern "C" int macaw_matvec_int8(const void* x, const void* q, const void* s,
                                 void* ws, void* out, int B, int K, int N,
                                 int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec =
      N % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  cudaError_t err;
  if (B <= 1) {
    err = macaw::launch_rows<1>(vec, x, q, ws, B, K, N, splits, st);
  } else if (B <= 2) {
    err = macaw::launch_rows<2>(vec, x, q, ws, B, K, N, splits, st);
  } else if (B <= 4) {
    err = macaw::launch_rows<4>(vec, x, q, ws, B, K, N, splits, st);
  } else {
    err = macaw::launch_rows<8>(vec, x, q, ws, B, K, N, splits, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(B) * N;
  macaw::matvec_reduce_kernel<<<static_cast<unsigned int>((total + 255) / 256),
                                256, 0, st>>>(
      static_cast<const float*>(ws), static_cast<const float*>(s),
      static_cast<macaw::bf16*>(out), B, N, splits);
  return static_cast<int>(cudaGetLastError());
}
