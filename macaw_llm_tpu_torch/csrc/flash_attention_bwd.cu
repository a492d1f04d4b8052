// Flash-attention backward: dq (B3) and dk/dv (B4), probabilities
// recomputed from the forward's log-sum-exp.
//
// Replaces: macaw_llm_tpu/ops/pallas/flash_attention.py:366 (_bwd_dq_kernel)
// and :413 (_bwd_dkv_kernel), the two pallas_calls of _flash_bwd.
//
// Both kernels take q/dO [B, Sq, N, D], k/v [B, Sk, N, D] bf16, lse and
// delta fp32 [B*N, Sq] (delta = rowsum(dO * O), less the LSE cotangent when
// there is one), an optional additive fp32 padding bias [B, Sk], and recompute
//   S  = Q K^T * scale + bias (masked),  P = exp(S - lse),
//   dP = dO V^T,                         dS = P * (dP - delta)  (bf16),
//   dQ = dS K * scale,  dK = dS^T Q * scale,  dV = P^T dO  (P in bf16),
// with fp32 accumulation, as the TPU kernels do. P is forced to 0 where the
// key is masked and on rows whose lse is NEG_INF (a query with no valid key:
// its forward output is zeros), so such rows give zero gradients.
//
// Bound on the H100 at the train shape (B=8, S=1080, N=32, D=128, causal):
// operations. dq does 3 and dk/dv 4 [S x S x D] products over the causal
// half, 4.8e11 and 6.4e11 FLOP against 3.3e8 bytes of inputs and outputs.
//
// Design (first version: right and simple, no wgmma/TMA): the TPU grid's
// sequential axis becomes a loop inside the block, and the two kernels keep
// the TPU's split so that neither needs atomics and both are deterministic.
//  * dq: one block per (batch x head, 64-query tile), four warps of 16 query
//    rows. Q, dO and the fp32 dQ accumulator of a warp stay in shared memory;
//    the block streams K/V tiles of BK keys up to the causal diagonal, each
//    staged once for all four warps. S and dP are WMMA products (bf16
//    operands, fp32 accumulate) through one fp32 tile; each lane turns half a
//    row of them into P and dS in registers.
//  * dk/dv: one block per (batch x head, 16 x WARPS keys), each warp owning
//    16 keys with their K, V and fp32 dK, dV accumulators in shared memory;
//    the block streams 64-query tiles of Q, dO, lse and delta from the
//    causal diagonal down to the end and works on the transposed tiles
//    (S^T = K Q^T, dP^T = V dO^T), so both updates are plain row-major
//    products. Query rows past Sq carry lse NEG_INF and add nothing.
// Head dims 64, 128 and 256. At D = 256 the dq kernel takes 32-key tiles and
// the dk/dv kernel 32 keys per block (two warps), to stay inside 227 KB.
#include "kernels.cuh"

using namespace nvcuda;

namespace macaw {
namespace {

// A logit or lse at or below this is masked (NEG_INF plus a finite term).
constexpr float kMaskedLogit = -1e30f;

using AFrag = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using BColFrag =
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using BRowFrag =
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using CFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// out[16 x 16*NT] (fp32, pitch po) = A[16 x D] (bf16, pitch pa) times the
// transpose of B[16*NT x D] (bf16, pitch pb): the "Q K^T" product.
template <int D, int NT>
__device__ __forceinline__ void mm_abt(const bf16* a, int pa, const bf16* b,
                                       int pb, float* out, int po) {
#pragma unroll
  for (int c = 0; c < NT; ++c) {
    CFrag acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      AFrag af;
      BColFrag bf;
      wmma::load_matrix_sync(af, a + kk * 16, pa);
      wmma::load_matrix_sync(bf, b + c * 16 * pb + kk * 16, pb);
      wmma::mma_sync(acc, af, bf, acc);
    }
    wmma::store_matrix_sync(out + c * 16, acc, po, wmma::mem_row_major);
  }
}

// acc[16 x D] (fp32, pitch pc) += A[16 x 16*KT] (bf16, pitch pa) times
// B[16*KT x D] (bf16, pitch pb): the "dS K" product.
template <int D, int KT>
__device__ __forceinline__ void mm_ab_acc(const bf16* a, int pa, const bf16* b,
                                          int pb, float* acc, int pc) {
  for (int nn = 0; nn < D / 16; ++nn) {
    CFrag o;
    wmma::load_matrix_sync(o, acc + nn * 16, pc, wmma::mem_row_major);
#pragma unroll
    for (int c = 0; c < KT; ++c) {
      AFrag af;
      BRowFrag bf;
      wmma::load_matrix_sync(af, a + c * 16, pa);
      wmma::load_matrix_sync(bf, b + c * 16 * pb + nn * 16, pb);
      wmma::mma_sync(o, af, bf, o);
    }
    wmma::store_matrix_sync(acc + nn * 16, o, pc, wmma::mem_row_major);
  }
}

// rows [r0, r0 + rows) of a [S, N, D] head slice into shared memory at
// pitch pd; rows at or past s are zeros
template <int D>
__device__ __forceinline__ void stage_rows(bf16* dst, int pd, const bf16* src,
                                           size_t tok, int r0, int rows, int s,
                                           int tid, int nthreads) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < rows * CH; i += nthreads) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = zero;
    if (r0 + r < s) {
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * tok + c);
    }
    *reinterpret_cast<uint4*>(dst + r * pd + c) = val;
  }
}

// ---------------------------------------------------------------- dq (B3)

template <int D, int BK>
struct DqLayout {
  static constexpr int BQ = 64, WARPS = 4;
  static constexpr int PD = D + 8;   // bf16 pitch: Q, dO, K and V tiles
  static constexpr int PA = D + 4;   // fp32 pitch: dQ accumulator
  static constexpr int PS = BK + 4;  // fp32 pitch: S / dP tile
  static constexpr int PP = BK + 8;  // bf16 pitch: dS tile
  static constexpr int kWarpBytes =
      2 * 16 * PD * 2 + 16 * PA * 4 + 16 * PS * 4 + 16 * PP * 2;
  static constexpr int kBytes = 2 * BK * PD * 2 + WARPS * kWarpBytes;
};

template <int D, int BK>
__global__ void __launch_bounds__(128)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const float* __restrict__ bias,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dq,
                        int Sq, int Sk, int N, float scale, int causal) {
  using L = DqLayout<D, BK>;
  constexpr int PD = L::PD, PA = L::PA, PS = L::PS, PP = L::PP;
  constexpr int COLS = BK / 2, HALF = D / 2;
  extern __shared__ __align__(128) unsigned char smem[];

  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + BK * PD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* wb = smem + 2 * BK * PD * 2 + warp * L::kWarpBytes;
  bf16* qs = reinterpret_cast<bf16*>(wb);
  bf16* dos = qs + 16 * PD;
  float* acc = reinterpret_cast<float*>(wb + 2 * 16 * PD * 2);
  float* ss = acc + 16 * PA;
  bf16* dss = reinterpret_cast<bf16*>(ss + 16 * PS);

  const int bn = blockIdx.y, b = bn / N, n = bn % N;
  const size_t tok = static_cast<size_t>(N) * D;
  const size_t qoff = static_cast<size_t>(b) * Sq * tok +
                      static_cast<size_t>(n) * D;
  const size_t koff = static_cast<size_t>(b) * Sk * tok +
                      static_cast<size_t>(n) * D;
  const float* bb = bias != nullptr ? bias + static_cast<size_t>(b) * Sk
                                    : nullptr;

  const int q0 = blockIdx.x * L::BQ + warp * 16;
  // each lane owns half a row: BK/2 entries of a tile, D/2 output columns
  const int row = lane >> 1, half = lane & 1, qi = q0 + row;

  stage_rows<D>(qs, PD, q + qoff, tok, q0, 16, Sq, lane, 32);
  stage_rows<D>(dos, PD, dout + qoff, tok, q0, 16, Sq, lane, 32);
  for (int i = lane; i < 16 * PA; i += 32) acc[i] = 0.f;
  float row_lse = kNegInf, row_delta = 0.f;
  if (qi < Sq) {
    row_lse = lse[static_cast<size_t>(bn) * Sq + qi];
    row_delta = delta[static_cast<size_t>(bn) * Sq + qi];
  }
  const bool row_live = row_lse > kMaskedLogit;
  __syncwarp();

  int kt_end = (Sk + BK - 1) / BK;
  if (causal) {
    const int last_q = blockIdx.x * L::BQ + L::BQ - 1;
    kt_end = min(kt_end, last_q / BK + 1);
  }
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous tile
    stage_rows<D>(ks, PD, k + koff, tok, k0, BK, Sk, threadIdx.x, blockDim.x);
    stage_rows<D>(vs, PD, v + koff, tok, k0, BK, Sk, threadIdx.x, blockDim.x);
    __syncthreads();
    if (q0 >= Sq || (causal && k0 > q0 + 15)) continue;

    mm_abt<D, BK / 16>(qs, PD, ks, PD, ss, PS);  // S (unscaled)
    __syncwarp();
    float p[COLS];
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int col = half * COLS + c;
      const float s = masked_score(ss[row * PS + col], scale, bb, k0 + col,
                                   qi, Sk, causal != 0);
      p[c] = (row_live && s > kMaskedLogit) ? expf(s - row_lse) : 0.f;
    }
    __syncwarp();
    mm_abt<D, BK / 16>(dos, PD, vs, PD, ss, PS);  // dP
    __syncwarp();
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int col = half * COLS + c;
      dss[row * PP + col] = f2bf(p[c] * (ss[row * PS + col] - row_delta));
    }
    __syncwarp();
    mm_ab_acc<D, BK / 16>(dss, PP, ks, PD, acc, PA);  // dQ += dS K
    __syncwarp();
  }

  if (qi < Sq) {
    bf16* out = dq + qoff + static_cast<size_t>(qi) * tok + half * HALF;
    for (int c = 0; c < HALF; ++c) {
      out[c] = f2bf(acc[row * PA + half * HALF + c] * scale);
    }
  }
}

// ------------------------------------------------------------- dk/dv (B4)

template <int D, int WARPS>
struct DkvLayout {
  static constexpr int BQ = 64, BKV = 16 * WARPS;
  static constexpr int PD = D + 8;   // bf16 pitch: Q, dO, K and V rows
  static constexpr int PA = D + 4;   // fp32 pitch: dK, dV accumulators
  static constexpr int PS = BQ + 4;  // fp32 pitch: S^T / dP^T tile
  static constexpr int PP = BQ + 8;  // bf16 pitch: P^T / dS^T tile
  static constexpr int kTileBytes = 2 * BQ * PD * 2 + 2 * BQ * 4;
  static constexpr int kWarpBytes =
      2 * 16 * PD * 2 + 2 * 16 * PA * 4 + 16 * PS * 4 + 16 * PP * 2;
  static constexpr int kBytes = kTileBytes + WARPS * kWarpBytes;
};

template <int D, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const float* __restrict__ bias,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq,
                         int Sk, int N, float scale, int causal) {
  using L = DkvLayout<D, WARPS>;
  constexpr int PD = L::PD, PA = L::PA, PS = L::PS, PP = L::PP, BQ = L::BQ;
  constexpr int COLS = BQ / 2, HALF = D / 2;
  extern __shared__ __align__(128) unsigned char smem[];

  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + BQ * PD;
  float* lse_s = reinterpret_cast<float*>(smem + 2 * BQ * PD * 2);
  float* delta_s = lse_s + BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* wb = smem + L::kTileBytes + warp * L::kWarpBytes;
  bf16* ksw = reinterpret_cast<bf16*>(wb);
  bf16* vsw = ksw + 16 * PD;
  float* dka = reinterpret_cast<float*>(wb + 2 * 16 * PD * 2);
  float* dva = dka + 16 * PA;
  float* ss = dva + 16 * PA;
  bf16* ps = reinterpret_cast<bf16*>(ss + 16 * PS);

  const int bn = blockIdx.y, b = bn / N, n = bn % N;
  const size_t tok = static_cast<size_t>(N) * D;
  const size_t qoff = static_cast<size_t>(b) * Sq * tok +
                      static_cast<size_t>(n) * D;
  const size_t koff = static_cast<size_t>(b) * Sk * tok +
                      static_cast<size_t>(n) * D;
  const float* bb = bias != nullptr ? bias + static_cast<size_t>(b) * Sk
                                    : nullptr;
  const float* lse_b = lse + static_cast<size_t>(bn) * Sq;
  const float* delta_b = delta + static_cast<size_t>(bn) * Sq;

  const int kblock = blockIdx.x * L::BKV;
  const int k0w = kblock + warp * 16;
  // each lane owns half a key row: 32 queries of a tile, D/2 output columns
  const int row = lane >> 1, half = lane & 1, kj = k0w + row;

  stage_rows<D>(ksw, PD, k + koff, tok, k0w, 16, Sk, lane, 32);
  stage_rows<D>(vsw, PD, v + koff, tok, k0w, 16, Sk, lane, 32);
  for (int i = lane; i < 16 * PA; i += 32) {
    dka[i] = 0.f;
    dva[i] = 0.f;
  }
  __syncwarp();

  const int nq = (Sq + BQ - 1) / BQ;
  // causal: query tiles wholly before this block's first key add nothing
  const int qt_begin = causal ? kblock / BQ : 0;
  for (int qt = qt_begin; qt < nq; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // every warp is done with the previous tile
    stage_rows<D>(qs, PD, q + qoff, tok, q0, BQ, Sq, threadIdx.x, blockDim.x);
    stage_rows<D>(dos, PD, dout + qoff, tok, q0, BQ, Sq, threadIdx.x,
                  blockDim.x);
    for (int i = threadIdx.x; i < BQ; i += blockDim.x) {
      const bool in = q0 + i < Sq;
      lse_s[i] = in ? lse_b[q0 + i] : kNegInf;
      delta_s[i] = in ? delta_b[q0 + i] : 0.f;
    }
    __syncthreads();
    if (k0w >= Sk || (causal && q0 + BQ - 1 < k0w)) continue;

    mm_abt<D, BQ / 16>(ksw, PD, qs, PD, ss, PS);  // S^T (unscaled)
    __syncwarp();
    float p[COLS];
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int col = half * COLS + c;
      const float l = lse_s[col];
      const float s = masked_score(ss[row * PS + col], scale, bb, kj,
                                   q0 + col, Sk, causal != 0);
      p[c] = (l > kMaskedLogit && s > kMaskedLogit) ? expf(s - l) : 0.f;
      ps[row * PP + col] = f2bf(p[c]);
    }
    __syncwarp();
    mm_ab_acc<D, BQ / 16>(ps, PP, dos, PD, dva, PA);  // dV += P^T dO
    mm_abt<D, BQ / 16>(vsw, PD, dos, PD, ss, PS);     // dP^T
    __syncwarp();
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int col = half * COLS + c;
      ps[row * PP + col] = f2bf(p[c] * (ss[row * PS + col] - delta_s[col]));
    }
    __syncwarp();
    mm_ab_acc<D, BQ / 16>(ps, PP, qs, PD, dka, PA);  // dK += dS^T Q
    __syncwarp();
  }

  if (kj < Sk) {
    const size_t at = koff + static_cast<size_t>(kj) * tok + half * HALF;
    for (int c = 0; c < HALF; ++c) {
      dk[at + c] = f2bf(dka[row * PA + half * HALF + c] * scale);
      dv[at + c] = f2bf(dva[row * PA + half * HALF + c]);
    }
  }
}

template <int D, int BK>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* bias, const void* dout, const void* lse,
                      const void* delta, void* dq, int B, int Sq, int Sk,
                      int N, float scale, int causal, cudaStream_t stream) {
  using L = DqLayout<D, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + L::BQ - 1) / L::BQ, B * N);
  flash_bwd_dq_kernel<D, BK><<<grid, L::WARPS * 32, L::kBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), Sq, Sk, N,
      scale, causal);
  return cudaGetLastError();
}

template <int D, int WARPS>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* bias, const void* dout, const void* lse,
                       const void* delta, void* dk, void* dv, int B, int Sq,
                       int Sk, int N, float scale, int causal,
                       cudaStream_t stream) {
  using L = DkvLayout<D, WARPS>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D, WARPS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sk + L::BKV - 1) / L::BKV, B * N);
  flash_bwd_dkv_kernel<D, WARPS><<<grid, WARPS * 32, L::kBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), Sq, Sk, N, scale, causal);
  return cudaGetLastError();
}

}  // namespace
}  // namespace macaw

extern "C" int macaw_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* bias,
    const void* dout, const void* lse, const void* delta, void* dq, int B,
    int Sq, int Sk, int N, int D, float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return macaw::launch_dq<64, 64>(q, k, v, bias, dout, lse, delta, dq, B,
                                      Sq, Sk, N, scale, causal, st);
    case 128:
      return macaw::launch_dq<128, 64>(q, k, v, bias, dout, lse, delta, dq,
                                       B, Sq, Sk, N, scale, causal, st);
    case 256:
      return macaw::launch_dq<256, 32>(q, k, v, bias, dout, lse, delta, dq,
                                       B, Sq, Sk, N, scale, causal, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int macaw_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* bias,
    const void* dout, const void* lse, const void* delta, void* dk, void* dv,
    int B, int Sq, int Sk, int N, int D, float scale, int causal,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return macaw::launch_dkv<64, 4>(q, k, v, bias, dout, lse, delta, dk, dv,
                                      B, Sq, Sk, N, scale, causal, st);
    case 128:
      return macaw::launch_dkv<128, 4>(q, k, v, bias, dout, lse, delta, dk,
                                       dv, B, Sq, Sk, N, scale, causal, st);
    case 256:
      return macaw::launch_dkv<256, 2>(q, k, v, bias, dout, lse, delta, dk,
                                       dv, B, Sq, Sk, N, scale, causal, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
