// Online-softmax attention streaming K/V, forward with log-sum-exp.
//
// Replaces: macaw_llm_tpu/ops/pallas/flash_attention.py:188, _flash_fwd /
// _fwd_kernel (flash_attention, flash_attention_with_lse, flash_sdpa, the
// shared-K/V alignment fold).
//
// Bound on the H100 at the main-path shapes: operations. The video
// alignment (q [16, 624, 1, 256], k/v [16, 32009, 1, 256] bf16) is
// 3.3e11 FLOP, 331 us at 989 TFLOP/s, against 534 MB of q, k, v and out,
// 160 us at 3.35 TB/s; Whisper's self-attention ([16, 1500, 8, 64]) is
// 7.4e10 FLOP against 25 MB. So both matmuls run on the tensor cores.
//
// Design: the TPU's sequential grid axis over K blocks becomes a loop
// inside the block. One block per (batch x head, 64-query tile), four warps
// of 16 query rows. Each K/V tile of 64 keys is staged once in shared
// memory for all four warps; a warp computes its 16 x 64 logits with WMMA
// (bf16 operands, fp32 accumulate), applies scale, padding bias, the
// ragged-tail mask and the causal mask, updates its running max and sum in
// fp32, rescales its fp32 output rows in shared memory and adds P V with
// the probabilities rounded to bf16, as the TPU kernel does. K tiles above
// the causal diagonal of the block are never loaded. Rows with no valid
// key give zeros and a log-sum-exp of NEG_INF.
#include "kernels.cuh"

using namespace nvcuda;

namespace macaw {
namespace {

template <int D>
struct FlashLayout {
  static constexpr int BQ = 64, BK = 64, WARPS = 4;
  static constexpr int PD = D + 8;   // bf16 pitch: Q stage, K and V tiles
  static constexpr int PO = D + 4;   // fp32 pitch: output accumulator
  static constexpr int PS = BK + 4;  // fp32 pitch: logit tile
  static constexpr int PP = BK + 8;  // bf16 pitch: probability tile
  static constexpr int kWarpBytes =
      16 * PD * 2 + 16 * PO * 4 + 16 * PS * 4 + 16 * PP * 2;
  static constexpr int kBytes = 2 * BK * PD * 2 + WARPS * kWarpBytes;
};

using AFrag = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using BColFrag =
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using BRowFrag =
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using CFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

template <int D>
__global__ void __launch_bounds__(128)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const float* __restrict__ bias, bf16* __restrict__ out,
                     float* __restrict__ lse, int Sq, int Sk, int N,
                     float scale, int causal) {
  using L = FlashLayout<D>;
  constexpr int PD = L::PD, PO = L::PO, PS = L::PS, PP = L::PP, BK = L::BK;
  constexpr int CH = D / 8;  // 16-byte chunks per row
  constexpr int HALF = D / 2;
  extern __shared__ __align__(128) unsigned char smem[];

  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + BK * PD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* wb = smem + 2 * BK * PD * 2 + warp * L::kWarpBytes;
  bf16* qs = reinterpret_cast<bf16*>(wb);
  float* os = reinterpret_cast<float*>(wb + 16 * PD * 2);
  float* ss = reinterpret_cast<float*>(wb + 16 * PD * 2 + 16 * PO * 4);
  bf16* ps =
      reinterpret_cast<bf16*>(wb + 16 * PD * 2 + 16 * PO * 4 + 16 * PS * 4);

  const int bn = blockIdx.y, b = bn / N, n = bn % N;
  const size_t tok = static_cast<size_t>(N) * D;  // stride of one position
  const bf16* qb = q + static_cast<size_t>(b) * Sq * tok +
                   static_cast<size_t>(n) * D;
  const bf16* kb = k + static_cast<size_t>(b) * Sk * tok +
                   static_cast<size_t>(n) * D;
  const bf16* vb = v + static_cast<size_t>(b) * Sk * tok +
                   static_cast<size_t>(n) * D;
  bf16* ob = out + static_cast<size_t>(b) * Sq * tok +
             static_cast<size_t>(n) * D;
  const float* bb = bias != nullptr ? bias + static_cast<size_t>(b) * Sk
                                    : nullptr;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  const int q0 = blockIdx.x * L::BQ + warp * 16;
  // each lane owns half a row: 32 logits of a tile, D/2 output columns
  const int row = lane >> 1, half = lane & 1, qi = q0 + row;

  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = zero;
    if (q0 + r < Sq) {
      val = *reinterpret_cast<const uint4*>(qb + (q0 + r) * tok + c);
    }
    *reinterpret_cast<uint4*>(qs + r * PD + c) = val;
  }
  for (int i = lane; i < 16 * PO; i += 32) os[i] = 0.f;
  __syncwarp();
  AFrag qf[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::load_matrix_sync(qf[kk], qs + kk * 16, PD);
  }

  float m = kNegInf, l = 0.f;
  int kt_end = (Sk + BK - 1) / BK;
  if (causal) {
    const int last_q = blockIdx.x * L::BQ + L::BQ - 1;
    kt_end = min(kt_end, last_q / BK + 1);
  }
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous tile
    for (int i = threadIdx.x; i < BK * CH; i += blockDim.x) {
      const int r = i / CH, c = (i % CH) * 8;
      uint4 kv = zero, vv = zero;
      if (k0 + r < Sk) {
        kv = *reinterpret_cast<const uint4*>(kb + (k0 + r) * tok + c);
        vv = *reinterpret_cast<const uint4*>(vb + (k0 + r) * tok + c);
      }
      *reinterpret_cast<uint4*>(ks + r * PD + c) = kv;
      *reinterpret_cast<uint4*>(vs + r * PD + c) = vv;
    }
    __syncthreads();
    if (q0 >= Sq || (causal && k0 > q0 + 15)) continue;

#pragma unroll
    for (int c = 0; c < BK / 16; ++c) {
      CFrag acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        BColFrag kf;
        wmma::load_matrix_sync(kf, ks + c * 16 * PD + kk * 16, PD);
        wmma::mma_sync(acc, qf[kk], kf, acc);
      }
      wmma::store_matrix_sync(ss + c * 16, acc, PS, wmma::mem_row_major);
    }
    __syncwarp();

    float sv[32];
    float mx = kNegInf;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int col = half * 32 + c;
      sv[c] = masked_score(ss[row * PS + col], scale, bb, k0 + col, qi, Sk,
                           causal != 0);
      mx = fmaxf(mx, sv[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    // while a row has seen no valid key, m stays NEG_INF; against -1e30
    // its exps underflow to 0, so it accumulates nothing
    const float mref = fmaxf(m_new, -1e30f);
    const float corr = expf(m - mref);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float p = expf(sv[c] - mref);
      sum += p;
      ps[row * PP + half * 32 + c] = f2bf(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * corr + sum;
    m = m_new;
    for (int c = 0; c < HALF; ++c) os[row * PO + half * HALF + c] *= corr;
    __syncwarp();

    for (int nn = 0; nn < D / 16; ++nn) {
      CFrag o;
      wmma::load_matrix_sync(o, os + nn * 16, PO, wmma::mem_row_major);
#pragma unroll
      for (int c = 0; c < BK / 16; ++c) {
        AFrag pf;
        BRowFrag vf;
        wmma::load_matrix_sync(pf, ps + c * 16, PP);
        wmma::load_matrix_sync(vf, vs + c * 16 * PD + nn * 16, PD);
        wmma::mma_sync(o, pf, vf, o);
      }
      wmma::store_matrix_sync(os + nn * 16, o, PO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  if (qi < Sq) {
    const float lsafe = (l == 0.f) ? 1.f : l;
    for (int c = 0; c < HALF; ++c) {
      ob[qi * tok + half * HALF + c] =
          f2bf(os[row * PO + half * HALF + c] / lsafe);
    }
    if (half == 0) lse[static_cast<size_t>(bn) * Sq + qi] = m + logf(lsafe);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, void* out, void* lse, int B, int Sq,
                   int Sk, int N, float scale, int causal,
                   cudaStream_t stream) {
  using L = FlashLayout<D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + L::BQ - 1) / L::BQ, B * N);
  flash_fwd_kernel<D><<<grid, L::WARPS * 32, L::kBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      static_cast<bf16*>(out), static_cast<float*>(lse), Sq, Sk, N, scale,
      causal);
  return cudaGetLastError();
}

}  // namespace
}  // namespace macaw

extern "C" int macaw_flash_attention(const void* q, const void* k,
                                     const void* v, const void* bias,
                                     void* out, void* lse, int B, int Sq,
                                     int Sk, int N, int D, float scale,
                                     int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return macaw::launch<64>(q, k, v, bias, out, lse, B, Sq, Sk, N, scale,
                               causal, st);
    case 128:
      return macaw::launch<128>(q, k, v, bias, out, lse, B, Sq, Sk, N, scale,
                                causal, st);
    case 256:
      return macaw::launch<256>(q, k, v, bias, out, lse, B, Sq, Sk, N, scale,
                                causal, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
