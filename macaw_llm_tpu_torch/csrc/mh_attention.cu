// Whole-sequence self-attention for short sequences (S_q == S_k).
//
// Replaces: macaw_llm_tpu/ops/pallas/mh_attention.py:147, _mh_fwd / _mh_kernel
// (the LLaMA prefill attention, called through mh_attention).
//
// Bound on the H100 at the main-path shape, q/k/v [16, 312, 32, 128] bf16,
// causal: q, k, v and out are 164 MB, 49 us at 3.35 TB/s; the causal
// matmuls are 1.3e10 FLOP, 13 us at 989 TFLOP/s. So the kernel is bound by
// bytes, and its design reads each of K and V once per (batch, head) and
// keeps all logits out of device memory.
//
// Design: one block per (batch, head). The block stages the whole padded
// K and V of its head in shared memory (2 x 320 x 136 x 2 B = 170 KB at
// S=312, D=128), then each warp takes 16-row query tiles. A warp computes
// its 16 x 16 logit tiles on the tensor cores (WMMA bf16, fp32 accumulate),
// so the [S, S] logits never exist anywhere: pass 1 walks the key tiles for
// the row max, pass 2 recomputes each tile, exponentiates in fp32, rounds
// the probabilities to bf16 (the TPU kernel's rounding) and accumulates
// P V in fp32 fragments. Key tiles above the causal diagonal are skipped.
// Rows with no valid key give zeros, as the TPU kernel does.
#include "kernels.cuh"

using namespace nvcuda;

namespace macaw {
namespace {

template <int D>
struct MhLayout {
  static constexpr int PD = D + 8;  // bf16 pitch of K, V and Q-stage rows
  static constexpr int PP = 24;     // bf16 pitch of the 16x16 prob tile
  static constexpr int kWarpBytes = 16 * PD * 2 + 16 * 16 * 4 + 16 * PP * 2;
  static int bytes(int sp, int warps) {
    return 2 * sp * PD * 2 + warps * kWarpBytes;
  }
};

using AFrag = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using BColFrag =
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using BRowFrag =
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using CFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// 16 x 16 logits of the warp's query tile against 16 staged keys -> tmp.
template <int D>
__device__ __forceinline__ void qk_tile(const AFrag (&qf)[D / 16],
                                        const bf16* krows, float* tmp) {
  CFrag acc;
  wmma::fill_fragment(acc, 0.0f);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    BColFrag kf;
    wmma::load_matrix_sync(kf, krows + kk * 16, MhLayout<D>::PD);
    wmma::mma_sync(acc, qf[kk], kf, acc);
  }
  wmma::store_matrix_sync(tmp, acc, 16, wmma::mem_row_major);
  __syncwarp();
}

template <int D>
__global__ void mh_attention_kernel(const bf16* __restrict__ q,
                                    const bf16* __restrict__ k,
                                    const bf16* __restrict__ v,
                                    const float* __restrict__ bias,
                                    bf16* __restrict__ out, int S, int N,
                                    float scale, int causal) {
  constexpr int PD = MhLayout<D>::PD;
  constexpr int PP = MhLayout<D>::PP;
  constexpr int CH = D / 8;  // 16-byte chunks per row
  extern __shared__ __align__(128) unsigned char smem[];

  const int sp = (S + 15) / 16 * 16;
  const int ntiles = sp / 16;
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + sp * PD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  unsigned char* wbase =
      smem + 2 * sp * PD * 2 + warp * MhLayout<D>::kWarpBytes;
  bf16* qs = reinterpret_cast<bf16*>(wbase);
  float* tmp = reinterpret_cast<float*>(wbase + 16 * PD * 2);
  bf16* ps = reinterpret_cast<bf16*>(wbase + 16 * PD * 2 + 16 * 16 * 4);

  const int b = blockIdx.x / N, n = blockIdx.x % N;
  const size_t tok = static_cast<size_t>(N) * D;  // stride of one position
  const size_t base = static_cast<size_t>(b) * S * tok +
                      static_cast<size_t>(n) * D;
  const bf16* qb = q + base;
  const bf16* kb = k + base;
  const bf16* vb = v + base;
  bf16* ob = out + base;
  const float* bb = bias != nullptr ? bias + static_cast<size_t>(b) * S
                                    : nullptr;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // stage K and V of this head; rows past S are zero
  for (int i = threadIdx.x; i < sp * CH; i += blockDim.x) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 kv = zero, vv = zero;
    if (r < S) {
      kv = *reinterpret_cast<const uint4*>(kb + r * tok + c);
      vv = *reinterpret_cast<const uint4*>(vb + r * tok + c);
    }
    *reinterpret_cast<uint4*>(ks + r * PD + c) = kv;
    *reinterpret_cast<uint4*>(vs + r * PD + c) = vv;
  }
  __syncthreads();

  // each lane owns half a row (8 columns) of a 16 x 16 tile
  const int row = lane >> 1, half = lane & 1;
  for (int t = warp; t < ntiles; t += nwarps) {
    const int q0 = t * 16, qi = q0 + row;
    for (int i = lane; i < 16 * CH; i += 32) {
      const int r = i / CH, c = (i % CH) * 8;
      uint4 val = zero;
      if (q0 + r < S) {
        val = *reinterpret_cast<const uint4*>(qb + (q0 + r) * tok + c);
      }
      *reinterpret_cast<uint4*>(qs + r * PD + c) = val;
    }
    __syncwarp();
    AFrag qf[D / 16];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::load_matrix_sync(qf[kk], qs + kk * 16, PD);
    }
    const int jend = causal ? t : ntiles - 1;

    // pass 1: the row max over every key tile
    float m = kNegInf;
    for (int j = 0; j <= jend; ++j) {
      qk_tile<D>(qf, ks + j * 16 * PD, tmp);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = half * 8 + c;
        m = fmaxf(m, masked_score(tmp[row * 16 + col], scale, bb,
                                  j * 16 + col, qi, S, causal != 0));
      }
      __syncwarp();
    }
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    // a row with no valid key keeps m = NEG_INF: against -1e30 every
    // exp underflows to 0, so the row sums to 0 and its output is 0
    const float mref = fmaxf(m, -1e30f);

    // pass 2: probabilities (bf16) times V, fp32 accumulate
    CFrag of[D / 16];
#pragma unroll
    for (int nn = 0; nn < D / 16; ++nn) wmma::fill_fragment(of[nn], 0.0f);
    float l = 0.f;
    for (int j = 0; j <= jend; ++j) {
      qk_tile<D>(qf, ks + j * 16 * PD, tmp);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = half * 8 + c;
        const float p = expf(masked_score(tmp[row * 16 + col], scale, bb,
                                          j * 16 + col, qi, S, causal != 0) -
                             mref);
        l += p;
        ps[row * PP + col] = f2bf(p);
      }
      __syncwarp();
      AFrag pf;
      wmma::load_matrix_sync(pf, ps, PP);
#pragma unroll
      for (int nn = 0; nn < D / 16; ++nn) {
        BRowFrag vf;
        wmma::load_matrix_sync(vf, vs + j * 16 * PD + nn * 16, PD);
        wmma::mma_sync(of[nn], pf, vf, of[nn]);
      }
      __syncwarp();
    }
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    const float lsafe = (l == 0.f) ? 1.f : l;
#pragma unroll
    for (int nn = 0; nn < D / 16; ++nn) {
      wmma::store_matrix_sync(tmp, of[nn], 16, wmma::mem_row_major);
      __syncwarp();
      if (qi < S) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int col = half * 8 + c;
          ob[qi * tok + nn * 16 + col] = f2bf(tmp[row * 16 + col] / lsafe);
        }
      }
      __syncwarp();
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, void* out, int B, int S, int N,
                   float scale, int causal, int warps, cudaStream_t stream) {
  const int sp = (S + 15) / 16 * 16;
  const int bytes = MhLayout<D>::bytes(sp, warps);
  cudaError_t err = cudaFuncSetAttribute(
      mh_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  mh_attention_kernel<D><<<B * N, warps * 32, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      static_cast<bf16*>(out), S, N, scale, causal);
  return cudaGetLastError();
}

}  // namespace
}  // namespace macaw

extern "C" int macaw_mh_attention(const void* q, const void* k, const void* v,
                                  const void* bias, void* out, int B, int S,
                                  int N, int D, float scale, int causal,
                                  int warps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return macaw::launch<64>(q, k, v, bias, out, B, S, N, scale, causal,
                               warps, st);
    case 128:
      return macaw::launch<128>(q, k, v, bias, out, B, S, N, scale, causal,
                                warps, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
