// Whole-sequence self-attention for short sequences (S_q == S_k), B1.
//
// Replaces: macaw_llm_tpu/ops/pallas/mh_attention.py:147, _mh_fwd / _mh_kernel
// (the LLaMA prefill attention, called through mh_attention).
//
// Contract (_mh_kernel's): every key of a row is resident; the softmax is
// single-pass against the exact row max (not a running max); P is rounded
// to bf16 before P V and the sum is normalized after it; a row with no
// valid key gives zeros.
//
// Bound on the H100 at the main-path shape, q/k/v [16, 312, 32, 128] bf16,
// causal: q, k, v and out are 164 MB, 49 us at 3.35 TB/s; the causal
// matmuls are 1.3e10 FLOP, 13 us at 989 TFLOP/s. So the kernel is bound by
// bytes: it reads K and V about once per (batch, head) and keeps every
// logit out of device memory.
//
// Design (sm_90a; the building blocks in hopper.cuh, shared with B2):
//  * One block per (batch x head, 192-query tile), three consumer
//    warpgroups of 64 query rows (12 warps cap a thread at 168 registers;
//    the kernel takes 164 at D = 128). At S = 312 a head is two blocks, of
//    1 + 2 + 3 and 4 + 5 causal key tiles a warpgroup: one block of K and
//    V serves three warpgroups, and the SM holds one block (two warpgroups
//    a block measured 0.122 against 0.107 ms at the prefill shape). The
//    query tiles of one head are adjacent in the grid (the last, with the
//    most causal work, first), so they run together and K and V come from
//    HBM about once.
//  * Thread 0 loads Q and the 64-key K and V tiles the block can reach (up
//    to its causal diagonal) by TMA, each tile on its own mbarrier, so the
//    math starts on the first tile while the rest land. All of them stay
//    resident (128-byte-swizzled panels; 214 KB at S = 312, D = 128).
//  * Pass 1: S = Q K^T by wgmma per tile, masked, giving the exact row max.
//  * Pass 2: S recomputed, exp(s - max) in fp32, P packed to bf16 in the
//    registers as the A operand of O += P V (V MN-major in shared memory),
//    O in registers. Recomputing S costs little (the kernel is bound by
//    bytes), where holding all of S next to O (64 x 320 fp32 a warpgroup)
//    would spill.
#include "hopper.cuh"

namespace macaw {
namespace {

constexpr int kMhGroups = 3;  // consumer warpgroups of 64 query rows
constexpr int kMhThreads = 128 * kMhGroups;

template <int D>
struct MhWg {
  static constexpr int NP = D / 64;  // 64-column panels of a row
  static constexpr int BQ = 64 * kMhGroups, BK = 64;
  static constexpr int kPanelQ = BQ * 128;  // 64 columns of BQ rows
  static constexpr int kTile0 = NP * kPanelQ;               // after Q
  static constexpr int kTileBytes = 2 * NP * kAttnPanelK;   // K, then V
  static constexpr uint32_t kQTx = BQ * D * 2, kTileTx = 2 * BK * D * 2;
  // Q, every key tile of the sequence, one barrier each and Q's, and the
  // slack that aligns the panels to 1024 bytes
  static int bytes(int tiles) {
    return kTile0 + tiles * kTileBytes + 8 * (1 + tiles) + 1024;
  }
};

template <int D>
__global__ void __launch_bounds__(kMhThreads, 1)
    mh_attention_wgmma(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const float* __restrict__ bias,
                       bf16* __restrict__ out, int S, int N, float scale,
                       int causal) {
  using L = MhWg<D>;
  constexpr int NP = L::NP, BK = L::BK;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int all_tiles = (S + BK - 1) / BK;
  const uint32_t bar_q = base + L::kTile0 + all_tiles * L::kTileBytes;
  auto tile_bar = [&](int j) { return bar_q + 8 * (1 + j); };
  auto tile_at = [&](int j) { return base + L::kTile0 + j * L::kTileBytes; };

  const int nqt = (S + L::BQ - 1) / L::BQ;
  const int qt = nqt - 1 - static_cast<int>(blockIdx.x % nqt);
  const int bn = static_cast<int>(blockIdx.x / nqt), b = bn / N, n = bn % N;
  const int qb0 = qt * L::BQ;
  const int ntiles =
      causal ? (min(qb0 + L::BQ, S) - 1) / BK + 1 : all_tiles;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int j = 0; j < ntiles; ++j) mbar_init(tile_bar(j), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_arrive_expect_tx(bar_q, L::kQTx);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      tma_load_4d(base + p * L::kPanelQ, &tm_q, bar_q, 64 * p, n, qb0, b);
    }
    for (int j = 0; j < ntiles; ++j) {
      const uint32_t bar = tile_bar(j), at = tile_at(j);
      mbar_arrive_expect_tx(bar, L::kTileTx);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        tma_load_4d(at + p * kAttnPanelK, &tm_k, bar, 64 * p, n, j * BK, b);
        tma_load_4d(at + (NP + p) * kAttnPanelK, &tm_v, bar, 64 * p, n,
                    j * BK, b);
      }
    }
  }
  __syncthreads();

  // each warpgroup owns 64 queries; one whose rows all lie past S has
  // nothing to do (the other warpgroup waits for every tile loaded)
  const int c = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int qw0 = qb0 + 64 * c;
  if (qw0 >= S) return;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int qrow[2] = {qw0 + 16 * warp + g, qw0 + 16 * warp + g + 8};
  const int jend = causal ? (min(qw0 + 64, S) - 1) / BK + 1 : all_tiles;
  const float* bias_b =
      bias != nullptr ? bias + static_cast<size_t>(b) * S : nullptr;
  const uint32_t qa = base + c * 64 * 128;
  float s[32], kb[16], mx[2];
  mbar_wait(bar_q, 0);

  // pass 1: the exact row max over every reachable key
  float m[2] = {kNegInf, kNegInf};
  for (int j = 0; j < jend; ++j) {
    mbar_wait(tile_bar(j), 0);
    wgmma_fence();
    attn_qk<D, BK, L::kPanelQ>(s, qa, tile_at(j));
    wgmma_commit();
    attn_key_bias(kb, bias_b, j * BK, S, t);
    wgmma_wait_all();
    reg_fence(s);
    attn_scores(s, scale, kb, causal && j * BK + BK - 1 > qw0, j * BK, qrow,
                t, mx);
    m[0] = fmaxf(m[0], mx[0]);
    m[1] = fmaxf(m[1], mx[1]);
  }
  // a row with no valid key keeps m = NEG_INF: against -1e30 every exp
  // underflows to 0, so the row sums to 0 and its output is 0
  float mref[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) mref[r] = fmaxf(quad_max(m[r]), kMaskedLogit);

  // pass 2: probabilities (bf16) times V, fp32 accumulate
  float o[D / 2], l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  for (int j = 0; j < jend; ++j) {
    const uint32_t at = tile_at(j);
    wgmma_fence();
    attn_qk<D, BK, L::kPanelQ>(s, qa, at);
    wgmma_commit();
    attn_key_bias(kb, bias_b, j * BK, S, t);
    wgmma_wait_all();
    reg_fence(s);
    attn_scores(s, scale, kb, causal && j * BK + BK - 1 > qw0, j * BK, qrow,
                t, mx);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i % 4) / 2;
      s[i] = __expf(s[i] - mref[r]);
      l[r] += s[i];
    }
    uint32_t pa[4][4];
    acc_to_a(s, pa);
    wgmma_fence();
    attn_pv<D>(o, pa, at + NP * kAttnPanelK);
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(o);
  }

  const size_t tok = static_cast<size_t>(N) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lt = quad_sum(l[r]);
    if (qrow[r] >= S) continue;
    const float lsafe = lt == 0.f ? 1.f : lt;
    bf16* dst = out + (static_cast<size_t>(b) * S + qrow[r]) * tok +
                static_cast<size_t>(n) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
          o[4 * j + 2 * r] / lsafe, o[4 * j + 2 * r + 1] / lsafe);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, void* out, int B, int S, int N,
                   float scale, int causal, cudaStream_t stream) {
  using L = MhWg<D>;
  if (S <= 0) return cudaErrorInvalidValue;
  const int bytes = L::bytes((S + L::BK - 1) / L::BK);
  CUtensorMap mq, mk, mv;
  if (!encode_map(&mq, q, B, S, N, D, L::BQ) ||
      !encode_map(&mk, k, B, S, N, D, L::BK) ||
      !encode_map(&mv, v, B, S, N, D, L::BK)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      mh_attention_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((S + L::BQ - 1) / L::BQ) *
                          static_cast<unsigned>(B * N);
  mh_attention_wgmma<D><<<blocks, kMhThreads, bytes, stream>>>(
      mq, mk, mv, static_cast<const float*>(bias), static_cast<bf16*>(out),
      S, N, scale, causal);
  return cudaGetLastError();
}

}  // namespace
}  // namespace macaw

extern "C" int macaw_mh_attention(const void* q, const void* k, const void* v,
                                  const void* bias, void* out, int B, int S,
                                  int N, int D, float scale, int causal,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return macaw::launch<64>(q, k, v, bias, out, B, S, N, scale, causal,
                               st);
    case 128:
      return macaw::launch<128>(q, k, v, bias, out, B, S, N, scale, causal,
                                st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
