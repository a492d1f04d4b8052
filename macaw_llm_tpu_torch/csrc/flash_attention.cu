// Online-softmax attention streaming K/V, forward with log-sum-exp (B2),
// and the combine of its split over keys.
//
// Replaces: macaw_llm_tpu/ops/pallas/flash_attention.py:188, _flash_fwd /
// _fwd_kernel (flash_attention, flash_attention_with_lse, flash_sdpa, the
// shared-K/V alignment fold).
//
// Computes, per (batch, head, query): S = Q K^T * scale + bias, with keys
// past Sk and keys above the causal diagonal at NEG_INF (masked_score's
// order); an online row max and sum in fp32; P rounded to bf16 before P V;
// fp32 accumulation; out = O / l in bf16 and lse = m + log l, laid out
// [B*N, Sq] for the backward kernels. A row with no valid key gives zeros
// and an lse of NEG_INF.
//
// Bound on the H100 at the main-path shapes: operations. The video
// alignment (q [16, 624, 1, 256], k/v [16, 32009, 1, 256] bf16) is 3.3e11
// FLOP, 331 us at 989 TFLOP/s, against 534 MB of q, k, v and out, 160 us at
// 3.35 TB/s; Whisper's self-attention ([16, 1500, 8, 64]) is 7.4e10 FLOP
// against 25 MB; the 7b train shape ([8, 1080, 32, 128], causal) 7.7e10
// FLOP against 2.6e8 bytes.
//
// Design (sm_90a: TMA, mbarriers, wgmma; the building blocks in
// hopper.cuh):
//  * One block per (batch x head, key chunk, 128-query tile): two consumer
//    warpgroups of 64 query rows and no producer warp, so a thread may hold
//    255 registers (O is 64 x D fp32 per warpgroup: 32, 64 or 128 registers
//    a thread); at D = 64 a block takes 128 registers a thread and 64 KB,
//    so two share an SM and hide each other's waits. Thread 0 loads the
//    Q tile once by TMA, then streams the chunk's K and V tiles (128 keys
//    at D = 128, else 64) through a ring of 128-byte-swizzled panels
//    guarded by full and empty mbarriers: 3 stages at D <= 128 (224 KB at
//    D = 128); 2 at D = 256, where Q (64 KB) and two stages (128 KB) take
//    192 of the 227 KB, and a stage is refilled as soon as both
//    warpgroups leave it.
//  * Per tile: S = Q K^T by wgmma (both operands K-major in shared memory);
//    the padding bias of the thread's own columns is read while it runs.
//    The softmax runs on the accumulator registers: a row's columns lie
//    on the 4 lanes of a quad, so its max takes two shuffles (its sum stays
//    per thread until the end). P is packed to bf16 in place as the A
//    operand of O += P V (V MN-major in shared memory); O stays in
//    registers.
//  * Causal: key tiles above a block's diagonal are never loaded and only
//    the diagonal tile is masked by index; the last query tile (the most
//    work) starts first.
//  * Split over keys: when the blocks of one chunk would leave SMs idle,
//    the wrapper (split_plan in ops/kernels/flash_attention.py) cuts the
//    keys into chunks of whole tiles. Each block then writes its normalized
//    fp32 partial O and its partial lse into a workspace the wrapper
//    allocates, and flash_fwd_combine merges the chunks in a fixed order:
//    lse = log sum_i exp(lse_i), out = sum_i exp(lse_i - lse) O_i. A chunk
//    in which a row has no valid key has lse_i = NEG_INF and weight 0; a
//    row with none in any chunk gives zeros and NEG_INF. The query tiles of
//    one (head, chunk) are adjacent in the grid, so they run together and
//    each K/V tile comes from HBM once and from L2 for the others.
//  * No atomics: out and lse are the same bits from run to run.
// Tried on the H100 and not kept (tools/flash_fwd_probe.py): issuing tile
// i's S beside tile i - 1's P V, with its softmax while that runs (FA3's
// overlap within a warpgroup), and a producer warp at D = 128; neither
// moved the 7b train shape off 0.33-0.35 ms (64-key tiles), and at D = 64
// the overlap's registers cost the second block on the SM. 128-key tiles
// at D = 64 (one block an SM) and in mh_attention.cu were no faster.
#include "hopper.cuh"

namespace macaw {
namespace {

constexpr int kFwdThreads = 256;  // two consumer warpgroups

template <int D>
struct FwdWg {
  static constexpr int NP = D / 64;  // 64-column panels of a row
  // keys per K/V tile: 128 at D = 128 (half the tile loop's waits, and S
  // = Q K^T as m64n128 products), 64 where registers or shared memory are
  // short (D = 64 keeps two blocks an SM, D = 256 holds O in 128 registers)
  static constexpr int BQ = 128, BK = D == 128 ? 128 : 64;
  static constexpr int kPanelK = BK * 128;  // 64 columns of BK rows
  static constexpr int kStages = D == 256 ? 2 : 3;
  // at D = 64 two blocks share an SM (64 KB of shared memory and at most
  // 128 registers a thread each), so one block's loads and softmax hide
  // behind the other's products
  static constexpr int kMinBlocks = D == 64 ? 2 : 1;
  static constexpr int kStage0 = NP * kAttnPanelQ;          // after Q
  static constexpr int kStageBytes = 2 * NP * kPanelK;  // K, then V
  static constexpr int kBar = kStage0 + kStages * kStageBytes;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
  static constexpr uint32_t kQTx = BQ * D * 2, kStageTx = 2 * BK * D * 2;
};

template <int D>
__global__ void __launch_bounds__(kFwdThreads, FwdWg<D>::kMinBlocks)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const float* __restrict__ bias, bf16* __restrict__ out,
                    float* __restrict__ lse, float* __restrict__ part_o,
                    float* __restrict__ part_lse, int B, int Sq, int Sk,
                    int N, float scale, int causal, int chunk_tiles,
                    int nchunks) {
  using L = FwdWg<D>;
  constexpr int NP = L::NP, BK = L::BK, kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + L::kBar;
  const Ring<kStages> ring{bar_q + 8, bar_q + 8 + 8 * kStages};

  // block -> (batch x head, chunk, query tile), query tiles fastest and the
  // last one first
  const int nqt = (Sq + L::BQ - 1) / L::BQ;
  const int qt = nqt - 1 - static_cast<int>(blockIdx.x % nqt);
  const int rest = static_cast<int>(blockIdx.x / nqt);
  const int chunk = rest % nchunks, bn = rest / nchunks;
  const int b = bn / N, n = bn % N;
  const int qb0 = qt * L::BQ;
  const int t0 = chunk * chunk_tiles;
  int t1 = min(t0 + chunk_tiles, (Sk + BK - 1) / BK);
  if (causal) t1 = min(t1, (min(qb0 + L::BQ, Sq) - 1) / BK + 1);
  const int ntiles = max(t1 - t0, 0);

  auto stage = [&](int i) {
    return base + L::kStage0 + (i % kStages) * L::kStageBytes;
  };
  // tile i: K and V rows [64 (t0 + i), + 64) into its stage
  auto load_tile = [&](int i) {
    const int k0 = (t0 + i) * BK;
    const uint32_t st = stage(i), bar = ring.full_bar(i);
    mbar_arrive_expect_tx(bar, L::kStageTx);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      tma_load_4d(st + p * L::kPanelK, &tm_k, bar, 64 * p, n, k0, b);
      tma_load_4d(st + (NP + p) * L::kPanelK, &tm_v, bar, 64 * p, n, k0,
                  b);
    }
  };

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(ring.full + 8 * s, 1);
      mbar_init(ring.empty + 8 * s, kFwdThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_arrive_expect_tx(bar_q, L::kQTx);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      tma_load_4d(base + p * kAttnPanelQ, &tm_q, bar_q, 64 * p, n, qb0, b);
    }
    for (int i = 0; i < min(ntiles, kStages); ++i) load_tile(i);
  }
  __syncthreads();

  // each warpgroup owns 64 queries
  const int c = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int qw0 = qb0 + 64 * c;
  const int qrow[2] = {qw0 + 16 * warp + g, qw0 + 16 * warp + g + 8};
  const float* bias_b =
      bias != nullptr ? bias + static_cast<size_t>(b) * Sk : nullptr;
  float o[D / 2], s[BK / 2], kb[BK / 4], mx[2];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  const uint32_t qa = base + c * 64 * 128;
  mbar_wait(bar_q, 0);

  for (int i = 0; i < ntiles; ++i) {
    ring.wait_full(i);
    __syncwarp();
    const int k0 = (t0 + i) * BK;
    // tile i reaches some of this warpgroup's rows
    if (qw0 < Sq && !(causal && k0 > qw0 + 63)) {
      wgmma_fence();
      attn_qk<D, BK>(s, qa, stage(i));
      wgmma_commit();
      // the padding bias of this thread's keys, read while S runs
      attn_key_bias(kb, bias_b, k0, Sk, t);
      wgmma_wait_all();
      reg_fence(s);
      attn_scores(s, scale, kb, causal && k0 + BK - 1 > qw0, k0, qrow, t,
                  mx);
      float mref[2], corr[2], ls[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mn = fmaxf(m[r], quad_max(mx[r]));
        // while a row has seen no valid key its max stays NEG_INF; against
        // -1e30 its exps underflow to 0, so it accumulates nothing
        mref[r] = fmaxf(mn, kMaskedLogit);
        corr[r] = __expf(m[r] - mref[r]);
        m[r] = mn;
      }
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        s[e] = __expf(s[e] - mref[(e % 4) / 2]);
        ls[(e % 4) / 2] += s[e];
      }
#pragma unroll
      for (int e = 0; e < D / 2; ++e) o[e] *= corr[(e % 4) / 2];
      l[0] = l[0] * corr[0] + ls[0];
      l[1] = l[1] * corr[1] + ls[1];
      uint32_t pa[BK / 16][4];
      acc_to_a(s, pa);
      wgmma_fence();
      attn_pv<D, BK>(o, pa, stage(i) + NP * L::kPanelK);
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(o);
    }
    mbar_arrive(ring.empty_bar(i));
    if (threadIdx.x == 0) {
      int next;
      if constexpr (kStages >= 3) {
        next = ring.refill_after(i, ntiles);
      } else {
        next = ring.refill_own(i, ntiles);
      }
      if (next >= 0) load_tile(next);
    }
  }

  reg_fence(o);
  const size_t tok = static_cast<size_t>(N) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lt = quad_sum(l[r]);
    if (qrow[r] >= Sq) continue;
    const float lsafe = lt == 0.f ? 1.f : lt;
    if (part_o == nullptr) {
      bf16* dst = out + (static_cast<size_t>(b) * Sq + qrow[r]) * tok +
                  static_cast<size_t>(n) * D + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] / lsafe,
                                  o[4 * j + 2 * r + 1] / lsafe);
      }
      if (t == 0) {
        lse[static_cast<size_t>(bn) * Sq + qrow[r]] = m[r] + logf(lsafe);
      }
    } else {
      // the chunk's plane of the workspace, laid out as out and lse
      const size_t row =
          ((static_cast<size_t>(chunk) * B + b) * Sq + qrow[r]) * N + n;
      float* dst = part_o + row * D + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(
            o[4 * j + 2 * r] / lsafe, o[4 * j + 2 * r + 1] / lsafe);
      }
      if (t == 0) part_lse[row] = lt > 0.f ? m[r] + logf(lt) : kNegInf;
    }
  }
}

// One warp per (batch, query, head) row: the chunks' partial lse give the
// row's lse and each chunk's weight, then out = sum_i w_i O_i over the
// row's D columns, two a lane at a time, in chunk order. The workspace
// planes are laid out as out [B, Sq, N, D] and [B, Sq, N]; lse goes out
// as [B*N, Sq].
template <int D>
__global__ void __launch_bounds__(256)
    flash_fwd_combine(const float* __restrict__ part_o,
                      const float* __restrict__ part_lse,
                      bf16* __restrict__ out, float* __restrict__ lse,
                      int rows, int Sq, int N, int nchunks) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int n = row % N, qi = (row / N) % Sq, b = row / (N * Sq);
  const size_t plane = static_cast<size_t>(rows);
  const size_t lse_at = (static_cast<size_t>(b) * N + n) * Sq + qi;
  bf16* dst = out + static_cast<size_t>(row) * D;
  float mx = kNegInf;
  for (int i = 0; i < nchunks; ++i) mx = fmaxf(mx, part_lse[i * plane + row]);
  if (mx <= kMaskedLogit) {  // no valid key in any chunk
    for (int col = 2 * lane; col < D; col += 64) {
      *reinterpret_cast<__nv_bfloat162*>(dst + col) =
          __floats2bfloat162_rn(0.f, 0.f);
    }
    if (lane == 0) lse[lse_at] = kNegInf;
    return;
  }
  // every exponent below is finite: mx and the total are > -1e30, and a
  // masked chunk's NEG_INF less either underflows to a weight of 0
  float sum = 0.f;
  for (int i = 0; i < nchunks; ++i) {
    sum += expf(part_lse[i * plane + row] - mx);
  }
  const float total = mx + logf(sum);
  for (int col = 2 * lane; col < D; col += 64) {
    float a0 = 0.f, a1 = 0.f;
    for (int i = 0; i < nchunks; ++i) {
      const size_t at = i * plane + row;
      const float w = expf(part_lse[at] - total);
      const float2 po =
          *reinterpret_cast<const float2*>(part_o + at * D + col);
      a0 += w * po.x;
      a1 += w * po.y;
    }
    *reinterpret_cast<__nv_bfloat162*>(dst + col) =
        __floats2bfloat162_rn(a0, a1);
  }
  if (lane == 0) lse[lse_at] = total;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, void* out, void* lse, void* part_o,
                   void* part_lse, int B, int Sq, int Sk, int N, float scale,
                   int causal, int chunk_tiles, int nchunks,
                   cudaStream_t stream) {
  using L = FwdWg<D>;
  if (Sq <= 0 || Sk <= 0 || nchunks < 1 || chunk_tiles < 1 ||
      (nchunks > 1 && (part_o == nullptr || part_lse == nullptr))) {
    return cudaErrorInvalidValue;
  }
  CUtensorMap mq, mk, mv;
  if (!encode_map(&mq, q, B, Sq, N, D, L::BQ) ||
      !encode_map(&mk, k, B, Sk, N, D, L::BK) ||
      !encode_map(&mv, v, B, Sk, N, D, L::BK)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kBytes);
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>((Sq + L::BQ - 1) / L::BQ) *
                           nchunks * B * N;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_fwd_wgmma<D><<<static_cast<unsigned>(blocks), kFwdThreads, L::kBytes,
                       stream>>>(
      mq, mk, mv, static_cast<const float*>(bias), static_cast<bf16*>(out),
      static_cast<float*>(lse),
      nchunks > 1 ? static_cast<float*>(part_o) : nullptr,
      static_cast<float*>(part_lse), B, Sq, Sk, N, scale, causal,
      chunk_tiles, nchunks);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_combine(const void* part_o, const void* part_lse,
                           void* out, void* lse, int B, int Sq, int N,
                           int nchunks, cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * N * Sq;
  if (rows == 0) return cudaSuccess;
  flash_fwd_combine<D><<<static_cast<unsigned>((rows + 7) / 8), 256, 0,
                         stream>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_lse),
      static_cast<bf16*>(out), static_cast<float*>(lse),
      static_cast<int>(rows), Sq, N, nchunks);
  return cudaGetLastError();
}

}  // namespace
}  // namespace macaw

// part_o [nchunks, B, Sq, N, D] and part_lse [nchunks, B, Sq, N] fp32 are
// the split's workspace (read only when nchunks > 1; then out and lse are
// left to macaw_flash_attention_combine).
extern "C" int macaw_flash_attention(const void* q, const void* k,
                                     const void* v, const void* bias,
                                     void* out, void* lse, void* part_o,
                                     void* part_lse, int B, int Sq, int Sk,
                                     int N, int D, float scale, int causal,
                                     int chunk_tiles, int nchunks,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return macaw::launch<64>(q, k, v, bias, out, lse, part_o, part_lse, B,
                               Sq, Sk, N, scale, causal, chunk_tiles,
                               nchunks, st);
    case 128:
      return macaw::launch<128>(q, k, v, bias, out, lse, part_o, part_lse, B,
                                Sq, Sk, N, scale, causal, chunk_tiles,
                                nchunks, st);
    case 256:
      return macaw::launch<256>(q, k, v, bias, out, lse, part_o, part_lse, B,
                                Sq, Sk, N, scale, causal, chunk_tiles,
                                nchunks, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int macaw_flash_attention_combine(const void* part_o,
                                             const void* part_lse, void* out,
                                             void* lse, int B, int Sq, int N,
                                             int D, int nchunks,
                                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return macaw::launch_combine<64>(part_o, part_lse, out, lse, B, Sq, N,
                                       nchunks, st);
    case 128:
      return macaw::launch_combine<128>(part_o, part_lse, out, lse, B, Sq, N,
                                        nchunks, st);
    case 256:
      return macaw::launch_combine<256>(part_o, part_lse, out, lse, B, Sq, N,
                                        nchunks, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
