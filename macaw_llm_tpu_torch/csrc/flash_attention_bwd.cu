// Flash-attention backward: delta, dq (B3) and dk/dv (B4), probabilities
// recomputed from the forward's log-sum-exp.
//
// Replaces: macaw_llm_tpu/ops/pallas/flash_attention.py:366 (_bwd_dq_kernel)
// and :413 (_bwd_dkv_kernel), the two pallas_calls of _flash_bwd, and the
// delta of _flash_bwd (:318, plain jnp there).
//
// The kernels take q/dO [B, Sq, N, D], k/v [B, Sk, N, D] bf16, lse and delta
// fp32 [B*N, Sq] (delta = rowsum(dO * O), less the LSE cotangent when there
// is one), an optional additive fp32 padding bias [B, Sk], and recompute
//   S  = Q K^T * scale + bias (masked),  P = exp(S - lse),
//   dP = dO V^T,                         dS = P * (dP - delta)  (bf16),
//   dQ = dS K * scale,  dK = dS^T Q * scale,  dV = P^T dO  (P in bf16),
// with fp32 accumulation, as the TPU kernels do. P is forced to 0 where the
// key is masked and on rows whose lse is NEG_INF (a query with no valid key:
// its forward output is zeros), so such rows give zero gradients.
//
// Bound on the H100 at the train shape (B=8, S=1080, N=32, D=128, causal):
// operations. dq does 3 and dk/dv 4 [S x S x D] products over the causal
// half, 1.15e11 and 1.53e11 FLOP (0.116 and 0.155 ms at 989 TFLOP/s)
// against 3.3e8 bytes of inputs and outputs (0.1 ms at 3.35 TB/s). delta is
// bytes: it reads O and dO once (1.4e8 bytes, 0.042 ms).
//
// Design at D = 64 and 128 (sm_90a: TMA, mbarriers, wgmma). The TPU's split
// into a dq kernel and a dk/dv kernel stays: neither needs atomics, each
// keeps one family of accumulators in registers, and every sum is taken in
// a fixed order, so the gradients are the same bits from run to run.
//  * Both kernels run two warpgroups of consumers and no producer warp:
//    with 8 warps a thread may hold 255 registers (dK and dV alone take
//    128 of a dk/dv thread's), where a ninth warp on the SM's four
//    register-file quarters caps every thread at 168. Thread 0 issues TMA
//    loads of 64-row tiles into a 3-stage ring of 128-byte-swizzled
//    shared-memory panels (rows of 64 bf16), guarded by a full and an empty
//    mbarrier per stage; after each tile it refills the stage of the tile
//    before (which the other warpgroup has most likely left), so two tiles
//    stay in flight. In dk/dv each warpgroup copies a tile's lse and delta
//    into shared memory with cp.async a tile ahead of their use; in dq each
//    thread reads the padding bias of its own columns while the products
//    run.
//    The tensor maps describe [B, S, N, D] in 4-D (head stride N*D), so one
//    map serves every head, and TMA fills rows past Sq or Sk with zeros.
//  * dk/dv: one block per (batch x head, 128-key tile); block 0 of the key
//    axis has the most causal work and starts first. Each consumer owns 64
//    keys: its K and V are loaded once, its dK and dV (64 x D fp32 each)
//    stay in registers. Per 64-query tile, from the causal diagonal on:
//    S^T = K Q^T and dP^T = V dO^T (wgmma, both operands in shared
//    memory); P^T (bias, ragged tail, causal and lse masks) and dS^T =
//    P^T (dP^T - delta) in registers, rounded to bf16 and kept there as the
//    A operands of dV += P^T dO and dK += dS^T Q. Issuing the products in
//    these two groups keeps at most S^T, dP^T, dK and dV live at once.
//  * dq: one block per (batch x head, 128-query tile), last tile first
//    (most causal work). Each consumer owns 64 queries with Q and dO loaded
//    once and dQ (64 x D fp32) in registers; per 64-key tile up to the
//    causal diagonal: S = Q K^T, dP = dO V^T, dS in bf16 registers, then
//    dQ += dS K.
//  * A consumer whose rows a tile cannot reach (above the causal diagonal,
//    or past Sq / Sk) skips the products but still takes the stage and
//    releases it, so the ring's phases stay in step.
//  * Epilogues scale, round to bf16 and store pairs of columns from the
//    accumulator registers.
// D = 256 keeps the first WMMA kernels (further below): two 64 x 256 fp32
// accumulators do not fit a thread's 255 registers, and D = 256 is not on
// the train path (Whisper is frozen, the alignment takes the einsum route).
//
// delta: one warp per (batch, query, head) row, 16-byte loads of O and dO,
// an fp32 dot in a fixed order, written as [B*N, Sq].
#include "hopper.cuh"

using namespace nvcuda;

namespace macaw {
namespace {

// ------------------------------------------------------------------ delta

// delta[b*N + n, s] = sum_d dO[b, s, n, d] O[b, s, n, d] (- g_lse[b, s, n])
__global__ void __launch_bounds__(256)
    flash_bwd_delta_kernel(const bf16* __restrict__ out,
                           const bf16* __restrict__ dout,
                           const float* __restrict__ g_lse,
                           float* __restrict__ delta, int rows, int S, int N,
                           int D) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const size_t at = static_cast<size_t>(row) * D;
  const uint4* o = reinterpret_cast<const uint4*>(out + at);
  const uint4* g = reinterpret_cast<const uint4*>(dout + at);
  float acc = 0.f;
  for (int c = lane; c < D / 8; c += 32) {
    const uint4 a = o[c], b = g[c];
    const bf16* pa = reinterpret_cast<const bf16*>(&a);
    const bf16* pb = reinterpret_cast<const bf16*>(&b);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc += bf2f(pa[e]) * bf2f(pb[e]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) {
    const int n = row % N, s = (row / N) % S, b = row / (N * S);
    if (g_lse != nullptr) acc -= g_lse[row];
    delta[(static_cast<size_t>(b) * N + n) * S + s] = acc;
  }
}

// ------------------------------------------------- dk/dv (B4), D 64 / 128

// Two consumer warpgroups and nothing else: 8 warps, two on each of the
// SM's four register-file quarters, so a thread may hold up to 255
// registers (a ninth warp would cap every thread at 168). Thread 0 issues
// the TMA loads.
constexpr int kWgThreads = 256;
constexpr int kStages = 3;

template <int D>
struct DkvWg {
  static constexpr int NP = D / 64;  // 64-column panels of a tile
  static constexpr int BKV = 128, BQ = 64;
  static constexpr int kPanelKV = BKV * 128, kPanelQ = BQ * 128;
  static constexpr int kK = 0, kV = NP * kPanelKV;
  static constexpr int kStage0 = 2 * NP * kPanelKV;
  static constexpr int kStageBytes = 2 * NP * kPanelQ;  // Q, then dO
  // per warpgroup, two buffers of a tile's lse and delta (64 + 64 fp32)
  static constexpr int kVec = kStage0 + kStages * kStageBytes;
  static constexpr int kBar = kVec + 2 * 2 * 2 * BQ * 4;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
  static constexpr uint32_t kKvTx = 2 * BKV * D * 2, kStageTx = 2 * BQ * D * 2;
};

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do,
                        const float* __restrict__ bias,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq,
                        int Sk, int N, float scale, int causal) {
  using L = DkvWg<D>;
  constexpr int NP = L::NP, BQ = L::BQ;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_kv = base + L::kBar;
  const Ring<kStages> ring{bar_kv + 8, bar_kv + 8 + 8 * kStages};

  const int bn = blockIdx.x, b = bn / N, n = bn % N;
  const int kb0 = blockIdx.y * L::BKV;
  // causal: query tiles wholly before the block's first key add nothing
  const int qt0 = causal ? kb0 / BQ : 0;
  const int ntiles = max((Sq + BQ - 1) / BQ - qt0, 0);

  // tile i: Q and dO rows [q0, q0 + 64) into its stage
  auto load_tile = [&](int i) {
    const int q0 = (qt0 + i) * BQ;
    const uint32_t st = base + L::kStage0 + (i % kStages) * L::kStageBytes;
    const uint32_t bar = ring.full_bar(i);
    mbar_arrive_expect_tx(bar, L::kStageTx);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      tma_load_4d(st + p * L::kPanelQ, &tm_q, bar, 64 * p, n, q0, b);
      tma_load_4d(st + (NP + p) * L::kPanelQ, &tm_do, bar, 64 * p, n, q0, b);
    }
  };

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(ring.full + 8 * s, 1);
      mbar_init(ring.empty + 8 * s, kWgThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_arrive_expect_tx(bar_kv, L::kKvTx);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      tma_load_4d(base + L::kK + p * L::kPanelKV, &tm_k, bar_kv, 64 * p, n,
                  kb0, b);
      tma_load_4d(base + L::kV + p * L::kPanelKV, &tm_v, bar_kv, 64 * p, n,
                  kb0, b);
    }
    for (int i = 0; i < min(ntiles, kStages); ++i) load_tile(i);
  }
  __syncthreads();

  // each warpgroup owns 64 keys
  const int c = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int kw0 = kb0 + 64 * c;
  int key[2];
  float kbias[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    key[r] = kw0 + 16 * warp + g + 8 * r;
    // a key past Sk: a zero row of K, masked
    kbias[r] = key[r] >= Sk      ? kNegInf
               : bias == nullptr ? 0.f
                                 : bias[static_cast<size_t>(b) * Sk + key[r]];
  }
  const float* lse_b = lse + static_cast<size_t>(bn) * Sq;
  const float* delta_b = delta + static_cast<size_t>(bn) * Sq;
  // tile i's lse (threads 0-63) and delta (64-127) into buffer i % 2 of
  // this warpgroup, one cp.async group per tile, a tile ahead of its use
  const uint32_t vec = base + L::kVec + c * 2 * 2 * BQ * 4;
  const float* vec_p = reinterpret_cast<const float*>(
      smem_raw + (vec - smem_u32(smem_raw)));
  auto prefetch = [&](int i) {
    const int qi = (qt0 + i) * BQ + tid % BQ;
    const float* src = tid < BQ ? lse_b : delta_b;
    cp_async4(vec + ((i % 2) * 2 * BQ + tid) * 4, src + min(qi, Sq - 1),
              qi < Sq);
    cp_async_commit();
  };
  if (ntiles > 0) prefetch(0);
  float dk_acc[D / 2], dv_acc[D / 2], st[32], dpt[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const uint32_t ka = base + L::kK + c * 64 * 128;
  const uint32_t va = base + L::kV + c * 64 * 128;
  mbar_wait(bar_kv, 0);

  for (int i = 0; i < ntiles; ++i) {
    ring.wait_full(i);
    cp_async_wait_all();
    // tile i's lse and delta are in, and no thread still reads tile i - 1's
    warpgroup_sync(c);
    if (i + 1 < ntiles) prefetch(i + 1);
    const float* v = vec_p + (i % 2) * 2 * BQ;
    const int q0 = (qt0 + i) * BQ;
    const bool live = kw0 < Sk && !(causal && q0 + BQ - 1 < kw0);
    const uint32_t qs = base + L::kStage0 + (i % kStages) * L::kStageBytes;
    const uint32_t dos = qs + NP * L::kPanelQ;
    if (live) {
      // S^T = K Q^T and dP^T = V dO^T (64 keys x 64 queries each)
      wgmma_fence();
      wgmma_ss_n64_first(st, desc_kmajor(ka), desc_kmajor(qs));
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk) {
        const int p = kk / 4, w = 32 * (kk % 4);
        wgmma_ss_n64(st, desc_kmajor(ka + p * L::kPanelKV + w),
                     desc_kmajor(qs + p * L::kPanelQ + w), 1);
      }
      wgmma_ss_n64_first(dpt, desc_kmajor(va), desc_kmajor(dos));
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk) {
        const int p = kk / 4, w = 32 * (kk % 4);
        wgmma_ss_n64(dpt, desc_kmajor(va + p * L::kPanelKV + w),
                     desc_kmajor(dos + p * L::kPanelQ + w), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      // P^T, and dS^T = P^T (dP^T - delta); both rounded to bf16 below
      // (queries past Sq: lse NEG_INF, so P = 0)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = 8 * j + 2 * t + h;
          const float l = q0 + col < Sq ? v[col] : kNegInf, dl = v[BQ + col];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int idx = 4 * j + 2 * r + h;
            float sc = st[idx] * scale + kbias[r];
            if (causal && key[r] > q0 + col) sc = kNegInf;
            const float p = (l > kMaskedLogit && sc > kMaskedLogit)
                                ? __expf(sc - l) : 0.f;
            st[idx] = p;
            dpt[idx] = p * (dpt[idx] - dl);
          }
        }
      }
      uint32_t pa[4][4], da[4][4];
      acc_to_a(st, pa);
      acc_to_a(dpt, da);
      // dV += P^T dO;  dK += dS^T Q
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs(dv_acc, pa[kk], desc_mnmajor(dos + kk * 2048, L::kPanelQ));
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs(dk_acc, da[kk], desc_mnmajor(qs + kk * 2048, L::kPanelQ));
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(dv_acc);
      reg_fence(dk_acc);
    }
    mbar_arrive(ring.empty_bar(i));
    if (threadIdx.x == 0) {
      const int next = ring.refill_after(i, ntiles);
      if (next >= 0) load_tile(next);
    }
  }

  reg_fence(dk_acc);
  reg_fence(dv_acc);
  const size_t tok = static_cast<size_t>(N) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= Sk) continue;
    const size_t at = (static_cast<size_t>(b) * Sk + key[r]) * tok +
                      static_cast<size_t>(n) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * j) =
          __floats2bfloat162_rn(dk_acc[4 * j + 2 * r] * scale,
                                dk_acc[4 * j + 2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * j) =
          __floats2bfloat162_rn(dv_acc[4 * j + 2 * r],
                                dv_acc[4 * j + 2 * r + 1]);
    }
  }
}

// ---------------------------------------------------- dq (B3), D 64 / 128

template <int D>
struct DqWg {
  static constexpr int NP = D / 64;
  static constexpr int BQ = 128, BK = 64;
  static constexpr int kPanelQ = BQ * 128, kPanelK = BK * 128;
  static constexpr int kQ = 0, kDo = NP * kPanelQ;
  static constexpr int kStage0 = 2 * NP * kPanelQ;
  static constexpr int kStageBytes = 2 * NP * kPanelK;  // K, then V
  static constexpr int kBar = kStage0 + kStages * kStageBytes;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
  static constexpr uint32_t kQdTx = 2 * BQ * D * 2, kStageTx = 2 * BK * D * 2;
};

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do,
                       const float* __restrict__ bias,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dq,
                       int Sq, int Sk, int N, float scale, int causal) {
  using L = DqWg<D>;
  constexpr int NP = L::NP, BK = L::BK;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_qd = base + L::kBar;
  const Ring<kStages> ring{bar_qd + 8, bar_qd + 8 + 8 * kStages};

  const int bn = blockIdx.x, b = bn / N, n = bn % N;
  // the last query tile (the most causal work) first
  const int qb0 = (gridDim.y - 1 - blockIdx.y) * L::BQ;
  int ntiles = (Sk + BK - 1) / BK;
  if (causal) ntiles = min(ntiles, (min(qb0 + L::BQ, Sq) - 1) / BK + 1);

  // tile i: K and V rows [64 i, 64 i + 64) into its stage
  auto load_tile = [&](int i) {
    const uint32_t st = base + L::kStage0 + (i % kStages) * L::kStageBytes;
    const uint32_t bar = ring.full_bar(i);
    mbar_arrive_expect_tx(bar, L::kStageTx);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      tma_load_4d(st + p * L::kPanelK, &tm_k, bar, 64 * p, n, i * BK, b);
      tma_load_4d(st + (NP + p) * L::kPanelK, &tm_v, bar, 64 * p, n, i * BK,
                  b);
    }
  };

  if (threadIdx.x == 0) {
    mbar_init(bar_qd, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(ring.full + 8 * s, 1);
      mbar_init(ring.empty + 8 * s, kWgThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_arrive_expect_tx(bar_qd, L::kQdTx);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      tma_load_4d(base + L::kQ + p * L::kPanelQ, &tm_q, bar_qd, 64 * p, n,
                  qb0, b);
      tma_load_4d(base + L::kDo + p * L::kPanelQ, &tm_do, bar_qd, 64 * p, n,
                  qb0, b);
    }
    for (int i = 0; i < min(ntiles, kStages); ++i) load_tile(i);
  }
  __syncthreads();

  // each warpgroup owns 64 queries
  const int c = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int qw0 = qb0 + 64 * c;
  int qrow[2];
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qrow[r] = qw0 + 16 * warp + g + 8 * r;
    const bool in = qrow[r] < Sq;
    const size_t at = static_cast<size_t>(bn) * Sq + qrow[r];
    row_lse[r] = in ? lse[at] : kNegInf;
    row_delta[r] = in ? delta[at] : 0.f;
  }
  const float* bias_b =
      bias != nullptr ? bias + static_cast<size_t>(b) * Sk : nullptr;
  float dq_acc[D / 2], sa[32], dpa[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
  const uint32_t qa = base + L::kQ + c * 64 * 128;
  const uint32_t doa = base + L::kDo + c * 64 * 128;
  mbar_wait(bar_qd, 0);

  for (int i = 0; i < ntiles; ++i) {
    ring.wait_full(i);
    __syncwarp();
    const int k0 = i * BK;
    const bool live = qw0 < Sq && !(causal && k0 > qw0 + 63);
    const uint32_t ks = base + L::kStage0 + (i % kStages) * L::kStageBytes;
    const uint32_t vs = ks + NP * L::kPanelK;
    if (live) {
      // S = Q K^T, dP = dO V^T (64 queries x 64 keys each)
      wgmma_fence();
      wgmma_ss_n64_first(sa, desc_kmajor(qa), desc_kmajor(ks));
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk) {
        const int p = kk / 4, w = 32 * (kk % 4);
        wgmma_ss_n64(sa, desc_kmajor(qa + p * L::kPanelQ + w),
                     desc_kmajor(ks + p * L::kPanelK + w), 1);
      }
      wgmma_ss_n64_first(dpa, desc_kmajor(doa), desc_kmajor(vs));
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk) {
        const int p = kk / 4, w = 32 * (kk % 4);
        wgmma_ss_n64(dpa, desc_kmajor(doa + p * L::kPanelQ + w),
                     desc_kmajor(vs + p * L::kPanelK + w), 1);
      }
      wgmma_commit();
      // the padding bias of this thread's 16 keys, read while the products
      // run (keys past Sk: a zero row of K, masked)
      float kb[16];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int kj = k0 + 8 * j + 2 * t + h;
          kb[2 * j + h] = kj < Sk ? (bias_b != nullptr ? bias_b[kj] : 0.f)
                                  : kNegInf;
        }
      }
      wgmma_wait_all();
      reg_fence(sa);
      reg_fence(dpa);
      // dS = P (dP - delta), rounded to bf16
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = 8 * j + 2 * t + h;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int idx = 4 * j + 2 * r + h;
            float sc = sa[idx] * scale + kb[2 * j + h];
            if (causal && k0 + col > qrow[r]) sc = kNegInf;
            const float p = (row_lse[r] > kMaskedLogit && sc > kMaskedLogit)
                                ? __expf(sc - row_lse[r]) : 0.f;
            dpa[idx] = p * (dpa[idx] - row_delta[r]);
          }
        }
      }
      uint32_t da[4][4];
      acc_to_a(dpa, da);
      // dQ += dS K
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs(dq_acc, da[kk], desc_mnmajor(ks + kk * 2048, L::kPanelK));
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(dq_acc);
    }
    mbar_arrive(ring.empty_bar(i));
    if (threadIdx.x == 0) {
      const int next = ring.refill_after(i, ntiles);
      if (next >= 0) load_tile(next);
    }
  }

  reg_fence(dq_acc);
  const size_t tok = static_cast<size_t>(N) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qrow[r] >= Sq) continue;
    const size_t at = (static_cast<size_t>(b) * Sq + qrow[r]) * tok +
                      static_cast<size_t>(n) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dq + at + 8 * j) =
          __floats2bfloat162_rn(dq_acc[4 * j + 2 * r] * scale,
                                dq_acc[4 * j + 2 * r + 1] * scale);
    }
  }
}

// --------------------------------------- D = 256: the first WMMA kernels
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


template <int D>
cudaError_t launch_dq_wgmma(const void* q, const void* k, const void* v,
                            const void* bias, const void* dout,
                            const void* lse, const void* delta, void* dq,
                            int B, int Sq, int Sk, int N, float scale,
                            int causal, cudaStream_t stream) {
  using L = DqWg<D>;
  CUtensorMap mq, mk, mv, mdo;
  if (!encode_map(&mq, q, B, Sq, N, D, L::BQ) ||
      !encode_map(&mdo, dout, B, Sq, N, D, L::BQ) ||
      !encode_map(&mk, k, B, Sk, N, D, L::BK) ||
      !encode_map(&mv, v, B, Sk, N, D, L::BK)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * N, (Sq + L::BQ - 1) / L::BQ);
  flash_bwd_dq_wgmma<D><<<grid, kWgThreads, L::kBytes, stream>>>(
      mq, mk, mv, mdo, static_cast<const float*>(bias),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), Sq, Sk, N, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_wgmma(const void* q, const void* k, const void* v,
                             const void* bias, const void* dout,
                             const void* lse, const void* delta, void* dk,
                             void* dv, int B, int Sq, int Sk, int N,
                             float scale, int causal, cudaStream_t stream) {
  using L = DkvWg<D>;
  CUtensorMap mq, mk, mv, mdo;
  if (!encode_map(&mq, q, B, Sq, N, D, L::BQ) ||
      !encode_map(&mdo, dout, B, Sq, N, D, L::BQ) ||
      !encode_map(&mk, k, B, Sk, N, D, L::BKV) ||
      !encode_map(&mv, v, B, Sk, N, D, L::BKV)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * N, (Sk + L::BKV - 1) / L::BKV);
  flash_bwd_dkv_wgmma<D><<<grid, kWgThreads, L::kBytes, stream>>>(
      mq, mk, mv, mdo, static_cast<const float*>(bias),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq, Sk, N, scale,
      causal);
  return cudaGetLastError();
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

extern "C" int macaw_flash_attention_bwd_delta(const void* out,
                                               const void* dout,
                                               const void* g_lse, void* delta,
                                               int B, int S, int N, int D,
                                               void* stream) {
  const int rows = B * S * N;
  if (rows == 0) return 0;
  macaw::flash_bwd_delta_kernel<<<(rows + 7) / 8, 256, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const macaw::bf16*>(out),
      static_cast<const macaw::bf16*>(dout),
      static_cast<const float*>(g_lse), static_cast<float*>(delta), rows, S,
      N, D);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int macaw_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* bias,
    const void* dout, const void* lse, const void* delta, void* dq, int B,
    int Sq, int Sk, int N, int D, float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return macaw::launch_dq_wgmma<64>(q, k, v, bias, dout, lse, delta, dq,
                                        B, Sq, Sk, N, scale, causal, st);
    case 128:
      return macaw::launch_dq_wgmma<128>(q, k, v, bias, dout, lse, delta, dq,
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
      return macaw::launch_dkv_wgmma<64>(q, k, v, bias, dout, lse, delta, dk,
                                         dv, B, Sq, Sk, N, scale, causal, st);
    case 128:
      return macaw::launch_dkv_wgmma<128>(q, k, v, bias, dout, lse, delta,
                                          dk, dv, B, Sq, Sk, N, scale, causal,
                                          st);
    case 256:
      return macaw::launch_dkv<256, 2>(q, k, v, bias, dout, lse, delta, dk,
                                       dv, B, Sq, Sk, N, scale, causal, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
