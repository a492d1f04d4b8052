// Hopper (sm_90a) building blocks shared by the attention kernels: the
// forward (flash_attention.cu, mh_attention.cu) and the backward
// (flash_attention_bwd.cu).
//
//  * mbarriers, with a trap on a wait that never ends;
//  * 4-D TMA loads of one head's 64-column panels of a [B, S, N, D] bf16
//    tensor, 128-byte swizzled (``encode_map`` builds the map on the host;
//    rows past S are zero-filled);
//  * wgmma wrappers: S = A B with both operands K-major in shared memory
//    (m64n64, m64n128), and D += A B with A in registers (bf16) and B
//    MN-major in shared memory (m64n64, m64n128, either half of m64n256);
//  * shared-memory matrix descriptors for those panels, and ``acc_to_a``,
//    which packs an fp32 accumulator into the bf16 A operand of the next
//    product;
//  * the forward kernels' tile steps: S = Q K^T, O += P V, the padding
//    bias of a thread's keys and the masked, scaled logits;
//  * ``Ring``: the full/empty barrier bookkeeping of a ring of TMA stages
//    that thread 0 fills.
#pragma once

#include <cuda.h>

#include "kernels.cuh"

namespace macaw {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// one arrival, and ``bytes`` more expected from TMA before the phase ends
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Wait for the completion of the barrier's phase of parity ``parity``. A
// wait that never ends (a fault in the ring's bookkeeping) traps after
// 2^26 polls, seconds on the card, so the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// a [rows x 64] box of a 4-D [B, S, N, D] tensor map at (d0, n, s0, b)
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int d0, int n,
                                            int s0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0), "r"(n),
      "r"(s0), "r"(b)
      : "memory");
}

// 4 bytes global -> shared, zeros when ``in`` is false
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// the 128 threads of warpgroup c (named barrier 1 + c)
__device__ __forceinline__ void warpgroup_sync(int c) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads of an accumulator above the wait
// that completes it (the wgmma asm is its only visible writer).
template <int M>
__device__ __forceinline__ void reg_fence(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptors for 128-byte-swizzled panels: rows of
// 128 bytes (64 bf16), 8-row groups 1024 bytes apart, panels 1024-aligned.
__device__ __forceinline__ uint64_t desc_addr(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
}

// K-major operand (a row per M or N index, K along the row); a k step of
// 16 inside a panel adds 32 bytes to the start address
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return desc_addr(addr) | (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// MN-major operand (a row per k, N along the row): consecutive 64-column
// panels ``panel_bytes`` apart; a k step of 16 is 16 rows, 2048 bytes
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr,
                                                 uint32_t panel_bytes) {
  return desc_addr(addr) | (static_cast<uint64_t>(panel_bytes >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The m64nNk16 accumulator of a thread (lane = 4 g + t of warp w holds rows
// 16 w + g and + 8, columns 8 j + 2 t and + 1 in d[4 j .. 4 j + 3]) read as
// the bf16 A operand of the next product over those columns: k step kk
// takes columns 16 kk .. 16 kk + 15 (KS = 4 k steps over 64 columns, 8
// over 128).
template <int KS>
__device__ __forceinline__ void acc_to_a(const float (&d)[8 * KS],
                                         uint32_t (&a)[KS][4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      a[kk][e] = pack_bf16(d[8 * kk + 2 * e], d[8 * kk + 2 * e + 1]);
    }
  }
}

// D[64 x 64] (+)= A B, A and B from shared memory, both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] = A B (the first k step: D is written, not read), A and B
// from shared memory, both K-major
__device__ __forceinline__ void wgmma_ss_n64_first(float (&d)[32], uint64_t da,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

// D[64 x 64] += A B, A [64 x 16] bf16 in registers, B [16 x 64] from
// shared memory, MN-major (N contiguous)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D[64 x 128] += A B, A [64 x 16] bf16 in registers, B [16 x 128] from
// shared memory, MN-major (N contiguous)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}


__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  wgmma_rs_n64(d, a, db, 1);
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  wgmma_rs_n128(d, a, db, 1);
}

// A logit or lse at or below this is masked (NEG_INF plus a finite term).
constexpr float kMaskedLogit = -1e30f;

// D[64 x 128] += A B into columns 2 OFF .. 2 OFF + 127 of a wider
// accumulator (d[OFF .. OFF + 63]): the halves of a 64 x 256 product, A
// [64 x 16] bf16 in registers, B [16 x 128] from shared memory, MN-major
template <int OFF, int M>
__device__ __forceinline__ void wgmma_rs_n128_at(float (&d)[M],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  static_assert(OFF + 64 <= M, "accumulator too small");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]),
        "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]),
        "+f"(d[OFF + 6]), "+f"(d[OFF + 7]), "+f"(d[OFF + 8]),
        "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]),
        "+f"(d[OFF + 15]), "+f"(d[OFF + 16]), "+f"(d[OFF + 17]),
        "+f"(d[OFF + 18]), "+f"(d[OFF + 19]), "+f"(d[OFF + 20]),
        "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
        "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]),
        "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]),
        "+f"(d[OFF + 30]), "+f"(d[OFF + 31]), "+f"(d[OFF + 32]),
        "+f"(d[OFF + 33]), "+f"(d[OFF + 34]), "+f"(d[OFF + 35]),
        "+f"(d[OFF + 36]), "+f"(d[OFF + 37]), "+f"(d[OFF + 38]),
        "+f"(d[OFF + 39]), "+f"(d[OFF + 40]), "+f"(d[OFF + 41]),
        "+f"(d[OFF + 42]), "+f"(d[OFF + 43]), "+f"(d[OFF + 44]),
        "+f"(d[OFF + 45]), "+f"(d[OFF + 46]), "+f"(d[OFF + 47]),
        "+f"(d[OFF + 48]), "+f"(d[OFF + 49]), "+f"(d[OFF + 50]),
        "+f"(d[OFF + 51]), "+f"(d[OFF + 52]), "+f"(d[OFF + 53]),
        "+f"(d[OFF + 54]), "+f"(d[OFF + 55]), "+f"(d[OFF + 56]),
        "+f"(d[OFF + 57]), "+f"(d[OFF + 58]), "+f"(d[OFF + 59]),
        "+f"(d[OFF + 60]), "+f"(d[OFF + 61]), "+f"(d[OFF + 62]),
        "+f"(d[OFF + 63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// the max and the sum over the 4 lanes of a quad (the lanes that hold one
// accumulator row between them)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------- forward attention tiles
// One warpgroup's 64 query rows against one tile of BK = 64 or 128 keys,
// as the forward kernels (flash_attention.cu, mh_attention.cu) lay them
// out: Q as D / 64 panels of 128 rows (the warpgroup's 64 rows at its own
// offset inside each), K and V as D / 64 panels of BK rows. The
// accumulator layout is acc_to_a's: lane 4 g + t of warp w holds rows
// 16 w + g and + 8 (r = 0, 1), columns 8 j + 2 t + h (h = 0, 1) in
// d[4 j + 2 r + h].
constexpr int kAttnPanelQ = 128 * 128, kAttnPanelK = 64 * 128;

// D[64 x 128] (+)= A B, A and B from shared memory, both K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 128] = A B (the first k step: D is written, not read)
__device__ __forceinline__ void wgmma_ss_n128_first(float (&d)[64],
                                                    uint64_t da,
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
        "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]),
        "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]),
        "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db), "r"(0));
}

// S = Q K^T [64 x BK] fp32, unscaled: D / 16 k steps, the first writes S;
// Q's panels PQ bytes apart
template <int D, int BK = 64, int PQ = kAttnPanelQ>
__device__ __forceinline__ void attn_qk(float (&s)[BK / 2], uint32_t qa,
                                        uint32_t ks) {
  constexpr int kPanelK = BK * 128;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int p = kk / 4, w = 32 * (kk % 4);
    const uint64_t da = desc_kmajor(qa + p * PQ + w);
    const uint64_t db = desc_kmajor(ks + p * kPanelK + w);
    if constexpr (BK == 64) {
      if (kk == 0) {
        wgmma_ss_n64_first(s, da, db);
      } else {
        wgmma_ss_n64(s, da, db, 1);
      }
    } else {
      if (kk == 0) {
        wgmma_ss_n128_first(s, da, db);
      } else {
        wgmma_ss_n128(s, da, db, 1);
      }
    }
  }
}

// O [64 x D] += P V: P [64 x BK keys] bf16 in registers (BK / 16 k steps
// of 16 keys), V MN-major in shared memory (n64, n128, or two n128 at
// D = 256)
template <int D, int BK = 64>
__device__ __forceinline__ void attn_pv(float (&o)[D / 2],
                                        const uint32_t (&pa)[BK / 16][4],
                                        uint32_t vs) {
  constexpr int kPanelK = BK * 128;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint32_t at = vs + kk * 2048;  // 16 keys: 16 rows of 128 bytes
    if constexpr (D == 64) {
      wgmma_rs_n64(o, pa[kk], desc_mnmajor(at, kPanelK), 1);
    } else if constexpr (D == 128) {
      wgmma_rs_n128(o, pa[kk], desc_mnmajor(at, kPanelK), 1);
    } else {
      wgmma_rs_n128_at<0>(o, pa[kk], desc_mnmajor(at, kPanelK));
      wgmma_rs_n128_at<64>(o, pa[kk],
                           desc_mnmajor(at + 2 * kPanelK, kPanelK));
    }
  }
}

// The padding bias of the thread's NKB key columns of the tile at k0; a
// key past Sk (a zero row of K from TMA) is NEG_INF.
template <int NKB>
__device__ __forceinline__ void attn_key_bias(float (&kb)[NKB],
                                              const float* bias_b, int k0,
                                              int Sk, int t) {
#pragma unroll
  for (int j = 0; j < NKB / 2; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kj = k0 + 8 * j + 2 * t + h;
      kb[2 * j + h] = kj < Sk ? (bias_b != nullptr ? bias_b[kj] : 0.f)
                              : kNegInf;
    }
  }
}

// The tile's logits in place, in masked_score's order (scale, bias, then
// NEG_INF above the causal diagonal where ``diag``), and the maxima of the
// thread's two rows over them (quad_max completes them).
template <int NS>
__device__ __forceinline__ void attn_scores(float (&s)[NS], float scale,
                                            const float (&kb)[NS / 2],
                                            bool diag, int k0,
                                            const int (&qrow)[2], int t,
                                            float (&mx)[2]) {
  mx[0] = mx[1] = kNegInf;
#pragma unroll
  for (int j = 0; j < NS / 4; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int idx = 4 * j + 2 * r + h;
        float sc = s[idx] * scale + kb[2 * j + h];
        if (diag && k0 + 8 * j + 2 * t + h > qrow[r]) sc = kNegInf;
        s[idx] = sc;
        mx[r] = fmaxf(mx[r], sc);
      }
    }
  }
}

// Ring bookkeeping of the streaming kernels: thread 0 fills stage i % kStages
// with tile i; every thread arrives on the stage's empty barrier when done
// with it. After tile i thread 0 refills the stage of tile i - 1 (which the
// other warpgroup has most likely left by then) with tile i + kStages - 1.
template <int kStages>
struct Ring {
  uint32_t full, empty;  // kStages barriers each, 8 bytes apart

  __device__ uint32_t full_bar(int i) const { return full + 8 * (i % kStages); }
  __device__ uint32_t empty_bar(int i) const {
    return empty + 8 * (i % kStages);
  }
  __device__ void wait_full(int i) const {
    mbar_wait(full_bar(i), (i / kStages) & 1);
  }
  // the tile whose stage is free for a refill once tile i is done, or -1
  __device__ int refill_after(int i, int ntiles) const {
    const int next = i + kStages - 1;
    if (i < 1 || next >= ntiles) return -1;
    mbar_wait(empty_bar(i - 1), ((i - 1) / kStages) & 1);
    return next;
  }
  // The same for a two-stage ring, where the stage of tile i - 1 already
  // holds tile i + 1: tile i's own stage takes tile i + 2 once every thread
  // is done with tile i.
  __device__ int refill_own(int i, int ntiles) const {
    const int next = i + kStages;
    if (next >= ntiles) return -1;
    mbar_wait(empty_bar(i), (i / kStages) & 1);
    return next;
  }
};

// A [B, S, N, D] bf16 tensor as a 4-D TMA map (innermost first) whose box
// is one 64-column panel of ``rows`` rows of one head, 128-byte swizzled;
// rows past S read as zeros.
inline bool encode_map(CUtensorMap* map, const void* ptr, int B, int S,
                       int N, int D, int rows) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(N) * D * 2,
                                 static_cast<cuuint64_t>(S) * N * D * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(
             map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace macaw
