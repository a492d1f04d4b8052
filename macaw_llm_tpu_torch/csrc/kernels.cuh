// Shared helpers of the port's hand-written Hopper kernels (sm_90a).
//
// Conventions of every C entry point in this directory:
//   * tensors arrive as raw device pointers from torch (contiguous, checked
//     by the Python wrapper); the kernel allocates nothing;
//   * it launches on the stream it is given (torch's current stream);
//   * it returns cudaGetLastError() right after its launches, so a launch
//     refused for its configuration reaches the caller as an error code.
#pragma once

#include <cfloat>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace macaw {

// float32 min: the reference package's NEG_INF for masked logits
constexpr float kNegInf = -FLT_MAX;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float bf2f(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ bf16 f2bf(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// One attention logit with the reference's masking order: scale, then the
// additive padding bias, then the causal mask. Keys at or past ``sk`` are
// the zero rows the TPU kernels padded with a NEG_INF bias.
__device__ __forceinline__ float masked_score(float dot, float scale,
                                              const float* bias, int kj,
                                              int qi, int sk, bool causal) {
  float s = kNegInf;
  if (kj < sk) {
    s = dot * scale;
    if (bias != nullptr) s += bias[kj];
  }
  if (causal && kj > qi) s = kNegInf;
  return s;
}

}  // namespace macaw
