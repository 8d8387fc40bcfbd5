// Shared pieces of the LM kernels (flash_attention.cu, decode_attention.cu,
// fused_mlp.cu, ssd_scan.cu): element-type conversions, warp reductions,
// the masking constant and the dynamic shared-memory opt-in.  Operands may
// be float32 or bfloat16; sums are float32 everywhere.  The bf16 routes of
// flash_attention.cu and fused_mlp.cu multiply on the tensor cores (their
// helpers are in tensor_core.cuh); everything else computes on the CUDA
// cores.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace lm {

// The TPU kernels' NEG_INF: masked logits, and the running max's start.
constexpr float kNegInf = -1e30f;

// Element-type codes passed by the Python wrappers.
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
// round to nearest even, as torch's .to(torch.bfloat16)
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Above 48 KB a block's shared memory must be dynamic and opted into, once
// per kernel instance.  Returns the CUDA error code (0 on success).
template <typename Kernel>
inline int allow_smem(Kernel kernel, int bytes, bool* done) {
  if (*done || bytes <= 48 * 1024) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) *done = true;
  return (int)e;
}

}  // namespace lm

// Each library exports its own error-string lookup for the wrapper.
#define LM_ERROR_STRING(name)                                   \
  extern "C" const char* name##_error_string(int e) {           \
    return cudaGetErrorString((cudaError_t)e);                  \
  }
