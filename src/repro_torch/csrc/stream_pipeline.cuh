// Fused pointwise stage chain for NVIDIA Hopper (sm_90a): the fixed part.
//
// Replaces the TPU kernel `stream_pipeline` / `_kernel` of
// src/repro/kernels/stream_pipeline.py:34.  There each grid step loads one
// (256, 512) tile of the padded plane into VMEM, applies every stage in
// turn and stores the tile once; the plane is padded to whole tiles first
// and cropped after.  Here the plane is one flat array of n float32 values:
// for pointwise stages the result depends on neither the tile nor the
// padding, so there is no pad, no crop and no tile.  The ragged tail is
// masked by the loop bound.
//
// What bounds it on an H100: the bytes, one read and one write of the
// plane (8 bytes per element) against 3.35 TB/s; a chain needs about 20
// float32 operations per byte before the arithmetic would.  So the design
// moves each byte once, in wide loads, with enough of them in flight:
//
//   * each thread takes 4 consecutive values as one 16-byte float4 load
//     and store when both pointers are 16-byte aligned (kVec); otherwise,
//     and for the last n % 4 values, scalar loads;
//   * the whole chain runs in registers between the load and the store:
//     nothing else touches memory;
//   * the blocks walk the plane in a grid-stride loop, the grid sized by
//     the caller from n and capped at a few blocks per SM, so every SM
//     keeps its 2048 threads' loads in flight without a tail of blocks;
//   * offsets are 64-bit (an 8K plane is 33 M values; a batch of them
//     passes 2^31).
//
// A generated source (repro_torch/kernels/stream_pipeline.py) includes this
// header and supplies only the chain, as a functor `float(float)` whose body
// the expression recorder emitted from the stage functions.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "stream_group.cuh"  // sg:: helpers the recorded bodies call

namespace sp {

constexpr int kThreads = 256;

template <bool kVec, class Chain>
__global__ void __launch_bounds__(kThreads)
    pipeline_kernel(const float* __restrict__ in, float* __restrict__ out,
                    long long n) {
  const Chain f{};
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long tail = 0;
  if (kVec) {
    const long long n4 = n / 4;
    const float4* __restrict__ in4 = reinterpret_cast<const float4*>(in);
    float4* __restrict__ out4 = reinterpret_cast<float4*>(out);
    for (long long i = first; i < n4; i += stride) {
      float4 v = __ldg(in4 + i);
      v.x = f(v.x);
      v.y = f(v.y);
      v.z = f(v.z);
      v.w = f(v.w);
      out4[i] = v;
    }
    tail = n4 * 4;
  }
  for (long long i = tail + first; i < n; i += stride)
    out[i] = f(__ldg(in + i));
}

// Launches the chain over n values on `stream`; returns the CUDA error.
template <class Chain>
int launch(const void* in, void* out, long long n, int vec, int grid,
           void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    pipeline_kernel<true, Chain><<<grid, kThreads, 0, s>>>(
        (const float*)in, (float*)out, n);
  else
    pipeline_kernel<false, Chain><<<grid, kThreads, 0, s>>>(
        (const float*)in, (float*)out, n);
  return (int)cudaGetLastError();
}

}  // namespace sp
