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
// moves each byte once, in wide loads, with many of them in flight:
//
//   * each thread takes U float4 values (16 bytes each) and issues all
//     their loads before it applies the chain to any, so a thread has
//     U x 16 bytes in flight, not one load's; a block's loads are
//     kThreads float4 apart, so each warp reads whole 512-byte runs;
//     float4 only when both pointers are 16-byte aligned (kVec), else the
//     same walk over scalars;
//   * the grid is sized from n, one pass of kThreads * U vectors a block
//     and no grid-stride loop, so no thread walks a chain of dependent
//     load -> chain -> store trips;
//   * U (1, 2 or 4) is chosen at each launch from the chain's cost, the
//     plane's size, the SMs and the L2 (kernels/stream_pipeline.py:unroll,
//     measured per chain and plane in PERF.md): a heavy chain wants every
//     warp the card holds, a light one fewer, longer threads until the
//     plane passes the L2;
//   * plain loads (ld.global.nc) and stores: the streaming hints
//     (ld.global.cs / st.global.cs, evict first) cost up to 3 % at 8K
//     (4320x7680, past the 50 MB L2) and won nothing at the smaller planes;
//   * the whole chain runs in registers between the load and the store;
//   * the last n % 4 values take scalar loads, in the first block;
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

template <class Chain>
__device__ __forceinline__ void apply(const Chain& f, float& v) { v = f(v); }

template <class Chain>
__device__ __forceinline__ void apply(const Chain& f, float4& v) {
  v.x = f(v.x);
  v.y = f(v.y);
  v.z = f(v.z);
  v.w = f(v.w);
}

// Block b's thread t takes elements b * kThreads * U + t + j * kThreads
// (j < U) of m elements of type V.
template <int U, class V, class Chain>
__device__ __forceinline__ void walk(const V* __restrict__ in,
                                     V* __restrict__ out, long long m,
                                     const Chain& f) {
  const long long base = (long long)blockIdx.x * kThreads * U + threadIdx.x;
  V v[U];
#pragma unroll
  for (int j = 0; j < U; ++j) {  // every load before any use
    const long long i = base + (long long)j * kThreads;
    if (i < m) v[j] = __ldg(in + i);
  }
#pragma unroll
  for (int j = 0; j < U; ++j) {
    const long long i = base + (long long)j * kThreads;
    if (i < m) {
      apply(f, v[j]);
      out[i] = v[j];
    }
  }
}

template <bool kVec, int U, class Chain>
__global__ void __launch_bounds__(kThreads)
    pipeline_kernel(const float* __restrict__ in, float* __restrict__ out,
                    long long n) {
  const Chain f{};
  if (kVec) {
    const long long n4 = n / 4;
    walk<U>(reinterpret_cast<const float4*>(in),
            reinterpret_cast<float4*>(out), n4, f);
    const long long i = 4 * n4 + threadIdx.x;  // the ragged tail
    if (blockIdx.x == 0 && i < n) {
      float v = __ldg(in + i);
      apply(f, v);
      out[i] = v;
    }
  } else {
    walk<U>(in, out, n, f);
  }
}

template <int U, class Chain>
int launch_unrolled(const float* in, float* out, long long n, int vec,
                    cudaStream_t s) {
  const long long per_block = (long long)kThreads * U;
  const long long work = vec ? n / 4 : n;
  const long long grid = work > 0 ? (work + per_block - 1) / per_block : 1;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (vec)
    pipeline_kernel<true, U, Chain><<<(unsigned)grid, kThreads, 0, s>>>(
        in, out, n);
  else
    pipeline_kernel<false, U, Chain><<<(unsigned)grid, kThreads, 0, s>>>(
        in, out, n);
  return (int)cudaGetLastError();
}

// Launches the chain over n values on `stream`, float4 loads when vec and
// `unroll` (1, 2 or 4) of them a thread; returns the CUDA error.
template <class Chain>
int launch(const void* in, void* out, long long n, int vec, int unroll,
           void* stream) {
  const float* x = (const float*)in;
  float* y = (float*)out;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (unroll) {
    case 1: return launch_unrolled<1, Chain>(x, y, n, vec, s);
    case 2: return launch_unrolled<2, Chain>(x, y, n, vec, s);
    case 4: return launch_unrolled<4, Chain>(x, y, n, vec, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace sp
