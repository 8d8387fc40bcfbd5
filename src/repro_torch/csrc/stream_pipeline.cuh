// Fused pointwise stage chain for NVIDIA Hopper (sm_90a): the fixed part.
//
// Replaces the TPU kernel `stream_pipeline` / `_kernel` of
// src/repro/kernels/stream_pipeline.py:34.  There each grid step loads one
// (256, 512) tile of the padded plane into VMEM, applies every stage in
// turn and stores the tile once; the plane is padded to whole tiles first
// and cropped after.  Here the plane is one flat array of n values of its
// type T (float, __nv_bfloat16, __half, int or bool):
// for pointwise stages the result depends on neither the tile nor the
// padding, so there is no pad, no crop and no tile.  The ragged tail is
// masked by the loop bound.
//
// What bounds it on an H100: the bytes, one read and one write of the
// plane (8 bytes per float32 element, 4 per bf16 one) against 3.35 TB/s; a
// chain needs about 20 float32 operations per byte before the arithmetic
// would.  A bf16 or f16 plane computes in float32 and rounds each
// operation's result to its type (the recorder emits the rounding).  So the design
// moves each byte once, in wide loads, with many of them in flight:
//
//   * each thread takes UNROLL steps of 16 bytes of input (4 float32
//     values, 8 bf16) and issues all their loads before it applies the
//     chain to any, so a thread has UNROLL x 16 bytes in flight, not one
//     load's; a block's loads are kThreads steps apart, so each warp reads
//     whole 512-byte runs; 16-byte steps only when both pointers are
//     16-byte aligned (kVec), else the same walk over scalars;
//   * the grid is sized from n, one pass of kThreads * U vectors a block
//     and no grid-stride loop, so no thread walks a chain of dependent
//     load -> chain -> store trips;
//   * UNROLL (1, 2 or 4) is chosen at each launch from the chain's cost, the
//     plane's size, the SMs and the L2 (kernels/stream_pipeline.py:unroll,
//     measured per chain and plane in PERF.md): a heavy chain wants every
//     warp the card holds, a light one fewer, longer threads until the
//     plane passes the L2;
//   * plain loads (ld.global.nc) and stores: the streaming hints
//     (ld.global.cs / st.global.cs, evict first) cost up to 3 % at 8K
//     (4320x7680, past the 50 MB L2) and won nothing at the smaller planes;
//   * the whole chain runs in registers between the load and the store;
//   * the last n % (16 / sizeof(T)) values take scalar loads, in the
//     first block;
//   * offsets are 64-bit (an 8K plane is 33 M values; a batch of them
//     passes 2^31).
//
// A generated source (repro_torch/kernels/stream_pipeline.py) includes this
// header and supplies only the chain, as a functor `U(T)` with `using T`
// (the input's type) and `using U` (the output's: the plane's, or a
// staged run's stage value, a bool kept bool), whose body the expression
// recorder emitted from the stage functions.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "stream_group.cuh"  // sg:: helpers the recorded bodies call

namespace sp {

constexpr int kThreads = 256;

// One step of a thread: N = 16 / sizeof(T) input values (one 16-byte
// load: 4 float32 or int, 8 bf16 or f16, 16 bool) and their N results of
// type U, stored as N * sizeof(U) bytes.
template <class T, class U>
struct Step {
  static constexpr int N = 16 / (int)sizeof(T);
  static constexpr int kOutBytes = N * (int)sizeof(U);
};

template <int BYTES>
__device__ __forceinline__ void store_bytes(void* p, const void* src) {
  if constexpr (BYTES >= 16) {
#pragma unroll
    for (int j = 0; j < BYTES / 16; ++j) {
      uint4 t;
      memcpy(&t, (const char*)src + 16 * j, 16);
      reinterpret_cast<uint4*>(p)[j] = t;
    }
  } else if constexpr (BYTES == 8) {
    uint2 t;
    memcpy(&t, src, 8);
    *reinterpret_cast<uint2*>(p) = t;
  } else {
    static_assert(BYTES == 4, "a step stores 4, 8 or a multiple of 16 bytes");
    unsigned t;
    memcpy(&t, src, 4);
    *reinterpret_cast<unsigned*>(p) = t;
  }
}

template <class T>
__device__ __forceinline__ T load1(const T* p) {
  if constexpr (std::is_same<T, bool>::value) return *p;
  else return __ldg(p);
}

// Block b's thread t takes steps b * kThreads * UNROLL + t + j * kThreads
// (j < UNROLL) of m steps; a step is N values (VEC) or one (scalar).
template <bool VEC, int UNROLL, class Chain>
__device__ __forceinline__ void walk(const typename Chain::T* __restrict__ in,
                                     typename Chain::U* __restrict__ out,
                                     long long m, const Chain& f) {
  using T = typename Chain::T;
  using U = typename Chain::U;
  using S = Step<T, U>;
  constexpr int N = VEC ? S::N : 1;
  const long long base =
      (long long)blockIdx.x * kThreads * UNROLL + threadIdx.x;
  T v[UNROLL][N];
#pragma unroll
  for (int j = 0; j < UNROLL; ++j) {  // every load before any use
    const long long i = base + (long long)j * kThreads;
    if (i < m) {
      if constexpr (VEC) {
        const uint4 t = __ldg(reinterpret_cast<const uint4*>(in) + i);
        memcpy(v[j], &t, 16);
      } else {
        v[j][0] = load1(in + i);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < UNROLL; ++j) {
    const long long i = base + (long long)j * kThreads;
    if (i < m) {
      U r[N];
#pragma unroll
      for (int e = 0; e < N; ++e) r[e] = f(v[j][e]);
      if constexpr (VEC) store_bytes<S::kOutBytes>(out + i * N, r);
      else out[i] = r[0];
    }
  }
}

template <bool kVec, int UNROLL, class Chain>
__global__ void __launch_bounds__(kThreads)
    pipeline_kernel(const typename Chain::T* __restrict__ in,
                    typename Chain::U* __restrict__ out, long long n) {
  constexpr int N = Step<typename Chain::T, typename Chain::U>::N;
  const Chain f{};
  if (kVec) {
    const long long steps = n / N;
    walk<true, UNROLL>(in, out, steps, f);
    const long long i = N * steps + threadIdx.x;  // the ragged tail
    if (blockIdx.x == 0 && i < n) out[i] = f(load1(in + i));
  } else {
    walk<false, UNROLL>(in, out, n, f);
  }
}

template <int UNROLL, class Chain>
int launch_unrolled(const typename Chain::T* in, typename Chain::U* out,
                    long long n, int vec, cudaStream_t s) {
  const long long per_block = (long long)kThreads * UNROLL;
  const long long work =
      vec ? n / Step<typename Chain::T, typename Chain::U>::N : n;
  const long long grid = work > 0 ? (work + per_block - 1) / per_block : 1;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (vec)
    pipeline_kernel<true, UNROLL, Chain><<<(unsigned)grid, kThreads, 0, s>>>(
        in, out, n);
  else
    pipeline_kernel<false, UNROLL, Chain><<<(unsigned)grid, kThreads, 0, s>>>(
        in, out, n);
  return (int)cudaGetLastError();
}

// Launches the chain over n values on `stream`, 16-byte loads when vec and
// `unroll` (1, 2 or 4) of them a thread; returns the CUDA error.
template <class Chain>
int launch(const void* in, void* out, long long n, int vec, int unroll,
           void* stream) {
  using T = typename Chain::T;
  using U = typename Chain::U;
  const T* x = (const T*)in;
  U* y = (U*)out;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (unroll) {
    case 1: return launch_unrolled<1, Chain>(x, y, n, vec, s);
    case 2: return launch_unrolled<2, Chain>(x, y, n, vec, s);
    case 4: return launch_unrolled<4, Chain>(x, y, n, vec, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace sp
