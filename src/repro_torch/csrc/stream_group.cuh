// Fused dataflow group kernel for NVIDIA Hopper (sm_90a): the fixed part.
//
// Replaces the TPU kernel `lower_group_pallas` / `_group_kernel` of
// src/repro/core/fusion.py.  One thread block computes one (TH, TW)
// output tile of a fusion group over an (H, W) float32 plane:
//
//   1. load_window: every group input's (TH+2HY) x (TW+2HX) halo window
//      goes into shared memory, zero outside the plane (the zero pad the
//      TPU path does on the host);
//   2. eval_region: each stage, in topological order, is evaluated over
//      its output's halo-extended region into that channel's window,
//      masked to zero outside rows [r0, r1) x cols [0, W), with
//      __syncthreads() between stages -- the per-stage zero-padding
//      semantics of the reference, exactly;
//   3. eval_store: halo-free graph outputs are written straight to
//      device memory (centre tile only).
//
// A generated source (repro_torch/kernels/stream_group.py) includes this
// header and supplies only the stage expressions and the channel layout.
//
// What bounds it on an H100: for most groups the bytes -- each input
// read once plus its halo re-reads, each output written once -- against
// 3.35 TB/s; every intermediate stays in shared memory.  For a group
// with many transcendental calls per element (bilateral_filter: 25 expf
// per pixel) it is the arithmetic.  This first version keeps every
// buffered channel in shared memory and evaluates stages one after the
// other; it does not yet overlap loads with compute (no cp.async/TMA).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace sg {

constexpr int kThreads = 256;

// torch.maximum / torch.minimum: NaN in either operand gives NaN.
__device__ __forceinline__ float fmax_nan(float a, float b) {
  return (a != a || b != b) ? (a + b) : fmaxf(a, b);
}
__device__ __forceinline__ float fmin_nan(float a, float b) {
  return (a != a || b != b) ? (a + b) : fminf(a, b);
}
// torch.clamp: a NaN input stays NaN.
__device__ __forceinline__ float clamp_min(float a, float lo) {
  return (a != a) ? a : fmaxf(a, lo);
}
__device__ __forceinline__ float clamp_max(float a, float hi) {
  return (a != a) ? a : fminf(a, hi);
}
// torch.sign: -1, 0 or +1 (0 for NaN).
__device__ __forceinline__ float sign(float a) {
  return (float)((0.0f < a) - (a < 0.0f));
}

// Read of a split arm whose source is a group input: the arm is masked
// to the valid row band like every stage output, the input is not.
__device__ __forceinline__ float row_masked(float v, int gy, int r0, int r1) {
  return (gy >= r0 && gy < r1) ? v : 0.0f;
}

template <int H, int W, int TH, int TW, int HY, int HX>
__device__ __forceinline__ void load_window(float* __restrict__ dst,
                                            const float* __restrict__ src,
                                            int y0, int x0) {
  constexpr int PW = TW + 2 * HX;
  constexpr int N = (TH + 2 * HY) * PW;
  for (int i = threadIdx.x; i < N; i += kThreads) {
    const int gy = y0 + i / PW - HY;
    const int gx = x0 + i % PW - HX;
    dst[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                 ? __ldg(src + (size_t)gy * W + gx)
                 : 0.0f;
  }
}

template <int W, int TH, int TW, int HY, int HX, class F>
__device__ __forceinline__ void eval_region(float* __restrict__ dst, int y0,
                                            int x0, int r0, int r1, F f) {
  constexpr int PW = TW + 2 * HX;
  constexpr int N = (TH + 2 * HY) * PW;
  for (int i = threadIdx.x; i < N; i += kThreads) {
    const int ly = i / PW - HY;
    const int lx = i % PW - HX;
    const int gy = y0 + ly;
    const int gx = x0 + lx;
    dst[i] = (gy >= r0 && gy < r1 && gx >= 0 && gx < W) ? f(ly, lx) : 0.0f;
  }
}

template <int H, int W, int TH, int TW, class F>
__device__ __forceinline__ void eval_store(float* __restrict__ out, int y0,
                                           int x0, int r0, int r1, F f) {
  for (int i = threadIdx.x; i < TH * TW; i += kThreads) {
    const int ly = i / TW;
    const int lx = i % TW;
    const int gy = y0 + ly;
    const int gx = x0 + lx;
    if (gy < H && gx < W)
      out[(size_t)gy * W + gx] = (gy >= r0 && gy < r1) ? f(ly, lx) : 0.0f;
  }
}

}  // namespace sg
