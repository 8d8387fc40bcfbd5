// Fused dataflow group kernel for NVIDIA Hopper (sm_90a): the fixed part.
//
// Replaces the TPU kernel `lower_group_pallas` / `_group_kernel` of
// src/repro/core/fusion.py.  One thread block computes one (TH, TW)
// output tile of a fusion group over an (H, W) float32 plane, in two
// phases:
//
//   1. the windowed phase, for channels with a halo (a later stencil reads
//      them off-centre): load_window puts every such group input's
//      (TH+2HY) x (TW+2PX) window into shared memory by cp.async, zero
//      outside the plane (the zero pad the TPU path does on the host),
//      all of it in flight before the first wait; eval_region
//      evaluates each stage with a haloed output over that region into
//      its window, masked to zero outside rows [r0, r1) x cols [0, W) --
//      the per-stage zero-padding semantics of the reference, exactly;
//   2. the centre pass: one loop over the tile's centre, kVec adjacent
//      outputs of a row per thread and step, evaluates every halo-free
//      stage in registers (a halo-free channel is read only at offset
//      (0, 0), by stages over the centre), reads halo-free group inputs
//      straight from device memory (load4, every step's load issued before
//      the first step computes) and stores the group's outputs (store4).  A stencil's window rows are read once per step as
//      16-byte chunks (window_row) and reused across the kVec outputs.
//
// A barrier is emitted only before a pass that reads a window written by
// other threads since the last one (the generator tracks it).  Windows
// start PX = HX rounded up to 4 columns left of the tile, so their rows
// are 16-byte aligned in device and shared memory: loads and stores are
// float4 where the plane's width is a multiple of 4 and the pointers are
// 16-byte aligned (VEC), scalar at the plane's edges otherwise.
//
// A generated source (repro_torch/kernels/stream_group.py) includes this
// header and supplies only the stage expressions and the channel layout.
// Every value is computed by the recorder's expression in its order,
// under -fmad=false, so the kernel is bit-exact against the plain
// version.
//
// What bounds it on an H100: for most groups the bytes -- each input read
// once plus its halo re-reads, each output written once -- against
// 3.35 TB/s; every intermediate stays on chip.  For a group with many
// transcendental calls per element (bilateral_filter: 25 expf per pixel)
// it is the arithmetic.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace sg {

constexpr int kThreads = 256;
constexpr int kVec = 4;  // adjacent outputs per thread in the centre pass
// A group without windows streams the plane flat: blocks of kFlatThreads,
// each thread kFlatSteps chunks of kVec elements, a block 2 KB contiguous
// (on an H100 at full HD, 64 x 2 beat 128 x 1..4 and 256 x 1..2).
constexpr int kFlatThreads = 64;
constexpr int kFlatSteps = 2;

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

// A window's left (and right) margin: the halo rounded up to 4 columns.
__host__ __device__ constexpr int pad4(int hx) { return (hx + 3) & ~3; }

// 16 bytes read once: not kept in L1, and L2 fetches 256-byte sectors.
__device__ __forceinline__ float4 ldg4(const float* p) {
  float4 v;
  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::256B.v4.f32 {%0,%1,%2,%3}, [%4];\n"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
  return v;
}

// 16 bytes from device to shared memory without staging in registers,
// so every chunk of a window is in flight at once.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// Every cp.async of this thread has landed; a barrier must follow before
// other threads read the windows.
__device__ __forceinline__ void load_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Rows [y0-HY, y0+TH+HY) x cols [x0-PX, x0+TW+PX) of src into dst (row
// stride TW+2PX), zero outside the plane; one 16-byte chunk per step, by
// cp.async where it lies in the plane (VEC), scalar loads otherwise.
template <bool VEC, int H, int W, int TH, int TW, int HY, int HX>
__device__ __forceinline__ void load_window(float* __restrict__ dst,
                                            const float* __restrict__ src,
                                            int y0, int x0) {
  constexpr int PX = pad4(HX), PW = TW + 2 * PX, CH = PW / 4;
  constexpr int N = (TH + 2 * HY) * CH;
  for (int i = threadIdx.x; i < N; i += kThreads) {
    const int r = i / CH, c = (i - r * CH) * 4;
    const int gy = y0 + r - HY, gx = x0 + c - PX;
    float* d = dst + r * PW + c;
    if (VEC && gy >= 0 && gy < H && gx >= 0 && gx + 3 < W) {
      cp_async16(d, src + (size_t)gy * W + gx);
    } else {
      const bool row = gy >= 0 && gy < H;
      const float* p = src + (long long)gy * W + gx;
      float4 v;
      v.x = (row && gx >= 0 && gx < W) ? __ldg(p) : 0.0f;
      v.y = (row && gx + 1 >= 0 && gx + 1 < W) ? __ldg(p + 1) : 0.0f;
      v.z = (row && gx + 2 >= 0 && gx + 2 < W) ? __ldg(p + 2) : 0.0f;
      v.w = (row && gx + 3 >= 0 && gx + 3 < W) ? __ldg(p + 3) : 0.0f;
      *reinterpret_cast<float4*>(d) = v;
    }
  }
}

// A stage with halo (HY, HX) over its region, one element per thread and
// step, into its window.
template <int W, int TH, int TW, int HY, int HX, class F>
__device__ __forceinline__ void eval_region(float* __restrict__ dst, int y0,
                                            int x0, int r0, int r1, F f) {
  constexpr int PX = pad4(HX), PW = TW + 2 * PX, RW = TW + 2 * HX;
  constexpr int N = (TH + 2 * HY) * RW;
  for (int i = threadIdx.x; i < N; i += kThreads) {
    const int ly = i / RW - HY;
    const int lx = i % RW - HX;
    const int gy = y0 + ly;
    const int gx = x0 + lx;
    dst[(ly + HY) * PW + lx + PX] =
        (gy >= r0 && gy < r1 && gx >= 0 && gx < W) ? f(ly, lx) : 0.0f;
  }
}

// Columns [lx-R, lx+kVec+R) of tile row `row` of a window with halo
// (HY, HX), R a multiple of 4 (at most PX): dst[j] is column lx - R + j.
template <int TW, int HY, int HX, int R>
__device__ __forceinline__ void window_row(float (&dst)[kVec + 2 * R],
                                           const float* __restrict__ win,
                                           int row, int lx) {
  constexpr int PX = pad4(HX), PW = TW + 2 * PX;
  static_assert(R % 4 == 0 && R <= PX, "window_row reads inside the window");
  const float* p = win + (row + HY) * PW + lx + PX - R;
#pragma unroll
  for (int j = 0; j < (kVec + 2 * R) / 4; ++j) {
    const float4 v = *reinterpret_cast<const float4*>(p + 4 * j);
    dst[4 * j] = v.x;
    dst[4 * j + 1] = v.y;
    dst[4 * j + 2] = v.z;
    dst[4 * j + 3] = v.w;
  }
}

// kVec elements of a row of a group input from device memory; zero past
// the plane (those outputs are never stored).
template <bool VEC, int H, int W>
__device__ __forceinline__ void load4(float (&v)[kVec],
                                      const float* __restrict__ src, int gy,
                                      int gx) {
  const float* p = src + (size_t)gy * W + gx;
  if (VEC && gy < H && gx + 3 < W) {
    const float4 t = ldg4(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      v[e] = (gy < H && gx + e < W) ? __ldg(p + e) : 0.0f;
  }
}

template <bool VEC, int H, int W>
__device__ __forceinline__ void store4(float* __restrict__ dst, int gy,
                                       int gx, const float (&v)[kVec]) {
  if (gy >= H) return;
  float* p = dst + (size_t)gy * W + gx;
  if (VEC && gx + 3 < W) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      if (gx + e < W) p[e] = v[e];
  }
}

// 16 bytes read once by a flat group: L2 evicts them first, so the
// outputs' lines replace consumed inputs rather than other data.
__device__ __forceinline__ float4 ldg4_stream(const float* p) {
  float4 v;
  asm volatile(
      "{\n.reg .b64 pol;\n"
      "createpolicy.fractional.L2::evict_first.b64 pol, 1.0;\n"
      "ld.global.nc.L1::no_allocate.L2::cache_hint.L2::256B.v4.f32 "
      "{%0,%1,%2,%3}, [%4], pol;\n}\n"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
  return v;
}

// Chunk c of the flat plane: elements [kVec c, kVec c + kVec) of the H*W
// plane, zero past its end.
template <bool VEC, int H, int W>
__device__ __forceinline__ void load4_flat(float (&v)[kVec],
                                           const float* __restrict__ src,
                                           int c) {
  const long long i = (long long)kVec * c;
  if (VEC && i + 3 < (long long)H * W) {
    const float4 t = ldg4_stream(src + i);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      v[e] = i + e < (long long)H * W ? __ldg(src + i + e) : 0.0f;
  }
}

template <bool VEC, int H, int W>
__device__ __forceinline__ void store4_flat(float* __restrict__ dst, int c,
                                            const float (&v)[kVec]) {
  const long long i = (long long)kVec * c;
  if (VEC && i + 3 < (long long)H * W) {
    *reinterpret_cast<float4*>(dst + i) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      if (i + e < (long long)H * W) dst[i + e] = v[e];
  }
}

}  // namespace sg
