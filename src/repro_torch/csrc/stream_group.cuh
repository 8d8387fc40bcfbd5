// Fused dataflow group kernel for NVIDIA Hopper (sm_90a): the fixed part.
//
// Replaces the TPU kernel `lower_group_pallas` / `_group_kernel` of
// src/repro/core/fusion.py.  One thread block computes one (TH, TW)
// output tile of a fusion group over an (H, W) plane, in two phases:
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
// A (B, H, W) batch of planes is one launch: gridDim.z = B, and in the
// kernel's batch instance every block first moves each input and output
// pointer to its frame, blockIdx.z * H * W elements on (64-bit), on the
// tiled and the flat route.  One frame launches the instance without it.
//
// A barrier is emitted only before a pass that reads a window written by
// other threads since the last one (the generator tracks it).  Windows
// start PX = HX rounded up to 4 columns left of the tile, so their rows
// start on a chunk of 4 values in device and shared memory: loads and
// stores take whole chunks where the plane's width is a multiple of 4 and
// the pointers are 16-byte aligned (VEC), scalar at the plane's edges
// otherwise.
//
// Every channel keeps its own type T in device and shared memory (float,
// int, bool as one byte, __nv_bfloat16, __half; the reference's outputs
// take their channel's dtype) and computes in C(T): float for the float
// types, else T.  A chunk of kVec values is one access of 4 x sizeof(T)
// bytes: 16 for float and int, 8 for bf16 and f16, 4 for bool.  Windows
// lie in shared memory by decreasing element size, so each starts aligned
// to its chunk.
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

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

#include <type_traits>

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

// Python's (and jnp's) floor division and modulo of floats, as torch
// computes them (div_floor_floating, remainder).
__device__ __forceinline__ float floordiv(float a, float b) {
  if (b == 0.0f) return a / b;
  const float m = fmodf(a, b);
  float d = (a - m) / b;
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) d -= 1.0f;
  if (d == 0.0f) return copysignf(0.0f, a / b);
  float f = floorf(d);
  if (d - f > 0.5f) f += 1.0f;
  return f;
}
__device__ __forceinline__ float mod(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m += b;
  return m;
}

// int32 arithmetic wraps at 32 bits, as torch's and XLA's does.
__device__ __forceinline__ int iadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int isub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int imul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}
__device__ __forceinline__ int ineg(int a) { return (int)(0u - (unsigned)a); }
__device__ __forceinline__ int iabs(int a) { return a < 0 ? ineg(a) : a; }
__device__ __forceinline__ int isign(int a) { return (0 < a) - (a < 0); }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
// Floor division and modulo of ints (C truncates).  A zero divisor gives
// -1 and a (XLA's); INT_MIN // -1 wraps.
__device__ __forceinline__ int floordiv(int a, int b) {
  if (b == 0) return -1;
  if (b == -1) return ineg(a);
  const int q = a / b;
  return (q * b != a && ((a < 0) != (b < 0))) ? q - 1 : q;
}
__device__ __forceinline__ int mod(int a, int b) {
  if (b == 0) return a;
  if (b == -1) return 0;
  const int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

// A float32 result rounded to bf16 / f16 (nearest even), as each op on a
// bf16 or f16 array rounds.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ float round_f16(float v) {
  return __half2float(__float2half(v));
}

// A stored value's compute type C(T), and the conversions between them.
template <class T> struct Compute { using type = T; };
template <> struct Compute<__nv_bfloat16> { using type = float; };
template <> struct Compute<__half> { using type = float; };
template <class T> using compute_t = typename Compute<T>::type;

template <class T>
__device__ __forceinline__ compute_t<T> widen(T v) { return v; }
template <>
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }

template <class T>
__device__ __forceinline__ T narrow(compute_t<T> v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half narrow<__half>(float v) {
  return __float2half(v);
}

template <class T>
__device__ __forceinline__ T zero() { return narrow<T>(compute_t<T>(0)); }

// One value from device memory (read-only path for float).
template <class T>
__device__ __forceinline__ T ldg1(const T* p) {
  if constexpr (std::is_same<T, float>::value) return __ldg(p);
  else return *p;
}

// Read of a split arm whose source is a group input: the arm is masked
// to the valid row band like every stage output, the input is not.
template <class V>
__device__ __forceinline__ V row_masked(V v, int gy, int r0, int r1) {
  return (gy >= r0 && gy < r1) ? v : V(0);
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

// kVec values of T as one access of 4 x sizeof(T) bytes.
struct alignas(8) Bytes8 { unsigned a, b; };
template <class T>
using Chunk = typename std::conditional<
    sizeof(T) == 4, float4,
    typename std::conditional<sizeof(T) == 2, Bytes8, unsigned>::type>::type;

// Chunk p (aligned to its size) of device memory into v, read once.
template <class T>
__device__ __forceinline__ void load_chunk(T (&v)[kVec], const T* p) {
  if constexpr (sizeof(T) == 4) {
    const float4 t = ldg4(reinterpret_cast<const float*>(p));
    memcpy(v, &t, 16);
  } else {
    const Chunk<T> t = *reinterpret_cast<const Chunk<T>*>(p);
    memcpy(v, &t, sizeof(t));
  }
}

// A chunk of shared (or device) memory, plain access.
template <class T>
__device__ __forceinline__ void read_chunk(T (&v)[kVec], const T* p) {
  const Chunk<T> t = *reinterpret_cast<const Chunk<T>*>(p);
  memcpy(v, &t, sizeof(t));
}
template <class T>
__device__ __forceinline__ void write_chunk(T* p, const T (&v)[kVec]) {
  Chunk<T> t;
  memcpy(&t, v, sizeof(t));
  *reinterpret_cast<Chunk<T>*>(p) = t;
}

// Rows [y0-HY, y0+TH+HY) x cols [x0-PX, x0+TW+PX) of src into dst (row
// stride TW+2PX), zero outside the plane; one chunk per step, where it lies
// in the plane (VEC) by cp.async for 4-byte types and a plain copy for the
// narrower ones, by scalar loads otherwise.
template <bool VEC, int H, int W, int TH, int TW, int HY, int HX, class T>
__device__ __forceinline__ void load_window(T* __restrict__ dst,
                                            const T* __restrict__ src,
                                            int y0, int x0) {
  constexpr int PX = pad4(HX), PW = TW + 2 * PX, CH = PW / 4;
  constexpr int N = (TH + 2 * HY) * CH;
  for (int i = threadIdx.x; i < N; i += kThreads) {
    const int r = i / CH, c = (i - r * CH) * 4;
    const int gy = y0 + r - HY, gx = x0 + c - PX;
    T* d = dst + r * PW + c;
    if (VEC && gy >= 0 && gy < H && gx >= 0 && gx + 3 < W) {
      const T* s = src + (size_t)gy * W + gx;
      if constexpr (sizeof(T) == 4) {
        cp_async16(reinterpret_cast<float*>(d),
                   reinterpret_cast<const float*>(s));
      } else {
        T v[kVec];
        read_chunk(v, s);
        write_chunk(d, v);
      }
    } else {
      const bool row = gy >= 0 && gy < H;
      const T* p = src + (long long)gy * W + gx;
      T v[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        v[e] = (row && gx + e >= 0 && gx + e < W) ? ldg1(p + e) : zero<T>();
      write_chunk(d, v);
    }
  }
}

// A stage with halo (HY, HX) over its region, one element per thread and
// step, into its window; f returns the value in C(T).
template <int W, int TH, int TW, int HY, int HX, class T, class F>
__device__ __forceinline__ void eval_region(T* __restrict__ dst, int y0,
                                            int x0, int r0, int r1, F f) {
  constexpr int PX = pad4(HX), PW = TW + 2 * PX, RW = TW + 2 * HX;
  constexpr int N = (TH + 2 * HY) * RW;
  for (int i = threadIdx.x; i < N; i += kThreads) {
    const int ly = i / RW - HY;
    const int lx = i % RW - HX;
    const int gy = y0 + ly;
    const int gx = x0 + lx;
    dst[(ly + HY) * PW + lx + PX] =
        (gy >= r0 && gy < r1 && gx >= 0 && gx < W) ? narrow<T>(f(ly, lx))
                                                   : zero<T>();
  }
}

// Columns [lx-R, lx+kVec+R) of tile row `row` of a window with halo
// (HY, HX), R a multiple of 4 (at most PX): dst[j] is column lx - R + j.
template <int TW, int HY, int HX, int R, class T>
__device__ __forceinline__ void window_row(compute_t<T> (&dst)[kVec + 2 * R],
                                           const T* __restrict__ win,
                                           int row, int lx) {
  constexpr int PX = pad4(HX), PW = TW + 2 * PX;
  static_assert(R % 4 == 0 && R <= PX, "window_row reads inside the window");
  const T* p = win + (row + HY) * PW + lx + PX - R;
#pragma unroll
  for (int j = 0; j < (kVec + 2 * R) / 4; ++j) {
    T v[kVec];
    read_chunk(v, p + 4 * j);
#pragma unroll
    for (int e = 0; e < kVec; ++e) dst[4 * j + e] = widen(v[e]);
  }
}

// kVec elements of a row of a group input from device memory; zero past
// the plane (those outputs are never stored).
template <bool VEC, int H, int W, class T>
__device__ __forceinline__ void load4(compute_t<T> (&v)[kVec],
                                      const T* __restrict__ src, int gy,
                                      int gx) {
  const T* p = src + (size_t)gy * W + gx;
  T t[kVec];
  if (VEC && gy < H && gx + 3 < W) {
    load_chunk(t, p);
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      t[e] = (gy < H && gx + e < W) ? ldg1(p + e) : zero<T>();
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e) v[e] = widen(t[e]);
}

template <bool VEC, int H, int W, class T>
__device__ __forceinline__ void store4(T* __restrict__ dst, int gy, int gx,
                                       const compute_t<T> (&v)[kVec]) {
  if (gy >= H) return;
  T* p = dst + (size_t)gy * W + gx;
  T t[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) t[e] = narrow<T>(v[e]);
  if (VEC && gx + 3 < W) {
    write_chunk(p, t);
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      if (gx + e < W) p[e] = t[e];
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
template <bool VEC, int H, int W, class T>
__device__ __forceinline__ void load4_flat(compute_t<T> (&v)[kVec],
                                           const T* __restrict__ src,
                                           int c) {
  const long long i = (long long)kVec * c;
  T t[kVec];
  if (VEC && i + 3 < (long long)H * W) {
    if constexpr (sizeof(T) == 4) {
      const float4 f = ldg4_stream(reinterpret_cast<const float*>(src + i));
      memcpy(t, &f, 16);
    } else {
      read_chunk(t, src + i);
    }
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      t[e] = i + e < (long long)H * W ? ldg1(src + i + e) : zero<T>();
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e) v[e] = widen(t[e]);
}

template <bool VEC, int H, int W, class T>
__device__ __forceinline__ void store4_flat(T* __restrict__ dst, int c,
                                            const compute_t<T> (&v)[kVec]) {
  const long long i = (long long)kVec * c;
  T t[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) t[e] = narrow<T>(v[e]);
  if (VEC && i + 3 < (long long)H * W) {
    write_chunk(dst + i, t);
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      if (i + e < (long long)H * W) dst[i + e] = t[e];
  }
}

}  // namespace sg
