// SwiGLU's backward for the fused MLP's bf16 training route: one pass.
//
// Not a port of a TPU kernel: the JAX package has no backward kernel (its
// jax.grad differentiates the plain version and leaves the products to
// XLA).  kernels/fused_mlp_backward.py runs the MLP's backward products on
// the tensor cores (torch.mm, bf16 operands, float32 sums and results).
// Between them sits the elementwise SwiGLU backward: given the float32 gate
// and up products g = hb Wg, u = hb Wu and the activation's gradient
// da = dy Wd^T, all (T, f), swiglu_backward_kernel writes in bf16
//   ab = silu(g) * u                        (the forward's a, for dWd)
//   dg = da * u * s * (1 + g * (1 - s))     (s = sigmoid(g))
//   du = da * silu(g)
// with every operation in float32, in the order of PyTorch's silu and
// silu_backward (silu(g) = g / (1 + exp(-g)); exp(-g) is taken once for
// both).  As separate PyTorch operations these would pass the (T, f)
// intermediates through device memory about eight times; here each input
// is read once and each output written once.
//
// What bounds it: bytes, 12 read and 6 written an element, 0.60 GB at
// granite's training shape (T = 4096, f = 8192): 0.18 ms at 3.35 TB/s.  A
// thread takes four neighbouring elements with 16-byte loads and 8-byte
// stores, in a grid-stride loop over one wave of blocks; the scalar
// instance takes the last n % 4 elements, and every element where a
// pointer is not aligned for the wide copies.  Any n.
#include <stdint.h>

#include "lm_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;      // 2048 threads an SM: one wave

struct alignas(8) Bf16x4 {
  __nv_bfloat162 lo, hi;
};

__device__ __forceinline__ void swiglu_grad(float g, float u, float da,
                                            float& ab, float& dg,
                                            float& du) {
  const float e = expf(-g);
  const float silu = g / (1.0f + e);
  const float s = 1.0f / (1.0f + e);
  ab = silu * u;
  dg = da * u * s * (1.0f + g * (1.0f - s));
  du = da * silu;
}

__device__ __forceinline__ Bf16x4 pack4(const float (&v)[4]) {
  Bf16x4 p;
  p.lo = __floats2bfloat162_rn(v[0], v[1]);
  p.hi = __floats2bfloat162_rn(v[2], v[3]);
  return p;
}

// kVec: element groups [0, n / 4), four a thread a step; else elements
// [begin, n), one a thread a step.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
swiglu_backward_kernel(const float* __restrict__ g,
                       const float* __restrict__ u,
                       const float* __restrict__ da, bf16* __restrict__ ab,
                       bf16* __restrict__ dg, bf16* __restrict__ du,
                       long long begin, long long n) {
  const long long stride = (long long)gridDim.x * kThreads;
  long long i = begin + (long long)blockIdx.x * kThreads + threadIdx.x;
  if constexpr (kVec) {
    for (; i < n / 4; i += stride) {
      const float4 gv = reinterpret_cast<const float4*>(g)[i];
      const float4 uv = reinterpret_cast<const float4*>(u)[i];
      const float4 dv = reinterpret_cast<const float4*>(da)[i];
      const float gs[4] = {gv.x, gv.y, gv.z, gv.w};
      const float us[4] = {uv.x, uv.y, uv.z, uv.w};
      const float ds[4] = {dv.x, dv.y, dv.z, dv.w};
      float a[4], p[4], q[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) swiglu_grad(gs[k], us[k], ds[k], a[k], p[k],
                                              q[k]);
      reinterpret_cast<Bf16x4*>(ab)[i] = pack4(a);
      reinterpret_cast<Bf16x4*>(dg)[i] = pack4(p);
      reinterpret_cast<Bf16x4*>(du)[i] = pack4(q);
    }
  } else {
    for (; i < n; i += stride) {
      float a, p, q;
      swiglu_grad(g[i], u[i], da[i], a, p, q);
      ab[i] = __float2bfloat16(a);
      dg[i] = __float2bfloat16(p);
      du[i] = __float2bfloat16(q);
    }
  }
}

inline int blocks_for(long long work, int n_sm) {
  const long long want = (work + kThreads - 1) / kThreads;
  const long long wave = (long long)n_sm * kBlocksPerSm;
  return (int)(want < wave ? want : wave);
}

}  // namespace

// g, u, da: n float32 each; ab, dg, du: n bf16 each, written.  n_sm: the
// card's multiprocessors (the grid is one wave).  Returns the CUDA error.
extern "C" int fused_mlp_backward_swiglu(const void* g, const void* u,
                                         const void* da, void* ab, void* dg,
                                         void* du, long long n, int n_sm,
                                         void* stream) {
  if (n < 0 || n_sm < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const float *gp = (const float*)g, *up = (const float*)u,
              *dp = (const float*)da;
  bf16 *ap = (bf16*)ab, *gq = (bf16*)dg, *uq = (bf16*)du;
  const bool wide =
      (((uintptr_t)g | (uintptr_t)u | (uintptr_t)da) % 16 == 0) &&
      (((uintptr_t)ab | (uintptr_t)dg | (uintptr_t)du) % 8 == 0);
  long long done = 0;
  if (wide && n >= 4) {
    swiglu_backward_kernel<true><<<blocks_for(n / 4, n_sm), kThreads, 0, st>>>(
        gp, up, dp, ap, gq, uq, 0, n);
    const int e = (int)cudaGetLastError();
    if (e != 0) return e;
    done = n / 4 * 4;
  }
  if (done < n) {
    swiglu_backward_kernel<false>
        <<<blocks_for(n - done, n_sm), kThreads, 0, st>>>(gp, up, dp, ap, gq,
                                                           uq, done, n);
    return (int)cudaGetLastError();
  }
  return 0;
}

LM_ERROR_STRING(fused_mlp_backward)
