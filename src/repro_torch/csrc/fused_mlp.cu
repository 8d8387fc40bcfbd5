// Fused RMSNorm -> SwiGLU MLP for Hopper, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel fused_mlp / _kernel (src/repro/kernels/fused_mlp.py).
// Same function: xn = x * rsqrt(mean(x^2) + eps) * w_norm, kept in float32
// as the TPU kernel keeps it; a = silu(xn @ Wg) * (xn @ Wu); out = a @ Wd;
// float32 accumulation, the output in x's type.  The (T, d_ff) activation
// never reaches device memory.
//
// What differs: the TPU grid walks d_ff in order inside each row block,
// carrying the (rows, d) accumulator from step to step.  Here blocks run in
// parallel and carry nothing, and a decode step has only a few rows: walked
// in order, it would run on one block.  So d_ff is split across blocks too.
// Block (row tile, split) walks its share of d_ff in 64-wide steps with its
// (rows, d) float32 accumulator in shared memory and writes it as a partial
// sum; mlp_reduce_kernel then adds the partials of every split in split
// order and casts.  No atomics: the result does not depend on timing.  The
// two launches together are the port of fused_mlp.
//
// What bounds it: the weights' bytes (3 * d * d_ff elements, read once per
// row tile; one row tile at decode) at small T, the float32 arithmetic on
// the CUDA cores (6 * T * d * d_ff flops) at prefill lengths.  This first
// version stages 64 x 64 weight tiles through shared memory with plain
// loads; tensor cores, TMA and a deeper pipeline are later work.
#include "lm_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int BF = 64;  // d_ff columns per step: thread t owns column t % 64
constexpr int DK = 64;  // d rows of Wg / Wu staged at a time

struct Args {
  int T, d, f, steps_per_split;
  float eps;
};

// floats of shared memory for a row tile of BT rows (a multiple of 4)
__host__ __device__ constexpr long long smem_floats(int BT, int d) {
  return (long long)BT * d + BT * DK + 2 * DK * BF + BT * BF + BT;
}

template <typename T, int RT>  // RT rows per thread; BT = 4 * RT rows
__global__ void __launch_bounds__(kThreads)
mlp_partial_kernel(const T* __restrict__ x, const T* __restrict__ wn,
                   const T* __restrict__ wg, const T* __restrict__ wu,
                   const T* __restrict__ wd, float* __restrict__ partial,
                   const Args a) {
  constexpr int BT = 4 * RT;
  extern __shared__ float smem[];
  float* acc = smem;              // [BT][d] this split's out rows
  float* xs = acc + BT * a.d;     // [BT][DK] normalized x chunk
  float* gs = xs + BT * DK;       // [DK][BF] Wg chunk
  float* us = gs + DK * BF;       // [DK][BF] Wu chunk
  float* as = us + DK * BF;       // [BT][BF] silu(g) * u
  float* rstd = as + BT * BF;     // [BT]

  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const int t0 = blockIdx.x * BT, split = blockIdx.y;
  const long long d = a.d, f = a.f;

  // 1. 1 / rms of each row, one warp per row
  for (int r = w; r < BT; r += kThreads / 32) {
    float ss = 0.f;
    if (t0 + r < a.T)
      for (int c = lane; c < a.d; c += 32) {
        const float xv = lm::to_f(x[(t0 + r) * d + c]);
        ss = fmaf(xv, xv, ss);
      }
    ss = lm::warp_sum(ss);
    if (lane == 0) rstd[r] = 1.0f / sqrtf(ss / (float)a.d + a.eps);
  }
  for (int i = t; i < BT * a.d; i += kThreads) acc[i] = 0.f;
  __syncthreads();

  const int c = t % BF, rg = t / BF;  // rows rg * RT .. rg * RT + RT - 1
  const int f_begin = split * a.steps_per_split * BF;
  const int f_end = min(a.f, f_begin + a.steps_per_split * BF);
  for (int f0 = f_begin; f0 < f_end; f0 += BF) {
    // 2. g, u = xn @ Wg[:, f0:f0+BF], xn @ Wu[:, f0:f0+BF]
    float g[RT], u[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) g[i] = u[i] = 0.f;
    for (int d0 = 0; d0 < a.d; d0 += DK) {
      for (int i = t; i < BT * DK; i += kThreads) {
        const int r = i / DK, col = d0 + i % DK;
        xs[i] = (t0 + r < a.T && col < a.d)
            ? lm::to_f(x[(t0 + r) * d + col]) * rstd[r] * lm::to_f(wn[col])
            : 0.f;
      }
#pragma unroll 4
      for (int i = t; i < DK * BF; i += kThreads) {
        const int row = d0 + i / BF, col = f0 + i % BF;
        const bool ok = row < a.d && col < a.f;
        gs[i] = ok ? lm::to_f(wg[row * f + col]) : 0.f;
        us[i] = ok ? lm::to_f(wu[row * f + col]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < DK; ++kk) {
        const float gw = gs[kk * BF + c], uw = us[kk * BF + c];
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const float xv = xs[(rg * RT + i) * DK + kk];
          g[i] = fmaf(xv, gw, g[i]);
          u[i] = fmaf(xv, uw, u[i]);
        }
      }
      __syncthreads();
    }
    // 3. a = silu(g) * u; zero past d_ff, where g = u = 0
#pragma unroll
    for (int i = 0; i < RT; ++i)
      as[(rg * RT + i) * BF + c] = g[i] / (1.0f + expf(-g[i])) * u[i];
    __syncthreads();

    // 4. acc += a @ Wd[f0:f0+BF, :]
    const int nk = min(BF, a.f - f0);
    for (int col = t; col < a.d; col += kThreads) {
      float o[BT];
#pragma unroll
      for (int r = 0; r < BT; ++r) o[r] = acc[r * a.d + col];
#pragma unroll 8
      for (int kk = 0; kk < nk; ++kk) {
        const float wv = lm::to_f(wd[(f0 + kk) * d + col]);
#pragma unroll
        for (int r = 0; r < BT; ++r) o[r] = fmaf(as[r * BF + kk], wv, o[r]);
      }
#pragma unroll
      for (int r = 0; r < BT; ++r) acc[r * a.d + col] = o[r];
    }
    __syncthreads();
  }

  // 5. this split's partial sums: partial[split][row][:]
  for (int i = t; i < BT * a.d; i += kThreads) {
    const int r = i / a.d;
    if (t0 + r < a.T)
      partial[((long long)split * a.T + t0 + r) * d + (i - r * a.d)] = acc[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mlp_reduce_kernel(const float* __restrict__ partial, T* __restrict__ out,
                  long long n, int nsplit) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < nsplit; ++k) s += partial[k * n + i];  // fixed order
  out[i] = lm::from_f<T>(s);
}

template <typename T, int RT>
int launch(const void* x, const void* wn, const void* wg, const void* wu,
           const void* wd, float* partial, void* out, const Args& a,
           int nsplit, cudaStream_t stream) {
  static bool smem_ready = false;
  const long long floats = smem_floats(4 * RT, a.d);
  if (floats * 4 > 232448) return (int)cudaErrorInvalidValue;
  const int smem = (int)(floats * 4);
  const int e = lm::allow_smem(mlp_partial_kernel<T, RT>, 232448,
                               &smem_ready);
  if (e != 0) return e;
  const dim3 grid((a.T + 4 * RT - 1) / (4 * RT), nsplit);
  mlp_partial_kernel<T, RT><<<grid, kThreads, smem, stream>>>(
      (const T*)x, (const T*)wn, (const T*)wg, (const T*)wu, (const T*)wd,
      partial, a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)a.T * a.d;
  mlp_reduce_kernel<T><<<(unsigned)((n + kThreads - 1) / kThreads), kThreads,
                         0, stream>>>(partial, (T*)out, n, nsplit);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rows(int block_t, const void* x, const void* wn, const void* wg,
                const void* wu, const void* wd, float* partial, void* out,
                const Args& a, int nsplit, cudaStream_t stream) {
  switch (block_t) {
    case 4: return launch<T, 1>(x, wn, wg, wu, wd, partial, out, a, nsplit,
                                stream);
    case 8: return launch<T, 2>(x, wn, wg, wu, wd, partial, out, a, nsplit,
                                stream);
    case 16: return launch<T, 4>(x, wn, wg, wu, wd, partial, out, a, nsplit,
                                 stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// plan: block_t (4, 8 or 16 rows), nsplit, steps_per_split (64-wide d_ff
// steps per split).  partial: nsplit * T * d float32 scratch.  Returns a
// CUDA error code, 0 on success.
extern "C" int fused_mlp_launch(const void* x, const void* wn,
                                const void* wg, const void* wu,
                                const void* wd, void* partial, void* out,
                                int dtype, int T, int d, int f, float eps,
                                int block_t, int nsplit,
                                int steps_per_split, void* stream) {
  Args a;
  a.T = T; a.d = d; a.f = f; a.eps = eps;
  a.steps_per_split = steps_per_split;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == lm::kF32)
    return launch_rows<float>(block_t, x, wn, wg, wu, wd, (float*)partial,
                              out, a, nsplit, st);
  if (dtype == lm::kBF16)
    return launch_rows<__nv_bfloat16>(block_t, x, wn, wg, wu, wd,
                                      (float*)partial, out, a, nsplit, st);
  return (int)cudaErrorInvalidValue;
}

LM_ERROR_STRING(fused_mlp)
