// Fused RMSNorm -> SwiGLU MLP for Hopper, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel fused_mlp / _kernel (src/repro/kernels/fused_mlp.py).
// Same function: xn = x * rsqrt(mean(x^2) + eps) * w_norm;
// a = silu(xn @ Wg) * (xn @ Wu); out = a @ Wd; sums in float32, the output
// in x's type.  The (T, d_ff) activation never reaches device memory.
//
// What differs: the TPU grid walks d_ff in order inside each row block,
// carrying the (rows, d) accumulator from step to step.  Here blocks run in
// parallel and carry nothing, and a decode step has only a few rows: walked
// in order, it would run on one block.  So d_ff is split across blocks too:
// block (row tile, split) writes the float32 partial sum of its d_ff slice,
// partial[split][row][:], and mlp_reduce_kernel adds the partials in a fixed
// order and casts.  No atomics: the result does not depend on timing.
//
// Three routes; the wrapper (kernels/fused_mlp.py, `route`) picks one from
// the type, T and the shapes:
//
// fused_mlp_stream_launch -- bf16, T <= 8 (decode).  Bound by the weights'
// bytes (3 * d * d_ff bf16, 100.7 MB for granite: 0.030 ms at 3.35 TB/s);
// the float32 arithmetic (6 T d d_ff) is a fifth of that time at T = 4, so
// it stays on the CUDA cores and xn stays float32.  A block of 8 warps owns
// 64 columns of d_ff (128 blocks for d_ff = 8192, one an SM).  It streams
// Wg / Wu[:, slice] as 16-byte loads in batches of rows, the next batch in
// flight while the FMAs of this one run and no barrier between a load and
// its use; the first batch is issued before the T rows are normalized into
// shared memory (16-byte loads of x).  The 32 row groups' sums meet through
// shuffles and shared memory; a = silu(g) * u goes to shared memory, and
// the block streams its contiguous Wd[slice, :] rows the same way (the
// first batch in flight during the sums), each thread owning 8 output
// columns.  Partials: nsplit * T * d * 4 bytes written and read once (4.2
// MB each way at T = 4, mostly from L2).  Measured (PERF.md): half the
// byte bound at T = 4; clusters of blocks sharing wider Wg / Wu slabs and
// 32-column blocks, two an SM, were slower.
//
// fused_mlp_tc_launch -- bf16 at prefill lengths.  Tensor cores: mma.sync
// m16n8k16 bf16 -> float32 from ldmatrix fragments, as in flash_attention.
// mlp_norm_kernel first writes xn rounded to bf16 (T x d).  A block of 8
// warps takes BT = 64 * MT rows and an FS-wide slice of d_ff.  For each
// 64-wide step of its slice it multiplies xn by the Wg and Wu columns in
// 64-deep tiles, rounds a = silu(g) * u to bf16 into a shared (BT x FS) tile,
// then multiplies that tile by Wd[slice, :] in 128-column chunks and writes
// each chunk's float32 partial.  Every tile (xn, Wg and Wu; then Wd) reaches
// shared memory by 16-byte cp.async copies through one 3-stage ring, so the
// next tiles are in flight while the block multiplies.  Rounding xn and a
// to bf16 are the two rounding points the float32 plain version does not
// have (tests/test_torch_lm_kernels.py emulates them at granite's width).
// What bounds it: at T = 255 the bytes bound is 0.031 ms and the bf16
// operations 0.026 ms; the split's partials (nsplit * T * d * 8 bytes moved)
// and the weights' re-reads per row tile (from L2) set the plan's trade-off
// (kernels/fused_mlp.py, tc_plan).  Measured (PERF.md): 0.22 ms at T = 255,
// stalled between steps (a 4- or 5-stage ring changes nothing) and behind
// its 267 MB of partials; TMA / wgmma and partials added in a cluster's
// distributed shared memory are the next steps.
//
// fused_mlp_launch -- float32 (the f32 checks, zamba2's float32 run), or
// bf16 shapes the other routes refuse (d or d_ff not a multiple of 8, or
// operands not 16-byte aligned).  Float32 FMAs on the CUDA cores: block
// (row tile, split) walks its share of d_ff in 64-wide steps with its
// (rows, d) accumulator in shared memory and 64 x 64 weight tiles staged
// through shared memory with plain loads.
#include <stdint.h>

#include "lm_common.cuh"
#include "tensor_core.cuh"

namespace {

using tcore::bf16;

// TP consecutive floats of shared memory (16-byte aligned when TP % 4 == 0)
template <int TP>
__device__ __forceinline__ void load_tp(const float* p, float (&v)[TP]) {
  if constexpr (TP % 4 == 0) {
#pragma unroll
    for (int q = 0; q < TP / 4; ++q) {
      const float4 f4 = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = f4.x;
      v[4 * q + 1] = f4.y;
      v[4 * q + 2] = f4.z;
      v[4 * q + 3] = f4.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < TP; ++i) v[i] = p[i];
  }
}

// 8 bf16 of a 16-byte word -> float32, exactly
__device__ __forceinline__ void unpack8(const uint4& v, float (&o)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// ---------------------------------------------------------------------------
// the partials' sum, every route
// ---------------------------------------------------------------------------
namespace red {

constexpr int kThreads = 256, kWarps = kThreads / 32;

// out[i] = sum over s of partial[s][i], n = T * d outputs; V consecutive
// outputs a lane (4: float4 loads, when n % 4 == 0), 32 * V a block.  The
// order is fixed: warp w adds splits [w * nsplit / 8, (w + 1) * nsplit / 8)
// in order, then the 8 warps' sums are added in warp order.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
mlp_reduce_kernel(const float* __restrict__ partial, T* __restrict__ out,
                  long long n, int nsplit) {
  __shared__ float sums[kWarps][32 * V];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long i = ((long long)blockIdx.x * 32 + lane) * V;
  const int s0 = w * nsplit / kWarps, s1 = (w + 1) * nsplit / kWarps;
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;
  if (i < n) {
#pragma unroll 4
    for (int s = s0; s < s1; ++s) {
      const float* p = partial + (long long)s * n + i;
      if constexpr (V == 4) {
        const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
        acc[0] += v.x;
        acc[1] += v.y;
        acc[2] += v.z;
        acc[3] += v.w;
      } else {
        acc[0] += __ldcs(p);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) sums[w][lane * V + j] = acc[j];
  __syncthreads();
  if (w == 0 && i < n) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float s = sums[0][lane * V + j];
      for (int k = 1; k < kWarps; ++k) s += sums[k][lane * V + j];
      out[i + j] = lm::from_f<T>(s);
    }
  }
}

template <typename T>
int launch(const float* partial, void* out, long long n, int nsplit,
           cudaStream_t stream) {
  if (n % 4 == 0) {
    mlp_reduce_kernel<T, 4><<<(unsigned)((n + 127) / 128), kThreads, 0,
                              stream>>>(partial, (T*)out, n, nsplit);
  } else {
    mlp_reduce_kernel<T, 1><<<(unsigned)((n + 31) / 32), kThreads, 0,
                              stream>>>(partial, (T*)out, n, nsplit);
  }
  return (int)cudaGetLastError();
}

}  // namespace red

// ---------------------------------------------------------------------------
// float32 route on the CUDA cores (any type, any shape)
// ---------------------------------------------------------------------------
namespace simt {

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

template <typename T, int RT>
int launch(const void* x, const void* wn, const void* wg, const void* wu,
           const void* wd, float* partial, const Args& a, int nsplit,
           cudaStream_t stream) {
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
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rows(int block_t, const void* x, const void* wn, const void* wg,
                const void* wu, const void* wd, float* partial, const Args& a,
                int nsplit, cudaStream_t stream) {
  switch (block_t) {
    case 4: return launch<T, 1>(x, wn, wg, wu, wd, partial, a, nsplit,
                                stream);
    case 8: return launch<T, 2>(x, wn, wg, wu, wd, partial, a, nsplit,
                                stream);
    case 16: return launch<T, 4>(x, wn, wg, wu, wd, partial, a, nsplit,
                                 stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16 decode route: streaming the weights on the CUDA cores
// ---------------------------------------------------------------------------
namespace stream {

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int FS = 64;                          // d_ff columns of a block
constexpr int kChunks = FS / 8;                 // 16-byte chunks of a row
constexpr int kRowGroups = kThreads / kChunks;  // Wg / Wu rows a pass
constexpr int UD = 4;                           // Wd rows a batch

struct Args {
  int T, d, f;
  float eps;
};

// bytes of shared memory for TP padded rows: xn [d][TP], the warps' g and u
// sums [kWarps][TP][2][FS], a [FS][TP]
__host__ __device__ constexpr long long smem_bytes(int TP, int d) {
  return 4LL * ((long long)d * TP + kWarps * TP * 2 * FS + FS * TP);
}

// One batch of Wg and Wu: rows k0 + j * kRowGroups (j < U, k < k_end) at
// column col (8 bf16 a load); zero past the rows or d_ff, without a load.
template <int U>
__device__ __forceinline__ void load_gu(uint4 (&gv)[U], uint4 (&uv)[U],
                                        const bf16* gp, const bf16* up,
                                        int k0, int k_end, bool col_ok,
                                        long long f) {
#pragma unroll
  for (int j = 0; j < U; ++j) {
    const int k = k0 + j * kRowGroups;
    const bool ok = col_ok && k < k_end;
    gv[j] = ok ? __ldcs(reinterpret_cast<const uint4*>(gp + k * f))
               : make_uint4(0u, 0u, 0u, 0u);
    uv[j] = ok ? __ldcs(reinterpret_cast<const uint4*>(up + k * f))
               : make_uint4(0u, 0u, 0u, 0u);
  }
}

// One batch of Wd: UD rows from k0 of the slice at output chunk cc; zero
// when cc is past the row, without a load.
__device__ __forceinline__ void load_d(uint4 (&dv)[UD], const bf16* wd,
                                       long long d, int f0, int cc, int k0,
                                       bool ok) {
#pragma unroll
  for (int j = 0; j < UD; ++j)
    dv[j] = ok ? __ldcs(reinterpret_cast<const uint4*>(
                     wd + (f0 + k0 + j) * d + 8 * cc))
               : make_uint4(0u, 0u, 0u, 0u);
}

template <int TP>  // T <= TP rows, TP in 1, 2, 4, 8
__global__ void __launch_bounds__(kThreads, 1)
mlp_stream_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wn,
                  const bf16* __restrict__ wg, const bf16* __restrict__ wu,
                  const bf16* __restrict__ wd, float* __restrict__ partial,
                  const Args a) {
  constexpr int U = TP <= 2 ? 8 : TP == 4 ? 4 : 2;  // Wg / Wu rows a batch
  constexpr int STEP = U * kRowGroups;
  extern __shared__ __align__(16) float stream_smem[];
  float* xs = stream_smem;                 // [d][TP]
  float* red = xs + a.d * TP;              // [kWarps][TP][2][FS]
  float* as = red + kWarps * TP * 2 * FS;  // [FS][TP]

  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const int split = blockIdx.x, f0 = split * FS;
  const long long d = a.d, f = a.f;
  // thread (c, rg) takes column chunk c of rows rg, rg + 32, ...; a warp's
  // load covers 4 rows x 128 bytes
  const int c = t % kChunks, rg = t / kChunks;
  const int col = f0 + 8 * c;
  const bool col_ok = col < a.f;  // d_ff % 8 == 0: a chunk is in or out
  const bf16* gp = wg + col;
  const bf16* up = wu + col;

  // the first weights are in flight while the rows are normalized
  uint4 gc[U], uc[U], gn[U], un[U];
  load_gu<U>(gc, uc, gp, up, rg, a.d, col_ok, f);

  // 1. xn = x * rstd * w_norm in float32, rows past T zero: 16-byte loads
  // of x into xs, each row's sum of squares (lanes, then warps in order),
  // then the scale in place
  float ss[TP];
#pragma unroll
  for (int i = 0; i < TP; ++i) ss[i] = 0.f;
  for (int cc = t; cc < a.d / 8; cc += kThreads) {
    uint4 xv[TP];
#pragma unroll
    for (int i = 0; i < TP; ++i)
      xv[i] = i < a.T ? __ldg(reinterpret_cast<const uint4*>(x + i * d +
                                                             8 * cc))
                      : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int i = 0; i < TP; ++i) {
      float v[8];
      unpack8(xv[i], v);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        ss[i] = fmaf(v[e], v[e], ss[i]);
        xs[(8 * cc + e) * TP + i] = v[e];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TP; ++i) {
    ss[i] = lm::warp_sum(ss[i]);
    if (lane == 0) red[w * TP + i] = ss[i];
  }
  __syncthreads();
  float rstd[TP];
#pragma unroll
  for (int i = 0; i < TP; ++i) {
    float s = 0.f;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww) s += red[ww * TP + i];
    rstd[i] = 1.0f / sqrtf(s / (float)a.d + a.eps);
  }
  for (int cc = t; cc < a.d / 8; cc += kThreads) {
    float wv[8];
    unpack8(__ldg(reinterpret_cast<const uint4*>(wn + 8 * cc)), wv);
#pragma unroll
    for (int e = 0; e < 8; ++e)
#pragma unroll
      for (int i = 0; i < TP; ++i) {
        float* px = xs + (8 * cc + e) * TP + i;
        *px = i < a.T ? *px * rstd[i] * wv[e] : 0.f;
      }
  }
  __syncthreads();

  // 2. g, u = xn @ Wg / Wu[:, col .. col + 8]: the next batch is in
  // flight while this one's FMAs run
  float g[TP][8], u[TP][8];
#pragma unroll
  for (int i = 0; i < TP; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) g[i][e] = u[i][e] = 0.f;
  for (int k0 = rg; k0 < a.d; k0 += STEP) {
    load_gu<U>(gn, un, gp, up, k0 + STEP, a.d, col_ok, f);
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int k = k0 + j * kRowGroups;
      if (k < a.d) {
        float xv[TP], gw[8], uw[8];
        load_tp<TP>(xs + k * TP, xv);
        unpack8(gc[j], gw);
        unpack8(uc[j], uw);
#pragma unroll
        for (int i = 0; i < TP; ++i)
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            g[i][e] = fmaf(xv[i], gw[e], g[i][e]);
            u[i][e] = fmaf(xv[i], uw[e], u[i][e]);
          }
      }
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      gc[j] = gn[j];
      uc[j] = un[j];
    }
  }

  // the first Wd rows are in flight while g and u are summed: thread t
  // owns output columns 8 cc .. 8 cc + 7, cc = t, t + 256, ...; the
  // slice's rows are contiguous, nk of them (a multiple of 8)
  const int nk = min(FS, a.f - f0), n_cc = a.d / 8;
  uint4 dc[UD], dn[UD];
  load_d(dc, wd, d, f0, t, 0, t < n_cc);

  // the warp's 4 row groups (lanes c, c + 8, c + 16, c + 24), then the 8
  // warps in order
#pragma unroll
  for (int i = 0; i < TP; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      g[i][e] += __shfl_xor_sync(0xffffffffu, g[i][e], 8);
      g[i][e] += __shfl_xor_sync(0xffffffffu, g[i][e], 16);
      u[i][e] += __shfl_xor_sync(0xffffffffu, u[i][e], 8);
      u[i][e] += __shfl_xor_sync(0xffffffffu, u[i][e], 16);
    }
  if (lane < kChunks) {
#pragma unroll
    for (int i = 0; i < TP; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        red[((w * TP + i) * 2) * FS + 8 * lane + e] = g[i][e];
        red[((w * TP + i) * 2 + 1) * FS + 8 * lane + e] = u[i][e];
      }
  }
  __syncthreads();

  // 3. a = silu(g) * u; zero past d_ff, where g = u = 0
  for (int idx = t; idx < TP * FS; idx += kThreads) {
    const int i = idx / FS, cc = idx - i * FS;
    float gs = 0.f, us = 0.f;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww) {
      gs += red[((ww * TP + i) * 2) * FS + cc];
      us += red[((ww * TP + i) * 2 + 1) * FS + cc];
    }
    as[cc * TP + i] = gs / (1.0f + expf(-gs)) * us;
  }
  __syncthreads();

  // 4. partial[split] = a @ Wd[f0:f0+FS, :], batches of UD rows walked
  // over (cc, k0), the next in flight while this one's FMAs run
  float o[TP][8];
#pragma unroll
  for (int i = 0; i < TP; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) o[i][e] = 0.f;
  int cc = t, k0 = 0;
  while (cc < n_cc) {
    const bool last = k0 + UD >= nk;  // the column chunk's last batch
    const int cn = last ? cc + kThreads : cc, kn = last ? 0 : k0 + UD;
    load_d(dn, wd, d, f0, cn, kn, cn < n_cc);
#pragma unroll
    for (int j = 0; j < UD; ++j) {
      float wv[8], av[TP];
      unpack8(dc[j], wv);
      load_tp<TP>(as + (k0 + j) * TP, av);
#pragma unroll
      for (int i = 0; i < TP; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) o[i][e] = fmaf(av[i], wv[e], o[i][e]);
    }
    if (last) {
#pragma unroll
      for (int i = 0; i < TP; ++i) {
        if (i < a.T) {
          float4* pp = reinterpret_cast<float4*>(
              partial + ((long long)split * a.T + i) * d + 8 * cc);
          pp[0] = make_float4(o[i][0], o[i][1], o[i][2], o[i][3]);
          pp[1] = make_float4(o[i][4], o[i][5], o[i][6], o[i][7]);
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) o[i][e] = 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < UD; ++j) dc[j] = dn[j];
    cc = cn;
    k0 = kn;
  }
}

template <int TP>
int launch(const void* x, const void* wn, const void* wg, const void* wu,
           const void* wd, float* partial, const Args& a,
           cudaStream_t stream) {
  static bool smem_ready = false;
  const long long bytes = smem_bytes(TP, a.d);
  if (bytes > 232448) return (int)cudaErrorInvalidValue;
  const int e = lm::allow_smem(mlp_stream_kernel<TP>, 232448, &smem_ready);
  if (e != 0) return e;
  const int nsplit = (a.f + FS - 1) / FS;
  mlp_stream_kernel<TP><<<nsplit, kThreads, (int)bytes, stream>>>(
      (const bf16*)x, (const bf16*)wn, (const bf16*)wg, (const bf16*)wu,
      (const bf16*)wd, partial, a);
  return (int)cudaGetLastError();
}

}  // namespace stream

// ---------------------------------------------------------------------------
// bf16 prefill route on the tensor cores
// ---------------------------------------------------------------------------
namespace tc {

using namespace tcore;

constexpr int kThreads = 256;
constexpr int BK = 64;      // depth of a tile: d for gate/up, d_ff for down
constexpr int BF = 64;      // d_ff columns of a gate/up step
constexpr int BD = 128;     // d columns of a down step
constexpr int STAGES = 3;  // ring slots
// Row strides in shared memory: 8 bf16 (16 bytes) of padding shift each
// row by four banks, so the 8 rows an ldmatrix phase reads hit distinct
// banks.
constexpr int LDK = BK + 8, LDD = BD + 8;

struct Args {
  int T, d, f, fs;  // fs: d_ff columns of a split, a multiple of 64
};

// bf16 elements of one ring slot: a gate/up step's xn (BT x 64), Wg and
// Wu (64 x 64) tiles, or a down step's Wd (64 x 128) tile
template <int MT>
constexpr int kSlot = (64 * MT + 2 * BK) * LDK;
static_assert(BK * LDD <= kSlot<1>, "a Wd tile fits a slot");

__host__ __device__ constexpr long long smem_bytes(int MT, int fs) {
  return 2LL * (STAGES * (long long)(64 * MT + 2 * BK) * LDK +
                64LL * MT * (fs + 8));
}

// xn = bf16(x * rstd * w_norm), one block a row
__global__ void __launch_bounds__(256)
mlp_norm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wn,
                bf16* __restrict__ xn, int d, float eps) {
  __shared__ float part[8];
  __shared__ float rstd;
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const bf16* xr = x + (long long)blockIdx.x * d;
  float ss = 0.f;
  for (int c = t; c < d; c += 256) {
    const float v = __bfloat162float(xr[c]);
    ss = fmaf(v, v, ss);
  }
  ss = lm::warp_sum(ss);
  if (lane == 0) part[w] = ss;
  __syncthreads();
  if (t == 0) {
    float s = 0.f;
    for (int i = 0; i < 8; ++i) s += part[i];
    rstd = 1.0f / sqrtf(s / (float)d + eps);
  }
  __syncthreads();
  bf16* out = xn + (long long)blockIdx.x * d;
  for (int c = t; c < d; c += 256)
    out[c] = __float2bfloat16(__bfloat162float(xr[c]) * rstd *
                              __bfloat162float(wn[c]));
}

// The block's steps, in the order it consumes them: n_a gate/up steps
// (64-wide d_ff step j, 64-deep d chunk kc), then n_b down steps (128-wide
// d chunk dc, 64-deep d_ff chunk kk).  issue() starts the copies of one
// step into a ring slot; masked chunks are zero-filled.
struct Plan {
  int r0, f0, KD, KF, n_a, n;
};

template <int MT>
__device__ __forceinline__ void issue(int s, bf16* slot, const Plan& p,
                                      const Args& a, const bf16* xn,
                                      const bf16* wg, const bf16* wu,
                                      const bf16* wd) {
  constexpr int BT = 64 * MT;
  if (s < p.n_a) {
    const int j = s / p.KD, kc = s - j * p.KD;
    const int k0 = kc * BK, fc = p.f0 + j * BF;
    // rows of the slot: BT of xn, then 64 of Wg, then 64 of Wu; 8 chunks
    // of 16 bytes a row
    for (int i = threadIdx.x; i < (BT + 2 * BK) * 8; i += kThreads) {
      const int r = i >> 3, ch = (i & 7) * 8;
      const bf16* src;
      bool valid;
      if (r < BT) {
        const int row = p.r0 + r, col = k0 + ch;
        valid = row < a.T && col < a.d;
        src = xn + (long long)row * a.d + col;
      } else {
        const int rr = r < BT + BK ? r - BT : r - BT - BK;
        const int row = k0 + rr, col = fc + ch;
        valid = row < a.d && col < a.f;
        src = (r < BT + BK ? wg : wu) + (long long)row * a.f + col;
      }
      cp_async16(slot + r * LDK + ch, valid ? src : xn, valid);
    }
  } else {
    const int s2 = s - p.n_a, dc = s2 / p.KF, kk = s2 - dc * p.KF;
    const int fr = p.f0 + kk * BK, dcol = dc * BD;
    for (int i = threadIdx.x; i < BK * (BD / 8); i += kThreads) {
      const int r = i >> 4, ch = (i & 15) * 8;
      const int row = fr + r, col = dcol + ch;
      const bool valid = row < a.f && col < a.d;
      cp_async16(slot + r * LDD + ch,
                 valid ? wd + (long long)row * a.d + col : wd, valid);
    }
  }
}

// Block (row tile, split): rows [64 MT x, +64 MT), d_ff [fs y, +fs).
// Warp w computes rows 16 (w % 4) + 64 m (m < MT): at a gate/up step the
// 32 columns 32 (w / 4) of g and u, at a down step the 64 columns
// 64 (w / 4) of the 128-column chunk.
template <int MT>
__global__ void __launch_bounds__(kThreads, MT == 1 ? 2 : 1)
mlp_tc_kernel(const bf16* __restrict__ xn, const bf16* __restrict__ wg,
              const bf16* __restrict__ wu, const bf16* __restrict__ wd,
              float* __restrict__ partial, const Args a) {
  constexpr int BT = 64 * MT;
  constexpr int SLOT = kSlot<MT>;
  const int LDA = a.fs + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // [STAGES][SLOT]
  bf16* as = ring + STAGES * SLOT;                 // [BT][fs + 8]

  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = 16 * (w & 3), wc = w >> 2;
  const int g = lane >> 2, t4 = lane & 3;
  Plan p;
  p.r0 = blockIdx.x * BT;
  p.f0 = blockIdx.y * a.fs;
  p.KD = (a.d + BK - 1) / BK;
  p.KF = a.fs / BK;
  p.n_a = (a.fs / BF) * p.KD;
  p.n = p.n_a + ((a.d + BD - 1) / BD) * p.KF;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < p.n) issue<MT>(s, ring + s * SLOT, p, a, xn, wg, wu, wd);
    cp_async_commit();
  }

  // gate/up steps: g, u in float32 fragments; at a step's last d chunk
  // a = silu(g) * u, rounded to bf16, goes to the shared tile
  float gacc[MT][4][4], uacc[MT][4][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) gacc[m][n][e] = uacc[m][n][e] = 0.f;
  for (int s = 0; s < p.n_a; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step s has landed; every warp is done with s - 1
    const int nx = s + STAGES - 1;
    if (nx < p.n)
      issue<MT>(nx, ring + (nx % STAGES) * SLOT, p, a, xn, wg, wu, wd);
    cp_async_commit();
    const bf16* xt = ring + (s % STAGES) * SLOT;
    const bf16* gt = xt + BT * LDK;
    const bf16* ut = gt + BK * LDK;
#pragma unroll
    for (int k16 = 0; k16 < BK / 16; ++k16) {
      uint32_t bg[2][4], bu[2][4];
#pragma unroll
      for (int n2 = 0; n2 < 2; ++n2) {
        const int off = (k16 * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDK +
                        32 * wc + n2 * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(bg[n2], gt + off);
        ldmatrix_x4_trans(bu[n2], ut + off);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        uint32_t af[4];
        ldmatrix_x4(af, xt + (64 * m + wr + (lane & 15)) * LDK + k16 * 16 +
                            (lane >> 4) * 8);
#pragma unroll
        for (int n2 = 0; n2 < 2; ++n2) {
          mma16816(gacc[m][2 * n2], af, bg[n2][0], bg[n2][1]);
          mma16816(gacc[m][2 * n2 + 1], af, bg[n2][2], bg[n2][3]);
          mma16816(uacc[m][2 * n2], af, bu[n2][0], bu[n2][1]);
          mma16816(uacc[m][2 * n2 + 1], af, bu[n2][2], bu[n2][3]);
        }
      }
    }
    const int j = s / p.KD;
    if (s - j * p.KD == p.KD - 1) {  // the step's last d chunk
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int col = j * BF + 32 * wc + n * 8 + 2 * t4;
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // rows g and g + 8
            float av[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float gv = gacc[m][n][2 * h + e];
              av[e] = gv / (1.0f + expf(-gv)) * uacc[m][n][2 * h + e];
              gacc[m][n][2 * h + e] = uacc[m][n][2 * h + e] = 0.f;
            }
            *reinterpret_cast<__nv_bfloat162*>(
                as + (64 * m + wr + g + 8 * h) * LDA + col) =
                __floats2bfloat162_rn(av[0], av[1]);
          }
        }
    }
  }

  // down steps: each 128-column chunk of partial = a @ Wd[slice, chunk]
  float dacc[MT][8][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dacc[m][n][e] = 0.f;
  for (int s = p.n_a; s < p.n; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // the a tile is complete at the first down step
    const int nx = s + STAGES - 1;
    if (nx < p.n)
      issue<MT>(nx, ring + (nx % STAGES) * SLOT, p, a, xn, wg, wu, wd);
    cp_async_commit();
    const bf16* dt = ring + (s % STAGES) * SLOT;
    const int s2 = s - p.n_a, dc = s2 / p.KF, kk = s2 - dc * p.KF;
#pragma unroll
    for (int k16 = 0; k16 < BK / 16; ++k16) {
      uint32_t af[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
        ldmatrix_x4(af[m], as + (64 * m + wr + (lane & 15)) * LDA + kk * BK +
                               k16 * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, dt + (k16 * 16 + (lane & 7) +
                                   ((lane >> 3) & 1) * 8) * LDD +
                                 64 * wc + n2 * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma16816(dacc[m][2 * n2], af[m], b[0], b[1]);
          mma16816(dacc[m][2 * n2 + 1], af[m], b[2], b[3]);
        }
      }
    }
    if (kk == p.KF - 1) {  // the chunk's last d_ff chunk: write, restart
      float* pp = partial + (long long)blockIdx.y * a.T * a.d;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int col = dc * BD + 64 * wc + n * 8 + 2 * t4;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = p.r0 + 64 * m + wr + g + 8 * h;
            if (row < a.T && col < a.d)
              *reinterpret_cast<float2*>(pp + (long long)row * a.d + col) =
                  make_float2(dacc[m][n][2 * h], dacc[m][n][2 * h + 1]);
            dacc[m][n][2 * h] = dacc[m][n][2 * h + 1] = 0.f;
          }
        }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block
}

template <int MT>
int launch(const void* xn, const void* wg, const void* wu, const void* wd,
           float* partial, const Args& a, cudaStream_t stream) {
  static bool smem_ready = false;
  const long long bytes = smem_bytes(MT, a.fs);
  if (bytes > 232448) return (int)cudaErrorInvalidValue;
  const int e = lm::allow_smem(mlp_tc_kernel<MT>, 232448, &smem_ready);
  if (e != 0) return e;
  const dim3 grid((a.T + 64 * MT - 1) / (64 * MT),
                  (a.f + a.fs - 1) / a.fs);
  mlp_tc_kernel<MT><<<grid, kThreads, (int)bytes, stream>>>(
      (const bf16*)xn, (const bf16*)wg, (const bf16*)wu, (const bf16*)wd,
      partial, a);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// The CUDA-core route.  plan: block_t (4, 8 or 16 rows), nsplit,
// steps_per_split (64-wide d_ff steps per split).  partial: nsplit * T * d
// float32 scratch.  Returns a CUDA error code, 0 on success.
extern "C" int fused_mlp_launch(const void* x, const void* wn,
                                const void* wg, const void* wu,
                                const void* wd, void* partial, void* out,
                                int dtype, int T, int d, int f, float eps,
                                int block_t, int nsplit,
                                int steps_per_split, void* stream) {
  simt::Args a;
  a.T = T; a.d = d; a.f = f; a.eps = eps;
  a.steps_per_split = steps_per_split;
  const cudaStream_t st = (cudaStream_t)stream;
  float* pp = (float*)partial;
  const long long n = (long long)T * d;
  int e;
  if (dtype == lm::kF32) {
    e = simt::launch_rows<float>(block_t, x, wn, wg, wu, wd, pp, a, nsplit,
                                 st);
    return e != 0 ? e : red::launch<float>(pp, out, n, nsplit, st);
  }
  if (dtype == lm::kBF16) {
    e = simt::launch_rows<bf16>(block_t, x, wn, wg, wu, wd, pp, a, nsplit,
                                st);
    return e != 0 ? e : red::launch<bf16>(pp, out, n, nsplit, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The decode route: bf16, T <= 8, d and d_ff multiples of 8, every pointer
// 16-byte aligned (the wrapper checks).  partial: ceil(f / 64) * T * d
// float32 scratch.
extern "C" int fused_mlp_stream_launch(const void* x, const void* wn,
                                       const void* wg, const void* wu,
                                       const void* wd, void* partial,
                                       void* out, int T, int d, int f,
                                       float eps, void* stream) {
  if (T < 1 || T > 8 || d % 8 || f % 8) return (int)cudaErrorInvalidValue;
  stream::Args a;
  a.T = T; a.d = d; a.f = f; a.eps = eps;
  const cudaStream_t st = (cudaStream_t)stream;
  float* pp = (float*)partial;
  int e;
  if (T == 1) e = stream::launch<1>(x, wn, wg, wu, wd, pp, a, st);
  else if (T == 2) e = stream::launch<2>(x, wn, wg, wu, wd, pp, a, st);
  else if (T <= 4) e = stream::launch<4>(x, wn, wg, wu, wd, pp, a, st);
  else e = stream::launch<8>(x, wn, wg, wu, wd, pp, a, st);
  if (e != 0) return e;
  return red::launch<bf16>(pp, out, (long long)T * d,
                           (f + stream::FS - 1) / stream::FS, st);
}

// The tensor-core route: bf16, d and d_ff multiples of 8, every pointer
// 16-byte aligned.  mt: 64 * mt rows a block (1 or 2); fs: d_ff columns a
// split, a multiple of 64.  xn: T * d bf16 scratch; partial:
// ceil(f / fs) * T * d float32 scratch.
extern "C" int fused_mlp_tc_launch(const void* x, const void* wn,
                                   const void* wg, const void* wu,
                                   const void* wd, void* xn, void* partial,
                                   void* out, int T, int d, int f, float eps,
                                   int mt, int fs, void* stream) {
  if (T < 1 || d % 8 || f % 8 || fs < 64 || fs % 64)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  tc::mlp_norm_kernel<<<T, 256, 0, st>>>((const bf16*)x, (const bf16*)wn,
                                          (bf16*)xn, d, eps);
  int e = (int)cudaGetLastError();
  if (e != 0) return e;
  tc::Args a;
  a.T = T; a.d = d; a.f = f; a.fs = fs;
  float* pp = (float*)partial;
  if (mt == 1) e = tc::launch<1>(xn, wg, wu, wd, pp, a, st);
  else if (mt == 2) e = tc::launch<2>(xn, wg, wu, wd, pp, a, st);
  else return (int)cudaErrorInvalidValue;
  if (e != 0) return e;
  return red::launch<bf16>(pp, out, (long long)T * d, (f + fs - 1) / fs, st);
}

LM_ERROR_STRING(fused_mlp)
