// Decode (single-token) attention for Hopper, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel decode_attention / _kernel
// (src/repro/kernels/decode_attention.py).  Same function: one query token
// per sequence against an S-long KV cache, an additive (B, S) bias (the
// per-slot length mask of continuous batching), an online softmax over the
// keys, float32 arithmetic, the output in q's type.  As on the TPU, the
// G = Hq / Hkv query heads that share a KV head are handled together, so each
// KV head's cache is read once for all of them.  q and the cache may have
// different types (the serving path has a bfloat16 query against a float32
// cache): each operand is converted to float32 as it is loaded, and nothing
// is cast before the launch.
//
// What bounds it: the bytes of the live cache, read once.  At the serving
// shapes (4 slots x 8 KV heads x 512 positions) that is a few MB, about a
// microsecond of HBM time, so the design is about spreading the read over
// the whole card and keeping many loads in flight:
// - S is split across blocks.  The grid is (batch * KV head, split), with the
//   keys per split chosen at launch (kernels/decode_attention.py:plan) so that
//   the blocks fill at least two waves of the SMs: 32 heads x 16 splits of 32
//   keys = 512 blocks at the serving shapes, where one block per head left 100
//   of 132 SMs idle.
// - A key row is read by LPR lanes with 16-byte loads (a float4 of a float32
//   row, 8 bf16 of a bf16 row); a warp reads 32 / LPR rows at once and every
//   lane keeps NB rows of K and V in flight.  q's G rows, the logits, the
//   running max and sum and the (G, Dv) accumulator live in registers; the
//   logits are reduced across the LPR lanes with shuffles.  No shared-memory
//   tile, no per-element division.
// - Keys that the bias masks (bias <= NEG_INF / 2, or -inf) are not read: in
//   the reference such keys get p = 0 exactly (decode_attention.py:50-51), so
//   skipping them changes nothing.  A moderately negative bias (-1e4) is read.
//   A row whose keys are all masked gives 0, as in the TPU kernel.
// - Each block merges its warps' softmax states in shared memory.  The splits
//   of one head are one thread-block cluster (at most 8 blocks): after a
//   cluster barrier, block 0 reads the others' states from their shared
//   memory (distributed shared memory) and merges them in split order.  No
//   scratch in device memory, no counter, no atomics: the output is the same
//   bits from run to run, and a CUDA graph can replay the launch as it is.
#include <cooperative_groups.h>

#include "lm_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplits = 8;   // a portable cluster: decode_attention.py
constexpr float kSkip = 0.5f * lm::kNegInf;  // a bias at or below: not read

struct Args {
  int B, Hq, Hkv, S, Dk, Dv, G;
  int keys_per_split, splits;
  int vec;  // 1: every K and V row may be read with 16-byte loads
  float scale;
  // element strides: q/o over (batch, head), k/v over (batch, head,
  // position); the last dim is contiguous.  bias is (B, S), row stride
  // bias_b.
  long long qb, qh, kb, kh, ks, vb, vh, vs, ob, oh, bias_b;
};

template <typename T> struct Vec;  // elements in 16 bytes
template <> struct Vec<float> { static constexpr int n = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int n = 8; };

// Elements [d0, d0 + V) of a cache row as float32, zeros from D on.  With
// vec the row's start is 16-byte aligned and D a multiple of V.  The cache
// is read once: the loads stream past L1 and leave L2 early.
__device__ __forceinline__ void load_row(float (&r)[4], const float* row,
                                         int d0, int D, bool vec) {
  if (vec) {
    if (d0 < D) {
      const float4 u = __ldcs(reinterpret_cast<const float4*>(row + d0));
      r[0] = u.x; r[1] = u.y; r[2] = u.z; r[3] = u.w;
    } else {
      r[0] = r[1] = r[2] = r[3] = 0.f;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) r[j] = d0 + j < D ? row[d0 + j] : 0.f;
}

__device__ __forceinline__ void load_row(float (&r)[8],
                                         const __nv_bfloat16* row, int d0,
                                         int D, bool vec) {
  if (vec) {
    if (d0 < D) {
      const uint4 u = __ldcs(reinterpret_cast<const uint4*>(row + d0));
      const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // bf16 -> float32 is a shift, exact
        r[2 * j] = __uint_as_float(w[j] << 16);
        r[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) r[j] = 0.f;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
    r[j] = d0 + j < D ? __bfloat162float(row[d0 + j]) : 0.f;
}

template <typename TQ, typename TKV, int LPR, int GMAX>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                    const TKV* __restrict__ v, const float* __restrict__ bias,
                    TQ* __restrict__ o, const Args a) {
  constexpr int V = Vec<TKV>::n;
  constexpr int RPW = 32 / LPR;          // key rows a warp reads at once
  constexpr int R = kWarps * RPW;        // key rows a block reads at once
  // key rows in flight a lane, as many as the registers hold
  constexpr int NB = GMAX >= 16 ? 2 : (GMAX >= 8 || V == 8) ? 4 : 8;
  constexpr int DMAX = LPR * V;          // the widest row the lanes cover
  __shared__ float sm[kWarps][GMAX], sl[kWarps][GMAX];
  __shared__ float sacc[kWarps][GMAX][DMAX];
  __shared__ float bm[GMAX], bl[GMAX], bacc[GMAX][DMAX];  // the block's
  __shared__ float wgt[kMaxSplits][GMAX], lsp[kMaxSplits][GMAX];
  __shared__ float stot[GMAX];

  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const int sub = lane / LPR, d0 = (lane % LPR) * V;
  const int rg = w * RPW + sub;          // this lane's row of the R
  const int bh = blockIdx.x, split = blockIdx.y;
  const int b = bh / a.Hkv, hk = bh - b * a.Hkv;
  const int G = a.G, Dv = a.Dv;
  const bool vec = a.vec != 0;

  float qr[GMAX][V];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    const TQ* qp = q + b * a.qb + (long long)(hk * G + g) * a.qh;
#pragma unroll
    for (int j = 0; j < V; ++j)
      qr[g][j] = (g < G && d0 + j < a.Dk) ? lm::to_f(qp[d0 + j]) : 0.f;
  }
  float m[GMAX], l[GMAX], acc[GMAX][V];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = lm::kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) acc[g][j] = 0.f;
  }

  const TKV* kp = k + b * a.kb + hk * a.kh;
  const TKV* vp = v + b * a.vb + hk * a.vh;
  const float* bp = bias != nullptr ? bias + b * a.bias_b : nullptr;
  const int k_begin = split * a.keys_per_split;
  const int k_end = min(a.S, k_begin + a.keys_per_split);

  for (int k0 = k_begin; k0 < k_end; k0 += R * NB) {
    // the bias first: a masked key's rows are never loaded
    float bv[NB];
    bool on[NB];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int key = k0 + i * R + rg;
      const bool in = key < k_end;
      bv[i] = in && bp != nullptr ? bp[key] : 0.f;
      on[i] = in && bv[i] > kSkip;
    }
    float kr[NB][V], vr[NB][V];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const long long key = k0 + i * R + rg;
      if (on[i]) {
        load_row(kr[i], kp + key * a.ks, d0, a.Dk, vec);
        load_row(vr[i], vp + key * a.vs, d0, Dv, vec);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) kr[i][j] = vr[i][j] = 0.f;
      }
    }
    // logits: this lane's V products, then a sum over the row's LPR lanes
    float s[NB][GMAX];
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        float x = 0.f;
#pragma unroll
        for (int j = 0; j < V; ++j) x = fmaf(qr[g][j], kr[i][j], x);
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1)
          x += __shfl_xor_sync(0xffffffffu, x, off);
        s[i][g] = on[i] ? x * a.scale + bv[i] : -INFINITY;
      }
    // online softmax over these NB keys, row by row
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      float mx = m[g];
#pragma unroll
      for (int i = 0; i < NB; ++i) mx = fmaxf(mx, s[i][g]);
      const bool live = mx > kSkip;
      const float alpha = expf(m[g] - mx);
      float p[NB], psum = 0.f;
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        p[i] = live ? expf(s[i][g] - mx) : 0.f;
        psum += p[i];
      }
      l[g] = alpha * l[g] + psum;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float x = acc[g][j] * alpha;
#pragma unroll
        for (int i = 0; i < NB; ++i) x = fmaf(p[i], vr[i][j], x);
        acc[g][j] = x;
      }
      m[g] = mx;
    }
  }

  // the warp's RPW row streams into one state (lanes of sub 0 keep it)
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float a0 = expf(m[g] - mn), a1 = expf(mo - mn);
      l[g] = l[g] * a0 + lo * a1;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][j], off);
        acc[g][j] = acc[g][j] * a0 + ao * a1;
      }
      m[g] = mn;
    }
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (d0 == 0) {
        sm[w][g] = m[g];
        sl[w][g] = l[g];
      }
#pragma unroll
      for (int j = 0; j < V; ++j) sacc[w][g][d0 + j] = acc[g][j];
    }
  }
  __syncthreads();

  // the block's warps in order into this split's state
  for (int e = t; e < G * Dv; e += kThreads) {
    const int g = e / Dv, d = e - g * Dv;
    float mx = sm[0][g];
#pragma unroll
    for (int ww = 1; ww < kWarps; ++ww) mx = fmaxf(mx, sm[ww][g]);
    float ls = 0.f, as = 0.f;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww) {
      const float f = expf(sm[ww][g] - mx);
      ls += sl[ww][g] * f;
      as += sacc[ww][g][d] * f;
    }
    bacc[g][d] = as;
    if (d == 0) {
      bm[g] = mx;
      bl[g] = ls;
    }
  }

  // block 0 of the cluster merges every split's state, in split order
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (cluster.block_rank() == 0) {
    for (int e = t; e < a.splits * G; e += kThreads) {
      const int sp = e / G, g = e - sp * G;
      wgt[sp][g] = *cluster.map_shared_rank(&bm[g], sp);
      lsp[sp][g] = *cluster.map_shared_rank(&bl[g], sp);
    }
    __syncthreads();
    if (t < G) {
      float mx = lm::kNegInf;
      for (int sp = 0; sp < a.splits; ++sp) mx = fmaxf(mx, wgt[sp][t]);
      float ls = 0.f;
      for (int sp = 0; sp < a.splits; ++sp) {
        const float f = expf(wgt[sp][t] - mx);
        wgt[sp][t] = f;
        ls += lsp[sp][t] * f;
      }
      stot[t] = fmaxf(ls, 1e-30f);
    }
    __syncthreads();
    for (int e = t; e < G * Dv; e += kThreads) {
      const int g = e / Dv, d = e - g * Dv;
      float x[kMaxSplits];
#pragma unroll
      for (int sp = 0; sp < kMaxSplits; ++sp)
        x[sp] = sp < a.splits ? *cluster.map_shared_rank(&bacc[g][d], sp)
                              : 0.f;
      float as = 0.f;
#pragma unroll
      for (int sp = 0; sp < kMaxSplits; ++sp)
        if (sp < a.splits) as += x[sp] * wgt[sp][g];
      o[b * a.ob + (long long)(hk * G + g) * a.oh + d] =
          lm::from_f<TQ>(as / stot[g]);
    }
  }
  cluster.sync();  // the other blocks' shared memory lives until read
}

template <typename TQ, typename TKV, int LPR, int GMAX>
int launch(const void* q, const void* k, const void* v, const float* bias,
           void* o, const Args& a, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * a.Hkv, a.splits);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = a.splits;  // a head's splits: one cluster
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, decode_split_kernel<TQ, TKV, LPR, GMAX>, (const TQ*)q,
      (const TKV*)k, (const TKV*)v, bias, (TQ*)o, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// lanes per row: the fewest of 8, 16, 32 whose 16-byte loads cover a row
template <typename TQ, typename TKV, int GMAX>
int launch_d(const void* q, const void* k, const void* v, const float* bias,
             void* o, const Args& a, cudaStream_t stream) {
  const int d = a.Dk > a.Dv ? a.Dk : a.Dv;
  if constexpr (Vec<TKV>::n == 8) {  // bf16 rows: 8 a lane
    if (d <= 64)
      return launch<TQ, TKV, 8, GMAX>(q, k, v, bias, o, a, stream);
    if (d <= 128)
      return launch<TQ, TKV, 16, GMAX>(q, k, v, bias, o, a, stream);
  } else {                           // float32 rows: 4 a lane
    if (d <= 64)
      return launch<TQ, TKV, 16, GMAX>(q, k, v, bias, o, a, stream);
    if (d <= 128)
      return launch<TQ, TKV, 32, GMAX>(q, k, v, bias, o, a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename TQ, typename TKV>
int launch_g(const void* q, const void* k, const void* v, const float* bias,
             void* o, const Args& a, cudaStream_t stream) {
  if (a.G == 1)
    return launch_d<TQ, TKV, 1>(q, k, v, bias, o, a, stream);
  if (a.G <= 4)
    return launch_d<TQ, TKV, 4>(q, k, v, bias, o, a, stream);
  if (a.G <= 8)
    return launch_d<TQ, TKV, 8>(q, k, v, bias, o, a, stream);
  if (a.G <= 16)
    return launch_d<TQ, TKV, 16>(q, k, v, bias, o, a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dims: B, Hq, Hkv, S, Dk, Dv, keys_per_split, splits (at most 8), vec.
// strides: qb, qh, kb, kh, ks, vb, vh, vs, ob, oh, bias_b.  bias may be
// null.  Returns a CUDA error code, 0 on success.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* bias,
                                       void* o, int q_dtype, int kv_dtype,
                                       const int* dims,
                                       const long long* strides,
                                       float scale, void* stream) {
  Args a;
  a.B = dims[0]; a.Hq = dims[1]; a.Hkv = dims[2]; a.S = dims[3];
  a.Dk = dims[4]; a.Dv = dims[5];
  a.keys_per_split = dims[6]; a.splits = dims[7]; a.vec = dims[8];
  a.G = a.Hq / a.Hkv;
  a.scale = scale;
  if (a.splits < 1 || a.splits > kMaxSplits || a.keys_per_split < 1 ||
      (long long)a.splits * a.keys_per_split < a.S)
    return (int)cudaErrorInvalidValue;
  long long* s[] = {&a.qb, &a.qh, &a.kb, &a.kh, &a.ks, &a.vb,
                    &a.vh, &a.vs, &a.ob, &a.oh, &a.bias_b};
  for (int i = 0; i < 11; ++i) *s[i] = strides[i];
  const float* bp = (const float*)bias;
  const cudaStream_t st = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  if (q_dtype == lm::kF32 && kv_dtype == lm::kF32)
    return launch_g<float, float>(q, k, v, bp, o, a, st);
  if (q_dtype == lm::kBF16 && kv_dtype == lm::kBF16)
    return launch_g<bf16, bf16>(q, k, v, bp, o, a, st);
  if (q_dtype == lm::kBF16 && kv_dtype == lm::kF32)
    return launch_g<bf16, float>(q, k, v, bp, o, a, st);
  if (q_dtype == lm::kF32 && kv_dtype == lm::kBF16)
    return launch_g<float, bf16>(q, k, v, bp, o, a, st);
  return (int)cudaErrorInvalidValue;
}

LM_ERROR_STRING(decode_attention)
