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
// MLA's latent cache (one KV head for 40 query heads, Dk 288, Dv 256) takes
// the latent instance further down (namespace mla).
#include <cooperative_groups.h>

#include "lm_common.cuh"
#include "tensor_core.cuh"

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

// ---------------------------------------------------------------------------
// The latent instance: MLA's absorbed decode, MQA over the latent cache.
//
// One KV head (Hkv = 1) serves G query heads (minicpm3-4b: G = 40, Dk 288,
// Dv 256; deepseek-v2-lite: G = 16, Dk 576, Dv 512), with keys of Dk =
// kv_lora_rank + rope_head_dim and values of Dv = kv_lora_rank; the TPU
// kernel takes Dv != Dk for this case
// (decode_attention.py:71-75).  The split instance above keeps the (G, Dv)
// accumulator in registers per lane group, which does not scale to 40 x 256.
// Here:
// - a block is one (slot, split).  Its G query rows, padded to GP = 16 x MT,
//   sit in shared memory as float32 (48 x 288 for minicpm3);
// - the split's keys go through shared memory 32 rows at a time, each live
//   row loaded once, 16 bytes a load, a thread's loads all issued before
//   its stores.  When v is the first Dv columns of the same rows (the
//   serving path's cache holds [c_kv ; k_rope] in one row, and v is c_kv),
//   the V rows are not loaded again: the cache is read once per slot for
//   all G heads, which is the point of MLA;
// - both products run on the tensor cores, m16n8k8 TF32 in three passes
//   (3xTF32: hi x hi + hi x lo + lo x hi, about float32's accuracy; an
//   operand that is exact in TF32, a bf16 query or cache, skips its lo
//   pass): the logits (GP x 32) = Q K^T as 2 x MT tiles of 16 x 16, each
//   tile's depth split over KG = 8 / (2 MT) warps (4 at G <= 16, so all
//   8 warps work at Dk 576) whose partial sums the softmax adds in warp
//   order; P V (GP x Dv) with warp w owning columns 8 NC w .. of every
//   head (NC = 4, or 8 past Dv 256 where G <= 32), its accumulator in mma
//   fragments;
// - between them the online softmax of each head runs across the lanes of
//   one warp (lane = key; shuffles), in place in shared memory;
// - masked keys (bias <= NEG_INF / 2) are not read: their rows are zero in
//   shared memory and their p is 0; a tile with no live key is skipped; a
//   row whose keys are all masked gives 0;
// - the splits of a slot are one thread-block cluster (at most 16, a
//   non-portable size the instance opts into: 4 slots x 16 splits of one
//   32-key tile at 512 positions).  After a cluster barrier, block r merges
//   the heads h = r, r + splits, ... from every split's shared memory, in
//   split order: no scratch, no atomics, the same bits on every replay.
// What bounds it: at the served shapes the live latent rows are a few MB,
// about a microsecond of HBM time; the products are 2 G (Dk + Dv) operations
// a key.
namespace mla {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;       // keys a step: one per lane in the softmax
constexpr int kMaxSplits = 16;  // a cluster of 16: non-portable, opted in
constexpr int kMaxDk = 576, kMaxDv = kWarps * 64;
constexpr int kMaxRow = kMaxDk + 4;  // the widest shared-memory row
constexpr int kPS = kTile + 4;       // a logits / p row (4 mod 32 words)

// warps that split one logits tile's depth: 8 / (2 MT), at least 1
template <int MT>
constexpr int kKG = kWarps / (2 * MT) > 0 ? kWarps / (2 * MT) : 1;

struct Args {
  int B, G, S, Dk, Dv, keys_per_split, splits;
  int vec;     // K and V rows may be read with 16-byte loads
  int q_vec;   // so may q's rows
  int v_in_k;  // v is k[..., :Dv]: the V rows are the K rows
  int ks;      // shared-memory row of q and K, in floats: Dk rounded up to
               // 8, 4 mod 32 (a fragment load free of bank conflicts)
  float scale;
  long long qb, qh, kb, kpos, vb, vpos, ob, oh, bias_b;
};

// ``rows`` rows of D elements (row r at src + r * stride) into shared memory
// (row r at dst + r * ds) as float32, zeros from D to Dpad; a row with bit r
// of ``live`` clear is zeros, and is not read.  With ``vec`` each thread
// issues 16-byte loads for up to 32 floats before it stores any, so a tile
// costs about one memory latency, not one per load; D must then be a
// multiple of Vec<T>::n.  Without, element by element.
template <typename T>
__device__ __forceinline__ void rows_to_smem(float* dst, int ds, const T* src,
                                             long long stride, int rows,
                                             int D, int Dpad,
                                             unsigned long long live,
                                             bool vec, int t) {
  if (vec) {
    constexpr int V = Vec<T>::n, kBatch = 32 / V;  // 32 floats in flight
    const int per = D / V, total = rows * per;
    for (int base = 0; base < total; base += kBatch * kThreads) {
      float r[kBatch][V];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int u = base + i * kThreads + t;
        const int row = u / per;
        if (u < total && ((live >> row) & 1ull))
          load_row(r[i], src + row * stride, (u - row * per) * V, D, true);
        else
#pragma unroll
          for (int j = 0; j < V; ++j) r[i][j] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int u = base + i * kThreads + t;
        if (u >= total) break;
        const int row = u / per;
        float* out = dst + row * ds + (u - row * per) * V;
#pragma unroll
        for (int j = 0; j < V; j += 4)
          *reinterpret_cast<float4*>(out + j) =
              make_float4(r[i][j], r[i][j + 1], r[i][j + 2], r[i][j + 3]);
      }
    }
    const int pad = Dpad - D;
    for (int e = t; e < rows * pad; e += kThreads)
      dst[(e / pad) * ds + D + e % pad] = 0.f;
    return;
  }
#pragma unroll 4
  for (int e = t; e < rows * Dpad; e += kThreads) {
    const int row = e / Dpad, d = e - row * Dpad;
    dst[row * ds + d] = d < D && ((live >> row) & 1ull)
                            ? lm::to_f(src[row * stride + d]) : 0.f;
  }
}

template <typename T>
constexpr bool kExact = sizeof(T) == 2;  // bf16 values are TF32 values

template <typename TQ, typename TKV, int MT, int NC>
__global__ void __launch_bounds__(kThreads)
mla_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                  const TKV* __restrict__ v, const float* __restrict__ bias,
                  TQ* __restrict__ o, const Args a) {
  constexpr int GP = 16 * MT;        // heads, padded to the mma's rows
  constexpr int HPW = GP / kWarps;   // heads a warp in the softmax
  constexpr int KG = kKG<MT>;        // warps a logits tile's depth takes
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  __shared__ float salpha[GP], bm[GP], bl[GP];

  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const int g = lane >> 2, tg = lane & 3;   // an mma fragment's row, column
  const int b = blockIdx.x;
  const int KS = a.ks, Dk8 = (a.Dk + 7) & ~7, Dv = a.Dv;
  const bool vec = a.vec != 0, v_in_k = a.v_in_k != 0;
  const int VS = v_in_k ? KS : Dv + 8;                 // 8 mod 32 words
  float* const qs = smem;                              // GP x KS
  float* const kt = qs + GP * KS;                      // kTile x KS
  float* const vt = kt + kTile * KS;                   // kTile x VS
  float* const ps = vt + (v_in_k ? 0 : kTile * VS);    // KG x GP x kPS
  const float* const vrows = v_in_k ? kt : vt;

  rows_to_smem(qs, KS, q + b * a.qb, a.qh, GP, a.Dk, Dk8,
               a.G >= 64 ? ~0ull : (1ull << a.G) - 1, a.q_vec != 0, t);
  float m[HPW], l[HPW];             // heads w + 8 j, in every lane
#pragma unroll
  for (int j = 0; j < HPW; ++j) {
    m[j] = lm::kNegInf;
    l[j] = 0.f;
  }
  // P V: warp w's columns 8 (NC w + n) of the heads 16 mt + g (+ 8)
  const int n0 = 8 * NC * w;
  const int nt = n0 < Dv ? min(NC, (Dv - n0) / 8) : 0;
  float acc[MT][NC][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < NC; ++n)
      acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.f;

  const TKV* kp = k + b * a.kb;
  const TKV* vp = v + b * a.vb;
  const float* bp = bias != nullptr ? bias + b * a.bias_b : nullptr;
  const int k_begin = blockIdx.y * a.keys_per_split;
  const int k_end = min(a.S, k_begin + a.keys_per_split);

  for (int k0 = k_begin; k0 < k_end; k0 += kTile) {
    // this lane's key: the bias first, a masked key's row is never loaded
    const int key = k0 + lane;
    const float bv = key < k_end && bp != nullptr ? bp[key] : 0.f;
    const bool on = key < k_end && bv > kSkip;
    const unsigned live = __ballot_sync(0xffffffffu, on);  // the same in
    // every warp; the barrier also ends the last tile's reads of kt, vt, ps
    if (!__syncthreads_or(on)) continue;
    // masked rows are zeros: p = 0 must not meet a NaN
    rows_to_smem(kt, KS, kp + (long long)k0 * a.kpos, a.kpos, kTile, a.Dk,
                 Dk8, live, vec, t);
    if (!v_in_k)
      rows_to_smem(vt, VS, vp + (long long)k0 * a.vpos, a.vpos, kTile, Dv,
                   Dv, live, vec, t);
    __syncthreads();

    // logits: tile w % 2 MT (heads 16 (tile / 2) .., keys 16 (tile % 2)
    // ..) over depth slice w / 2 MT of KG, into partial plane w / 2 MT
    if (w < 2 * MT * KG) {
      const int tile = w % (2 * MT), kg = w / (2 * MT);
      const int m0 = 16 * (tile >> 1), c0 = 16 * (tile & 1);
      const int per = 8 * ((Dk8 / 8 + KG - 1) / KG);
      const int kb = kg * per, kn = min(Dk8 - kb, per);
      float s[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      if (kn > 0)
        tcore::warp_mma<2, kExact<TQ>, kExact<TKV>, false, false>(
            s, qs + kb, KS, m0, kt + kb, KS, c0, 2, kn);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float* r0 = ps + kg * GP * kPS + (m0 + g) * kPS + c0 + 8 * n + 2 * tg;
        r0[0] = s[n][0];
        r0[1] = s[n][1];
        r0[8 * kPS] = s[n][2];
        r0[8 * kPS + 1] = s[n][3];
      }
    }
    __syncthreads();
    // each head's online softmax across its warp's lanes, p in place
#pragma unroll
    for (int j = 0; j < HPW; ++j) {
      const int h = w + kWarps * j;
      float raw = ps[h * kPS + lane];
#pragma unroll
      for (int kg = 1; kg < KG; ++kg) raw += ps[kg * GP * kPS + h * kPS + lane];
      const float sv = on ? raw * a.scale + bv : -INFINITY;
      const float mn = fmaxf(m[j], lm::warp_max(sv));
      const bool alive = mn > kSkip;
      const float p = alive ? expf(sv - mn) : 0.f;
      const float alpha = expf(m[j] - mn);
      l[j] = alpha * l[j] + lm::warp_sum(p);
      m[j] = mn;
      ps[h * kPS + lane] = p;
      if (lane == 0) salpha[h] = alpha;
    }
    __syncthreads();

    // P V into warp w's columns of every head
    if (nt > 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float a0 = salpha[16 * mt + g], a1 = salpha[16 * mt + g + 8];
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          acc[mt][n][0] *= a0;
          acc[mt][n][1] *= a0;
          acc[mt][n][2] *= a1;
          acc[mt][n][3] *= a1;
        }
        tcore::warp_mma<NC, false, kExact<TKV>, false, true>(
            acc[mt], ps, kPS, 16 * mt, vrows, VS, n0, nt, kTile);
      }
    }
  }

  // this split's state, for the cluster: m and l per head, the accumulator
  // over the tiles' shared memory
  __syncthreads();
  float* const bacc = smem;                            // GP x Dv
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < HPW; ++j) {
      bm[w + kWarps * j] = m[j];
      bl[w + kWarps * j] = l[j];
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < NC; ++n)
      if (n < nt) {
        float* r0 = bacc + (16 * mt + g) * Dv + n0 + 8 * n + 2 * tg;
        r0[0] = acc[mt][n][0];
        r0[1] = acc[mt][n][1];
        r0[8 * Dv] = acc[mt][n][2];
        r0[8 * Dv + 1] = acc[mt][n][3];
      }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  // block r merges heads r, r + splits, ... from every split, in order
  const int splits = a.splits;
  for (int h = (int)cluster.block_rank(); h < a.G; h += splits) {
    float ms[kMaxSplits], f[kMaxSplits];
    float mx = lm::kNegInf;
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp) {
      ms[sp] = sp < splits ? *cluster.map_shared_rank(&bm[h], sp)
                           : lm::kNegInf;
      mx = fmaxf(mx, ms[sp]);
    }
    float tot = 0.f;
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp) {
      f[sp] = expf(ms[sp] - mx);
      if (sp < splits) tot += *cluster.map_shared_rank(&bl[h], sp) * f[sp];
    }
    tot = fmaxf(tot, 1e-30f);
    for (int d = t; d < Dv; d += kThreads) {
      float as = 0.f;
#pragma unroll
      for (int sp = 0; sp < kMaxSplits; ++sp)
        if (sp < splits)
          as += *cluster.map_shared_rank(&bacc[h * Dv + d], sp) * f[sp];
      o[b * a.ob + (long long)h * a.oh + d] = lm::from_f<TQ>(as / tot);
    }
  }
  cluster.sync();  // the other blocks' shared memory lives until read
}

// floats of dynamic shared memory: the tiles' and the merge's, overlaid
inline int smem_floats(const Args& a, int GP, int KG) {
  const int tiles = GP * a.ks + kTile * a.ks
                    + (a.v_in_k ? 0 : kTile * (a.Dv + 8)) + KG * GP * kPS;
  const int merge = GP * a.Dv;
  return tiles > merge ? tiles : merge;
}

template <typename TQ, typename TKV, int MT, int NC>
int launch(const void* q, const void* k, const void* v, const float* bias,
           void* o, const Args& a, cudaStream_t stream) {
  static int opted = 0;  // the dynamic shared memory opted into so far
  static bool wide_ok = false;
  auto kernel = mla_decode_kernel<TQ, TKV, MT, NC>;
  constexpr int GP = 16 * MT;
  const int bytes = 4 * smem_floats(a, GP, kKG<MT>);
  int e = 0;
  if (bytes > opted && bytes > 48 * 1024) {
    e = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e == 0) opted = bytes;
  }
  if (e == 0 && !wide_ok) {
    e = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    wide_ok = e == 0;
  }
  if (e != 0) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B, a.splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = a.splits;  // a slot's splits: one cluster
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t r = cudaLaunchKernelEx(
      &cfg, kernel, (const TQ*)q, (const TKV*)k, (const TKV*)v, bias, (TQ*)o,
      a);
  if (r != cudaSuccess) return (int)r;
  return (int)cudaGetLastError();
}

// value columns a warp: 32, or 64 past Dv 256 (G <= 32 only: more heads'
// accumulators would spill)
template <typename TQ, typename TKV, int MT>
int launch_v(const void* q, const void* k, const void* v, const float* bias,
             void* o, const Args& a, cudaStream_t stream) {
  if (a.Dv <= kWarps * 32)
    return launch<TQ, TKV, MT, 4>(q, k, v, bias, o, a, stream);
  if constexpr (MT <= 2)
    return launch<TQ, TKV, MT, 8>(q, k, v, bias, o, a, stream);
  return (int)cudaErrorInvalidValue;
}

// 16-row tiles of heads: the fewest of 1-4 (GP = 16, 32, 48, 64)
template <typename TQ, typename TKV>
int launch_g(const void* q, const void* k, const void* v, const float* bias,
             void* o, const Args& a, cudaStream_t stream) {
  if (a.G <= 16) return launch_v<TQ, TKV, 1>(q, k, v, bias, o, a, stream);
  if (a.G <= 32) return launch_v<TQ, TKV, 2>(q, k, v, bias, o, a, stream);
  if (a.G <= 48) return launch_v<TQ, TKV, 3>(q, k, v, bias, o, a, stream);
  if (a.G <= 64) return launch_v<TQ, TKV, 4>(q, k, v, bias, o, a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace mla

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

// The latent instance.  dims: B, G (= Hq; Hkv is 1), S, Dk, Dv (a multiple
// of 8), keys_per_split (a multiple of 32), splits (at most 16), vec,
// v_in_k, the shared-memory row of q and K in floats (Dk rounded up to 8,
// 4 mod 32), q_vec.  strides: qb, qh, kb, kpos, vb, vpos, ob, oh, bias_b.
extern "C" int decode_attention_mla_launch(const void* q, const void* k,
                                           const void* v, const void* bias,
                                           void* o, int q_dtype,
                                           int kv_dtype, const int* dims,
                                           const long long* strides,
                                           float scale, void* stream) {
  mla::Args a;
  a.B = dims[0]; a.G = dims[1]; a.S = dims[2]; a.Dk = dims[3];
  a.Dv = dims[4]; a.keys_per_split = dims[5]; a.splits = dims[6];
  a.vec = dims[7]; a.v_in_k = dims[8]; a.ks = dims[9]; a.q_vec = dims[10];
  a.scale = scale;
  if (a.splits < 1 || a.splits > mla::kMaxSplits ||
      a.keys_per_split % mla::kTile != 0 || a.keys_per_split < 1 ||
      (long long)a.splits * a.keys_per_split < a.S ||
      a.Dk > mla::kMaxDk || a.Dv > mla::kMaxDv || a.Dv % 8 != 0 ||
      a.ks % 32 != 4 || a.ks < a.Dk || a.ks > mla::kMaxRow ||
      (a.v_in_k && a.Dv > a.Dk))
    return (int)cudaErrorInvalidValue;
  long long* s[] = {&a.qb, &a.qh, &a.kb, &a.kpos, &a.vb,
                    &a.vpos, &a.ob, &a.oh, &a.bias_b};
  for (int i = 0; i < 9; ++i) *s[i] = strides[i];
  const float* bp = (const float*)bias;
  const cudaStream_t st = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  if (q_dtype == lm::kF32 && kv_dtype == lm::kF32)
    return mla::launch_g<float, float>(q, k, v, bp, o, a, st);
  if (q_dtype == lm::kBF16 && kv_dtype == lm::kBF16)
    return mla::launch_g<bf16, bf16>(q, k, v, bp, o, a, st);
  if (q_dtype == lm::kBF16 && kv_dtype == lm::kF32)
    return mla::launch_g<bf16, float>(q, k, v, bp, o, a, st);
  if (q_dtype == lm::kF32 && kv_dtype == lm::kBF16)
    return mla::launch_g<float, bf16>(q, k, v, bp, o, a, st);
  return (int)cudaErrorInvalidValue;
}

LM_ERROR_STRING(decode_attention)
