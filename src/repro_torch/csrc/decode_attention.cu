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
//
// What bounds it: the live latent rows, read once for all G heads (a float32
// row of deepseek's is 2.3 KB; 64 slots of ~330 live rows are ~49 MB, ~15 us
// of HBM time), and close behind, the products: 2 G (Dk + Dv) operations a
// key, in 3xTF32 (three m16n8k8 passes, two where q is bf16) on the tensor
// cores.  So the design gives every SM an even share of the live rows and
// keeps its loads in flight behind the products.  Three passes, each with a
// grid fixed by the shapes, so a CUDA graph replays them with new lengths:
// - mla_extent_kernel, a block a slot: the slot's live extent, its first to
//   its last key that the bias leaves unmasked (bias > NEG_INF / 2);
// - mla_decode_kernel, one or two blocks an SM: the slots laid end to end,
//   each as kSlotRows rows for its fixed cost (its query rows' load, its
//   write-out) and then its extent's rows, are cut into equal runs, one a
//   block (a multiple of kTile rows), so a long slot spreads over many SMs
//   and short slots share one.  A block walks its run
//   kTile keys at a time through a ring of `stages` tiles in shared memory,
//   filled `stages` - 1 tiles ahead of the products by bulk copies (TMA), a
//   row a copy, each stage's bytes counted on its mbarrier (a float32 cache
//   on 16 bytes; a bf16 one goes through registers).  A tile's bias is read
//   one tile ahead of its rows; masked keys inside an extent are zeroed in
//   shared memory, never read.  The G query rows (padded to GP = 16 MT) sit
//   in shared memory in q's type, copied in as soon as the last tile of the
//   slot before is done with them.  The logits (GP x kTile) = Q K^T run as
//   MT row tiles of 16 x 16, each tile's depth split over KG warps; the
//   online softmax takes a head a half-warp (lane = key); P V (GP x Dv)
//   gives warp w columns 8 NC w .. of every head, its accumulator in mma
//   fragments.  Both products run in 3xTF32 (hi x hi + hi x lo + lo x hi,
//   each operand kept to about 2^-20 of itself; a bf16 operand is exact in
//   TF32 and skips its lo pass).  When v is the first Dv columns of k's
//   rows (the model's [c_kv ; k_rope] row, v = c_kv), the V rows are the K
//   rows: each row is read once.  A slot whose extent lies inside the run
//   is written out normalised; a run's first and last slot, when the cut
//   splits them, leave a partial state (running max and sum per head, the
//   unnormalised G x Dv output) in scratch.  At G <= 16 two blocks share an
//   SM, so one's loads, barriers and softmax overlap the other's products;
// - mla_combine_kernel, a block a (slot, head): merges a split slot's
//   partial states in a fixed order; a slot with no live key gives 0.
// No atomics, and every cut follows from the extents alone: the same inputs
// give the same bits on every call and every replay.
namespace mla {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 16;         // keys a tile: one a lane of a half-warp
constexpr int kMaxStages = 4;     // tiles in the ring, at most
constexpr int kSlotRows = 16;     // a slot's fixed cost, in rows of a run
constexpr int kMaxG = 64;
constexpr int kMaxDk = 576, kMaxDv = kWarps * 64;
constexpr int kMaxRow = kMaxDk + 4;  // the widest shared-memory row
constexpr int kPS = kTile + 4;       // a logits / p row (20 words)

// warps that split one logits tile's depth: 8, 4, 2, 1 at MT = 1-4
template <int MT>
constexpr int kKG = MT == 1 ? 8 : MT == 2 ? 4 : MT == 3 ? 2 : 1;

// a tile's flags
constexpr int kFirst = 1;  // the run's first tile of its slot
constexpr int kLast = 2;   // the run's last tile of its slot
constexpr int kWhole = 4;  // the run holds the slot's whole extent

struct Args {
  int B, G, S, Dk, Dv;
  int blocks;  // runs: the decode pass's blocks
  int stages;  // tiles in the ring, 2 to kMaxStages
  int vec;     // K and V rows may be read with 16-byte loads
  int q_vec;   // so may q's rows
  int v_in_k;  // v is k[..., :Dv]: the V rows are the K rows
  int ks;      // shared-memory row of K, in floats: Dk rounded up to 8,
               // 4 mod 32 (a fragment load free of bank conflicts)
  int qs;      // shared-memory row of q, in q's elements: Dk rounded up to
               // 8, 4 mod 32 words
  float scale;
  long long qb, qh, kb, kpos, vb, vpos, ob, oh, bias_b;
};

// The scratch (decode_attention.py:_mla_scratch_bytes): each slot's extent
// (first key, rows), then two partial states a run (its first and its last
// slot): the max and the sum per head, the unnormalised output per head.
struct Scratch {
  int* ext;
  float *pm, *pl, *pacc;
};

__host__ __device__ inline Scratch carve(void* base, const Args& a) {
  const long long parts = 2LL * a.blocks * a.G;
  Scratch s;
  s.ext = static_cast<int*>(base);
  s.pm = reinterpret_cast<float*>(static_cast<char*>(base) +
                                  (8LL * a.B + 15) / 16 * 16);
  s.pl = s.pm + parts;
  s.pacc = s.pl + parts;
  return s;
}

// a slot's rows laid end to end: its fixed cost, then its extent (none
// for a slot with no live key)
__device__ __forceinline__ int slot_rows(int len) {
  return len > 0 ? kSlotRows + len : 0;
}

// the rows of a run: an even share of the rows, rounded up to whole tiles
__device__ __forceinline__ int run_rows(int total, int blocks) {
  return ((total + blocks - 1) / blocks + kTile - 1) / kTile * kTile;
}

// Block-wide, over the slots laid end to end: returns the rows in all, and
// writes to s_out the slot `want_slot` or, if that is negative, the slot
// that holds this block's run's first row (blockIdx.x * run_rows), with the
// slot's first row, its extent's first key and its extent's rows; s_out[0]
// is -1 if no slot holds that row.  One load of the extents where B <=
// kThreads, else a pass to count them and a pass to find the slot.
__device__ int scan_rows(const int* ext, int B, int blocks, int want_slot,
                         int* s_w, int* s_out) {
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  if (t == 0) s_out[0] = -1;
  int first = 0, key = 0, len = 0;  // this thread's slot of the last chunk
  auto found = [&](int i) {
    s_out[0] = i;
    s_out[1] = first;
    s_out[2] = key;
    s_out[3] = len;
  };
  auto pass = [&](int want_row) {
    int run = 0;
    for (int c0 = 0; c0 < B; c0 += kThreads) {
      const int i = c0 + t;
      key = i < B ? ext[2 * i] : 0;
      len = i < B ? ext[2 * i + 1] : 0;
      const int rows = slot_rows(len);
      int x = rows;  // the warp's inclusive sum up to this lane
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, off);
        if (lane >= off) x += y;
      }
      if (lane == 31) s_w[w] = x;
      __syncthreads();
      int before = run, chunk = 0;
#pragma unroll
      for (int ww = 0; ww < kWarps; ++ww) {
        if (ww < w) before += s_w[ww];
        chunk += s_w[ww];
      }
      first = before + x - rows;
      if (i < B && (i == want_slot ||
                    (rows > 0 && first <= want_row && want_row < first + rows)))
        found(i);
      run += chunk;
      __syncthreads();
    }
    return run;
  };
  const int total = pass(-1);
  if (want_slot >= 0) return total;
  const int r = blockIdx.x * run_rows(total, blocks);
  if (B > kThreads) {
    pass(r);
  } else {
    if (t < B && len > 0 && first <= r && r < first + slot_rows(len))
      found(t);
    __syncthreads();
  }
  return total;
}

__device__ __forceinline__ float half_max(float v) {  // over a half-warp
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
mla_extent_kernel(const float* __restrict__ bias, int* __restrict__ ext,
                  const Args a) {
  __shared__ int slo[kWarps], shi[kWarps];
  const int b = blockIdx.x, t = threadIdx.x, w = t >> 5, lane = t & 31;
  int lo = a.S, hi = -1;
  if (bias == nullptr) {
    lo = 0;
    hi = a.S - 1;
  } else {
    const float* bp = bias + b * a.bias_b;
    // 16-byte loads where the rows allow: a row in one or two loads a thread
    const int n4 = a.S % 4 == 0 && a.bias_b % 4 == 0 &&
                           (reinterpret_cast<uintptr_t>(bias) & 15) == 0
                       ? a.S / 4 : 0;
#pragma unroll 2
    for (int u = t; u < n4; u += kThreads) {
      const float4 x = reinterpret_cast<const float4*>(bp)[u];
      const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (xs[i] > kSkip) {
          lo = min(lo, 4 * u + i);
          hi = max(hi, 4 * u + i);
        }
    }
    for (int key = 4 * n4 + t; key < a.S; key += kThreads)
      if (bp[key] > kSkip) {
        lo = min(lo, key);
        hi = max(hi, key);
      }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  if (lane == 0) {
    slo[w] = lo;
    shi[w] = hi;
  }
  __syncthreads();
  if (t == 0) {
    for (int ww = 1; ww < kWarps; ++ww) {
      lo = min(lo, slo[ww]);
      hi = max(hi, shi[ww]);
    }
    ext[2 * b] = hi >= lo ? lo : 0;
    ext[2 * b + 1] = hi >= lo ? hi - lo + 1 : 0;
  }
}

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

// The ring's barriers and copies (Hopper's bulk copy engine, TMA): a copy
// of a whole row from device to shared memory that reports its bytes to an
// mbarrier; a consumer waits for the barrier's phase to flip.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                   tcore::smem_addr(bar))
               : "memory");
}

// the one arrival of a phase, and the bytes the copies will bring
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          tcore::smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(tcore::smem_addr(bar)), "r"(parity)
        : "memory");
}

// bytes (a multiple of 16, both ends on 16 bytes) from device memory into
// shared memory, counted on bar; ordered after this thread's (and, after a
// barrier, the block's) earlier accesses to shared memory
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(tcore::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(tcore::smem_addr(bar))
      : "memory");
}

// q's G rows of Dk elements (row h at src + h * stride) into shared memory
// in their own type (row h at dst + h * ds), element by element: the rows
// that bulk copies cannot take
template <typename T>
__device__ __forceinline__ void q_rows(T* dst, int ds, const T* src,
                                       long long stride, int G, int Dk,
                                       int t) {
  for (int e = t; e < G * Dk; e += kThreads) {
    const int row = e / Dk;
    dst[row * ds + e - row * Dk] = src[row * stride + e - row * Dk];
  }
}

template <typename T>
constexpr bool kExact = sizeof(T) == 2;  // bf16 values are TF32 values

// x = hi + lo for 3xTF32: hi is x cut to TF32 (a mask of its 13 low
// bits), lo the rest, exact in float32 and cut to TF32 in turn; so x is
// kept to about 2^-20 of itself, at one integer operation a part where
// rounding conversions would take two cvt.  EXACT: x is a TF32 value (a
// bf16 one), lo is 0 and is not formed.
template <bool EXACT>
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  constexpr unsigned kMask = 0xffffe000u;
  hi = __float_as_uint(x) & (EXACT ? ~0u : kMask);
  if constexpr (!EXACT) lo = __float_as_uint(x - __uint_as_float(hi)) & kMask;
}

// A warp's logits over depth [kb, kb + kn) (a multiple of 8): acc[n] +=
// sum_k Q[m0 + row][k] K[8 n + col][k] in mma fragments (row m0 + lane / 4
// in acc[n][0..1], 8 rows on in [2..3], columns 8 n + 2 (lane % 4) and the
// next), Q in q's type (row stride QS), K float32 rows (stride KS), in
// 3xTF32, the small terms first; BX: every K value is exact in TF32.
template <typename TQ, bool BX>
__device__ __forceinline__ void mma_qk(float (&acc)[kTile / 8][4],
                                       const TQ* qs, int QS, int m0,
                                       const float* kt, int KS, int kb,
                                       int kn) {
  constexpr bool AX = kExact<TQ>;
  const int lane = threadIdx.x & 31, g = lane >> 2, tg = lane & 3;
  const TQ* const ap = qs + (m0 + g) * QS + kb + tg;
  const float* const bp = kt + g * KS + kb + tg;
  for (int k0 = 0; k0 < kn; k0 += 8) {
    unsigned ah[4], al[4];
    split<AX>(lm::to_f(ap[k0]), ah[0], al[0]);
    split<AX>(lm::to_f(ap[k0 + 8 * QS]), ah[1], al[1]);
    split<AX>(lm::to_f(ap[k0 + 4]), ah[2], al[2]);
    split<AX>(lm::to_f(ap[k0 + 8 * QS + 4]), ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
      const float* const b0 = bp + 8 * n * KS + k0;
      unsigned bh[2], bl[2];
      split<BX>(b0[0], bh[0], bl[0]);
      split<BX>(b0[4], bh[1], bl[1]);
      if (!AX) tcore::mma_tf32(acc[n], al, bh);
      if (!BX) tcore::mma_tf32(acc[n], ah, bl);
      tcore::mma_tf32(acc[n], ah, bh);
    }
  }
}

// A warp's P V over a tile's kTile keys: acc[n] += sum_k P[m0 + row][k]
// V[k][n0 + 8 n + col] for n < nt (fragments as mma_qk's), P float32 rows
// (stride kPS), V rows k-major (stride VS), in 3xTF32; BX: every V value is
// exact in TF32.
template <int NC, bool BX>
__device__ __forceinline__ void mma_pv(float (&acc)[NC][4], const float* ps,
                                       int m0, const float* vt, int VS,
                                       int n0, int nt) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tg = lane & 3;
  const float* const ap = ps + (m0 + g) * kPS + tg;
  const float* const bp = vt + tg * VS + n0 + g;
#pragma unroll
  for (int k0 = 0; k0 < kTile; k0 += 8) {
    unsigned ah[4], al[4];
    split<false>(ap[k0], ah[0], al[0]);
    split<false>(ap[k0 + 8 * kPS], ah[1], al[1]);
    split<false>(ap[k0 + 4], ah[2], al[2]);
    split<false>(ap[k0 + 8 * kPS + 4], ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      if (n < nt) {
        const float* const b0 = bp + k0 * VS + 8 * n;
        unsigned bh[2], bl[2];
        split<BX>(b0[0], bh[0], bl[0]);
        split<BX>(b0[4 * VS], bh[1], bl[1]);
        tcore::mma_tf32(acc[n], al, bh);
        if (!BX) tcore::mma_tf32(acc[n], ah, bl);
        tcore::mma_tf32(acc[n], ah, bh);
      }
    }
  }
}

// floats before the ring in the decode pass's shared memory: q's rows
__host__ __device__ inline int q_floats(int GP, int qs, int q_size) {
  return (GP * qs * q_size + 15) / 16 * 4;
}

template <typename TQ, typename TKV, int MT, int NC>
__global__ void __launch_bounds__(kThreads, MT == 1 ? 2 : 1)
mla_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                  const TKV* __restrict__ v, const float* __restrict__ bias,
                  TQ* __restrict__ o, void* __restrict__ scratch,
                  const Args a) {
  constexpr int GP = 16 * MT;        // heads, padded to the mma's rows
  constexpr int KG = kKG<MT>;        // warps a logits tile's depth takes
  extern __shared__ float4 smem4[];
  __shared__ float salpha[GP], sm[GP], sl[GP];
  __shared__ float sbias[kMaxStages][kTile];
  __shared__ int sdesc[kMaxStages][4];  // slot, live bits, flags, partial
  __shared__ int s_w[kWarps], s_out[4];
  __shared__ alignas(8) uint64_t mbar[kMaxStages + 1];  // the ring's, q's

  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const int g = lane >> 2, tg = lane & 3;     // an mma fragment's row, column
  const int half = lane >> 4, j = lane & 15;  // the softmax's head, key
  const int G = a.G, Dk = a.Dk, Dv = a.Dv, KS = a.ks, QS = a.qs;
  const int Dk8 = (Dk + 7) & ~7;
  const bool v_in_k = a.v_in_k != 0;
  const int VS = v_in_k ? KS : Dv + 8;                 // 8 mod 32 words
  const int stage = kTile * KS + (v_in_k ? 0 : kTile * VS);
  TQ* const qs = reinterpret_cast<TQ*>(smem4);         // GP x QS
  float* const ring = reinterpret_cast<float*>(smem4) +
                      q_floats(GP, QS, sizeof(TQ));    // stages x stage
  float* const ps = ring + a.stages * stage;           // KG x GP x kPS
  const Scratch sc = carve(scratch, a);

  // this block's run: rows [r0, r1) of the slots laid end to end
  const int total = scan_rows(sc.ext, a.B, a.blocks, -1, s_w, s_out);
  const int per = run_rows(total, a.blocks);
  const int r0 = blockIdx.x * per;
  if (r0 >= total) return;
  const int r1 = min(total, r0 + per);
  // zeros where no copy writes: q's pad rows and columns, K's columns
  // Dk .. Dk8
  for (int e = t; e < GP * QS; e += kThreads) qs[e] = lm::from_f<TQ>(0.f);
  for (int e = t; e < a.stages * kTile * (Dk8 - Dk); e += kThreads) {
    const int row = e / (Dk8 - Dk);
    ring[(row / kTile) * stage + (row % kTile) * KS + Dk + e % (Dk8 - Dk)] =
        0.f;
  }
  if (t == 0) {
    for (int i = 0; i <= kMaxStages; ++i) mbar_init(&mbar[i]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // float32 rows on 16 bytes come by bulk copies; others through registers
  const bool tma = sizeof(TKV) == 4 && a.vec != 0;

  // the feed, the same in every thread: the next tile to copy starts at row
  // fr, inside slot fb, whose rows start at fbase (its extent kSlotRows
  // later, at key ffirst)
  int fb = s_out[0], fbase = s_out[1], ffirst = s_out[2], flen = s_out[3];
  int nfirst = 0, nlen = 0;  // slot fb + 1's extent, read ahead
  if (fb + 1 < a.B) {
    nfirst = sc.ext[2 * fb + 2];
    nlen = sc.ext[2 * fb + 3];
  }
  int fr = max(r0, fbase + kSlotRows);
  // past slot fb's extent: on to the next slot with live rows
  auto settle = [&]() {
    while (fr < r1 && fr >= fbase + slot_rows(flen)) {
      fbase += slot_rows(flen);
      ++fb;
      ffirst = nfirst;
      flen = nlen;
      if (fb + 1 < a.B) {
        nfirst = sc.ext[2 * fb + 2];
        nlen = sc.ext[2 * fb + 3];
      }
      fr = max(fr, fbase + (flen > 0 ? kSlotRows : 0));
    }
  };
  // the bias of lane j's key in the next tile (0 past the tile)
  auto tile_bias = [&]() {
    const int n = min(kTile, min(r1, fbase + slot_rows(flen)) - fr);
    return j < n && bias != nullptr
               ? bias[fb * a.bias_b + ffirst + (fr - fbase - kSlotRows) + j]
               : 0.f;
  };
  settle();
  float bnext = fr < r1 ? tile_bias() : 0.f;
  int issued = 0;
  // the next tile into ring stage st; then on to the tile after it
  auto issue = [&](int st) {
    const int end = min(r1, fbase + slot_rows(flen));  // the run's rows of fb
    const int n = min(kTile, end - fr);
    const int key0 = ffirst + (fr - fbase - kSlotRows);
    const unsigned live =
        __ballot_sync(0xffffffffu, j < n && bnext > kSkip) & 0xffffu;
    if (t < kTile) sbias[st][t] = bnext;
    if (t == 0) {
      sdesc[st][0] = fb;
      sdesc[st][1] = (int)live;
      sdesc[st][2] = (fr == max(r0, fbase + kSlotRows) ? kFirst : 0) |
                     (fr + n == end ? kLast : 0) |
                     (fbase + kSlotRows >= r0 &&
                              fbase + slot_rows(flen) <= r1 ? kWhole : 0);
      sdesc[st][3] = 2 * blockIdx.x + (fbase <= r0 ? 0 : 1);
    }
    float* const kt = ring + st * stage;
    float* const vt = kt + kTile * KS;  // V rows of their own
    const TKV* const kp = k + fb * a.kb + key0 * a.kpos;
    const TKV* const vp = v + fb * a.vb + key0 * a.vpos;
    if (tma) {
      // zeros in the rows the copies leave out: p = 0 must not meet a NaN
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int row = w; row < kTile; row += kWarps) {
        if ((live >> row) & 1u) continue;
        for (int c4 = 4 * lane; c4 < Dk; c4 += 128)
          *reinterpret_cast<float4*>(kt + row * KS + c4) = z;
        for (int c4 = 4 * lane; !v_in_k && c4 < Dv; c4 += 128)
          *reinterpret_cast<float4*>(vt + row * VS + c4) = z;
      }
      if (w == 0) {  // one copy a live row, a lane each
        if (lane == 0)
          mbar_expect(&mbar[st],
                      __popc(live) * 4 * (Dk + (v_in_k ? 0 : Dv)));
        __syncwarp();
        if ((live >> lane) & 1u) {
          bulk_copy(kt + lane * KS, kp + lane * a.kpos, 4 * Dk, &mbar[st]);
          if (!v_in_k)
            bulk_copy(vt + lane * VS, vp + lane * a.vpos, 4 * Dv, &mbar[st]);
        }
      }
    } else {
      rows_to_smem(kt, KS, kp, a.kpos, kTile, Dk, Dk8, live, a.vec != 0, t);
      if (!v_in_k)
        rows_to_smem(vt, VS, vp, a.vpos, kTile, Dv, Dv, live, a.vec != 0, t);
      if (t == 0) mbar_expect(&mbar[st], 0);
    }
    ++issued;
    fr += n;
    settle();
    if (fr < r1) bnext = tile_bias();
  };

  float m[MT], l[MT];  // heads w + kWarps (2 i + half), in every lane
  float acc[MT][NC][4];
  // P V: warp w's columns 8 (NC w + n) of the heads 16 mt + g (+ 8)
  const int n0 = 8 * NC * w;
  const int nt = n0 < Dv ? min(NC, (Dv - n0) / 8) : 0;

  // a slot's query rows by bulk copies (rows on 16 bytes), a lane a row of
  // warp 0; done with the last tile's logits, the buffer is free
  auto issue_q = [&](int slot) {
    if (lane == 0) mbar_expect(&mbar[kMaxStages], G * Dk * sizeof(TQ));
    __syncwarp();
    for (int h = lane; h < G; h += 32)
      bulk_copy(qs + h * QS, q + slot * a.qb + h * a.qh, Dk * sizeof(TQ),
                &mbar[kMaxStages]);
  };

  int nq = 0;  // query rows' loads waited for
  // the ring's first stages - 1 tiles (c < 0), then one ahead of each tile
  for (int c = 1 - a.stages; c < issued; ++c) {
    if (c >= 0) {
      mbar_wait(&mbar[c % a.stages], (c / a.stages) & 1);
      __syncthreads();  // tile c is in; every thread is done with tile c - 1
    }
    if (fr < r1) issue((c + a.stages - 1) % a.stages);
    if (c < 0) {
      if (c == -1 && w == 0 && a.q_vec && issued > 0) issue_q(sdesc[0][0]);
      continue;
    }
    const int st = c % a.stages;
    const int slot = sdesc[st][0], bits = sdesc[st][2];
    const unsigned live = (unsigned)sdesc[st][1];
    const float* const kt = ring + st * stage;
    const float* const vt = v_in_k ? kt : kt + kTile * KS;
    if (bits & kFirst) {  // a new slot: its query rows, a fresh state
      if (a.q_vec) mbar_wait(&mbar[kMaxStages], nq++ & 1);
      else q_rows(qs, QS, q + slot * a.qb, a.qh, G, Dk, t);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        m[i] = lm::kNegInf;
        l[i] = 0.f;
#pragma unroll
        for (int n = 0; n < NC; ++n)
          acc[i][n][0] = acc[i][n][1] = acc[i][n][2] = acc[i][n][3] = 0.f;
      }
      if (!a.q_vec) __syncthreads();
    }
    if (live != 0) {
      // logits: tile w % MT (heads 16 (w % MT) ..) over depth slice w / MT
      // of KG, into partial plane w / MT
      if (w < MT * KG) {
        const int mt = w % MT, kg = w / MT;
        const int per_k = 8 * ((Dk8 / 8 + KG - 1) / KG);
        const int kb = kg * per_k, kn = min(Dk8 - kb, per_k);
        float s[kTile / 8][4] = {};
        if (kn > 0)
          mma_qk<TQ, kExact<TKV>>(s, qs, QS, 16 * mt, kt, KS, kb, kn);
#pragma unroll
        for (int n = 0; n < kTile / 8; ++n) {
          float* r0p =
              ps + kg * GP * kPS + (16 * mt + g) * kPS + 8 * n + 2 * tg;
          r0p[0] = s[n][0];
          r0p[1] = s[n][1];
          r0p[8 * kPS] = s[n][2];
          r0p[8 * kPS + 1] = s[n][3];
        }
      }
      __syncthreads();
      // each head's online softmax across a half-warp's lanes, p in place
      const float bv = sbias[st][j];
      const bool on = (live >> j) & 1u;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int h = w + kWarps * (2 * i + half);
        float raw = ps[h * kPS + j];
#pragma unroll
        for (int kg = 1; kg < KG; ++kg) raw += ps[kg * GP * kPS + h * kPS + j];
        const float sv = on ? raw * a.scale + bv : -INFINITY;
        const float mn = fmaxf(m[i], half_max(sv));
        const bool alive = mn > kSkip;
        const float p = alive ? expf(sv - mn) : 0.f;
        const float alpha = expf(m[i] - mn);
        l[i] = alpha * l[i] + half_sum(p);
        m[i] = mn;
        ps[h * kPS + j] = p;
        if (j == 0) salpha[h] = alpha;
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
          mma_pv<NC, kExact<TKV>>(acc[mt], ps, 16 * mt, vt, VS, n0, nt);
        }
      }
    }
    if (w == 0 && a.q_vec) {  // the next tile's slot's query rows, ahead
      __syncwarp();
      const int nx = (c + 1) % a.stages;
      if (c + 1 < issued && (sdesc[nx][2] & kFirst)) issue_q(sdesc[nx][0]);
    }
    if (bits & kLast) {  // the run is done with this slot: out, or a partial
      if (j == 0) {
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int h = w + kWarps * (2 * i + half);
          sm[h] = m[i];
          sl[h] = l[i];
        }
      }
      __syncthreads();
      const bool whole = (bits & kWhole) != 0;
      const int part = sdesc[st][3];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int h = 16 * mt + g + 8 * r;
          if (h >= G) continue;
          const float tot = fmaxf(sl[h], 1e-30f);
#pragma unroll
          for (int n = 0; n < NC; ++n) {
            const int d = n0 + 8 * n + 2 * tg;
            const float x0 = acc[mt][n][2 * r], x1 = acc[mt][n][2 * r + 1];
            if (n >= nt) {
            } else if (whole) {
              TQ* op = o + slot * a.ob + h * a.oh + d;
              op[0] = lm::from_f<TQ>(x0 / tot);
              op[1] = lm::from_f<TQ>(x1 / tot);
            } else {
              *reinterpret_cast<float2*>(
                  sc.pacc + ((long long)part * G + h) * Dv + d) =
                  make_float2(x0, x1);
            }
          }
        }
      if (!whole && t < G) {
        sc.pm[part * G + t] = sm[t];
        sc.pl[part * G + t] = sl[t];
      }
    }
  }
}

// A split slot's partial states of one head, merged: the runs' weights
// exp(m_i - max) by a warp, then each group of Dv / 4 threads sums every
// groups-th run's output, 4 columns a thread, and the groups' sums are
// added in group order.  Dynamic shared memory: a weight a run, then a
// float4 a thread.
template <typename TQ>
__global__ void __launch_bounds__(kThreads)
mla_combine_kernel(TQ* __restrict__ o, void* __restrict__ scratch,
                   const Args a) {
  extern __shared__ float4 cmem[];
  __shared__ int s_w[kWarps], s_out[4];
  __shared__ float stot;
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const int b = blockIdx.x, h = blockIdx.y, G = a.G, Dv = a.Dv;
  const Scratch sc = carve(scratch, a);
  const int total = scan_rows(sc.ext, a.B, a.blocks, b, s_w, s_out);
  const int base = s_out[1], len = s_out[3];
  TQ* const oh = o + b * a.ob + h * a.oh;
  if (len == 0) {  // every key masked: 0, as in the TPU kernel
    for (int d = t; d < Dv; d += kThreads) oh[d] = lm::from_f<TQ>(0.f);
    return;
  }
  // the runs that hold the slot's extent: rows base + kSlotRows ..
  const int per = run_rows(total, a.blocks), first = base + kSlotRows;
  const int i0 = first / per, np = (first + len - 1) / per - i0 + 1;
  if (np == 1) return;  // one run held the slot and wrote it out
  // run i0 + i's partial state of the head: the run's first slot's, or
  // (run i0 only) its last's
  auto at = [&](int i) {
    return (2LL * (i0 + i) + (base <= (i0 + i) * per ? 0 : 1)) * G + h;
  };
  float* const wts = reinterpret_cast<float*>(cmem);            // np
  float4* const red = cmem + (a.blocks + 3) / 4;                // kThreads
  if (w == 0) {
    float mx = lm::kNegInf;
    for (int i = lane; i < np; i += 32) mx = fmaxf(mx, sc.pm[at(i)]);
    mx = lm::warp_max(mx);
    float tot = 0.f;
    for (int i = lane; i < np; i += 32) {
      const float f = expf(sc.pm[at(i)] - mx);
      wts[i] = f;
      tot += sc.pl[at(i)] * f;
    }
    tot = lm::warp_sum(tot);
    if (lane == 0) stot = fmaxf(tot, 1e-30f);
  }
  __syncthreads();
  const int nc = Dv / 4, groups = kThreads / nc;
  const int grp = t / nc, c = 4 * (t - grp * nc);
  float4 as = make_float4(0.f, 0.f, 0.f, 0.f);
  if (grp < groups) {
#pragma unroll 4
    for (int i = grp; i < np; i += groups) {
      const float4 x =
          *reinterpret_cast<const float4*>(sc.pacc + at(i) * Dv + c);
      as.x += x.x * wts[i];
      as.y += x.y * wts[i];
      as.z += x.z * wts[i];
      as.w += x.w * wts[i];
    }
  }
  red[t] = as;
  __syncthreads();
  if (grp == 0) {
    for (int g2 = 1; g2 < groups; ++g2) {
      const float4 x = red[g2 * nc + t];
      as.x += x.x;
      as.y += x.y;
      as.z += x.z;
      as.w += x.w;
    }
    const float tot = stot;
    oh[c] = lm::from_f<TQ>(as.x / tot);
    oh[c + 1] = lm::from_f<TQ>(as.y / tot);
    oh[c + 2] = lm::from_f<TQ>(as.z / tot);
    oh[c + 3] = lm::from_f<TQ>(as.w / tot);
  }
}

// bytes of the decode pass's dynamic shared memory: the query rows, the
// ring, the logits' partial planes
inline int smem_bytes(const Args& a, int GP, int KG, int q_size) {
  return 4 * (q_floats(GP, a.qs, q_size) +
              a.stages * kTile * (a.ks + (a.v_in_k ? 0 : a.Dv + 8)) +
              KG * GP * kPS);
}

template <typename TQ, typename TKV, int MT, int NC>
int launch(const void* q, const void* k, const void* v, const float* bias,
           void* o, void* scratch, const Args& a, cudaStream_t stream) {
  static int opted = 0;  // the dynamic shared memory opted into so far
  auto kernel = mla_decode_kernel<TQ, TKV, MT, NC>;
  const int bytes = smem_bytes(a, 16 * MT, kKG<MT>, (int)sizeof(TQ));
  if (bytes > opted && bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    opted = bytes;
  }
  mla_extent_kernel<<<a.B, kThreads, 0, stream>>>(bias, carve(scratch, a).ext,
                                                  a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  kernel<<<a.blocks, kThreads, bytes, stream>>>(
      (const TQ*)q, (const TKV*)k, (const TKV*)v, bias, (TQ*)o, scratch, a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  mla_combine_kernel<TQ><<<dim3(a.B, a.G), kThreads,
                            16 * ((a.blocks + 3) / 4 + kThreads), stream>>>(
      (TQ*)o, scratch, a);
  return (int)cudaGetLastError();
}

// value columns a warp: 32, or 64 past Dv 256 (G <= 32 only: more heads'
// accumulators would spill)
template <typename TQ, typename TKV, int MT>
int launch_v(const void* q, const void* k, const void* v, const float* bias,
             void* o, void* scratch, const Args& a, cudaStream_t stream) {
  if (a.Dv <= kWarps * 32)
    return launch<TQ, TKV, MT, 4>(q, k, v, bias, o, scratch, a, stream);
  if constexpr (MT <= 2)
    return launch<TQ, TKV, MT, 8>(q, k, v, bias, o, scratch, a, stream);
  return (int)cudaErrorInvalidValue;
}

// 16-row tiles of heads: the fewest of 1-4 (GP = 16, 32, 48, 64)
template <typename TQ, typename TKV>
int launch_g(const void* q, const void* k, const void* v, const float* bias,
             void* o, void* scratch, const Args& a, cudaStream_t stream) {
  if (a.G <= 16)
    return launch_v<TQ, TKV, 1>(q, k, v, bias, o, scratch, a, stream);
  if (a.G <= 32)
    return launch_v<TQ, TKV, 2>(q, k, v, bias, o, scratch, a, stream);
  if (a.G <= 48)
    return launch_v<TQ, TKV, 3>(q, k, v, bias, o, scratch, a, stream);
  if (a.G <= kMaxG)
    return launch_v<TQ, TKV, 4>(q, k, v, bias, o, scratch, a, stream);
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
// of 8), blocks (the runs of the decode pass), stages (2 to 4), vec, v_in_k,
// the shared-memory row of K in floats (Dk rounded up to 8, 4 mod 32), q_vec,
// the shared-memory row of q in its elements (4 mod 32 words).  strides: qb,
// qh, kb, kpos, vb, vpos, ob, oh, bias_b.  scratch: decode_attention.py's
// _mla_scratch_bytes of device memory.
extern "C" int decode_attention_mla_launch(const void* q, const void* k,
                                           const void* v, const void* bias,
                                           void* o, void* scratch,
                                           int q_dtype, int kv_dtype,
                                           const int* dims,
                                           const long long* strides,
                                           float scale, void* stream) {
  mla::Args a;
  a.B = dims[0]; a.G = dims[1]; a.S = dims[2]; a.Dk = dims[3];
  a.Dv = dims[4]; a.blocks = dims[5]; a.stages = dims[6];
  a.vec = dims[7]; a.v_in_k = dims[8]; a.ks = dims[9]; a.q_vec = dims[10];
  a.qs = dims[11];
  a.scale = scale;
  const int q_size = q_dtype == lm::kF32 ? 4 : 2;
  if (a.B < 1 || a.blocks < 1 || a.stages < 2 ||
      a.stages > mla::kMaxStages || a.G < 1 || a.G > mla::kMaxG ||
      a.Dk > mla::kMaxDk || a.Dv > mla::kMaxDv || a.Dv % 8 != 0 ||
      a.ks % 32 != 4 || a.ks < a.Dk || a.ks > mla::kMaxRow ||
      a.qs < a.Dk || a.qs * q_size % 128 != 16 ||
      (a.v_in_k && a.Dv > a.Dk))
    return (int)cudaErrorInvalidValue;
  long long* s[] = {&a.qb, &a.qh, &a.kb, &a.kpos, &a.vb,
                    &a.vpos, &a.ob, &a.oh, &a.bias_b};
  for (int i = 0; i < 9; ++i) *s[i] = strides[i];
  const float* bp = (const float*)bias;
  const cudaStream_t st = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  if (q_dtype == lm::kF32 && kv_dtype == lm::kF32)
    return mla::launch_g<float, float>(q, k, v, bp, o, scratch, a, st);
  if (q_dtype == lm::kBF16 && kv_dtype == lm::kBF16)
    return mla::launch_g<bf16, bf16>(q, k, v, bp, o, scratch, a, st);
  if (q_dtype == lm::kBF16 && kv_dtype == lm::kF32)
    return mla::launch_g<bf16, float>(q, k, v, bp, o, scratch, a, st);
  if (q_dtype == lm::kF32 && kv_dtype == lm::kBF16)
    return mla::launch_g<float, bf16>(q, k, v, bp, o, scratch, a, st);
  return (int)cudaErrorInvalidValue;
}

LM_ERROR_STRING(decode_attention)
