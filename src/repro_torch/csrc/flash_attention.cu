// Flash (streaming) attention for Hopper, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel flash_attention / _kernel
// (src/repro/kernels/flash_attention.py).  Same function: GQA attention
// with an online softmax over key tiles, an additive (B, Sk) bias, an
// optional causal mask, Dv != Dk allowed, the output in q's type.  What
// differs from the TPU kernel:
//   * the causal offset is Sk - Sq (the oracle's, kernels/ref.py), not the
//     padded lengths' difference; pad keys are masked here, not by a padded
//     bias, so any Sq, Sk works (the TPU kernel is wrong when
//     Skp - Sqp != Sk - Sq, e.g. S = 100);
//   * causal blocks stop at the last key any of their rows can see;
//   * a row whose keys are all masked gives 0, as the TPU kernel's clamp of
//     l does.
//
// Two routes; the wrapper (kernels/flash_attention.py, `route`) picks one
// from the operands' types and head dims:
//
// flash_attention_tc_launch -- bf16 q, k and v, Dk and Dv multiples of 16,
// Dk <= 288 and Dv <= 256 (the serving path; Dk 288 / Dv 256 is MLA's
// absorbed prefill, q and k over [c_kv ; k_rope], v over c_kv).  Tensor cores: mma.sync m16n8k16 bf16 ->
// float32 from ldmatrix fragments.  A block takes 64 query rows of one
// (batch, query head), 16 rows a warp; q-blocks with the most causal tiles
// are launched first.  Q and 64-key tiles of K and V reach shared memory by
// 16-byte cp.async copies (rows padded by 16 bytes, so ldmatrix reads
// distinct banks), one copy group a tile, through a ring of stages: while
// the block computes, the next tiles are in flight.  The online softmax
// runs on the accumulator fragments in registers (logits in log2 units,
// row max and sum across a quad by shuffles, 2^x on the SFU, O rescaled in
// registers); P is rounded to bf16 A-fragments in registers and fed
// straight into the PV mma, never through shared memory, and the row sum l
// adds the rounded P, so O is an exact convex combination of V's rows with
// weights bf16(p) / sum(bf16(p)).  Rounding P is the one rounding point the
// TPU kernel does not have; the float32 accumulation keeps the result
// within a quarter of the path's bf16 budget before the output's own
// rounding (tests/test_torch_lm_kernels.py emulates it up to S = 2048).
// Only tiles that cross the causal diagonal or the ragged end of the keys
// are masked; a warp skips a tile that lies wholly above its rows'
// diagonal.
//   The k-loop steps by 16 over Dk and skips the chunks past the call's Dk,
// so an instance serves every Dk up to its own: <64, 64>, <128, 128>,
// <256, 256> and <288, 256> (288 = 18 x 16; no tile assumes a power of
// two).  The <288, 256> instance holds Q (64 x 296 bf16, 37.9 KB) and two
// stages of K and V tiles (2 x 64 x (296 + 264) bf16, 143.4 KB) in 181.2 KB
// of shared memory, inside the 227 KB a block may take; O's accumulator is
// Dv = 256 wide, as the <256, 256> instance's.
//   At the served lengths (Sk <= 512: at most 8 tiles) a launch is latency,
// not work: the bytes bound it under a microsecond.  So up to 4 tiles go
// in flight at once (4 stages) and two key groups of 4 warps take
// alternate tiles for the same rows and merge their (m, l, O) at the end:
// a block's longest chain is half its tiles.  Longer sequences take one
// key group, double-buffered tiles and at most 170 registers (D = 64),
// three blocks an SM.  mma.sync, not wgmma: at the served lengths the warp-level
// product is enough and keeps every warp independent; at S = 2048 the
// kernel is 3x SDPA (PERF.md), the work for a wgmma redesign.
//
// flash_attention_launch -- float32 or mixed-type operands, or head dims
// the tensor-core route does not take (any Dk, Dv <= 288).  Float32 on
// the CUDA cores: one block of 128 threads per (batch, query head, 32
// query rows); four
// threads share a row, each holding 16 of a 64-key tile's logits and a
// quarter of the row's accumulator in registers; Q, K, V and the tile's
// probabilities in shared memory (rows padded by one float).  It holds the
// float32 oracle to 1e-5, which bf16 or TF32 tensor cores cannot.
//
// What bounds both on the card: at the serving path's shapes the bytes (Q,
// K, V read once, O written once), well under a microsecond; the work is
// a few MFLOP per head.
#include <math.h>
#include <stdint.h>

#include "lm_common.cuh"
#include "tensor_core.cuh"

namespace {

struct Args {
  int B, Hq, Hkv, Sq, Sk, Dk, Dv, causal;
  float scale;
  // element strides: q/k/v/o over (batch, head, position); the last dim
  // is contiguous.  bias is (B, Sk) with row stride bias_b.
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os, bias_b;
};

Args make_args(const int* dims, const long long* strides, float scale) {
  Args a;
  a.B = dims[0]; a.Hq = dims[1]; a.Hkv = dims[2]; a.Sq = dims[3];
  a.Sk = dims[4]; a.Dk = dims[5]; a.Dv = dims[6]; a.causal = dims[7];
  a.scale = scale;
  long long* s[] = {&a.qb, &a.qh, &a.qs, &a.kb, &a.kh, &a.ks, &a.vb,
                    &a.vh, &a.vs, &a.ob, &a.oh, &a.os, &a.bias_b};
  for (int i = 0; i < 13; ++i) *s[i] = strides[i];
  return a;
}

// ---------------------------------------------------------------------------
// float32 route on the CUDA cores
// ---------------------------------------------------------------------------
namespace simt {

constexpr int kThreads = 128;
constexpr int BQ = 32;  // query rows per block, four threads per row
constexpr int BK = 64;  // keys per tile, sixteen per thread

template <int DMAX>
constexpr int smem_floats() {
  return BQ * (DMAX + 1) + BK * (DMAX + 1) + BK * DMAX + BQ * (BK + 1);
}

template <typename TQ, typename TKV, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_simt_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                  const TKV* __restrict__ v, const float* __restrict__ bias,
                  TQ* __restrict__ o, const Args a) {
  extern __shared__ float smem[];
  constexpr int QLD = DMAX + 1, KLD = DMAX + 1, VLD = DMAX, PLD = BK + 1;
  float* qs = smem;             // [BQ][QLD]
  float* ks = qs + BQ * QLD;    // [BK][KLD]
  float* vs = ks + BK * KLD;    // [BK][VLD], zero past Dv
  float* ps = vs + BK * VLD;    // [BQ][PLD]

  const int t = threadIdx.x, r = t >> 2, c4 = t & 3;
  const int b = blockIdx.y / a.Hq, h = blockIdx.y % a.Hq;
  const int hk = h / (a.Hq / a.Hkv);  // the KV head this query head reads
  const int q0 = blockIdx.x * BQ;
  const TQ* qp = q + b * a.qb + h * a.qh;
  const TKV* kp = k + b * a.kb + hk * a.kh;
  const TKV* vp = v + b * a.vb + hk * a.vh;

  for (int i = t; i < BQ * a.Dk; i += kThreads) {
    const int rr = i / a.Dk, d = i - rr * a.Dk;
    qs[rr * QLD + d] =
        q0 + rr < a.Sq ? lm::to_f(qp[(long long)(q0 + rr) * a.qs + d]) : 0.f;
  }
  const int offs = a.Sk - a.Sq;  // queries sit at the end of the keys
  const int qpos = q0 + r;
  // past q0 + BQ - 1 + offs every row of the block is masked
  const int kend = a.causal ? min(a.Sk, q0 + BQ + offs) : a.Sk;

  float m = lm::kNegInf, l = 0.f;
  float acc[DMAX / 4];
#pragma unroll
  for (int j = 0; j < DMAX / 4; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile's reads are done
    for (int i = t; i < BK * a.Dk; i += kThreads) {
      const int kk = i / a.Dk, d = i - kk * a.Dk;
      ks[kk * KLD + d] = k0 + kk < a.Sk
          ? lm::to_f(kp[(long long)(k0 + kk) * a.ks + d]) : 0.f;
    }
    for (int i = t; i < BK * DMAX; i += kThreads) {
      const int kk = i / DMAX, d = i - kk * DMAX;
      vs[kk * VLD + d] = (k0 + kk < a.Sk && d < a.Dv)
          ? lm::to_f(vp[(long long)(k0 + kk) * a.vs + d]) : 0.f;
    }
    __syncthreads();

    float s[BK / 4];
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) s[i] = 0.f;
    for (int d = 0; d < a.Dk; ++d) {
      const float qv = qs[r * QLD + d];
#pragma unroll
      for (int i = 0; i < BK / 4; ++i)
        s[i] = fmaf(qv, ks[(c4 + 4 * i) * KLD + d], s[i]);
    }
    float mloc = lm::kNegInf;
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
      const int kpos = k0 + c4 + 4 * i;
      float x;
      if (kpos >= a.Sk || (a.causal && kpos > qpos + offs)) {
        x = lm::kNegInf;
      } else {
        x = s[i] * a.scale;
        if (bias != nullptr) x += bias[b * a.bias_b + kpos];
      }
      s[i] = x;
      mloc = fmaxf(mloc, x);
    }
    // the four threads of a row are neighbouring lanes of one warp
    mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 1));
    mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 2));
    const float m_new = fmaxf(m, mloc);
    const bool live = m_new > 0.5f * lm::kNegInf;  // some key is unmasked
    float lsum = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
      const float p = live ? expf(s[i] - m_new) : 0.f;
      ps[r * PLD + c4 + 4 * i] = p;
      lsum += p;
    }
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    const float alpha = expf(m - m_new);
    l = alpha * l + lsum;
    m = m_new;
    __syncwarp();  // the row's probabilities are in shared memory

#pragma unroll
    for (int j = 0; j < DMAX / 4; ++j) acc[j] *= alpha;
    for (int kk = 0; kk < BK; ++kk) {
      const float p = ps[r * PLD + kk];
#pragma unroll
      for (int j = 0; j < DMAX / 4; ++j)
        acc[j] = fmaf(p, vs[kk * VLD + c4 + 4 * j], acc[j]);
    }
  }

  if (qpos < a.Sq) {
    const float denom = fmaxf(l, 1e-30f);
    TQ* op = o + b * a.ob + h * a.oh + (long long)qpos * a.os;
#pragma unroll
    for (int j = 0; j < DMAX / 4; ++j) {
      const int c = c4 + 4 * j;
      if (c < a.Dv) op[c] = lm::from_f<TQ>(acc[j] / denom);
    }
  }
}

template <typename TQ, typename TKV, int DMAX>
int launch(const void* q, const void* k, const void* v, const float* bias,
           void* o, const Args& a, cudaStream_t stream) {
  static bool smem_ready = false;
  constexpr int smem = smem_floats<DMAX>() * (int)sizeof(float);
  const int e = lm::allow_smem(flash_simt_kernel<TQ, TKV, DMAX>, smem,
                               &smem_ready);
  if (e != 0) return e;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.B * a.Hq);
  flash_simt_kernel<TQ, TKV, DMAX><<<grid, kThreads, smem, stream>>>(
      (const TQ*)q, (const TKV*)k, (const TKV*)v, bias, (TQ*)o, a);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV>
int launch_d(const void* q, const void* k, const void* v, const float* bias,
             void* o, const Args& a, cudaStream_t stream) {
  const int d = a.Dk > a.Dv ? a.Dk : a.Dv;
  if (d <= 64) return launch<TQ, TKV, 64>(q, k, v, bias, o, a, stream);
  if (d <= 128) return launch<TQ, TKV, 128>(q, k, v, bias, o, a, stream);
  if (d <= 256) return launch<TQ, TKV, 256>(q, k, v, bias, o, a, stream);
  // 188.5 KB of shared memory: MLA's absorbed prefill in float32
  if (d <= 288) return launch<TQ, TKV, 288>(q, k, v, bias, o, a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16 route on the tensor cores
// ---------------------------------------------------------------------------
namespace tc {

using namespace tcore;

constexpr int kWarps = 4;        // warps of a key group, 16 query rows each
constexpr int BQ = 16 * kWarps;  // query rows per block
constexpr int BK = 64;           // keys per tile
constexpr float kLog2e = 1.4426950408889634f;

// Row strides in shared memory: 8 bf16 (16 bytes) of padding shift each
// row by four banks, so the 8 rows an ldmatrix phase reads hit distinct
// banks.
template <int D> constexpr int kLd = D + 8;

// K and V tiles in flight: STAGES-deep ring buffers.
template <int DK, int DV, int STAGES>
constexpr int kSmemBytes =
    (BQ * kLd<DK> + STAGES * BK * (kLd<DK> + kLd<DV>)) * (int)sizeof(bf16);

// 2^x on the special-function unit (2 ulp; ftz: 2^-126 and below give 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Copies rows [r0, r0 + ROWS) of a (., D) bf16 matrix, D <= DMAX, with
// row stride ld_g into shared memory rows of stride LD; rows at or past n
// are zero.  The chunk count is a compile-time constant, so the loop has
// a fixed trip count and divides by a constant.
template <int LD, int ROWS, int DMAX, int NT>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long ld_g, int r0, int n,
                                          int D) {
  constexpr int CH = DMAX / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8;
    if (c < D) {
      const bool valid = r0 + r < n;
      const bf16* s = valid ? src + (long long)(r0 + r) * ld_g + c : src;
      cp_async16(dst + r * LD + c, s, valid);
    }
  }
}

// One block: BQ query rows of one (batch, query head).  KSPLIT key groups
// of kWarps warps each take every KSPLIT-th key tile for the same rows and
// merge their softmax states at the end, so a block's longest chain of
// tiles is 1 / KSPLIT as long.  K and V tiles pass through a STAGES-deep
// ring, one cp.async group per tile.
// One key group (long sequences): at most 170 registers a thread, so
// three blocks share an SM and hide each other's latency.
template <int DK, int DV, int STAGES, int KSPLIT>
__global__ void __launch_bounds__(32 * kWarps * KSPLIT, KSPLIT == 1 && DV <= 64 ? 3 : 1)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const float* __restrict__ bias,
                bf16* __restrict__ o, const Args a, const int n_qblocks) {
  static_assert(STAGES % KSPLIT == 0, "a step takes KSPLIT ring stages");
  constexpr int NT = 32 * kWarps * KSPLIT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LK = kLd<DK>, LV = kLd<DV>;
  // Q's fragments stay in registers where they fit beside O's accumulator
  constexpr bool kQRegs = DK <= 128;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LK]
  bf16* ks = qs + BQ * LK;                       // [STAGES][BK][LK]
  bf16* vs = ks + STAGES * BK * LK;              // [STAGES][BK][LV]

  // blockIdx.x = qb_rev * (B * Hq) + bh: the last q-blocks, which see the
  // most causal tiles, are launched first
  const int bh = blockIdx.x % (a.B * a.Hq);
  const int qb = n_qblocks - 1 - blockIdx.x / (a.B * a.Hq);
  const int b = bh / a.Hq, h = bh % a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = qb * BQ;
  const bf16* qp = q + b * a.qb + h * a.qh;
  const bf16* kp = k + b * a.kb + hk * a.kh;
  const bf16* vp = v + b * a.vb + hk * a.vh;
  const float* bp = bias != nullptr ? bias + b * a.bias_b : nullptr;

  const int warp = (threadIdx.x >> 5) % kWarps;  // the warp's rows
  const int grp = (threadIdx.x >> 5) / kWarps;   // the warp's key group
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row and column pair
  const int offs = a.Sk - a.Sq;            // queries sit at the end of keys
  const int row_lo = q0 + 16 * warp + g, row_hi = row_lo + 8;
  const int kend = a.causal ? min(a.Sk, q0 + BQ + offs) : a.Sk;
  const int n_tiles = kend > 0 ? (kend + BK - 1) / BK : 0;
  // the last key any row of this warp sees
  const int warp_last = q0 + 16 * warp + 15 + offs;
  const float scale_log2 = a.scale * kLog2e;

  float oacc[DV / 8][4];
#pragma unroll
  for (int j = 0; j < DV / 8; ++j)
    oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.f;
  float m_lo = lm::kNegInf, m_hi = lm::kNegInf;  // quad-uniform row max
  float l_lo = 0.f, l_hi = 0.f;                  // this thread's part of l
  uint32_t qf[kQRegs ? DK / 16 : 1][4];

  // prologue: Q and the first STAGES tiles in flight, one group a tile
  if (n_tiles > 0) load_rows<LK, BQ, DK, NT>(qs, qp, a.qs, q0, a.Sq, a.Dk);
  for (int j = 0; j < STAGES && j < n_tiles; ++j) {
    load_rows<LK, BK, DK, NT>(ks + j * BK * LK, kp, a.ks, j * BK, a.Sk, a.Dk);
    load_rows<LV, BK, DV, NT>(vs + j * BK * LV, vp, a.vs, j * BK, a.Sk, a.Dv);
    cp_async_commit();
  }
  for (int t0 = 0; t0 < n_tiles; t0 += KSPLIT) {  // a step: KSPLIT tiles
    // the step's tiles have landed when the groups after them are all
    // that is pending
    cp_async_wait_upto(min(n_tiles, t0 + STAGES) - min(n_tiles, t0 + KSPLIT));
    __syncthreads();  // ... for every thread's copies
    if (kQRegs && t0 == 0) {
#pragma unroll
      for (int kc = 0; kc < DK / 16; ++kc)
        if (kc * 16 < a.Dk)
          ldmatrix_x4(qf[kQRegs ? kc : 0],
                      qs + (16 * warp + (lane & 15)) * LK + kc * 16 +
                          (lane >> 4) * 8);
    }
    const int j = t0 + grp, k0 = j * BK, stage = j % STAGES;
    const bf16* kt = ks + stage * BK * LK;
    const bf16* vt = vs + stage * BK * LV;

    // else past the keys, or wholly above the warp's diagonal
    if (j < n_tiles && !(a.causal && k0 > warp_last)) {
      // S = Q K^T for the warp's 16 rows and the tile's 64 keys
      float s[BK / 8][4];
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < DK / 16; ++kc) {
        if (kc * 16 < a.Dk) {
          uint32_t af[4];
          if (kQRegs) {
#pragma unroll
            for (int r = 0; r < 4; ++r) af[r] = qf[kQRegs ? kc : 0][r];
          } else {
            ldmatrix_x4(af, qs + (16 * warp + (lane & 15)) * LK + kc * 16 +
                                (lane >> 4) * 8);
          }
          uint32_t bfr[BK / 16][4];
#pragma unroll
          for (int n2 = 0; n2 < BK / 16; ++n2)
            ldmatrix_x4(bfr[n2], kt + (n2 * 16 + (lane & 7) +
                                       ((lane >> 4) << 3)) * LK +
                                     kc * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int n2 = 0; n2 < BK / 16; ++n2) {
            mma16816(s[2 * n2], af, bfr[n2][0], bfr[n2][1]);
            mma16816(s[2 * n2 + 1], af, bfr[n2][2], bfr[n2][3]);
          }
        }
      }
      // logits in log2 units; masks only where the tile crosses the
      // diagonal or the ragged end
      const bool masked = k0 + BK > a.Sk ||
                          (a.causal && k0 + BK - 1 > q0 + 16 * warp + offs);
      float mx[BK / 8][2];
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + n * 8 + 2 * t4 + (e & 1);
          const int row = e < 2 ? row_lo : row_hi;
          float x = s[n][e] * scale_log2;
          if (bp != nullptr && key < a.Sk) x = __fmaf_rn(bp[key], kLog2e, x);
          if (masked && (key >= a.Sk || (a.causal && key > row + offs)))
            x = lm::kNegInf;
          s[n][e] = x;
        }
        mx[n][0] = fmaxf(s[n][0], s[n][1]);
        mx[n][1] = fmaxf(s[n][2], s[n][3]);
      }
#pragma unroll
      for (int w = BK / 16; w > 0; w >>= 1) {  // tree over the n-blocks
#pragma unroll
        for (int n = 0; n < w; ++n) {
          mx[n][0] = fmaxf(mx[n][0], mx[n + w][0]);
          mx[n][1] = fmaxf(mx[n][1], mx[n + w][1]);
        }
      }
      float mx_lo = mx[0][0], mx_hi = mx[0][1];
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
      const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
      // a row with no unmasked key yet subtracts +inf: its P is 0
      const float mu_lo = mn_lo > 0.5f * lm::kNegInf ? mn_lo : INFINITY;
      const float mu_hi = mn_hi > 0.5f * lm::kNegInf ? mn_hi : INFINITY;
      const float al_lo = exp2_approx(m_lo - mn_lo);
      const float al_hi = exp2_approx(m_hi - mn_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;
      l_lo *= al_lo;
      l_hi *= al_hi;
#pragma unroll
      for (int j2 = 0; j2 < DV / 8; ++j2) {
        oacc[j2][0] *= al_lo; oacc[j2][1] *= al_lo;
        oacc[j2][2] *= al_hi; oacc[j2][3] *= al_hi;
      }
      // P = exp(S - m) as bf16 A-fragments, 16 keys each; O += P V
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) {
        float p[2][4];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            p[h2][e] = exp2_approx(s[2 * kc + h2][e] - (e < 2 ? mu_lo : mu_hi));
        }
        uint32_t pf[4];
        pf[0] = pack_bf16(p[0][0], p[0][1], &l_lo);
        pf[1] = pack_bf16(p[0][2], p[0][3], &l_hi);
        pf[2] = pack_bf16(p[1][0], p[1][1], &l_lo);
        pf[3] = pack_bf16(p[1][2], p[1][3], &l_hi);
        uint32_t bfr[DV / 16][4];
#pragma unroll
        for (int n2 = 0; n2 < DV / 16; ++n2)
          if (n2 * 16 < a.Dv)
            ldmatrix_x4_trans(bfr[n2], vt + (kc * 16 + (lane & 7) +
                                             ((lane >> 3) & 1) * 8) * LV +
                                           n2 * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int n2 = 0; n2 < DV / 16; ++n2) {
          if (n2 * 16 < a.Dv) {
            mma16816(oacc[2 * n2], pf, bfr[n2][0], bfr[n2][1]);
            mma16816(oacc[2 * n2 + 1], pf, bfr[n2][2], bfr[n2][3]);
          }
        }
      }
    }
    if (t0 + STAGES < n_tiles) {  // the step's stages take the next tiles
      __syncthreads();  // every warp is done with them
      for (int jj = t0 + STAGES; jj < t0 + STAGES + KSPLIT && jj < n_tiles;
           ++jj) {
        const int st = jj % STAGES;
        load_rows<LK, BK, DK, NT>(ks + st * BK * LK, kp, a.ks, jj * BK, a.Sk,
                                  a.Dk);
        load_rows<LV, BK, DV, NT>(vs + st * BK * LV, vp, a.vs, jj * BK, a.Sk,
                                  a.Dv);
        cp_async_commit();
      }
    }
  }

  if (KSPLIT > 1) {
    // merge: each later key group leaves (m, its part of l, O) for the
    // same thread of group 0, in the ring's memory, lane-minor
    constexpr int NV = DV / 2 + 4;  // floats a thread leaves
    float* xs = reinterpret_cast<float*>(ks);
    __syncthreads();  // the ring is free
    if (grp > 0) {
      float* dst = xs + ((grp - 1) * kWarps + warp) * NV * 32 + lane;
      dst[0] = m_lo; dst[32] = m_hi; dst[64] = l_lo; dst[96] = l_hi;
#pragma unroll
      for (int j2 = 0; j2 < DV / 8; ++j2)
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[(4 + 4 * j2 + e) * 32] = oacc[j2][e];
    }
    __syncthreads();
    if (grp > 0) return;
    for (int gi = 1; gi < KSPLIT; ++gi) {
      const float* src = xs + ((gi - 1) * kWarps + warp) * NV * 32 + lane;
      const float mn_lo = fmaxf(m_lo, src[0]), mn_hi = fmaxf(m_hi, src[32]);
      const float a0_lo = exp2_approx(m_lo - mn_lo);
      const float a1_lo = exp2_approx(src[0] - mn_lo);
      const float a0_hi = exp2_approx(m_hi - mn_hi);
      const float a1_hi = exp2_approx(src[32] - mn_hi);
      l_lo = l_lo * a0_lo + src[64] * a1_lo;
      l_hi = l_hi * a0_hi + src[96] * a1_hi;
#pragma unroll
      for (int j2 = 0; j2 < DV / 8; ++j2) {
        const float* so = src + (4 + 4 * j2) * 32;
        oacc[j2][0] = oacc[j2][0] * a0_lo + so[0] * a1_lo;
        oacc[j2][1] = oacc[j2][1] * a0_lo + so[32] * a1_lo;
        oacc[j2][2] = oacc[j2][2] * a0_hi + so[64] * a1_hi;
        oacc[j2][3] = oacc[j2][3] * a0_hi + so[96] * a1_hi;
      }
      m_lo = mn_lo;
      m_hi = mn_hi;
    }
  }

  // l: the quad's four parts; a row with no unmasked key has l = 0 -> 0
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f);
  const float inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
  bf16* op = o + b * a.ob + h * a.oh;
#pragma unroll
  for (int j2 = 0; j2 < DV / 8; ++j2) {
    const int c = j2 * 8 + 2 * t4;
    if (c < a.Dv) {
      if (row_lo < a.Sq)
        *reinterpret_cast<__nv_bfloat162*>(op + (long long)row_lo * a.os + c) =
            __floats2bfloat162_rn(oacc[j2][0] * inv_lo, oacc[j2][1] * inv_lo);
      if (row_hi < a.Sq)
        *reinterpret_cast<__nv_bfloat162*>(op + (long long)row_hi * a.os + c) =
            __floats2bfloat162_rn(oacc[j2][2] * inv_hi, oacc[j2][3] * inv_hi);
    }
  }
}

template <int DK, int DV, int STAGES, int KSPLIT>
int launch(const void* q, const void* k, const void* v, const float* bias,
           void* o, const Args& a, cudaStream_t stream) {
  static bool smem_ready = false;
  constexpr int smem = kSmemBytes<DK, DV, STAGES>;
  static_assert((DV / 2 + 4) * 32 * kWarps * (KSPLIT - 1) * 4 <=
                    STAGES * BK * (kLd<DK> + kLd<DV>) * 2,
                "the merge fits in the ring");
  const int e = lm::allow_smem(flash_tc_kernel<DK, DV, STAGES, KSPLIT>, smem,
                               &smem_ready);
  if (e != 0) return e;
  const int n_qblocks = (a.Sq + BQ - 1) / BQ;
  flash_tc_kernel<DK, DV, STAGES, KSPLIT>
      <<<n_qblocks * a.B * a.Hq, 32 * kWarps * KSPLIT, smem, stream>>>(
          (const bf16*)q, (const bf16*)k, (const bf16*)v, bias, (bf16*)o, a,
          n_qblocks);
  return (int)cudaGetLastError();
}

// Up to 8 key tiles (Sk <= 512, the batcher's longest prompt): two key
// groups of 4 warps and a 4-stage ring (up to 4 tiles, all of them in
// flight at once), so a block's longest chain is half its tiles.  Longer:
// one key group and double-buffered tiles, for more blocks per SM.
template <int DK, int DV>
int launch_split(const void* q, const void* k, const void* v,
                 const float* bias, void* o, const Args& a,
                 cudaStream_t stream) {
  if (a.Sk <= 8 * BK)
    return launch<DK, DV, 4, 2>(q, k, v, bias, o, a, stream);
  return launch<DK, DV, 2, 1>(q, k, v, bias, o, a, stream);
}

}  // namespace tc

}  // namespace

// dims: B, Hq, Hkv, Sq, Sk, Dk, Dv, causal.  strides: qb, qh, qs, kb, kh,
// ks, vb, vh, vs, ob, oh, os, bias_b.  bias may be null.  Returns a CUDA
// error code, 0 on success.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, const void* bias,
                                      void* o, int q_dtype, int kv_dtype,
                                      const int* dims,
                                      const long long* strides, float scale,
                                      void* stream) {
  const Args a = make_args(dims, strides, scale);
  const float* bp = (const float*)bias;
  const cudaStream_t st = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  if (q_dtype == lm::kF32 && kv_dtype == lm::kF32)
    return simt::launch_d<float, float>(q, k, v, bp, o, a, st);
  if (q_dtype == lm::kBF16 && kv_dtype == lm::kBF16)
    return simt::launch_d<bf16, bf16>(q, k, v, bp, o, a, st);
  if (q_dtype == lm::kBF16 && kv_dtype == lm::kF32)
    return simt::launch_d<bf16, float>(q, k, v, bp, o, a, st);
  if (q_dtype == lm::kF32 && kv_dtype == lm::kBF16)
    return simt::launch_d<float, bf16>(q, k, v, bp, o, a, st);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core route: bf16 q, k, v and o; Dk and Dv multiples of 16,
// Dk <= 288 and Dv <= 256; every pointer and row stride 16-byte aligned
// (the wrapper checks).  Same arguments as flash_attention_launch, without the types.
extern "C" int flash_attention_tc_launch(const void* q, const void* k,
                                         const void* v, const void* bias,
                                         void* o, const int* dims,
                                         const long long* strides,
                                         float scale, void* stream) {
  const Args a = make_args(dims, strides, scale);
  const float* bp = (const float*)bias;
  const cudaStream_t st = (cudaStream_t)stream;
  if (a.Dk % 16 || a.Dv % 16) return (int)cudaErrorInvalidValue;
  const int d = a.Dk > a.Dv ? a.Dk : a.Dv;
  if (d <= 64) return tc::launch_split<64, 64>(q, k, v, bp, o, a, st);
  if (d <= 128) return tc::launch_split<128, 128>(q, k, v, bp, o, a, st);
  if (d <= 256) return tc::launch<256, 256, 2, 1>(q, k, v, bp, o, a, st);
  if (a.Dk <= 288 && a.Dv <= 256)
    return tc::launch<288, 256, 2, 1>(q, k, v, bp, o, a, st);
  return (int)cudaErrorInvalidValue;
}

LM_ERROR_STRING(flash_attention)
