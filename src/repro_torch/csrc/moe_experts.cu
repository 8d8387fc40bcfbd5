// Grouped SwiGLU experts over a dropless routing (DeepSeek-V2's routed
// experts): every (token, choice) pair runs through its expert, none is
// dropped, and each expert's weights are read once for all of its rows.
//
// The wrapper (kernels/moe_experts.py) sorts the T K choices by expert on
// the device: row p of the sorted order is a choice of expert e when
// offsets[e] <= p < offsets[e + 1], of token rows[p], weighted by gates[p];
// slots[t] holds token t's K rows in ascending order (so its experts in
// ascending id).  Nothing here depends on the host knowing the counts: the
// grids are sized by T alone, a block reads its expert's row range from
// offsets, and a block whose range is empty returns before it reads a
// weight.  So a decode step that calls this is captured in one CUDA graph.
//
// Three launches, each deterministic (no atomics, a fixed order):
// - gate/up: block (64 d_ff columns, expert, row tile) streams the expert's
//   Wg and Wu columns through a cp.async ring, 64 rows of d a step, against
//   the tile's token rows gathered from h; mma.sync m16n8k16, bf16 in,
//   float32 sums; a = silu(g) * u rounded to bf16 into act (R x f);
// - down: block (64 d columns, expert, row tile) the same over act's rows
//   and Wd; y = gate * (a @ Wd) in float32 (R x d);
// - combine: out[t] = 0 + y[slots[t][0]] + ... + y[slots[t][K - 1]].
// A row tile is 16 MT rows; an expert has at most T rows (a token's K
// experts are distinct), so ceil(T / 16 MT) tiles cover any routing.
// What bounds it: the experts' weights, 3 d f bf16 each, read once per row
// tile (a decode step's ~6 rows an expert fit one tile; a long prefill's
// further tiles find the weights in L2).
#include <type_traits>

#include "lm_common.cuh"
#include "tensor_core.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace tcore;

constexpr int kThreads = 128;     // 4 warps, each 16 of a block's columns
constexpr int BK = 64;            // depth of a step
constexpr int BN = 64;            // output columns of a block
constexpr int LDK = BK + 8;       // padded row of a token tile, bf16
constexpr int LDN = BN + 8;       // padded row of a weight tile, bf16
constexpr int STAGES = 4;

struct Args {
  int T, d, f, E, K;
};

// The sorted rows [lo, hi) of expert e that row tile rt covers.
__device__ __forceinline__ bool tile_rows(const int* offsets, int e, int rt,
                                          int BT, int& lo, int& hi) {
  const int begin = offsets[e], end = offsets[e + 1];
  lo = begin + rt * BT;
  hi = min(end, lo + BT);
  return lo < hi;
}

template <int MT>
constexpr int kGateUpSlot = 16 * MT * LDK + 2 * BK * LDN;
template <int MT>
constexpr int kDownSlot = 16 * MT * LDK + BK * LDN;

// A warp's step: acc[m][n] += tile rows 16 m .. (row-major, LDK) times the
// weight tile's columns 16 w + 8 n .. (k-major, LDN), over BK.
template <int MT>
__device__ __forceinline__ void step_mma(float (&acc)[MT][2][4],
                                         const bf16* xt, const bf16* wt,
                                         int w, int lane) {
#pragma unroll
  for (int k16 = 0; k16 < BK / 16; ++k16) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, wt + (k16 * 16 + (lane & 7) +
                               ((lane >> 3) & 1) * 8) * LDN +
                             16 * w + (lane >> 4) * 8);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      uint32_t af[4];
      ldmatrix_x4(af, xt + (16 * m + (lane & 15)) * LDK + k16 * 16 +
                          (lane >> 4) * 8);
      mma16816(acc[m][0], af, b[0], b[1]);
      mma16816(acc[m][1], af, b[2], b[3]);
    }
  }
}

template <int MT>
__global__ void __launch_bounds__(kThreads)
moe_gate_up_kernel(const bf16* __restrict__ h, const int* __restrict__ rows,
                   const int* __restrict__ offsets,
                   const bf16* __restrict__ wg, const bf16* __restrict__ wu,
                   bf16* __restrict__ act, const Args a) {
  constexpr int BT = 16 * MT;
  constexpr int SLOT = kGateUpSlot<MT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // [STAGES][SLOT]
  __shared__ int tok[BT];
  const int f0 = blockIdx.x * BN, e = blockIdx.y;
  int lo, hi;
  if (!tile_rows(offsets, e, blockIdx.z, BT, lo, hi)) return;
  for (int i = threadIdx.x; i < BT; i += kThreads)
    tok[i] = lo + i < hi ? rows[lo + i] : -1;
  __syncthreads();
  const long long per = (long long)a.d * a.f;
  const bf16* wge = wg + e * per;
  const bf16* wue = wu + e * per;
  const int KD = (a.d + BK - 1) / BK;

  // step s's slot: BT token rows, then 64 rows of Wg, then 64 of Wu, each
  // in 16-byte chunks; rows past the tile or past d are zero-filled
  auto issue = [&](int s, bf16* slot) {
    const int k0 = s * BK;
    for (int i = threadIdx.x; i < (BT + 2 * BK) * 8; i += kThreads) {
      const int r = i >> 3, ch = (i & 7) * 8;
      const bf16* src;
      bf16* dst;
      bool valid;
      if (r < BT) {
        const int t = tok[r], col = k0 + ch;
        valid = t >= 0 && col < a.d;
        src = h + (long long)t * a.d + col;
        dst = slot + r * LDK + ch;
      } else {
        const bool up = r >= BT + BK;
        const int kr = r - BT - (up ? BK : 0), row = k0 + kr, col = f0 + ch;
        valid = row < a.d && col < a.f;
        src = (up ? wue : wge) + (long long)row * a.f + col;
        dst = slot + BT * LDK + (up ? BK * LDN : 0) + kr * LDN + ch;
      }
      cp_async16(dst, valid ? src : h, valid);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KD) issue(s, ring + s * SLOT);
    cp_async_commit();
  }
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float gacc[MT][2][4], uacc[MT][2][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) gacc[m][n][j] = uacc[m][n][j] = 0.f;
  for (int s = 0; s < KD; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step s has landed; every warp is done with s - 1
    const int nx = s + STAGES - 1;
    if (nx < KD) issue(nx, ring + (nx % STAGES) * SLOT);
    cp_async_commit();
    const bf16* xt = ring + (s % STAGES) * SLOT;
    step_mma<MT>(gacc, xt, xt + BT * LDK, w, lane);
    step_mma<MT>(uacc, xt, xt + BT * LDK + BK * LDN, w, lane);
  }
  cp_async_wait<0>();  // no copy outlives the block

  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int col = f0 + 16 * w + 8 * n + 2 * t4;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {  // rows g and g + 8
        const int r = lo + 16 * m + g + 8 * hh;
        if (r < hi && col < a.f) {
          float av[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float gv = gacc[m][n][2 * hh + j];
            av[j] = gv / (1.0f + expf(-gv)) * uacc[m][n][2 * hh + j];
          }
          *reinterpret_cast<__nv_bfloat162*>(act + (long long)r * a.f + col) =
              __floats2bfloat162_rn(av[0], av[1]);
        }
      }
    }
}

template <int MT>
__global__ void __launch_bounds__(kThreads)
moe_down_kernel(const bf16* __restrict__ act, const int* __restrict__ offsets,
                const float* __restrict__ gates, const bf16* __restrict__ wd,
                float* __restrict__ y, const Args a) {
  constexpr int BT = 16 * MT;
  constexpr int SLOT = kDownSlot<MT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // [STAGES][SLOT]
  const int d0 = blockIdx.x * BN, e = blockIdx.y;
  int lo, hi;
  if (!tile_rows(offsets, e, blockIdx.z, BT, lo, hi)) return;
  const bf16* wde = wd + e * (long long)a.f * a.d;
  const int KF = (a.f + BK - 1) / BK;

  // step s's slot: the tile's BT rows of act, then 64 rows of Wd
  auto issue = [&](int s, bf16* slot) {
    const int k0 = s * BK;
    for (int i = threadIdx.x; i < (BT + BK) * 8; i += kThreads) {
      const int r = i >> 3, ch = (i & 7) * 8;
      const bf16* src;
      bf16* dst;
      bool valid;
      if (r < BT) {
        const int row = lo + r, col = k0 + ch;
        valid = row < hi && col < a.f;
        src = act + (long long)row * a.f + col;
        dst = slot + r * LDK + ch;
      } else {
        const int kr = r - BT, row = k0 + kr, col = d0 + ch;
        valid = row < a.f && col < a.d;
        src = wde + (long long)row * a.d + col;
        dst = slot + BT * LDK + kr * LDN + ch;
      }
      cp_async16(dst, valid ? src : act, valid);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KF) issue(s, ring + s * SLOT);
    cp_async_commit();
  }
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[MT][2][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][n][j] = 0.f;
  for (int s = 0; s < KF; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nx = s + STAGES - 1;
    if (nx < KF) issue(nx, ring + (nx % STAGES) * SLOT);
    cp_async_commit();
    const bf16* xt = ring + (s % STAGES) * SLOT;
    step_mma<MT>(acc, xt, xt + BT * LDK, w, lane);
  }
  cp_async_wait<0>();

  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int col = d0 + 16 * w + 8 * n + 2 * t4;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = lo + 16 * m + g + 8 * hh;
        if (r < hi && col < a.d) {
          const float gt = gates[r];
          *reinterpret_cast<float2*>(y + (long long)r * a.d + col) =
              make_float2(gt * acc[m][n][2 * hh], gt * acc[m][n][2 * hh + 1]);
        }
      }
    }
}

// out[t] = 0 + y[slots[t][0]] + ... in slot order, 4 columns a thread
__global__ void __launch_bounds__(256)
moe_combine_kernel(const float* __restrict__ y, const int* __restrict__ slots,
                   float* __restrict__ out, const Args a) {
  const int t = blockIdx.x;
  const int* sl = slots + (long long)t * a.K;
  for (int c = 4 * threadIdx.x; c < a.d; c += 4 * 256) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < a.K; ++j) {
      const float4 v =
          *reinterpret_cast<const float4*>(y + (long long)sl[j] * a.d + c);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    *reinterpret_cast<float4*>(out + (long long)t * a.d + c) = s;
  }
}

template <int MT>
int launch(const bf16* h, const int* rows, const int* offsets,
           const float* gates, const int* slots, const bf16* wg,
           const bf16* wu, const bf16* wd, bf16* act, float* y, float* out,
           const Args& a, cudaStream_t stream) {
  static bool up_ok = false, down_ok = false;
  constexpr int up_bytes = 2 * STAGES * kGateUpSlot<MT>;
  constexpr int down_bytes = 2 * STAGES * kDownSlot<MT>;
  int e = lm::allow_smem(moe_gate_up_kernel<MT>, up_bytes, &up_ok);
  if (e == 0) e = lm::allow_smem(moe_down_kernel<MT>, down_bytes, &down_ok);
  if (e != 0) return e;
  const int tiles = (a.T + 16 * MT - 1) / (16 * MT);
  moe_gate_up_kernel<MT>
      <<<dim3((a.f + BN - 1) / BN, a.E, tiles), kThreads, up_bytes, stream>>>(
          h, rows, offsets, wg, wu, act, a);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  moe_down_kernel<MT>
      <<<dim3((a.d + BN - 1) / BN, a.E, tiles), kThreads, down_bytes,
         stream>>>(act, offsets, gates, wd, y, a);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  moe_combine_kernel<<<a.T, 256, 0, stream>>>(y, slots, out, a);
  return (int)cudaGetLastError();
}

}  // namespace

// h: T x d bf16 (the normed tokens); rows, gates: the R = T K sorted
// choices' tokens (int32) and gates (float32); offsets: E + 1 int32;
// slots: T x K int32; wg, wu: E x d x f, wd: E x f x d, bf16; act: R x f
// bf16 and y: R x d float32 scratch; out: T x d float32.  d and f
// multiples of 8, every pointer 16-byte aligned (the wrapper checks); mt:
// 16 mt rows a tile (1, 2 or 4).  Returns a CUDA error code, 0 on success.
extern "C" int moe_experts_launch(const void* h, const void* rows,
                                  const void* offsets, const void* gates,
                                  const void* slots, const void* wg,
                                  const void* wu, const void* wd, void* act,
                                  void* y, void* out, int T, int d, int f,
                                  int E, int K, int mt, void* stream) {
  if (T < 1 || d < 8 || f < 8 || d % 8 || f % 8 || E < 1 || E > 65535 ||
      K < 1 || K > E)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.T = T; a.d = d; a.f = f; a.E = E; a.K = K;
  const cudaStream_t st = (cudaStream_t)stream;
  auto go = [&](auto tag) {
    constexpr int MT = decltype(tag)::value;
    return launch<MT>((const bf16*)h, (const int*)rows, (const int*)offsets,
                      (const float*)gates, (const int*)slots,
                      (const bf16*)wg, (const bf16*)wu, (const bf16*)wd,
                      (bf16*)act, (float*)y, (float*)out, a, st);
  };
  if (mt == 1) return go(std::integral_constant<int, 1>{});
  if (mt == 2) return go(std::integral_constant<int, 2>{});
  if (mt == 4) return go(std::integral_constant<int, 4>{});
  return (int)cudaErrorInvalidValue;
}

LM_ERROR_STRING(moe_experts)
