// The Mamba2 SSD chunked scan for Hopper, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel ssd_scan / _kernel (src/repro/kernels/ssd_scan.py).
// Same function: per chunk of L positions of one head,
//   y     = ((C B^T) ⊙ exp(segsum(dA))) (x dt) + (C ⊙ exp(cumsum dA)) state^T
//   state = state * exp(sum dA) + ((x dt) ⊙ exp(cs_last - cs))^T B
// with dA = dt * A, B and C broadcast from g groups to h heads, y in x's type
// and the final state in float32.
//
// What bounds it: operations.  Per head and chunk of L = 128 rows at
// mamba2-2.7b's widths the masked product and the two state products are
// about 5.3 MFLOP, and C B^T another 2.1 MFLOP per group and chunk, against
// a few hundred KB moved.  The TPU walks the chunks as a sequential grid
// dimension with the state in VMEM; carried over, one block walked all
// chunks of a head, so at b = 1 the card ran 160 blocks (1.2 waves), 16
// chunks deep at s = 2048, and computed C B^T once per head.  Here the same
// function is cut into three passes that one call launches, each parallel
// over everything but what the recurrence orders:
// 1. chunk pass, in parallel over (b, h, chunk, 32 columns of P): the
//    chunk's cumsum of dt * A and its own end state
//    S_c = ((x dt) ⊙ exp(cs_last - cs))^T B, written to a float32 scratch;
//    in the same launch, blocks over (b, group, chunk, 64 x 64 tile) compute
//    C B^T once per group (mamba2 and zamba2 have one group for 80 and 64
//    heads), its lower triangle, into a second scratch.
// 2. state pass, sequential over chunks only, in parallel over (b, h, P, N):
//    state_c = state_{c-1} * exp(cs_last_c) + S_c from init_state or zeros,
//    leaving each chunk's incoming state in the scratch in S_c's place and
//    writing the final state (at s = 2048 the scratch is 16 x 80 x 64 x 128
//    floats, 42 MB).
// 3. output pass, in parallel over (b, h, chunk, 32 columns of P):
//    y = exp(cs) ⊙ (C state_{c-1}^T) + (C B^T ⊙ exp(cs_i - cs_j)) (x dt),
//    accumulated in one set of registers and rounded to x's type once.
// The products run on the tensor cores in 3xTF32: each float32 operand is
// split into its TF32 rounding and the TF32 rounding of the rest, and
// hi*hi + hi*lo + lo*hi is accumulated in float32 by mma.sync m16n8k8, which
// keeps about the float32 product's accuracy (the final state is held to
// 1e-5 of the plain version, also for bf16 inputs; the CPU emulation of the
// split is in tests/test_torch_ssm_kernels.py).  bf16 B and C are exact in
// TF32, so the products with their (zero) lo part are left out: C B^T takes
// one pass in bf16, the two state products two.  A warp owns a 16 x 32 tile
// of a product; its fragments come from float32 tiles in shared memory whose
// row strides keep a fragment load free of bank conflicts, loaded a row at
// a time (coalesced), every load of a tile issued before the first is used.
// Only the lower triangle of the masked product is multiplied (a warp's 16
// rows bound its k loop), and only j <= i of exp(cs_i - cs_j) is taken,
// where the TPU kernel takes exp of the whole difference matrix and masks
// after.  On an H100 the output pass takes about 60 % of a call, its loads
// and exps more than its products (PERF.md).
//
// x * dt and dt * A are formed here from x (float32 or bfloat16) and the
// float32 dt and A, rounding as the wrapper's products on the TPU do.  A
// ragged last chunk is masked: rows past the sequence act as dt = 0, x = 0
// steps (decay 1, no input), exactly as ops.ssd's padding, for y and the
// state.  The scan starts from a given float32 state, or from zeros.
#include "lm_common.cuh"
#include "tensor_core.cuh"

namespace {

using tcore::warp_mma;  // 3xTF32 products: tensor_core.cuh

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPS = 32;     // columns of P per block of passes 1 and 3
constexpr int kLMax = 128;  // the longest chunk the cumsum takes
constexpr int kCB = 64;     // rows and columns of a C B^T tile

struct Args {
  int b, s, h, p, g, n, L;
  int nc, nps, cbt;  // chunks, P tiles, C B^T tiles per chunk
  int L8, N8;        // L and N rounded up to the mma's 8
  int has_init;
  // element strides; the last dim of x, B, C and y is contiguous, the
  // states are contiguous (b, h, p, n)
  long long xb, xs, xh, db, ds, dh, Bb, Bs, Bg, Cb, Cs, Cg, yb, ys, yh;
};

__host__ __device__ __forceinline__ int round8(int v) { return (v + 7) & ~7; }
// Row strides of the tiles: k-major 8, row-major 4 words past a multiple of
// 32 (see warp_mma).
__host__ __device__ __forceinline__ int kstride(int v) {
  return ((v + 31) & ~31) + 8;
}
__host__ __device__ __forceinline__ int rstride(int v) {
  return ((v + 31) & ~31) + 4;
}

// Shared floats of a pass-1 block (a state block's x*dt*decay [L8][kPS],
// B [L8][N8], the cumsum and the decay to the chunk's end [L8]; or a C B^T
// block's B and C rows [kCB][N8]) and of a pass-3 block (the cumsum [L8],
// then C [L8][N8] and the state [kPS][N8], then the masked product^T
// [L8][L8] and x*dt [L8][kPS]), each row padded to its stride.
inline long long pass1_floats(int L, int N) {
  const long long L8 = round8(L), N8 = round8(N);
  const long long st = L8 * kstride(kPS) + L8 * kstride(N8) + 2 * L8;
  const long long cb = 2LL * kCB * rstride(N8);
  return st > cb ? st : cb;
}
inline long long pass3_floats(int L, int N) {
  const long long L8 = round8(L), N8 = round8(N);
  const long long off = (L8 + kPS) * rstride(N8);
  const long long diag = L8 * (kstride(L8) + kstride(kPS));
  return (off > diag ? off : diag) + L8;
}

// cs[l] = cumsum of dt * A over the chunk's rows, rows past s adding 0:
// 4 rows a lane, then a warp scan.  Called by warp 0.
__device__ void chunk_cumsum(float* cs, const float* dp, long long ds,
                             float Ah, int rows, int L8) {
  const int lane = threadIdx.x;
  constexpr int EPL = kLMax / 32;
  float loc[EPL], run = 0.f;
#pragma unroll
  for (int j = 0; j < EPL; ++j) {
    const int l = lane * EPL + j;
    run += l < rows ? dp[(long long)l * ds] * Ah : 0.f;
    loc[j] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
#pragma unroll
  for (int j = 0; j < EPL; ++j) {
    const int l = lane * EPL + j;
    if (l < L8) cs[l] = excl + loc[j];
  }
}

// bf16 inputs (B and C) are exact in TF32.
template <typename T>
constexpr bool kBF16 = sizeof(T) == 2;

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// Four elements of a row as loaded: a float4 of float32, or two words of
// bf16 pairs.
template <typename T> struct Raw4;
template <> struct Raw4<float> { float4 v; };
template <> struct Raw4<__nv_bfloat16> { uint2 v; };
template <typename T> struct XDt { Raw4<T> x; float dt; };

// Elements [c, c + 4) of a row as loaded.  With V one 16-byte (float32) or
// 8-byte (bf16) load: the row and c are 4-element aligned and c + 4 <= lim.
// Else four scalar loads, each index clamped below lim.  Nothing here waits
// for the data, so a thread's loads of a tile all go out before the first
// one is used; masks and conversions come at the store.
template <bool V>
__device__ __forceinline__ Raw4<float> fetch4(const float* row, int c,
                                              int lim) {
  if constexpr (V) {
    return {*reinterpret_cast<const float4*>(row + c)};
  } else {
    return {make_float4(row[min(c, lim - 1)], row[min(c + 1, lim - 1)],
                        row[min(c + 2, lim - 1)], row[min(c + 3, lim - 1)])};
  }
}
template <bool V>
__device__ __forceinline__ Raw4<__nv_bfloat16> fetch4(
    const __nv_bfloat16* row, int c, int lim) {
  if constexpr (V) {
    return {*reinterpret_cast<const uint2*>(row + c)};
  } else {
    const unsigned short* r = reinterpret_cast<const unsigned short*>(row);
    const unsigned e0 = r[min(c, lim - 1)], e1 = r[min(c + 1, lim - 1)];
    const unsigned e2 = r[min(c + 2, lim - 1)], e3 = r[min(c + 3, lim - 1)];
    return {make_uint2(e0 | (e1 << 16), e2 | (e3 << 16))};
  }
}
// The column a unit of 4 loads from: 4 u, kept inside the row with V.
template <bool V>
__device__ __forceinline__ int column(int u, int lim) {
  return V ? min(4 * u, lim - 4) : 4 * u;
}

// The four as float32, those from `valid` on zero (bf16 -> float32 is a
// shift, exact).
__device__ __forceinline__ float4 widen(Raw4<float> r, int valid) {
  return make_float4(valid > 0 ? r.v.x : 0.f, valid > 1 ? r.v.y : 0.f,
                     valid > 2 ? r.v.z : 0.f, valid > 3 ? r.v.w : 0.f);
}
__device__ __forceinline__ float4 widen(Raw4<__nv_bfloat16> r, int valid) {
  return make_float4(valid > 0 ? __uint_as_float(r.v.x << 16) : 0.f,
                     valid > 1 ? __uint_as_float(r.v.x & 0xffff0000u) : 0.f,
                     valid > 2 ? __uint_as_float(r.v.y << 16) : 0.f,
                     valid > 3 ? __uint_as_float(r.v.y & 0xffff0000u) : 0.f);
}
// Elements of a unit of 4 at column 4 u below lim, 0 when its row is out.
__device__ __forceinline__ int valid4(bool row_in, int u, int lim) {
  return row_in ? min(max(lim - 4 * u, 0), 4) : 0;
}

// A tile of n units from device memory into shared memory: each thread
// fetches kU units (fetch(e): loads only, every index valid), then stores
// them (store(e, raw): masks, conversions, arithmetic).
constexpr int kU = 8;
template <typename Fetch, typename Store>
__device__ __forceinline__ void stage(int n, Fetch fetch, Store store) {
  using R = decltype(fetch(0));
  for (int e0 = threadIdx.x; e0 < n; e0 += kThreads * kU) {
    R v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) v[u] = fetch(min(e0 + u * kThreads, n - 1));
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = e0 + u * kThreads;
      if (e < n) store(e, v[u]);
    }
  }
}

__device__ __forceinline__ void put_row(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}

constexpr float4 kZero4 = {0.f, 0.f, 0.f, 0.f};

// A unit of x (4 columns of row e / kP4 of a chunk's kPS-wide P tile, P
// left of lim) and that row's dt; and the four x * dt, zero where masked.
constexpr int kP4 = kPS / 4;
template <bool V, typename T>
__device__ __forceinline__ XDt<T> fetch_xdt(const T* xp, const float* dp,
                                            const Args& a, int e, int rows,
                                            int lim) {
  const int l = min(e / kP4, rows - 1);
  return {fetch4<V>(xp + (long long)l * a.xs, column<V>(e % kP4, lim), lim),
          dp[(long long)l * a.ds]};
}
template <typename T>
__device__ __forceinline__ float4 scale(XDt<T> v, bool row_in, int u,
                                        int lim) {
  float4 f = widen(v.x, valid4(row_in, u, lim));
  f.x *= v.dt; f.y *= v.dt; f.z *= v.dt; f.w *= v.dt;
  return f;
}

// Pass 1.  Blocks [0, b*g*nc*cbt): one 64 x 64 tile of C B^T (stored
// transposed, cb[j][i] = B_j . C_i, tiles with i >= j only).  The rest: the
// end state S_c of one (b, h, chunk) for kPS columns of P, and the chunk's
// cs_last.
template <typename T, bool V>
__global__ void __launch_bounds__(kThreads)
chunk_pass(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, float* __restrict__ cb,
           float* __restrict__ st, float* __restrict__ cl, const Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int t = threadIdx.x, w = t >> 5, L = a.L, N = a.n;
  const int L8 = a.L8, N8 = a.N8, N4 = N8 / 4;
  const int lane = t & 31, g8 = lane >> 2, tg = lane & 3;
  const int n_cb = a.b * a.g * a.nc * a.cbt;

  if ((int)blockIdx.x < n_cb) {
    int tile = blockIdx.x % a.cbt, it = 0;
    const int bgc = blockIdx.x / a.cbt;
    while (tile > it) tile -= ++it;  // (jt, it), jt <= it, row by row
    const int jt = tile;
    const int c = bgc % a.nc, bg = bgc / a.nc;
    const int gi = bg % a.g, bi = bg / a.g;
    const int c0 = c * L, rows = min(L, a.s - c0);
    const int j0 = jt * kCB, i0 = it * kCB;
    const int RS = rstride(N8);
    float* Bn = smem;               // [kCB][RS]  B rows j0..
    float* Cn = Bn + kCB * RS;      // [kCB][RS]  C rows i0..
    const T* Bp = Bm + bi * a.Bb + gi * a.Bg;
    const T* Cp = Cm + bi * a.Cb + gi * a.Cg;
    // unit (r, n4), n4 fastest: a warp reads whole rows
    stage(kCB * N4, [&](int e) {
      const int r = min(j0 + e / N4, rows - 1);
      return fetch4<V>(Bp + (long long)(c0 + r) * a.Bs,
                       column<V>(e % N4, N), N);
    }, [&](int e, Raw4<T> v) {
      const int r = e / N4, n4 = e % N4;
      put_row(Bn + r * RS + 4 * n4, widen(v, valid4(j0 + r < rows, n4, N)));
    });
    stage(kCB * N4, [&](int e) {
      const int r = min(i0 + e / N4, rows - 1);
      return fetch4<V>(Cp + (long long)(c0 + r) * a.Cs,
                       column<V>(e % N4, N), N);
    }, [&](int e, Raw4<T> v) {
      const int r = e / N4, n4 = e % N4;
      put_row(Cn + r * RS + 4 * n4, widen(v, valid4(i0 + r < rows, n4, N)));
    });
    __syncthreads();
    // warp w: rows j0 + 16 (w % 4), columns i0 + 32 (w / 4)
    const int m0 = 16 * (w % 4), n0 = 32 * (w / 4);
    float acc[4][4];
    zero(acc);
    warp_mma<4, kBF16<T>, kBF16<T>, false, false>(acc, Bn, RS, m0, Cn, RS,
                                                  n0, 4, N8);
    float* out = cb + (long long)bgc * L * L;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int jj = j0 + m0 + g8 + 8 * h, ii = i0 + n0 + 8 * j + 2 * tg;
        if (jj < L && ii < L)  // L and ii even: both columns or none
          *reinterpret_cast<float2*>(out + (long long)jj * L + ii) =
              make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
      }
    return;
  }

  const int q = blockIdx.x - n_cb;
  const int ps = q % a.nps, bhc = q / a.nps;
  const int c = bhc % a.nc, bh = bhc / a.nc;
  const int hi = bh % a.h, bi = bh / a.h;
  const int gi = hi / (a.h / a.g);
  const int c0 = c * L, rows = min(L, a.s - c0), p0 = ps * kPS;
  const int XS = kstride(kPS), BS = kstride(N8);
  float* xdd = smem;                // [L8][XS]  x * dt * exp(cs_last - cs)
  float* Bs = xdd + L8 * XS;        // [L8][BS]
  float* cs = Bs + L8 * BS;         // [L8]
  float* dec = cs + L8;             // [L8]  exp(cs_last - cs)
  const float* dp = dt + bi * a.db + hi * a.dh + (long long)c0 * a.ds;
  if (t < 32) chunk_cumsum(cs, dp, a.ds, A[hi], rows, L8);
  const T* Bp = Bm + bi * a.Bb + gi * a.Bg + (long long)c0 * a.Bs;
  stage(L8 * N4, [&](int e) {
    const int l = e / N4;
    return fetch4<V>(Bp + (long long)min(l, rows - 1) * a.Bs,
                     column<V>(e - l * N4, N), N);
  }, [&](int e, Raw4<T> v) {
    const int l = e / N4, n4 = e - l * N4;
    put_row(Bs + l * BS + 4 * n4, widen(v, valid4(l < rows, n4, N)));
  });
  const T* xp = x + bi * a.xb + hi * a.xh + (long long)c0 * a.xs + p0;
  stage(L8 * kP4, [&](int e) {
    return fetch_xdt<V>(xp, dp, a, e, rows, a.p - p0);
  }, [&](int e, XDt<T> v) {
    const int l = e / kP4, u = e - l * kP4;
    put_row(xdd + l * XS + 4 * u, scale(v, l < rows, u, a.p - p0));
  });
  __syncthreads();
  const float last = cs[L - 1];
  if (ps == 0 && t == 0) cl[bhc] = last;
  for (int l = t; l < L8; l += kThreads) dec[l] = expf(last - cs[l]);
  __syncthreads();
  for (int e = t; e < L8 * kPS; e += kThreads) {
    const int l = e / kPS;
    xdd[l * XS + e - l * kPS] *= dec[l];
  }
  __syncthreads();
  // S_c (kPS x N8): warp w takes rows 16 (w % 2) and columns 32 (w / 2),
  // then every 128th column on
  float* out = st + (long long)bhc * a.p * N;
  const int K = round8(rows);
  const int m0 = 16 * (w % 2);
  for (int n0 = 32 * (w / 2); n0 < N8; n0 += 32 * (kWarps / 2)) {
    float acc[4][4];
    zero(acc);
    warp_mma<4, false, kBF16<T>, true, true>(acc, xdd, XS, m0, Bs, BS, n0,
                                             min(4, (N8 - n0) / 8), K);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pp = p0 + m0 + g8 + 8 * h, nn = n0 + 8 * j + 2 * tg;
        if (pp < a.p && nn < N)  // N a multiple of 4: both or none
          *reinterpret_cast<float2*>(out + (long long)pp * N + nn) =
              make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
      }
  }
}

// Pass 2: one float4 of the (P, N) state of one (b, h) a thread, walked
// over the chunks; each chunk's S_c is replaced by its incoming state.
__global__ void __launch_bounds__(kThreads)
state_pass(float* __restrict__ st, const float* __restrict__ cl,
           const float* __restrict__ init, float* __restrict__ fstate,
           const Args a) {
  const long long pn = (long long)a.p * a.n;
  const long long e = 4LL * ((long long)blockIdx.y * kThreads + threadIdx.x);
  if (e >= pn) return;
  const int bh = blockIdx.x;
  float4 state = init != nullptr
      ? *reinterpret_cast<const float4*>(init + bh * pn + e)
      : make_float4(0.f, 0.f, 0.f, 0.f);
  float4* slab = reinterpret_cast<float4*>(st + (long long)bh * a.nc * pn + e);
  const long long step = pn / 4;
  float4 next = slab[0];
  float dnext = cl[(long long)bh * a.nc];
  for (int c = 0; c < a.nc; ++c) {
    const float4 sc = next;
    const float dec = expf(dnext);
    if (c + 1 < a.nc) {  // the next chunk's loads ahead of this store
      next = slab[(c + 1) * step];
      dnext = cl[(long long)bh * a.nc + c + 1];
    }
    slab[c * step] = state;
    state.x = state.x * dec + sc.x;
    state.y = state.y * dec + sc.y;
    state.z = state.z * dec + sc.z;
    state.w = state.w * dec + sc.w;
  }
  *reinterpret_cast<float4*>(fstate + bh * pn + e) = state;
}

// Pass 3: y of one (b, h, chunk) for kPS columns of P.  Warp w owns rows
// 16 w .. 16 w + 15 of the chunk and all kPS columns.
template <typename T, bool V>
__global__ void __launch_bounds__(kThreads)
output_pass(const T* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ A, const T* __restrict__ Cm,
            const float* __restrict__ cb, const float* __restrict__ st,
            const float* __restrict__ init, T* __restrict__ y,
            const Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int t = threadIdx.x, w = t >> 5, L = a.L, N = a.n;
  const int L8 = a.L8, N8 = a.N8, N4 = N8 / 4;
  const int lane = t & 31, g8 = lane >> 2, tg = lane & 3;
  const int ps = blockIdx.x % a.nps, bhc = blockIdx.x / a.nps;
  const int c = bhc % a.nc, bh = bhc / a.nc;
  const int hi = bh % a.h, bi = bh / a.h;
  const int gi = hi / (a.h / a.g);
  const int c0 = c * L, rows = min(L, a.s - c0), p0 = ps * kPS;
  const int LS = kstride(L8), XS = kstride(kPS), RS = rstride(N8);
  float* cs = smem;                 // [L8]
  float* tile = cs + L8;
  const float* dp = dt + bi * a.db + hi * a.dh + (long long)c0 * a.ds;
  if (t < 32) chunk_cumsum(cs, dp, a.ds, A[hi], rows, L8);
  const int m0 = 16 * w;            // this warp's rows
  const bool mine = m0 < L8;
  float acc[4][4];
  zero(acc);

  // the carried state: acc = C state^T, from state_{c-1} (or init_state),
  // then each row times exp(cs_i)
  const float* prev = c > 0 ? st + (long long)bhc * a.p * N
                            : (a.has_init ? init + (long long)bh * a.p * N
                                          : nullptr);
  if (prev != nullptr) {
    float* Cn = tile;               // [L8][RS]  C rows
    float* Pn = Cn + L8 * RS;       // [kPS][RS] state rows
    const T* Cp = Cm + bi * a.Cb + gi * a.Cg + (long long)c0 * a.Cs;
    // unit (row, n4), n4 fastest: a warp reads whole rows
    stage(L8 * N4, [&](int e) {
      return fetch4<V>(Cp + (long long)min(e / N4, rows - 1) * a.Cs,
                       column<V>(e % N4, N), N);
    }, [&](int e, Raw4<T> v) {
      const int l = e / N4, n4 = e % N4;
      put_row(Cn + l * RS + 4 * n4, widen(v, valid4(l < rows, n4, N)));
    });
    stage(kPS * N4, [&](int e) {
      return fetch4<true>(prev + (long long)min(p0 + e / N4, a.p - 1) * N,
                          min(4 * (e % N4), N - 4), N);
    }, [&](int e, Raw4<float> v) {
      const int pp = e / N4, n4 = e % N4;
      put_row(Pn + pp * RS + 4 * n4,
              widen(v, valid4(p0 + pp < a.p, n4, N)));
    });
    __syncthreads();
    if (mine) {
      warp_mma<4, kBF16<T>, false, false, false>(acc, Cn, RS, m0, Pn, RS, 0,
                                                 4, N8);
      const float d0 = expf(cs[m0 + g8]), d1 = expf(cs[m0 + g8 + 8]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[j][0] *= d0; acc[j][1] *= d0;
        acc[j][2] *= d1; acc[j][3] *= d1;
      }
    }
  }
  __syncthreads();  // the cumsum is in; the tiles above are read

  // the chunk itself: acc += (C B^T ⊙ exp(cs_i - cs_j)) (x dt), j <= i
  float* Mt = tile;                 // [L8][LS]  the masked product, j-major
  float* xd = Mt + L8 * LS;         // [L8][XS]  x * dt
  const float* cbp = cb + ((long long)(bi * a.g + gi) * a.nc + c) * L * L;
  const int L4 = L8 / 4;
  // unit (j, 4 columns i), kept where j <= i < rows; a unit wholly above
  // the diagonal is not loaded
  stage(L8 * L4, [&](int e) {
    const int j = min(e / L4, L - 1), i0 = 4 * (e - (e / L4) * L4);
    return i0 + 3 >= j ? fetch4<true>(cbp + (long long)j * L,
                                      min(i0, L - 4), L)
                       : Raw4<float>{kZero4};
  }, [&](int e, Raw4<float> v) {
    const int j = e / L4, i0 = 4 * (e - j * L4);
    float r[4] = {0.f, 0.f, 0.f, 0.f};
    if (i0 + 3 >= j && i0 < rows) {
      const float f[4] = {v.v.x, v.v.y, v.v.z, v.v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u;
        if (j <= i && i < rows) r[u] = f[u] * expf(cs[i] - cs[j]);
      }
    }
    put_row(Mt + j * LS + i0, make_float4(r[0], r[1], r[2], r[3]));
  });
  const T* xp = x + bi * a.xb + hi * a.xh + (long long)c0 * a.xs + p0;
  stage(L8 * kP4, [&](int e) {
    return fetch_xdt<V>(xp, dp, a, e, rows, a.p - p0);
  }, [&](int e, XDt<T> v) {
    const int l = e / kP4, u = e - l * kP4;
    put_row(xd + l * XS + 4 * u, scale(v, l < rows, u, a.p - p0));
  });
  __syncthreads();
  if (!mine) return;
  // rows m0 .. m0 + 15 see keys j < m0 + 16 only
  warp_mma<4, false, false, true, true>(acc, Mt, LS, m0, xd, XS, 0, 4,
                                        min(m0 + 16, L8));

  T* yp = y + bi * a.yb + hi * a.yh + (long long)c0 * a.ys + p0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = m0 + g8 + 8 * h;
      if (i >= rows) continue;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int pp = 8 * j + 2 * tg + u;
        if (p0 + pp < a.p)
          yp[(long long)i * a.ys + pp] = lm::from_f<T>(acc[j][2 * h + u]);
      }
    }
}

// Above 48 KB a kernel's shared memory must be opted into, per instance;
// *set remembers the largest size done.  The SM's L1 / shared split is set
// to the most shared memory, so two blocks of ~93 KB fit an SM.
template <typename Kernel>
int allow(Kernel kernel, long long bytes, int* set) {
  if (bytes <= *set) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  *set = (int)bytes;
  return 0;
}

template <typename T, bool V>
int launch(const void* x, const float* dt, const float* A, const void* B,
           const void* C, const float* init, void* y, float* fstate,
           float* scratch, const Args& a, cudaStream_t stream) {
  static int set1 = 48 * 1024, set3 = 48 * 1024;
  const long long bytes1 = pass1_floats(a.L, a.n) * (long long)sizeof(float);
  const long long bytes3 = pass3_floats(a.L, a.n) * (long long)sizeof(float);
  int e = allow(chunk_pass<T, V>, bytes1, &set1);
  if (e == 0) e = allow(output_pass<T, V>, bytes3, &set3);
  if (e != 0) return e;
  float* cb = scratch;  // [b][g][nc][L][L], then [b][h][nc][p][n], [b][h][nc]
  float* st = cb + (long long)a.b * a.g * a.nc * a.L * a.L;
  float* cl = st + (long long)a.b * a.h * a.nc * a.p * a.n;
  const int per_bh = a.nc * a.nps;
  chunk_pass<T, V><<<a.b * a.g * a.nc * a.cbt + a.b * a.h * per_bh, kThreads,
                  bytes1, stream>>>((const T*)x, dt, A, (const T*)B,
                                    (const T*)C, cb, st, cl, a);
  if ((e = (int)cudaGetLastError()) != 0) return e;
  const long long f4 = (long long)a.p * a.n / 4;
  state_pass<<<dim3(a.b * a.h, (unsigned)((f4 + kThreads - 1) / kThreads)),
               kThreads, 0, stream>>>(st, cl, init, fstate, a);
  if ((e = (int)cudaGetLastError()) != 0) return e;
  output_pass<T, V><<<a.b * a.h * per_bh, kThreads, bytes3, stream>>>(
      (const T*)x, dt, A, (const T*)C, cb, st, init, (T*)y, a);
  return (int)cudaGetLastError();
}

}  // namespace

// dims: b, s, h, p, g, n, L, vec (1 when every row of x, B and C starts
// 4-element aligned, 16 bytes for float32 and 8 for bf16, and p is a
// multiple of 4: every unit of 4 is then one load).  strides: xb, xs, xh, db, ds, dh, Bb, Bs,
// Bg, Cb, Cs, Cg, yb, ys, yh.  init may be null (a zero state).  x, B, C and
// y share one type (dtype: lm::kF32 or lm::kBF16); dt, A and the states are
// float32, the states contiguous and 16-byte aligned.  scratch holds
// b*g*nc*L*L + b*h*nc*p*n + b*h*nc floats (nc = ceil(s / L): C B^T, the
// chunk states, the chunks' cs_last).  Three launches: the chunk, state and
// output passes.  Returns a CUDA error code, 0 on success.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* B, const void* C,
                               const void* init, void* y, void* fstate,
                               void* scratch, int dtype, const int* dims,
                               const long long* strides, void* stream) {
  Args a;
  a.b = dims[0]; a.s = dims[1]; a.h = dims[2]; a.p = dims[3];
  a.g = dims[4]; a.n = dims[5]; a.L = dims[6];
  if (a.L % 4 || a.L > kLMax || a.L <= 0 || a.n % 4 || a.g <= 0 ||
      a.h % a.g || a.s <= 0)
    return (int)cudaErrorInvalidValue;
  a.nc = (a.s + a.L - 1) / a.L;
  a.nps = (a.p + kPS - 1) / kPS;
  const int tiles = (a.L + kCB - 1) / kCB;
  a.cbt = tiles * (tiles + 1) / 2;
  a.L8 = round8(a.L);
  a.N8 = round8(a.n);
  a.has_init = init != nullptr;
  const bool vec = dims[7] != 0;
  long long* s[] = {&a.xb, &a.xs, &a.xh, &a.db, &a.ds, &a.dh, &a.Bb, &a.Bs,
                    &a.Bg, &a.Cb, &a.Cs, &a.Cg, &a.yb, &a.ys, &a.yh};
  for (int i = 0; i < 15; ++i) *s[i] = strides[i];
  const cudaStream_t st = (cudaStream_t)stream;
  const float* d = (const float*)dt;
  const float* Ap = (const float*)A;
  const float* ip = (const float*)init;
  float* fs = (float*)fstate;
  float* sc = (float*)scratch;
  using bf16 = __nv_bfloat16;
  if (dtype == lm::kF32)
    return vec ? launch<float, true>(x, d, Ap, B, C, ip, y, fs, sc, a, st)
               : launch<float, false>(x, d, Ap, B, C, ip, y, fs, sc, a, st);
  if (dtype == lm::kBF16)
    return vec ? launch<bf16, true>(x, d, Ap, B, C, ip, y, fs, sc, a, st)
               : launch<bf16, false>(x, d, Ap, B, C, ip, y, fs, sc, a, st);
  return (int)cudaErrorInvalidValue;
}

LM_ERROR_STRING(ssd_scan)
