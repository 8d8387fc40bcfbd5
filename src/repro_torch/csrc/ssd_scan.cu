// The Mamba2 SSD chunked scan for Hopper, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel ssd_scan / _kernel (src/repro/kernels/ssd_scan.py).
// Same function: per chunk of L positions of one head,
//   y     = ((C B^T) ⊙ exp(segsum(dA))) (x dt) + (C ⊙ exp(cumsum dA)) state^T
//   state = state * exp(sum dA) + ((x dt) ⊙ exp(cs_last - cs))^T B
// with dA = dt * A, B and C broadcast from g groups to h heads, y in x's type
// and the final state in float32.  Arithmetic is float32 on the CUDA cores.
//
// What differs from the TPU kernel, and why:
// - The TPU walks the chunks as a sequential grid dimension and carries the
//   (P, N) state in VMEM scratch.  Blocks on the card run in no order, so the
//   chunk loop is inside the block: one block walks all chunks of its head and
//   keeps its state in shared memory for the whole walk; nothing is written to
//   device memory between chunks.
// - A block holds B^T, C^T (N x L), the L x L decay-masked product, x*dt and
//   the state in float32 shared memory: at L = N = 128 that is 231,552 of the
//   232,448 bytes a block may use, so a block takes 32 of the P columns.  y's
//   and the state's columns depend only on their own columns of x, so P splits
//   across blocks at the cost of recomputing C B^T per split.  Grid:
//   b * h * ceil(P / 32) blocks of 256 threads (160 for mamba2-2.7b at b = 1).
// - The TPU kernel takes exp of the whole L x L difference matrix and masks it
//   after; above the diagonal the difference is positive and can overflow.
//   Here only j <= i is computed and the rest is written as 0.
// - x * dt and dt * A are formed here from x (float32 or bfloat16) and the
//   float32 dt and A, rounding as the wrapper's products on the TPU do.
// - A ragged last chunk is masked: rows past the sequence act as dt = 0, x = 0
//   steps (decay 1, no input), exactly as ops.ssd's padding, for y and state.
// - The kernel starts from a given float32 state, or from zeros.
//
// What bounds it: operations.  Per (head, chunk) the two lower-triangular
// L x L products and the two state products are about 7.4 MFLOP at
// mamba2-2.7b's widths, against a few hundred KB moved.  Each thread computes
// a 4 x 4 register tile of each product from shared memory; row strides are
// odd so column walks are free of bank conflicts.  Tensor cores, TMA and a
// split of the chunk loop (a state pass, then independent chunks) are later
// work.
#include "lm_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPS = 32;     // columns of P per block
constexpr int kLMax = 128;  // the longest chunk the block's cumsum takes

struct Args {
  int b, s, h, p, g, n, L, nps;
  // element strides; the last dim of x, B, C and y is contiguous, the
  // states are contiguous (b, h, p, n)
  long long xb, xs, xh, db, ds, dh, Bb, Bs, Bg, Cb, Cs, Cg, yb, ys, yh;
};

// Shared floats of a block: B^T and C^T [N][L+1], the masked product
// [L][L+1], x*dt [L][kPS], the state [kPS][N+1], the cumsum [L].
inline long long smem_floats(int L, int N) {
  return 2LL * N * (L + 1) + (long long)L * (L + 1) + (long long)L * kPS +
         (long long)kPS * (N + 1) + L;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, const float* __restrict__ init,
           T* __restrict__ y, float* __restrict__ fstate, const Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int L = a.L, N = a.n;
  const int LB = L + 1, NS = N + 1;  // odd strides (L, N multiples of 4)
  float* Bt = smem;                  // [N][LB]  B transposed
  float* Ct = Bt + N * LB;           // [N][LB]  C transposed
  float* M = Ct + N * LB;            // [L][LB]  (C B^T) ⊙ decay, j <= i
  float* xd = M + L * LB;            // [L][kPS] x * dt, 16-byte aligned
  float* st = xd + L * kPS;          // [kPS][NS] the carried state
  float* cs = st + kPS * NS;         // [L] inclusive cumsum of dt * A

  const int t = threadIdx.x;
  const int ps = blockIdx.x % a.nps;
  const int bh = blockIdx.x / a.nps;
  const int hi = bh % a.h, bi = bh / a.h;
  const int gi = hi / (a.h / a.g);
  const int p0 = ps * kPS;
  const float Ah = A[hi];
  const long long state0 = ((long long)bi * a.h + hi) * a.p;

  for (int e = t; e < kPS * N; e += kThreads) {
    const int pp = e / N, nn = e - pp * N;
    st[pp * NS + nn] = (init != nullptr && p0 + pp < a.p)
        ? init[(state0 + p0 + pp) * N + nn] : 0.f;
  }

  const T* xp = x + bi * a.xb + hi * a.xh + p0;
  const float* dp = dt + bi * a.db + hi * a.dh;
  const T* Bp = Bm + bi * a.Bb + gi * a.Bg;
  const T* Cp = Cm + bi * a.Cb + gi * a.Cg;
  T* yp = y + bi * a.yb + hi * a.yh + p0;
  const int T4 = L / 4;       // 4-row tiles of the chunk
  const int P4 = kPS / 4, N4 = N / 4;

  for (int c0 = 0; c0 < a.s; c0 += L) {
    const int rows = min(L, a.s - c0);
    __syncthreads();  // the previous chunk's reads are done
    for (int e = t; e < L * N; e += kThreads) {
      const int l = e / N, nn = e - l * N;
      const bool live = l < rows;
      Bt[nn * LB + l] =
          live ? lm::to_f(Bp[(long long)(c0 + l) * a.Bs + nn]) : 0.f;
      Ct[nn * LB + l] =
          live ? lm::to_f(Cp[(long long)(c0 + l) * a.Cs + nn]) : 0.f;
    }
    for (int e = t; e < L * kPS; e += kThreads) {
      const int l = e / kPS, pp = e - l * kPS;
      xd[e] = (l < rows && p0 + pp < a.p)
          ? lm::to_f(xp[(long long)(c0 + l) * a.xs + pp]) *
                dp[(long long)(c0 + l) * a.ds]
          : 0.f;
    }
    if (t < 32) {  // cs = cumsum(dt * A): 4 rows a lane, then a warp scan
      constexpr int EPL = kLMax / 32;
      float loc[EPL], run = 0.f;
#pragma unroll
      for (int j = 0; j < EPL; ++j) {
        const int l = t * EPL + j;
        run += l < rows ? dp[(long long)(c0 + l) * a.ds] * Ah : 0.f;
        loc[j] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (t >= o) incl += v;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (t == 0) excl = 0.f;
#pragma unroll
      for (int j = 0; j < EPL; ++j) {
        const int l = t * EPL + j;
        if (l < L) cs[l] = excl + loc[j];
      }
    }
    __syncthreads();

    // M[i][j] = (C_i . B_j) * exp(cs_i - cs_j) for j <= i, else 0.  A thread
    // takes rows 4ti..4ti+3 and columns tj + T4 * b, b < nb: the columns a
    // row tile can see.
    for (int q = t; q < T4 * T4; q += kThreads) {
      const int ti = q / T4, tj = q - ti * T4;
      const int nb = min(4, (4 * ti + 3) / T4 + 1);
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[r][b] = 0.f;
      for (int k = 0; k < N; ++k) {
        const float* cr = Ct + k * LB + 4 * ti;
        const float* br = Bt + k * LB + tj;
        float cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = cr[r];
#pragma unroll
        for (int b = 0; b < 4; ++b) bv[b] = b < nb ? br[b * T4] : 0.f;
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (b < nb) acc[r][b] = fmaf(cv[r], bv[b], acc[r][b]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * ti + r;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int j = tj + b * T4;
          M[i * LB + j] = j <= i ? acc[r][b] * expf(cs[i] - cs[j]) : 0.f;
        }
      }
    }
    __syncthreads();

    // y = M xd + exp(cs) ⊙ (C state^T): 4 rows x 4 columns a thread
    for (int q = t; q < T4 * P4; q += kThreads) {
      const int ti = q / P4, tp = q - ti * P4;
      float acc[4][4], off[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = off[r][c] = 0.f;
      const int jend = 4 * ti + 4;
      for (int j = 0; j < jend; ++j) {
        const float4 xv = *reinterpret_cast<const float4*>(xd + j * kPS +
                                                           4 * tp);
        const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float mv = M[(4 * ti + r) * LB + j];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(mv, xs[c], acc[r][c]);
        }
      }
      for (int k = 0; k < N; ++k) {
        float cv[4], sv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = Ct[k * LB + 4 * ti + r];
#pragma unroll
        for (int c = 0; c < 4; ++c) sv[c] = st[(4 * tp + c) * NS + k];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) off[r][c] = fmaf(cv[r], sv[c], off[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * ti + r;
        if (i >= rows) continue;
        const float dec = expf(cs[i]);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int pp = 4 * tp + c;
          if (p0 + pp < a.p)
            yp[(long long)(c0 + i) * a.ys + pp] =
                lm::from_f<T>(acc[r][c] + off[r][c] * dec);
        }
      }
    }
    __syncthreads();

    // decay each row to the chunk's end: xd *= exp(cs_last - cs)
    const float last = cs[L - 1];
    for (int e = t; e < L * kPS; e += kThreads)
      xd[e] = xd[e] * expf(last - cs[e / kPS]);
    __syncthreads();

    // state = state * exp(cs_last) + xd^T B: 4 columns of P x the N
    // columns tn + N4 * b a thread
    const float total = expf(last);
    for (int q = t; q < P4 * N4; q += kThreads) {
      const int tp = q / N4, tn = q - tp * N4;
      float acc[4][4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[c][b] = 0.f;
      for (int l = 0; l < L; ++l) {
        const float4 wv = *reinterpret_cast<const float4*>(xd + l * kPS +
                                                           4 * tp);
        const float ws[4] = {wv.x, wv.y, wv.z, wv.w};
        float bv[4];
#pragma unroll
        for (int b = 0; b < 4; ++b) bv[b] = Bt[(tn + b * N4) * LB + l];
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[c][b] = fmaf(ws[c], bv[b], acc[c][b]);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          float* s = st + (4 * tp + c) * NS + tn + b * N4;
          *s = *s * total + acc[c][b];
        }
    }
  }
  __syncthreads();
  for (int e = t; e < kPS * N; e += kThreads) {
    const int pp = e / N, nn = e - pp * N;
    if (p0 + pp < a.p) fstate[(state0 + p0 + pp) * N + nn] = st[pp * NS + nn];
  }
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* B,
           const void* C, const float* init, void* y, float* fstate,
           const Args& a, cudaStream_t stream) {
  static int smem_set = 48 * 1024;  // the opt-in is per kernel instance
  const long long bytes = smem_floats(a.L, a.n) * (long long)sizeof(float);
  if (bytes > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
    smem_set = (int)bytes;
  }
  ssd_kernel<T><<<a.b * a.h * a.nps, kThreads, bytes, stream>>>(
      (const T*)x, dt, A, (const T*)B, (const T*)C, init, (T*)y, fstate, a);
  return (int)cudaGetLastError();
}

}  // namespace

// dims: b, s, h, p, g, n, L.  strides: xb, xs, xh, db, ds, dh, Bb, Bs, Bg,
// Cb, Cs, Cg, yb, ys, yh.  init may be null (a zero state).  x, B, C and y
// share one type (dtype: lm::kF32 or lm::kBF16); dt, A and the states are
// float32.  Returns a CUDA error code, 0 on success.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* B, const void* C,
                               const void* init, void* y, void* fstate,
                               int dtype, const int* dims,
                               const long long* strides, void* stream) {
  Args a;
  a.b = dims[0]; a.s = dims[1]; a.h = dims[2]; a.p = dims[3];
  a.g = dims[4]; a.n = dims[5]; a.L = dims[6];
  a.nps = (a.p + kPS - 1) / kPS;
  if (a.L % 4 || a.L > kLMax || a.n % 4 || a.g <= 0 || a.h % a.g)
    return (int)cudaErrorInvalidValue;
  long long* s[] = {&a.xb, &a.xs, &a.xh, &a.db, &a.ds, &a.dh, &a.Bb, &a.Bs,
                    &a.Bg, &a.Cb, &a.Cs, &a.Cg, &a.yb, &a.ys, &a.yh};
  for (int i = 0; i < 15; ++i) *s[i] = strides[i];
  const cudaStream_t st = (cudaStream_t)stream;
  const float* d = (const float*)dt;
  const float* Ap = (const float*)A;
  const float* ip = (const float*)init;
  float* fs = (float*)fstate;
  if (dtype == lm::kF32)
    return launch<float>(x, d, Ap, B, C, ip, y, fs, a, st);
  if (dtype == lm::kBF16)
    return launch<__nv_bfloat16>(x, d, Ap, B, C, ip, y, fs, a, st);
  return (int)cudaErrorInvalidValue;
}

LM_ERROR_STRING(ssd_scan)
