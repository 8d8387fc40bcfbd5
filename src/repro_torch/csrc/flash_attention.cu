// Flash (streaming) attention for Hopper, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel flash_attention / _kernel
// (src/repro/kernels/flash_attention.py).  Same function: GQA attention
// with an online softmax over key tiles, an additive (B, Sk) bias, an
// optional causal mask, Dv != Dk allowed; float32 arithmetic, the output in
// q's type.  What differs from the TPU kernel:
//   * the causal offset is Sk - Sq (the oracle's, kernels/ref.py), not the
//     padded lengths' difference; pad keys are masked here, not by a padded
//     bias, so any Sq, Sk works (the TPU kernel is wrong when
//     Skp - Sqp != Sk - Sq, e.g. S = 100);
//   * causal blocks stop at the last key any of their rows can see;
//   * a row whose keys are all masked gives 0, as the TPU kernel's clamp of
//     l does.
//
// Block structure: one block of 128 threads per (batch, query head, 32
// query rows).  Four threads share a row: each holds 16 of a 64-key tile's
// logits and a quarter of the row's (Dv) accumulator in registers.  Q, K, V
// and the probabilities of a tile sit in shared memory (rows padded by one
// float so that the dot products read distinct banks).  Float32 math on the
// CUDA cores, no tensor cores, no TMA: at the serving path's shapes (Sq = Sk
// <= 512, D = 64) the work is a few MFLOP per head and launch latency sets
// the floor; the bytes (Q, K, V read once, O written once) bound it at
// under a microsecond.
#include "lm_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int BQ = 32;  // query rows per block, four threads per row
constexpr int BK = 64;  // keys per tile, sixteen per thread

struct Args {
  int B, Hq, Hkv, Sq, Sk, Dk, Dv, causal;
  float scale;
  // element strides: q/k/v/o over (batch, head, position); the last dim
  // is contiguous.  bias is (B, Sk) with row stride bias_b.
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os, bias_b;
};

template <int DMAX>
constexpr int smem_floats() {
  return BQ * (DMAX + 1) + BK * (DMAX + 1) + BK * DMAX + BQ * (BK + 1);
}

template <typename TQ, typename TKV, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
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
  const int e = lm::allow_smem(flash_kernel<TQ, TKV, DMAX>, smem,
                               &smem_ready);
  if (e != 0) return e;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.B * a.Hq);
  flash_kernel<TQ, TKV, DMAX><<<grid, kThreads, smem, stream>>>(
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
  return (int)cudaErrorInvalidValue;
}

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
  Args a;
  a.B = dims[0]; a.Hq = dims[1]; a.Hkv = dims[2]; a.Sq = dims[3];
  a.Sk = dims[4]; a.Dk = dims[5]; a.Dv = dims[6]; a.causal = dims[7];
  a.scale = scale;
  long long* s[] = {&a.qb, &a.qh, &a.qs, &a.kb, &a.kh, &a.ks, &a.vb,
                    &a.vh, &a.vs, &a.ob, &a.oh, &a.os, &a.bias_b};
  for (int i = 0; i < 13; ++i) *s[i] = strides[i];
  const float* bp = (const float*)bias;
  const cudaStream_t st = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  if (q_dtype == lm::kF32 && kv_dtype == lm::kF32)
    return launch_d<float, float>(q, k, v, bp, o, a, st);
  if (q_dtype == lm::kBF16 && kv_dtype == lm::kBF16)
    return launch_d<bf16, bf16>(q, k, v, bp, o, a, st);
  if (q_dtype == lm::kBF16 && kv_dtype == lm::kF32)
    return launch_d<bf16, float>(q, k, v, bp, o, a, st);
  if (q_dtype == lm::kF32 && kv_dtype == lm::kBF16)
    return launch_d<float, bf16>(q, k, v, bp, o, a, st);
  return (int)cudaErrorInvalidValue;
}

LM_ERROR_STRING(flash_attention)
