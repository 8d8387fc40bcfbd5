// Decode (single-token) attention for Hopper, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel decode_attention / _kernel
// (src/repro/kernels/decode_attention.py).  Same function: one query token
// per sequence against an S-long KV cache, an additive (B, S) bias (the
// per-slot length mask of continuous batching), an online softmax over key
// tiles, float32 arithmetic, the output in q's type.  As on the TPU, the
// G = Hq / Hkv query heads that share a KV head are the rows of one block's
// tile, so each KV head's cache is read once for all of them.  q and the
// cache may have different types (the serving path has a bfloat16 query
// against a float32 cache): each operand is converted to float32 as it is
// loaded, and nothing is cast before the launch.
//
// What bounds it: the bytes of the cache (B * Hkv * S * (Dk + Dv) elements,
// read once).  Block structure: one block of 128 threads per (batch, KV
// head), the TPU's grid.  A 128-key tile of K and V is staged in shared
// memory; thread t computes key t's G logits; each warp runs the online
// softmax of some rows; the (G, Dv) accumulator is spread over the threads'
// registers.  At 4 slots and 8 KV heads that is 32 blocks on 132 SMs: the
// first redesign is to split S across blocks and merge the partial softmax
// states in a second pass.
#include "lm_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int BK = kThreads;  // keys per tile, one per thread

struct Args {
  int B, Hq, Hkv, S, Dk, Dv;
  float scale;
  // element strides: q/o over (batch, head), k/v over (batch, head,
  // position); the last dim is contiguous.  bias is (B, S), row stride
  // bias_b.
  long long qb, qh, kb, kh, ks, vb, vh, vs, ob, oh, bias_b;
};

template <int GMAX, int DMAX>
constexpr int smem_floats() {
  return GMAX * DMAX + BK * (DMAX + 1) + BK * DMAX + GMAX * BK + 3 * GMAX;
}

template <typename TQ, typename TKV, int GMAX, int DMAX>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
              const TKV* __restrict__ v, const float* __restrict__ bias,
              TQ* __restrict__ o, const Args a) {
  extern __shared__ float smem[];
  constexpr int KLD = DMAX + 1;
  constexpr int EPT = (GMAX * DMAX + kThreads - 1) / kThreads;
  float* qs = smem;                 // [GMAX][DMAX], zero past G and Dk
  float* ks = qs + GMAX * DMAX;     // [BK][KLD]
  float* vs = ks + BK * KLD;        // [BK][DMAX], zero past Dv
  float* ps = vs + BK * DMAX;       // [GMAX][BK] logits, then probabilities
  float* ms = ps + GMAX * BK;       // running max per row
  float* ls = ms + GMAX;            // running sum per row
  float* als = ls + GMAX;           // this tile's rescale per row

  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const int G = a.Hq / a.Hkv;
  const int b = blockIdx.x / a.Hkv, hk = blockIdx.x % a.Hkv;
  const TKV* kp = k + b * a.kb + hk * a.kh;
  const TKV* vp = v + b * a.vb + hk * a.vh;

  for (int i = t; i < GMAX * DMAX; i += kThreads) {
    const int g = i / DMAX, d = i - g * DMAX;
    qs[i] = (g < G && d < a.Dk)
        ? lm::to_f(q[b * a.qb + (long long)(hk * G + g) * a.qh + d]) : 0.f;
  }
  if (t < GMAX) {
    ms[t] = lm::kNegInf;
    ls[t] = 0.f;
  }
  float acc[EPT];
#pragma unroll
  for (int j = 0; j < EPT; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < a.S; k0 += BK) {
    __syncthreads();  // the previous tile's reads are done
    for (int i = t; i < BK * a.Dk; i += kThreads) {
      const int kk = i / a.Dk, d = i - kk * a.Dk;
      ks[kk * KLD + d] = k0 + kk < a.S
          ? lm::to_f(kp[(long long)(k0 + kk) * a.ks + d]) : 0.f;
    }
    for (int i = t; i < BK * DMAX; i += kThreads) {
      const int kk = i / DMAX, d = i - kk * DMAX;
      vs[i] = (k0 + kk < a.S && d < a.Dv)
          ? lm::to_f(vp[(long long)(k0 + kk) * a.vs + d]) : 0.f;
    }
    __syncthreads();

    // key k0 + t against every row of the group
    float s[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) s[g] = 0.f;
    for (int d = 0; d < a.Dk; ++d) {
      const float kv = ks[t * KLD + d];
#pragma unroll
      for (int g = 0; g < GMAX; ++g) s[g] = fmaf(qs[g * DMAX + d], kv, s[g]);
    }
    const int kpos = k0 + t;
    const float bv = (kpos < a.S && bias != nullptr)
        ? bias[b * a.bias_b + kpos] : 0.f;
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
      ps[g * BK + t] = kpos < a.S ? s[g] * a.scale + bv : lm::kNegInf;
    __syncthreads();

    // online softmax, one warp per row
    for (int g = w; g < G; g += kThreads / 32) {
      float x[BK / 32];
      float mloc = lm::kNegInf;
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) {
        x[j] = ps[g * BK + lane + 32 * j];
        mloc = fmaxf(mloc, x[j]);
      }
      mloc = lm::warp_max(mloc);
      const float m_prev = ms[g];
      const float m_new = fmaxf(m_prev, mloc);
      const bool live = m_new > 0.5f * lm::kNegInf;
      float lsum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) {
        const float p = live ? expf(x[j] - m_new) : 0.f;
        ps[g * BK + lane + 32 * j] = p;
        lsum += p;
      }
      lsum = lm::warp_sum(lsum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        als[g] = alpha;
        ls[g] = alpha * ls[g] + lsum;
        ms[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V over this tile
#pragma unroll
    for (int j = 0; j < EPT; ++j) {
      const int e = t + kThreads * j, g = e / DMAX, c = e - g * DMAX;
      if (g < G) {
        float x = acc[j] * als[g];
        for (int kk = 0; kk < BK; ++kk)
          x = fmaf(ps[g * BK + kk], vs[kk * DMAX + c], x);
        acc[j] = x;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < EPT; ++j) {
    const int e = t + kThreads * j, g = e / DMAX, c = e - g * DMAX;
    if (g < G && c < a.Dv)
      o[b * a.ob + (long long)(hk * G + g) * a.oh + c] =
          lm::from_f<TQ>(acc[j] / fmaxf(ls[g], 1e-30f));
  }
}

template <typename TQ, typename TKV, int GMAX, int DMAX>
int launch(const void* q, const void* k, const void* v, const float* bias,
           void* o, const Args& a, cudaStream_t stream) {
  static bool smem_ready = false;
  constexpr int smem = smem_floats<GMAX, DMAX>() * (int)sizeof(float);
  const int e = lm::allow_smem(decode_kernel<TQ, TKV, GMAX, DMAX>, smem,
                               &smem_ready);
  if (e != 0) return e;
  decode_kernel<TQ, TKV, GMAX, DMAX><<<a.B * a.Hkv, kThreads, smem,
                                       stream>>>(
      (const TQ*)q, (const TKV*)k, (const TKV*)v, bias, (TQ*)o, a);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV, int GMAX>
int launch_d(const void* q, const void* k, const void* v, const float* bias,
             void* o, const Args& a, cudaStream_t stream) {
  const int d = a.Dk > a.Dv ? a.Dk : a.Dv;
  if (d <= 64) return launch<TQ, TKV, GMAX, 64>(q, k, v, bias, o, a, stream);
  if (d <= 128)
    return launch<TQ, TKV, GMAX, 128>(q, k, v, bias, o, a, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename TQ, typename TKV>
int launch_g(const void* q, const void* k, const void* v, const float* bias,
             void* o, const Args& a, cudaStream_t stream) {
  const int G = a.Hq / a.Hkv;
  if (G <= 4) return launch_d<TQ, TKV, 4>(q, k, v, bias, o, a, stream);
  if (G <= 8) return launch_d<TQ, TKV, 8>(q, k, v, bias, o, a, stream);
  if (G <= 16) return launch_d<TQ, TKV, 16>(q, k, v, bias, o, a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dims: B, Hq, Hkv, S, Dk, Dv.  strides: qb, qh, kb, kh, ks, vb, vh, vs,
// ob, oh, bias_b.  bias may be null.  Returns a CUDA error code, 0 on
// success.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* bias,
                                       void* o, int q_dtype, int kv_dtype,
                                       const int* dims,
                                       const long long* strides,
                                       float scale, void* stream) {
  Args a;
  a.B = dims[0]; a.Hq = dims[1]; a.Hkv = dims[2]; a.S = dims[3];
  a.Dk = dims[4]; a.Dv = dims[5];
  a.scale = scale;
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
