// Tensor-core building blocks shared by the LM kernels: for the bf16 routes
// (flash_attention.cu, fused_mlp.cu) 16-byte cp.async copies into shared
// memory and their waits, ldmatrix fragment loads and the warp-level
// mma.sync m16n8k16 product, bf16 in and float32 accumulate; for float32
// operands (ssd_scan.cu, decode_attention.cu's latent instance) the
// m16n8k8 TF32 product in three passes (3xTF32), about float32's accuracy.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tcore {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zero-fills when !valid (the
// source address is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Waits until at most n of this thread's copy groups are pending (n <= 3).
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n <= 0) cp_async_wait<0>();
  else if (n == 1) cp_async_wait<1>();
  else if (n == 2) cp_async_wait<2>();
  else cp_async_wait<3>();
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col); bf16 in, float32 accumulate.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats -> one register of two bf16 (round to nearest even), lo in
// the low half; also returns the rounded values' sum.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi,
                                              float* rounded_sum) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  *rounded_sum += __low2float(h) + __high2float(h);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// x = hi + lo with hi the TF32 rounding of x (to nearest, ties away) and lo
// the TF32 rounding of what is left; with EXACT, x is known to be a TF32
// value (hi = x, lo = 0, not formed).
template <bool EXACT>
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  if constexpr (EXACT) {
    hi = __float_as_uint(x);
  } else {
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
    const float rest = x - __uint_as_float(hi);
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));
  }
}

// c += a (16 x 8, row) * b (8 x 8, col); TF32 in, float32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A warp's 16 x (8 nt) tile of a product in 3xTF32: acc[j] += the sum over
// k < K (a multiple of 8) of A[m0 + row][k] B[k][n0 + 8 j + col], the
// operands in shared memory: A k-major (a[k lda + m]) with AK, else
// row-major (a[m lda + k]); B k-major (b[k ldb + n]) with BK, else n-major
// (b[n ldb + k]).  A k-major stride of 8 and a row-major one of 4 modulo 32
// words keep a fragment load free of bank conflicts.  acc holds the mma's
// accumulator fragments: acc[j][0..1] in row m0 + lane / 4, acc[j][2..3] in
// row m0 + 8 + lane / 4, columns n0 + 8 j + 2 (lane % 4) and the next.  AX
// (BX): every A (B) value is exact in TF32, as bf16 values are, so its lo
// part is 0 and the products with it are left out.
template <int NT, bool AX, bool BX, bool AK, bool BK>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const float* a,
                                         int lda, int m0, const float* b,
                                         int ldb, int n0, int nt, int K) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tg = lane & 3;
  // element (m0 + g + 8 r, k0 + tg + 4 c) of A, (k0 + tg + 4 c, n0 + g) of B
  const float* ap = AK ? a + tg * lda + m0 + g : a + (m0 + g) * lda + tg;
  const float* bp = BK ? b + tg * ldb + n0 + g : b + (n0 + g) * ldb + tg;
  const int ar = AK ? 8 : 8 * lda, ac = AK ? 4 * lda : 4;
  const int bc = BK ? 4 * ldb : 4, bj = BK ? 8 : 8 * ldb;
  const int ak = AK ? lda : 1, bk = BK ? ldb : 1;
  for (int k0 = 0; k0 < K; k0 += 8) {
    const float* a0 = ap + k0 * ak;
    const float* b0 = bp + k0 * bk;
    unsigned ah[4], al[4];
    split_tf32<AX>(a0[0], ah[0], al[0]);
    split_tf32<AX>(a0[ar], ah[1], al[1]);
    split_tf32<AX>(a0[ac], ah[2], al[2]);
    split_tf32<AX>(a0[ar + ac], ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
        unsigned bh[2], bl[2];
        split_tf32<BX>(b0[j * bj], bh[0], bl[0]);
        split_tf32<BX>(b0[j * bj + bc], bh[1], bl[1]);
        if (!AX) mma_tf32(acc[j], al, bh);  // the small terms first
        if (!BX) mma_tf32(acc[j], ah, bl);
        mma_tf32(acc[j], ah, bh);
      }
    }
  }
}

}  // namespace tcore
