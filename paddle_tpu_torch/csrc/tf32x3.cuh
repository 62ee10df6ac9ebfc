// Helpers shared by the 3xTF32 tensor-core kernels of this directory
// (flash_attention.cu's forward, conv1x1_bwd.cu, lstm_cell.cu): cp.async
// copies into shared memory, the 3xTF32 operand split and the m16n8k8
// TF32 product.
// Sources include it by its relative name; kernels/_build.py hashes it
// with every source, so an edit here rebuilds them all.

#pragma once

#include <cuda_runtime.h>

namespace tf32x3 {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// asynchronous copy of 16 or 4 bytes, zero-filled when !ok (src is then
// any valid address)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 3xTF32: a = big + small exactly, big = a cut to TF32's 10 mantissa
// bits (one AND), small = the rest, of which the tensor core reads the
// top 10 bits; small*big + big*small + big*big then carries a product
// to about 2^-20 of |a b|. One rule for both kernels. Rounding big
// (cvt.rna.tf32.f32) halves that error, but costs both kernels time
// (PERF.md), and neither needs it: B1 stays within 7.2e-6 of its
// plain version against a 1e-5 tolerance, B8's dw within 6e-7 of
// max|dw| of float64, closer than the cuBLAS einsums (conv1x1_bwd.cu).
__device__ __forceinline__ void split(float v, unsigned& big,
                                      unsigned& small) {
  big = __float_as_uint(v) & 0xffffe000u;
  small = __float_as_uint(v - __uint_as_float(big));
}
// c += a b, one m16n8k8 TF32 product with float32 accumulation
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace tf32x3
