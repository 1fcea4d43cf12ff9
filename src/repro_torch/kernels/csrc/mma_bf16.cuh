// Inline-PTX building blocks of the bf16 tensor-core kernels on Hopper
// (sm_90a), shared by the sources that include it: flash_attention.cu's
// forward and flash_attention_bwd.cu's backward.  16-byte cp.async copies
// from global to shared memory, ldmatrix loads of 8 x 8 bf16 tiles (plain
// and transposed), mma.sync.m16n8k16 bf16 x bf16 -> fp32, the bf16 pair
// packing that turns an fp32 C fragment into an A fragment, and the SFU's
// 2^x.
//
// Fragment layouts of m16n8k16 (PTX ISA): lane = 4 g + t.  A (16 x 16):
// a0 (row g, cols 2t, 2t+1), a1 (row g+8, same), a2 (row g, cols 2t+8,
// 2t+9), a3 (row g+8, same).  B (16 x 8): b0 (rows 2t, 2t+1, col g), b1
// (rows 2t+8, 2t+9, col g).  C (16 x 8): c0, c1 (row g, cols 2t, 2t+1),
// c2, c3 (row g+8, same).  So the C fragments of columns 16 s .. 16 s + 7
// and 16 s + 8 .. 16 s + 15 of a product are, packed to bf16, the A
// fragment of k16 step s of the next product: a score tile goes on to the
// next product without a trip through shared memory.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// 2^x by the SFU's ex2.approx (relative error ~2^-22; subnormals flush to
// 0): p is rounded to bf16 (2^-9) right after.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a b, a a 16 x 16 bf16 row fragment, b a 16 x 8 bf16 column
// fragment, c a 16 x 8 fp32 fragment.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as a bf16 pair, round to nearest even; lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

}  // namespace
