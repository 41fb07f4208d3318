// Tensor-core pieces of the bf16 selection and banded kernels
// (sel_attn_fwd_mma.cu, sel_attn_bwd.cu, sel_attn_bwd_1p.cu,
// banded_fwd_mma.cu, banded_bwd_mma.cu): 16-byte cp.async copies, ldmatrix
// loads of mma.sync.m16n8k16 fragments from bf16 tiles in shared memory,
// the bf16 product with f32 accumulation, and packing of f32 results into
// bf16 operand fragments.
//
// Fragments of mma.m16n8k16 (PTX ISA), lane = 4 * g + t:
//   A 16x16 (4 regs of 2 bf16):  a0 (row g,   cols 2t, 2t+1)   a1 (row g+8, cols 2t, 2t+1)
//                                a2 (row g,   cols 2t+8, +9)   a3 (row g+8, cols 2t+8, +9)
//   B 16x8  (2 regs):            b0 (k 2t, 2t+1; col g)        b1 (k 2t+8, 2t+9; col g)
//   C 16x8  (4 f32):             c0, c1 (row g, cols 2t, 2t+1) c2, c3 (row g+8, same cols)
// So the C tiles of n-columns [8j, 8j+16) are, packed to bf16, the A
// fragment of the k-step [8j, 8j+16) of a following product (`a_from_c`).
//
// Tiles in shared memory are bf16, row-major, with a row pitch of D + 8
// elements (a multiple of 8, and 16 bytes more than the data): the eight
// 16-byte rows an ldmatrix phase reads then fall into eight different
// four-bank groups, so no load has a bank conflict.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>

namespace nsa {
namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without the registers; !valid zero-fills them
// (src is then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a * b (bf16 operands, f32 accumulator)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of two bf16 (lo in the low half), round to nearest
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment of the k-step made of C tiles c0 (k 0..7) and c1 (k 8..15)
__device__ __forceinline__ void a_from_c(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Lane addresses of the x4 loads (tile: bf16, row pitch `pitch` elements).
// A fragment of rows [r0, r0+16), cols [c0, c0+16) of a row-major tile.
__device__ __forceinline__ const __nv_bfloat16* a_addr(const __nv_bfloat16* tile, int pitch,
                                                       int r0, int c0) {
  const int lane = threadIdx.x & 31;
  return tile + (r0 + (lane & 15)) * pitch + c0 + (lane >> 4) * 8;
}
// A fragment of rows [m0, m0+16), k [k0, k0+16) from a tile stored
// transposed (tile[k][m]); load with ldsm_x4_t.
__device__ __forceinline__ const __nv_bfloat16* at_addr(const __nv_bfloat16* tile, int pitch,
                                                        int m0, int k0) {
  const int lane = threadIdx.x & 31;
  return tile + (k0 + (lane & 7) + (lane >> 4) * 8) * pitch + m0 + ((lane >> 3) & 1) * 8;
}
// B fragments (b0, b1 of columns n0..n0+7, then of n0+8..n0+15) for
// k [k0, k0+16) from a tile stored [n][k] (the product's B transposed:
// K for S = Q K^T); load with ldsm_x4.
__device__ __forceinline__ const __nv_bfloat16* bn_addr(const __nv_bfloat16* tile, int pitch,
                                                        int n0, int k0) {
  const int lane = threadIdx.x & 31;
  return tile + (n0 + (lane & 7) + (lane >> 4) * 8) * pitch + k0 + ((lane >> 3) & 1) * 8;
}
// The same fragments from a tile stored [k][n] (dO for dV = P^T dO); load
// with ldsm_x4_t.
__device__ __forceinline__ const __nv_bfloat16* bk_addr(const __nv_bfloat16* tile, int pitch,
                                                        int k0, int n0) {
  const int lane = threadIdx.x & 31;
  return tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * pitch + n0 + (lane >> 4) * 8;
}

// acc[NI][4] (M = 16 rows, N = 8*NI) += A (16 x 16*KS, from a_frag(ks)) *
// B, B's fragments from a tile stored [n][k] (bn_addr) or [k][n]
// (bk_addr, kmajor = true). NI even.
template <int NI, int KS, bool KMAJOR, typename AFrag>
__device__ __forceinline__ void mma_tile(float (&acc)[NI][4], AFrag a_frag,
                                         const __nv_bfloat16* b_tile, int pitch) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t a[4];
    a_frag(ks, a);
#pragma unroll
    for (int ni = 0; ni < NI; ni += 2) {
      uint32_t b[4];
      if (KMAJOR)
        ldsm_x4_t(b, bk_addr(b_tile, pitch, 16 * ks, 8 * ni));
      else
        ldsm_x4(b, bn_addr(b_tile, pitch, 8 * ni, 16 * ks));
      mma(acc[ni], a, b[0], b[1]);
      mma(acc[ni + 1], a, b[2], b[3]);
    }
  }
}

}  // namespace tc
}  // namespace nsa
