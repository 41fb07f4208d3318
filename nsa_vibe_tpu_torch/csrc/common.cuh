// Shared helpers for the NSA serving kernels (sm_90a, plain C interface).
//
// Every kernel takes bf16 or f32 operands (template T), converts them to
// f32 in shared memory, accumulates in f32 and runs its softmax in f32.
// Layouts follow the Python wrappers (ops/cuda/*.py), all contiguous:
//   Q [B,S,G,h,Dk]   K [B,G,S_kv,Dk]   V [B,G,S_kv,Dv]   O [B,S,G,h,Dv]
#pragma once

#include <cfloat>
#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace nsa {

constexpr float NEG = -FLT_MAX;   // finite "masked" logit (as the TPU kernels)
// row statistic of a row with no visible key: exp(s - EMPTY_LSE) == 0 in
// the backward (as the TPU kernels, flash_bwd.py EMPTY_LSE)
constexpr float EMPTY_LSE = 1e30f;
constexpr unsigned FULL = 0xffffffffu;

enum DType : int { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// lse = m + log(l) of a row's online softmax (natural base), or EMPTY_LSE
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? m + logf(l) : EMPTY_LSE;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Number of compressed tokens emitted after s_raw raw tokens.
__device__ __forceinline__ int num_cmp(int s_raw, int l, int d) {
  return s_raw >= l ? (s_raw - l) / d + 1 : 0;
}

// Packed documents: ds [B,S] int32 holds each query token's document start
// (l_sel-aligned, non-decreasing along a row); every kernel that takes ds
// bounds its rows with these two. doc_start: the start of query token t of
// batch row b. doc_lo: the first key a query of a document starting at
// `start` may see, the token `start` in the window stream, the first pooled
// token that starts at or after it, ceil(start / d), in the compressed one
// (cmp). Both grow with t. The document's first selection block is
// start / l_sel.
__device__ __forceinline__ int doc_start(const int* __restrict__ ds, int S, int b, int t) {
  return __ldg(ds + (size_t)b * S + t);
}
__device__ __forceinline__ int doc_lo(int start, bool cmp, int d) {
  return cmp ? (start + d - 1) / d : start;
}

// Online-softmax update of one row by one chunk of up to 32 keys, one key
// per lane. `logit` is this lane's scaled logit (ignored where !vis).
// Updates m/l in shared memory (lane 0 writes) and returns this lane's
// probability p (0 where !vis) and the rescale factor alpha of the old
// accumulators.
__device__ __forceinline__ void online_softmax_step(float logit, bool vis, float* m_row,
                                                    float* l_row, float& p, float& alpha) {
  const int lane = threadIdx.x & 31;
  const float m_old = *m_row;
  const float m_new = fmaxf(m_old, warp_max(vis ? logit : NEG));
  p = vis ? expf(logit - m_new) : 0.f;
  alpha = expf(m_old - m_new);   // m_old == m_new == NEG -> 1; first visible -> 0
  const float psum = warp_sum(p);
  __syncwarp();
  if (lane == 0) {
    *l_row = *l_row * alpha + psum;
    *m_row = m_new;
  }
  __syncwarp();
}

// Load rows [r0, r0+nr) of a [.., n_rows_total, D] tensor slice into a
// shared f32 tile with row pitch `pitch`; rows at or past `r_end` are zeroed
// (their memory may not exist; zero keeps 0 * garbage out of P·V). One
// element per thread per step: for operands of any width (M_csl).
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int pitch, const T* __restrict__ src,
                                          int D, int r0, int nr, int r_end) {
  for (int idx = threadIdx.x; idx < nr * D; idx += blockDim.x) {
    const int r = idx / D, c = idx - r * D;
    const int gr = r0 + r;
    dst[r * pitch + c] = gr < r_end ? to_f(src[(size_t)gr * D + c]) : 0.f;
  }
}

// 16-byte vectors: 4 f32 or 8 bf16 elements.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int E = 4;
  __device__ __forceinline__ static void to_f(const uint4& u, float* out) {
    const float4 f = *reinterpret_cast<const float4*>(&u);
    out[0] = f.x; out[1] = f.y; out[2] = f.z; out[3] = f.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ __forceinline__ static void to_f(const uint4& u, float* out) {
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(b[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

// Stage nr rows of width D into shared f32 rows of pitch `pitch` (a multiple
// of 4) with 16-byte loads; each thread issues U loads before it converts
// and stores any, so U loads per thread are in flight at once. row_ptr(r)
// gives row r's global address, or nullptr for a row to zero. Requires
// D % 8 == 0 and 16-byte aligned rows (checked by the Python wrappers).
template <typename T, int U = 4, typename RowPtr>
__device__ __forceinline__ void load_rows_vec(float* dst, int pitch, RowPtr row_ptr, int D,
                                              int nr) {
  constexpr int E = Vec<T>::E;
  const int vpr = D / E;
  const int total = nr * vpr;
  for (int base = threadIdx.x; base < total; base += U * blockDim.x) {
    uint4 buf[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = base + u * blockDim.x;
      buf[u] = make_uint4(0u, 0u, 0u, 0u);
      if (idx < total) {
        const int r = idx / vpr;
        const T* p = row_ptr(r);
        if (p != nullptr) buf[u] = __ldg(reinterpret_cast<const uint4*>(p + (idx - r * vpr) * E));
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = base + u * blockDim.x;
      if (idx < total) {
        const int r = idx / vpr, c = (idx - r * vpr) * E;
        float f[E];
        Vec<T>::to_f(buf[u], f);
        float4* d4 = reinterpret_cast<float4*>(dst + r * pitch + c);
#pragma unroll
        for (int e = 0; e < E / 4; ++e)
          d4[e] = make_float4(f[4 * e], f[4 * e + 1], f[4 * e + 2], f[4 * e + 3]);
      }
    }
  }
}

// Contiguous rows [r0, r0+nr) of a [rows, D] slice; rows at or past r_end zeroed.
template <typename T, int U = 4>
__device__ __forceinline__ void load_rows_vec(float* dst, int pitch, const T* __restrict__ src,
                                              int D, int r0, int nr, int r_end) {
  load_rows_vec<T, U>(dst, pitch,
                   [&](int r) -> const T* {
                     return r0 + r < r_end ? src + (size_t)(r0 + r) * D : nullptr;
                   },
                   D, nr);
}

// Dot product of two shared f32 rows, D % 4 == 0, both 16-byte aligned.
__device__ __forceinline__ float dot4(const float* a, const float* b, int D) {
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float s = 0.f;
  for (int i = 0; i < D / 4; ++i) {
    const float4 x = a4[i], y = b4[i];
    s = fmaf(x.x, y.x, s);
    s = fmaf(x.y, y.y, s);
    s = fmaf(x.z, y.z, s);
    s = fmaf(x.w, y.w, s);
  }
  return s;
}

// Store 4 f32 values as 4 elements of T (16 bytes of f32, 8 of bf16).
template <typename T>
__device__ __forceinline__ void store4(T* dst, float4 v);
template <> __device__ __forceinline__ void store4<float>(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}
template <> __device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* dst, float4 v) {
  __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(dst);
  d[0] = __floats2bfloat162_rn(v.x, v.y);
  d[1] = __floats2bfloat162_rn(v.z, v.w);
}

// Gate-epilogue fold (nsa.gate_fold), backward side: the one-pass
// backwards of rows 7 and 9 scale each staged dO row r (width D, pitch
// `pitch`; rows [0, nr)) by its gate g(r) in f32 and store the product in
// the tile's type, so a bf16 tile holds (dO * g).astype(bf16), what
// flash_bwd.py:424 and sel_flash.py:781 feed their products; the launch
// then has the bits of the ungated launch on that tensor. A bf16 tile is
// taken 8 elements (16 bytes) at a time, so D % 8 == 0 and 16-byte rows;
// thread t takes the pieces idx = t, t + blockDim.x, ... (row idx / (D/8)),
// as the kernels' cp.async staging loops do, so a thread may scale the
// pieces it staged itself right after cp_async_wait, before the barrier
// that publishes them. The f32 form scales a tile already published.
template <typename GateOf>
__device__ __forceinline__ void gate_rows(float* t, int pitch, int nr, int D, GateOf gate_of) {
  for (int idx = threadIdx.x; idx < nr * D; idx += blockDim.x) {
    const int r = idx / D, c = idx - r * D;
    t[r * pitch + c] = __fmul_rn(t[r * pitch + c], gate_of(r));
  }
}
template <typename GateOf>
__device__ __forceinline__ void gate_rows(__nv_bfloat16* t, int pitch, int nr, int D,
                                          GateOf gate_of) {
  const int v = D / 8;
  for (int idx = threadIdx.x; idx < nr * v; idx += blockDim.x) {
    const int r = idx / v, c = (idx - r * v) * 8;
    const float g = gate_of(r);
    __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(t + r * pitch + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(x[e]);
      x[e] = __floats2bfloat162_rn(__fmul_rn(f.x, g), __fmul_rn(f.y, g));
    }
  }
}

// Sets the kernel's dynamic shared memory and launches it on `grid` blocks
// (none for grid <= 0); returns the cudaError_t of the launch.
template <typename Kernel, typename... Args>
int launch_kernel(Kernel kern, long long grid, int threads, size_t smem, cudaStream_t stream,
                  Args... args) {
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (grid > 0) kern<<<(unsigned)grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// Shared-memory carve-up in floats, each piece rounded up to a multiple of 4
// so that every piece stays 16-byte aligned.
__host__ __device__ constexpr size_t round4(size_t n) { return (n + 3) & ~size_t(3); }

}  // namespace nsa

#define NSA_LAUNCH_CHECK() return static_cast<int>(cudaGetLastError())
