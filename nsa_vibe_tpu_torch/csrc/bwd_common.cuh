// Shared pieces of the attention backward kernels (banded_bwd.cu,
// sel_attn_bwd.cu, banded_bwd_1p.cu, sel_attn_bwd_1p.cu, win_bwd_diag.cu,
// banded_bwd_mma.cu): the per-chunk arithmetic of the kv-major dK/dV pass,
// the dQ product over a staged key tile, and the deterministic reductions
// of per-split partial dK/dV and of per-slot partial dQ.
//
// Notation (as the TPU kernels, flash_bwd.py): for a visible (row, key)
//   s  = scale * q.k          P  = exp(s - lse[row])   (0 where not visible;
//   dP = dO[row].v            dS = P * (dP - delta[row])   EMPTY_LSE rows -> 0)
//   dV[key] += P dO[row]      dK[key] += scale * dS q[row]
//   dQ[row] += scale * dS k[key]
// All products here are f32 FMAs on operands staged in shared memory as
// f32 (the bf16 selection and banded backward kernels use tensor cores
// instead: tc.cuh; they share only the reductions).
// No float atomics anywhere: every output element is summed by one thread
// in a fixed order, and partial sums across blocks are added by
// `reduce_splits` in split order, so two launches give identical bits.
#pragma once

#include "common.cuh"

namespace nsa {
namespace bwd {

constexpr int THREADS = 256;
constexpr int KC = 64;         // keys per tile / chunk
constexpr int MAX_ROWS = 64;   // query rows (tokens x heads) per chunk
constexpr int SP = KC + 4;     // pitch of the P / dS tiles (float4 rows, fewer bank conflicts)

// Phase A of a chunk: S = Q K^T and dP = dO V^T over `rows` staged query
// rows and KC staged keys, each thread a 4x4 tile (rows ri+16m, keys
// ki+16n), then P and dS per element. vis(r, key) says whether row r sees
// tile key `key` (0..KC-1; keys past the staged count must be invisible).
// Writes P to p_out[r*p_pitch_r + key*p_pitch_k] (when p_out != nullptr)
// and dS likewise; rows >= rows and invisible keys get 0.
template <typename Vis>
__device__ __forceinline__ void scores_and_ds(const float* q_s, const float* do_s, const float* k_s,
                                              const float* v_s, const float* lse_s,
                                              const float* dl_s, int rows, int Dk, int Dv,
                                              int kp, int vp, float scale, Vis vis, float* p_out,
                                              float* ds_out, int pitch_r, int pitch_k) {
  const int tid = threadIdx.x;
  const int ri = tid / 16, ki = tid % 16;
  float sc[4][4], dp[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) sc[m][n] = dp[m][n] = 0.f;
  for (int c = 0; c < Dk; c += 4) {
    float4 qv[4], kv[4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
      qv[m] = *reinterpret_cast<const float4*>(q_s + min(ri + 16 * m, rows - 1) * Dk + c);
#pragma unroll
    for (int n = 0; n < 4; ++n)
      kv[n] = *reinterpret_cast<const float4*>(k_s + (ki + 16 * n) * kp + c);
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        sc[m][n] = fmaf(qv[m].x, kv[n].x, sc[m][n]);
        sc[m][n] = fmaf(qv[m].y, kv[n].y, sc[m][n]);
        sc[m][n] = fmaf(qv[m].z, kv[n].z, sc[m][n]);
        sc[m][n] = fmaf(qv[m].w, kv[n].w, sc[m][n]);
      }
  }
  for (int c = 0; c < Dv; c += 4) {
    float4 ov[4], vv[4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
      ov[m] = *reinterpret_cast<const float4*>(do_s + min(ri + 16 * m, rows - 1) * Dv + c);
#pragma unroll
    for (int n = 0; n < 4; ++n)
      vv[n] = *reinterpret_cast<const float4*>(v_s + (ki + 16 * n) * vp + c);
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        dp[m][n] = fmaf(ov[m].x, vv[n].x, dp[m][n]);
        dp[m][n] = fmaf(ov[m].y, vv[n].y, dp[m][n]);
        dp[m][n] = fmaf(ov[m].z, vv[n].z, dp[m][n]);
        dp[m][n] = fmaf(ov[m].w, vv[n].w, dp[m][n]);
      }
  }
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int r = ri + 16 * m;
    const bool live = r < rows;
    const float lse = live ? lse_s[r] : EMPTY_LSE;
    const float dl = live ? dl_s[r] : 0.f;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int key = ki + 16 * n;
      const float p = (live && vis(r, key)) ? expf(sc[m][n] * scale - lse) : 0.f;
      const int o = r * pitch_r + key * pitch_k;
      if (p_out != nullptr) p_out[o] = p;
      ds_out[o] = p * (dp[m][n] - dl);
    }
  }
}

// Phase C of the kv-major pass: acc[key][dims] += sum over rows r of
// w_s[r][key] * x_s[r][dims] for the KC x D tile of one accumulator (dV
// with w = P, x = dO; dK with w = dS, x = Q). Thread slice e = tid +
// THREADS*i owns keys 4*kq..4*kq+3 and dims 4*c4..4*c4+3, so each step
// reads one float4 of weights and one of x for 16 FMAs.
template <int NS>
__device__ __forceinline__ void accumulate_kv(float4 (&acc)[NS][4], const float* w_s,
                                              const float* x_s, int rows, int D) {
  const int d4 = D / 4;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int e = threadIdx.x + THREADS * i;
    const int kq = e / d4, c4 = e - (e / d4) * d4;
    if (kq >= KC / 4) continue;
    for (int r = 0; r < rows; ++r) {
      const float4 wv = *reinterpret_cast<const float4*>(w_s + r * SP + 4 * kq);
      const float4 xv = *reinterpret_cast<const float4*>(x_s + r * D + 4 * c4);
      const float w4[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        acc[i][k].x = fmaf(w4[k], xv.x, acc[i][k].x);
        acc[i][k].y = fmaf(w4[k], xv.y, acc[i][k].y);
        acc[i][k].z = fmaf(w4[k], xv.z, acc[i][k].z);
        acc[i][k].w = fmaf(w4[k], xv.w, acc[i][k].w);
      }
    }
  }
}

// Writes a kv accumulator (times `mul`) for keys k0 + [0, nk) into out
// [rows of width D, row index (bg_row0 + key)]; OutT is float for a
// per-split partial, T for the final gradient.
template <typename OutT, int NS>
__device__ __forceinline__ void store_kv(float4 (&acc)[NS][4], OutT* out, size_t row0,
                                         int nk, int D, float mul) {
  const int d4 = D / 4;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int e = threadIdx.x + THREADS * i;
    const int kq = e / d4, c4 = e - (e / d4) * d4;
    if (kq >= KC / 4) continue;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int key = 4 * kq + k;
      if (key < nk) {
        const float4 a = acc[i][k];
        store4<OutT>(out + (row0 + key) * D + 4 * c4,
                     make_float4(a.x * mul, a.y * mul, a.z * mul, a.w * mul));
      }
    }
  }
}

// Slices of the kv accumulators a thread owns: KC/4 key quads x D/4 dim
// quads over THREADS threads (1 for D <= 64, 2 for D <= 128).
__host__ __device__ constexpr int kv_slices(int D) {
  return ((KC / 4) * (D / 4) + THREADS - 1) / THREADS;
}

// out[i] = sum over splits s (in order) of part[s * n + i], cast to T.
template <typename T>
__global__ void __launch_bounds__(THREADS)
reduce_splits_kernel(const float* __restrict__ part, T* __restrict__ out, long long n, int nsplit) {
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * THREADS) {
    float a = 0.f;
    for (int s = 0; s < nsplit; ++s) a += part[(size_t)s * n + i];
    out[i] = from_f<T>(a);
  }
}

template <typename T>
int reduce_splits(const float* part, void* out, long long n, int nsplit, cudaStream_t stream) {
  const long long want = (n + THREADS - 1) / THREADS;
  const unsigned grid = (unsigned)(want < 4096 ? want : 4096);
  reduce_splits_kernel<T><<<grid, THREADS, 0, stream>>>(part, static_cast<T*>(out), n, nsplit);
  return static_cast<int>(cudaGetLastError());
}

// acc[row][dims] += sum over keys j < nk of ds_s[row][j] * k_s[j][dims]
// for one staged key tile, with dS row-major ([MAX_ROWS][SP], as
// scores_and_ds writes it with pitch_r = SP) and K rows of pitch kp. Thread
// slice e = tid + THREADS*i owns rows 4*rq..4*rq+3 and dims 4*c4..4*c4+3;
// keys go in fours (dS and the staged K rows are 0 from nk to KC), so each
// step reads 4 float4 of dS and 4 of K for 64 FMAs. Used for dQ by the
// one-pass kernels (a partial per key tile) and the diagonal and two-pass
// dQ kernels (exact).
template <int NS>
__device__ __forceinline__ void accumulate_q_rows(float4 (&acc)[NS][4], const float* ds_s,
                                                  const float* k_s, int nk, int Dk, int kp) {
  const int d4 = Dk / 4;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int e = threadIdx.x + THREADS * i;
    const int rq = e / d4, c4 = e - (e / d4) * d4;
    if (rq >= MAX_ROWS / 4) continue;
    for (int j = 0; j < nk; j += 4) {
      float w[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 dv = *reinterpret_cast<const float4*>(ds_s + (4 * rq + r) * SP + j);
        w[r][0] = dv.x;
        w[r][1] = dv.y;
        w[r][2] = dv.z;
        w[r][3] = dv.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 kv = *reinterpret_cast<const float4*>(k_s + (j + u) * kp + 4 * c4);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[i][r].x = fmaf(w[r][u], kv.x, acc[i][r].x);
          acc[i][r].y = fmaf(w[r][u], kv.y, acc[i][r].y);
          acc[i][r].z = fmaf(w[r][u], kv.z, acc[i][r].z);
          acc[i][r].w = fmaf(w[r][u], kv.w, acc[i][r].w);
        }
      }
    }
  }
}

// out[row][:] = scale * (sum over slots s < count(row), in slot order, of
// ws[s][row][:]) cast to T, for rows [0, rows) of width D (D % 4 == 0). The
// slot stride is rows * D floats; `count` is a functor row -> the number of
// slots the one-pass kernel wrote for that row (0: the row gets zeros).
template <typename T, typename Count>
__global__ void __launch_bounds__(THREADS)
sum_slots_kernel(const float* __restrict__ ws, T* __restrict__ out, long long rows, int D,
                 Count count, float scale) {
  const int d4 = D / 4;
  const long long n = rows * d4;
  const size_t stride = (size_t)rows * D;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * THREADS) {
    const long long row = i / d4;
    const size_t o = (size_t)row * D + (size_t)(i - row * d4) * 4;
    const int ns = count(row);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < ns; ++s) {
      const float4 x = *reinterpret_cast<const float4*>(ws + s * stride + o);
      a.x += x.x;
      a.y += x.y;
      a.z += x.z;
      a.w += x.w;
    }
    store4<T>(out + o, make_float4(a.x * scale, a.y * scale, a.z * scale, a.w * scale));
  }
}

template <typename T, typename Count>
int sum_slots(const float* ws, void* out, long long rows, int D, Count count, float scale,
              cudaStream_t stream) {
  const long long want = (rows * (D / 4) + THREADS - 1) / THREADS;
  const unsigned grid = (unsigned)(want < 8192 ? want : 8192);
  sum_slots_kernel<T, Count><<<grid, THREADS, 0, stream>>>(ws, static_cast<T*>(out), rows, D,
                                                           count, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bwd
}  // namespace nsa
