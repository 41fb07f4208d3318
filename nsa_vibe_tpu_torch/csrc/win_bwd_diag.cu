// win_bwd_diag: diagonal backward of the sliding-window branch, from the
// forward's row statistics, for f32 operands.
//
// Replaces, for f32 operands: nsa_vibe_tpu/ops/pallas/flash_diag.py::
// flash_banded_bwd_diag (kernel _diag_bwd_kernel), the JAX train step's
// window backward under win.bwd_diag = 1 on the one-pass route (S >= 128).
// bf16 operands (the train step's dtype) take the tensor-core kernel
// win_bwd_diag_mma_kernel of banded_bwd_mma.cu; f32 keeps this FMA kernel,
// since the f32 gates (5e-5 relative) rule out TF32.
//
// What it computes: the same dQ, dK, dV as the one-pass and two-pass
// designs in window mode (banded_bwd_1p.cu, banded_bwd.cu): query token t
// sees keys [max(t-w+1, 0, ds), min(t+1, S_kv)), ds its document start
// (packed documents) or 0; outputs f32, accumulated in f32 (notation:
// bwd_common.cuh).
//
// What bounds it on the H100: ~5 products per visible (row, key) pair at
// the card's f32 FMA rate (67 TFLOP/s, not the tensor cores), and
// shared-memory reads; plus the strips' bytes below. It forms S, P, dP and
// dS once per (row, key) pair.
// Design: q-major, one block per (b, g, q tile of TQ = 64 / h tokens). The
// block stages its 64 query rows in shared memory and streams the tile's
// band [t_first - w + 1, t_last] in 64-key chunks; per chunk it forms P and
// dS once, keeps dQ exact in registers, and sums the chunk's dK/dV over the
// tile's rows in registers. The dK/dV of the band go to a per-tile f32
// strip [B, G, nq, SL, D] (SL = the band's keys rounded up to 64), as the
// TPU kernel's strips (flash_diag.py:363-366); sum_strips
// (banded_common.cuh) adds, for each key, the strips of the tiles whose
// band covers it in ascending tile order (about (w + TQ - 1) / TQ of
// them). The TPU kernel sums its strips with a one-hot matmul, a
// workaround for slow scatters, not ported. No float atomics: two launches
// give identical bits.
#include "banded_common.cuh"

using namespace nsa;
using namespace nsa::bwd;
using namespace nsa::band;

namespace {

// keys of the band of a tile's rows, rounded up to whole 64-key chunks
__host__ __device__ int strip_keys(int TQ, int w, int S_kv) {
  const int band = TQ + w - 1;
  const int most = (band < S_kv ? band : S_kv) + KC - 1;
  return most / KC * KC;
}

template <int NSK, int NSV, int NSQ>
__global__ void __launch_bounds__(THREADS)
win_bwd_diag_kernel(const float* __restrict__ Q, const float* __restrict__ K,
                    const float* __restrict__ V, const float* __restrict__ dO,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const int* __restrict__ ds, float* __restrict__ dQ,
                    float* __restrict__ strip_k, float* __restrict__ strip_v, Params p, int SL) {
  extern __shared__ __align__(16) float smem[];
  const int nq = (p.S + p.TQ - 1) / p.TQ;
  int bid = blockIdx.x;
  const int qt = bid % nq;
  bid /= nq;
  const int g = bid % p.G;
  const int b = bid / p.G;
  const int h = p.h, Dk = p.Dk, Dv = p.Dv;
  const int kp = Dk + 4, vp = Dv + 4;
  const int s0 = qt * p.TQ;
  const int nt = min(p.TQ, p.S - s0);
  const int rows = nt * h;

  const Smem L(MAX_ROWS, Dk, Dv);
  float* q_s = smem + L.q;     // [64][Dk]
  float* do_s = smem + L.dO;   // [64][Dv]
  float* k_s = smem + L.k;
  float* v_s = smem + L.v;
  float* p_s = smem + L.p;     // [64][SP]
  float* ds_s = smem + L.ds;   // [64][SP]
  float* lse_s = smem + L.lse;
  float* dl_s = smem + L.dl;
  int* lo_s = reinterpret_cast<int*>(smem + L.lo);
  int* hi_s = reinterpret_cast<int*>(smem + L.hi);

  stage_rows(p, Q, dO, lse, delta, ds, b, g, s0, nt, q_s, do_s, lse_s, dl_s, lo_s, hi_s);
  float4 q_acc[NSQ][4];
#pragma unroll
  for (int i = 0; i < NSQ; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) q_acc[i][r] = make_float4(0.f, 0.f, 0.f, 0.f);

  // the tile's dense band, also under ds: the strip layout sum_strips
  // reads; each row masks its own document bound (stage_rows)
  int lo_first, hi_last, unused;
  key_range(p, p.t_start + s0, lo_first, unused);
  key_range(p, p.t_start + s0 + nt - 1, unused, hi_last);   // lo and hi never decrease with t
  const float* Kbg = K + ((size_t)b * p.G + g) * p.S_kv * Dk;
  const float* Vbg = V + ((size_t)b * p.G + g) * p.S_kv * Dv;
  const size_t strip0 = (((size_t)b * p.G + g) * nq + qt) * SL;   // strip row of key lo_first

  for (int k0 = lo_first; k0 < hi_last; k0 += KC) {
    const int nk = min(KC, hi_last - k0);
    __syncthreads();   // previous chunk consumed (and the rows staged)
    load_rows_vec<float>(k_s, kp, Kbg, Dk, k0, KC, k0 + nk);
    load_rows_vec<float>(v_s, vp, Vbg, Dv, k0, KC, k0 + nk);
    __syncthreads();
    float4 dk_acc[NSK][4], dv_acc[NSV][4];
#pragma unroll
    for (int i = 0; i < NSK; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) dk_acc[i][k] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < NSV; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) dv_acc[i][k] = make_float4(0.f, 0.f, 0.f, 0.f);
    scores_and_ds(q_s, do_s, k_s, v_s, lse_s, dl_s, rows, Dk, Dv, kp, vp, p.scale,
                  [&](int r, int key) {
                    const int k = k0 + key;
                    return key < nk && k >= lo_s[r] && k < hi_s[r];
                  },
                  p_s, ds_s, SP, 1);
    __syncthreads();
    accumulate_kv<NSV>(dv_acc, p_s, do_s, rows, Dv);
    accumulate_kv<NSK>(dk_acc, ds_s, q_s, rows, Dk);
    accumulate_q_rows<NSQ>(q_acc, ds_s, k_s, nk, Dk, kp);
    store_kv<float, NSK>(dk_acc, strip_k, strip0 + (k0 - lo_first), nk, Dk, 1.f);
    store_kv<float, NSV>(dv_acc, strip_v, strip0 + (k0 - lo_first), nk, Dv, 1.f);
  }
  const int d4 = Dk / 4;
#pragma unroll
  for (int i = 0; i < NSQ; ++i) {
    const int e = threadIdx.x + THREADS * i;
    const int rq = e / d4, c4 = e - (e / d4) * d4;
    if (rq >= MAX_ROWS / 4) continue;
#pragma unroll
    for (int r4 = 0; r4 < 4; ++r4) {
      const int r = 4 * rq + r4;
      if (r < rows) {
        const int ti = r / h;
        const size_t row = (((size_t)b * p.S + s0 + ti) * p.G + g) * h + (r - ti * h);
        const float4 a = q_acc[i][r4];
        store4<float>(dQ + row * Dk + 4 * c4,
                  make_float4(a.x * p.scale, a.y * p.scale, a.z * p.scale, a.w * p.scale));
      }
    }
  }
}

template <int NSK, int NSV>
int launch_ns(const float* Q, const float* K, const float* V, const float* dO, const float* lse,
              const float* delta, const int* ds, float* dQ, float* dK, float* dV,
              float* strip_k, float* strip_v, const Params& p, cudaStream_t stream) {
  const size_t smem = Smem(MAX_ROWS, p.Dk, p.Dv).total * sizeof(float);
  const int SL = strip_keys(p.TQ, p.w, p.S_kv);
  cudaError_t e = cudaFuncSetAttribute(win_bwd_diag_kernel<NSK, NSV, NSK>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long nq = (p.S + p.TQ - 1) / p.TQ;
  const unsigned grid = (unsigned)((long long)p.B * p.G * nq);
  win_bwd_diag_kernel<NSK, NSV, NSK><<<grid, THREADS, smem, stream>>>(
      Q, K, V, dO, lse, delta, ds, dQ, strip_k, strip_v, p, SL);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int rk = sum_strips<float>(strip_k, dK, p, p.Dk, SL, p.scale, 1, stream);
  if (rk != 0) return rk;
  return sum_strips<float>(strip_v, dV, p, p.Dv, SL, 1.f, 1, stream);
}

}  // namespace

extern "C" {

long long nsa_win_bwd_diag_smem_bytes(int Dk, int Dv) {
  return (long long)(Smem(MAX_ROWS, Dk, Dv).total * sizeof(float));
}

int nsa_win_bwd_diag_strip_keys(int TQ, int w, int S_kv) { return strip_keys(TQ, w, S_kv); }

// f32 only. Query row s at position t_start + s. TQ tokens per
// q tile, TQ * h <= 64. ds: [B,S] int32 document
// starts, or null. strip_k / strip_v: f32 scratch of B*G*ceil(S/TQ)*SL*Dk
// (Dv) floats, SL = nsa_win_bwd_diag_strip_keys(TQ, w, S_kv).
int nsa_win_bwd_diag(const float* Q, const float* K, const float* V, const float* dO,
                     const float* lse, const float* delta, const int* ds, float* dQ, float* dK,
                     float* dV, float* strip_k, float* strip_v, int B, int S, int S_kv, int G,
                     int h, int Dk, int Dv, int w, float scale, int t_start, int TQ,
                     void* stream) {
  if (TQ <= 0 || TQ * h > MAX_ROWS || w <= 0 || S <= 0 || S_kv <= 0 || Dk % 8 != 0 ||
      Dv % 8 != 0 || Dk > 128 || Dv > 128 || strip_k == nullptr || strip_v == nullptr ||
      t_start < 0)
    return (int)cudaErrorInvalidValue;
  const Params p{B, S, S_kv, G, h, Dk, Dv, WIN, w, 0, 1, TQ, 1, scale, t_start};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nk = kv_slices(Dk), nv = kv_slices(Dv);
  if (nk == 1 && nv == 1)
    return launch_ns<1, 1>(Q, K, V, dO, lse, delta, ds, dQ, dK, dV, strip_k, strip_v, p, s);
  if (nk == 1)
    return launch_ns<1, 2>(Q, K, V, dO, lse, delta, ds, dQ, dK, dV, strip_k, strip_v, p, s);
  if (nv == 1)
    return launch_ns<2, 1>(Q, K, V, dO, lse, delta, ds, dQ, dK, dV, strip_k, strip_v, p, s);
  return launch_ns<2, 2>(Q, K, V, dO, lse, delta, ds, dQ, dK, dV, strip_k, strip_v, p, s);
}

}  // extern "C"
