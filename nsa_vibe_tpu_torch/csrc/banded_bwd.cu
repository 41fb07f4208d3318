// banded_bwd: backward of the window and compressed-prefix attention
// branches (mode WIN or CMP), from the forward's row statistics.
//
// Replaces: nsa_vibe_tpu/ops/pallas/flash_bwd.py::flash_banded_bwd (kernels
// _dq_kernel and _dkv_kernel: the two-pass design, q-major dQ and kv-major
// dK/dV), which the JAX train step runs for the window and compressed
// branches under bwd.onepass = 0 (ops/tuning.py).
//
// What it computes, for query rows (token t, head j of group g) with
// visible keys [lo(t), hi(t)):
//   WIN: lo = max(t-w+1, 0), hi = min(t+1, S_kv)
//   CMP: lo = 0, hi = min(num_cmp(t+1), S_kv)   (empty for t < l-1)
// dQ, dK, dV of O = softmax(scale Q K^T) V given dO, lse (EMPTY_LSE on rows
// with no key: they get dQ = 0 and add nothing) and delta = rowsum(dO*O);
// outputs in the operands' dtype, accumulated in f32 (notation:
// bwd_common.cuh).
//
// What bounds it on the H100: at the m7c training shape (B=8, S=2048,
// G=2, h=6, D=64, w=512) the window backward is ~5 products over ~88 M
// visible (row, key) pairs, ~113 GFLOP against ~60 MB of operands: the
// tensor cores bound it (~0.11 ms). This f32 FMA design is bound by FMA
// issue and shared-memory reads instead, and recomputes S and dP once in
// each of its two passes.
// Design: the TPU kernel's dQ ring (one kv-major grid carrying dQ tiles in
// VMEM across steps) has no counterpart across GPU blocks, so there are two
// passes and no float atomics:
//   dQ  (q-major): one block per (b, g, tile of TQ tokens x h heads <= 64
//       rows) streams the tile's band of keys, 64 per chunk, through shared
//       memory; dS goes to a key-major tile and dQ stays in registers
//       (4 rows x 4 dims per thread).
//   dKV (kv-major): one block per (b, g, tile of 64 keys, split) keeps its
//       K/V tile in shared memory and streams the query rows that see it
//       (WIN: t in [k0, k1-1+w-1]; CMP: t >= k0*d + l - 1), TQ tokens per
//       chunk, split into `nsplit` contiguous token ranges so that enough
//       blocks fill the card; dK and dV stay in registers (4 keys x 4 dims
//       per thread). With nsplit > 1 each split writes an f32 partial and
//       `reduce_splits` adds them in split order.
// tensor-core (mma/wgmma) tiles are later work.
#include "bwd_common.cuh"

using namespace nsa;
using namespace nsa::bwd;

namespace {

enum Mode : int { WIN = 0, CMP = 1 };

struct Params {
  int B, S, S_kv, G, h, Dk, Dv, mode, w, l, d, TQ, nsplit;
  float scale;
};

// keys [lo, hi) that query token t sees
__device__ __forceinline__ void key_range(const Params& p, int t, int& lo, int& hi) {
  if (p.mode == WIN) {
    lo = max(t - p.w + 1, 0);
    hi = min(t + 1, p.S_kv);
  } else {
    lo = 0;
    hi = min(num_cmp(t + 1, p.l, p.d), p.S_kv);
  }
}

// query tokens [t_lo, t_hi] that see at least one key of [k0, k1), k1 > k0
__device__ __forceinline__ void token_range(const Params& p, int k0, int k1, int& t_lo,
                                            int& t_hi) {
  if (p.mode == WIN) {
    t_lo = k0;
    t_hi = min(k1 - 1 + p.w - 1, p.S - 1);
  } else {
    t_lo = k0 * p.d + p.l - 1;
    t_hi = p.S - 1;
  }
}

// shared-memory carve-up (floats); the two passes use the same layout
struct Smem {
  size_t q, dO, k, v, p, ds, lse, dl, lo, hi, total;
  __host__ __device__ Smem(int Dk, int Dv) {
    q = 0;
    dO = q + round4((size_t)MAX_ROWS * Dk);
    k = dO + round4((size_t)MAX_ROWS * Dv);
    v = k + round4((size_t)KC * (Dk + 4));
    p = v + round4((size_t)KC * (Dv + 4));
    ds = p + round4((size_t)MAX_ROWS * SP);
    lse = ds + round4((size_t)MAX_ROWS * SP);
    dl = lse + MAX_ROWS;
    lo = dl + MAX_ROWS;   // ints
    hi = lo + MAX_ROWS;   // ints
    total = hi + MAX_ROWS;
  }
};

// Stages the query rows of tokens [t0, t0+nt) of (b, g): Q and dO rows,
// lse, delta and each row's visible key range.
template <typename T>
__device__ __forceinline__ void stage_rows(const Params& p, const T* Q, const T* dO,
                                           const float* lse, const float* delta, int b, int g,
                                           int t0, int nt, float* q_s, float* do_s,
                                           float* lse_s, float* dl_s, int* lo_s, int* hi_s) {
  const int h = p.h;
  auto row_of = [&](int r) -> size_t {
    const int i = r / h;
    return (((size_t)b * p.S + t0 + i) * p.G + g) * h + (r - i * h);
  };
  const int rows = nt * h;
  load_rows_vec<T>(q_s, p.Dk, [&](int r) -> const T* { return Q + row_of(r) * p.Dk; }, p.Dk,
                   rows);
  load_rows_vec<T>(do_s, p.Dv, [&](int r) -> const T* { return dO + row_of(r) * p.Dv; }, p.Dv,
                   rows);
  for (int r = threadIdx.x; r < rows; r += THREADS) {
    const size_t o = row_of(r);
    lse_s[r] = lse[o];
    dl_s[r] = delta[o];
    key_range(p, t0 + r / h, lo_s[r], hi_s[r]);
  }
}

// dQ[row] += dS[row][key] k[key] over the staged keys: thread slice e owns
// rows 4*rq..4*rq+3 (read as one float4 of the key-major dS tile) and dims
// 4*c4..4*c4+3 (one float4 of the K row).
template <int NS>
__device__ __forceinline__ void accumulate_q(float4 (&acc)[NS][4], const float* ds_t,
                                             const float* k_s, int nk, int Dk, int kp) {
  const int d4 = Dk / 4;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int e = threadIdx.x + THREADS * i;
    const int rq = e / d4, c4 = e - (e / d4) * d4;
    if (rq >= MAX_ROWS / 4) continue;
    for (int j = 0; j < nk; ++j) {
      const float4 dv = *reinterpret_cast<const float4*>(ds_t + j * SP + 4 * rq);
      const float4 kv = *reinterpret_cast<const float4*>(k_s + j * kp + 4 * c4);
      const float d4v[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[i][r].x = fmaf(d4v[r], kv.x, acc[i][r].x);
        acc[i][r].y = fmaf(d4v[r], kv.y, acc[i][r].y);
        acc[i][r].z = fmaf(d4v[r], kv.z, acc[i][r].z);
        acc[i][r].w = fmaf(d4v[r], kv.w, acc[i][r].w);
      }
    }
  }
}

template <typename T, int NS>
__global__ void __launch_bounds__(THREADS)
banded_bwd_dq_kernel(const T* __restrict__ Q, const T* __restrict__ K, const T* __restrict__ V,
                     const T* __restrict__ dO, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dQ, Params p) {
  extern __shared__ __align__(16) float smem[];
  const int nq = (p.S + p.TQ - 1) / p.TQ;
  int bid = blockIdx.x;
  const int qt = bid % nq;
  bid /= nq;
  const int g = bid % p.G;
  const int b = bid / p.G;
  const int s0 = qt * p.TQ;
  const int nt = min(p.TQ, p.S - s0);
  const int h = p.h, Dk = p.Dk, Dv = p.Dv;
  const int rows = nt * h;
  const int kp = Dk + 4, vp = Dv + 4;

  const Smem L(Dk, Dv);
  float* q_s = smem + L.q;
  float* do_s = smem + L.dO;
  float* k_s = smem + L.k;
  float* v_s = smem + L.v;
  float* ds_t = smem + L.ds;   // [KC][SP]: dS key-major, rows along the pitch
  float* lse_s = smem + L.lse;
  float* dl_s = smem + L.dl;
  int* lo_s = reinterpret_cast<int*>(smem + L.lo);
  int* hi_s = reinterpret_cast<int*>(smem + L.hi);

  stage_rows<T>(p, Q, dO, lse, delta, b, g, s0, nt, q_s, do_s, lse_s, dl_s, lo_s, hi_s);
  float4 acc[NS][4];
#pragma unroll
  for (int i = 0; i < NS; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[i][r] = make_float4(0.f, 0.f, 0.f, 0.f);

  int lo_first, hi_last, unused;
  key_range(p, s0, lo_first, unused);
  key_range(p, s0 + nt - 1, unused, hi_last);   // lo and hi never decrease with t
  const T* Kbg = K + ((size_t)b * p.G + g) * p.S_kv * Dk;
  const T* Vbg = V + ((size_t)b * p.G + g) * p.S_kv * Dv;

  for (int k0 = lo_first; k0 < hi_last; k0 += KC) {
    const int nk = min(KC, hi_last - k0);
    __syncthreads();   // previous chunk consumed (and the rows staged)
    load_rows_vec<T>(k_s, kp, Kbg, Dk, k0, KC, k0 + nk);
    load_rows_vec<T>(v_s, vp, Vbg, Dv, k0, KC, k0 + nk);
    __syncthreads();
    scores_and_ds(q_s, do_s, k_s, v_s, lse_s, dl_s, rows, Dk, Dv, kp, vp, p.scale,
                  [&](int r, int key) {
                    const int k = k0 + key;
                    return key < nk && k >= lo_s[r] && k < hi_s[r];
                  },
                  nullptr, ds_t, 1, SP);
    __syncthreads();
    accumulate_q<NS>(acc, ds_t, k_s, nk, Dk, kp);
  }
  const int d4 = Dk / 4;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int e = threadIdx.x + THREADS * i;
    const int rq = e / d4, c4 = e - (e / d4) * d4;
    if (rq >= MAX_ROWS / 4) continue;
#pragma unroll
    for (int r4 = 0; r4 < 4; ++r4) {
      const int r = 4 * rq + r4;
      if (r < rows) {
        const int ti = r / h;
        const size_t row = (((size_t)b * p.S + s0 + ti) * p.G + g) * h + (r - ti * h);
        const float4 a = acc[i][r4];
        store4<T>(dQ + row * Dk + 4 * c4,
                  make_float4(a.x * p.scale, a.y * p.scale, a.z * p.scale, a.w * p.scale));
      }
    }
  }
}

template <typename T, typename OutT, int NSK, int NSV>
__global__ void __launch_bounds__(THREADS)
banded_bwd_dkv_kernel(const T* __restrict__ Q, const T* __restrict__ K, const T* __restrict__ V,
                      const T* __restrict__ dO, const float* __restrict__ lse,
                      const float* __restrict__ delta, OutT* __restrict__ dK,
                      OutT* __restrict__ dV, Params p) {
  extern __shared__ __align__(16) float smem[];
  const int nkt = (p.S_kv + KC - 1) / KC;
  int bid = blockIdx.x;
  const int split = bid % p.nsplit;
  bid /= p.nsplit;
  const int kt = bid % nkt;
  bid /= nkt;
  const int g = bid % p.G;
  const int b = bid / p.G;
  const int k0 = kt * KC;
  const int nk = min(KC, p.S_kv - k0);
  const int h = p.h, Dk = p.Dk, Dv = p.Dv;
  const int kp = Dk + 4, vp = Dv + 4;

  const Smem L(Dk, Dv);
  float* q_s = smem + L.q;
  float* do_s = smem + L.dO;
  float* k_s = smem + L.k;
  float* v_s = smem + L.v;
  float* p_s = smem + L.p;    // [rows][SP]
  float* ds_s = smem + L.ds;  // [rows][SP]
  float* lse_s = smem + L.lse;
  float* dl_s = smem + L.dl;
  int* lo_s = reinterpret_cast<int*>(smem + L.lo);
  int* hi_s = reinterpret_cast<int*>(smem + L.hi);

  load_rows_vec<T>(k_s, kp, K + ((size_t)b * p.G + g) * p.S_kv * Dk, Dk, k0, KC, k0 + nk);
  load_rows_vec<T>(v_s, vp, V + ((size_t)b * p.G + g) * p.S_kv * Dv, Dv, k0, KC, k0 + nk);
  float4 dk_acc[NSK][4], dv_acc[NSV][4];
#pragma unroll
  for (int i = 0; i < NSK; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) dk_acc[i][k] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < NSV; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) dv_acc[i][k] = make_float4(0.f, 0.f, 0.f, 0.f);

  // this split's share of the tokens that see the tile, whole chunks of TQ
  int t_lo, t_hi;
  token_range(p, k0, k0 + nk, t_lo, t_hi);
  const int ntok = max(t_hi - t_lo + 1, 0);
  const int per = ((ntok + p.nsplit - 1) / p.nsplit + p.TQ - 1) / p.TQ * p.TQ;
  const int ta = t_lo + split * per;
  const int tb = min(t_hi + 1, ta + per);

  for (int t0 = ta; t0 < tb; t0 += p.TQ) {
    const int nt = min(p.TQ, tb - t0);
    const int rows = nt * h;
    __syncthreads();   // previous chunk consumed (and the K/V tile staged)
    stage_rows<T>(p, Q, dO, lse, delta, b, g, t0, nt, q_s, do_s, lse_s, dl_s, lo_s, hi_s);
    __syncthreads();
    scores_and_ds(q_s, do_s, k_s, v_s, lse_s, dl_s, rows, Dk, Dv, kp, vp, p.scale,
                  [&](int r, int key) {
                    const int k = k0 + key;
                    return key < nk && k >= lo_s[r] && k < hi_s[r];
                  },
                  p_s, ds_s, SP, 1);
    __syncthreads();
    accumulate_kv<NSV>(dv_acc, p_s, do_s, rows, Dv);
    accumulate_kv<NSK>(dk_acc, ds_s, q_s, rows, Dk);
  }
  const size_t row0 = (((size_t)split * p.B + b) * p.G + g) * p.S_kv + k0;
  store_kv<OutT, NSK>(dk_acc, dK, row0, nk, Dk, p.scale);
  store_kv<OutT, NSV>(dv_acc, dV, row0, nk, Dv, 1.f);
}

template <typename T, int NSK, int NSV>
int launch_ns(const void* Q, const void* K, const void* V, const void* dO, const float* lse,
              const float* delta, void* dQ, void* dK, void* dV, float* part, const Params& p,
              cudaStream_t stream) {
  const size_t smem = Smem(p.Dk, p.Dv).total * sizeof(float);
  const T* q = static_cast<const T*>(Q);
  const T* k = static_cast<const T*>(K);
  const T* v = static_cast<const T*>(V);
  const T* o = static_cast<const T*>(dO);
  cudaError_t e = cudaFuncSetAttribute(banded_bwd_dq_kernel<T, NSK>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long nq = (p.S + p.TQ - 1) / p.TQ;
  const unsigned grid_q = (unsigned)((long long)p.B * p.G * nq);
  banded_bwd_dq_kernel<T, NSK><<<grid_q, THREADS, smem, stream>>>(q, k, v, o, lse, delta,
                                                                  static_cast<T*>(dQ), p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long nkt = (p.S_kv + KC - 1) / KC;
  const unsigned grid = (unsigned)((long long)p.B * p.G * nkt * p.nsplit);
  if (p.nsplit == 1) {
    e = cudaFuncSetAttribute(banded_bwd_dkv_kernel<T, T, NSK, NSV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    banded_bwd_dkv_kernel<T, T, NSK, NSV><<<grid, THREADS, smem, stream>>>(
        q, k, v, o, lse, delta, static_cast<T*>(dK), static_cast<T*>(dV), p);
    return (int)cudaGetLastError();
  }
  const long long nk_el = (long long)p.B * p.G * p.S_kv * p.Dk;
  const long long nv_el = (long long)p.B * p.G * p.S_kv * p.Dv;
  float* part_k = part;
  float* part_v = part + (size_t)p.nsplit * nk_el;
  e = cudaFuncSetAttribute(banded_bwd_dkv_kernel<T, float, NSK, NSV>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  banded_bwd_dkv_kernel<T, float, NSK, NSV><<<grid, THREADS, smem, stream>>>(
      q, k, v, o, lse, delta, part_k, part_v, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int rk = reduce_splits<T>(part_k, dK, nk_el, p.nsplit, stream);
  if (rk != 0) return rk;
  return reduce_splits<T>(part_v, dV, nv_el, p.nsplit, stream);
}

template <typename T>
int launch(const void* Q, const void* K, const void* V, const void* dO, const float* lse,
           const float* delta, void* dQ, void* dK, void* dV, float* part, const Params& p,
           cudaStream_t stream) {
  const int nk = kv_slices(p.Dk), nv = kv_slices(p.Dv);
  if (nk == 1 && nv == 1)
    return launch_ns<T, 1, 1>(Q, K, V, dO, lse, delta, dQ, dK, dV, part, p, stream);
  if (nk == 1) return launch_ns<T, 1, 2>(Q, K, V, dO, lse, delta, dQ, dK, dV, part, p, stream);
  if (nv == 1) return launch_ns<T, 2, 1>(Q, K, V, dO, lse, delta, dQ, dK, dV, part, p, stream);
  return launch_ns<T, 2, 2>(Q, K, V, dO, lse, delta, dQ, dK, dV, part, p, stream);
}

}  // namespace

extern "C" {

long long nsa_banded_bwd_smem_bytes(int Dk, int Dv) {
  return (long long)(Smem(Dk, Dv).total * sizeof(float));
}

// part: f32 scratch of nsplit * B*G*S_kv*(Dk+Dv) floats when nsplit > 1
// (per-split partial dK, then dV), else unused.
int nsa_banded_bwd(int dtype, const void* Q, const void* K, const void* V, const void* dO,
                   const float* lse, const float* delta, void* dQ, void* dK, void* dV,
                   float* part, int B, int S, int S_kv, int G, int h, int Dk, int Dv, int mode,
                   int w, int l, int d, float scale, int TQ, int nsplit, void* stream) {
  if (TQ <= 0 || TQ * h > MAX_ROWS || nsplit <= 0 || Dk % 8 != 0 || Dv % 8 != 0 || Dk > 128 ||
      Dv > 128 || (mode == WIN && w <= 0) || (mode == CMP && (l <= 0 || d <= 0)) ||
      (mode != WIN && mode != CMP) || (nsplit > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const Params p{B, S, S_kv, G, h, Dk, Dv, mode, w, l, d, TQ, nsplit, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) return launch<float>(Q, K, V, dO, lse, delta, dQ, dK, dV, part, p, s);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(Q, K, V, dO, lse, delta, dQ, dK, dV, part, p, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
