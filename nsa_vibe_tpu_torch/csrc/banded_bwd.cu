// banded_bwd: the dQ pass of the two-pass backward of the window and
// compressed-prefix attention branches (mode WIN or CMP), from the
// forward's row statistics, for f32 operands.
//
// Replaces, for f32 operands: nsa_vibe_tpu/ops/pallas/flash_bwd.py::
// flash_banded_bwd's q-major _dq_kernel, which the JAX train step runs for
// the window and compressed branches under bwd.onepass = 0 (ops/tuning.py).
// Its kv-major _dkv_kernel is the one-pass kernel with its dQ slots off
// (banded_bwd_1p.cu, ws == nullptr). bf16 operands (the train step's dtype)
// take banded_bwd_dq_mma_kernel and banded_bwd_1p_mma_kernel of
// banded_bwd_mma.cu on tensor cores; f32 keeps the FMA kernels, since the
// f32 gates (5e-5 relative) rule out TF32.
//
// What it computes, for query rows (token t, head j of group g) with
// visible keys [lo(t), hi(t)) (banded_common.cuh::key_range): dQ of O =
// softmax(scale Q K^T) V given dO, lse (EMPTY_LSE on rows with no key: they
// get dQ = 0) and delta = rowsum(dO*O); f32, accumulated in f32 (notation:
// bwd_common.cuh).
//
// What bounds it on the H100: ~3 products per visible (row, key) pair (S,
// dP, dQ) at the card's f32 FMA rate (67 TFLOP/s, not the tensor cores),
// and shared-memory reads.
// Design: q-major, one block per (b, g, tile of TQ tokens x h heads <= 64
// rows), as win_bwd_diag.cu without its strips: the block stages its rows
// (banded_common.cuh::stage_rows), streams the tile's band of keys 64 per
// chunk through shared memory, forms P and dS per chunk (scores_and_ds),
// keeps dQ exact in registers (accumulate_q_rows) and writes it once. No
// float atomics: two launches give identical bits.
#include "banded_common.cuh"

using namespace nsa;
using namespace nsa::bwd;
using namespace nsa::band;

namespace {

template <int NS>
__global__ void __launch_bounds__(THREADS)
banded_bwd_dq_kernel(const float* __restrict__ Q, const float* __restrict__ K,
                     const float* __restrict__ V, const float* __restrict__ dO,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ ds, float* __restrict__ dQ, Params p) {
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

  const Smem L(MAX_ROWS, Dk, Dv);
  float* q_s = smem + L.q;
  float* do_s = smem + L.dO;
  float* k_s = smem + L.k;
  float* v_s = smem + L.v;
  float* ds_s = smem + L.ds;   // [rows][SP]
  float* lse_s = smem + L.lse;
  float* dl_s = smem + L.dl;
  int* lo_s = reinterpret_cast<int*>(smem + L.lo);
  int* hi_s = reinterpret_cast<int*>(smem + L.hi);

  stage_rows(p, Q, dO, lse, delta, ds, b, g, s0, nt, q_s, do_s, lse_s, dl_s, lo_s, hi_s);
  float4 acc[NS][4];
#pragma unroll
  for (int i = 0; i < NS; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[i][r] = make_float4(0.f, 0.f, 0.f, 0.f);

  int lo_first, hi_last, unused;
  key_range(p, p.t_start + s0, lo_first, unused);
  key_range(p, p.t_start + s0 + nt - 1, unused, hi_last);   // lo and hi never decrease with t
  if (ds != nullptr) doc_bound(p, ds, b, s0, lo_first);
  const float* Kbg = K + ((size_t)b * p.G + g) * p.S_kv * Dk;
  const float* Vbg = V + ((size_t)b * p.G + g) * p.S_kv * Dv;

  for (int k0 = lo_first; k0 < hi_last; k0 += KC) {
    const int nk = min(KC, hi_last - k0);
    __syncthreads();   // previous chunk consumed (and the rows staged)
    load_rows_vec<float>(k_s, kp, Kbg, Dk, k0, KC, k0 + nk);
    load_rows_vec<float>(v_s, vp, Vbg, Dv, k0, KC, k0 + nk);
    __syncthreads();
    scores_and_ds(q_s, do_s, k_s, v_s, lse_s, dl_s, rows, Dk, Dv, kp, vp, p.scale,
                  [&](int r, int key) {
                    const int k = k0 + key;
                    return key < nk && k >= lo_s[r] && k < hi_s[r];
                  },
                  nullptr, ds_s, SP, 1);
    __syncthreads();
    accumulate_q_rows<NS>(acc, ds_s, k_s, nk, Dk, kp);
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
        store4<float>(dQ + row * Dk + 4 * c4,
                      make_float4(a.x * p.scale, a.y * p.scale, a.z * p.scale, a.w * p.scale));
      }
    }
  }
}

template <int NS>
int launch(const float* Q, const float* K, const float* V, const float* dO, const float* lse,
           const float* delta, const int* ds, float* dQ, int B, const Params& p,
           cudaStream_t stream) {
  const size_t smem = Smem(MAX_ROWS, p.Dk, p.Dv).total * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(banded_bwd_dq_kernel<NS>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long grid = (long long)B * p.G * ((p.S + p.TQ - 1) / p.TQ);
  if (grid > 0)
    banded_bwd_dq_kernel<NS><<<(unsigned)grid, THREADS, smem, stream>>>(Q, K, V, dO, lse, delta,
                                                                       ds, dQ, p);
  NSA_LAUNCH_CHECK();
}

}  // namespace

extern "C" {

long long nsa_banded_bwd_smem_bytes(int Dk, int Dv) {
  return (long long)(Smem(MAX_ROWS, Dk, Dv).total * sizeof(float));
}

// f32 only: dQ of the two-pass design (its dK and dV: nsa_banded_bwd_1p with
// ws null). Q, dO [B,S,G,h,D*], K/V [B,G,S_kv,D*], lse/delta [B,S,G,h], ds
// [B,S] int32 document starts (or null); mode 0 WIN (w > 0), 1 CMP (l, d >
// 0); query row s at position t_start + s; TQ tokens per block,
// TQ * h <= 64.
int nsa_banded_bwd(const float* Q, const float* K, const float* V, const float* dO,
                   const float* lse, const float* delta, const int* ds, float* dQ, int B, int S,
                   int S_kv, int G, int h, int Dk, int Dv, int mode, int w, int l, int d,
                   float scale, int t_start, int TQ, void* stream) {
  if (TQ <= 0 || TQ * h > MAX_ROWS || Dk % 8 != 0 || Dv % 8 != 0 || Dk > 128 || Dv > 128 ||
      (mode == WIN && w <= 0) || (mode == CMP && (l <= 0 || d <= 0)) ||
      (mode != WIN && mode != CMP) || t_start < 0)
    return (int)cudaErrorInvalidValue;
  const Params p{B, S, S_kv, G, h, Dk, Dv, mode, w, l, d, TQ, 1, scale, t_start};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_slices(Dk) == 1) return launch<1>(Q, K, V, dO, lse, delta, ds, dQ, B, p, s);
  return launch<2>(Q, K, V, dO, lse, delta, ds, dQ, B, p, s);
}

}  // extern "C"
