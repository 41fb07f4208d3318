// banded_bwd_1p: one-pass backward of the window and compressed-prefix
// attention branches (mode WIN or CMP), from the forward's row statistics,
// for f32 operands.
//
// Replaces, for f32 operands: nsa_vibe_tpu/ops/pallas/flash_bwd.py::
// flash_banded_bwd_onepass (kernel _onepass_bwd_kernel), the JAX train
// step's win and cmp backward under bwd.onepass = 1 (the window's when
// win.bwd_diag does not apply). bf16 operands (the train step's dtype) take
// the tensor-core kernel banded_bwd_1p_mma_kernel of banded_bwd_mma.cu,
// which writes the same dQ slots; f32 keeps this FMA kernel, since the f32
// gates (5e-5 relative) rule out TF32.
//
// What it computes: the same dQ, dK, dV as the two-pass design
// (flash_bwd.py::flash_banded_bwd: banded_bwd.cu's dQ pass, then this
// kernel with its slots off): for query rows (token t, head j
// of group g) with visible keys [lo(t), hi(t)) (banded_common.cuh), the
// gradients of O = softmax(scale Q K^T) V given dO, lse and delta =
// rowsum(dO*O); outputs f32, accumulated in f32 (notation: bwd_common.cuh).
//
// What bounds it on the H100: ~5 products per visible (row, key) pair at
// the card's f32 FMA rate (67 TFLOP/s, not the tensor cores), and
// shared-memory reads. It forms S, P, dP and dS once per (row, key) pair
// where the two-pass design forms them twice.
// Design: one kv-major pass, one block per (b, g, tile of 64 keys, split),
// as banded_bwd's dK/dV pass: the block keeps its K/V tile in shared
// memory and streams the query rows that see it, TQ tokens per chunk; dK
// and dV stay in registers. The same dS tile gives the chunk's rows their
// partial dQ = dS K_tile (accumulate_q_rows), which has no home across
// blocks (the TPU kernel's dQ ring carries it in VMEM across sequential
// grid steps): each partial goes to an f32 slot workspace ws[slot][row]
// (banded_common.cuh::BandSlots: slot = the tile's offset from the row's
// first visible tile, kt - lo(t)/64: WIN at most (w+62)/64 + 1 slots, CMP
// kt under the dense bound). Splits partition the query rows, so each
// (slot, row) is written by exactly one block; sum_slots adds each row's
// slots in slot order and scales. With ds [B,S] (packed documents) each
// row's keys start at its document (doc_bound); the rows a tile streams
// stay the dense superset (token_range), and a row that sees no key of the
// tile there writes no slot (band_slot). dK/dV go through per-split f32
// partials summed in split order (with one split the partial is only
// cast). No float atomics: two launches give identical bits. With ws ==
// nullptr the kernel forms dK and dV alone: the dK/dV pass of the two-pass
// design (banded_bwd.cu has its dQ pass), as flash_bwd.py::
// flash_banded_bwd's _dkv_kernel. With gate [B,S,G] f32 (the gate-epilogue
// fold, flash_bwd.py:422-424) each staged dO row is scaled by its gate
// (common.cuh::gate_rows) before any product: the bits of the ungated
// launch on dO * g.
#include "banded_common.cuh"

using namespace nsa;
using namespace nsa::bwd;
using namespace nsa::band;

namespace {

template <int NSK, int NSV, int NSQ>
__global__ void __launch_bounds__(THREADS)
banded_bwd_1p_kernel(const float* __restrict__ Q, const float* __restrict__ K,
                     const float* __restrict__ V, const float* __restrict__ dO,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, const int* __restrict__ ds,
                     const float* __restrict__ gate, float* __restrict__ dK,
                     float* __restrict__ dV, float* __restrict__ ws, Params p) {
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
  const size_t slot_stride = (size_t)p.B * p.S * p.G * h * Dk;

  const Smem L(MAX_ROWS, Dk, Dv);
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

  load_rows_vec<float>(k_s, kp, K + ((size_t)b * p.G + g) * p.S_kv * Dk, Dk, k0, KC, k0 + nk);
  load_rows_vec<float>(v_s, vp, V + ((size_t)b * p.G + g) * p.S_kv * Dv, Dv, k0, KC, k0 + nk);
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
  token_range<true>(p, k0, k0 + nk, t_lo, t_hi);
  const int ntok = max(t_hi - t_lo + 1, 0);
  const int per = ((ntok + p.nsplit - 1) / p.nsplit + p.TQ - 1) / p.TQ * p.TQ;
  const int ta = t_lo + split * per;
  const int tb = min(t_hi + 1, ta + per);
  const int d4 = Dk / 4;

  for (int t0 = ta; t0 < tb; t0 += p.TQ) {
    const int nt = min(p.TQ, tb - t0);
    const int rows = nt * h;
    __syncthreads();   // previous chunk consumed (and the K/V tile staged)
    stage_rows(p, Q, dO, lse, delta, ds, b, g, t0, nt, q_s, do_s, lse_s, dl_s, lo_s, hi_s);
    __syncthreads();
    if (gate != nullptr) {
      gate_rows(do_s, Dv, rows, Dv,
                [&](int r) { return gate[((size_t)b * p.S + t0 + r / h) * p.G + g]; });
      __syncthreads();
    }
    scores_and_ds(q_s, do_s, k_s, v_s, lse_s, dl_s, rows, Dk, Dv, kp, vp, p.scale,
                  [&](int r, int key) {
                    const int k = k0 + key;
                    return key < nk && k >= lo_s[r] && k < hi_s[r];
                  },
                  p_s, ds_s, SP, 1);
    __syncthreads();
    accumulate_kv<NSV>(dv_acc, p_s, do_s, rows, Dv);
    accumulate_kv<NSK>(dk_acc, ds_s, q_s, rows, Dk);
    if (ws == nullptr) continue;   // dK and dV alone
    float4 q_acc[NSQ][4];
#pragma unroll
    for (int i = 0; i < NSQ; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) q_acc[i][r] = make_float4(0.f, 0.f, 0.f, 0.f);
    accumulate_q_rows<NSQ>(q_acc, ds_s, k_s, nk, Dk, kp);
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
          const int slot = band_slot(kt, lo_s[r], hi_s[r]);
          const size_t row = (((size_t)b * p.S + t0 + ti) * p.G + g) * h + (r - ti * h);
          if (slot >= 0)
            *reinterpret_cast<float4*>(ws + slot * slot_stride + row * Dk + 4 * c4) =
                q_acc[i][r4];
        }
      }
    }
  }
  const size_t row0 = (((size_t)split * p.B + b) * p.G + g) * p.S_kv + k0;
  store_kv<float, NSK>(dk_acc, dK, row0, nk, Dk, p.scale);
  store_kv<float, NSV>(dv_acc, dV, row0, nk, Dv, 1.f);
}

template <int NSK, int NSV>
int launch_ns(const float* Q, const float* K, const float* V, const float* dO, const float* lse,
              const float* delta, const int* ds, const float* gate, float* dQ, float* dK,
              float* dV, float* part, float* ws, const Params& p, cudaStream_t stream) {
  const size_t smem = Smem(MAX_ROWS, p.Dk, p.Dv).total * sizeof(float);
  const long long nkt = (p.S_kv + KC - 1) / KC;
  const unsigned grid = (unsigned)((long long)p.B * p.G * nkt * p.nsplit);
  const long long nk_el = (long long)p.B * p.G * p.S_kv * p.Dk;
  const long long nv_el = (long long)p.B * p.G * p.S_kv * p.Dv;
  float* part_k = part;
  float* part_v = part + (size_t)p.nsplit * nk_el;
  cudaError_t e = cudaFuncSetAttribute(banded_bwd_1p_kernel<NSK, NSV, NSK>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  banded_bwd_1p_kernel<NSK, NSV, NSK><<<grid, THREADS, smem, stream>>>(
      Q, K, V, dO, lse, delta, ds, gate, part_k, part_v, ws, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int rk = reduce_splits<float>(part_k, dK, nk_el, p.nsplit, stream);
  if (rk != 0) return rk;
  const int rv = reduce_splits<float>(part_v, dV, nv_el, p.nsplit, stream);
  if (rv != 0 || ws == nullptr) return rv;
  const long long rows = (long long)p.B * p.S * p.G * p.h;
  if (ds != nullptr)
    return sum_slots<float>(ws, dQ, rows, p.Dk, BandSlots<true>{p, ds}, p.scale, stream);
  return sum_slots<float>(ws, dQ, rows, p.Dk, BandSlots<false>{p, nullptr}, p.scale, stream);
}

}  // namespace

extern "C" {

long long nsa_banded_bwd_1p_smem_bytes(int Dk, int Dv) {
  return (long long)(Smem(MAX_ROWS, Dk, Dv).total * sizeof(float));
}

// Slots of the dQ workspace: the most key tiles one row sees.
int nsa_banded_bwd_1p_slots(int mode, int w, int S_kv) {
  const int nkt = (S_kv + KC - 1) / KC;
  if (mode != WIN) return nkt;
  const int most = (w + KC - 2) / KC + 1;
  return most < nkt ? most : nkt;
}

// f32 only. Query row s at position t_start + s. ds: [B,S]
// int32 document starts, or null. gate: [B,S,G] f32, or null (ungated).
// part: f32 scratch of
// nsplit * B*G*S_kv*(Dk+Dv) floats (per-split partial dK, then dV). ws: f32
// dQ workspace of nsa_banded_bwd_1p_slots(...) * B*S*G*h*Dk floats, or null
// for dK and dV alone (dQ unused).
int nsa_banded_bwd_1p(const float* Q, const float* K, const float* V, const float* dO,
                      const float* lse, const float* delta, const int* ds, const float* gate,
                      float* dQ, float* dK,
                      float* dV, float* part, float* ws, int B, int S, int S_kv, int G, int h,
                      int Dk, int Dv, int mode, int w, int l, int d, float scale, int t_start,
                      int TQ, int nsplit, void* stream) {
  if (TQ <= 0 || TQ * h > MAX_ROWS || nsplit <= 0 || Dk % 8 != 0 || Dv % 8 != 0 || Dk > 128 ||
      Dv > 128 || S_kv <= 0 || (mode == WIN && w <= 0) || (mode == CMP && (l <= 0 || d <= 0)) ||
      (mode != WIN && mode != CMP) || part == nullptr || t_start < 0)
    return (int)cudaErrorInvalidValue;
  const Params p{B, S, S_kv, G, h, Dk, Dv, mode, w, l, d, TQ, nsplit, scale, t_start};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nk = kv_slices(Dk), nv = kv_slices(Dv);
  if (nk == 1 && nv == 1)
    return launch_ns<1, 1>(Q, K, V, dO, lse, delta, ds, gate, dQ, dK, dV, part, ws, p, s);
  if (nk == 1)
    return launch_ns<1, 2>(Q, K, V, dO, lse, delta, ds, gate, dQ, dK, dV, part, ws, p, s);
  if (nv == 1)
    return launch_ns<2, 1>(Q, K, V, dO, lse, delta, ds, gate, dQ, dK, dV, part, ws, p, s);
  return launch_ns<2, 2>(Q, K, V, dO, lse, delta, ds, gate, dQ, dK, dV, part, ws, p, s);
}

}  // extern "C"
