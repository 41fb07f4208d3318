// The bf16 banded forward's per-CTA walk on tensor cores (window or
// compressed prefix), shared by the kernels of banded_fwd_mma.cu
// (win_fwd_mma_kernel, cmp_fwd_mma_kernel) and by the fused scorer of
// select_cmp_mma.cu, whose pass 1 is the compressed-prefix walk. The
// design note is at the top of banded_fwd_mma.cu.
#pragma once

#include "common.cuh"
#include "tc.cuh"

namespace nsa {
namespace band {

constexpr int KC = 64;            // keys per K/V tile
constexpr int MAX_THREADS = 256;  // 8 warps: 128 rows
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float M_FLOOR = -1e20f;

enum Mode : int { WIN = 0, CMP = 1 };

// 2^x on the special function unit (relative error ~2^-22; 2^-inf and
// results below 2^-126 give 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

struct Params {
  int S, S_kv, G, h, Dk, Dv, w, l, d, t_start, qT, nq, BG;
  float scale;
};

// keys [lo, hi) that the query at position t sees; both grow with t
template <int MODE>
__device__ __forceinline__ void key_range(const Params& p, int t, int& lo, int& hi) {
  if (MODE == WIN) {
    lo = max(t - p.w + 1, 0);
    hi = min(t + 1, p.S_kv);
  } else {
    lo = 0;
    hi = min(num_cmp(t + 1, p.l, p.d), p.S_kv);
  }
}

// Shared memory (bytes): K[2], V[2] (KC keys each), then Q (`rows` rows);
// bf16, row pitch DT + 8 (tc.cuh).
template <int DT>
struct Layout {
  static constexpr int P = DT + 8;
  static constexpr size_t TILE = (size_t)KC * P * 2;
  static constexpr size_t K = 0, V = 2 * TILE, Q = 4 * TILE;
  static size_t bytes(int rows) { return Q + (size_t)rows * P * 2; }
};

// One CTA's rows (blockIdx.x: q tile from the last, then b * G + g): O and,
// with lse != nullptr, lse. With nlse2 != nullptr it also returns -(m +
// log2(l)) of this thread's rows r0 + g8 (nlse2[0]) and r0 + g8 + 8
// (nlse2[1]), the base-2 statistic of each row's softmax (0 for a row with
// no key), so that a caller can form p = exp2(s * scale * log2 e + nlse2).
// DOCS: ds [B,S] holds each token's document start (row s reads ds[b, s]): each row's
// lo is raised to its document's bound (common.cuh::doc_lo); the dense
// instantiation compiles as it did before documents existed. GATED (the
// gate-epilogue fold): gate [B,S,G] f32 scales each row's output, O =
// (acc / l) * g in f32 before the cast to bf16 (flash.py:274); lse and
// nlse2 stay the ungated softmax's. The ungated instantiations read no gate.
template <int DT, int MODE, bool DOCS, bool GATED = false>
__device__ __forceinline__ void band_fwd(const __nv_bfloat16* __restrict__ Q,
                                         const __nv_bfloat16* __restrict__ K,
                                         const __nv_bfloat16* __restrict__ V,
                                         const int* __restrict__ ds,
                                         __nv_bfloat16* __restrict__ O, float* __restrict__ lse,
                                         const Params& p, float* nlse2 = nullptr,
                                         const float* __restrict__ gate = nullptr) {
  using C = Layout<DT>;
  constexpr int P = C::P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nthr = blockDim.x, ROWS = nthr / 2;   // 16 rows per warp
  const int qt = p.nq - 1 - (int)(blockIdx.x / p.BG);   // the last q tile first
  const int bg = blockIdx.x % p.BG;                     // b * G + g
  const int g = bg % p.G, b = bg / p.G;
  const int s0 = qt * p.qT;
  const int T = min(p.qT, p.S - s0);   // live tokens of the tile
  const int h = p.h, Dk = p.Dk, Dv = p.Dv;
  const int R = T * h;                 // live rows
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, g8 = lane >> 2, t4 = lane & 3;
  const float sl2 = p.scale * LOG2E;

  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + C::K);   // [2][KC][P]
  __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + C::V);   // [2][KC][P]
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + C::Q);   // [ROWS][P]

  // global row of tile row r: token s0 + r / h, head r % h
  auto grow = [&](int r) -> size_t {
    return (((size_t)b * p.S + s0 + r / h) * p.G + g) * h + r % h;
  };
  // head-width padding: columns [D, DT) stay zero
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  for (int idx = tid; idx < ROWS * (DT / 8); idx += nthr) {
    const int r = idx / (DT / 8), c = (idx % (DT / 8)) * 8;
    if (c >= Dk) *reinterpret_cast<uint4*>(q_s + r * P + c) = z;
  }
  for (int idx = tid; idx < 2 * KC * (DT / 8); idx += nthr) {
    const int r = idx / (DT / 8), c = (idx % (DT / 8)) * 8;
    if (c >= Dk) *reinterpret_cast<uint4*>(k_s + r * P + c) = z;
    if (c >= Dv) *reinterpret_cast<uint4*>(v_s + r * P + c) = z;
  }
  for (int idx = tid; idx < ROWS * (Dk / 8); idx += nthr) {
    const int r = idx / (Dk / 8), c = (idx % (Dk / 8)) * 8;
    tc::cp_async16(q_s + r * P + c, r < R ? Q + grow(r) * Dk + c : Q, r < R);
  }

  // the tile's band [lo(t_first), hi(t_last)) in key tiles from an
  // absolute multiple of KC
  const int t_first = p.t_start + s0;
  int lo, hi, unused;
  key_range<MODE>(p, t_first, lo, unused);
  key_range<MODE>(p, t_first + T - 1, unused, hi);
  if (DOCS) lo = max(lo, doc_lo(doc_start(ds, p.S, b, s0), MODE == CMP, p.d));
  const int kb0 = (lo / KC) * KC;
  const int J = hi > lo ? (hi - kb0 + KC - 1) / KC : 0;

  const __nv_bfloat16* Kbg = K + (size_t)bg * p.S_kv * Dk;
  const __nv_bfloat16* Vbg = V + (size_t)bg * p.S_kv * Dv;
  auto issue = [&](int j, int buf) {
    const int k0 = kb0 + j * KC;
    const int nk = min(KC, p.S_kv - k0);
    __nv_bfloat16* kb = k_s + buf * KC * P;
    __nv_bfloat16* vb = v_s + buf * KC * P;
    for (int idx = tid; idx < KC * (Dk / 8); idx += nthr) {
      const int r = idx / (Dk / 8), c = (idx % (Dk / 8)) * 8;
      tc::cp_async16(kb + r * P + c, r < nk ? Kbg + (size_t)(k0 + r) * Dk + c : K, r < nk);
    }
    for (int idx = tid; idx < KC * (Dv / 8); idx += nthr) {
      const int r = idx / (Dv / 8), c = (idx % (Dv / 8)) * 8;
      tc::cp_async16(vb + r * P + c, r < nk ? Vbg + (size_t)(k0 + r) * Dv + c : V, r < nk);
    }
  };

  // this thread's two rows (r0 + g8, r0 + g8 + 8) and their bands; padded
  // rows (r >= R) see no key
  const int r0 = 16 * w;
  int rlo[2], rhi[2];
  bool rlive[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r0 + g8 + 8 * hf;
    rlive[hf] = r < R;
    rlo[hf] = rhi[hf] = 0;
    if (rlive[hf]) key_range<MODE>(p, t_first + r / h, rlo[hf], rhi[hf]);
    if (DOCS && rlive[hf])
      rlo[hf] = max(rlo[hf], doc_lo(doc_start(ds, p.S, b, s0 + r / h), MODE == CMP, p.d));
  }

  float o[DT / 8][4];
#pragma unroll
  for (int i = 0; i < DT / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m2[2] = {M_FLOOR, M_FLOOR}, lsum[2] = {0.f, 0.f};
  if (J > 0) issue(0, 0);
  tc::cp_async_commit();   // Q and the first tile
  for (int j = 0; j < J; ++j) {
    const int buf = j & 1;
    if (j + 1 < J) {   // the next tile's copy overlaps this tile's math
      issue(j + 1, buf ^ 1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = kb0 + j * KC;
    bool sees = false, all = true;   // a live row sees a key of the tile; every one sees all
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      sees |= rlive[hf] && k0 + KC > rlo[hf] && k0 < rhi[hf];
      all &= !rlive[hf] || (k0 >= rlo[hf] && k0 + KC <= rhi[hf]);
    }
    if (__any_sync(FULL, sees)) {   // else no row of the warp sees a key: skip the tile
      const bool whole = __all_sync(FULL, all);
      const __nv_bfloat16* kb = k_s + buf * KC * P;
      const __nv_bfloat16* vb = v_s + buf * KC * P;
      float s[KC / 8][4];
#pragma unroll
      for (int i = 0; i < KC / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
      tc::mma_tile<KC / 8, DT / 16, false>(
          s, [&](int ks, uint32_t (&f)[4]) { tc::ldsm_x4(f, tc::a_addr(q_s, P, r0, 16 * ks)); },
          kb, P);
      // C element e of n-tile i: row r0 + g8 + 8 (e >> 1), key k0 + 8i + 2 t4
      // + (e & 1). The max runs over the raw logits (scale > 0); each p is
      // exp2(fma(s, scale * log2 e, -m)), the same instructions whether the
      // warp masks the tile or not, so a row gets the same bits either way.
      float mx[2] = {NEG, NEG};
      if (whole) {
#pragma unroll
        for (int i = 0; i < KC / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[i][e]);
      } else {
#pragma unroll
        for (int i = 0; i < KC / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hf = e >> 1, key = k0 + 8 * i + 2 * t4 + (e & 1);
            if (!(key >= rlo[hf] && key < rhi[hf])) s[i][e] = NEG;
            mx[hf] = fmaxf(mx[hf], s[i][e]);
          }
      }
      float alpha[2], neg_m[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {   // the row's four threads hold its 64 keys
        mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(FULL, mx[hf], 1));
        mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(FULL, mx[hf], 2));
        const float m_new = fmaxf(m2[hf], __fmul_rn(mx[hf], sl2));   // >= M_FLOOR: finite
        alpha[hf] = m_new == m2[hf] ? 1.f : fast_exp2(m2[hf] - m_new);   // exactly 1: no key
        m2[hf] = m_new;
        neg_m[hf] = -m_new;
        lsum[hf] *= alpha[hf];
      }
#pragma unroll
      for (int i = 0; i < KC / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // masked: exp2(-FLT_MAX * scale * log2 e - m) = 0
          const float pr = fast_exp2(fmaf(s[i][e], sl2, neg_m[e >> 1]));
          lsum[e >> 1] += pr;
          s[i][e] = pr;
        }
#pragma unroll
      for (int i = 0; i < DT / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][e] *= alpha[e >> 1];
      // O += P V (P rounded to bf16 in the A fragments, V by ldmatrix.trans)
      tc::mma_tile<DT / 8, KC / 16, true>(
          o, [&](int ks, uint32_t (&f)[4]) { tc::a_from_c(f, s[2 * ks], s[2 * ks + 1]); }, vb,
          P);
    }
    __syncthreads();   // this buffer is refilled next
  }
  tc::cp_async_wait<0>();   // a tile with no key tile still staged Q
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float l = lsum[hf];
    l += __shfl_xor_sync(FULL, l, 1);
    l += __shfl_xor_sync(FULL, l, 2);
    if (nlse2 != nullptr) nlse2[hf] = l > 0.f ? -(m2[hf] + log2f(l)) : 0.f;
    const int r = r0 + g8 + 8 * hf;
    if (r >= R) continue;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    const float gv = GATED ? gate[((size_t)b * p.S + s0 + r / h) * p.G + g] : 1.f;
    __nv_bfloat16* dst = O + grow(r) * Dv;
#pragma unroll
    for (int i = 0; i < DT / 8; ++i) {
      const int dim = 8 * i + 2 * t4;
      if (dim < Dv) {
        const float x0 = o[i][2 * hf] * inv, x1 = o[i][2 * hf + 1] * inv;
        *reinterpret_cast<uint32_t*>(dst + dim) =
            GATED ? tc::pack_bf16(x0 * gv, x1 * gv) : tc::pack_bf16(x0, x1);
      }
    }
    if (lse != nullptr && t4 == 0) lse[grow(r)] = l > 0.f ? (m2[hf] + log2f(l)) * LN2 : EMPTY_LSE;
  }
}

}  // namespace band
}  // namespace nsa
