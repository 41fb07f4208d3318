// Pieces of the bf16 banded backward on tensor cores shared by
// banded_bwd_mma.cu (every ungated entry: the diagonal, two-pass dQ and
// one-pass kernels) and banded_bwd_gated_mma.cu (the one-pass kernel's
// entries under the gate-epilogue fold, compiled apart so that the two
// sources build in parallel): P and dS of one element (p_and_ds), the
// one-pass kv-major body (kv_major) and its reductions (kv_finish). The
// design note is at the top of banded_bwd_mma.cu.
#pragma once

#include "banded_common.cuh"
#include "tc.cuh"

using namespace nsa;
using namespace nsa::bwd;
using namespace nsa::band;

namespace {

constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the special function unit (relative error ~2^-22; results below
// 2^-126 give 0), as the forward (banded_fwd_mma.cu)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// P and dS of one (row, key) element, in place of its logit s and its dP
// = dO.v: the one function both designs form them with, so a (row, key)
// pair gets the same P and dS bits in either. nl2 = -(lse * log2e) of the
// row (EMPTY_LSE: P = 0); an invisible key gets P = dS = 0 whatever s and
// dP hold.
__device__ __forceinline__ void p_and_ds(float& s, float& dp, bool vis, float sl2, float nl2,
                                         float delta) {
  const float p = fast_exp2(fmaf(s, sl2, nl2));
  dp = vis ? p * (dp - delta) : 0.f;
  s = vis ? p : 0.f;
}

__device__ __forceinline__ float neg_lse2(float lse) { return -(lse * LOG2E); }

// ------------------------------------------------------------ one-pass (kv-major)

template <int DT>
struct KvLayout {
  static constexpr int ROWS = DT == 64 ? 64 : 32;   // band rows per chunk
  static constexpr int P = DT + 8;                  // pitch of the K, V, Q, dO tiles
  static constexpr int RP = ROWS + 8;               // pitch of the dS^T tile
  static constexpr int NT = ROWS / 8;               // n-tiles (8 rows) of S^T
  // shared memory in bytes: K, V, Q[2], dO[2], dS^T (bf16); then per buffer
  // -lse*log2e, delta (f32) and each row's key range lo, hi (int)
  static constexpr size_t TILE = (size_t)KC * P * 2, CHUNK = (size_t)ROWS * P * 2;
  static constexpr size_t K = 0, V = TILE, Q = 2 * TILE, DO = Q + 2 * CHUNK, DS = DO + 2 * CHUNK;
  static constexpr size_t STATS = DS + (size_t)KC * RP * 2;
  static constexpr size_t BYTES = STATS + (size_t)2 * ROWS * 4 * 4;
};

// The kv-major body of the one-pass design (and, with ws == nullptr, the
// two-pass design's dK/dV pass). DOCS: ds given; OFF: row token s at
// position p.t_start + s; the dense instantiations read neither. GATED (the
// gate-epilogue fold, flash_bwd.py:394, :422-424): each staged dO row is
// scaled by its gate [B,S,G] f32 and rounded to bf16 in shared memory
// (common.cuh::gate_rows) before any product reads it, so the launch has
// the bits of the ungated launch on (dO * g).to(bf16). The entries:
// banded_bwd_1p_mma_kernel (banded_bwd_mma.cu, ungated, compiled as
// before) and gated_banded_bwd_1p_mma_kernel (banded_bwd_gated_mma.cu).
template <int DT, int MODE, bool DOCS, bool OFF, bool GATED>
__device__ __forceinline__ void kv_major(const __nv_bfloat16* __restrict__ Q,
                                         const __nv_bfloat16* __restrict__ K,
                                         const __nv_bfloat16* __restrict__ V,
                                         const __nv_bfloat16* __restrict__ dO,
                                         const float* __restrict__ lse,
                                         const float* __restrict__ delta,
                                         const int* __restrict__ ds,
                                         const float* __restrict__ gate,
                                         float* __restrict__ part_k, float* __restrict__ part_v,
                                         float* __restrict__ ws, const Params& p) {
  using C = KvLayout<DT>;
  constexpr int P = C::P, ROWS = C::ROWS, NT = C::NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nkt = (p.S_kv + KC - 1) / KC;
  int bid = blockIdx.x;
  const int split = bid % p.nsplit;
  bid /= p.nsplit;
  const int kt = bid % nkt;
  bid /= nkt;
  const int g = bid % p.G, b = bid / p.G;
  const int h = p.h, Dk = p.Dk, Dv = p.Dv;
  const int k0 = kt * KC;
  const int nk = min(KC, p.S_kv - k0);
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, g8 = lane >> 2, t4 = lane & 3;
  const int kw0 = 16 * w;   // this warp's keys in the tile
  const float sl2 = p.scale * LOG2E;
  const int pos0 = OFF ? p.t_start : 0;   // position of row token 0

  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + C::K);
  __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + C::V);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + C::Q);     // [2][ROWS][P]
  __nv_bfloat16* do_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + C::DO);   // [2][ROWS][P]
  __nv_bfloat16* ds_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + C::DS);   // [KC][RP]
  float* nl_s = reinterpret_cast<float*>(smem_raw + C::STATS);                // [2][ROWS]
  float* dl_s = nl_s + 2 * ROWS;
  int* lo_s = reinterpret_cast<int*>(dl_s + 2 * ROWS);
  int* hi_s = lo_s + 2 * ROWS;

  // this split's share of the band rows (token * h + head) that see the
  // tile: [ra, rb), whole chunks of ROWS rows
  int t_lo, t_hi;
  token_range<OFF>(p, k0, k0 + nk, t_lo, t_hi);
  const int R0 = t_lo * h;
  const int nrows = t_hi >= t_lo ? (t_hi - t_lo + 1) * h : 0;
  const int per = ((nrows + p.nsplit - 1) / p.nsplit + ROWS - 1) / ROWS * ROWS;
  const int ra = R0 + split * per;
  const int rb = min(R0 + nrows, ra + per);

  // head-width padding: columns [D, DT) of every tile stay zero
  constexpr int ZROWS = KC > 2 * ROWS ? KC : 2 * ROWS;
  for (int idx = tid; idx < ZROWS * (DT / 8); idx += 128) {
    const int r = idx / (DT / 8), c = (idx % (DT / 8)) * 8;
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    if (r < KC && c >= Dk) *reinterpret_cast<uint4*>(k_s + r * P + c) = z;
    if (r < KC && c >= Dv) *reinterpret_cast<uint4*>(v_s + r * P + c) = z;
    if (r < 2 * ROWS) {
      if (c >= Dk) *reinterpret_cast<uint4*>(q_s + r * P + c) = z;
      if (c >= Dv) *reinterpret_cast<uint4*>(do_s + r * P + c) = z;
    }
  }
  // the K/V tile; keys past S_kv read as zeros
  const size_t bg = (size_t)b * p.G + g;
  for (int idx = tid; idx < KC * (Dk / 8); idx += 128) {
    const int r = idx / (Dk / 8), c = (idx % (Dk / 8)) * 8;
    tc::cp_async16(k_s + r * P + c, r < nk ? K + (bg * p.S_kv + k0 + r) * Dk + c : K, r < nk);
  }
  for (int idx = tid; idx < KC * (Dv / 8); idx += 128) {
    const int r = idx / (Dv / 8), c = (idx % (Dv / 8)) * 8;
    tc::cp_async16(v_s + r * P + c, r < nk ? V + (bg * p.S_kv + k0 + r) * Dv + c : V, r < nk);
  }

  // global row of band row a (token a / h, head a % h)
  auto grow = [&](int a) -> size_t {
    const int t = a / h;
    return (((size_t)b * p.S + t) * p.G + g) * h + (a - t * h);
  };
  // stages band rows [a0, a0 + ROWS) into buffer `buf`: Q/dO rows by
  // cp.async (rows at or past rb zero-filled), statistics and key ranges by
  // plain loads
  auto issue = [&](int a0, int buf) {
    __nv_bfloat16* qb = q_s + buf * ROWS * P;
    __nv_bfloat16* ob = do_s + buf * ROWS * P;
    for (int idx = tid; idx < ROWS * (Dk / 8); idx += 128) {
      const int r = idx / (Dk / 8), c = (idx % (Dk / 8)) * 8;
      const bool ok = a0 + r < rb;
      tc::cp_async16(qb + r * P + c, ok ? Q + grow(a0 + r) * Dk + c : Q, ok);
    }
    for (int idx = tid; idx < ROWS * (Dv / 8); idx += 128) {
      const int r = idx / (Dv / 8), c = (idx % (Dv / 8)) * 8;
      const bool ok = a0 + r < rb;
      tc::cp_async16(ob + r * P + c, ok ? dO + grow(a0 + r) * Dv + c : dO, ok);
    }
    for (int r = tid; r < ROWS; r += 128) {
      const int o = buf * ROWS + r;
      if (a0 + r < rb) {
        const size_t gr = grow(a0 + r);
        nl_s[o] = neg_lse2(lse[gr]);
        dl_s[o] = delta[gr];
        key_range(p, pos0 + (a0 + r) / h, lo_s[o], hi_s[o]);
        if (DOCS) doc_bound(p, ds, b, (a0 + r) / h, lo_s[o]);
      } else {   // a padded row sees no key
        nl_s[o] = dl_s[o] = 0.f;
        lo_s[o] = hi_s[o] = 0;
      }
    }
  };

  float dk[DT / 8][4], dv[DT / 8][4];
#pragma unroll
  for (int i = 0; i < DT / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

  const size_t stride = (size_t)p.B * p.S * p.G * h * Dk;   // one dQ slot
  if (ra < rb) issue(ra, 0);
  tc::cp_async_commit();   // the K/V tile and the first chunk
  int buf = 0;
  for (int a0 = ra; a0 < rb; a0 += ROWS, buf ^= 1) {
    if (a0 + ROWS < rb) {   // the next chunk's copy overlaps this chunk's math
      issue(a0 + ROWS, buf ^ 1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    // (dO * g).astype(bf16) of each staged row (flash_bwd.py:424): a thread
    // scales the 16-byte pieces it staged itself (issue's mapping, which
    // gate_rows shares at 128 threads), so the barrier below publishes them
    if (GATED)
      gate_rows(do_s + buf * ROWS * P, P, min(ROWS, rb - a0), Dv,
                [&](int r) { return gate[((size_t)b * p.S + (a0 + r) / h) * p.G + g]; });
    __syncthreads();
    const __nv_bfloat16* qb = q_s + buf * ROWS * P;
    const __nv_bfloat16* ob = do_s + buf * ROWS * P;
    const float* nl_b = nl_s + buf * ROWS;
    const float* dl_b = dl_s + buf * ROWS;
    const int* lo_b = lo_s + buf * ROWS;
    const int* hi_b = hi_s + buf * ROWS;

    // S^T = K_w Q^T and dP^T = V_w dO^T (16 keys x ROWS rows)
    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
    tc::mma_tile<NT, DT / 16, false>(
        st, [&](int ks, uint32_t (&f)[4]) { tc::ldsm_x4(f, tc::a_addr(k_s, P, kw0, 16 * ks)); },
        qb, P);
    tc::mma_tile<NT, DT / 16, false>(
        dpt, [&](int ks, uint32_t (&f)[4]) { tc::ldsm_x4(f, tc::a_addr(v_s, P, kw0, 16 * ks)); },
        ob, P);
    // P and dS in place (C element e: key k0 + kw0 + g8 (+8 for e >= 2),
    // chunk row 8j + 2 t4 + (e & 1))
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + kw0 + g8 + (e >> 1) * 8, r = 8 * j + 2 * t4 + (e & 1);
        p_and_ds(st[j][e], dpt[j][e], key >= lo_b[r] && key < hi_b[r], sl2, nl_b[r], dl_b[r]);
      }
    // dV += P^T dO, dK += dS^T Q (P and dS rounded to bf16 in the A fragments)
    tc::mma_tile<DT / 8, ROWS / 16, true>(
        dv, [&](int ks, uint32_t (&f)[4]) { tc::a_from_c(f, st[2 * ks], st[2 * ks + 1]); }, ob,
        P);
    tc::mma_tile<DT / 8, ROWS / 16, true>(
        dk, [&](int ks, uint32_t (&f)[4]) { tc::a_from_c(f, dpt[2 * ks], dpt[2 * ks + 1]); },
        qb, P);
    if (ws != nullptr) {   // the one-pass design: this chunk's dQ partials to their slots
      // dS^T to shared memory, then dQ = dS K_tile: warp w takes row tile rt,
      // dims [dq0, dq0 + 64)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int r = 8 * j + 2 * t4;
        *reinterpret_cast<uint32_t*>(ds_s + (kw0 + g8) * C::RP + r) =
            tc::pack_bf16(dpt[j][0], dpt[j][1]);
        *reinterpret_cast<uint32_t*>(ds_s + (kw0 + g8 + 8) * C::RP + r) =
            tc::pack_bf16(dpt[j][2], dpt[j][3]);
      }
      __syncthreads();
      const int rt = w % (ROWS / 16), dq0 = (w / (ROWS / 16)) * 64;
      float dq[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[i][e] = 0.f;
      tc::mma_tile<8, KC / 16, true>(
          dq,
          [&](int ks, uint32_t (&f)[4]) {
            tc::ldsm_x4_t(f, tc::at_addr(ds_s, C::RP, 16 * rt, 16 * ks));
          },
          k_s + dq0, P);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = 16 * rt + g8 + 8 * hf;
        if (a0 + r >= rb) continue;
        int slot = MODE == WIN ? kt - lo_b[r] / KC : kt;
        if (DOCS) {   // a row of another document may see no key of the tile
          slot = band_slot(kt, lo_b[r], hi_b[r]);
          if (slot < 0) continue;
        }
        float* dst = ws + (size_t)slot * stride + grow(a0 + r) * Dk;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int dim = dq0 + 8 * i + 2 * t4;
          if (dim < Dk)
            *reinterpret_cast<float2*>(dst + dim) =
                make_float2(dq[i][2 * hf], dq[i][2 * hf + 1]);
        }
      }
    }
    __syncthreads();   // this buffer (and dS^T) is refilled next
  }
  tc::cp_async_wait<0>();   // a split with no rows still staged K/V
  // this split's partial rows (split, b, g, key) of dK (times scale) and dV
  const size_t row0 = (((size_t)split * p.B + b) * p.G + g) * p.S_kv + k0;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int key = kw0 + g8 + 8 * hf;
    if (key >= nk) continue;
#pragma unroll
    for (int i = 0; i < DT / 8; ++i) {
      const int dim = 8 * i + 2 * t4;
      if (dim < Dk)
        *reinterpret_cast<float2*>(part_k + (row0 + key) * Dk + dim) =
            make_float2(dk[i][2 * hf] * p.scale, dk[i][2 * hf + 1] * p.scale);
      if (dim < Dv)
        *reinterpret_cast<float2*>(part_v + (row0 + key) * Dv + dim) =
            make_float2(dv[i][2 * hf], dv[i][2 * hf + 1]);
    }
  }
}

// After the kv-major kernel: dK, dV from the per-split partials (in split
// order), and with ws dQ from the slots (sum_slots, in slot order).
template <typename T>
int kv_finish(float* part_k, float* part_v, const int* ds, void* dQ, void* dK, void* dV,
              float* ws, const Params& p, cudaStream_t stream) {
  const long long nk_el = (long long)p.B * p.G * p.S_kv * p.Dk;
  const long long nv_el = (long long)p.B * p.G * p.S_kv * p.Dv;
  int r = reduce_splits<T>(part_k, dK, nk_el, p.nsplit, stream);
  if (r != 0) return r;
  r = reduce_splits<T>(part_v, dV, nv_el, p.nsplit, stream);
  if (r != 0 || ws == nullptr) return r;
  const long long rows = (long long)p.B * p.S * p.G * p.h;
  if (ds != nullptr)
    return sum_slots<T>(ws, dQ, rows, p.Dk, BandSlots<true>{p, ds}, p.scale, stream);
  return sum_slots<T>(ws, dQ, rows, p.Dk, BandSlots<false>{p, nullptr}, p.scale, stream);
}

inline bool wide(int Dk, int Dv) { return Dk > 64 || Dv > 64; }

}  // namespace

namespace nsa {
namespace band {

// The one-pass launch under the gate-epilogue fold (banded_bwd_gated_mma.cu):
// as the ungated one, with gate [B,S,G] f32 scaling each dO row.
int launch_kv_gated(const void* Q, const void* K, const void* V, const void* dO,
                    const float* lse, const float* delta, const int* ds, const float* gate,
                    void* dQ, void* dK, void* dV, float* part, float* ws, const Params& p,
                    cudaStream_t stream);

}  // namespace band
}  // namespace nsa
