// banded_bwd_mma: the bf16 banded backward on tensor cores: the window's
// diagonal (q-major) design, the one-pass (kv-major) design of the window
// and of the compressed prefix, and the two-pass design of both (a q-major
// dQ pass, then the kv-major kernel with its dQ slots off).
//
// Replaces, for bf16 operands (the train step's dtype):
//   nsa_vibe_tpu/ops/pallas/flash_diag.py::flash_banded_bwd_diag (kernel
//   _diag_bwd_kernel): win_bwd_diag_mma_kernel;
//   nsa_vibe_tpu/ops/pallas/flash_bwd.py::flash_banded_bwd_onepass (kernel
//   _onepass_bwd_kernel), both modes: banded_bwd_1p_mma_kernel;
//   nsa_vibe_tpu/ops/pallas/flash_bwd.py::flash_banded_bwd (kernels
//   _dq_kernel and _dkv_kernel), both modes: banded_bwd_dq_mma_kernel, then
//   banded_bwd_1p_mma_kernel with ws == nullptr.
// f32 keeps the FMA kernels of win_bwd_diag.cu, banded_bwd_1p.cu and
// banded_bwd.cu (their 5e-5 gates rule out TF32).
//
// What it computes, as those kernels: for query rows (token t, head j of
// group g) with visible keys [lo(t), hi(t)) (banded_common.cuh: WIN
// [t-w+1, t], CMP the first num_cmp(t+1) compressed tokens, both below
// S_kv; with ds [B,S] (packed documents) none before the row's document
// start ds, nor a pooled token that starts before it), the gradients dQ,
// dK, dV of O = softmax(scale Q K^T) V given dO, lse and delta =
// rowsum(dO*O) (notation: bwd_common.cuh); outputs bf16, accumulated in
// f32. Under ds the diagonal kernel keeps the dense band for its strips
// (so sum_strips reads written rows, zeros where no row sees a key), the
// dQ pass starts its band at the tile's first token's ds, and the kv pass
// streams the dense superset of rows, each masking its own bound and
// writing no slot for a tile it does not see (band_slot).
//
// What bounds it on the H100: five products of 2 FLOP per visible (row,
// key) pair (S, dP, dV, dK, dQ): ~56 GFLOP for the window at the m7c train
// shape (B=8, S=2048, G=2, h=6, D=64, w=512), 0.057 ms on the bf16 tensor
// cores; ~23 GFLOP for the compressed prefix (S_cmp=127), whose bound is
// its bytes (0.023 ms). Both designs also move f32 partial sums through
// device memory: the diagonal design its dK/dV strips, the one-pass design
// its dQ slots (and dK/dV split partials). The two-pass design moves neither
// dQ slots nor strips, only the kv pass's split partials, and forms S and dP
// once in each pass.
//
// P and dS, the same in both designs (`p_and_ds`): P = exp2(fma(s,
// scale*log2e, -lse*log2e)) with the same instructions in every tile,
// exactly 0 where a key is not visible and on EMPTY_LSE rows, dS = P (dP -
// delta); both rounded to bf16 before their products, as the TPU kernels
// round them (flash_bwd.py:345, :350; flash_diag.py:337, :341). l, lse and
// delta stay f32. K/V rows past S_kv are zero-filled by cp.async and
// head-width padding columns are zero, so padding memory never reaches a
// product. No float atomics: every strip row, slot and partial has one
// writer and is summed in a fixed order, so two launches give identical
// bits.
//
// Diagonal design (win_bwd_diag_mma_kernel), q-major: one CTA of ROWS / 16
// warps per (b, g, q tile of ROWS rows = ROWS / h tokens; ROWS 64, 128 or
// 192); warp w owns rows [16w, 16w+16). The body (`q_major`) also serves
// the two-pass design's dQ pass (banded_bwd_dq_mma_kernel<DT, ROWS, MODE>,
// ROWS 64 or 128) in either mode with the dK/dV half compiled out (DKV
// false): there dQ is the whole output and no P or dS tile goes to shared
// memory. In CMP mode later q tiles see longer prefixes, so the CTAs take
// the q tiles from the last one down, the heaviest first. The CTA stages
// its Q and dO rows once by cp.async, then streams the band's 64-key K/V
// tiles, double-buffered, from the tile at floor(lo(t_first) / 64) * 64 to
// the one holding t_last - absolute multiples of 64, as the forward
// (banded_fwd_mma.cu). Per tile and half of 32 keys a warp that sees a key
// forms S = Q K^T and dP = dO V^T on mma.sync, P and dS in registers, and
// dQ += dS K, exact in f32 registers across the band (K by
// ldmatrix.trans); a warp that sees none skips the half. dK and dV sum over
// all the tile's rows, across warps: P and dS go to shared memory in bf16,
// and the warps form dV = P^T dO and dK = dS^T Q in units of 16 keys x 32
// dims (P^T and dS^T read back by ldmatrix.trans, as the dQ path of
// sel_bwd_kv_mma_kernel), written straight from the fragments to the
// tile's f32 strip [B, G, nq, SL, D]; sum_strips adds each key's strips in
// ascending tile order. The strips take nq * SL * (Dk + Dv) * 4 bytes per
// (b, g): with 64-aligned key tiles SL is ceil((63 + ROWS/h - 1 + w) / 64)
// tiles; a 128-row tile has half the strips of a 64-row tile. The TPU
// kernel rounds its strips to bf16 (flash_diag.py:338, :344); these stay
// f32.
//
// One-pass design (banded_bwd_1p_mma_kernel<DT, MODE>), kv-major: one CTA
// of 4 warps per (b, g, 64-key tile, split); warp w owns keys [16w, 16w+16)
// of the tile. The CTA stages the K/V tile once and streams the band rows
// (token * h + head, contiguous in t) that see the tile, in chunks of ROWS
// rows (64; 32 at D = 128) double-buffered by cp.async. Splits cut the
// rows into shares of whole chunks (fixed by shape and card in the
// wrapper). Per chunk it forms S^T = K Q^T and dP^T = V dO^T on mma.sync,
// P and dS in registers, keeps dV += P^T dO and dK += dS^T Q in f32
// registers (P and dS fragments as the A operands, dO and Q by
// ldmatrix.trans), and writes the chunk's dQ = dS K_tile (dS^T through
// shared memory) to its f32 slot straight from the fragments: slot = kt -
// lo(t)/64 (banded_common.cuh::BandSlots; kt in CMP under the dense bound). sum_slots adds
// each row's slots in order, reduce_splits each key's split partials. With
// ws == nullptr (the two-pass design's dK/dV pass) the kernel skips dS^T,
// the dQ product and the slots.
#include "banded_bwd_mma.cuh"

namespace {

constexpr int KP = KC + 8;   // pitch (bf16) of the diagonal kernel's P and dS tiles [row][key]

// ------------------------------------------------------------ diagonal (q-major)

// Shared memory (bytes): K[2], V[2] (KC keys each), Q, dO (ROWS rows; row
// pitch DT + 8), and where DKV P, dS (ROWS x KC, pitch KP); all bf16.
template <int DT, int ROWS, bool DKV>
struct QLayout {
  static constexpr int P = DT + 8;
  static constexpr size_t TILE = (size_t)KC * P * 2, ROWT = (size_t)ROWS * P * 2;
  static constexpr size_t K = 0, V = 2 * TILE, Q = 4 * TILE, DO = Q + ROWT, PS = DO + ROWT;
  static constexpr size_t DS = PS + (size_t)ROWS * KP * 2;
  static constexpr size_t BYTES = DKV ? DS + (size_t)ROWS * KP * 2 : PS;
};

// CTAs per SM the register budget is cut for: at D = 64 two of 8 warps
// (128 rows; 128 registers) or three of 4 (64 rows; at four, 128 registers
// spilled)
__host__ __device__ constexpr int q_min_blocks(int DT, int ROWS) {
  return DT == 64 ? (ROWS == 64 ? 3 : ROWS == 128 ? 2 : 1) : 1;
}

// The q-major body: the diagonal design (MODE WIN, DKV: dK/dV strips) and
// the two-pass design's dQ pass (either MODE, dQ only). p.mode is MODE;
// DOCS: ds given (the dense instantiation reads none); OFF: row token s at
// position p.t_start + s (sequence sharding; the dense instantiation reads
// no offset). Both set: packed documents under sequence sharding (row
// token s at position t_start + s reads ds[b, s], a packed position).
template <int DT, int ROWS, int MODE, bool DKV, bool DOCS, bool OFF>
__device__ __forceinline__ void q_major(const __nv_bfloat16* __restrict__ Q,
                                        const __nv_bfloat16* __restrict__ K,
                                        const __nv_bfloat16* __restrict__ V,
                                        const __nv_bfloat16* __restrict__ dO,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ delta,
                                        const int* __restrict__ ds,
                                        __nv_bfloat16* __restrict__ dQ, float* __restrict__ strip_k,
                                        float* __restrict__ strip_v, const Params& p, int SL) {
  using C = QLayout<DT, ROWS, DKV>;
  constexpr int P = C::P, NTHR = 2 * ROWS, NW = NTHR / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int BG = p.B * p.G;
  const int nq = (p.S + p.TQ - 1) / p.TQ;
  const int qt = MODE == CMP ? nq - 1 - (int)(blockIdx.x / BG) : (int)(blockIdx.x / BG);
  const int bg = blockIdx.x % BG;
  const int g = bg % p.G, b = bg / p.G;
  const int s0 = qt * p.TQ;
  const int T = min(p.TQ, p.S - s0);   // live tokens of the tile
  const int pos0 = OFF ? p.t_start : 0;   // position of row token 0
  const int h = p.h, Dk = p.Dk, Dv = p.Dv;
  const int R = T * h;                 // live rows
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, g8 = lane >> 2, t4 = lane & 3;
  const float sl2 = p.scale * LOG2E;

  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + C::K);   // [2][KC][P]
  __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + C::V);   // [2][KC][P]
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + C::Q);   // [ROWS][P]
  __nv_bfloat16* do_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + C::DO); // [ROWS][P]
  __nv_bfloat16* p_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + C::PS);  // [ROWS][KP]
  __nv_bfloat16* ds_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + C::DS); // [ROWS][KP]

  // global row of tile row r: token s0 + r / h, head r % h
  auto grow = [&](int r) -> size_t {
    return (((size_t)b * p.S + s0 + r / h) * p.G + g) * h + r % h;
  };
  // head-width padding: columns [D, DT) stay zero
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  for (int idx = tid; idx < ROWS * (DT / 8); idx += NTHR) {
    const int r = idx / (DT / 8), c = (idx % (DT / 8)) * 8;
    if (c >= Dk) *reinterpret_cast<uint4*>(q_s + r * P + c) = z;
    if (c >= Dv) *reinterpret_cast<uint4*>(do_s + r * P + c) = z;
  }
  for (int idx = tid; idx < 2 * KC * (DT / 8); idx += NTHR) {
    const int r = idx / (DT / 8), c = (idx % (DT / 8)) * 8;
    if (c >= Dk) *reinterpret_cast<uint4*>(k_s + r * P + c) = z;
    if (c >= Dv) *reinterpret_cast<uint4*>(v_s + r * P + c) = z;
  }
  // Q and dO rows; padded rows (r >= R) zero-filled
  for (int idx = tid; idx < ROWS * (Dk / 8); idx += NTHR) {
    const int r = idx / (Dk / 8), c = (idx % (Dk / 8)) * 8;
    tc::cp_async16(q_s + r * P + c, r < R ? Q + grow(r) * Dk + c : Q, r < R);
  }
  for (int idx = tid; idx < ROWS * (Dv / 8); idx += NTHR) {
    const int r = idx / (Dv / 8), c = (idx % (Dv / 8)) * 8;
    tc::cp_async16(do_s + r * P + c, r < R ? dO + grow(r) * Dv + c : dO, r < R);
  }

  // the tile's band [lo(t_first), hi(t_last)) in key tiles from an
  // absolute multiple of KC; the diagonal design (DKV) keeps the dense
  // band, whose strip rows sum_strips reads
  int lo, hi, unused;
  key_range(p, pos0 + s0, lo, unused);
  key_range(p, pos0 + s0 + T - 1, unused, hi);
  if (DOCS && !DKV) doc_bound(p, ds, b, s0, lo);
  const int kb0 = (lo / KC) * KC;
  const int J = hi > lo ? (hi - kb0 + KC - 1) / KC : 0;

  const __nv_bfloat16* Kbg = K + (size_t)bg * p.S_kv * Dk;
  const __nv_bfloat16* Vbg = V + (size_t)bg * p.S_kv * Dv;
  auto issue = [&](int j, int buf) {
    const int k0 = kb0 + j * KC;
    const int nk = min(KC, p.S_kv - k0);
    __nv_bfloat16* kb = k_s + buf * KC * P;
    __nv_bfloat16* vb = v_s + buf * KC * P;
    for (int idx = tid; idx < KC * (Dk / 8); idx += NTHR) {
      const int r = idx / (Dk / 8), c = (idx % (Dk / 8)) * 8;
      tc::cp_async16(kb + r * P + c, r < nk ? Kbg + (size_t)(k0 + r) * Dk + c : K, r < nk);
    }
    for (int idx = tid; idx < KC * (Dv / 8); idx += NTHR) {
      const int r = idx / (Dv / 8), c = (idx % (Dv / 8)) * 8;
      tc::cp_async16(vb + r * P + c, r < nk ? Vbg + (size_t)(k0 + r) * Dv + c : V, r < nk);
    }
  };

  // this thread's two rows (r0 + g8, r0 + g8 + 8): bands and statistics;
  // padded rows see no key
  const int r0 = 16 * w;
  int rlo[2], rhi[2];
  float nl2[2], dl[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r0 + g8 + 8 * hf;
    rlo[hf] = rhi[hf] = 0;
    nl2[hf] = dl[hf] = 0.f;
    if (r < R) {
      key_range(p, pos0 + s0 + r / h, rlo[hf], rhi[hf]);
      if (DOCS) doc_bound(p, ds, b, s0 + r / h, rlo[hf]);
      nl2[hf] = neg_lse2(lse[grow(r)]);
      dl[hf] = delta[grow(r)];
    }
  }

  float dq[DT / 8][4];
#pragma unroll
  for (int i = 0; i < DT / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[i][e] = 0.f;

  constexpr int NH = DT / 32;                 // 32-dim blocks of a dK/dV unit
  constexpr int UNITS = 2 * (KC / 16) * NH;   // (dV | dK) x 16-key tiles x dim blocks
  const size_t strip0 = ((size_t)bg * nq + qt) * SL;

  if (J > 0) issue(0, 0);
  tc::cp_async_commit();   // Q, dO and the first tile
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
    const __nv_bfloat16* kb = k_s + buf * KC * P;
    const __nv_bfloat16* vb = v_s + buf * KC * P;
#pragma unroll
    for (int c0 = 0; c0 < KC; c0 += 32) {   // the tile's two halves of 32 keys
      bool sees = false;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) sees |= k0 + c0 + 32 > rlo[hf] && k0 + c0 < rhi[hf];
      if (__any_sync(FULL, sees)) {
        float s[4][4], dp[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
        tc::mma_tile<4, DT / 16, false>(
            s, [&](int ks, uint32_t (&f)[4]) { tc::ldsm_x4(f, tc::a_addr(q_s, P, r0, 16 * ks)); },
            kb + c0 * P, P);
        tc::mma_tile<4, DT / 16, false>(
            dp,
            [&](int ks, uint32_t (&f)[4]) { tc::ldsm_x4(f, tc::a_addr(do_s, P, r0, 16 * ks)); },
            vb + c0 * P, P);
        // C element e of n-tile i: row r0 + g8 + 8 (e >> 1), key k0 + c0 + 8i + 2 t4 + (e & 1)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hf = e >> 1, key = k0 + c0 + 8 * i + 2 * t4 + (e & 1);
            p_and_ds(s[i][e], dp[i][e], key >= rlo[hf] && key < rhi[hf], sl2, nl2[hf], dl[hf]);
          }
        // dQ += dS K (dS rounded to bf16 in the A fragments, K by ldmatrix.trans)
        tc::mma_tile<DT / 8, 2, true>(
            dq, [&](int ks, uint32_t (&f)[4]) { tc::a_from_c(f, dp[2 * ks], dp[2 * ks + 1]); },
            kb + c0 * P, P);
        if constexpr (DKV) {   // P and dS (bf16) to shared memory for dV and dK
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = c0 + 8 * i + 2 * t4;
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int o = (r0 + g8 + 8 * hf) * KP + col;
              *reinterpret_cast<uint32_t*>(p_s + o) =
                  tc::pack_bf16(s[i][2 * hf], s[i][2 * hf + 1]);
              *reinterpret_cast<uint32_t*>(ds_s + o) =
                  tc::pack_bf16(dp[i][2 * hf], dp[i][2 * hf + 1]);
            }
          }
        }
      } else if constexpr (DKV) {   // no row of the warp sees a key of the half: P = dS = 0
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int idx = lane + 32 * u, o = (r0 + idx / 4) * KP + c0 + (idx % 4) * 8;
          *reinterpret_cast<uint4*>(p_s + o) = z;
          *reinterpret_cast<uint4*>(ds_s + o) = z;
        }
      }
    }
    if constexpr (DKV) {
      __syncthreads();
      // dV = P^T dO and dK = dS^T Q of the tile's keys, summed over the ROWS
      // rows, in units of 16 keys x 32 dims, to the strip rows of keys k0..
      for (int u = w; u < UNITS; u += NW) {
        const int prod = u / (4 * NH), mt = (u / NH) % 4, n0 = 32 * (u % NH);
        const int D = prod ? Dk : Dv;
        if (n0 >= D) continue;
        const __nv_bfloat16* wt = prod ? ds_s : p_s;
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
        tc::mma_tile<4, ROWS / 16, true>(
            acc,
            [&](int ks, uint32_t (&f)[4]) {
              tc::ldsm_x4_t(f, tc::at_addr(wt, KP, 16 * mt, 16 * ks));
            },
            (prod ? q_s : do_s) + n0, P);
        float* out = (prod ? strip_k : strip_v) + (strip0 + (k0 - kb0) + 16 * mt + g8) * D;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int dim = n0 + 8 * i + 2 * t4;
          if (dim < D) {
            *reinterpret_cast<float2*>(out + dim) = make_float2(acc[i][0], acc[i][1]);
            *reinterpret_cast<float2*>(out + 8 * D + dim) = make_float2(acc[i][2], acc[i][3]);
          }
        }
      }
    }
    __syncthreads();   // P, dS and this K/V buffer are refilled next
  }
  tc::cp_async_wait<0>();   // a tile with no key tile still staged Q and dO
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r0 + g8 + 8 * hf;
    if (r >= R) continue;
    __nv_bfloat16* dst = dQ + grow(r) * Dk;
#pragma unroll
    for (int i = 0; i < DT / 8; ++i) {
      const int dim = 8 * i + 2 * t4;
      if (dim < Dk)
        *reinterpret_cast<uint32_t*>(dst + dim) =
            tc::pack_bf16(dq[i][2 * hf] * p.scale, dq[i][2 * hf + 1] * p.scale);
    }
  }
}

template <int DT, int ROWS, bool DOCS, bool OFF>
__global__ void __launch_bounds__(2 * ROWS, q_min_blocks(DT, ROWS))
win_bwd_diag_mma_kernel(const __nv_bfloat16* __restrict__ Q, const __nv_bfloat16* __restrict__ K,
                        const __nv_bfloat16* __restrict__ V, const __nv_bfloat16* __restrict__ dO,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const int* __restrict__ ds, __nv_bfloat16* __restrict__ dQ,
                        float* __restrict__ strip_k, float* __restrict__ strip_v, Params p,
                        int SL) {
  q_major<DT, ROWS, WIN, true, DOCS, OFF>(Q, K, V, dO, lse, delta, ds, dQ, strip_k, strip_v, p,
                                         SL);
}

template <int DT, int ROWS, int MODE, bool DOCS, bool OFF>
__global__ void __launch_bounds__(2 * ROWS, q_min_blocks(DT, ROWS))
banded_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ Q, const __nv_bfloat16* __restrict__ K,
                         const __nv_bfloat16* __restrict__ V,
                         const __nv_bfloat16* __restrict__ dO, const float* __restrict__ lse,
                         const float* __restrict__ delta, const int* __restrict__ ds,
                         __nv_bfloat16* __restrict__ dQ, Params p) {
  q_major<DT, ROWS, MODE, false, DOCS, OFF>(Q, K, V, dO, lse, delta, ds, dQ, nullptr, nullptr,
                                            p, 0);
}

// ------------------------------------------------------------ one-pass (kv-major)

template <int DT, int MODE, bool DOCS, bool OFF>
__global__ void __launch_bounds__(128)
banded_bwd_1p_mma_kernel(const __nv_bfloat16* __restrict__ Q,
                         const __nv_bfloat16* __restrict__ K,
                         const __nv_bfloat16* __restrict__ V,
                         const __nv_bfloat16* __restrict__ dO, const float* __restrict__ lse,
                         const float* __restrict__ delta, const int* __restrict__ ds,
                         float* __restrict__ part_k, float* __restrict__ part_v,
                         float* __restrict__ ws, Params p) {
  kv_major<DT, MODE, DOCS, OFF, false>(Q, K, V, dO, lse, delta, ds, nullptr, part_k, part_v, ws,
                                       p);
}

// ------------------------------------------------------------ launches

using DiagKernel = void (*)(const __nv_bfloat16*, const __nv_bfloat16*, const __nv_bfloat16*,
                            const __nv_bfloat16*, const float*, const float*, const int*,
                            __nv_bfloat16*, float*, float*, Params, int);

// q tiles (rows) of the q-major kernels' OFF instantiations: the wrappers'
// MMA_TILE_ROWS and DQ_TILE_ROWS (the other tiles serve the sweeps)
constexpr int OFF_ROWS = 128;

template <int DT, int ROWS>
int launch_diag(const void* Q, const void* K, const void* V, const void* dO, const float* lse,
                const float* delta, const int* ds, void* dQ, void* dK, void* dV, float* strip_k,
                float* strip_v, const Params& p, int SL, cudaStream_t stream) {
  const bool docs = ds != nullptr;
  DiagKernel kern = docs ? &win_bwd_diag_mma_kernel<DT, ROWS, true, false>
                         : &win_bwd_diag_mma_kernel<DT, ROWS, false, false>;
  if (p.t_start != 0) {
    if constexpr (ROWS == OFF_ROWS)
      kern = docs ? &win_bwd_diag_mma_kernel<DT, ROWS, true, true>
                  : &win_bwd_diag_mma_kernel<DT, ROWS, false, true>;
    else return (int)cudaErrorInvalidValue;
  }
  constexpr size_t smem = QLayout<DT, ROWS, true>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long nq = (p.S + p.TQ - 1) / p.TQ;
  const long long grid = (long long)p.B * p.G * nq;
  if (grid > 0)
    kern<<<(unsigned)grid, 2 * ROWS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(Q), static_cast<const __nv_bfloat16*>(K),
        static_cast<const __nv_bfloat16*>(V), static_cast<const __nv_bfloat16*>(dO), lse, delta,
        ds, static_cast<__nv_bfloat16*>(dQ), strip_k, strip_v, p, SL);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int rk = sum_strips<__nv_bfloat16>(strip_k, dK, p, p.Dk, SL, p.scale, KC, stream);
  if (rk != 0) return rk;
  return sum_strips<__nv_bfloat16>(strip_v, dV, p, p.Dv, SL, 1.f, KC, stream);
}

template <int DT, int ROWS, int MODE>
int launch_dq(const void* Q, const void* K, const void* V, const void* dO, const float* lse,
              const float* delta, const int* ds, void* dQ, const Params& p,
              cudaStream_t stream) {
  const bool docs = ds != nullptr;
  auto kern = docs ? &banded_bwd_dq_mma_kernel<DT, ROWS, MODE, true, false>
                   : &banded_bwd_dq_mma_kernel<DT, ROWS, MODE, false, false>;
  if (p.t_start != 0) {
    if constexpr (ROWS == OFF_ROWS)
      kern = docs ? &banded_bwd_dq_mma_kernel<DT, ROWS, MODE, true, true>
                  : &banded_bwd_dq_mma_kernel<DT, ROWS, MODE, false, true>;
    else return (int)cudaErrorInvalidValue;
  }
  constexpr size_t smem = QLayout<DT, ROWS, false>::BYTES;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long grid = (long long)p.B * p.G * ((p.S + p.TQ - 1) / p.TQ);
  if (grid > 0)
    kern<<<(unsigned)grid, 2 * ROWS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(Q), static_cast<const __nv_bfloat16*>(K),
        static_cast<const __nv_bfloat16*>(V), static_cast<const __nv_bfloat16*>(dO), lse, delta,
        ds, static_cast<__nv_bfloat16*>(dQ), p);
  NSA_LAUNCH_CHECK();
}

using KvKernel = void (*)(const __nv_bfloat16*, const __nv_bfloat16*, const __nv_bfloat16*,
                          const __nv_bfloat16*, const float*, const float*, const int*, float*,
                          float*, float*, Params);

template <int DT>
int launch_kv(const void* Q, const void* K, const void* V, const void* dO, const float* lse,
              const float* delta, const int* ds, void* dQ, void* dK, void* dV, float* part,
              float* ws, const Params& p, cudaStream_t stream) {
  const bool docs = ds != nullptr, off = p.t_start != 0;
  const KvKernel kern =
      p.mode == WIN
          ? (docs ? (off ? &banded_bwd_1p_mma_kernel<DT, WIN, true, true>
                         : &banded_bwd_1p_mma_kernel<DT, WIN, true, false>)
                  : (off ? &banded_bwd_1p_mma_kernel<DT, WIN, false, true>
                         : &banded_bwd_1p_mma_kernel<DT, WIN, false, false>))
          : (docs ? (off ? &banded_bwd_1p_mma_kernel<DT, CMP, true, true>
                         : &banded_bwd_1p_mma_kernel<DT, CMP, true, false>)
                  : (off ? &banded_bwd_1p_mma_kernel<DT, CMP, false, true>
                         : &banded_bwd_1p_mma_kernel<DT, CMP, false, false>));
  constexpr size_t smem = KvLayout<DT>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long nkt = (p.S_kv + KC - 1) / KC;
  const unsigned grid = (unsigned)((long long)p.B * p.G * nkt * p.nsplit);
  float* part_k = part;
  float* part_v = part + (size_t)p.nsplit * p.B * p.G * p.S_kv * p.Dk;
  kern<<<grid, 128, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(Q), static_cast<const __nv_bfloat16*>(K),
      static_cast<const __nv_bfloat16*>(V), static_cast<const __nv_bfloat16*>(dO), lse, delta, ds,
      part_k, part_v, ws, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return kv_finish<__nv_bfloat16>(part_k, part_v, ds, dQ, dK, dV, ws, p, stream);
}

}  // namespace

extern "C" {

// band rows per chunk of the one-pass kernel
int nsa_banded_bwd_1p_mma_rows(int Dk, int Dv) {
  return wide(Dk, Dv) ? KvLayout<128>::ROWS : KvLayout<64>::ROWS;
}

long long nsa_banded_bwd_1p_mma_smem_bytes(int Dk, int Dv) {
  return (long long)(wide(Dk, Dv) ? KvLayout<128>::BYTES : KvLayout<64>::BYTES);
}

// bf16 only. Q, dO [B,S,G,h,D*], K/V [B,G,S_kv,D*], lse/delta [B,S,G,h] f32,
// ds [B,S] int32 document starts (or null), gate [B,S,G] f32 (or null:
// ungated; with a gate the gradients are those of dO * g rounded to bf16)
// -> dQ, dK, dV (bf16); query row s at position t_start + s (with ds
// also). mode 0 WIN (w > 0), 1 CMP (l, d > 0); Dk, Dv <= 128 and multiples
// of 8. part: f32 scratch of nsplit * B*G*S_kv*(Dk+Dv) floats; ws: f32 dQ
// slots, nsa_banded_bwd_1p_slots(...) * B*S*G*h*Dk floats, or null for dK
// and dV alone (the two-pass design's kv pass; dQ unused).
int nsa_banded_bwd_1p_mma(const void* Q, const void* K, const void* V, const void* dO,
                          const float* lse, const float* delta, const int* ds,
                          const float* gate, void* dQ, void* dK, void* dV, float* part,
                          float* ws, int B, int S, int S_kv, int G, int h, int Dk, int Dv,
                          int mode, int w, int l, int d, float scale, int t_start, int nsplit,
                          void* stream) {
  if (nsplit <= 0 || h <= 0 || Dk % 8 != 0 || Dv % 8 != 0 || Dk > 128 || Dv > 128 ||
      S_kv <= 0 || (mode == WIN && w <= 0) || (mode == CMP && (l <= 0 || d <= 0)) ||
      (mode != WIN && mode != CMP) || part == nullptr || t_start < 0)
    return (int)cudaErrorInvalidValue;
  const Params p{B, S, S_kv, G, h, Dk, Dv, mode, w, l, d, 0, nsplit, scale, t_start};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gate != nullptr)
    return launch_kv_gated(Q, K, V, dO, lse, delta, ds, gate, dQ, dK, dV, part, ws, p, s);
  if (wide(Dk, Dv)) return launch_kv<128>(Q, K, V, dO, lse, delta, ds, dQ, dK, dV, part, ws, p, s);
  return launch_kv<64>(Q, K, V, dO, lse, delta, ds, dQ, dK, dV, part, ws, p, s);
}

long long nsa_win_bwd_diag_mma_smem_bytes(int Dk, int Dv, int rows) {
  if (wide(Dk, Dv)) return (long long)(rows == 64 ? QLayout<128, 64, true>::BYTES
                                                  : QLayout<128, 128, true>::BYTES);
  return (long long)(rows == 64    ? QLayout<64, 64, true>::BYTES
                     : rows == 128 ? QLayout<64, 128, true>::BYTES
                                   : QLayout<64, 192, true>::BYTES);
}

long long nsa_banded_bwd_dq_mma_smem_bytes(int Dk, int Dv, int rows) {
  if (wide(Dk, Dv))
    return (long long)(rows == 64 ? QLayout<128, 64, false>::BYTES
                                  : QLayout<128, 128, false>::BYTES);
  return (long long)(rows == 64 ? QLayout<64, 64, false>::BYTES : QLayout<64, 128, false>::BYTES);
}

// bf16 only: dQ of the two-pass design (its dK and dV: nsa_banded_bwd_1p_mma
// with ws null). Shapes, modes and t_start as nsa_banded_bwd_1p_mma; q tiles
// of `rows` = 64 or 128 rows (rows / h tokens, h <= rows; 128 where t_start
// > 0).
int nsa_banded_bwd_dq_mma(const void* Q, const void* K, const void* V, const void* dO,
                          const float* lse, const float* delta, const int* ds, void* dQ, int B,
                          int S, int S_kv, int G, int h, int Dk, int Dv, int mode, int w, int l,
                          int d, float scale, int t_start, int rows, void* stream) {
  if ((rows != 64 && rows != 128) || h <= 0 || h > rows || S_kv <= 0 || Dk % 8 != 0 ||
      Dv % 8 != 0 || Dk > 128 || Dv > 128 || (mode == WIN && w <= 0) ||
      (mode == CMP && (l <= 0 || d <= 0)) || (mode != WIN && mode != CMP) || t_start < 0)
    return (int)cudaErrorInvalidValue;
  const Params p{B, S, S_kv, G, h, Dk, Dv, mode, w, l, d, rows / h, 1, scale, t_start};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using Launch = int (*)(const void*, const void*, const void*, const void*, const float*,
                        const float*, const int*, void*, const Params&, cudaStream_t);
  const bool cmp = mode == CMP;
  const Launch launch =
      wide(Dk, Dv) ? (rows == 64 ? (cmp ? &launch_dq<128, 64, CMP> : &launch_dq<128, 64, WIN>)
                                 : (cmp ? &launch_dq<128, 128, CMP> : &launch_dq<128, 128, WIN>))
      : rows == 64 ? (cmp ? &launch_dq<64, 64, CMP> : &launch_dq<64, 64, WIN>)
                   : (cmp ? &launch_dq<64, 128, CMP> : &launch_dq<64, 128, WIN>);
  return launch(Q, K, V, dO, lse, delta, ds, dQ, p, s);
}

// Strip rows per q tile of `rows` rows (rows / h tokens): the most 64-key
// tiles a tile's band spans, times 64.
int nsa_win_bwd_diag_mma_strip_keys(int rows, int h, int w, int S_kv) {
  const int tq = rows / h;
  const int band = (KC - 1 + tq - 1 + w + KC - 1) / KC;
  const int nkt = (S_kv + KC - 1) / KC;
  return (band < nkt ? band : nkt) * KC;
}

// bf16 only. Shapes and t_start as nsa_banded_bwd_1p_mma, window w > 0. q
// tiles of `rows` = 64, 128 or 192 rows (192 for Dk, Dv <= 64 only; 128
// where t_start > 0), rows / h tokens, h <= rows. strip_k / strip_v: f32 scratch of B*G*ceil(S/(rows/h))*SL*Dk (Dv)
// floats, SL = nsa_win_bwd_diag_mma_strip_keys(rows, h, w, S_kv).
int nsa_win_bwd_diag_mma(const void* Q, const void* K, const void* V, const void* dO,
                         const float* lse, const float* delta, const int* ds, void* dQ, void* dK,
                         void* dV, float* strip_k, float* strip_v, int B, int S, int S_kv, int G,
                         int h, int Dk, int Dv, int w, float scale, int t_start, int rows,
                         void* stream) {
  const bool wd = wide(Dk, Dv);
  if ((rows != 64 && rows != 128 && (rows != 192 || wd)) || h <= 0 || h > rows || w <= 0 ||
      S <= 0 || S_kv <= 0 || Dk % 8 != 0 || Dv % 8 != 0 || Dk > 128 || Dv > 128 ||
      strip_k == nullptr || strip_v == nullptr || t_start < 0)
    return (int)cudaErrorInvalidValue;
  const Params p{B, S, S_kv, G, h, Dk, Dv, WIN, w, 0, 1, rows / h, 1, scale, t_start};
  const int SL = nsa_win_bwd_diag_mma_strip_keys(rows, h, w, S_kv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using Launch = int (*)(const void*, const void*, const void*, const void*, const float*,
                        const float*, const int*, void*, void*, void*, float*, float*,
                        const Params&, int, cudaStream_t);
  const Launch launch = wd ? (rows == 64 ? &launch_diag<128, 64> : &launch_diag<128, 128>)
                        : rows == 64  ? &launch_diag<64, 64>
                        : rows == 128 ? &launch_diag<64, 128>
                                      : &launch_diag<64, 192>;
  return launch(Q, K, V, dO, lse, delta, ds, dQ, dK, dV, strip_k, strip_v, p, SL, s);
}

}  // extern "C"
