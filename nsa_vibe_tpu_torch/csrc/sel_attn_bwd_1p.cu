// sel_attn_bwd_1p: one-pass backward of the NSA selection branch, and the
// kv-major pass both selection designs share (sel_bwd.cuh).
//
// Replaces: nsa_vibe_tpu/ops/pallas/sel_flash.py::selection_flash_bwd_onepass
// (kernel _sel_onepass_bwd_kernel), the selection backward of the JAX train
// step under sel.bwd_onepass = 1; and, with the dQ slots off, the dK/dV
// pass _sel_dkv_kernel of sel_flash.py::selection_flash_bwd (the two-pass
// design, sel_attn_bwd.cu).
//
// What it computes: dQ, dK, dV of sel_attn's forward: per query (b, s) and
// group g, softmax over the keys of the row's selected blocks taken as a
// SET, key positions <= t = tpos[b, s] and < S_kv; -1 slots and repeated
// block ids add nothing; EMPTY_LSE rows get P = 0; outputs in the operands'
// dtype, accumulated in f32 (notation: bwd_common.cuh).
//
// What bounds it on the H100: ~5 products of 2 FLOP per visible (row, key)
// pair, ~0.09 TFLOP at the m7c train shape (B=8, S=2048, G=2, h=6, D=64,
// n=16 blocks of 64): 0.0957 ms of bf16 tensor-core time; the one-pass
// design also writes and reads its f32 dQ slots (16 x B*S*G*h*Dk floats,
// 1.6 GB, >= 0.48 ms at 3.35 TB/s).
//
// Design: one CTA per work item (sel_bwd.cuh) and 64-key sub-tile of its
// selection block. It stages the K/V tile once and streams the item's
// member rows in chunks of TQ tokens (rows = TQ * h); dK/dV of the tile
// stay in f32 registers across chunks and go to the item's f32 partial.
// With slots on, the chunk's dS tile also gives each member row its
// partial dQ = dS K_tile, written to the f32 slot ws[slot][row] with slot
// = rank * nsub + sub (rank = the block's rank among the row's distinct
// visible blocks, nsub the key sub-tiles per block): each (slot, row) has
// exactly one writer (sub-tiles past S_kv still write zeros), and
// sum_slots adds each row's slots in order. No float atomics: two launches
// give identical bits.
//
// bf16 operands (the train step's dtype) take the tensor-core kernel
// `sel_bwd_kv_mma_kernel`: 4 warps, warp w owns keys [16w, 16w+16) of the
// tile. K/V (once) and each chunk's Q/dO rows (a token's h*D row is
// contiguous) arrive by 16-byte cp.async into bf16 tiles with a padded
// pitch (tc.cuh), double-buffered: chunk i+1's gather is in flight while
// chunk i computes. mma.m16n8k16 forms S^T = K Q^T and dP^T = V dO^T for
// the warp's keys; P = exp2(S scale log2e - lse log2e) and dS = P (dP -
// delta) are masked in the fragments and rounded to bf16, as the TPU
// kernel rounds them before its products (sel_flash.py:438, :514, :523,
// :818); their fragments are the A operands of dV += P^T dO and dK += dS^T
// Q (dO and Q by ldmatrix.trans). With slots on, dS^T goes to shared
// memory and each warp forms 16 rows x 64 dims of dQ = dS K, written to
// the slots straight from its fragments after dK/dV are updated. Head
// widths up to 64 (128) run as 64 (128) with zero columns; a chunk holds 64
// (32) rows.
// f32 operands (the f32 checks of chip_smoke.py and the tests, whose
// bounds are 5e-5 relative: TF32 would break them) keep the FMA
// arithmetic of bwd_common.cuh in `sel_bwd_kv_fma_kernel` (256 threads,
// operands staged as f32), over the same work list.
//
// The gate-epilogue fold (nsa.gate_fold; sel_flash.py:781): with a gate
// [B,S,G] f32 the one-pass design launches gated_sel_bwd_kv_mma_kernel
// (bf16) or gated_sel_bwd_kv_fma_kernel (f32), the same bodies (GATED),
// which scale each staged dO row by its gate and round it to the operands'
// dtype (common.cuh::gate_rows) before any product: the bits of the
// ungated launch on (dO * g).to(dtype). The ungated entries compile as
// before (csrc/ptxas_baseline.json).
#include "bwd_common.cuh"
#include "sel_bwd.cuh"
#include "tc.cuh"

using namespace nsa;
using namespace nsa::bwd;

namespace nsa {
namespace sel {
namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int TC_THREADS = 128;

// one work item of this CTA (sel_bwd.cuh)
struct Item {
  int slot, b, g, jb, i0, i1;
};

__device__ __forceinline__ bool decode_item(const KvArgs& a, const KvParams& p, int NB, int c,
                                            Item& it) {
  const int* w = a.work + 3 * c;
  const int blk = w[1];
  if (blk < 0) return false;
  it.slot = w[0];
  it.jb = blk % NB;
  it.g = (blk / NB) % p.G;
  it.b = blk / NB / p.G;
  it.i0 = w[2] * p.per;
  it.i1 = min(a.cnt[blk], it.i0 + p.per);
  return true;
}

// slots a row (b, s, g, head) wrote: its distinct visible blocks' sub-tiles
struct SelSlots {
  const int* nblk;   // [B,S,G]
  int h, nsub;
  __device__ int operator()(long long row) const { return nblk[row / h] * nsub; }
};

// ------------------------------------------------------------ f32: FMA

// shared memory (floats), 256 threads
struct FmaSmem {
  size_t q, dO, k, v, p, ds, lse, dl, tok, tpos, rank, total;
  __host__ __device__ FmaSmem(int Dk, int Dv) {
    q = 0;
    dO = q + round4((size_t)MAX_ROWS * Dk);
    k = dO + round4((size_t)MAX_ROWS * Dv);
    v = k + round4((size_t)KC * (Dk + 4));
    p = v + round4((size_t)KC * (Dv + 4));
    ds = p + round4((size_t)MAX_ROWS * SP);
    lse = ds + round4((size_t)MAX_ROWS * SP);
    dl = lse + MAX_ROWS;
    tok = dl + MAX_ROWS;    // ints: the chunk's member tokens
    tpos = tok + MAX_ROWS;  // ints: their positions
    rank = tpos + MAX_ROWS; // ints: the block's rank in each member's set
    total = rank + MAX_ROWS;
  }
};

template <int NSK, int NSV, bool GATED>
__device__ __forceinline__ void kv_fma_body(const KvArgs& a, const KvParams& p,
                                            const float* __restrict__ gate) {
  extern __shared__ __align__(16) float smem[];
  const int L = p.l_sel;
  const int nsub = (L + KC - 1) / KC;
  const int NB = (p.S_kv + L - 1) / L;
  Item it;
  if (!decode_item(a, p, NB, blockIdx.x / nsub, it)) return;
  const int sub = blockIdx.x % nsub;
  const int b = it.b, g = it.g;
  const int k0 = it.jb * L + sub * KC;
  // keys of this tile; 0 for a sub-tile past S_kv, which still writes its
  // members' (zero) dQ slots
  const int nk = max(min(min(KC, L - sub * KC), p.S_kv - k0), 0);
  const int h = p.h, Dk = p.Dk, Dv = p.Dv;
  const int kp = Dk + 4, vp = Dv + 4;
  const size_t slot_stride = (size_t)p.B * p.S * p.G * h * Dk;
  const float* Q = static_cast<const float*>(a.Q);
  const float* dO = static_cast<const float*>(a.dO);

  const FmaSmem S_(Dk, Dv);
  float* q_s = smem + S_.q;
  float* do_s = smem + S_.dO;
  float* k_s = smem + S_.k;
  float* v_s = smem + S_.v;
  float* p_s = smem + S_.p;
  float* ds_s = smem + S_.ds;
  float* lse_s = smem + S_.lse;
  float* dl_s = smem + S_.dl;
  int* tok_s = reinterpret_cast<int*>(smem + S_.tok);
  int* tp_s = reinterpret_cast<int*>(smem + S_.tpos);
  int* rk_s = reinterpret_cast<int*>(smem + S_.rank);

  const size_t bg = (size_t)b * p.G + g;
  load_rows_vec<float>(k_s, kp, static_cast<const float*>(a.K) + bg * p.S_kv * Dk, Dk, k0, KC,
                       k0 + nk);
  load_rows_vec<float>(v_s, vp, static_cast<const float*>(a.V) + bg * p.S_kv * Dv, Dv, k0, KC,
                       k0 + nk);
  float4 dk_acc[NSK][4], dv_acc[NSV][4];
#pragma unroll
  for (int i = 0; i < NSK; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) dk_acc[i][k] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < NSV; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) dv_acc[i][k] = make_float4(0.f, 0.f, 0.f, 0.f);

  const size_t lst = bg * NB + it.jb;
  const int* list = a.inv + lst * p.inv_pitch;
  const int* ranks = a.rank + lst * p.inv_pitch;
  const int d4 = Dk / 4;

  for (int i0 = it.i0; i0 < it.i1; i0 += p.TQ) {
    const int nt = min(p.TQ, it.i1 - i0);
    const int rows = nt * h;
    __syncthreads();   // previous chunk consumed (and the K/V tile staged)
    for (int i = threadIdx.x; i < nt; i += THREADS) {
      const int s = list[i0 + i];
      tok_s[i] = s;
      tp_s[i] = a.tpos[(size_t)b * p.S + s];
      if (a.ws != nullptr) rk_s[i] = ranks[i0 + i];
    }
    __syncthreads();
    auto row_of = [&](int r) -> size_t {
      const int i = r / h;
      return (((size_t)b * p.S + tok_s[i]) * p.G + g) * h + (r - i * h);
    };
    load_rows_vec<float>(q_s, Dk, [&](int r) -> const float* { return Q + row_of(r) * Dk; }, Dk,
                         rows);
    load_rows_vec<float>(do_s, Dv, [&](int r) -> const float* { return dO + row_of(r) * Dv; },
                         Dv, rows);
    for (int r = threadIdx.x; r < rows; r += THREADS) {
      const size_t o = row_of(r);
      lse_s[r] = a.lse[o];
      dl_s[r] = a.delta[o];
    }
    __syncthreads();
    if (GATED) {   // dO * g of each staged row (sel_flash.py:781)
      gate_rows(do_s, Dv, rows, Dv,
                [&](int r) { return gate[((size_t)b * p.S + tok_s[r / h]) * p.G + g]; });
      __syncthreads();
    }
    scores_and_ds(q_s, do_s, k_s, v_s, lse_s, dl_s, rows, Dk, Dv, kp, vp, p.scale,
                  [&](int r, int key) { return key < nk && k0 + key <= tp_s[r / h]; },
                  p_s, ds_s, SP, 1);
    __syncthreads();
    accumulate_kv<NSV>(dv_acc, p_s, do_s, rows, Dv);
    accumulate_kv<NSK>(dk_acc, ds_s, q_s, rows, Dk);
    if (a.ws == nullptr) continue;
    float4 q_acc[NSK][4];
#pragma unroll
    for (int i = 0; i < NSK; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) q_acc[i][r] = make_float4(0.f, 0.f, 0.f, 0.f);
    accumulate_q_rows<NSK>(q_acc, ds_s, k_s, nk, Dk, kp);
#pragma unroll
    for (int i = 0; i < NSK; ++i) {
      const int e = threadIdx.x + THREADS * i;
      const int rq = e / d4, c4 = e - (e / d4) * d4;
      if (rq >= MAX_ROWS / 4) continue;
#pragma unroll
      for (int r4 = 0; r4 < 4; ++r4) {
        const int r = 4 * rq + r4;
        if (r < rows) {
          const int slot = rk_s[r / h] * nsub + sub;
          *reinterpret_cast<float4*>(a.ws + slot * slot_stride + row_of(r) * Dk + 4 * c4) =
              q_acc[i][r4];
        }
      }
    }
  }
  const size_t row0 = ((size_t)it.slot * nsub + sub) * KC;
  store_kv<float, NSK>(dk_acc, a.part, row0, nk, Dk, 1.f);
  store_kv<float, NSV>(dv_acc, a.part + (size_t)p.n_work * nsub * KC * Dk, row0, nk, Dv, 1.f);
}

template <int NSK, int NSV>
__global__ void __launch_bounds__(THREADS) sel_bwd_kv_fma_kernel(KvArgs a, KvParams p) {
  kv_fma_body<NSK, NSV, false>(a, p, nullptr);
}

template <int NSK, int NSV>
__global__ void __launch_bounds__(THREADS)
gated_sel_bwd_kv_fma_kernel(KvArgs a, KvParams p, const float* __restrict__ gate) {
  kv_fma_body<NSK, NSV, true>(a, p, gate);
}

// ------------------------------------------------------------ bf16: tensor cores

template <int DT>
struct Mma {
  static constexpr int ROWS = DT == 64 ? 64 : 32;   // query rows per chunk
  static constexpr int P = DT + 8;                  // pitch of the K, V, Q, dO tiles
  static constexpr int RP = ROWS + 8;               // pitch of the dS^T tile
  static constexpr int NT = ROWS / 8;               // n-tiles (8 rows) of S^T
  // shared memory in bytes: K, V, Q[2], dO[2], dS^T (bf16); lse*log2e,
  // delta (f32), then position, rank and token of each row (int), per buffer
  static constexpr size_t TILE = (size_t)KC * P * 2, CHUNK = (size_t)ROWS * P * 2;
  static constexpr size_t K = 0, V = TILE, Q = 2 * TILE, DO = Q + 2 * CHUNK, DS = DO + 2 * CHUNK;
  static constexpr size_t STATS = DS + (size_t)KC * RP * 2;
  static constexpr size_t BYTES = STATS + (size_t)2 * ROWS * 5 * 4;
};

template <int DT, bool GATED>
__device__ __forceinline__ void kv_mma_body(const KvArgs& a, const KvParams& p,
                                            const float* __restrict__ gate) {
  using C = Mma<DT>;
  constexpr int P = C::P, ROWS = C::ROWS, NT = C::NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = p.l_sel;
  const int nsub = (L + KC - 1) / KC;
  const int NB = (p.S_kv + L - 1) / L;
  Item it;
  if (!decode_item(a, p, NB, blockIdx.x / nsub, it)) return;
  const int sub = blockIdx.x % nsub;
  const int b = it.b, g = it.g, h = p.h, Dk = p.Dk, Dv = p.Dv;
  const int k0 = it.jb * L + sub * KC;
  const int nk = max(min(min(KC, L - sub * KC), p.S_kv - k0), 0);
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, g8 = lane >> 2, t4 = lane & 3;
  const int kw0 = 16 * w;   // this warp's keys in the tile
  const float sl2 = p.scale * LOG2E;

  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + C::K);
  __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + C::V);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + C::Q);     // [2][ROWS][P]
  __nv_bfloat16* do_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + C::DO);   // [2][ROWS][P]
  __nv_bfloat16* ds_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + C::DS);   // [KC][RP]
  float* lse_s = reinterpret_cast<float*>(smem_raw + C::STATS);               // [2][ROWS]
  float* dl_s = lse_s + 2 * ROWS;
  int* tp_s = reinterpret_cast<int*>(dl_s + 2 * ROWS);
  int* rk_s = tp_s + 2 * ROWS;
  int* tok_s = rk_s + 2 * ROWS;

  const __nv_bfloat16* Q = static_cast<const __nv_bfloat16*>(a.Q);
  const __nv_bfloat16* dO = static_cast<const __nv_bfloat16*>(a.dO);
  const __nv_bfloat16* K = static_cast<const __nv_bfloat16*>(a.K);
  const __nv_bfloat16* V = static_cast<const __nv_bfloat16*>(a.V);
  const size_t bg = (size_t)b * p.G + g;
  const size_t lst = bg * NB + it.jb;
  const int* list = a.inv + lst * p.inv_pitch;
  const int* ranks = a.rank + lst * p.inv_pitch;

  // head-width padding: columns [D, DT) of every tile stay zero
  constexpr int ZROWS = KC > 2 * ROWS ? KC : 2 * ROWS;
  for (int idx = tid; idx < ZROWS * (DT / 8); idx += TC_THREADS) {
    const int r = idx / (DT / 8), c = (idx % (DT / 8)) * 8;
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    if (r < KC && c >= Dk) *reinterpret_cast<uint4*>(k_s + r * P + c) = z;
    if (r < KC && c >= Dv) *reinterpret_cast<uint4*>(v_s + r * P + c) = z;
    if (r < 2 * ROWS) {
      if (c >= Dk) *reinterpret_cast<uint4*>(q_s + r * P + c) = z;
      if (c >= Dv) *reinterpret_cast<uint4*>(do_s + r * P + c) = z;
    }
  }
  // the K/V tile; keys past the block or S_kv read as zeros
  for (int idx = tid; idx < KC * (Dk / 8); idx += TC_THREADS) {
    const int r = idx / (Dk / 8), c = (idx % (Dk / 8)) * 8;
    const bool ok = r < nk;
    tc::cp_async16(k_s + r * P + c, ok ? K + (bg * p.S_kv + k0 + r) * Dk + c : K, ok);
  }
  for (int idx = tid; idx < KC * (Dv / 8); idx += TC_THREADS) {
    const int r = idx / (Dv / 8), c = (idx % (Dv / 8)) * 8;
    const bool ok = r < nk;
    tc::cp_async16(v_s + r * P + c, ok ? V + (bg * p.S_kv + k0 + r) * Dv + c : V, ok);
  }

  // global row (b, s, g, head) of chunk row r whose token is s
  auto grow = [&](int s, int r) -> size_t {
    return (((size_t)b * p.S + s) * p.G + g) * h + r % h;
  };
  // gathers the chunk of member tokens [i0, i0 + TQ) into buffer `buf`:
  // Q/dO rows by cp.async (padded rows zero-filled), row statistics,
  // positions, ranks and tokens by plain loads
  auto issue = [&](int i0, int buf) {
    const int rows = min(p.TQ, it.i1 - i0) * h;
    __nv_bfloat16* qb = q_s + buf * ROWS * P;
    __nv_bfloat16* ob = do_s + buf * ROWS * P;
    for (int idx = tid; idx < ROWS * (Dk / 8); idx += TC_THREADS) {
      const int r = idx / (Dk / 8), c = (idx % (Dk / 8)) * 8;
      const bool ok = r < rows;
      tc::cp_async16(qb + r * P + c, ok ? Q + grow(list[i0 + r / h], r) * Dk + c : Q, ok);
    }
    for (int idx = tid; idx < ROWS * (Dv / 8); idx += TC_THREADS) {
      const int r = idx / (Dv / 8), c = (idx % (Dv / 8)) * 8;
      const bool ok = r < rows;
      tc::cp_async16(ob + r * P + c, ok ? dO + grow(list[i0 + r / h], r) * Dv + c : dO, ok);
    }
    for (int r = tid; r < ROWS; r += TC_THREADS) {
      const int o = buf * ROWS + r;
      if (r < rows) {
        const int s = list[i0 + r / h];
        const size_t gr = grow(s, r);
        lse_s[o] = a.lse[gr] * LOG2E;
        dl_s[o] = a.delta[gr];
        tp_s[o] = a.tpos[(size_t)b * p.S + s];
        rk_s[o] = a.ws != nullptr ? ranks[i0 + r / h] : 0;
        tok_s[o] = s;
      } else {
        lse_s[o] = 0.f;
        dl_s[o] = 0.f;
        tp_s[o] = -1;   // no key is visible to a padded row
        rk_s[o] = tok_s[o] = 0;
      }
    }
  };

  float dk[DT / 8][4], dv[DT / 8][4];
#pragma unroll
  for (int i = 0; i < DT / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

  issue(it.i0, 0);
  tc::cp_async_commit();
  int buf = 0;
  for (int i0 = it.i0; i0 < it.i1; i0 += p.TQ, buf ^= 1) {
    if (i0 + p.TQ < it.i1) {   // the next chunk's gather overlaps this chunk's math
      issue(i0 + p.TQ, buf ^ 1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    // (dO * g).astype(bf16) of each staged row (sel_flash.py:781): a thread
    // scales the 16-byte pieces it staged itself (issue's mapping, which
    // gate_rows shares at TC_THREADS), so the barrier below publishes them
    if (GATED)
      gate_rows(do_s + buf * ROWS * P, P, min(p.TQ, it.i1 - i0) * h, Dv,
                [&](int r) { return gate[((size_t)b * p.S + list[i0 + r / h]) * p.G + g]; });
    __syncthreads();
    const __nv_bfloat16* qb = q_s + buf * ROWS * P;
    const __nv_bfloat16* ob = do_s + buf * ROWS * P;
    const float* lse_b = lse_s + buf * ROWS;
    const float* dl_b = dl_s + buf * ROWS;
    const int* tp_b = tp_s + buf * ROWS;

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
    // P and dS in place (C element e: key kw0 + g8 (+8 for e >= 2), row 8j + 2 t4 + (e & 1))
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kw0 + g8 + (e >> 1) * 8, r = 8 * j + 2 * t4 + (e & 1);
        const bool vis = key < nk && k0 + key <= tp_b[r];
        const float pr = vis ? exp2f(st[j][e] * sl2 - lse_b[r]) : 0.f;
        st[j][e] = pr;
        dpt[j][e] = pr * (dpt[j][e] - dl_b[r]);
      }
    // dV += P^T dO, dK += dS^T Q (P and dS rounded to bf16 in the A fragments)
    tc::mma_tile<DT / 8, ROWS / 16, true>(
        dv, [&](int ks, uint32_t (&f)[4]) { tc::a_from_c(f, st[2 * ks], st[2 * ks + 1]); }, ob,
        P);
    tc::mma_tile<DT / 8, ROWS / 16, true>(
        dk, [&](int ks, uint32_t (&f)[4]) { tc::a_from_c(f, dpt[2 * ks], dpt[2 * ks + 1]); },
        qb, P);
    if (a.ws != nullptr) {
      // dS^T to shared memory, then dQ = dS K: warp w takes row tile rt,
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
      const int rows = min(p.TQ, it.i1 - i0) * h;
      const size_t stride = (size_t)p.B * p.S * p.G * h * Dk;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = 16 * rt + g8 + 8 * hf;
        if (r >= rows) continue;
        const int o = buf * ROWS + r;
        float* dst = a.ws + (size_t)(rk_s[o] * nsub + sub) * stride + grow(tok_s[o], r) * Dk;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int dim = dq0 + 8 * i + 2 * t4;
          if (dim < Dk)
            *reinterpret_cast<float2*>(dst + dim) = make_float2(dq[i][2 * hf], dq[i][2 * hf + 1]);
        }
      }
    }
    __syncthreads();   // this buffer (and dS^T) is refilled next
  }
  // the item's partial: rows (slot, sub, key) of width Dk / Dv
  const size_t row0 = ((size_t)it.slot * nsub + sub) * KC + kw0 + g8;
  float* part_k = a.part;
  float* part_v = a.part + (size_t)p.n_work * nsub * KC * Dk;
#pragma unroll
  for (int i = 0; i < DT / 8; ++i) {
    const int dim = 8 * i + 2 * t4;
    if (dim < Dk) {
      *reinterpret_cast<float2*>(part_k + row0 * Dk + dim) = make_float2(dk[i][0], dk[i][1]);
      *reinterpret_cast<float2*>(part_k + (row0 + 8) * Dk + dim) = make_float2(dk[i][2], dk[i][3]);
    }
    if (dim < Dv) {
      *reinterpret_cast<float2*>(part_v + row0 * Dv + dim) = make_float2(dv[i][0], dv[i][1]);
      *reinterpret_cast<float2*>(part_v + (row0 + 8) * Dv + dim) = make_float2(dv[i][2], dv[i][3]);
    }
  }
}

template <int DT>
__global__ void __launch_bounds__(TC_THREADS) sel_bwd_kv_mma_kernel(KvArgs a, KvParams p) {
  kv_mma_body<DT, false>(a, p, nullptr);
}

template <int DT>
__global__ void __launch_bounds__(TC_THREADS)
gated_sel_bwd_kv_mma_kernel(KvArgs a, KvParams p, const float* __restrict__ gate) {
  kv_mma_body<DT, true>(a, p, gate);
}

// ------------------------------------------------------------ reduction

// out[b, g, key, :] = mul * (sum over the items of the key's block, in slot
// order, of their partial row), cast to T; every key below S_kv.
template <typename T>
__global__ void __launch_bounds__(THREADS)
sel_bwd_reduce_kernel(const float* __restrict__ part, const int* __restrict__ span,
                      T* __restrict__ out, KvParams p, int D, float mul) {
  const int L = p.l_sel, nsub = (L + KC - 1) / KC, NB = (p.S_kv + L - 1) / L;
  const int d4 = D / 4;
  const long long n = (long long)p.B * p.G * p.S_kv * d4;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * THREADS) {
    const long long row = i / d4;                  // (b*G + g) * S_kv + key
    const int c = (int)(i - row * d4) * 4;
    const int key = (int)(row % p.S_kv);
    const long long bg = row / p.S_kv;
    const int jb = key / L, kin = key - jb * L;
    const long long blk = bg * NB + jb;
    const int first = span[2 * blk], items = span[2 * blk + 1];
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int it = 0; it < items; ++it) {
      const float4 x = *reinterpret_cast<const float4*>(
          part + (((size_t)(first + it) * nsub + kin / KC) * KC + kin % KC) * D + c);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    store4<T>(out + row * D + c, make_float4(acc.x * mul, acc.y * mul, acc.z * mul, acc.w * mul));
  }
}

template <typename T>
int reduce(const float* part, const int* span, void* out, const KvParams& p, int D, float mul,
           cudaStream_t stream) {
  const long long want = ((long long)p.B * p.G * p.S_kv * (D / 4) + THREADS - 1) / THREADS;
  const unsigned grid = (unsigned)(want < 8192 ? want : 8192);
  sel_bwd_reduce_kernel<T><<<grid, THREADS, 0, stream>>>(part, span, static_cast<T*>(out), p, D,
                                                         mul);
  return (int)cudaGetLastError();
}

template <typename T>
int finish(const KvArgs& a, const KvParams& p, cudaStream_t stream) {
  const int nsub = (p.l_sel + KC - 1) / KC;
  int e = reduce<T>(a.part, a.span, a.dK, p, p.Dk, p.scale, stream);
  if (e != 0) return e;
  e = reduce<T>(a.part + (size_t)p.n_work * nsub * KC * p.Dk, a.span, a.dV, p, p.Dv, 1.f, stream);
  if (e != 0 || a.ws == nullptr) return e;
  const long long rows = (long long)p.B * p.S * p.G * p.h;
  return sum_slots<T>(a.ws, a.dQ, rows, p.Dk, SelSlots{a.nblk, p.h, nsub}, p.scale, stream);
}

template <typename Kern, typename... Gate>
int launch_grid(Kern kernel, int threads, size_t smem, const KvArgs& a, const KvParams& p,
                cudaStream_t stream, Gate... gate) {
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)((long long)p.n_work * ((p.l_sel + KC - 1) / KC));
  kernel<<<grid, threads, smem, stream>>>(a, p, gate...);
  return (int)cudaGetLastError();
}

template <int NSK, int NSV>
int launch_fma_ns(const KvArgs& a, const KvParams& p, cudaStream_t stream, const float* gate) {
  const size_t smem = FmaSmem(p.Dk, p.Dv).total * sizeof(float);
  if (gate != nullptr)
    return launch_grid(gated_sel_bwd_kv_fma_kernel<NSK, NSV>, THREADS, smem, a, p, stream,
                       gate);
  return launch_grid(sel_bwd_kv_fma_kernel<NSK, NSV>, THREADS, smem, a, p, stream);
}

int launch_fma(const KvArgs& a, const KvParams& p, cudaStream_t stream, const float* gate) {
  const int nk = kv_slices(p.Dk), nv = kv_slices(p.Dv);
  if (nk == 1 && nv == 1) return launch_fma_ns<1, 1>(a, p, stream, gate);
  if (nk == 1) return launch_fma_ns<1, 2>(a, p, stream, gate);
  if (nv == 1) return launch_fma_ns<2, 1>(a, p, stream, gate);
  return launch_fma_ns<2, 2>(a, p, stream, gate);
}

template <int DT>
int launch_mma(const KvArgs& a, const KvParams& p, cudaStream_t stream, const float* gate) {
  if (gate != nullptr)
    return launch_grid(gated_sel_bwd_kv_mma_kernel<DT>, TC_THREADS, Mma<DT>::BYTES, a, p, stream,
                       gate);
  return launch_grid(sel_bwd_kv_mma_kernel<DT>, TC_THREADS, Mma<DT>::BYTES, a, p, stream);
}

}  // namespace

int kv_rows(int dtype, int Dk, int Dv) {
  if (dtype == DT_F32) return MAX_ROWS;
  return (Dk > 64 || Dv > 64) ? Mma<128>::ROWS : Mma<64>::ROWS;
}

long long kv_smem_bytes(int dtype, int Dk, int Dv) {
  if (dtype == DT_F32) return (long long)(FmaSmem(Dk, Dv).total * sizeof(float));
  return (long long)((Dk > 64 || Dv > 64) ? Mma<128>::BYTES : Mma<64>::BYTES);
}

int launch_kv(int dtype, const KvArgs& a, const KvParams& p, cudaStream_t stream,
              const float* gate) {
  if (p.l_sel <= 0 || p.S_kv <= 0 || p.h <= 0 || p.TQ <= 0 || p.TQ * p.h > kv_rows(dtype, p.Dk, p.Dv) ||
      p.per % p.TQ != 0 || p.Dk % 8 != 0 || p.Dv % 8 != 0 || p.Dk > 128 || p.Dv > 128 ||
      a.part == nullptr || (a.ws != nullptr && (a.rank == nullptr || a.nblk == nullptr)))
    return (int)cudaErrorInvalidValue;
  int e;
  if (dtype == DT_F32) {
    e = launch_fma(a, p, stream, gate);
    return e != 0 ? e : finish<float>(a, p, stream);
  }
  if (dtype != DT_BF16) return (int)cudaErrorInvalidValue;
  e = p.Dk > 64 || p.Dv > 64 ? launch_mma<128>(a, p, stream, gate)
                             : launch_mma<64>(a, p, stream, gate);
  return e != 0 ? e : finish<__nv_bfloat16>(a, p, stream);
}

}  // namespace sel
}  // namespace nsa

extern "C" {

int nsa_sel_attn_bwd_kv_rows(int dtype, int Dk, int Dv) { return nsa::sel::kv_rows(dtype, Dk, Dv); }

long long nsa_sel_attn_bwd_1p_smem_bytes(int dtype, int Dk, int Dv) {
  return nsa::sel::kv_smem_bytes(dtype, Dk, Dv);
}

// inv/rank [B,G,NB,inv_pitch] int32: row (b, g, block) lists the member
// query rows s (ascending) whose selection set holds the block, and the
// block's rank among each member's distinct visible blocks; cnt [B,G,NB]
// their number; work [n_work,3] / span [B*G*NB,2] int32: the work list
// (sel_bwd.cuh), items of `per` tokens; nblk [B,S,G] each row's distinct
// visible blocks. part: f32 scratch of n_work * ceil(l_sel/64) * 64 *
// (Dk+Dv) floats; ws: f32 dQ slots, max(nblk) * ceil(l_sel/64) *
// B*S*G*h*Dk floats (at most min(n, NB) blocks per row). gate [B,S,G] f32
// (or null: ungated): the gradients of dO * g rounded to the dtype.
int nsa_sel_attn_bwd_1p(int dtype, const void* Q, const void* K, const void* V, const void* dO,
                        const float* lse, const float* delta, const float* gate,
                        const int* tpos, const int* inv,
                        const int* cnt, const int* rank, const int* work, const int* span,
                        const int* nblk, void* dQ, void* dK, void* dV, float* part, float* ws,
                        int B, int S, int S_kv, int G, int h, int Dk, int Dv, int l_sel,
                        int inv_pitch, int n_work, int TQ, int per, float scale, void* stream) {
  if (ws == nullptr) return (int)cudaErrorInvalidValue;
  const nsa::sel::KvArgs a{Q, K, V, dO, lse, delta, tpos, inv, cnt, rank, work, span, nblk,
                           dQ, dK, dV, part, ws};
  const nsa::sel::KvParams p{B, S, S_kv, G, h, Dk, Dv, l_sel, inv_pitch, n_work, TQ, per, scale};
  return nsa::sel::launch_kv(dtype, a, p, static_cast<cudaStream_t>(stream), gate);
}

}  // extern "C"
