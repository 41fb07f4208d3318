// sel_attn_fwd_mma: the bf16 prefill selection forward on tensor cores.
//
// Replaces: nsa_vibe_tpu/ops/pallas/sel_flash.py::selection_flash_pallas
// (kernel _sel_flash_kernel: per q tile, the union of the tile's selected
// blocks, each row masked by its own set) for bf16 operands; f32 keeps the
// FMA kernel of sel_attn.cu (its 5e-5 gates rule out TF32).
//
// What it computes, per query (b, s) and KV group g, for all h heads of the
// group: softmax over the keys of the row's selected blocks taken as a SET
// (-1 slots and repeated ids add nothing), key positions <= t = tpos[b, s]
// and < S_kv; a row with no visible key returns 0. With lse != nullptr
// also lse [B,S,G,h] f32 = m + log(l) (natural base), EMPTY_LSE for a row
// with no key, as sel_attn.cu.
//
// What bounds it on the H100: at the m7c train shape (B=8, S=2048, G=2,
// h=6, D=64, n=16 blocks of 64) two products of 2 FLOP per visible (row,
// key) pair, ~0.05 TFLOP: ~0.05 ms of bf16 tensor-core time; the distinct
// bytes (Q, O and the K/V blocks in use) take ~0.02 ms. The FMA design
// (sel_attn.cu) instead gathers every selected block for every query from
// L2 into shared memory as f32 and feeds f32 FMAs from it.
// Design, the TPU kernel's cut for Hopper: one CTA of 4 warps per (b, g,
// q tile of T tokens, T*h <= 64 rows; warp w owns rows [16w, 16w+16),
// row r = token r / h, head r % h).
//   - Prologue: the tile's T*n ids of sel_idx mark the visible blocks in a
//     shared bitmap over the NB = ceil(S_kv / l_sel) blocks; a block scan
//     of the words' popcounts compacts it into the union, ascending, and
//     gives each token a membership bitmask over the union positions. No
//     host sync, no tables in device memory.
//   - Main loop over the union's key tiles of 64 keys (a block of l_sel
//     keys is ceil(l_sel / 64) tiles), K/V double-buffered through
//     cp.async (zero-filled past a partial block or S_kv, so padding
//     memory, which may hold NaN, never enters a product). S = Q K^T on
//     mma.m16n8k16 (tc.cuh) with Q's fragments held in registers;
//     membership, key <= t and key < S_kv masked in the fragments; a warp
//     none of whose rows holds the tile's block skips it. Online softmax
//     per row in f32 (base 2, scale * log2(e) folded into the logits; the
//     running max floored at -1e20, so a row with no visible key in a tile
//     adds exactly 0); l sums the unrounded p, as sel_flash.py:154 does. P
//     is rounded to bf16 as the A operand of O += P V (the TPU kernel's
//     p.astype(v.dtype), sel_flash.py:157), formed from the accumulators
//     in registers (tc::a_from_c) without touching shared memory.
//   - Padded rows (r >= T*h) read zero-filled Q with position -1: P = 0,
//     nothing is stored.
#include "common.cuh"
#include "tc.cuh"

using namespace nsa;

namespace {

constexpr int ROWS = 64;      // query rows (tokens x heads) per q tile
constexpr int KC = 64;        // keys per K/V tile
constexpr int THREADS = 128;  // 4 warps, 16 rows each
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float M_FLOOR = -1e20f;

struct Params {
  int S, S_kv, G, h, Dk, Dv, n, l_sel, qT, NB, U, W;
  float scale;
};

// Shared memory (bytes): Q, K[2], V[2] (bf16, pitch DT+8); per row its
// position; the block bitmap and each word's exclusive popcount prefix
// (NW = ceil(NB/32) words each); the union (U ids); the tokens'
// membership words (qT x W).
template <int DT>
struct Layout {
  static constexpr int P = DT + 8;
  static constexpr size_t TILE = (size_t)ROWS * P * 2;   // = KC keys
  static constexpr size_t Q = 0, K = TILE, V = 3 * TILE, TP = 5 * TILE;
  static constexpr size_t BITS = TP + (size_t)ROWS * 4;
  static size_t bytes(int NB, int U, int qT, int W) {
    const int NW = (NB + 31) / 32;
    return BITS + (size_t)(2 * NW + U + qT * W) * 4;
  }
};

// GATED (the gate-epilogue fold, sel_flash.py:169): O = (acc / l) * g in
// f32 before the cast, g the row's gate [B,S,G] f32; lse stays the ungated
// softmax's. The entries: sel_attn_union_kernel (ungated, compiled as
// before) and gated_sel_attn_union_kernel, over this one body.
template <int DT, bool GATED>
__device__ __forceinline__ void union_body(const __nv_bfloat16* __restrict__ Q,
                                           const __nv_bfloat16* __restrict__ K,
                                           const __nv_bfloat16* __restrict__ V,
                                           const int* __restrict__ sel,
                                           const int* __restrict__ tpos,
                                           const float* __restrict__ gate,
                                           __nv_bfloat16* __restrict__ O,
                                           float* __restrict__ lse, const Params& p) {
  using C = Layout<DT>;
  constexpr int P = C::P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int warp_tot[THREADS / 32];
  const int nq = (p.S + p.qT - 1) / p.qT;
  const int qt = blockIdx.x % nq;
  const int bg = blockIdx.x / nq;   // b * G + g
  const int g = bg % p.G, b = bg / p.G;
  const int s0 = qt * p.qT;
  const int T = min(p.qT, p.S - s0);   // live tokens of the tile
  const int h = p.h, Dk = p.Dk, Dv = p.Dv, L = p.l_sel, W = p.W, n = p.n;
  const int R = T * h;                 // live rows
  const int NW = (p.NB + 31) / 32;
  const int nsub = (L + KC - 1) / KC;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, g8 = lane >> 2, t4 = lane & 3;
  const float sl2 = p.scale * LOG2E;

  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + C::Q);
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + C::K);   // [2][KC][P]
  __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + C::V);   // [2][KC][P]
  int* tp_s = reinterpret_cast<int*>(smem_raw + C::TP);                     // [ROWS]
  unsigned* bits_s = reinterpret_cast<unsigned*>(smem_raw + C::BITS);       // [NW]
  int* wpre_s = reinterpret_cast<int*>(bits_s + NW);                        // [NW]
  int* order_s = wpre_s + NW;                                               // [U]
  unsigned* mask_s = reinterpret_cast<unsigned*>(order_s + p.U);            // [qT][W]

  // global row of tile row r: token s0 + r / h, head r % h
  auto grow = [&](int r) -> size_t {
    return (((size_t)b * p.S + s0 + r / h) * p.G + g) * h + r % h;
  };
  // head-width padding: columns [D, DT) stay zero
  for (int idx = tid; idx < ROWS * (DT / 8); idx += THREADS) {
    const int r = idx / (DT / 8), c = (idx % (DT / 8)) * 8;
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    if (c >= Dk) {
      *reinterpret_cast<uint4*>(q_s + r * P + c) = z;
      *reinterpret_cast<uint4*>(k_s + r * P + c) = z;
      *reinterpret_cast<uint4*>(k_s + (KC + r) * P + c) = z;
    }
    if (c >= Dv) {
      *reinterpret_cast<uint4*>(v_s + r * P + c) = z;
      *reinterpret_cast<uint4*>(v_s + (KC + r) * P + c) = z;
    }
  }
  for (int idx = tid; idx < ROWS * (Dk / 8); idx += THREADS) {
    const int r = idx / (Dk / 8), c = (idx % (Dk / 8)) * 8;
    tc::cp_async16(q_s + r * P + c, r < R ? Q + grow(r) * Dk + c : Q, r < R);
  }
  for (int r = tid; r < ROWS; r += THREADS)
    tp_s[r] = r < R ? tpos[(size_t)b * p.S + s0 + r / h] : -1;   // padded rows see no key
  for (int i = tid; i < NW; i += THREADS) bits_s[i] = 0u;
  for (int i = tid; i < p.qT * W; i += THREADS) mask_s[i] = 0u;
  __syncthreads();

  // the tile's visible ids: slot idx = token * n + j
  auto visible_id = [&](int idx) -> int {
    const int tok = idx / n;
    const size_t row = ((size_t)b * p.S + s0 + tok) * p.G + g;
    const int id = sel[row * n + idx % n];
    const int t = tp_s[tok * h];
    return (id >= 0 && id < p.NB && (long long)id * L <= t) ? id : -1;
  };
  for (int idx = tid; idx < T * n; idx += THREADS) {
    const int id = visible_id(idx);
    if (id >= 0) atomicOr(&bits_s[id >> 5], 1u << (id & 31));
  }
  __syncthreads();
  // compaction: thread tid owns words [tid*cw, tid*cw + cw); exclusive scan
  // of their popcounts over the block gives each word's first union position
  const int cw = (NW + THREADS - 1) / THREADS;
  const int w0 = min(tid * cw, NW), w1 = min(w0 + cw, NW);
  int cnt = 0;
  for (int i = w0; i < w1; ++i) cnt += __popc(bits_s[i]);
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_tot[w] = incl;
  __syncthreads();
  int pos = incl - cnt, total = 0;
#pragma unroll
  for (int i = 0; i < THREADS / 32; ++i) {
    pos += i < w ? warp_tot[i] : 0;
    total += warp_tot[i];
  }
  for (int i = w0; i < w1; ++i) {
    wpre_s[i] = pos;
    for (unsigned m = bits_s[i]; m != 0u; m &= m - 1u) order_s[pos++] = 32 * i + __ffs(m) - 1;
  }
  __syncthreads();
  for (int idx = tid; idx < T * n; idx += THREADS) {
    const int id = visible_id(idx);
    if (id < 0) continue;
    const int u = wpre_s[id >> 5] + __popc(bits_s[id >> 5] & ((1u << (id & 31)) - 1u));
    atomicOr(&mask_s[(idx / n) * W + (u >> 5)], 1u << (u & 31));
  }
  __syncthreads();

  const int J = total * nsub;   // key tiles of the union
  const __nv_bfloat16* Kbg = K + (size_t)bg * p.S_kv * Dk;
  const __nv_bfloat16* Vbg = V + (size_t)bg * p.S_kv * Dv;
  auto tile_keys = [&](int j, int& k0) {   // first key and key count of union tile j
    const int sub = j % nsub;
    k0 = order_s[j / nsub] * L + sub * KC;
    return max(min(min(KC, L - sub * KC), p.S_kv - k0), 0);
  };
  auto issue = [&](int j, int buf) {
    int k0;
    const int nk = tile_keys(j, k0);
    __nv_bfloat16* kb = k_s + buf * KC * P;
    __nv_bfloat16* vb = v_s + buf * KC * P;
    for (int idx = tid; idx < KC * (Dk / 8); idx += THREADS) {
      const int r = idx / (Dk / 8), c = (idx % (Dk / 8)) * 8;
      tc::cp_async16(kb + r * P + c, r < nk ? Kbg + (size_t)(k0 + r) * Dk + c : K, r < nk);
    }
    for (int idx = tid; idx < KC * (Dv / 8); idx += THREADS) {
      const int r = idx / (Dv / 8), c = (idx % (Dv / 8)) * 8;
      tc::cp_async16(vb + r * P + c, r < nk ? Vbg + (size_t)(k0 + r) * Dv + c : V, r < nk);
    }
  };

  float o[DT / 8][4];
#pragma unroll
  for (int i = 0; i < DT / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m2[2] = {M_FLOOR, M_FLOOR}, lsum[2] = {0.f, 0.f};   // this thread's two rows
  uint32_t qf[DT / 16][4];
  const int r0 = 16 * w;   // this warp's rows
  const int rows[2] = {r0 + g8, r0 + g8 + 8};
  const int tr[2] = {tp_s[rows[0]], tp_s[rows[1]]};
  const int tok[2] = {min(rows[0] / h, p.qT - 1), min(rows[1] / h, p.qT - 1)};
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
    if (j == 0 && r0 < R) {
#pragma unroll
      for (int ks = 0; ks < DT / 16; ++ks) tc::ldsm_x4(qf[ks], tc::a_addr(q_s, P, r0, 16 * ks));
    }
    const int u = j / nsub;
    bool mem[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      mem[hf] = rows[hf] < R && ((mask_s[tok[hf] * W + (u >> 5)] >> (u & 31)) & 1u);
    if (__any_sync(FULL, mem[0] || mem[1])) {
      int k0;
      const int nk = tile_keys(j, k0);
      const __nv_bfloat16* kb = k_s + buf * KC * P;
      const __nv_bfloat16* vb = v_s + buf * KC * P;
      float s[KC / 8][4];
#pragma unroll
      for (int i = 0; i < KC / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
      tc::mma_tile<KC / 8, DT / 16, false>(
          s, [&](int ks, uint32_t (&f)[4]) {
#pragma unroll
            for (int e = 0; e < 4; ++e) f[e] = qf[ks][e];
          },
          kb, P);
      // C element e of n-tile i: row rows[e >> 1], key 8i + 2 t4 + (e & 1)
      float mx[2] = {NEG, NEG};
#pragma unroll
      for (int i = 0; i < KC / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hf = e >> 1, key = 8 * i + 2 * t4 + (e & 1);
          const bool vis = mem[hf] && key < nk && k0 + key <= tr[hf];
          s[i][e] = vis ? s[i][e] * sl2 : NEG;
          mx[hf] = fmaxf(mx[hf], s[i][e]);
        }
      float alpha[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {   // the row's four threads hold its 64 keys
        mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(FULL, mx[hf], 1));
        mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(FULL, mx[hf], 2));
        const float m_new = fmaxf(m2[hf], mx[hf]);   // >= M_FLOOR: finite
        alpha[hf] = exp2f(m2[hf] - m_new);
        m2[hf] = m_new;
        lsum[hf] *= alpha[hf];
      }
#pragma unroll
      for (int i = 0; i < KC / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pr = exp2f(s[i][e] - m2[e >> 1]);   // masked: exp2(-FLT_MAX - m) = 0
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
  tc::cp_async_wait<0>();   // a tile with no union block still staged Q
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float l = lsum[hf];
    l += __shfl_xor_sync(FULL, l, 1);
    l += __shfl_xor_sync(FULL, l, 2);
    const int r = rows[hf];
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

template <int DT>
__global__ void __launch_bounds__(THREADS)
sel_attn_union_kernel(const __nv_bfloat16* __restrict__ Q, const __nv_bfloat16* __restrict__ K,
                      const __nv_bfloat16* __restrict__ V, const int* __restrict__ sel,
                      const int* __restrict__ tpos, __nv_bfloat16* __restrict__ O,
                      float* __restrict__ lse, Params p) {
  union_body<DT, false>(Q, K, V, sel, tpos, nullptr, O, lse, p);
}

template <int DT>
__global__ void __launch_bounds__(THREADS)
gated_sel_attn_union_kernel(const __nv_bfloat16* __restrict__ Q,
                            const __nv_bfloat16* __restrict__ K,
                            const __nv_bfloat16* __restrict__ V, const int* __restrict__ sel,
                            const int* __restrict__ tpos, const float* __restrict__ gate,
                            __nv_bfloat16* __restrict__ O, float* __restrict__ lse, Params p) {
  union_body<DT, true>(Q, K, V, sel, tpos, gate, O, lse, p);
}

template <int DT>
int launch(const void* Q, const void* K, const void* V, const int* sel, const int* tpos,
           const float* gate, void* O, float* lse, int B, const Params& p, cudaStream_t stream) {
  const size_t smem = Layout<DT>::bytes(p.NB, p.U, p.qT, p.W);
  const long long grid = (long long)B * p.G * ((p.S + p.qT - 1) / p.qT);
  const auto* q = static_cast<const __nv_bfloat16*>(Q);
  const auto* k = static_cast<const __nv_bfloat16*>(K);
  const auto* v = static_cast<const __nv_bfloat16*>(V);
  auto* o = static_cast<__nv_bfloat16*>(O);
  if (gate != nullptr)
    return launch_kernel(gated_sel_attn_union_kernel<DT>, grid, THREADS, smem, stream, q, k, v,
                         sel, tpos, gate, o, lse, p);
  return launch_kernel(sel_attn_union_kernel<DT>, grid, THREADS, smem, stream, q, k, v, sel, tpos,
                       o, lse, p);
}

Params make_params(int S, int S_kv, int G, int h, int Dk, int Dv, int n, int l_sel, int qT,
                   float scale) {
  const int NB = (S_kv + l_sel - 1) / l_sel;
  const int U = min(NB, qT * n);
  return Params{S, S_kv, G, h, Dk, Dv, n, l_sel, qT, NB, U, (U + 31) / 32, scale};
}

}  // namespace

extern "C" {

long long nsa_sel_attn_union_smem_bytes(int S_kv, int Dk, int Dv, int n, int l_sel, int qT) {
  const Params p = make_params(1, S_kv, 1, 1, Dk, Dv, n, l_sel, qT, 1.f);
  return (long long)((Dk > 64 || Dv > 64) ? Layout<128>::bytes(p.NB, p.U, qT, p.W)
                                          : Layout<64>::bytes(p.NB, p.U, qT, p.W));
}

// bf16 only. Q [B,S,G,h,Dk], K [B,G,S_kv,Dk], V [B,G,S_kv,Dv], sel [B,S,G,n]
// int32, tpos [B,S] int32, gate [B,S,G] f32 (or null: ungated) -> O
// [B,S,G,h,Dv] (times the row's gate), lse [B,S,G,h] f32 (or null). q tiles
// of qT tokens, qT * h <= 64; Dk, Dv <= 128 and multiples of 8.
int nsa_sel_attn_union(const void* Q, const void* K, const void* V, const int* sel,
                       const int* tpos, const float* gate, void* O, float* lse, int B, int S,
                       int S_kv, int G, int h,
                       int Dk, int Dv, int n, int l_sel, int qT, float scale, void* stream) {
  if (n <= 0 || l_sel <= 0 || S_kv <= 0 || h <= 0 || qT <= 0 || qT * h > ROWS ||
      Dk % 8 != 0 || Dv % 8 != 0 || Dk > 128 || Dv > 128)
    return (int)cudaErrorInvalidValue;
  const Params p = make_params(S, S_kv, G, h, Dk, Dv, n, l_sel, qT, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dk > 64 || Dv > 64) return launch<128>(Q, K, V, sel, tpos, gate, O, lse, B, p, s);
  return launch<64>(Q, K, V, sel, tpos, gate, O, lse, B, p, s);
}

}  // extern "C"
