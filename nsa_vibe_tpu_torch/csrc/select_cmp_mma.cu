// select_cmp_mma: the fused NSA selection scorer (Eq. 8-12) and
// compressed-branch forward, for bf16 operands, on tensor cores.
//
// Replaces, for bf16 operands (the serving and training dtype):
// nsa_vibe_tpu/ops/pallas/scorer.py::nsa_select_and_cmp_pallas (kernel
// _select_cmp_kernel, top-n epilogue _scorer_topn). f32 keeps the FMA
// kernel of select_cmp.cu (its 5e-5 gates rule out TF32).
//
// What it computes: select_cmp.cu's contract. Per query row (token t, head
// of group g) p = softmax(scale q . K_cmp^T) over c < num_cmp(t+1) (Eq. 8),
// O_cmp = p V_cmp, optionally lse = m + log(l) (natural base, EMPTY_LSE
// for rows t < l-1 that see no compressed token); per token the group's
// heads mapped onto the selection blocks by M_csl (Eq. 9-10), the forced
// blocks and the top-n (Eq. 11-12). As the TPU kernel does, P is rounded
// to bf16 as the operand of P V (p.astype(v.dtype), scorer.py:388) and
// kept in f32 for p . M (scorer.py:383-385). With ds [B,S] (packed
// documents) a row sees only the tokens c >= ceil(ds/d) (none: O = 0, lse
// EMPTY_LSE, p = 0) and the top-n stays in its document's blocks
// (select_blocks.cuh::top_n); pass 2 starts at the key tile of the tile's
// first token's first visible token.
//
// What bounds it on the H100: at the m7c serving shape (B=4, S=2048, G=2,
// h=6, D=64, S_cmp=127, S_sel=32) the products are ~2 GFLOP on the bf16
// tensor cores (~0.002 ms) against ~25 MB of Q and O (~0.008 ms): bytes
// bound it. The FMA kernel of select_cmp.cu, which bf16 ran before, is held
// back by its f32 arithmetic and by accumulators in shared memory that
// every chunk reads, rescales and writes back (PERF.md has both times).
//
// Design: two walks this port already has, run in one CTA over the same
// 64-token tiles of K_cmp at absolute multiples of 64. One CTA of ROWS /
// 16 warps (ROWS = 64 or 128; the launch's block size) per (b, g, q tile
// of TQ <= ROWS / h tokens; row = token * h + head), the q tiles from the
// last (the heaviest) down.
//   1. The compressed-prefix walk of the bf16 banded forward
//      (banded_fwd_mma.cuh::band_fwd in CMP mode): Q staged once, K/V
//      tiles double-buffered by cp.async, S = Q K^T and O += P V on
//      mma.sync, the base-2 online softmax with its max floored at -1e20,
//      P rounded to bf16 for P V; it writes O (and lse) and keeps each
//      row's lse2 = m + log2(l). The same device code on the same tiles
//      gives banded_attn(mode="cmp")'s bits for O and lse, whatever TQ.
//   2. The second pass of the select-only scorer (select_blocks_mma.cu):
//      it walks the K_cmp tiles again (double-buffered), forms S on
//      mma.sync, p = exp2(s * scale * log2 e - lse2) in f32 (0 where the
//      row does not see the token) into an f32 tile [TQ * h][64 + 4],
//      then select_blocks.cuh::chunk_scores sums each token's heads (which
//      may sit in two warps' rows) and adds p . M over the band of M the
//      chunk's tokens overlap into the [TQ][S_sel] f32 group scores; then
//      select_blocks.cuh::top_n (one warp per token; up to 32 blocks, as at
//      the m7c shapes, each lane ranks one block with 32 shuffles: one
//      argmax pass per pick, with its chain of shuffles, took most of the
//      kernel's time there, PERF.md).
// Two passes replace the FMA kernel's rescaling of R x S_sel accumulators
// by every chunk's alpha; QK^T is formed twice over a row's prefix (127
// compressed tokens at the serve shape, at most 1023 at the route's limit
// of S_sel = 256), which is cheap next to Q and O's bytes. No float
// atomics: two launches give the same bits. Shared memory at D = 64, 128
// rows, h = 6: band_fwd's 55296 bytes, the p tile 34272 and the scores
// 21 * S_sel * 4 (2688 at the serve shape, 21504 at S_sel = 256), so two
// CTAs share an SM; the wrapper shrinks TQ where the scores would not
// let two fit (h = 1 at wide S_sel).
#include "banded_fwd_mma.cuh"
#include "select_blocks.cuh"

using namespace nsa;

namespace {

constexpr int KC = band::KC;   // tokens per K_cmp tile, and per chunk of the map
static_assert(band::KC == scorer::KC, "the walk's tiles are the map's chunks");
constexpr int PP = KC + 4;     // pitch (f32) of the probability tile

struct Params {
  band::Params band;   // pass 1: the compressed-prefix walk
  scorer::Params sc;   // pass 2: the map and the top-n
};

// Shared memory (bytes): band_fwd's K[2], V[2] and Q tiles (band::Layout,
// `rows` Q rows), then the probability tile [TQ * h][PP] and the group
// scores [TQ][S_sel] (f32).
template <int DT>
struct Layout {
  size_t pt, acc, total;
  __host__ __device__ Layout(int rows, int TQ, int h, int S_sel) {
    pt = band::Layout<DT>::Q + (size_t)rows * band::Layout<DT>::P * 2;
    acc = pt + (size_t)TQ * h * PP * 4;
    total = acc + (size_t)TQ * S_sel * 4;
  }
};

// As the banded forward: at D = 64 within 128 registers, two CTAs of 8
// warps an SM. DOCS: ds given (the dense instantiation reads none); its
// rows' document bounds take registers that spilled at 128 (8 bytes, also
// with each row's lo kept in shared memory), so it is compiled for one CTA
// an SM and ops/cuda/select_cmp.py::tile_plan plans its tiles with that
// budget. OFF: query row s sits at position pos_offset + s (sequence
// sharding; pass 1 and the top-n read the offset from Params in every
// instantiation, pass 2 only in the OFF ones, so the dense one compiles as
// it did before the offset existed). DOCS and OFF together: packed
// documents under sequence sharding. GATED (the gate-epilogue fold,
// scorer.py:399): pass 1 writes O * g, g the row's gate [B,S,G] f32
// (band_fwd); pass 2, lse and the selection are the ungated ones. The
// entries: select_cmp_mma_kernel (ungated, compiled as before) and
// gated_select_cmp_mma_kernel, over this one body.
template <int DT, bool DOCS, bool OFF, bool GATED>
__device__ __forceinline__ void select_cmp_body(const __nv_bfloat16* __restrict__ Q,
                                                const __nv_bfloat16* __restrict__ Kc,
                                                const __nv_bfloat16* __restrict__ Vc,
                                                const float* __restrict__ M,
                                                const int* __restrict__ ds,
                                                const float* __restrict__ gate,
                                                int* __restrict__ sel,
                                                __nv_bfloat16* __restrict__ O,
                                                float* __restrict__ lse, const Params& p) {
  constexpr int P = band::Layout<DT>::P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const band::Params& bp = p.band;
  const scorer::Params& sp = p.sc;
  const int nthr = blockDim.x;
  const Layout<DT> L(nthr / 2, sp.TQ, sp.h, sp.S_sel);
  const int qt = bp.nq - 1 - (int)(blockIdx.x / bp.BG);   // band_fwd's q tile and (b, g)
  const int bg = blockIdx.x % bp.BG, g = bg % bp.G, b = bg / bp.G;
  const int s0 = qt * sp.TQ;
  const int nt = min(sp.TQ, sp.S - s0);   // live tokens of the tile
  const int h = sp.h, Dk = sp.Dk;
  const int R = nt * h;                   // live rows
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, g8 = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * w;   // this warp's rows [r0, r0 + 16)
  const int t0 = OFF ? sp.pos_offset : 0;   // position of the tile's row 0 is t0 + s0

  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + band::Layout<DT>::K);
  const __nv_bfloat16* q_s =
      reinterpret_cast<const __nv_bfloat16*>(smem_raw + band::Layout<DT>::Q);   // [rows][P]
  float* p_s = reinterpret_cast<float*>(smem_raw + L.pt);                    // [R][PP]
  float* acc = reinterpret_cast<float*>(smem_raw + L.acc);                   // [TQ][S_sel]
  for (int idx = tid; idx < nt * sp.S_sel; idx += nthr) acc[idx] = 0.f;

  // pass 1: O (and lse); -lse2 of this thread's rows r0 + g8 and r0 + g8 + 8
  float nlse2[2];
  band::band_fwd<DT, band::CMP, DOCS, GATED>(Q, Kc, Vc, ds, O, lse, bp, nlse2, gate);

  // pass 2: the tile's band again, key tiles [j0, J) (j0 = 0 without ds)
  const int n_vis_tile = min(num_cmp(t0 + s0 + nt, sp.l, sp.d), sp.S_cmp);
  const int J = (n_vis_tile + KC - 1) / KC;
  const int j0 = DOCS ? min(scorer::first_visible(sp, ds, b, s0) / KC, J) : 0;
  const __nv_bfloat16* Kbg = Kc + (size_t)bg * sp.S_cmp * Dk;
  auto issue = [&](int j, int buf) {   // key tile j to buffer buf, then commit
    const int k0 = j * KC;
    const int nk = min(KC, sp.S_cmp - k0);
    __nv_bfloat16* kb = k_s + buf * KC * P;
    for (int idx = tid; idx < KC * (Dk / 8); idx += nthr) {
      const int r = idx / (Dk / 8), c = (idx % (Dk / 8)) * 8;
      tc::cp_async16(kb + r * P + c, r < nk ? Kbg + (size_t)(k0 + r) * Dk + c : Kc, r < nk);
    }
    tc::cp_async_commit();
  };
  // visible tokens [lo, nv) of this thread's rows (none for rows past R)
  int lo[2], nv[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r0 + g8 + 8 * hf;
    lo[hf] = DOCS && r < R ? scorer::first_visible(sp, ds, b, s0 + r / h) : 0;
    nv[hf] = r < R ? min(num_cmp(t0 + s0 + r / h + 1, sp.l, sp.d), sp.S_cmp) : 0;
  }
  const bool live = r0 < R;   // the warp has rows
  const float sl2 = bp.scale * band::LOG2E;
  __syncthreads();   // pass 1's buffers are free; the group scores are zeroed
  if (j0 < J) issue(j0, 0);
  for (int j = j0; j < J; ++j) {
    const int buf = (j - j0) & 1;
    if (j + 1 < J) {   // the next tile's copy overlaps this tile's math
      issue(j + 1, buf ^ 1);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = j * KC;
    if (live) {
      // C element e of n-tile i: row r0 + g8 + 8 (e >> 1), key k0 + 8i + 2 t4 + (e & 1);
      // S = Q K^T as pass 1 forms it (Q rows past R are zero)
      float s[KC / 8][4];
#pragma unroll
      for (int i = 0; i < KC / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
      tc::mma_tile<KC / 8, DT / 16, false>(
          s, [&](int ks, uint32_t (&f)[4]) { tc::ldsm_x4(f, tc::a_addr(q_s, P, r0, 16 * ks)); },
          k_s + buf * KC * P, P);
#pragma unroll
      for (int i = 0; i < KC / 8; ++i)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {   // p in f32 to the probability tile
          const int r = r0 + g8 + 8 * hf, col = 8 * i + 2 * t4;
          if (r >= R) continue;
          float2 pv;
          const int c = k0 + col;
          pv.x = (!DOCS || c >= lo[hf]) && c < nv[hf]
                     ? band::fast_exp2(fmaf(s[i][2 * hf], sl2, nlse2[hf]))
                     : 0.f;
          pv.y = (!DOCS || c + 1 >= lo[hf]) && c + 1 < nv[hf]
                     ? band::fast_exp2(fmaf(s[i][2 * hf + 1], sl2, nlse2[hf]))
                     : 0.f;
          *reinterpret_cast<float2*>(p_s + r * PP + col) = pv;
        }
    }
    __syncthreads();
    scorer::chunk_scores(p_s, PP, acc, sp, nt, k0, min(k0 + KC, n_vis_tile), M);
    __syncthreads();   // the K buffer and the probability tile are refilled next
  }
  scorer::top_n<DOCS>(acc, sel, sp, b, g, s0, nt, ds);
}

template <int DT, bool DOCS, bool OFF>
__global__ void __launch_bounds__(band::MAX_THREADS, DT == 64 && !DOCS ? 2 : 1)
select_cmp_mma_kernel(const __nv_bfloat16* __restrict__ Q, const __nv_bfloat16* __restrict__ Kc,
                      const __nv_bfloat16* __restrict__ Vc, const float* __restrict__ M,
                      const int* __restrict__ ds, int* __restrict__ sel,
                      __nv_bfloat16* __restrict__ O, float* __restrict__ lse, Params p) {
  select_cmp_body<DT, DOCS, OFF, false>(Q, Kc, Vc, M, ds, nullptr, sel, O, lse, p);
}

template <int DT, bool DOCS, bool OFF>
__global__ void __launch_bounds__(band::MAX_THREADS, DT == 64 && !DOCS ? 2 : 1)
gated_select_cmp_mma_kernel(const __nv_bfloat16* __restrict__ Q,
                            const __nv_bfloat16* __restrict__ Kc,
                            const __nv_bfloat16* __restrict__ Vc, const float* __restrict__ M,
                            const int* __restrict__ ds, const float* __restrict__ gate,
                            int* __restrict__ sel, __nv_bfloat16* __restrict__ O,
                            float* __restrict__ lse, Params p) {
  select_cmp_body<DT, DOCS, OFF, true>(Q, Kc, Vc, M, ds, gate, sel, O, lse, p);
}

template <int DT>
int launch(const void* Q, const void* Kc, const void* Vc, const float* M, const int* ds,
           const float* gate, int* sel, void* O, float* lse, int B, int rows, const Params& p,
           cudaStream_t stream) {
  const size_t smem = Layout<DT>(rows, p.sc.TQ, p.sc.h, p.sc.S_sel).total;
  const bool docs = ds != nullptr, off = p.sc.pos_offset != 0;
  const long long grid = (long long)B * p.band.G * p.band.nq;
  const auto* q = static_cast<const __nv_bfloat16*>(Q);
  const auto* k = static_cast<const __nv_bfloat16*>(Kc);
  const auto* v = static_cast<const __nv_bfloat16*>(Vc);
  auto* o = static_cast<__nv_bfloat16*>(O);
  if (gate != nullptr) {
    const auto kern = docs ? (off ? &gated_select_cmp_mma_kernel<DT, true, true>
                                  : &gated_select_cmp_mma_kernel<DT, true, false>)
                           : (off ? &gated_select_cmp_mma_kernel<DT, false, true>
                                  : &gated_select_cmp_mma_kernel<DT, false, false>);
    return launch_kernel(kern, grid, 2 * rows, smem, stream, q, k, v, M, ds, gate, sel, o, lse,
                         p);
  }
  const auto kern = docs ? (off ? &select_cmp_mma_kernel<DT, true, true>
                                : &select_cmp_mma_kernel<DT, true, false>)
                         : (off ? &select_cmp_mma_kernel<DT, false, true>
                                : &select_cmp_mma_kernel<DT, false, false>);
  return launch_kernel(kern, grid, 2 * rows, smem, stream, q, k, v, M, ds, sel, o, lse, p);
}

}  // namespace

extern "C" {

long long nsa_select_cmp_mma_smem_bytes(int rows, int TQ, int h, int Dk, int Dv, int S_sel) {
  return (long long)((Dk > 64 || Dv > 64) ? Layout<128>(rows, TQ, h, S_sel).total
                                          : Layout<64>(rows, TQ, h, S_sel).total);
}

// bf16 only. Q [B,S,G,h,Dk], K_cmp [B,G,S_cmp,Dk], V_cmp [B,G,S_cmp,Dv], M
// [S_cmp,S_sel] f32, ds [B,S] int32 document starts (or null), gate [B,S,G]
// f32 (or null: ungated) -> sel [B,S,G,n_out] int32, O [B,S,G,h,Dv] (times
// the row's gate), lse [B,S,G,h] f32 (or null):
// select_cmp.cu's contract, query row s at position pos_offset + s (with
// ds also). CTAs of `rows` = 64 or 128 rows, TQ tokens each (TQ * h <= rows);
// Dk, Dv <= 128, multiples of 8.
int nsa_select_cmp_mma(const void* Q, const void* Kc, const void* Vc, const float* M,
                       const int* ds, const float* gate, int* sel, void* O, float* lse, int B,
                       int S, int G, int h,
                       int Dk, int Dv,
                       int S_cmp, int S_sel, int l, int d, int l_sel, int n_top,
                       int force_init, int force_local, float scale, int pos_offset, int TQ,
                       int rows, void* stream) {
  if ((rows != 64 && rows != 128) || h <= 0 || TQ <= 0 || TQ * h > rows || S_cmp <= 0 ||
      S_sel <= 0 || Dk % 8 != 0 || Dv % 8 != 0 || Dk > 128 || Dv > 128 || l <= 0 || d <= 0 ||
      l_sel <= 0 || pos_offset < 0)
    return (int)cudaErrorInvalidValue;
  const int nq = (S + TQ - 1) / TQ;
  const Params p{{S, S_cmp, G, h, Dk, Dv, 0, l, d, pos_offset, TQ, nq, B * G, scale},
                 {B, S, G, h, Dk, S_cmp, S_sel, l, d, l_sel, n_top, force_init, force_local,
                  pos_offset, TQ, scale}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dk > 64 || Dv > 64) return launch<128>(Q, Kc, Vc, M, ds, gate, sel, O, lse, B, rows, p, s);
  return launch<64>(Q, Kc, Vc, M, ds, gate, sel, O, lse, B, rows, p, s);
}

}  // extern "C"
