// select_blocks_mma: NSA selection scorer (Eq. 8-12) without the compressed
// branch's output, for bf16 operands, on tensor cores.
//
// Replaces, for bf16 operands (the serving dtype):
// nsa_vibe_tpu/ops/pallas/scorer.py::nsa_select_pallas (kernel
// _scorer_kernel, top-n epilogue _scorer_topn), which the JAX prefill runs
// when the fused scorer does not fit (long prompts) and which the 64k
// needle smoke runs on one query row. f32 keeps the FMA kernel of
// select_blocks.cu.
//
// What it computes: as select_blocks.cu (the notation there). Per query row
// (token t = pos_offset + s, head) p = softmax(scale q . K_cmp^T) over the
// row's visible prefix c < num_cmp(t+1) (Eq. 8), then per token the
// group's heads mapped onto the selection blocks (Eq. 9-10) and the forced
// blocks plus top-n (Eq. 11-12). p stays f32 for the map, as the TPU kernel
// keeps p and M f32 for p . M (scorer.py:113-115); the logits come from
// bf16 Q and K_cmp with f32 accumulation. With ds [B,S] (packed documents)
// a row sees only c >= ceil(ds/d) and picks from its document's blocks;
// both passes start at the key tile of the tile's first token's first
// visible token, since no row of the tile sees an earlier one.
//
// What bounds it on the H100: at the m7c 64k prefill (B=1, S=65536, G=2,
// h=6, Dk=64, S_cmp=4095, S_sel=1024) one QK^T over the ~1.6 G visible
// (row, key) pairs is ~206 GFLOP on the bf16 tensor cores (~0.21 ms)
// against ~0.2 GB of Q, K_cmp and sel_idx. This design forms QK^T twice (a
// pass for the row statistics, one for the probabilities), takes an exp2 of
// every visible pair in each pass, and writes every probability to shared
// memory once for the map.
//
// Design: one CTA of ROWS / 16 warps (ROWS = 64 or 128) per (b, g, q tile
// of TQ <= ROWS / h tokens; row = token * h + head); warp w owns rows [16w,
// 16w+16) and skips the math when it has none. In CMP order later q tiles
// see longer prefixes, so the CTAs take the q tiles from the last one down,
// the heaviest first. Each pass streams the tile's prefix of K_cmp in
// 64-token tiles at absolute multiples of 64 (by cp.async, zero-filled past
// S_cmp) through one buffer, forming S = Q K^T on mma.sync m16n8k16 (bf16
// -> f32) with Q's fragments read by ldmatrix at each tile (rows past the
// tile's live rows read its last live row and are dropped), so a row's
// logits do not depend on the tile that holds it:
//   1. statistics: the online max (floored at -1e20) and sum per row in
//      f32, base 2, across the four lanes that share a row; lse2 = m +
//      log2(l);
//   2. p = exp2(s * scale * log2 e - lse2) in f32 (0 where not visible),
//      written to a [rows, 64] f32 tile in shared memory; after a barrier,
//      one thread per (token of the tile, compressed token) sums the
//      token's h heads (which may lie in two warps' rows), then one thread
//      per (token, selection block the chunk touches) adds those sums times
//      the closed-form overlap into the [TQ, S_sel] f32 group scores in
//      shared memory (select_blocks.cuh::chunk_scores, as the FMA kernel),
//      so the map stays exact in f32 and no two threads write the same
//      element;
// then the top-n, one warp per token with shuffles (a rank per block up to
// 32 blocks, argmax passes past that; select_blocks.cuh::top_n). No float
// atomics: two launches give the same bits, and a row gives the same bits
// under any q tile or pos_offset.
// Occupancy, not the tensor cores, sets the time (PERF.md): the group
// scores take 40 KB of a 64-row CTA (S_sel = 1024, h = 6), so one K_cmp
// buffer instead of two lets three CTAs of 64 rows share an SM (12 warps;
// 75 KB each), whose loads and math overlap one another's; double-buffered,
// two fit. The wrapper takes TQ = ROWS / h and shrinks it until the group
// scores fit, so S_sel reaches ~55k blocks at h = 6, Dk = 64.
#include "select_blocks.cuh"
#include "tc.cuh"

using namespace nsa;
using namespace nsa::scorer;

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float M_FLOOR = -1e20f;   // floor of the running max: exp2 of a floored gap is finite
constexpr int PP = KC + 4;          // pitch (f32) of the probability tile

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Shared memory (bytes): a K_cmp tile of KC tokens and the TQ * h Q rows
// (bf16, row pitch DT + 8), the probability tile [TQ * h][PP] and the group
// scores [TQ][S_sel] (f32).
struct Layout {
  size_t k, q, pt, acc, total;
  __host__ __device__ Layout(int DT, int TQ, int h, int S_sel) {
    const size_t R = (size_t)TQ * h, pitch = (size_t)(DT + 8) * 2;
    k = 0;
    q = k + (size_t)KC * pitch;
    pt = q + R * pitch;
    acc = pt + R * PP * 4;
    total = acc + (size_t)TQ * S_sel * 4;
  }
};

// at most 128 registers a thread: two CTAs of 8 warps, or three of 4, fit an
// SM; DOCS: ds given (the dense instantiation reads none)
template <int DT, bool DOCS>
__global__ void __launch_bounds__(256, 2)
select_blocks_mma_kernel(const __nv_bfloat16* __restrict__ Q,
                         const __nv_bfloat16* __restrict__ Kc, const int* __restrict__ ds,
                         int* __restrict__ sel, Params p) {
  constexpr int P = DT + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Layout L(DT, p.TQ, p.h, p.S_sel);
  const int nthr = blockDim.x;
  const int nq = (p.S + p.TQ - 1) / p.TQ, BG = p.B * p.G;
  const int qt = nq - 1 - (int)(blockIdx.x / BG);   // the last (heaviest) q tile first
  const int bg = blockIdx.x % BG, g = bg % p.G, b = bg / p.G;
  const int s0 = qt * p.TQ;
  const int nt = min(p.TQ, p.S - s0);   // live tokens of the tile
  const int h = p.h, Dk = p.Dk;
  const int R = nt * h;                 // live rows
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, g8 = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * w;   // this warp's rows [r0, r0 + 16)
  const int t_first = p.pos_offset + s0;
  const float sl2 = p.scale * LOG2E;

  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.k);   // [KC][P]
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.q);   // [R][P]
  float* p_s = reinterpret_cast<float*>(smem_raw + L.pt);                  // [R][PP]
  float* acc = reinterpret_cast<float*>(smem_raw + L.acc);                 // [TQ][S_sel]

  // head-width padding: columns [Dk, DT) of Q and of the K tile stay zero
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  for (int idx = tid; Dk < DT && idx < R * (DT / 8); idx += nthr) {
    const int r = idx / (DT / 8), c = (idx % (DT / 8)) * 8;
    if (c >= Dk) *reinterpret_cast<uint4*>(q_s + r * P + c) = z;
  }
  for (int idx = tid; Dk < DT && idx < KC * (DT / 8); idx += nthr) {
    const int r = idx / (DT / 8), c = (idx % (DT / 8)) * 8;
    if (c >= Dk) *reinterpret_cast<uint4*>(k_s + r * P + c) = z;
  }
  // Q rows of the tile (row r: token s0 + r / h, head r % h)
  for (int idx = tid; idx < R * (Dk / 8); idx += nthr) {
    const int r = idx / (Dk / 8), c = (idx % (Dk / 8)) * 8;
    const size_t row = (((size_t)b * p.S + s0 + r / h) * p.G + g) * h + r % h;
    tc::cp_async16(q_s + r * P + c, Q + row * Dk + c, true);
  }
  tc::cp_async_commit();
  for (int idx = tid; idx < nt * p.S_sel; idx += nthr) acc[idx] = 0.f;

  // the tile's band: key tiles [j0, J), from the first token's first
  // visible token (0 without ds) to the last token's bound
  const int n_vis_tile = min(num_cmp(t_first + nt, p.l, p.d), p.S_cmp);
  const int J = (n_vis_tile + KC - 1) / KC;
  const int j0 = DOCS ? min(first_visible(p, ds, b, s0) / KC, J) : 0;
  const __nv_bfloat16* Kbg = Kc + (size_t)bg * p.S_cmp * Dk;
  auto issue = [&](int j) {   // key tile j to the buffer, then commit
    const int k0 = j * KC;
    const int nk = min(KC, p.S_cmp - k0);
    for (int idx = tid; idx < KC * (Dk / 8); idx += nthr) {
      const int r = idx / (Dk / 8), c = (idx % (Dk / 8)) * 8;
      tc::cp_async16(k_s + r * P + c, r < nk ? Kbg + (size_t)(k0 + r) * Dk + c : Kc, r < nk);
    }
    tc::cp_async_commit();
  };

  // this thread's rows r0 + g8 (hf 0) and r0 + g8 + 8 (hf 1): visible
  // tokens [lo, nv) (none for rows past R)
  int lo[2], nv[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r0 + g8 + 8 * hf;
    lo[hf] = DOCS && r < R ? first_visible(p, ds, b, s0 + r / h) : 0;
    nv[hf] = r < R ? min(num_cmp(t_first + r / h + 1, p.l, p.d), p.S_cmp) : 0;
  }
  const bool live = r0 < R;   // the warp has rows
  // running max (base 2) and this lane's partial sum of each row, then -lse2
  float m2[2] = {M_FLOOR, M_FLOOR}, l2[2] = {0.f, 0.f}, nlse2[2] = {0.f, 0.f};

  // pass 0: row statistics; pass 1: probabilities and the map
  for (int pass = 0; pass < 2; ++pass) {
    if (j0 < J) issue(j0);
    for (int j = j0; j < J; ++j) {
      tc::cp_async_wait<0>();
      __syncthreads();
      const int k0 = j * KC;
      // C element e of n-tile i: row r0 + g8 + 8 (e >> 1), key k0 + 8i + 2 t4 + (e & 1)
      float s[8][4];
      if (live) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
        // S = Q K^T; rows past R read row R - 1 (their results are dropped)
        tc::mma_tile<8, DT / 16, false>(
            s,
            [&](int ks, uint32_t (&f)[4]) {
              tc::ldsm_x4(f, q_s + min(r0 + (lane & 15), R - 1) * P + 16 * ks + (lane >> 4) * 8);
            },
            k_s, P);
      }
      if (pass == 0 && live) {
        // the quad's common running max, this lane's columns' sum under it
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float mx = M_FLOOR;
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int e = 2 * hf; e < 2 * hf + 2; ++e) {
              const int key = k0 + 8 * i + 2 * t4 + (e & 1);
              // exp2(NEG - m) = 0
              s[i][e] = (!DOCS || key >= lo[hf]) && key < nv[hf] ? s[i][e] * sl2 : NEG;
              mx = fmaxf(mx, s[i][e]);
            }
          mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
          const float m_new = fmaxf(m2[hf], mx);
          float sum = 0.f;
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int e = 2 * hf; e < 2 * hf + 2; ++e) sum += fast_exp2(s[i][e] - m_new);
          // exactly 1 where the max holds, so a tile past the row's prefix
          // leaves its sum's bits as they are
          l2[hf] = l2[hf] * (m_new == m2[hf] ? 1.f : fast_exp2(m2[hf] - m_new)) + sum;
          m2[hf] = m_new;
        }
      }
      if (pass == 1) {
        if (live) {   // p in f32 to the probability tile
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int r = r0 + g8 + 8 * hf, col = 8 * i + 2 * t4;
              if (r >= R) continue;
              float2 pv;
              const int c = k0 + col;
              pv.x = (!DOCS || c >= lo[hf]) && c < nv[hf]
                         ? fast_exp2(fmaf(s[i][2 * hf], sl2, nlse2[hf]))
                         : 0.f;
              pv.y = (!DOCS || c + 1 >= lo[hf]) && c + 1 < nv[hf]
                         ? fast_exp2(fmaf(s[i][2 * hf + 1], sl2, nlse2[hf]))
                         : 0.f;
              *reinterpret_cast<float2*>(p_s + r * PP + col) = pv;
            }
        }
        __syncthreads();
        chunk_scores(p_s, PP, acc, p, nt, k0, min(k0 + KC, n_vis_tile));
      }
      __syncthreads();   // the K tile (and the probability tile) is refilled next
      if (j + 1 < J) issue(j + 1);
    }
    if (pass == 0) {   // lse2 = m + log2(l) over the quad's partial sums
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float l = l2[hf];
        l += __shfl_xor_sync(FULL, l, 1);
        l += __shfl_xor_sync(FULL, l, 2);
        nlse2[hf] = l > 0.f ? -(m2[hf] + log2f(l)) : 0.f;
      }
    }
  }
  tc::cp_async_wait<0>();   // a tile with no key tile still staged Q
  __syncthreads();          // the group scores are complete (J = 0: zeroed)
  top_n<DOCS>(acc, sel, p, b, g, s0, nt, ds);
}

template <int DT>
int launch(const void* Q, const void* Kc, const int* ds, int* sel, const Params& p, int rows,
           cudaStream_t stream) {
  const size_t smem = Layout(DT, p.TQ, p.h, p.S_sel).total;
  const auto kern = ds != nullptr ? &select_blocks_mma_kernel<DT, true>
                                  : &select_blocks_mma_kernel<DT, false>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long grid = (long long)p.B * p.G * ((p.S + p.TQ - 1) / p.TQ);
  if (grid > 0)
    kern<<<(unsigned)grid, 2 * rows, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(Q), static_cast<const __nv_bfloat16*>(Kc), ds, sel, p);
  NSA_LAUNCH_CHECK();
}

}  // namespace

extern "C" {

long long nsa_select_blocks_mma_smem_bytes(int TQ, int h, int Dk, int S_sel) {
  return (long long)Layout(Dk > 64 ? 128 : 64, TQ, h, S_sel).total;
}

// bf16 only. Q [B,S,G,h,Dk], K_cmp [B,G,S_cmp,Dk], ds [B,S] int32 document
// starts (or null) -> sel [B,S,G,n_out] int32
// (select_blocks.cu's contract). Dk <= 128, a multiple of 8; CTAs of `rows`
// = 64 or 128 rows, TQ tokens each (TQ * h <= rows).
int nsa_select_blocks_mma(const void* Q, const void* Kc, const int* ds, int* sel, int B, int S,
                          int G, int h, int Dk, int S_cmp, int S_sel, int l, int d, int l_sel,
                          int n_top, int force_init, int force_local, int pos_offset,
                          float scale, int TQ, int rows, void* stream) {
  if ((rows != 64 && rows != 128) || TQ <= 0 || TQ * h > rows || S_cmp <= 0 || S_sel <= 0 ||
      Dk % 8 != 0 || Dk > 128 || pos_offset < 0 ||
      l <= 0 || d <= 0 || l_sel <= 0)
    return (int)cudaErrorInvalidValue;
  const Params p{B, S, G, h, Dk, S_cmp, S_sel, l, d, l_sel, n_top, force_init, force_local,
                 pos_offset, TQ, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dk > 64) return launch<128>(Q, Kc, ds, sel, p, rows, s);
  return launch<64>(Q, Kc, ds, sel, p, rows, s);
}

}  // extern "C"
