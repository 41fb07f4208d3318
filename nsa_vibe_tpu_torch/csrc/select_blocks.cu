// select_blocks: NSA selection scorer (Eq. 8-12) without the compressed
// branch's output, for selection-block counts too wide for select_cmp, for
// f32 operands.
//
// Replaces, for f32 operands: nsa_vibe_tpu/ops/pallas/scorer.py::
// nsa_select_pallas (kernel _scorer_kernel, top-n epilogue _scorer_topn),
// which the JAX prefill runs when the fused scorer does not fit (long
// prompts) and which the 64k needle smoke runs on one query row. bf16
// operands (the serving dtype) take the tensor-core kernel of
// select_blocks_mma.cu; f32 keeps this FMA kernel.
//
// What it computes, per query row s at position t = pos_offset + s (token
// t, head j of group g):
//   p      = softmax(q · K_cmp^T * scale) over c < num_cmp(t+1)   (Eq. 8)
//   p_slc  = p · M_csl                                           (Eq. 9)
// then per token p_grp = sum over the group's h heads of p_slc (Eq. 10),
// the forced blocks {0, t//l_sel, t//l_sel - 1} (clamped at 0) and
// n_top - n_forced argmax passes over `p_grp - 1e-8 * index` among blocks
// with start <= t that are not forced (Eq. 11-12). Output contract of
// select_cmp and of the TPU kernel: forced slots first (may repeat), then
// picks in descending score order, -1 when no candidate is left. A row
// with no visible compressed token adds p_slc = 0. With ds [B,S] (packed
// documents) a row sees only c >= ceil(ds/d), and its forced and candidate
// blocks start at its document's first block ds // l_sel
// (select_blocks.cuh::top_n).
//
// M_csl is not read: M[c, j] = overlap([c*d, c*d+l), [j*l_sel, (j+1)*l_sel))
// / l, the row-normalised fractional overlap of ops/block_index.py, whose
// integer overlaps sum to l in every row, so the one IEEE division here
// gives the same f32 value. Each compressed token overlaps at most
// ceil(l / l_sel) + 1 selection blocks (2 at m7c), so the map costs a few
// FMAs per (token, block) instead of a dense [S_cmp, S_sel] product.
//
// What bounds it on the H100: at the m7c 64k prefill (B=1, S=65536, G=2,
// h=6, Dk=64, S_cmp=4095, S_sel=1024) one QK^T over the ~1.6 G visible
// (row, key) pairs is ~206 GFLOP against ~0.2 GB of Q, K_cmp and sel_idx:
// the tensor cores bound it (~0.21 ms) in bf16, the f32 FMA rate (67
// TFLOP/s) in f32. This FMA design is bound by FMA issue and shared-memory
// reads, and forms QK^T twice.
// Design: the TPU kernel keeps a [rows, S_sel] f32 p_slc accumulator per
// head in VMEM; at S_sel = 1024 that is 1.5 MB per 64-row tile against the
// 227 KB a block has. Heads cannot be summed before they are normalised
// (each has its own max and denominator), so one block per (b, g, tile of
// TQ tokens x h heads, at most 64 rows) makes two passes over the tile's
// visible prefix of K_cmp (16-byte loads, 64 tokens per chunk, logits in
// 4x4 register tiles as banded_attn.cu):
//   1. statistics: online max and sum per row, giving lse = m + log(l);
//   2. probabilities exp(s - lse) per (row, token), then per (token of the
//      tile, token of the chunk) one thread sums the group's heads, and per
//      (token of the tile, selection block touched by the chunk) one thread
//      adds the chunk's overlapping tokens times M into a [TQ, S_sel] f32
//      accumulator in shared memory (40 KB at TQ=10, S_sel=1024), so no two
//      threads write the same element (select_blocks.cuh::chunk_scores);
// then the top-n, one warp per token with shuffles (a rank per block up to
// 32 blocks, argmax passes past that; select_blocks.cuh::top_n). The
// wrapper shrinks TQ until the accumulator fits and raises when even TQ =
// 1 does not (S_sel above ~53k at h = 6, Dk = 64, i.e. prompts of ~3.4 M
// tokens at l_sel = 64).
#include "select_blocks.cuh"

using namespace nsa;
using namespace nsa::scorer;

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int MAX_ROWS = 64;    // query rows (tokens x heads) per block

// shared-memory carve-up (floats): Q rows, one chunk of K_cmp (pitch
// Dk+4), the [rows, KC] logits/probabilities, row max/sum/lse, and the
// [TQ, S_sel] group-score accumulator
struct Smem {
  size_t q, k, s, m, l, acc, total;
  __host__ __device__ Smem(int TQ, int h, int Dk, int S_sel) {
    const size_t R = (size_t)TQ * h;
    q = 0;
    k = q + round4(R * Dk);
    s = k + round4((size_t)KC * (Dk + 4));
    m = s + round4(R * KC);
    l = m + round4(R);
    acc = l + round4(R);
    total = acc + round4((size_t)TQ * S_sel);
  }
};

// Phase A of a chunk: logits of the staged rows against the KC staged
// tokens, each thread a 4x4 tile (rows ri+16m, tokens ki+16n).
__device__ __forceinline__ void chunk_logits(const float* q_s, const float* k_s, int rows, int Dk,
                                             float (&sc)[4][4]) {
  const int ri = threadIdx.x / 16, ki = threadIdx.x % 16;
  const int kp = Dk + 4;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) sc[m][n] = 0.f;
  for (int c = 0; c < Dk; c += 4) {
    float4 qv[4], kv[4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
      qv[m] = *reinterpret_cast<const float4*>(q_s + min(ri + 16 * m, rows - 1) * Dk + c);
#pragma unroll
    for (int n = 0; n < 4; ++n)
      kv[n] = *reinterpret_cast<const float4*>(k_s + (ki + 16 * n) * kp + c);
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        sc[m][n] = fmaf(qv[m].x, kv[n].x, sc[m][n]);
        sc[m][n] = fmaf(qv[m].y, kv[n].y, sc[m][n]);
        sc[m][n] = fmaf(qv[m].z, kv[n].z, sc[m][n]);
        sc[m][n] = fmaf(qv[m].w, kv[n].w, sc[m][n]);
      }
  }
}

__global__ void __launch_bounds__(THREADS)
select_blocks_kernel(const float* __restrict__ Q, const float* __restrict__ Kc,
                     const int* __restrict__ ds, int* __restrict__ sel, Params p) {
  extern __shared__ __align__(16) float smem[];
  const int nq = (p.S + p.TQ - 1) / p.TQ;
  int bid = blockIdx.x;
  const int qt = bid % nq;
  bid /= nq;
  const int g = bid % p.G;
  const int b = bid / p.G;
  const int s0 = qt * p.TQ;
  const int nt = min(p.TQ, p.S - s0);
  const int h = p.h, Dk = p.Dk, S_sel = p.S_sel;
  const int rows = nt * h;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ri = tid / 16, ki = tid % 16;

  const Smem L(p.TQ, h, Dk, S_sel);
  float* q_s = smem + L.q;       // [R][Dk]
  float* k_s = smem + L.k;       // [KC][Dk+4]
  float* s_s = smem + L.s;       // [R][KC]
  float* m_s = smem + L.m;       // [R] running max, then lse
  float* l_s = smem + L.l;       // [R]
  float* acc = smem + L.acc;     // [TQ][S_sel]
  const int kp = Dk + 4;
  const int t_first = p.pos_offset + s0;

  auto q_row = [&](int r) -> size_t {
    const int i = r / h, j = r - i * h;
    return (((size_t)b * p.S + s0 + i) * p.G + g) * h + j;
  };
  load_rows_vec<float>(q_s, Dk, [&](int r) -> const float* { return Q + q_row(r) * Dk; }, Dk,
                       rows);
  for (int idx = tid; idx < rows; idx += THREADS) {
    m_s[idx] = NEG;
    l_s[idx] = 0.f;
  }
  for (int idx = tid; idx < nt * S_sel; idx += THREADS) acc[idx] = 0.f;

  const float* Kbg = Kc + ((size_t)b * p.G + g) * p.S_cmp * Dk;
  // prefix bound of the tile's last token: no row of the tile sees past it
  const int n_vis_tile = min(num_cmp(t_first + nt, p.l, p.d), p.S_cmp);
  // visible tokens [lo, nvis) of each row of this thread's phase-A tile
  int lo[4], nvis[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int i = min(ri + 16 * m, rows - 1) / h;
    lo[m] = ds != nullptr ? first_visible(p, ds, b, s0 + i) : 0;
    nvis[m] = min(num_cmp(t_first + i + 1, p.l, p.d), p.S_cmp);
  }

  // pass 1: row statistics (online max and sum)
  for (int c0 = 0; c0 < n_vis_tile; c0 += KC) {
    __syncthreads();   // previous chunk consumed (and Q staged)
    load_rows_vec<float>(k_s, kp, Kbg, Dk, c0, KC, n_vis_tile);
    __syncthreads();
    float sc[4][4];
    chunk_logits(q_s, k_s, rows, Dk, sc);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int r = ri + 16 * m;
      if (r < rows) {
#pragma unroll
        for (int n = 0; n < 4; ++n)
          s_s[r * KC + ki + 16 * n] =
              c0 + ki + 16 * n < nvis[m] && c0 + ki + 16 * n >= lo[m] ? sc[m][n] * p.scale : NEG;
      }
    }
    __syncthreads();
    for (int r = warp; r < rows; r += NWARPS) {
      const float* sr = s_s + r * KC;
      const float x0 = sr[lane], x1 = sr[lane + 32];
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
      const float p0 = x0 > NEG ? expf(x0 - m_new) : 0.f;
      const float p1 = x1 > NEG ? expf(x1 - m_new) : 0.f;
      const float psum = warp_sum(p0 + p1);
      if (lane == 0) {
        l_s[r] = l_s[r] * expf(m_old - m_new) + psum;
        m_s[r] = m_new;
      }
    }
  }
  __syncthreads();
  for (int r = tid; r < rows; r += THREADS) m_s[r] = row_lse(m_s[r], l_s[r]);   // lse

  // pass 2: probabilities, heads and overlapping tokens into the group scores
  for (int c0 = 0; c0 < n_vis_tile; c0 += KC) {
    __syncthreads();   // previous chunk consumed (and lse written)
    load_rows_vec<float>(k_s, kp, Kbg, Dk, c0, KC, n_vis_tile);
    __syncthreads();
    float sc[4][4];
    chunk_logits(q_s, k_s, rows, Dk, sc);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int r = ri + 16 * m;
      if (r < rows) {
        const float lse_r = m_s[r];
#pragma unroll
        for (int n = 0; n < 4; ++n)
          s_s[r * KC + ki + 16 * n] = c0 + ki + 16 * n < nvis[m] && c0 + ki + 16 * n >= lo[m]
                                          ? expf(sc[m][n] * p.scale - lse_r)
                                          : 0.f;
      }
    }
    __syncthreads();
    chunk_scores(s_s, KC, acc, p, nt, c0, min(c0 + KC, n_vis_tile));
  }
  __syncthreads();
  top_n<true>(acc, sel, p, b, g, s0, nt, ds);
}

int launch(const float* Q, const float* Kc, const int* ds, int* sel, const Params& p,
           cudaStream_t stream) {
  const size_t smem = Smem(p.TQ, p.h, p.Dk, p.S_sel).total * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(select_blocks_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long grid = (long long)p.B * p.G * ((p.S + p.TQ - 1) / p.TQ);
  if (grid > 0)
    select_blocks_kernel<<<(unsigned)grid, THREADS, smem, stream>>>(Q, Kc, ds, sel, p);
  NSA_LAUNCH_CHECK();
}

}  // namespace

extern "C" {

long long nsa_select_blocks_smem_bytes(int TQ, int h, int Dk, int S_sel) {
  return (long long)(Smem(TQ, h, Dk, S_sel).total * sizeof(float));
}

// f32 only. Q [B,S,G,h,Dk], K_cmp [B,G,S_cmp,Dk], ds [B,S] int32 document
// starts (or null) -> sel [B,S,G,n_out]; TQ tokens
// per block, TQ * h <= 64.
int nsa_select_blocks(const float* Q, const float* Kc, const int* ds, int* sel, int B, int S,
                      int G, int h, int Dk, int S_cmp, int S_sel, int l, int d, int l_sel,
                      int n_top, int force_init, int force_local, int pos_offset, float scale,
                      int TQ, void* stream) {
  if (TQ <= 0 || TQ * h > MAX_ROWS || S_cmp <= 0 || S_sel <= 0 || Dk % 8 != 0 ||
      pos_offset < 0 || l <= 0 || d <= 0 || l_sel <= 0)
    return (int)cudaErrorInvalidValue;
  const Params p{B, S, G, h, Dk, S_cmp, S_sel, l, d, l_sel, n_top, force_init, force_local,
                 pos_offset, TQ, scale};
  return launch(Q, Kc, ds, sel, p, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
