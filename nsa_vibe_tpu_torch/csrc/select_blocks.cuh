// Pieces of the selection scorers' kernels (select_blocks.cu, f32 on FMA;
// select_blocks_mma.cu and the fused select_cmp_mma.cu, bf16 on tensor
// cores): their parameters, the Eq. 9-10 map of one chunk of probabilities
// into a q tile's group scores, and the Eq. 11-12 top-n epilogue.
// Notation: select_blocks.cu.
#pragma once

#include "common.cuh"

namespace nsa {
namespace scorer {

constexpr int KC = 64;   // compressed tokens per chunk

struct Params {
  int B, S, G, h, Dk, S_cmp, S_sel, l, d, l_sel, n_top, force_init, force_local, pos_offset,
      TQ;
  float scale;
};

// Packed documents (ds [B,S] int32; row s reads ds[b, s] at
// any pos_offset): the first compressed
// token that query token s of batch row b sees (common.cuh::doc_lo). The
// tensor-core kernels read ds only in their DOCS instantiation, so the
// dense one compiles as it did before documents existed.
__device__ __forceinline__ int first_visible(const Params& p, const int* __restrict__ ds, int b,
                                             int s) {
  return doc_lo(doc_start(ds, p.S, b, s), true, p.d);
}

// Eq. 9-10 of one chunk of compressed tokens [c0, c1): for each token i <
// nt of the q tile and each selection block j the chunk overlaps,
//   acc[i][j] += sum over tokens c of the chunk within block j of
//                (sum over heads hh of p[(i*h + hh) * pitch + c - c0]) * M[c, j]
// with M[c, j] read from the map M [S_cmp, S_sel] f32 where one is given
// (the fused scorer's operand: only the entries of the tokens c that
// overlap block j are read, the band this loop bounds), else in closed form,
// overlap([c*d, c*d+l), [j*l_sel, (j+1)*l_sel)) / l (the select-only
// scorer). First one thread per (token, c) sums the heads (a token's heads may
// sit in two warps' rows) into the row of head 0, in place; after a barrier
// one thread per (token, block) adds its tokens, so no two threads write
// the same element and the sums run in a fixed order. Every thread of the
// block calls it; p_s holds the head sums afterwards.
__device__ __forceinline__ void chunk_scores(float* p_s, int pitch, float* acc, const Params& p,
                                             int nt, int c0, int c1,
                                             const float* __restrict__ M = nullptr) {
  const int nc = c1 - c0;
  for (int e = threadIdx.x; e < nt * KC; e += blockDim.x) {
    const int i = e / KC, c = e - i * KC;
    if (c >= nc) continue;
    float* col = p_s + (size_t)i * p.h * pitch + c;
    float pc = 0.f;
#pragma unroll 4
    for (int hh = 0; hh < p.h; ++hh) pc += col[hh * pitch];
    col[0] = pc;
  }
  __syncthreads();
  const int j_lo = c0 * p.d / p.l_sel;
  const int j_hi = min(((c1 - 1) * p.d + p.l - 1) / p.l_sel, p.S_sel - 1);
  const int nj = j_hi - j_lo + 1;
  for (int e = threadIdx.x; e < nt * nj; e += blockDim.x) {
    const int i = e / nj, j = j_lo + (e - i * nj);
    const int b0 = j * p.l_sel, b1 = b0 + p.l_sel;
    // tokens c with c*d < b1 and c*d + l > b0, within the chunk
    const int first = b0 - p.l + 1;
    const int lo_c = max(c0, first <= 0 ? 0 : (first + p.d - 1) / p.d);
    const int hi_c = min(c1 - 1, (b1 - 1) / p.d);
    const float* ph = p_s + (size_t)i * p.h * pitch - c0;
    float a = 0.f;
    for (int c = lo_c; c <= hi_c; ++c) {
      if (M != nullptr) {
        a = fmaf(ph[c], __ldg(M + (size_t)c * p.S_sel + j), a);
      } else {
        const int a0 = c * p.d;
        const int ov = min(a0 + p.l, b1) - max(a0, b0);   // a token inside the block: M = 1
        a = fmaf(ph[c], ov == p.l ? 1.f : __fdiv_rn((float)ov, (float)p.l), a);
      }
    }
    acc[i * p.S_sel + j] += a;
  }
}

// Eq. 11-12 per token of the q tile (tokens s0 .. s0+nt-1 of (b, g), at
// positions t_first + i): the forced slots {f, t//l_sel, t//l_sel - 1}
// (clamped at f), then the n_top - n_forced blocks of largest `score - 1e-8
// * index` among blocks in [f, t//l_sel] that are not forced, in descending
// order (ties to the lowest index), -1 for the slots past the last such
// block; one warp per token. f = ds // l_sel, the token's document's first
// block, where DOCS and ds are given (the FMA kernels pass DOCS with ds
// null for the dense bound), else 0. Up to 32 blocks a lane holds one and counts
// the blocks ahead of it with 32 shuffles: a block of rank k fills slot k;
// past 32, n_top - n_forced argmax passes with shuffle reductions. Either
// way a slot's block is the same. acc [nt][S_sel] is overwritten.
template <bool DOCS>
__device__ __forceinline__ void top_n(float* acc, int* __restrict__ sel, const Params& p, int b,
                                      int g, int s0, int nt, const int* __restrict__ ds) {
  const int lane = threadIdx.x & 31, nwarps = blockDim.x >> 5, S_sel = p.S_sel;
  const int n_forced = (p.force_init ? 1 : 0) + p.force_local;
  const int n_out = max(p.n_top, n_forced);
  const int k_rest = p.n_top - n_forced;
  if (S_sel <= 32) {
    for (int i = threadIdx.x >> 5; i < nt; i += nwarps) {
      const int t = p.pos_offset + s0 + i;
      const int last = t / p.l_sel;
      const int fb = DOCS && ds != nullptr ? doc_start(ds, p.S, b, s0 + i) / p.l_sel : 0;
      int* out = sel + (((size_t)b * p.S + s0 + i) * p.G + g) * n_out;
      const int c = lane;
      bool forced = p.force_init && c == fb;
      for (int f = 0; f < p.force_local; ++f) forced = forced || c == max(last - f, fb);
      const bool cand =
          c < S_sel && (long long)c * p.l_sel <= t && (!DOCS || c >= fb) && !forced;
      const float v = cand ? __fsub_rn(acc[(size_t)i * S_sel + c], __fmul_rn((float)c, 1e-8f))
                           : NEG;
      int rank = 0;   // candidates ahead of this one
#pragma unroll
      for (int o = 0; o < 32; ++o) {
        const float ov = __shfl_sync(FULL, v, o);
        rank += (ov > v || (ov == v && o < c)) ? 1 : 0;
      }
      const int n_cand = __popc(__ballot_sync(FULL, cand));
      if (lane == 0) {
        int f = 0;
        if (p.force_init) out[f++] = fb;
        for (int k = 0; k < p.force_local; ++k) out[f++] = max(last - k, fb);
      }
      if (cand && rank < k_rest) out[n_forced + rank] = c;
      for (int k = n_cand + lane; k < k_rest; k += 32) out[n_forced + k] = -1;
    }
    return;
  }
  for (int i = threadIdx.x >> 5; i < nt; i += nwarps) {
    const int t = p.pos_offset + s0 + i;
    const int last = t / p.l_sel;
    const int fb = DOCS && ds != nullptr ? doc_start(ds, p.S, b, s0 + i) / p.l_sel : 0;
    float* comp = acc + (size_t)i * S_sel;
    int* out = sel + (((size_t)b * p.S + s0 + i) * p.G + g) * n_out;
    for (int c = lane; c < S_sel; c += 32) {
      bool forced = p.force_init && c == fb;
      for (int f = 0; f < p.force_local; ++f) forced = forced || c == max(last - f, fb);
      const bool valid = (long long)c * p.l_sel <= t && (!DOCS || c >= fb);
      const float score = (valid && !forced) ? comp[c] : NEG;
      comp[c] = __fsub_rn(score, __fmul_rn((float)c, 1e-8f));
    }
    if (lane == 0) {
      int f = 0;
      if (p.force_init) out[f++] = fb;
      for (int k = 0; k < p.force_local; ++k) out[f++] = max(last - k, fb);
    }
    __syncwarp();
    for (int k = 0; k < k_rest; ++k) {
      float bv = NEG;
      int bi = INT_MAX;
      for (int c = lane; c < S_sel; c += 32) {
        const float v = comp[c];
        if (v > bv || (v == bv && c < bi)) {   // ties: the lowest index wins
          bv = v;
          bi = c;
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(FULL, bv, o);
        const int oi = __shfl_xor_sync(FULL, bi, o);
        if (ov > bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (lane == 0) out[n_forced + k] = bv > NEG / 2 ? bi : -1;
      if (bi < S_sel && (bi & 31) == lane) comp[bi] = NEG;   // the owning lane retires it
      __syncwarp();
    }
  }
}

}  // namespace scorer
}  // namespace nsa
