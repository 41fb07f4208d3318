// Pieces of the banded (window / compressed-prefix) backward kernels of the
// one-pass and diagonal designs (banded_bwd_1p.cu, win_bwd_diag.cu): the
// visibility rule, the staging of query rows, and the shared-memory
// carve-up. The rules are those of banded_bwd.cu (the two-pass design),
// which keeps its own copy.
#pragma once

#include "bwd_common.cuh"

namespace nsa {
namespace band {

using namespace nsa::bwd;

enum Mode : int { WIN = 0, CMP = 1 };

struct Params {
  int B, S, S_kv, G, h, Dk, Dv, mode, w, l, d, TQ, nsplit;
  float scale;
};

// keys [lo, hi) that query token t sees
__host__ __device__ __forceinline__ void key_range(const Params& p, int t, int& lo, int& hi) {
  if (p.mode == WIN) {
    lo = t - p.w + 1 > 0 ? t - p.w + 1 : 0;
    hi = t + 1 < p.S_kv ? t + 1 : p.S_kv;
  } else {
    const int n = t + 1 >= p.l ? (t + 1 - p.l) / p.d + 1 : 0;   // num_cmp(t+1)
    lo = 0;
    hi = n < p.S_kv ? n : p.S_kv;
  }
}

// query tokens [t_lo, t_hi] that see at least one key of [k0, k1), k1 > k0
__device__ __forceinline__ void token_range(const Params& p, int k0, int k1, int& t_lo,
                                            int& t_hi) {
  if (p.mode == WIN) {
    t_lo = k0;
    t_hi = min(k1 - 1 + p.w - 1, p.S - 1);
  } else {
    t_lo = k0 * p.d + p.l - 1;
    t_hi = p.S - 1;
  }
}

// shared-memory carve-up (floats) for `rows` staged query rows (a multiple
// of MAX_ROWS), one KC-key tile of K and V, and one MAX_ROWS x KC tile each
// of P and dS
struct Smem {
  size_t q, dO, k, v, p, ds, lse, dl, lo, hi, total;
  __host__ __device__ Smem(int rows, int Dk, int Dv) {
    q = 0;
    dO = q + round4((size_t)rows * Dk);
    k = dO + round4((size_t)rows * Dv);
    v = k + round4((size_t)KC * (Dk + 4));
    p = v + round4((size_t)KC * (Dv + 4));
    ds = p + round4((size_t)MAX_ROWS * SP);
    lse = ds + round4((size_t)MAX_ROWS * SP);
    dl = lse + rows;
    lo = dl + rows;   // ints
    hi = lo + rows;   // ints
    total = hi + rows;
  }
};

// Stages the query rows of tokens [t0, t0+nt) of (b, g): Q and dO rows,
// lse, delta and each row's visible key range.
template <typename T>
__device__ __forceinline__ void stage_rows(const Params& p, const T* Q, const T* dO,
                                           const float* lse, const float* delta, int b, int g,
                                           int t0, int nt, float* q_s, float* do_s,
                                           float* lse_s, float* dl_s, int* lo_s, int* hi_s) {
  const int h = p.h;
  auto row_of = [&](int r) -> size_t {
    const int i = r / h;
    return (((size_t)b * p.S + t0 + i) * p.G + g) * h + (r - i * h);
  };
  const int rows = nt * h;
  load_rows_vec<T>(q_s, p.Dk, [&](int r) -> const T* { return Q + row_of(r) * p.Dk; }, p.Dk,
                   rows);
  load_rows_vec<T>(do_s, p.Dv, [&](int r) -> const T* { return dO + row_of(r) * p.Dv; }, p.Dv,
                   rows);
  for (int r = threadIdx.x; r < rows; r += THREADS) {
    const size_t o = row_of(r);
    lse_s[r] = lse[o];
    dl_s[r] = delta[o];
    key_range(p, t0 + r / h, lo_s[r], hi_s[r]);
  }
}

}  // namespace band
}  // namespace nsa
