// Pieces of the banded (window / compressed-prefix) backward kernels of the
// one-pass, diagonal and two-pass designs: the visibility rule, the staging
// of query rows, the shared-memory carve-up of the f32 FMA kernels, the
// slot count of the one-pass dQ workspace and the strip sum of the diagonal
// design. Which kernel serves which dtype: f32 operands take the FMA
// kernels (banded_bwd_1p.cu, win_bwd_diag.cu, banded_bwd.cu), bf16 operands
// the tensor-core kernels (banded_bwd_mma.cu); both write the same slots
// and strips and finish with the same sum_slots / sum_strips.
#pragma once

#include "bwd_common.cuh"

namespace nsa {
namespace band {

using namespace nsa::bwd;

enum Mode : int { WIN = 0, CMP = 1 };

struct Params {
  int B, S, S_kv, G, h, Dk, Dv, mode, w, l, d, TQ, nsplit;
  float scale;
  // position of query row 0 (sequence sharding: the rows are a slice of
  // the sequence that K/V cover whole). The FMA kernels and the
  // slot and strip sums read it always, the tensor-core kernels only in
  // their OFF instantiation, so the dense one compiles as it did before
  int t_start;
};

// keys [lo, hi) that query token t (a position: t_start + row token) sees
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

// Packed documents: raises query token t's lo to its document's bound
// (common.cuh::doc_lo). The tensor-core kernels call it only in their DOCS
// instantiation, so the dense one compiles as it did before documents
// existed; the FMA kernels test ds != nullptr.
__device__ __forceinline__ void doc_bound(const Params& p, const int* __restrict__ ds, int b,
                                          int t, int& lo) {
  lo = max(lo, doc_lo(doc_start(ds, p.S, b, t), p.mode == CMP, p.d));
}

// the dQ slot of a row with visible keys [lo, hi) for key tile kt, or -1
// where the row sees no key of the tile: slots count the key tiles the row
// sees from its first (BandSlots)
__device__ __forceinline__ int band_slot(int kt, int lo, int hi) {
  return hi > lo && kt >= lo / KC && kt <= (hi - 1) / KC ? kt - lo / KC : -1;
}

// query tokens (rows' token indices) [t_lo, t_hi] that see at least one
// key of [k0, k1), k1 > k0 (under ds a superset of those that do); OFF:
// row token s sits at position t_start + s (else at s)
template <bool OFF>
__device__ __forceinline__ void token_range(const Params& p, int k0, int k1, int& t_lo,
                                            int& t_hi) {
  if (OFF) {
    if (p.mode == WIN) {
      t_lo = max(k0 - p.t_start, 0);
      t_hi = min(k1 - 1 + p.w - 1 - p.t_start, p.S - 1);
    } else {
      t_lo = max(k0 * p.d + p.l - 1 - p.t_start, 0);
      t_hi = p.S - 1;
    }
  } else if (p.mode == WIN) {
    t_lo = k0;
    t_hi = min(k1 - 1 + p.w - 1, p.S - 1);
  } else {
    t_lo = k0 * p.d + p.l - 1;
    t_hi = p.S - 1;
  }
}

// dQ slots a row of the one-pass design wrote (sum_slots' count): the key
// tiles its token sees. Slot of a (row, key tile kt): WIN kt - lo(t)/64,
// CMP kt; with ds (DOCS) kt - lo(t)/64 in both (band_slot), lo under the
// document bound. The kv pass and this count form lo alike.
template <bool DOCS>
struct BandSlots {
  Params p;
  const int* ds;
  __device__ int operator()(long long row) const {
    const int t = (int)((row / ((long long)p.G * p.h)) % p.S);
    int lo, hi;
    key_range(p, p.t_start + t, lo, hi);
    if (DOCS) doc_bound(p, ds, (int)(row / ((long long)p.G * p.h * p.S)), t, lo);
    return hi > lo ? (hi - 1) / KC - lo / KC + 1 : 0;
  }
};

// shared-memory carve-up (floats) of the FMA kernels for `rows` staged
// query rows (a multiple of MAX_ROWS), one KC-key tile of K and V, and one
// MAX_ROWS x KC tile each of P and dS
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

// Stages the f32 query rows of tokens [t0, t0+nt) of (b, g): Q and dO rows,
// lse, delta and each row's visible key range (under ds, when not null).
__device__ __forceinline__ void stage_rows(const Params& p, const float* Q, const float* dO,
                                           const float* lse, const float* delta,
                                           const int* ds, int b, int g, int t0, int nt,
                                           float* q_s, float* do_s, float* lse_s, float* dl_s,
                                           int* lo_s, int* hi_s) {
  const int h = p.h;
  auto row_of = [&](int r) -> size_t {
    const int i = r / h;
    return (((size_t)b * p.S + t0 + i) * p.G + g) * h + (r - i * h);
  };
  const int rows = nt * h;
  load_rows_vec<float>(q_s, p.Dk, [&](int r) -> const float* { return Q + row_of(r) * p.Dk; },
                       p.Dk, rows);
  load_rows_vec<float>(do_s, p.Dv, [&](int r) -> const float* { return dO + row_of(r) * p.Dv; },
                       p.Dv, rows);
  for (int r = threadIdx.x; r < rows; r += THREADS) {
    const size_t o = row_of(r);
    lse_s[r] = lse[o];
    dl_s[r] = delta[o];
    key_range(p, p.t_start + t0 + r / h, lo_s[r], hi_s[r]);
    if (ds != nullptr) doc_bound(p, ds, b, t0 + r / h, lo_s[r]);
  }
}

// Strips of the diagonal design: q tile qt (tokens [qt*TQ, qt*TQ+TQ), at
// positions t_start + token) wrote the dK/dV of its band's keys to strip
// rows [0, ...) of [B, G, nq, SL, D], strip row 0 being key kb0(qt) =
// floor(max(t_start + qt*TQ - w + 1, 0) / align) * align (align 1 for the FMA kernel, 64 for the tensor-core kernel, whose
// key tiles sit at multiples of 64). The band is the dense one also under
// ds, so every strip row this sum reads was written (zeros for the keys
// that no row of the tile sees in its document).
// out[b, g, k, :] = mul * (sum over the q tiles whose band covers key k, in
// ascending order, of their strip row k - kb0(qt)), cast to T; keys no row
// sees (k - t_start outside [1 - w, S)) get 0.
template <typename T>
__global__ void __launch_bounds__(THREADS)
sum_strips_kernel(const float* __restrict__ strip, T* __restrict__ out, Params p, int D, int SL,
                  float mul, int align) {
  const int nq = (p.S + p.TQ - 1) / p.TQ;
  const int d4 = D / 4;
  const long long n = (long long)p.B * p.G * p.S_kv * d4;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * THREADS) {
    const long long krow = i / d4;             // (b*G + g)*S_kv + k
    const int c = (int)(i - krow * d4) * 4;
    const long long bg = krow / p.S_kv;
    const int k = (int)(krow - bg * p.S_kv);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    const int kl = k - p.t_start;   // the first row token that sees key k
    if (kl < p.S && kl + p.w - 1 >= 0) {
      const int qa = max(kl, 0) / p.TQ;
      const int qb = min((kl + p.w - 1) / p.TQ, nq - 1);
      for (int qt = qa; qt <= qb; ++qt) {
        const int kb0 = max(p.t_start + qt * p.TQ - p.w + 1, 0) / align * align;
        const float4 x = *reinterpret_cast<const float4*>(
            strip + ((bg * nq + qt) * SL + (k - kb0)) * (size_t)D + c);
        a.x += x.x;
        a.y += x.y;
        a.z += x.z;
        a.w += x.w;
      }
    }
    store4<T>(out + krow * D + c, make_float4(a.x * mul, a.y * mul, a.z * mul, a.w * mul));
  }
}

template <typename T>
int sum_strips(const float* strip, void* out, const Params& p, int D, int SL, float mul,
               int align, cudaStream_t stream) {
  const long long want = ((long long)p.B * p.G * p.S_kv * (D / 4) + THREADS - 1) / THREADS;
  const unsigned grid = (unsigned)(want < 8192 ? want : 8192);
  sum_strips_kernel<T><<<grid, THREADS, 0, stream>>>(strip, static_cast<T*>(out), p, D, SL, mul,
                                                     align);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace band
}  // namespace nsa
