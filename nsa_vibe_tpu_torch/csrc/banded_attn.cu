// banded_attn: axis-aligned banded (window) or prefix (compressed) attention
// forward with a query position offset, f32.
//
// Replaces, for f32 operands: nsa_vibe_tpu/ops/pallas/flash.py::flash_banded
// (kernel _flash_kernel, row bounds _bounds_fn) and, in window mode at
// t_start = 0, nsa_vibe_tpu/ops/pallas/flash_diag.py::flash_banded_diag
// (kernel _diag_kernel, the window forward win_attn runs). bf16 operands
// take the tensor-core kernel of banded_fwd_mma.cu; f32 stays here, on
// FMA, since its 5e-5 gates rule out TF32.
//
// What it computes: query row s sits at position t = t_start + s and sees
//   WIN: keys [max(t-w+1, 0, ds), t]                   (and < S_kv)
//   CMP: compressed tokens [ceil(ds/d), num_cmp(t+1))  (none while t+1 < l; < S_kv)
// with ds the row's document start (packed documents: ds [B,S] given; row
// s reads ds[b, s], a packed position, also at t_start > 0) or 0.
// softmax in f32; a row with no visible key returns O = 0. Optionally (lse
// != nullptr) the row statistics lse [B,S,G,h] f32 = m + log(l) in the
// natural base, EMPTY_LSE for a row with no key (the port's convention,
// consumed by the backward kernels; the TPU kernel writes base-2 lse in a
// flat [B*G, 1, stats_rows] layout instead).
//
// What bounds it on the H100: at the m7c 64k prefill (B=1, S=65536, G=2,
// h=6, D=64, CMP over S_cmp=4095) the visible (row, key) pairs are ~1.6 G,
// ~412 GFLOP of QK^T and PV against ~0.5 GB of Q/K/V/O; in f32 outside the
// tensor cores (67 TFLOP/s) that is ~6.2 ms. This FMA design is bound by
// FMA issue and shared-memory reads.
// Design: one block per (b, g, tile of TQ tokens x h heads, at most 64
// rows); only the tile's band of K/V, [lo(t_first), hi(t_last)), streams
// through shared memory (16-byte loads), 64 keys per chunk from an
// absolute multiple of 64 (so the rows of a call at t_start > 0 equal
// those of the full call, as in banded_fwd_mma.cu); each chunk
// forms the [rows, 64] logits in 4x4 register tiles, runs the online
// softmax one warp per row, and accumulates P·V into (row, 4 dims) slices
// each thread keeps in registers. The mode is a template argument, so each
// instantiation tests only its own bounds.
#include "common.cuh"

using namespace nsa;

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int KC = 64;          // keys per chunk
constexpr int MAX_ROWS = 64;    // query rows (tokens x heads) per block
constexpr int MAX_SLICES = 8;   // (row, 4 output dims) slices per thread: Dv <= 128

enum Mode : int { WIN = 0, CMP = 1 };

struct Params {
  int S, S_kv, G, h, Dk, Dv, w, l, d, t_start, TQ;
  float scale;
};

// keys [lo, hi) that the query at position t, in a document starting at
// `start`, sees (start = 0: the dense bound)
template <int MODE>
__device__ __forceinline__ void key_range(const Params& p, int t, int start, int& lo, int& hi) {
  lo = max(MODE == WIN ? max(t - p.w + 1, 0) : 0, doc_lo(start, MODE == CMP, p.d));
  hi = min(MODE == WIN ? t + 1 : num_cmp(t + 1, p.l, p.d), p.S_kv);
}

// shared-memory carve-up (floats): Q rows, one chunk of K (pitch Dk+4) and
// V, the [rows, KC] logits/probabilities, row max/sum/rescale
struct Smem {
  size_t q, k, v, s, m, l, a, total;
  __host__ __device__ Smem(int TQ, int h, int Dk, int Dv) {
    const size_t R = (size_t)TQ * h;
    q = 0;
    k = q + round4(R * Dk);
    v = k + round4((size_t)KC * (Dk + 4));
    s = v + round4((size_t)KC * Dv);
    m = s + round4(R * KC);
    l = m + round4(R);
    a = l + round4(R);
    total = a + round4(R);
  }
};

// Per block: rows r = i*h + j (token s0+i, head j) of one (b, g); the band
// of K/V streams through shared memory KC keys at a time, and each chunk
// runs three phases separated by barriers:
//   A. logits [rows, KC]: each thread a 4x4 tile (rows ri+16m, keys
//      ki+16n), so every float4 read of Q or K feeds four FMAs per lane;
//   B. online softmax: one warp per row, two keys per lane;
//   C. O += P V: each thread owns (row, 4 dims) output slices in registers
//      (dims fixed per thread, rows strided), reusing each V read across
//      its rows. NS, the slices a thread can own at this Dv (4 at Dv=64),
//      is a template argument: guards for slices that cannot exist would
//      cost predicates the compiler then re-tests inside the P·V loop.
template <int NS, int MODE>
__global__ void __launch_bounds__(THREADS)
banded_attn_kernel(const float* __restrict__ Q, const float* __restrict__ K,
                   const float* __restrict__ V, const int* __restrict__ ds,
                   const float* __restrict__ gate, float* __restrict__ O,
                   float* __restrict__ lse, Params p) {
  using T = float;
  extern __shared__ __align__(16) float smem[];
  const int nq = (p.S + p.TQ - 1) / p.TQ;
  int bid = blockIdx.x;
  const int qt = bid % nq;
  bid /= nq;
  const int g = bid % p.G;
  const int b = bid / p.G;
  const int s0 = qt * p.TQ;
  const int nt = min(p.TQ, p.S - s0);
  const int h = p.h, Dk = p.Dk, Dv = p.Dv;
  const int rows = nt * h;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const Smem L(p.TQ, h, Dk, Dv);
  float* q_s = smem + L.q;   // [R][Dk]
  float* k_s = smem + L.k;   // [KC][Dk+4]
  float* v_s = smem + L.v;   // [KC][Dv]
  float* s_s = smem + L.s;   // [R][KC]
  float* m_s = smem + L.m;   // [R]
  float* l_s = smem + L.l;   // [R]
  float* a_s = smem + L.a;   // [R] rescale of the running output for this chunk
  const int kp = Dk + 4;

  auto qo_row = [&](int r) -> size_t {
    const int i = r / h, j = r - i * h;
    return (((size_t)b * p.S + s0 + i) * p.G + g) * h + j;
  };
  load_rows_vec<T>(q_s, Dk, [&](int r) -> const T* { return Q + qo_row(r) * Dk; }, Dk, rows);
  for (int idx = tid; idx < rows; idx += THREADS) {
    m_s[idx] = NEG;
    l_s[idx] = 0.f;
  }
  const int d4 = Dv / 4;
  const int rstride = THREADS / d4;
  const int c4 = tid % d4, rbase = tid / d4;
  const bool owner = tid < d4 * rstride;
  float4 acc[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int ri = tid / 16, ki = tid % 16;

  const T* Kbg = K + ((size_t)b * p.G + g) * p.S_kv * Dk;
  const T* Vbg = V + ((size_t)b * p.G + g) * p.S_kv * Dv;
  const int t_first = p.t_start + s0;
  // both bounds grow with t: the first token's lo and the last token's hi
  // bound the tile's band; chunks start at absolute multiples of KC, so a
  // row's result does not depend on the tile that holds it (a chunk where
  // the row sees no key leaves its state exactly as it was) and a call at
  // t_start > 0 gives the same bits as those rows of the full call
  // the document start of the tile's token s0 + i: 0 without ds
  auto start = [&](int i) { return ds != nullptr ? doc_start(ds, p.S, b, s0 + i) : 0; };
  int lo, hi, unused;
  key_range<MODE>(p, t_first, start(0), lo, unused);
  key_range<MODE>(p, t_first + nt - 1, 0, unused, hi);
  lo = lo / KC * KC;
  // per-row visible range of the rows of this thread's phase-A tile
  int rlo[4], rhi[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int i = min(ri + 16 * m, rows - 1) / h;
    key_range<MODE>(p, t_first + i, start(i), rlo[m], rhi[m]);
  }

  for (int k0 = lo; k0 < hi; k0 += KC) {
    __syncthreads();   // previous chunk consumed (and Q staged)
    load_rows_vec<T>(k_s, kp, Kbg, Dk, k0, KC, hi);
    load_rows_vec<T>(v_s, Dv, Vbg, Dv, k0, KC, hi);
    __syncthreads();
    {  // A: logits
      float sc[4][4];
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
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int r = ri + 16 * m;
        if (r < rows) {
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const int key = k0 + ki + 16 * n;
            const bool vis = key >= rlo[m] && key < rhi[m];
            s_s[r * KC + ki + 16 * n] = vis ? sc[m][n] * p.scale : NEG;
          }
        }
      }
    }
    __syncthreads();
    for (int r = warp; r < rows; r += NWARPS) {   // B: online softmax per row
      float* sr = s_s + r * KC;
      const float x0 = sr[lane], x1 = sr[lane + 32];
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
      const float p0 = x0 > NEG ? expf(x0 - m_new) : 0.f;
      const float p1 = x1 > NEG ? expf(x1 - m_new) : 0.f;
      sr[lane] = p0;
      sr[lane + 32] = p1;
      const float psum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + psum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    if (owner) {   // C: O += P V
      const int jmax = min(KC, hi - k0);
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        const int r = rbase + rstride * k;
        if (r < rows) {
          const float al = a_s[r];
          acc[k].x *= al;
          acc[k].y *= al;
          acc[k].z *= al;
          acc[k].w *= al;
        }
      }
      for (int j = 0; j < jmax; ++j) {
        const float4 vv = *reinterpret_cast<const float4*>(v_s + j * Dv + 4 * c4);
#pragma unroll
        for (int k = 0; k < NS; ++k) {
          const int r = rbase + rstride * k;
          if (r < rows) {
            const float pj = s_s[r * KC + j];
            acc[k].x = fmaf(pj, vv.x, acc[k].x);
            acc[k].y = fmaf(pj, vv.y, acc[k].y);
            acc[k].z = fmaf(pj, vv.z, acc[k].z);
            acc[k].w = fmaf(pj, vv.w, acc[k].w);
          }
        }
      }
    }
  }
  __syncthreads();
  if (owner) {
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const int r = rbase + rstride * k;
      if (r < rows) {
        const float den = l_s[r];
        float4 o = acc[k];
        o.x = den > 0.f ? o.x / den : 0.f;
        o.y = den > 0.f ? o.y / den : 0.f;
        o.z = den > 0.f ? o.z / den : 0.f;
        o.w = den > 0.f ? o.w / den : 0.f;
        if (gate != nullptr) {   // the gate-epilogue fold: O * g of the row's (b, s, g)
          const float gv = gate[qo_row(r) / h];
          o = make_float4(o.x * gv, o.y * gv, o.z * gv, o.w * gv);
        }
        store4<T>(O + qo_row(r) * Dv + 4 * c4, o);
      }
    }
  }
  if (lse != nullptr)
    for (int r = tid; r < rows; r += THREADS) lse[qo_row(r)] = row_lse(m_s[r], l_s[r]);
}

template <int NS, int MODE>
int launch_ns(const void* Q, const void* K, const void* V, const int* ds, const float* gate,
              void* O, float* lse, int B, const Params& p, cudaStream_t stream) {
  const size_t smem = Smem(p.TQ, p.h, p.Dk, p.Dv).total * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(banded_attn_kernel<NS, MODE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long nq = (p.S + p.TQ - 1) / p.TQ;
  const long long grid = (long long)B * p.G * nq;
  banded_attn_kernel<NS, MODE><<<(unsigned)grid, THREADS, smem, stream>>>(
      static_cast<const float*>(Q), static_cast<const float*>(K), static_cast<const float*>(V),
      ds, gate, static_cast<float*>(O), lse, p);
  NSA_LAUNCH_CHECK();
}

// NS = the (row, 4 dims) slices one thread can own: ceil(MAX_ROWS / rstride)
// with rstride = THREADS / (Dv / 4), rounded up to 1, 2, 4 or MAX_SLICES
template <int MODE>
int launch(const void* Q, const void* K, const void* V, const int* ds, const float* gate, void* O,
           float* lse, int B, const Params& p, cudaStream_t stream) {
  const int rstride = THREADS / (p.Dv / 4);
  const int ns = (MAX_ROWS + rstride - 1) / rstride;
  if (ns <= 1) return launch_ns<1, MODE>(Q, K, V, ds, gate, O, lse, B, p, stream);
  if (ns <= 2) return launch_ns<2, MODE>(Q, K, V, ds, gate, O, lse, B, p, stream);
  if (ns <= 4) return launch_ns<4, MODE>(Q, K, V, ds, gate, O, lse, B, p, stream);
  return launch_ns<MAX_SLICES, MODE>(Q, K, V, ds, gate, O, lse, B, p, stream);
}

}  // namespace

extern "C" {

long long nsa_banded_attn_smem_bytes(int TQ, int h, int Dk, int Dv) {
  return (long long)(Smem(TQ, h, Dk, Dv).total * sizeof(float));
}

// f32 only. Q [B,S,G,h,Dk], K [B,G,S_kv,Dk], V [B,G,S_kv,Dv], ds [B,S]
// int32 document starts (or null), gate [B,S,G] f32 (or null: ungated) ->
// O [B,S,G,h,Dv] (times the row's gate), lse [B,S,G,h] (or null). mode 0
// WIN (w > 0), 1 CMP (l, d > 0); tiles of TQ tokens, TQ * h <= 64.
int nsa_banded_attn(const void* Q, const void* K, const void* V, const int* ds,
                    const float* gate, void* O, float* lse, int B, int S, int S_kv, int G, int h,
                    int Dk, int Dv, int mode,
                    int w, int l, int d, int t_start, float scale, int TQ, void* stream) {
  if (TQ <= 0 || TQ * h > MAX_ROWS || Dv > 4 * MAX_SLICES * (THREADS / MAX_ROWS) ||
      Dv % 8 != 0 || Dk % 8 != 0 || t_start < 0 ||
      (mode != WIN && mode != CMP) ||
      (mode == WIN && w <= 0) || (mode == CMP && (l <= 0 || d <= 0)))
    return (int)cudaErrorInvalidValue;
  const Params p{S, S_kv, G, h, Dk, Dv, w, l, d, t_start, TQ, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == WIN) return launch<WIN>(Q, K, V, ds, gate, O, lse, B, p, s);
  return launch<CMP>(Q, K, V, ds, gate, O, lse, B, p, s);
}

}  // extern "C"
