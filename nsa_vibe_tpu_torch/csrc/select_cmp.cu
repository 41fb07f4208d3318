// select_cmp: fused NSA selection scorer (Eq. 8-12) and compressed-branch
// forward, in one pass over the compressed stream.
//
// Replaces: nsa_vibe_tpu/ops/pallas/scorer.py::nsa_select_and_cmp_pallas
// (kernel _select_cmp_kernel, top-n epilogue _scorer_topn).
//
// What it computes, per query row (token t, head j of group g):
//   p      = softmax(q · K_cmp^T * scale) over c < num_cmp(t+1)   (Eq. 8)
//   O_cmp  = p · V_cmp                                           (cmp branch)
//   p_slc  = p · M_csl                                           (Eq. 9)
// then per token: p_grp = sum over the group's h heads of p_slc (Eq. 10),
// the forced blocks {0, t//l_sel, t//l_sel - 1} (clamped at 0) and
// n_top - n_forced argmax passes over `p_grp - 1e-8 * index` among blocks
// with start <= t that are not forced (Eq. 11-12). Output contract of the
// TPU kernel: forced slots first (may repeat), then picks in descending
// score order, -1 when no candidate is left. Rows with no visible
// compressed token get O_cmp = 0 and p_slc = 0.
//
// What bounds it on the H100: at the m7c serving shape (S=2048, S_cmp=127,
// S_sel=32, h=6, D=64) the work is ~4 GFLOP for ~25 MB of Q/O traffic, so
// bytes bound it on paper (~8 us); this FMA design is instead bound by
// shared-memory reads feeding f32 FMAs. Design: one block per
// (b, g, tile of TQ tokens x h heads); K_cmp/V_cmp (16-byte loads, several
// in flight per thread) and M_csl stream through shared memory in chunks
// of 32 compressed tokens (one per lane) and only up to the tile's prefix
// bound; one warp per row keeps the online softmax (Q·K from float4 reads),
// and the O and p_slc accumulators live in shared memory so any h (odd
// included) and S_sel up to MAX_S_SEL fit without padding. The top-n runs
// one warp per token with shuffle argmax reductions. tensor-core (wgmma)
// tiles are later work.
#include "common.cuh"

using namespace nsa;

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int KC = 32;           // compressed tokens per chunk: one per lane
constexpr int MAX_S_SEL = 256;   // p_slc accumulator row width (shared memory)

struct Params {
  int S, G, h, Dk, Dv, S_cmp, S_sel, l, d, l_sel, n_top, force_init, force_local, TQ;
  float scale;
};

// shared-memory carve-up (floats): Q rows, O and p_slc accumulators, row
// max/sum, one chunk of K (pitch Dk+4), V and M, per-warp probabilities
struct Smem {
  size_t q, acc_o, acc_p, m, l, k, v, M, p, total;
  __host__ __device__ Smem(int TQ, int h, int Dk, int Dv, int S_sel) {
    const size_t R = (size_t)TQ * h;
    q = 0;
    acc_o = q + round4(R * Dk);
    acc_p = acc_o + round4(R * Dv);
    m = acc_p + round4(R * S_sel);
    l = m + round4(R);
    k = l + round4(R);
    v = k + round4((size_t)KC * (Dk + 4));
    M = v + round4((size_t)KC * Dv);
    p = M + round4((size_t)KC * S_sel);
    total = p + NWARPS * KC;
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
select_cmp_kernel(const T* __restrict__ Q, const T* __restrict__ Kc, const T* __restrict__ Vc,
                  const float* __restrict__ Mcsl, int* __restrict__ sel, T* __restrict__ O,
                  Params p) {
  extern __shared__ __align__(16) float smem[];
  const int nq = (p.S + p.TQ - 1) / p.TQ;
  int bid = blockIdx.x;
  const int qt = bid % nq;
  bid /= nq;
  const int g = bid % p.G;
  const int b = bid / p.G;
  const int s0 = qt * p.TQ;
  const int nt = min(p.TQ, p.S - s0);
  const int h = p.h, Dk = p.Dk, Dv = p.Dv, S_sel = p.S_sel;
  const int rows = nt * h;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const Smem L(p.TQ, h, Dk, Dv, S_sel);
  float* q_s = smem + L.q;            // [R][Dk]
  float* acc_o = smem + L.acc_o;      // [R][Dv]
  float* acc_p = smem + L.acc_p;      // [R][S_sel]
  float* m_s = smem + L.m;            // [R]
  float* l_s = smem + L.l;            // [R]
  float* k_s = smem + L.k;            // [KC][Dk+4] (pitch: conflict-free float4 rows per lane)
  float* v_s = smem + L.v;            // [KC][Dv]
  float* M_s = smem + L.M;            // [KC][S_sel]
  float* pw = smem + L.p + warp * KC; // this warp's probabilities [KC]
  const int kp = Dk + 4;

  // row r = i*h + j is token s0+i, head j; its Q/O row index in [B,S,G,h]
  auto qo_row = [&](int r) -> size_t {
    const int i = r / h, j = r - i * h;
    return (((size_t)b * p.S + s0 + i) * p.G + g) * h + j;
  };
  load_rows_vec<T>(q_s, Dk, [&](int r) -> const T* { return Q + qo_row(r) * Dk; }, Dk, rows);
  for (int idx = tid; idx < rows * Dv; idx += THREADS) acc_o[idx] = 0.f;
  for (int idx = tid; idx < rows * S_sel; idx += THREADS) acc_p[idx] = 0.f;
  for (int idx = tid; idx < rows; idx += THREADS) {
    m_s[idx] = NEG;
    l_s[idx] = 0.f;
  }

  const T* Kbg = Kc + ((size_t)b * p.G + g) * p.S_cmp * Dk;
  const T* Vbg = Vc + ((size_t)b * p.G + g) * p.S_cmp * Dv;
  // prefix bound of the tile's last token: no row of the tile sees past it
  const int n_vis_tile = min(num_cmp(s0 + nt, p.l, p.d), p.S_cmp);

  for (int c0 = 0; c0 < n_vis_tile; c0 += KC) {
    __syncthreads();   // previous chunk consumed, accumulators initialised
    load_rows_vec<T>(k_s, kp, Kbg, Dk, c0, KC, p.S_cmp);
    load_rows_vec<T>(v_s, Dv, Vbg, Dv, c0, KC, p.S_cmp);
    load_rows(M_s, S_sel, Mcsl, S_sel, c0, KC, p.S_cmp);
    __syncthreads();
    for (int r = warp; r < rows; r += NWARPS) {
      const int t = s0 + r / h;
      const int nvis = min(num_cmp(t + 1, p.l, p.d), p.S_cmp);
      if (nvis <= c0) continue;   // warp-uniform: this row sees nothing here
      const int jmax = min(KC, nvis - c0);
      const bool vis = lane < jmax;
      const float logit = vis ? dot4(q_s + r * Dk, k_s + lane * kp, Dk) * p.scale : NEG;
      float pr, alpha;
      online_softmax_step(logit, vis, m_s + r, l_s + r, pr, alpha);
      pw[lane] = pr;
      __syncwarp();
      for (int c = 2 * lane; c < Dv; c += 64) {
        float2 a = *reinterpret_cast<float2*>(acc_o + r * Dv + c);
        a.x *= alpha;
        a.y *= alpha;
        for (int j = 0; j < jmax; ++j) {
          const float pj = pw[j];
          const float2 v = *reinterpret_cast<const float2*>(v_s + j * Dv + c);
          a.x = fmaf(pj, v.x, a.x);
          a.y = fmaf(pj, v.y, a.y);
        }
        *reinterpret_cast<float2*>(acc_o + r * Dv + c) = a;
      }
      for (int c = lane; c < S_sel; c += 32) {
        float a = acc_p[r * S_sel + c] * alpha;
        for (int j = 0; j < jmax; ++j) a = fmaf(pw[j], M_s[j * S_sel + c], a);
        acc_p[r * S_sel + c] = a;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // epilogue 1: normalise; write O_cmp; p_slc = acc_p / l (0 without visible tokens)
  for (int r = warp; r < rows; r += NWARPS) {
    const float den = l_s[r];
    const size_t orow = qo_row(r);
    for (int c = lane; c < Dv; c += 32)
      O[orow * Dv + c] = from_f<T>(den > 0.f ? acc_o[r * Dv + c] / den : 0.f);
    for (int c = lane; c < S_sel; c += 32)
      acc_p[r * S_sel + c] = den > 0.f ? acc_p[r * S_sel + c] / den : 0.f;
  }
  __syncthreads();

  // epilogue 2: per token, Eq. 10 group sum, forced slots, argmax passes
  const int n_forced = (p.force_init ? 1 : 0) + p.force_local;
  const int n_out = max(p.n_top, n_forced);
  const int k_rest = p.n_top - n_forced;
  for (int i = warp; i < nt; i += NWARPS) {
    const int t = s0 + i;
    const int last = t / p.l_sel;
    float* comp = acc_p + (size_t)i * h * S_sel;   // row i*h becomes the composite score
    int* out = sel + (((size_t)b * p.S + s0 + i) * p.G + g) * n_out;
    for (int c = lane; c < S_sel; c += 32) {
      float grp = 0.f;
      for (int j = 0; j < h; ++j) grp += acc_p[(i * h + j) * S_sel + c];
      bool forced = p.force_init && c == 0;
      for (int f = 0; f < p.force_local; ++f) forced = forced || c == max(last - f, 0);
      const bool valid = (long long)c * p.l_sel <= t;
      const float score = (valid && !forced) ? grp : NEG;
      comp[c] = __fsub_rn(score, __fmul_rn((float)c, 1e-8f));
    }
    if (lane == 0) {
      int f = 0;
      if (p.force_init) out[f++] = 0;
      for (int k = 0; k < p.force_local; ++k) out[f++] = max(last - k, 0);
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

template <typename T>
int launch(const void* Q, const void* Kc, const void* Vc, const float* M, int* sel, void* O,
           int B, const Params& p, cudaStream_t stream) {
  const size_t smem = Smem(p.TQ, p.h, p.Dk, p.Dv, p.S_sel).total * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(select_cmp_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long nq = (p.S + p.TQ - 1) / p.TQ;
  const long long grid = (long long)B * p.G * nq;
  select_cmp_kernel<T><<<(unsigned)grid, THREADS, smem, stream>>>(
      static_cast<const T*>(Q), static_cast<const T*>(Kc), static_cast<const T*>(Vc), M, sel,
      static_cast<T*>(O), p);
  NSA_LAUNCH_CHECK();
}

}  // namespace

extern "C" {

const char* nsa_error_string(int e) { return cudaGetErrorString(static_cast<cudaError_t>(e)); }

int nsa_select_cmp_max_s_sel() { return MAX_S_SEL; }

long long nsa_select_cmp_smem_bytes(int TQ, int h, int Dk, int Dv, int S_sel) {
  return (long long)(Smem(TQ, h, Dk, Dv, S_sel).total * sizeof(float));
}

int nsa_select_cmp(int dtype, const void* Q, const void* Kc, const void* Vc, const float* M,
                   int* sel, void* O, int B, int S, int G, int h, int Dk, int Dv, int S_cmp,
                   int S_sel, int l, int d, int l_sel, int n_top, int force_init,
                   int force_local, float scale, int TQ, void* stream) {
  if (S_sel > MAX_S_SEL || S_cmp <= 0 || TQ <= 0) return (int)cudaErrorInvalidValue;
  const Params p{S, G, h, Dk, Dv, S_cmp, S_sel, l, d, l_sel, n_top, force_init, force_local,
                 TQ, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) return launch<float>(Q, Kc, Vc, M, sel, O, B, p, s);
  if (dtype == DT_BF16) return launch<__nv_bfloat16>(Q, Kc, Vc, M, sel, O, B, p, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
