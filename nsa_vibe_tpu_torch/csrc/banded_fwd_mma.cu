// banded_fwd_mma: the bf16 banded forward on tensor cores, for the sliding
// window and for the compressed prefix.
//
// Replaces, for bf16 operands: nsa_vibe_tpu/ops/pallas/flash_diag.py::
// flash_banded_diag (kernel _diag_kernel, the window forward) and
// nsa_vibe_tpu/ops/pallas/flash.py::flash_banded (kernel _flash_kernel,
// window or compressed prefix, with t_start). f32 keeps the FMA kernel of
// banded_attn.cu (its 5e-5 gates rule out TF32).
//
// What it computes, as banded_attn.cu: query row s sits at position t =
// t_start + s and sees
//   WIN: keys [max(t-w+1, 0), min(t+1, S_kv))
//   CMP: compressed tokens [0, min(num_cmp(t+1), S_kv))
// softmax over the visible keys; a row with no visible key returns O = 0.
// With lse != nullptr also lse [B,S,G,h] f32 = m + log(l) (natural base),
// EMPTY_LSE for a row with no key: the port's convention, which
// win_bwd_diag, banded_bwd_1p and banded_bwd read.
//
// What bounds it on the H100: two products of 2 FLOP per visible (row,
// key) pair against the bytes of Q, K, V and O. At the m7c shapes (G=2,
// h=6, D=64) that is ~13 GFLOP for the window at the serve shape (B=4,
// S=2048, w=512; ~0.013 ms on the bf16 tensor cores against ~0.015 ms of
// bytes) and ~412 GFLOP for the compressed prefix at 64k (B=1, S=65536,
// S_cmp=4095; ~0.42 ms against ~0.2 ms of bytes): the tensor cores bound
// both.
// Design, cut for Hopper (not the TPU kernels' 128-wide band operands):
// one CTA of 4 or 8 warps per (b, g, q tile of rows r = token * h + head,
// 64 or 128 rows: 64 // h or 128 // h tokens; the h heads of a group share
// each K/V tile); warp w owns rows [16w, 16w+16).
//   - Key tiles of 64 keys at absolute multiples of 64: the first is
//     floor(lo(t_first) / 64) * 64. A row's result then does not depend on
//     which q tile holds it: a tile where the row sees no key leaves its
//     state exactly as it was (alpha = 1, p = 0), so a call at t_start > 0
//     gives the same bits as the same rows of the full call.
//   - K/V tiles double-buffered through cp.async (tc.cuh), zero-filled past
//     S_kv (padding memory may hold NaN and never enters a product); Q
//     staged once in shared memory, its A fragments read by ldmatrix at
//     each tile: held in registers they took the window kernel at D = 64
//     past 128 registers, so one CTA of 8 warps a SM; read again they add
//     a quarter to the S product's shared-memory reads and leave both
//     modes within 128 registers, two CTAs a SM.
//   - S = Q K^T and O += P V on mma.m16n8k16 with f32 accumulation;
//     scale * log2(e) multiplies the f32 logits in the exponent's FMA (Q
//     is not rounded after scaling). Only the band's edge tiles are
//     masked, per warp: a tile that every live row of the warp sees whole
//     takes no mask, and a tile that none sees is skipped (in CMP only the
//     last tile of a warp is partial).
//   - Online softmax per row in f32, base 2, the running max floored at
//     -1e20 (flash.py:206-208); l sums the unrounded p (flash.py:211); P
//     is rounded to bf16 as the A operand of P V, as the TPU kernels round
//     it (p.astype(v.dtype), flash.py:213, flash_diag.py:119), formed from
//     the accumulators in registers (tc::a_from_c).
//   - CMP load balance: later q tiles see longer prefixes, so blockIdx
//     walks the q tiles from the last to the first (every (b, g) of a q
//     tile together): the heaviest CTAs launch first.
//   - The mode is a template argument instantiated under two kernel names
//     (win_fwd_mma_kernel, cmp_fwd_mma_kernel), so a profile keeps the two
//     branches apart; the warp count is the launch's block size.
// wgmma with TMA suits a contiguous band better still: later work.
#include "common.cuh"
#include "tc.cuh"

using namespace nsa;

namespace {

constexpr int KC = 64;            // keys per K/V tile
constexpr int MAX_THREADS = 256;  // 8 warps: 128 rows
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float M_FLOOR = -1e20f;

enum Mode : int { WIN = 0, CMP = 1 };

// 2^x on the special function unit (relative error ~2^-22; 2^-inf and
// results below 2^-126 give 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

struct Params {
  int S, S_kv, G, h, Dk, Dv, w, l, d, t_start, qT, nq, BG;
  float scale;
};

// keys [lo, hi) that the query at position t sees; both grow with t
template <int MODE>
__device__ __forceinline__ void key_range(const Params& p, int t, int& lo, int& hi) {
  if (MODE == WIN) {
    lo = max(t - p.w + 1, 0);
    hi = min(t + 1, p.S_kv);
  } else {
    lo = 0;
    hi = min(num_cmp(t + 1, p.l, p.d), p.S_kv);
  }
}

// Shared memory (bytes): K[2], V[2] (KC keys each), then Q (`rows` rows);
// bf16, row pitch DT + 8 (tc.cuh).
template <int DT>
struct Layout {
  static constexpr int P = DT + 8;
  static constexpr size_t TILE = (size_t)KC * P * 2;
  static constexpr size_t K = 0, V = 2 * TILE, Q = 4 * TILE;
  static size_t bytes(int rows) { return Q + (size_t)rows * P * 2; }
};

template <int DT, int MODE>
__device__ __forceinline__ void band_fwd(const __nv_bfloat16* __restrict__ Q,
                                         const __nv_bfloat16* __restrict__ K,
                                         const __nv_bfloat16* __restrict__ V,
                                         __nv_bfloat16* __restrict__ O, float* __restrict__ lse,
                                         const Params& p) {
  using C = Layout<DT>;
  constexpr int P = C::P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nthr = blockDim.x, ROWS = nthr / 2;   // 16 rows per warp
  const int qt = p.nq - 1 - (int)(blockIdx.x / p.BG);   // the last q tile first
  const int bg = blockIdx.x % p.BG;                     // b * G + g
  const int g = bg % p.G, b = bg / p.G;
  const int s0 = qt * p.qT;
  const int T = min(p.qT, p.S - s0);   // live tokens of the tile
  const int h = p.h, Dk = p.Dk, Dv = p.Dv;
  const int R = T * h;                 // live rows
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, g8 = lane >> 2, t4 = lane & 3;
  const float sl2 = p.scale * LOG2E;

  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + C::K);   // [2][KC][P]
  __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + C::V);   // [2][KC][P]
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + C::Q);   // [ROWS][P]

  // global row of tile row r: token s0 + r / h, head r % h
  auto grow = [&](int r) -> size_t {
    return (((size_t)b * p.S + s0 + r / h) * p.G + g) * h + r % h;
  };
  // head-width padding: columns [D, DT) stay zero
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  for (int idx = tid; idx < ROWS * (DT / 8); idx += nthr) {
    const int r = idx / (DT / 8), c = (idx % (DT / 8)) * 8;
    if (c >= Dk) *reinterpret_cast<uint4*>(q_s + r * P + c) = z;
  }
  for (int idx = tid; idx < 2 * KC * (DT / 8); idx += nthr) {
    const int r = idx / (DT / 8), c = (idx % (DT / 8)) * 8;
    if (c >= Dk) *reinterpret_cast<uint4*>(k_s + r * P + c) = z;
    if (c >= Dv) *reinterpret_cast<uint4*>(v_s + r * P + c) = z;
  }
  for (int idx = tid; idx < ROWS * (Dk / 8); idx += nthr) {
    const int r = idx / (Dk / 8), c = (idx % (Dk / 8)) * 8;
    tc::cp_async16(q_s + r * P + c, r < R ? Q + grow(r) * Dk + c : Q, r < R);
  }

  // the tile's band [lo(t_first), hi(t_last)) in key tiles from an
  // absolute multiple of KC
  const int t_first = p.t_start + s0;
  int lo, hi, unused;
  key_range<MODE>(p, t_first, lo, unused);
  key_range<MODE>(p, t_first + T - 1, unused, hi);
  const int kb0 = (lo / KC) * KC;
  const int J = hi > lo ? (hi - kb0 + KC - 1) / KC : 0;

  const __nv_bfloat16* Kbg = K + (size_t)bg * p.S_kv * Dk;
  const __nv_bfloat16* Vbg = V + (size_t)bg * p.S_kv * Dv;
  auto issue = [&](int j, int buf) {
    const int k0 = kb0 + j * KC;
    const int nk = min(KC, p.S_kv - k0);
    __nv_bfloat16* kb = k_s + buf * KC * P;
    __nv_bfloat16* vb = v_s + buf * KC * P;
    for (int idx = tid; idx < KC * (Dk / 8); idx += nthr) {
      const int r = idx / (Dk / 8), c = (idx % (Dk / 8)) * 8;
      tc::cp_async16(kb + r * P + c, r < nk ? Kbg + (size_t)(k0 + r) * Dk + c : K, r < nk);
    }
    for (int idx = tid; idx < KC * (Dv / 8); idx += nthr) {
      const int r = idx / (Dv / 8), c = (idx % (Dv / 8)) * 8;
      tc::cp_async16(vb + r * P + c, r < nk ? Vbg + (size_t)(k0 + r) * Dv + c : V, r < nk);
    }
  };

  // this thread's two rows (r0 + g8, r0 + g8 + 8) and their bands; padded
  // rows (r >= R) see no key
  const int r0 = 16 * w;
  int rlo[2], rhi[2];
  bool rlive[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r0 + g8 + 8 * hf;
    rlive[hf] = r < R;
    rlo[hf] = rhi[hf] = 0;
    if (rlive[hf]) key_range<MODE>(p, t_first + r / h, rlo[hf], rhi[hf]);
  }

  float o[DT / 8][4];
#pragma unroll
  for (int i = 0; i < DT / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m2[2] = {M_FLOOR, M_FLOOR}, lsum[2] = {0.f, 0.f};
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
    const int k0 = kb0 + j * KC;
    bool sees = false, all = true;   // a live row sees a key of the tile; every one sees all
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      sees |= rlive[hf] && k0 + KC > rlo[hf] && k0 < rhi[hf];
      all &= !rlive[hf] || (k0 >= rlo[hf] && k0 + KC <= rhi[hf]);
    }
    if (__any_sync(FULL, sees)) {   // else no row of the warp sees a key: skip the tile
      const bool whole = __all_sync(FULL, all);
      const __nv_bfloat16* kb = k_s + buf * KC * P;
      const __nv_bfloat16* vb = v_s + buf * KC * P;
      float s[KC / 8][4];
#pragma unroll
      for (int i = 0; i < KC / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
      tc::mma_tile<KC / 8, DT / 16, false>(
          s, [&](int ks, uint32_t (&f)[4]) { tc::ldsm_x4(f, tc::a_addr(q_s, P, r0, 16 * ks)); },
          kb, P);
      // C element e of n-tile i: row r0 + g8 + 8 (e >> 1), key k0 + 8i + 2 t4
      // + (e & 1). The max runs over the raw logits (scale > 0); each p is
      // exp2(fma(s, scale * log2 e, -m)), the same instructions whether the
      // warp masks the tile or not, so a row gets the same bits either way.
      float mx[2] = {NEG, NEG};
      if (whole) {
#pragma unroll
        for (int i = 0; i < KC / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[i][e]);
      } else {
#pragma unroll
        for (int i = 0; i < KC / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hf = e >> 1, key = k0 + 8 * i + 2 * t4 + (e & 1);
            if (!(key >= rlo[hf] && key < rhi[hf])) s[i][e] = NEG;
            mx[hf] = fmaxf(mx[hf], s[i][e]);
          }
      }
      float alpha[2], neg_m[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {   // the row's four threads hold its 64 keys
        mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(FULL, mx[hf], 1));
        mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(FULL, mx[hf], 2));
        const float m_new = fmaxf(m2[hf], __fmul_rn(mx[hf], sl2));   // >= M_FLOOR: finite
        alpha[hf] = m_new == m2[hf] ? 1.f : fast_exp2(m2[hf] - m_new);   // exactly 1: no key
        m2[hf] = m_new;
        neg_m[hf] = -m_new;
        lsum[hf] *= alpha[hf];
      }
#pragma unroll
      for (int i = 0; i < KC / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // masked: exp2(-FLT_MAX * scale * log2 e - m) = 0
          const float pr = fast_exp2(fmaf(s[i][e], sl2, neg_m[e >> 1]));
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
  tc::cp_async_wait<0>();   // a tile with no key tile still staged Q
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float l = lsum[hf];
    l += __shfl_xor_sync(FULL, l, 1);
    l += __shfl_xor_sync(FULL, l, 2);
    const int r = r0 + g8 + 8 * hf;
    if (r >= R) continue;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    __nv_bfloat16* dst = O + grow(r) * Dv;
#pragma unroll
    for (int i = 0; i < DT / 8; ++i) {
      const int dim = 8 * i + 2 * t4;
      if (dim < Dv)
        *reinterpret_cast<uint32_t*>(dst + dim) =
            tc::pack_bf16(o[i][2 * hf] * inv, o[i][2 * hf + 1] * inv);
    }
    if (lse != nullptr && t4 == 0) lse[grow(r)] = l > 0.f ? (m2[hf] + log2f(l)) * LN2 : EMPTY_LSE;
  }
}

// At D = 64 both modes fit 128 registers, so two CTAs of 8 warps share an
// SM (the design note above)
template <int DT>
__global__ void __launch_bounds__(MAX_THREADS, DT == 64 ? 2 : 1)
win_fwd_mma_kernel(const __nv_bfloat16* __restrict__ Q, const __nv_bfloat16* __restrict__ K,
                   const __nv_bfloat16* __restrict__ V, __nv_bfloat16* __restrict__ O,
                   float* __restrict__ lse, Params p) {
  band_fwd<DT, WIN>(Q, K, V, O, lse, p);
}

template <int DT>
__global__ void __launch_bounds__(MAX_THREADS, DT == 64 ? 2 : 1)
cmp_fwd_mma_kernel(const __nv_bfloat16* __restrict__ Q, const __nv_bfloat16* __restrict__ K,
                   const __nv_bfloat16* __restrict__ V, __nv_bfloat16* __restrict__ O,
                   float* __restrict__ lse, Params p) {
  band_fwd<DT, CMP>(Q, K, V, O, lse, p);
}

using Kernel = void (*)(const __nv_bfloat16*, const __nv_bfloat16*, const __nv_bfloat16*,
                        __nv_bfloat16*, float*, Params);

template <int DT>
int launch(int mode, const void* Q, const void* K, const void* V, void* O, float* lse, int B,
           int rows, const Params& p, cudaStream_t stream) {
  const Kernel kern = mode == WIN ? &win_fwd_mma_kernel<DT> : &cmp_fwd_mma_kernel<DT>;
  const size_t smem = Layout<DT>::bytes(rows);
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long grid = (long long)B * p.G * p.nq;
  if (grid > 0)
    kern<<<(unsigned)grid, 2 * rows, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(Q), static_cast<const __nv_bfloat16*>(K),
        static_cast<const __nv_bfloat16*>(V), static_cast<__nv_bfloat16*>(O), lse, p);
  NSA_LAUNCH_CHECK();
}

}  // namespace

extern "C" {

long long nsa_banded_fwd_mma_smem_bytes(int Dk, int Dv, int rows) {
  return (long long)((Dk > 64 || Dv > 64) ? Layout<128>::bytes(rows) : Layout<64>::bytes(rows));
}

// bf16 only. Q [B,S,G,h,Dk], K [B,G,S_kv,Dk], V [B,G,S_kv,Dv] -> O
// [B,S,G,h,Dv], lse [B,S,G,h] f32 (or null). mode 0 WIN (w > 0), 1 CMP
// (l, d > 0); q tiles of `rows` = 64 or 128 rows (rows / h tokens, h <=
// rows); Dk, Dv <= 128 and multiples of 8.
int nsa_banded_fwd_mma(const void* Q, const void* K, const void* V, void* O, float* lse, int B,
                       int S, int S_kv, int G, int h, int Dk, int Dv, int mode, int w, int l,
                       int d, int t_start, float scale, int rows, void* stream) {
  if ((rows != 64 && rows != 128) || h <= 0 || h > rows || S_kv < 0 || t_start < 0 ||
      Dk % 8 != 0 || Dv % 8 != 0 || Dk > 128 || Dv > 128 || (mode != WIN && mode != CMP) ||
      (mode == WIN && w <= 0) || (mode == CMP && (l <= 0 || d <= 0)))
    return (int)cudaErrorInvalidValue;
  const int qT = rows / h;
  const int nq = (S + qT - 1) / qT;
  const Params p{S, S_kv, G, h, Dk, Dv, w, l, d, t_start, qT, nq, B * G, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dk > 64 || Dv > 64) return launch<128>(mode, Q, K, V, O, lse, B, rows, p, s);
  return launch<64>(mode, Q, K, V, O, lse, B, rows, p, s);
}

}  // extern "C"
