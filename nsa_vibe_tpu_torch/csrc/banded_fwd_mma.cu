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
//   WIN: keys [max(t-w+1, 0, ds), min(t+1, S_kv))
//   CMP: compressed tokens [ceil(ds/d), min(num_cmp(t+1), S_kv))
// with ds the row's document start (packed documents, ds [B,S] given; row
// s reads ds[b, s], a packed position, also at t_start > 0) or 0; the tile band takes ds at the tile's first token, each
// row masks its own.
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
//     branches apart; the warp count is the launch's block size. So is
//     DOCS (ds given): the dense instantiation reads no ds. The
//     gate-epilogue fold (nsa.gate_fold; flash.py:274, flash_diag.py:125)
//     has entries of its own over the same body, gated_win_fwd_mma_kernel
//     and gated_cmp_fwd_mma_kernel: O = (acc / l) * g in f32, g the row's
//     gate [B,S,G] f32, then the cast; the ungated entries compile as
//     before (csrc/ptxas_baseline.json). The
//     per-CTA walk (band_fwd) is in banded_fwd_mma.cuh: the fused scorer
//     (select_cmp_mma.cu) runs it in CMP mode as its pass 1.
// wgmma with TMA suits a contiguous band better still: later work.
#include "banded_fwd_mma.cuh"

using namespace nsa;
using namespace nsa::band;

namespace {

// At D = 64 both modes fit 128 registers, so two CTAs of 8 warps share an
// SM (the design note above)
template <int DT, bool DOCS>
__global__ void __launch_bounds__(MAX_THREADS, DT == 64 ? 2 : 1)
win_fwd_mma_kernel(const __nv_bfloat16* __restrict__ Q, const __nv_bfloat16* __restrict__ K,
                   const __nv_bfloat16* __restrict__ V, const int* __restrict__ ds,
                   __nv_bfloat16* __restrict__ O, float* __restrict__ lse, Params p) {
  band_fwd<DT, WIN, DOCS>(Q, K, V, ds, O, lse, p);
}

template <int DT, bool DOCS>
__global__ void __launch_bounds__(MAX_THREADS, DT == 64 ? 2 : 1)
cmp_fwd_mma_kernel(const __nv_bfloat16* __restrict__ Q, const __nv_bfloat16* __restrict__ K,
                   const __nv_bfloat16* __restrict__ V, const int* __restrict__ ds,
                   __nv_bfloat16* __restrict__ O, float* __restrict__ lse, Params p) {
  band_fwd<DT, CMP, DOCS>(Q, K, V, ds, O, lse, p);
}

// the gate-epilogue fold's entries: O = (acc / l) * gate[b, s, g]
template <int DT, bool DOCS>
__global__ void __launch_bounds__(MAX_THREADS, DT == 64 ? 2 : 1)
gated_win_fwd_mma_kernel(const __nv_bfloat16* __restrict__ Q, const __nv_bfloat16* __restrict__ K,
                         const __nv_bfloat16* __restrict__ V, const int* __restrict__ ds,
                         const float* __restrict__ gate, __nv_bfloat16* __restrict__ O,
                         float* __restrict__ lse, Params p) {
  band_fwd<DT, WIN, DOCS, true>(Q, K, V, ds, O, lse, p, nullptr, gate);
}

template <int DT, bool DOCS>
__global__ void __launch_bounds__(MAX_THREADS, DT == 64 ? 2 : 1)
gated_cmp_fwd_mma_kernel(const __nv_bfloat16* __restrict__ Q, const __nv_bfloat16* __restrict__ K,
                         const __nv_bfloat16* __restrict__ V, const int* __restrict__ ds,
                         const float* __restrict__ gate, __nv_bfloat16* __restrict__ O,
                         float* __restrict__ lse, Params p) {
  band_fwd<DT, CMP, DOCS, true>(Q, K, V, ds, O, lse, p, nullptr, gate);
}

template <int DT>
int launch(int mode, const void* Q, const void* K, const void* V, const int* ds,
           const float* gate, void* O, float* lse, int B, int rows, const Params& p,
           cudaStream_t stream) {
  const bool docs = ds != nullptr;
  const size_t smem = Layout<DT>::bytes(rows);
  const long long grid = (long long)B * p.G * p.nq;
  const auto* q = static_cast<const __nv_bfloat16*>(Q);
  const auto* k = static_cast<const __nv_bfloat16*>(K);
  const auto* v = static_cast<const __nv_bfloat16*>(V);
  auto* o = static_cast<__nv_bfloat16*>(O);
  if (gate != nullptr) {
    const auto kern = mode == WIN ? (docs ? &gated_win_fwd_mma_kernel<DT, true>
                                          : &gated_win_fwd_mma_kernel<DT, false>)
                                  : (docs ? &gated_cmp_fwd_mma_kernel<DT, true>
                                          : &gated_cmp_fwd_mma_kernel<DT, false>);
    return launch_kernel(kern, grid, 2 * rows, smem, stream, q, k, v, ds, gate, o, lse, p);
  }
  const auto kern = mode == WIN ? (docs ? &win_fwd_mma_kernel<DT, true>
                                        : &win_fwd_mma_kernel<DT, false>)
                                : (docs ? &cmp_fwd_mma_kernel<DT, true>
                                        : &cmp_fwd_mma_kernel<DT, false>);
  return launch_kernel(kern, grid, 2 * rows, smem, stream, q, k, v, ds, o, lse, p);
}

}  // namespace

extern "C" {

long long nsa_banded_fwd_mma_smem_bytes(int Dk, int Dv, int rows) {
  return (long long)((Dk > 64 || Dv > 64) ? Layout<128>::bytes(rows) : Layout<64>::bytes(rows));
}

// bf16 only. Q [B,S,G,h,Dk], K [B,G,S_kv,Dk], V [B,G,S_kv,Dv], ds [B,S]
// int32 document starts (or null), gate [B,S,G] f32 (or null: ungated) ->
// O [B,S,G,h,Dv] (times the row's gate), lse [B,S,G,h] f32 (or null). mode
// 0 WIN (w > 0), 1 CMP (l, d > 0); q tiles of `rows` = 64 or 128 rows (rows
// / h tokens, h <= rows); Dk, Dv <= 128 and multiples of 8.
int nsa_banded_fwd_mma(const void* Q, const void* K, const void* V, const int* ds,
                       const float* gate, void* O, float* lse, int B, int S, int S_kv, int G,
                       int h, int Dk, int Dv,
                       int mode, int w, int l, int d, int t_start, float scale, int rows,
                       void* stream) {
  if ((rows != 64 && rows != 128) || h <= 0 || h > rows || S_kv < 0 || t_start < 0 ||
      Dk % 8 != 0 || Dv % 8 != 0 || Dk > 128 || Dv > 128 || (mode != WIN && mode != CMP) ||
      (mode == WIN && w <= 0) || (mode == CMP && (l <= 0 || d <= 0)))
    return (int)cudaErrorInvalidValue;
  const int qT = rows / h;
  const int nq = (S + qT - 1) / qT;
  const Params p{S, S_kv, G, h, Dk, Dv, w, l, d, t_start, qT, nq, B * G, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dk > 64 || Dv > 64) return launch<128>(mode, Q, K, V, ds, gate, O, lse, B, rows, p, s);
  return launch<64>(mode, Q, K, V, ds, gate, O, lse, B, rows, p, s);
}

}  // extern "C"
