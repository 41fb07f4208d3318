// banded_bwd_gated_mma: the one-pass bf16 banded backward on tensor cores
// under the gate-epilogue fold (nsa.gate_fold), for the window and the
// compressed prefix.
//
// Replaces, for bf16 operands: the gated form of nsa_vibe_tpu/ops/pallas/
// flash_bwd.py::flash_banded_bwd_onepass (gate_rows: the kernel scales
// each dO row by its gate and rounds it to dO's dtype, flash_bwd.py:394,
// :422-424, before any product).
//
// What it computes: banded_bwd_1p_mma_kernel's gradients (banded_bwd_mma.cu,
// whose design note holds for this body too) of the gated output Y = g O,
// given dY: the kernel stages dY rows as the ungated one stages dO, then
// scales each by its row's gate [B,S,G] f32 and rounds it to bf16 in
// shared memory (common.cuh::gate_rows), so its bits are those of the
// ungated launch on (dY * g).to(bf16); delta is rowsum(dY * Y). What bounds
// it: the ungated kernel's work plus one pass over each staged dO tile in
// shared memory. Its entries are compiled in this source, apart from
// banded_bwd_mma.cu, so that the two build in parallel; the ungated entries
// there compile as they did before the fold (csrc/ptxas_baseline.json).
#include "banded_bwd_mma.cuh"

namespace {

template <int DT, int MODE, bool DOCS, bool OFF>
__global__ void __launch_bounds__(128)
gated_banded_bwd_1p_mma_kernel(const __nv_bfloat16* __restrict__ Q,
                               const __nv_bfloat16* __restrict__ K,
                               const __nv_bfloat16* __restrict__ V,
                               const __nv_bfloat16* __restrict__ dO,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               const int* __restrict__ ds, const float* __restrict__ gate,
                               float* __restrict__ part_k, float* __restrict__ part_v,
                               float* __restrict__ ws, Params p) {
  kv_major<DT, MODE, DOCS, OFF, true>(Q, K, V, dO, lse, delta, ds, gate, part_k, part_v, ws, p);
}

template <int DT>
int launch_gated(const void* Q, const void* K, const void* V, const void* dO, const float* lse,
                 const float* delta, const int* ds, const float* gate, void* dQ, void* dK,
                 void* dV, float* part, float* ws, const Params& p, cudaStream_t stream) {
  const bool docs = ds != nullptr, off = p.t_start != 0;
  const auto kern =
      p.mode == WIN
          ? (docs ? (off ? &gated_banded_bwd_1p_mma_kernel<DT, WIN, true, true>
                         : &gated_banded_bwd_1p_mma_kernel<DT, WIN, true, false>)
                  : (off ? &gated_banded_bwd_1p_mma_kernel<DT, WIN, false, true>
                         : &gated_banded_bwd_1p_mma_kernel<DT, WIN, false, false>))
          : (docs ? (off ? &gated_banded_bwd_1p_mma_kernel<DT, CMP, true, true>
                         : &gated_banded_bwd_1p_mma_kernel<DT, CMP, true, false>)
                  : (off ? &gated_banded_bwd_1p_mma_kernel<DT, CMP, false, true>
                         : &gated_banded_bwd_1p_mma_kernel<DT, CMP, false, false>));
  const long long nkt = (p.S_kv + KC - 1) / KC;
  float* part_k = part;
  float* part_v = part + (size_t)p.nsplit * p.B * p.G * p.S_kv * p.Dk;
  const int e = launch_kernel(kern, (long long)p.B * p.G * nkt * p.nsplit, 128,
                              KvLayout<DT>::BYTES, stream, static_cast<const __nv_bfloat16*>(Q),
                              static_cast<const __nv_bfloat16*>(K),
                              static_cast<const __nv_bfloat16*>(V),
                              static_cast<const __nv_bfloat16*>(dO), lse, delta, ds, gate,
                              part_k, part_v, ws, p);
  if (e != 0) return e;
  return kv_finish<__nv_bfloat16>(part_k, part_v, ds, dQ, dK, dV, ws, p, stream);
}

}  // namespace

namespace nsa {
namespace band {

int launch_kv_gated(const void* Q, const void* K, const void* V, const void* dO,
                    const float* lse, const float* delta, const int* ds, const float* gate,
                    void* dQ, void* dK, void* dV, float* part, float* ws, const Params& p,
                    cudaStream_t stream) {
  if (wide(p.Dk, p.Dv))
    return launch_gated<128>(Q, K, V, dO, lse, delta, ds, gate, dQ, dK, dV, part, ws, p, stream);
  return launch_gated<64>(Q, K, V, dO, lse, delta, ds, gate, dQ, dK, dV, part, ws, p, stream);
}

}  // namespace band
}  // namespace nsa
