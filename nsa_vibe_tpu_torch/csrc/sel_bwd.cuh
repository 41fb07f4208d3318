// The kv-major pass of the selection backward, shared by both designs:
// sel_attn_bwd_1p.cu defines it (with the dQ slots of the one-pass design,
// row 9), sel_attn_bwd.cu calls it without slots after its query-major dQ
// pass (the two-pass design, row 10).
//
// Work list (ops/cuda/sel_attn_bwd.py::selection_work_items, built on the
// device): each (b, g, selection block)'s member rows (the inverse index
// inv/cnt, ascending) are cut into items of `per` tokens (a fixed number of
// chunks of TQ tokens). Item slots are numbered block by block (block
// (b, g, j) owns slots span[blk][0] .. + span[blk][1]); `work` lists one
// (slot, block, item number) per CTA, largest items first, so block 0,
// which every row selects, spreads over many CTAs and they start first.
// Unused entries have block -1. Each CTA writes its f32 dK/dV partial to
// its slot; `sel_bwd_reduce_kernel` adds a key's partials in slot order
// (one writer per element, no float atomics).
#pragma once

#include <cuda_runtime.h>

namespace nsa {
namespace sel {

struct KvParams {
  int B, S, S_kv, G, h, Dk, Dv, l_sel, inv_pitch, n_work, TQ, per;
  float scale;
};

struct KvArgs {
  const void *Q, *K, *V, *dO;
  const float *lse, *delta;
  const int *tpos, *inv, *cnt, *rank, *work, *span, *nblk;
  void *dQ, *dK, *dV;
  float *part;   // 2 * n_work * nsub * 64 * (Dk or Dv) f32: the items' dK/dV partials
  float *ws;     // the one-pass dQ slots, or nullptr (no dQ from this pass)
};

// query rows (tokens x heads) per chunk of the kv-major kernel for a dtype
// and head widths; TQ = rows / h
int kv_rows(int dtype, int Dk, int Dv);
long long kv_smem_bytes(int dtype, int Dk, int Dv);
// launches the kv-major kernel and the reductions (dK, dV; with ws also
// dQ by sum_slots); returns a cudaError_t. gate [B,S,G] f32 (the one-pass
// design under the gate-epilogue fold, or null): each dO row is scaled by
// its gate and rounded to the operands' dtype before any product.
int launch_kv(int dtype, const KvArgs& a, const KvParams& p, cudaStream_t stream,
              const float* gate = nullptr);

}  // namespace sel
}  // namespace nsa
