"""Model FLOP accounting and MFU of the TinyLM train step.

The port's own copy of nsa_vibe_tpu/utils/flops.py (train_step_flops,
attention_key_reads, mfu), with the H100's peak in place of the TPU's.

Conventions (stated so the number is auditable):
  * matmul fwd = 2·M·N·K; training = 3x fwd (dx + dw each cost one fwd).
  * attention fwd per query row per head = 2·T_k·(Dk + Dv) for the QK^T
    and P·V matmuls; training = 3x fwd (the one-pass backward recomputes
    P once and forms dV/dS/dK/dQ — ~2x fwd on top of fwd).
  * T_k is the EXACT per-position visible-key count per branch (summed
    in closed form over t), not S — NSA's point is that T_k << S:
      cmp: num_cmp(t+1) = floor((t+1-l)/d)+1 compressed keys
      sel: min(t+1, n_sel·l_sel) raw keys (the kernel reads exactly n·l')
      win: min(t+1, w) raw keys
  * the selection scorer's p_cmp pass (Eq.8) is one extra QK over the
    cmp keys (no PV): fwd 2·T_cmp·Dk per head, trained 3x.
  * ϕ-pooling, gate MLP, RMSNorm, softmax exps, rope are dropped
    (<1% of total; all bandwidth-bound, not tensor-core work).
  * remat's recomputed forward is not counted (model FLOPs, not hardware
    FLOPs).

Peak: the H100 SXM's dense bf16 tensor-core rate, 989 TFLOP/s (NVIDIA's
data sheet, without sparsity), the peak chip_smoke.py's bounds use.
"""

from __future__ import annotations

H100_BF16_PEAK_FLOPS = 989e12


def _sum_min(s: int, cap: int) -> int:
    """sum_{t=0}^{s-1} min(t+1, cap)  (closed form)."""
    if s <= cap:
        return s * (s + 1) // 2
    return cap * (cap + 1) // 2 + (s - cap) * cap


def _sum_num_cmp(s: int, l: int, d: int) -> int:
    """sum_{t=0}^{s-1} num_cmp(t+1), num_cmp(x) = (x-l)//d + 1 for x>=l."""
    total = 0
    # num_cmp increments every d positions starting at t+1 = l
    # closed form: for x in [l, s]: (x-l)//d + 1
    n = s - l + 1
    if n <= 0:
        return 0
    full, rem = divmod(n, d)
    # values 1..full each appear d times; value full+1 appears rem times
    total = d * full * (full + 1) // 2 + rem * (full + 1)
    return total


def attention_key_reads(seq: int, nsa) -> dict:
    """Exact per-sequence visible-key totals per branch (sum over rows)."""
    return {
        "cmp": _sum_num_cmp(seq, nsa.l, nsa.d),
        "sel": _sum_min(seq, nsa.n_sel * nsa.l_sel),
        "win": _sum_min(seq, nsa.w),
    }


def train_step_flops(mcfg, batch: int, seq: int) -> dict:
    """Total training FLOPs for one optimizer step of TinyLM.

    Returns a dict with the breakdown; "total" is the headline.
    """
    nsa = mcfg.nsa
    dim = nsa.dim
    H = nsa.n_heads
    G = nsa.n_kv_groups
    Dk, Dv = nsa.d_k, nsa.d_v
    hidden = int(dim * mcfg.mlp_ratio)
    L = mcfg.n_layers
    tok = batch * seq

    # --- dense projections, per layer, fwd FLOPs per token ---
    proj = 2 * dim * (H * Dk)            # Q
    proj += 2 * dim * (G * Dk) * 3       # K_sel, K_win, K_cmp
    proj += 2 * dim * (G * Dv) * 3       # V_sel, V_win, V_cmp
    proj += 2 * (H * Dv) * dim           # out
    mlp = 2 * dim * hidden * 2           # in + out matmuls
    dense_fwd = (proj + mlp) * tok * L
    head_fwd = 2 * dim * mcfg.vocab_size * tok  # lm head (embed lookup free)

    # --- attention, exact key-read sums per sequence ---
    reads = attention_key_reads(seq, nsa)
    att_keys = sum(reads.values()) * batch * L          # rows x keys
    att_fwd = att_keys * H * 2 * (Dk + Dv)
    scorer_fwd = reads["cmp"] * batch * L * H * 2 * Dk  # Eq.8 p_cmp QK
    # Eq.9 M-map matmul: [T_cmp x n_blocks] per (row, G)
    n_blocks = (seq + nsa.l_sel - 1) // nsa.l_sel
    mmap_fwd = reads["cmp"] * batch * L * G * 2 * n_blocks

    fwd = dense_fwd + head_fwd + att_fwd + scorer_fwd + mmap_fwd
    total = 3 * fwd   # training: dx + dw (or attention dQ/dK/dV) ~ 2x fwd
    return {
        "total": total,
        "fwd": fwd,
        "dense_fwd": dense_fwd + head_fwd,
        "attention_fwd": att_fwd + scorer_fwd + mmap_fwd,
        "per_token": total / tok,
    }


def mfu(flops_per_step: float, step_seconds: float,
        peak: float = H100_BF16_PEAK_FLOPS) -> dict:
    """Achieved TFLOP/s and MFU of a step of flops_per_step model FLOPs.
    Under a mesh (dp, sp, pp, tp) pass train_step_flops of the global
    batch: the model's FLOPs are counted once over the ranks (a tp member
    does 1/tp of each block's work, an sp member 1/sp of the rows), and
    the MFU is that of one card, peak, running the whole step."""
    achieved = flops_per_step / step_seconds
    return {
        "achieved_tflops": round(achieved / 1e12, 1),
        "mfu_pct": round(100.0 * achieved / peak, 1),
    }
