"""Model FLOPs of the TinyLM train step and of serving, unrounded.

The training count is a frozen copy of the port's
utils/flops.py::train_step_flops (PR 19): matmul forward 2·M·N·K,
training 3x forward, attention per query row and head 2·T_k·(Dk + Dv)
over the exact visible-key count T_k of each branch (cmp: num_cmp(t+1),
sel: min(t+1, n_sel·l_sel), win: min(t+1, w)), the scorer's p_cmp pass
one more QK over the cmp keys, the Eq. 9 map as a dense matmul; phi,
the gate MLP, norms, softmax and RoPE left out; recomputation not
counted. Serving counts the forward alone, each token at its own depth.
"""

from __future__ import annotations


def sum_min(s: int, cap: int) -> int:
    """sum over t < s of min(t+1, cap)."""
    if s <= cap:
        return s * (s + 1) // 2
    return cap * (cap + 1) // 2 + (s - cap) * cap


def num_cmp(x: int, l: int, d: int) -> int:
    """Compressed tokens emitted after x raw tokens."""
    return (x - l) // d + 1 if x >= l else 0


def sum_num_cmp(s: int, l: int, d: int) -> int:
    """sum over t < s of num_cmp(t+1)."""
    n = s - l + 1
    if n <= 0:
        return 0
    full, rem = divmod(n, d)
    return d * full * (full + 1) // 2 + rem * (full + 1)


def key_reads(seq: int, cfg: dict) -> dict:
    """Visible keys of each branch summed over the rows of one sequence."""
    return {"cmp": sum_num_cmp(seq, cfg["l"], cfg["d"]),
            "sel": sum_min(seq, cfg["n_sel"] * cfg["l_sel"]),
            "win": sum_min(seq, cfg["w"])}


def dense_per_token(cfg: dict) -> int:
    """Forward FLOPs of one token through the projections and MLPs of
    every layer and the LM head."""
    dim, H, G = cfg["dim"], cfg["n_heads"], cfg["n_kv_groups"]
    dk, dv = cfg["d_k"], cfg["d_v"]
    hidden = int(dim * cfg.get("mlp_ratio", 4.0))
    proj = 2 * dim * (H * dk) + 2 * dim * (G * dk) * 3 + 2 * dim * (G * dv) * 3 \
        + 2 * (H * dv) * dim
    mlp = 2 * dim * hidden * 2
    return (proj + mlp) * cfg["n_layers"] + 2 * dim * cfg["vocab_size"]


def attention_fwd(reads: dict, rows: int, seq: int, cfg: dict) -> int:
    """Forward attention FLOPs (branches, scorer, Eq. 9 map) of `rows`
    sequences with these key reads."""
    H, G, dk, dv, L = (cfg["n_heads"], cfg["n_kv_groups"], cfg["d_k"], cfg["d_v"],
                       cfg["n_layers"])
    att = sum(reads.values()) * rows * L * H * 2 * (dk + dv)
    scorer = reads["cmp"] * rows * L * H * 2 * dk
    n_blocks = -(-seq // cfg["l_sel"])
    mmap = reads["cmp"] * rows * L * G * 2 * n_blocks
    return att + scorer + mmap


def train_step_flops(cfg: dict, batch: int, seq: int) -> int:
    """Model FLOPs of one optimizer step over batch x seq tokens."""
    fwd = dense_per_token(cfg) * batch * seq + attention_fwd(key_reads(seq, cfg), batch, seq,
                                                             cfg)
    return 3 * fwd


def prefill_flops(cfg: dict, length: int) -> int:
    """Forward FLOPs of a prompt of `length` tokens, every position's
    logits included."""
    return dense_per_token(cfg) * length + attention_fwd(key_reads(length, cfg), 1, length,
                                                         cfg)


def decode_flops(cfg: dict, t: int) -> int:
    """Forward FLOPs of the token at position t (t tokens before it)."""
    H, G, dk, dv, L = (cfg["n_heads"], cfg["n_kv_groups"], cfg["d_k"], cfg["d_v"],
                       cfg["n_layers"])
    nc = num_cmp(t + 1, cfg["l"], cfg["d"])
    keys = nc + min(t + 1, cfg["n_sel"] * cfg["l_sel"]) + min(t + 1, cfg["w"])
    n_blocks = -(-(t + 1) // cfg["l_sel"])
    return (dense_per_token(cfg) + L * (H * 2 * (dk + dv) * keys + H * 2 * dk * nc
                                        + G * 2 * nc * n_blocks))
