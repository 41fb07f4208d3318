"""Static block metadata and the Eq. 9 cmp->sel score mapping.

Own copy of nsa_vibe_tpu/ops/block_index.py (the port imports nothing of
the JAX package), plus `build_M_csl_on`, the Eq. 9 map built on a device. Semantics:
  * compression blocks are overlapped: starts = 0, d, 2d, ...,
    count = 0 if S < l else (S - l)//d + 1;
  * selection blocks are non-overlapped: starts = 0, l_sel, ...,
    count = ceil(S / l_sel);
  * M[i, j] = overlap(cmp_i, sel_j) / sum_j overlap(cmp_i, sel_j)
    (row-normalized fractional overlap; rows sum to 1).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class BlockMeta:
    """Shape-static NSA block geometry for a maximum sequence length."""

    seq_len: int
    l: int
    d: int
    l_sel: int
    n_sel: int
    w: int
    cmp_starts: np.ndarray   # [S_cmp] int32
    sel_starts: np.ndarray   # [S_sel] int32
    M_csl: np.ndarray        # [S_cmp, S_sel] float32 dense Eq. 9 mapping

    @property
    def S_cmp(self) -> int:
        return int(self.cmp_starts.shape[0])

    @property
    def S_sel(self) -> int:
        return int(self.sel_starts.shape[0])


def build_block_starts(seq_len: int, l: int, d: int, l_sel: int) -> tuple[np.ndarray, np.ndarray]:
    if l <= 0 or d <= 0 or l_sel <= 0:
        raise ValueError("block parameters must be positive")
    n_cmp = 0 if seq_len < l else (seq_len - l) // d + 1
    cmp_starts = (np.arange(n_cmp, dtype=np.int32) * d).astype(np.int32)
    n_sel = 0 if seq_len <= 0 else -(-seq_len // l_sel)
    sel_starts = (np.arange(n_sel, dtype=np.int32) * l_sel).astype(np.int32)
    return cmp_starts, sel_starts


def build_M_csl_on(seq_len: int, l: int, d: int, l_sel: int, device) -> torch.Tensor:
    """Dense Eq. 9 fractional-overlap matrix [S_cmp, S_sel] float32 on
    `device`, rows normalized to sum 1 (integer overlaps, exact sums, one
    division: bit-identical to the JAX package's numpy form). Building it
    where it is used avoids a host-to-device copy, which on a card would
    make the host wait for the kernels queued before it."""
    cmp_starts, sel_starts = build_block_starts(seq_len, l, d, l_sel)
    a0 = (torch.arange(cmp_starts.size, device=device) * d)[:, None]
    b0 = (torch.arange(sel_starts.size, device=device) * l_sel)[None, :]
    ov = (torch.minimum(a0 + l, b0 + l_sel) - torch.maximum(a0, b0)).clamp(min=0).float()
    row = ov.sum(dim=1, keepdim=True)
    return torch.where(row > 0, ov / row.clamp(min=1.0), torch.zeros((), device=device))


def build_M_csl(seq_len: int, l: int, d: int, l_sel: int) -> np.ndarray:
    """build_M_csl_on as a numpy array."""
    return build_M_csl_on(seq_len, l, d, l_sel, "cpu").numpy()


@functools.lru_cache(maxsize=64)
def build_block_meta(seq_len: int, l: int, d: int, l_sel: int, n_sel: int, w: int) -> BlockMeta:
    """Static metadata for sequences up to `seq_len` (cached: numpy only,
    a few KB per distinct shape)."""
    if l % d != 0 or l_sel % d != 0:
        raise ValueError("require d|l and d|l_sel")
    cmp_starts, sel_starts = build_block_starts(seq_len, l, d, l_sel)
    return BlockMeta(
        seq_len=seq_len, l=l, d=d, l_sel=l_sel, n_sel=n_sel, w=w,
        cmp_starts=cmp_starts, sel_starts=sel_starts,
        M_csl=build_M_csl(seq_len, l, d, l_sel),
    )


def num_cmp_blocks(s_raw, l: int, d: int):
    """Number of emitted compression blocks after s_raw raw tokens:
    0 if s_raw < l else (s_raw - l)//d + 1. Python ints or numpy arrays."""
    full = (s_raw - l) // d + 1
    if isinstance(s_raw, (int, np.integer)):
        return int(full) if s_raw >= l else 0
    return np.where(s_raw >= l, full, 0)


def expected_decode_reads(s_raw: int, l: int, d: int, l_sel: int, n_sel: int, w: int) -> int:
    """Per-step decode memory-reads formula: num_cmp(S) + n*l' + min(w, S)."""
    return num_cmp_blocks(s_raw, l, d) + n_sel * l_sel + min(w, s_raw)
