"""Typed configuration (port of nsa_vibe_tpu/core/config.py).

The fields keep the JAX package's names and defaults. Options that only
route between TPU paths (`kernel`, `prefill_chunk`, `varlen_exact`,
`remat`) are absent: the port dispatches by the device of the tensors
(CUDA -> kernel, CPU -> plain version), and varlen and training come in
later slices.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class NSAConfig:
    """Core NSA attention hyperparameters (paper §3)."""

    dim: int = 256
    n_heads: int = 8
    n_kv_groups: int = 2
    d_k: int = 64
    d_v: int = 64

    l: int = 32        # compression block length
    d: int = 16        # compression stride
    l_sel: int = 64    # selection block length
    n_sel: int = 16    # number of selected blocks
    w: int = 512       # sliding window length

    phi: str = "avg"           # "avg" | "conv" (learnable depthwise conv, init=avg)
    gate_hidden: Optional[int] = None  # default d_k // 2
    gate_temp: float = 1.0
    rope_base: float = 10000.0
    rope_scale: float = 1.0

    force_init: bool = True    # always select block 0
    force_local: int = 2       # always select the last 2 blocks

    force_branch: Optional[str] = None    # "cmp" | "sel" | "win" gate override
    force_uniform_gate: bool = False

    def __post_init__(self) -> None:
        if self.n_heads % self.n_kv_groups != 0:
            raise ValueError("n_heads must be divisible by n_kv_groups")
        if self.l % self.d != 0 or self.l_sel % self.d != 0:
            raise ValueError("require d|l and d|l_sel")
        if self.d_k % 2 != 0:
            raise ValueError("RoPE requires even d_k")

    @property
    def h_per_group(self) -> int:
        return self.n_heads // self.n_kv_groups


@dataclass(frozen=True)
class ModelConfig:
    """TinyLM / LlamaBlockNSA model configuration."""

    vocab_size: int = 256      # byte-LM
    n_layers: int = 2
    nsa: NSAConfig = dataclasses.field(default_factory=NSAConfig)
    mlp_ratio: float = 4.0
    rmsnorm_eps: float = 1e-6
    dtype: str = "float32"     # activation and parameter dtype


# configs/m7c_125m.yaml as code (the model and nsa sections; the train
# section belongs to a later slice). tests/test_torch_ops.py holds it
# against the YAML.
M7C_125M = ModelConfig(
    vocab_size=256,
    n_layers=12,
    dtype="bfloat16",
    nsa=NSAConfig(dim=768, n_heads=12, n_kv_groups=2, d_k=64, d_v=64,
                  l=32, d=16, l_sel=64, n_sel=16, w=512),
)
