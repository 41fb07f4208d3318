"""Typed configuration (port of nsa_vibe_tpu/core/config.py).

The fields keep the JAX package's names and defaults. Options that only
route between TPU paths (`kernel`, `prefill_chunk`) are absent: the port
dispatches by the device of the tensors (CUDA -> kernel, CPU -> plain
version). So is `varlen_exact`: the port's avg ϕ is always window-exact
(ops/compress.py), the form the JAX package computes under
`varlen_exact=True` (train/trainer.py::load_config accepts that key and
refuses `false`). `TrainConfig` is the JAX trainer's configuration, with
`varlen` packed-document batching (ops/varlen.py) and the parallel axes
dp, sp, pp, tp and fsdp (parallel/).
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
    # gradient checkpointing: False | True/"full" (recompute whole blocks in
    # the backward) | "mlp" (recompute only the MLP)
    remat: "bool | str" = False


@dataclass(frozen=True)
class TrainConfig:
    """Trainer configuration (JAX TrainConfig's defaults)."""

    lr: float = 3e-4
    warmup_steps: int = 50
    steps: int = 1000
    max_grad_norm: float = 1.0
    weight_decay: float = 0.0
    batch_size: int = 8
    seq_len: int = 128
    accum_steps: int = 1
    seed: int = 1337
    log_every: int = 20
    save_every: int = 0        # 0 = only final
    eval_every: int = 0
    out_dir: str = "artifacts/train"
    # per-step gate/selection stats (gate entropy, collapse fraction, k-stats)
    gate_stats: bool = True
    # packed-document batching (ops/varlen.py): batches carry (tokens,
    # seq_start, loss_mask); no attention crosses a document boundary
    varlen: bool = False
    # parallelism (parallel/): batch rows over dp ranks (0 = world // (pp
    # sp tp)), query positions over sp ranks, blocks over pp pipeline
    # stages (GPipe over pp_microbatches micro-batches, 0 = pp), KV groups
    # and the MLP hidden dim over tp ranks (tp must divide both), fsdp
    # shards parameters and moments over dp (leaves with an axis of at
    # least fsdp_min_size)
    dp: int = 0
    tp: int = 1
    sp: int = 1
    pp: int = 1
    pp_microbatches: int = 0
    fsdp: bool = False
    fsdp_min_size: int = 512


# configs/m7c_125m.yaml as code (the card machine has no PyYAML):
# M7C_125M is its model and nsa sections, M7C_125M_TRAIN its train
# section. tests/test_torch_ops.py and tests/test_torch_train.py hold both
# against the YAML.
M7C_125M = ModelConfig(
    vocab_size=256,
    n_layers=12,
    dtype="bfloat16",
    remat=True,
    nsa=NSAConfig(dim=768, n_heads=12, n_kv_groups=2, d_k=64, d_v=64,
                  l=32, d=16, l_sel=64, n_sel=16, w=512),
)
M7C_125M_TRAIN = TrainConfig(
    lr=3e-4, warmup_steps=1000, steps=50000, max_grad_norm=1.0, batch_size=8,
    seq_len=2048, log_every=50, save_every=5000, eval_every=1000,
)
