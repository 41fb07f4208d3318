"""A configuration small enough for the CPU, and cells built around it."""

from types import SimpleNamespace

import torch

from perfbench import harness

TINY = {"vocab_size": 256, "n_layers": 2, "dim": 64, "n_heads": 4, "n_kv_groups": 2,
        "d_k": 16, "d_v": 16, "l": 8, "d": 4, "l_sel": 16, "n_sel": 4, "w": 32,
        "phi": "avg", "gate_temp": 1.0, "rope_base": 10000.0, "rope_scale": 1.0,
        "force_init": True, "force_local": 2, "mlp_ratio": 4.0, "rmsnorm_eps": 1e-6,
        "dtype": "float32", "remat": False}
HP = {"lr": 3e-4, "warmup_steps": 1000, "steps": 50000, "max_grad_norm": 1.0,
      "weight_decay": 0.0}
TRAIN = {"driver": "train", "batch": 4, "seq": 128, "accum": 1, "start": "after_warmup",
         "zipf_exponent": 1.0, "check_steps": 3}
SERVE = {"driver": "serve", "slots": 4, "prompt_lengths": [64, 150, 300],
         "answers": {"a": 4, "b": 8, "c": 12}, "segment": 4, "capacity": 316,
         "pool_rounds": 8, "check_requests": 3, "order_seed": 21}
CPU = torch.device("cpu")


def cell(kind: str, limits: dict, dtype: str = "float32", **traffic) -> SimpleNamespace:
    """A tiny cell of the train or serve driver with these limits."""
    base = TRAIN if kind == "train" else SERVE
    settings = {"ref_rows": 2, "ref_chunk": 64, "limits": limits}
    return SimpleNamespace(workload=f"tiny.{kind}", chips=1, cfg=dict(TINY, dtype=dtype),
                           hp=dict(HP), traffic=dict(base, **traffic), cell=settings,
                           e2e=[], per_layer=[])


def run(res, seed: int = 2**31 + 7, seconds: float = 0.5) -> dict:
    """One run of the cell on the CPU, the card check skipped."""
    return harness.run(res, seed, seconds, False, CPU, 0.0)
