"""PyTorch/CUDA port of nsa_vibe_tpu for NVIDIA Hopper (H100).

The JAX package `nsa_vibe_tpu` is the reference; this package mirrors its
module names and parameter layout (nested dicts, weights `[in, out]`
applied as `x @ W`) so parameters move between the two without
transposes (`convert.params_from_numpy`).

Two paths are ported: serving (prefill with cache seeding and cached
greedy/sampled decode, `models.tinylm.generate`) and the single-device
train step and trainer (`train.train_step`, `python -m
nsa_vibe_tpu_torch.train.trainer`). Their TPU kernels, forward and
backward, have hand-written CUDA counterparts under `csrc/`, bound in
`ops/cuda/`.
A CUDA tensor always goes to a kernel; a CPU tensor goes to the kernel's
plain PyTorch version (which the tests compare with the JAX package).
"""

from nsa_vibe_tpu_torch.core.config import (
    M7C_125M, M7C_125M_TRAIN, ModelConfig, NSAConfig, TrainConfig,
)

__all__ = ["M7C_125M", "M7C_125M_TRAIN", "ModelConfig", "NSAConfig", "TrainConfig"]
