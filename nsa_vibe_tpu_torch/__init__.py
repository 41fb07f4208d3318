"""PyTorch/CUDA port of nsa_vibe_tpu for NVIDIA Hopper (H100).

The JAX package `nsa_vibe_tpu` is the reference; this package mirrors its
module names and parameter layout (nested dicts, weights `[in, out]`
applied as `x @ W`) so parameters move between the two without
transposes (`convert.params_from_numpy`).

This slice covers the serving path: prefill with cache seeding and cached
greedy/sampled decode (`models.tinylm.generate`). Its four TPU kernels
have hand-written CUDA counterparts under `csrc/`, bound in `ops/cuda/`.
A CUDA tensor always goes to a kernel; a CPU tensor goes to the kernel's
plain PyTorch version (which the tests compare with the JAX package).
"""

from nsa_vibe_tpu_torch.core.config import M7C_125M, ModelConfig, NSAConfig

__all__ = ["M7C_125M", "ModelConfig", "NSAConfig"]
