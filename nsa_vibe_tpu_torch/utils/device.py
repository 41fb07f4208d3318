"""Device resolution for the port's entry points.

Entry points default to `device="cuda"` and raise when no card is
present; the CPU is used only when the caller asks for it (as the tests
do). There is no silent move to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def torch_dtype(name: "str | torch.dtype") -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]

