"""Dispatch rule and argument checks shared by the kernel wrappers.

A wrapper takes the plain PyTorch version only for tensors on the CPU. A
CUDA tensor launches the kernel or raises; there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

# dtype codes of the C interface (csrc/common.cuh, enum DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232448   # dynamic shared memory one H100 block may use (227 KB)


def resolve_kernel(x: torch.Tensor) -> str:
    """'plain' for a CPU tensor, 'cuda' for a CUDA tensor; raises otherwise."""
    if x.device.type == "cpu":
        return "plain"
    if x.device.type == "cuda":
        return "cuda"
    raise ValueError(f"no kernel or plain version for device {x.device}")


def check_operands(name: str, float_args: dict, int_args: dict = None) -> int:
    """Device, dtype and contiguity checks before a launch. Returns the
    dtype code of the float operands."""
    dev = None
    dtype = None
    for arg, t in {**float_args, **(int_args or {})}.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected a CUDA tensor")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, other operands on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    for arg, t in float_args.items():
        if dtype is None:
            dtype = t.dtype
        if t.dtype != dtype or t.dtype not in DTYPE_CODES:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}; the kernel takes float32 or "
                            f"bfloat16, the same for every float operand")
    for arg, t in (int_args or {}).items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {arg} must be int32, got {t.dtype}")
    return DTYPE_CODES[dtype]


def check_vector_rows(name: str, **tensors: torch.Tensor) -> None:
    """The kernels stage rows with 16-byte loads: the last dimension must be
    a multiple of 8 and every row 16-byte aligned."""
    for arg, t in tensors.items():
        if t.shape[-1] % 8 != 0 or t.data_ptr() % 16 != 0:
            raise ValueError(f"{name}: {arg} needs a last dimension that is a multiple of 8 "
                             f"and 16-byte aligned rows, got {tuple(t.shape)}")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def raise_on_error(lib, name: str, err: int) -> None:
    if err != 0:
        msg = lib.nsa_error_string(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err} ({msg})")


def check_smem(name: str, nbytes: int) -> None:
    if nbytes > SMEM_LIMIT:
        raise ValueError(f"{name}: needs {nbytes} bytes of shared memory per block, "
                         f"more than the {SMEM_LIMIT} an H100 block can use")
