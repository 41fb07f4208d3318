"""Dispatch rule and argument checks shared by the kernel wrappers.

A wrapper takes the plain PyTorch version only for tensors on the CPU. A
CUDA tensor launches the kernel or raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools

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


def check_seq_start(name: str, seq_start, B: int, S: int, device) -> None:
    """seq_start is None, or an int32 [B, S] contiguous tensor on `device`.
    Its contract (l_sel-aligned, non-decreasing starts <= t) is not checked
    here: that would read it back on the host (ops/varlen.py)."""
    if seq_start is None:
        return
    if seq_start.dtype != torch.int32 or tuple(seq_start.shape) != (B, S) \
            or seq_start.device != device or not seq_start.is_contiguous():
        raise ValueError(f"{name}: seq_start ({seq_start.dtype}, {tuple(seq_start.shape)}, on "
                         f"{seq_start.device}) must be a contiguous int32 [B, S] = [{B}, {S}] "
                         f"tensor on {device}")


def check_gate(name: str, gate, B: int, S: int, G: int, device) -> None:
    """gate is None, or the gate-epilogue fold's f32 [B, S, G] contiguous
    tensor on `device` (one gate a (token, group), shared by its heads)."""
    if gate is None:
        return
    if gate.dtype != torch.float32 or tuple(gate.shape) != (B, S, G) \
            or gate.device != device or not gate.is_contiguous():
        raise ValueError(f"{name}: gate ({gate.dtype}, {tuple(gate.shape)}, on {gate.device}) "
                         f"must be a contiguous float32 [B, S, G] = [{B}, {S}, {G}] tensor on "
                         f"{device}")


def check_offset(name: str, t_start: int) -> None:
    """t_start (the position of query row 0 under sequence sharding) is a
    host int >= 0. With seq_start too (packed documents under sequence
    sharding) row s reads seq_start[b, s], a packed position."""
    if not isinstance(t_start, int) or t_start < 0:
        raise ValueError(f"{name}: the query offset must be a host int >= 0, got {t_start!r}")


def check_vector_rows(name: str, **tensors: torch.Tensor) -> None:
    """The kernels stage rows with 16-byte loads: the last dimension must be
    a multiple of 8 and every row 16-byte aligned."""
    for arg, t in tensors.items():
        if t.shape[-1] % 8 != 0 or t.data_ptr() % 16 != 0:
            raise ValueError(f"{name}: {arg} needs a last dimension that is a multiple of 8 "
                             f"and 16-byte aligned rows, got {tuple(t.shape)}")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def ptr_or_null(t) -> ctypes.c_void_p:
    """A tensor's address, or a null pointer for None (an output the kernel skips)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def raise_on_error(lib, name: str, err: int) -> None:
    if err != 0:
        msg = lib.nsa_error_string(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err} ({msg})")


@functools.lru_cache(maxsize=8)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of card `index` (a host query, no sync)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def kv_splits(device: torch.device, tiles: int, max_splits: int) -> int:
    """Splits of a kv-major backward pass's query range: enough that
    tiles * splits covers ~4 blocks per SM, at most max_splits (>= 1).
    Fixed by shape and card, so a launch's sums are always the same."""
    want = -(-4 * sm_count(device.index or 0) // max(tiles, 1))
    return max(1, min(want, max_splits))


def check_smem(name: str, nbytes: int) -> None:
    if nbytes > SMEM_LIMIT:
        raise ValueError(f"{name}: needs {nbytes} bytes of shared memory per block, "
                         f"more than the {SMEM_LIMIT} an H100 block can use")
