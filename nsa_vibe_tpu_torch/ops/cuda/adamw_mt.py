"""Multi-tensor AdamW (csrc/adamw_mt.cu): the train step's global norm and
clipped AdamW update over every trainable leaf in three launches a step
(for leaves of one dtype).

Replaces no TPU kernel (the JAX package leaves optax's chain to XLA's
fusion). train/optim.py runs it for every leaf list on the card, and keeps
its tensor-op path for CPU tensors; that path is also the reference the
card tests hold these kernels to, bit for bit. Bound on the H100 and
design: see the notes at the top of the CUDA source.

A launch's leaves travel in the kernel's parameters: `plan` splits a list of
leaf sizes into launches of at most MAX_LEAVES leaves and gives each launch
its CTAs, each over one contiguous range of the launch's concatenated
elements (tests/test_torch_adamw_mt.py walks them as the kernel does).
`Plan` holds the launches of an optimizer state's leaves, one group a dtype
(`by_dtype`), with the host arrays of the parameters', mu's and nu's
pointers; train/optim.py builds it at the first step and keeps it in the
state beside mu and nu, which the update writes in place. Only the
gradients' pointers are read each step. The kernels take contiguous bf16
and f32 leaves on one card; a Plan raises on any other, and a
non-contiguous gradient is copied before the kernels read it. Counts
launches in `norm_and_good.launches` (the partial norms and the finalize)
and `update_.launches`.
"""

from __future__ import annotations

import ctypes
import operator
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import torch

from nsa_vibe_tpu_torch.ops.cuda.build import library
from nsa_vibe_tpu_torch.ops.cuda.common import (
    DTYPE_CODES, ptr, raise_on_error, sm_count, stream_of,
)

THREADS = 256        # threads a CTA of the norm and update kernels (csrc/adamw_mt.cu)
CTAS_PER_SM = 4      # at most this many CTAs an SM in one launch
MAX_LEAVES = 768     # leaves a launch's parameters hold with CUDA >= 12.1 (the library says)


@dataclass(frozen=True)
class Launch:
    """One launch: `leaves` (indices into the planned list, none empty),
    their first elements `start` in the launch's concatenation (one more
    entry: the total), `ctas` CTAs of `per_cta` elements each (the last may
    hold fewer), and the first of its `ctas` partial-norm slots."""
    leaves: Tuple[int, ...]
    start: Tuple[int, ...]
    per_cta: int
    ctas: int
    slot: int


def plan(sizes: Sequence[int], vec: int, max_ctas: int,
         max_leaves: int = MAX_LEAVES, slot: int = 0) -> List[Launch]:
    """Launches covering every element of the leaves of `sizes` once: the
    non-empty leaves in order, max_leaves a launch, each launch's elements
    split into at most max_ctas equal ranges of at least THREADS * vec
    elements (vec: elements in 16 bytes); partial-norm slots from `slot` on."""
    keep = [i for i, n in enumerate(sizes) if n > 0]
    out = []
    for k in range(0, len(keep), max_leaves):
        leaves = tuple(keep[k:k + max_leaves])
        start = [0]
        for i in leaves:
            start.append(start[-1] + sizes[i])
        total = start[-1]
        ctas = max(1, min(max_ctas, -(-total // (THREADS * vec))))
        per_cta = -(-total // ctas)
        ctas = -(-total // per_cta)
        out.append(Launch(leaves, tuple(start), per_cta, ctas, slot))
        slot += ctas
    return out


def by_dtype(dtypes: Sequence[torch.dtype]) -> Dict[torch.dtype, List[int]]:
    """The leaf indices of each dtype, dtypes in order of first appearance:
    one launch group each."""
    out: Dict[torch.dtype, List[int]] = {}
    for i, dt in enumerate(dtypes):
        out.setdefault(dt, []).append(i)
    return out


def _pointers(ts: Sequence[torch.Tensor], leaves: Sequence[int]):
    return (ctypes.c_void_p * len(leaves))(*(ts[i].data_ptr() for i in leaves))


class _Group:
    """The launches of one dtype's leaves (`index`: their places in the
    state's list), with each launch's start array and its parameters', mu's
    and nu's pointer arrays."""

    def __init__(self, lib, dtype, index, params, mu, nu, max_ctas: int, slot: int):
        self.code = DTYPE_CODES[dtype]
        self.launches = plan([params[i].numel() for i in index], 16 // dtype.itemsize,
                             max_ctas, lib.nsa_adamw_mt_max_leaves(), slot)
        self.leaves = [[index[j] for j in x.leaves] for x in self.launches]
        self.start = [(ctypes.c_longlong * len(x.start))(*x.start) for x in self.launches]
        self.ptrs = [[_pointers(ts, leaves) for ts in (params, mu, nu)] for leaves in self.leaves]
        self.slots = sum(x.ctas for x in self.launches)


class Plan:
    """The kernels' launches over an optimizer state's leaves (params and
    their moments mu, nu, updated in place), built once. Raises ValueError
    where the kernels do not take the leaves: not all CUDA tensors on one
    card, a dtype other than bf16 and f32, a moment of another shape or
    dtype than its parameter, a non-contiguous parameter or moment."""

    def __init__(self, params: Sequence[torch.Tensor], mu: Sequence[torch.Tensor],
                 nu: Sequence[torch.Tensor]):
        if not params or not len(params) == len(mu) == len(nu):
            raise ValueError(f"adamw_mt: {len(params)} parameters, {len(mu)} and {len(nu)} "
                             f"moments")
        self.device = params[0].device
        for i, (p, m, v) in enumerate(zip(params, mu, nu)):
            for t in (p, m, v):
                if t.device != self.device or t.dtype not in DTYPE_CODES \
                        or not t.is_contiguous():
                    raise ValueError(f"adamw_mt: leaf {i} is a {t.dtype} tensor of strides "
                                     f"{t.stride()} on {t.device}; the kernels take "
                                     f"contiguous bf16 and f32 leaves on one card, all on "
                                     f"{self.device}")
            if (m.shape, m.dtype) != (p.shape, p.dtype) or (v.shape, v.dtype) != (p.shape,
                                                                                  p.dtype):
                raise ValueError(f"adamw_mt: leaf {i}'s moments differ from it in shape or "
                                 f"dtype")
        if self.device.type != "cuda":
            raise ValueError(f"adamw_mt: the leaves are on {self.device}, not a card")
        lib = library()
        max_ctas = CTAS_PER_SM * sm_count(self.device.index or 0)
        self.params, self.mu, self.nu = list(params), list(mu), list(nu)
        self.dtypes = [p.dtype for p in params]
        self.sizes = [p.numel() for p in params]
        self.groups, slot = [], 0
        for dt, index in by_dtype(self.dtypes).items():
            self.groups.append(_Group(lib, dt, index, params, mu, nu, max_ctas, slot))
            slot += self.groups[-1].slots
        self.slots = slot
        self.launches = sum(len(g.launches) for g in self.groups)   # a pass over every leaf

    def holds(self, params, mu, nu) -> bool:
        """Whether these are the tensors the plan was built for."""
        return all(len(a) == len(b) and all(map(operator.is_, a, b))
                   for a, b in ((params, self.params), (mu, self.mu), (nu, self.nu)))

    def grads(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The gradients as the kernels read them: each of its leaf's dtype
        and size on the card, a non-contiguous one copied. Raises ValueError
        otherwise."""
        if len(grads) != len(self.sizes):
            raise ValueError(f"adamw_mt: {len(grads)} gradients for {len(self.sizes)} leaves")
        dev = self.device.index
        out = []
        for i, (g, dt, n) in enumerate(zip(grads, self.dtypes, self.sizes)):
            if g.dtype != dt or g.numel() != n or not g.is_cuda or g.get_device() != dev:
                raise ValueError(f"adamw_mt: gradient {i} is a {g.dtype} tensor of "
                                 f"{g.numel()} elements on {g.device}; its leaf is {dt}, "
                                 f"{n} elements on {self.device}")
            out.append(g if g.is_contiguous() else g.contiguous())
        return out


def _scalar(t: torch.Tensor, dtype: torch.dtype, name: str, device: torch.device) -> None:
    if t.dtype != dtype or t.numel() != 1 or t.device != device:
        raise ValueError(f"adamw_mt: {name} is a {t.dtype} tensor of {t.numel()} elements on "
                         f"{t.device}, not a {dtype} scalar on {device}")


def norm_and_good(pl: Plan, grads: Sequence[torch.Tensor], loss: torch.Tensor,
                  inv_accum: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(grad_norm, good) of the gradients of pl's leaves: the f32 norm of
    every g * inv_accum (rounded to g's dtype, as the tensor op rounds it)
    and isfinite(loss) & isfinite(grad_norm), as f32 and bool device
    scalars. loss is an f32 scalar on the leaves' card."""
    _scalar(loss, torch.float32, "loss", pl.device)
    grads = pl.grads(grads)
    lib = library()
    stream = stream_of(loss)
    partials = torch.empty(max(pl.slots, 1), dtype=torch.float32, device=pl.device)
    for grp in pl.groups:
        for x, leaves, start in zip(grp.launches, grp.leaves, grp.start):
            raise_on_error(lib, "adamw_mt norm", lib.nsa_adamw_mt_norm(
                grp.code, start, _pointers(grads, leaves), len(leaves), x.per_cta, x.ctas,
                inv_accum, ctypes.c_void_p(partials.data_ptr() + 4 * x.slot), stream))
    grad_norm = torch.empty((), dtype=torch.float32, device=pl.device)
    good = torch.empty((), dtype=torch.bool, device=pl.device)
    raise_on_error(lib, "adamw_mt finalize", lib.nsa_adamw_mt_finalize(
        ptr(partials), pl.slots, ptr(loss), ptr(grad_norm), ptr(good), stream))
    norm_and_good.launches += pl.launches + 1
    return grad_norm, good


norm_and_good.launches = 0


def update_(pl: Plan, grads: Sequence[torch.Tensor], lr: torch.Tensor, bc1: torch.Tensor,
            bc2: torch.Tensor, grad_norm: torch.Tensor, good: torch.Tensor,
            hyper: Tuple[float, ...]) -> None:
    """The clipped AdamW step of train/optim.py::apply_update_plain_ in place
    on pl's parameters and moments, applied only where good; the count is
    the caller's. lr (the schedule at the count before its increment), bc1,
    bc2 (1 - b^(count + 1)) and grad_norm are f32 device scalars, good a
    bool one; hyper the Python scalars (inv_accum, max_grad_norm, 1 - b1,
    b1, 1 - b2, b2, eps, weight_decay), which the kernels take as f32, as
    PyTorch casts them."""
    for t, name in ((lr, "lr"), (bc1, "bc1"), (bc2, "bc2"), (grad_norm, "grad_norm")):
        _scalar(t, torch.float32, name, pl.device)
    _scalar(good, torch.bool, "good", pl.device)
    grads = pl.grads(grads)
    lib = library()
    stream = stream_of(good)
    for grp in pl.groups:
        for x, leaves, start, (p, mu, nu) in zip(grp.launches, grp.leaves, grp.start, grp.ptrs):
            raise_on_error(lib, "adamw_mt update", lib.nsa_adamw_mt_update(
                grp.code, start, p, _pointers(grads, leaves), mu, nu, len(leaves), x.per_cta,
                x.ctas, ptr(grad_norm), ptr(good), ptr(lr), ptr(bc1), ptr(bc2), *hyper, stream))
    update_.launches += pl.launches


update_.launches = 0
