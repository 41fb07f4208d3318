"""Design keys of the port (counterpart of nsa_vibe_tpu/ops/tuning.py).

Three keys, under the JAX package's names, choose the backward kernel of
each branch (`backward_kernel`, read by ops/attention.py at every
backward):

  bwd.onepass      1: the window and compressed branches run the one-pass
                   kernel (banded_bwd_1p); 0: the two-pass kernel
                   (banded_bwd).
  sel.bwd_onepass  1: the selection runs sel_attn_bwd_1p; 0: sel_attn_bwd;
                   None (the default): follows bwd.onepass (as
                   nsa_vibe_tpu/ops/attention.py:412-414).
  win.bwd_diag     1: on the one-pass route the window branch runs the
                   diagonal kernel (win_bwd_diag) when S >= DIAG_MIN_S
                   query rows (as flash_bwd.py:500-501); never the
                   compressed branch.

Two more, read by core/nsa.py's prefill (`tuned`), choose how the branch
outputs are combined, as nsa_vibe_tpu/ops/tuning.py:101-115 and
nsa_vibe_tpu/core/nsa.py:218-245 do:

  nsa.gate_fold    1: the gate-epilogue fold. The forward kernels emit the
                   gated branch output Y = g * O, the combine is a plain
                   sum and the gate logits' gradient comes from the delta
                   preprocess through the D-form softmax backward
                   (core/gate.py::gate_probs_dform). 0 (the default): the
                   gated combine of core/nsa.py::combine_branches.
  nsa.flat_io      accepted (0 or 1) so that a JAX setting carries over, and
                   has no effect: the TPU's flat-IO kernels write the
                   unpadded [B, S, H * Dv] layout, and the port's kernels
                   write contiguous [B, S, G, h, Dv], which has those bytes
                   under either value.

The backward defaults are the port's own, chosen by timing both designs of
each branch at the m7c-125M train shape on an H100 (chip_smoke.py phase
(f); PERF.md); the fold keys default to 0, as in the JAX package.
Overrides come from a JSON object in the file named by the environment
variable NSA_TORCH_TUNING (never NSA_KERNEL_TUNING, whose keys answer TPU
constraints), read once; a key not listed here, or a value other than 0 or
1 (or None for sel.bwd_onepass), raises. The port's kernels take their
tile sizes from their own modules, not from here.
"""

from __future__ import annotations

import functools
import json
import os

ENV_VAR = "NSA_TORCH_TUNING"
DEFAULTS = {"bwd.onepass": 1, "sel.bwd_onepass": None, "win.bwd_diag": 1,
            "nsa.gate_fold": 0, "nsa.flat_io": 0}
DIAG_MIN_S = 128   # the diagonal window backward engages from this many query rows


@functools.lru_cache(maxsize=1)
def _load() -> dict:
    """The keys in force: DEFAULTS, overridden by the JSON file named by
    NSA_TORCH_TUNING when it is set."""
    path = os.environ.get(ENV_VAR)
    if not path:
        return dict(DEFAULTS)
    with open(path) as f:
        data = json.load(f)
    unknown = sorted(set(data) - set(DEFAULTS))
    if unknown:
        raise ValueError(f"{ENV_VAR}={path}: unknown keys {unknown}; the port knows "
                         f"{sorted(DEFAULTS)}")
    for key, value in data.items():
        allowed = (0, 1, None) if key == "sel.bwd_onepass" else (0, 1)
        if value not in allowed:
            raise ValueError(f"{ENV_VAR}={path}: {key} must be one of {list(allowed)}, "
                             f"got {value!r}")
    return {**DEFAULTS, **data}


def tuned(key: str):
    """The value in force of `key`, one of DEFAULTS' keys."""
    return _load()[key]


def backward_kernel(branch: str, S: int, w: int = 0) -> str:
    """Name of the backward kernel the dispatch launches for `branch`
    ("win", "cmp" or "sel") at S query rows (w: the window)."""
    keys = _load()
    onepass = bool(keys["bwd.onepass"])
    if branch == "sel":
        sel = keys["sel.bwd_onepass"]
        return "sel_attn_bwd_1p" if (onepass if sel is None else bool(sel)) else "sel_attn_bwd"
    if branch not in ("win", "cmp"):
        raise ValueError(f"backward_kernel: branch must be 'win', 'cmp' or 'sel', got {branch!r}")
    if not onepass:
        return "banded_bwd"
    if branch == "win" and w > 0 and S >= DIAG_MIN_S and keys["win.bwd_diag"]:
        return "win_bwd_diag"
    return "banded_bwd_1p"
