"""Hand-written Hopper kernels of the serving, training and long-context
paths, their wrappers and plain PyTorch versions.

| wrapper         | CUDA source             | replaces (nsa_vibe_tpu/ops/pallas/)                 |
|-----------------|-------------------------|-----------------------------------------------------|
| select_cmp      | csrc/select_cmp_mma.cu, | scorer.py::nsa_select_and_cmp_pallas                |
|                 | csrc/select_cmp.cu      |                                                     |
| sel_attn        | csrc/sel_attn.cu,       | sel_flash.py::selection_flash_pallas (prefill),     |
|                 | csrc/sel_attn_fwd_mma.cu| selection.py::selection_attention_pallas (decode)   |
| win_attn        | csrc/banded_fwd_mma.cu, | flash_diag.py::flash_banded_diag                    |
|                 | csrc/banded_attn.cu     |                                                     |
| banded_bwd_1p   | csrc/banded_bwd_mma.cu, | flash_bwd.py::flash_banded_bwd_onepass (win, cmp)   |
|                 | csrc/banded_bwd_1p.cu   |                                                     |
| banded_bwd      | csrc/banded_bwd_mma.cu, | flash_bwd.py::flash_banded_bwd (win, cmp; 2 passes) |
|                 | csrc/banded_bwd.cu      |                                                     |
| sel_attn_bwd_1p | csrc/sel_attn_bwd_1p.cu | sel_flash.py::selection_flash_bwd_onepass           |
| sel_attn_bwd    | csrc/sel_attn_bwd.cu    | sel_flash.py::selection_flash_bwd (2 passes)        |
| win_bwd_diag    | csrc/banded_bwd_mma.cu, | flash_diag.py::flash_banded_bwd_diag                |
|                 | csrc/win_bwd_diag.cu    |                                                     |
| banded_attn     | csrc/banded_fwd_mma.cu, | flash.py::flash_banded (win and cmp, t_start)       |
|                 | csrc/banded_attn.cu     |                                                     |
| select_blocks   | csrc/select_blocks_mma.cu | scorer.py::nsa_select_pallas (pos_offset)         |
|                 | csrc/select_blocks.cu   |                                                     |

adamw_mt (csrc/adamw_mt.cu) is the train step's optimizer, in three
launches a step over every leaf; it replaces no TPU kernel and counts its
launches apart (`norm_and_good.launches`, `update_.launches`), outside
WRAPPERS; reset_launch_counts zeroes them too.

win_attn and banded_attn launch the same two kernels (window mode at
t_start = 0 for win_attn): bf16 the tensor-core banded_fwd_mma.cu, f32
the FMA banded_attn.cu. The other wrappers with two sources take the
tensor-core one (`*_mma.cu`) for bf16 and the FMA one for f32 (sel_attn
at decode: sel_attn.cu in both); banded_bwd's dK/dV pass is
banded_bwd_1p's kernel with its dQ slots off. The backward design each
branch runs follows ops/tuning.py. Each wrapper counts its launches in a
plain integer attribute (`<wrapper>.launches`), incremented only where
the kernel is launched; the wrappers that take the gate-epilogue fold's
gate (nsa.gate_fold) also count their gated launches
(`<wrapper>.gated_launches`). A replay of a captured CUDA graph calls no
wrapper, so these counts do not see it: a replay's launches are read from
a profiler trace.
"""

from __future__ import annotations

from nsa_vibe_tpu_torch.ops.cuda import adamw_mt as _adamw_mt_mod
from nsa_vibe_tpu_torch.ops.cuda import banded_attn as _banded_attn_mod
from nsa_vibe_tpu_torch.ops.cuda import banded_bwd as _banded_bwd_mod
from nsa_vibe_tpu_torch.ops.cuda import banded_bwd_1p as _banded_bwd_1p_mod
from nsa_vibe_tpu_torch.ops.cuda import sel_attn as _sel_attn_mod
from nsa_vibe_tpu_torch.ops.cuda import sel_attn_bwd as _sel_attn_bwd_mod
from nsa_vibe_tpu_torch.ops.cuda import sel_attn_bwd_1p as _sel_attn_bwd_1p_mod
from nsa_vibe_tpu_torch.ops.cuda import select_blocks as _select_blocks_mod
from nsa_vibe_tpu_torch.ops.cuda import select_cmp as _select_cmp_mod
from nsa_vibe_tpu_torch.ops.cuda import win_attn as _win_attn_mod
from nsa_vibe_tpu_torch.ops.cuda import win_bwd_diag as _win_bwd_diag_mod

WRAPPERS = (_select_cmp_mod.select_cmp, _sel_attn_mod.sel_attn, _win_attn_mod.win_attn,
            _banded_bwd_mod.banded_bwd, _sel_attn_bwd_mod.sel_attn_bwd,
            _banded_attn_mod.banded_attn, _select_blocks_mod.select_blocks,
            _banded_bwd_1p_mod.banded_bwd_1p, _sel_attn_bwd_1p_mod.sel_attn_bwd_1p,
            _win_bwd_diag_mod.win_bwd_diag)


# the wrappers that take the gate-epilogue fold's gate (`gated_launches`)
GATED_WRAPPERS = (_select_cmp_mod.select_cmp, _sel_attn_mod.sel_attn, _win_attn_mod.win_attn,
                  _banded_attn_mod.banded_attn, _banded_bwd_1p_mod.banded_bwd_1p,
                  _sel_attn_bwd_1p_mod.sel_attn_bwd_1p)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
    for fn in GATED_WRAPPERS:
        fn.gated_launches = 0
    _sel_attn_mod.sel_attn.decode_launches = 0
    _banded_bwd_mod.banded_bwd.cmp_launches = 0
    _banded_bwd_1p_mod.banded_bwd_1p.cmp_launches = 0
    _adamw_mt_mod.norm_and_good.launches = 0
    _adamw_mt_mod.update_.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in WRAPPERS}


def gated_launch_counts() -> dict:
    """The launches under the gate-epilogue fold, by wrapper."""
    return {fn.__name__: fn.gated_launches for fn in GATED_WRAPPERS}
