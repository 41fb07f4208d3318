"""Hand-written Hopper kernels of the serving path, their wrappers and
plain PyTorch versions.

| wrapper      | CUDA source          | replaces (nsa_vibe_tpu/ops/pallas/)                  |
|--------------|----------------------|------------------------------------------------------|
| select_cmp   | csrc/select_cmp.cu   | scorer.py::nsa_select_and_cmp_pallas                 |
| sel_attn     | csrc/sel_attn.cu     | sel_flash.py::selection_flash_pallas (prefill),      |
|              |                      | selection.py::selection_attention_pallas (decode)    |
| win_attn     | csrc/win_attn.cu     | flash_diag.py::flash_banded_diag                     |

Each wrapper counts its launches in a plain integer attribute
(`<wrapper>.launches`), incremented only where the kernel is launched.
"""

from __future__ import annotations

from nsa_vibe_tpu_torch.ops.cuda import sel_attn as _sel_attn_mod
from nsa_vibe_tpu_torch.ops.cuda import select_cmp as _select_cmp_mod
from nsa_vibe_tpu_torch.ops.cuda import win_attn as _win_attn_mod

WRAPPERS = (_select_cmp_mod.select_cmp, _sel_attn_mod.sel_attn, _win_attn_mod.win_attn)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
    _sel_attn_mod.sel_attn.decode_launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in WRAPPERS}
