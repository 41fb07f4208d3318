"""Rules of the PyTorch port that the code must keep.

* No module of nsa_vibe_tpu_torch/, and not chip_smoke.py, imports JAX or
  the JAX package (the card machine has no JAX; the port keeps its own
  copies of what it needs).
* Entry points default to the card and raise when none is present,
  unless the caller asks for device="cpu".
"""

import ast
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from nsa_vibe_tpu_torch.convert import params_from_numpy
from nsa_vibe_tpu_torch.core.cache import init_cache
from nsa_vibe_tpu_torch.core.config import ModelConfig, NSAConfig
from nsa_vibe_tpu_torch.core.nsa import init_nsa_params
from nsa_vibe_tpu_torch.models.tinylm import init_model_params

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(r"^(jax|jaxlib|nsa_vibe_tpu)(\.|$)")
SMALL = ModelConfig(vocab_size=16, n_layers=1,
                    nsa=NSAConfig(dim=32, n_heads=2, n_kv_groups=1, d_k=16, d_v=16,
                                  l=8, d=4, l_sel=8, n_sel=3, w=8))


def _port_files():
    return sorted((ROOT / "nsa_vibe_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
            assert node.level == 0, f"{path}:{node.lineno}: relative import"
        else:
            continue
        for name in names:
            assert not FORBIDDEN.match(name), f"{path}:{node.lineno} imports {name}"


def test_forbidden_pattern_spares_the_port_package():
    assert FORBIDDEN.match("nsa_vibe_tpu.core") and FORBIDDEN.match("jax.numpy")
    assert not FORBIDDEN.match("nsa_vibe_tpu_torch.core")


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator().manual_seed(0)
    tree = {"w": np.zeros((2, 2), np.float32)}
    for call in (lambda: init_model_params(SMALL, gen),
                 lambda: init_nsa_params(SMALL.nsa, gen),
                 lambda: init_cache(SMALL.nsa, 1, 16),
                 lambda: params_from_numpy(tree)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # the CPU, when asked for, works
    p = init_model_params(SMALL, gen, device="cpu")
    assert p["embed"].device.type == "cpu"
    assert params_from_numpy(tree, device="cpu")["w"].device.type == "cpu"
    assert init_cache(SMALL.nsa, 1, 16, device="cpu").k_sel.device.type == "cpu"
