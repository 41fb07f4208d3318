"""Parameters from the seed, the same for the system under test and for the
reference.

Every leaf is drawn from one generator on the device, in two large calls
(one normal blob for the embedding, one uniform blob for every matrix),
then scaled per leaf and cast to the type the configuration serves in.
The reference upcasts these same values to float32. The initialisation
follows the model's own: embedding N(0, 0.02), every matrix U(-lim, lim)
with lim = 1/sqrt(fan_in), the gate's first layer Xavier-uniform and its
last 0.1 x Xavier, biases 0, norm weights 1.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from perfbench.reference.tinylm import param_names

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def seed_of(seed: int, *stream: int) -> int:
    """A generator seed for one stream of a run's randomness."""
    h = seed % (1 << 62)
    for s in stream:
        h = (h * 1000003 + s + 1) % (1 << 62)
    return h


def shapes(cfg: dict) -> List[Tuple[str, tuple, str, float]]:
    """(name, shape, kind, scale) of every leaf: kind is normal, uniform,
    ones or zeros."""
    dim, H, G = cfg["dim"], cfg["n_heads"], cfg["n_kv_groups"]
    dk, dv, V = cfg["d_k"], cfg["d_v"], cfg["vocab_size"]
    hid = int(dim * cfg.get("mlp_ratio", 4.0))
    gh = cfg.get("gate_hidden") or max(1, dk // 2)
    table = {
        "attn_norm": ((dim,), "ones", 1.0),
        "attn.W_Q": ((dim, H * dk), "uniform", dim ** -0.5),
        "attn.W_K_sel": ((dim, G * dk), "uniform", dim ** -0.5),
        "attn.W_V_sel": ((dim, G * dv), "uniform", dim ** -0.5),
        "attn.W_K_win": ((dim, G * dk), "uniform", dim ** -0.5),
        "attn.W_V_win": ((dim, G * dv), "uniform", dim ** -0.5),
        "attn.W_K_cmp": ((dim, G * dk), "uniform", dim ** -0.5),
        "attn.W_V_cmp": ((dim, G * dv), "uniform", dim ** -0.5),
        "attn.W_O": ((H * dv, dim), "uniform", (H * dv) ** -0.5),
        "attn.gate.w1": ((dk, gh), "uniform", math.sqrt(6.0 / (dk + gh))),
        "attn.gate.b1": ((gh,), "zeros", 0.0),
        "attn.gate.w2": ((gh, 3), "uniform", 0.1 * math.sqrt(6.0 / (gh + 3))),
        "attn.gate.b2": ((3,), "zeros", 0.0),
        "mlp_norm": ((dim,), "ones", 1.0),
        "mlp.w_in": ((dim, hid), "uniform", dim ** -0.5),
        "mlp.w_out": ((hid, dim), "uniform", hid ** -0.5),
    }
    out = []
    for name in param_names(cfg):
        if name == "embed":
            out.append((name, (V, dim), "normal", 0.02))
        elif name == "final_norm":
            out.append((name, (dim,), "ones", 1.0))
        elif name == "lm_head":
            out.append((name, (dim, V), "uniform", dim ** -0.5))
        else:
            shape, kind, scale = table[name.split(".", 2)[2]]
            out.append((name, shape, kind, scale))
    return out


@torch.no_grad()
def make(cfg: dict, seed: int, device, dtype=None) -> Dict[str, torch.Tensor]:
    """name -> leaf, in `dtype` (default the configuration's) on `device`."""
    dt = DTYPES[dtype or cfg["dtype"]]
    leaves = shapes(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_of(seed, 0))
    n_norm = sum(math.prod(s) for _, s, k, _ in leaves if k == "normal")
    n_unif = sum(math.prod(s) for _, s, k, _ in leaves if k == "uniform")
    normal = torch.empty(n_norm, device=device).normal_(generator=gen)
    unif = torch.empty(n_unif, device=device).uniform_(-1.0, 1.0, generator=gen)
    out, o_n, o_u = {}, 0, 0
    for name, shape, kind, scale in leaves:
        n = math.prod(shape)
        if kind == "normal":
            out[name] = (normal[o_n:o_n + n] * scale).to(dt).view(shape)
            o_n += n
        elif kind == "uniform":
            out[name] = (unif[o_u:o_u + n] * scale).to(dt).view(shape)
            o_u += n
        elif kind == "ones":
            out[name] = torch.ones(shape, dtype=dt, device=device)
        else:
            out[name] = torch.zeros(shape, dtype=dt, device=device)
    return out


def nested(flat: Dict[str, torch.Tensor]) -> dict:
    """name -> leaf as nested dicts, blocks as a list."""
    root: dict = {}
    for name, t in flat.items():
        parts = name.split(".")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t
    root["blocks"] = [root["blocks"][str(i)] for i in range(len(root["blocks"]))]
    return root


def flat(tree, prefix: str = "", skip=("W_qkv",)) -> Dict[str, torch.Tensor]:
    """The inverse of `nested`, leaving out the keys in `skip`."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if k in skip:
            continue
        name = f"{prefix}{k}"
        if isinstance(v, (dict, list, tuple)):
            out.update(flat(v, name + ".", skip))
        else:
            out[name] = v
    return out
