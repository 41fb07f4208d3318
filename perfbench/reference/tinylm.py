"""The plain reference: TinyLM over Native Sparse Attention, in float32.

A byte-level language model of n pre-norm blocks (RMSNorm, NSA attention,
RMSNorm, SiLU MLP, residuals), a final RMSNorm and an untied LM head,
written from the NSA paper (arXiv 2502.11089, section 3) in plain PyTorch:

  * projections x @ W (weights [in, out]): Q for every head, and K/V of
    each branch (compressed, selected, window) for every KV group;
  * RoPE, split-half pairs, inv_freq = base^(-2i/D), positions / scale, on
    Q, K_sel, K_win, and on the compressed branch's raw K before pooling;
  * phi: the mean of each window of l tokens at stride d (S_cmp = (S-l)//d
    + 1); query t sees the first (t+1-l)//d + 1 compressed tokens;
  * selection scores (Eq. 8-10): the compressed branch's softmax p_cmp,
    mapped onto selection blocks of l_sel tokens by the fractional overlap
    of each compressed window with each block, summed over the heads of a
    group; block 0 and the last two blocks up to t are always taken, then
    the n_sel - 3 best other blocks that start at or before t (score minus
    1e-8 x index, the lower index first on ties); the branch attends to
    the keys of those blocks at positions <= t;
  * the sliding window: keys t-w+1 .. t;
  * the gate: softmax over (cmp, sel, win) of a two-layer SiLU MLP of the
    group's mean RoPE'd query; out = sum of gated branches @ W_O.

Every number is float32; TF32 is switched off by `float32_matmuls`. The
`Rounding` passed in rounds what a model computed in a lower type would
hold in it: every matmul operand, the residual stream after each add and
the logits. "float32" leaves them; "fp8" casts them to float8 e4m3 (at
most 448 in magnitude), as the configuration's bfloat16 is a cast: the
precision below it, which the benchmark's control computes in.
Gradients pass straight through the rounding. Nothing here reads
anything made by the system under test, and nothing here imports it.

Memory: attention runs in chunks of query rows; in training, a
block's intermediates are dropped after its forward and recomputed in the
backward, so one block's intermediates of one block of rows are live at a
time.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

FP8_MAX = 448.0
Params = Dict[str, torch.Tensor]


def float32_matmuls() -> None:
    """float32 products in float32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Rounding:
    """Rounding of what the model holds: "float32" (none) or "fp8" (e4m3)."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "fp8"):
            raise ValueError(f"unknown rounding {name!r}")
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "float32":
            return x
        v = x.detach()
        q = v.clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).to(torch.float32)
        return x + (q - v)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self(a) @ self(b)


def layer_names(cfg: dict, i: int) -> List[str]:
    p = f"blocks.{i}."
    return [p + k for k in ("attn_norm", "attn.W_Q", "attn.W_K_sel", "attn.W_V_sel",
                            "attn.W_K_win", "attn.W_V_win", "attn.W_K_cmp", "attn.W_V_cmp",
                            "attn.W_O", "attn.gate.w1", "attn.gate.b1", "attn.gate.w2",
                            "attn.gate.b2", "mlp_norm", "mlp.w_in", "mlp.w_out")]


def param_names(cfg: dict) -> List[str]:
    names = ["embed"]
    for i in range(cfg["n_layers"]):
        names += layer_names(cfg, i)
    return names + ["final_norm", "lm_head"]


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, pos: torch.Tensor, base: float, scale: float) -> torch.Tensor:
    """x [..., S, D] at positions pos [S]."""
    D = x.shape[-1]
    half = D // 2
    inv = base ** (-2.0 * torch.arange(half, dtype=torch.float32, device=x.device) / D)
    ang = (pos.float() / (scale if scale > 0 else 1.0))[:, None] * inv
    sin, cos = torch.sin(ang), torch.cos(ang)
    x0, x1 = x[..., :half], x[..., half:]
    return torch.cat((x0 * cos - x1 * sin, x0 * sin + x1 * cos), dim=-1)


def n_cmp_visible(t: torch.Tensor, l: int, d: int) -> torch.Tensor:
    """Compressed tokens visible to the query at position t."""
    s = t + 1
    return torch.where(s >= l, torch.div(s - l, d, rounding_mode="floor") + 1,
                       torch.zeros_like(s))


def overlap_map(S: int, l: int, d: int, l_sel: int, device) -> torch.Tensor:
    """[S_cmp, S_sel]: overlap of compressed window i with selection block j,
    over the window's length."""
    S_cmp = 0 if S < l else (S - l) // d + 1
    S_sel = -(-S // l_sel)
    a = (torch.arange(S_cmp, device=device) * d)[:, None]
    b = (torch.arange(S_sel, device=device) * l_sel)[None, :]
    ov = (torch.minimum(a + l, b + l_sel) - torch.maximum(a, b)).clamp(min=0).float()
    return ov / ov.sum(1, keepdim=True).clamp(min=1.0)


def select_blocks(p_grp: torch.Tensor, t: torch.Tensor, cfg: dict) -> torch.Tensor:
    """p_grp [B, c, G, S_sel] at positions t [c] -> the chosen blocks as a
    mask [B, c, G, S_sel]."""
    B, c, G, S_sel = p_grp.shape
    l_sel = cfg["l_sel"]
    blk = torch.arange(S_sel, device=p_grp.device)
    last = torch.div(t, l_sel, rounding_mode="floor")
    forced = []
    if cfg.get("force_init", True):
        forced.append(torch.zeros_like(t))
    for k in range(cfg.get("force_local", 2)):
        forced.append((last - k).clamp(min=0))
    taken = torch.zeros((c, S_sel), dtype=torch.bool, device=p_grp.device)
    for f in forced:
        taken[torch.arange(c, device=t.device), f] = True
    valid = (blk[None, :] * l_sel) <= t[:, None]
    score = torch.where((valid & ~taken)[None, :, None, :], p_grp,
                        torch.full((), float("-inf"), device=p_grp.device))
    score = score - blk.float() * 1e-8
    k_rest = max(0, cfg["n_sel"] - len(forced))
    # one spare column takes the picks that found no block
    chosen = torch.zeros((B, c, G, S_sel + 1), dtype=torch.bool, device=p_grp.device)
    chosen[..., :S_sel] = taken[None, :, None, :]
    if k_rest > 0:
        top = torch.topk(score, min(k_rest, S_sel), dim=-1)
        chosen.scatter_(-1, torch.where(torch.isfinite(top.values), top.indices,
                                        torch.full_like(top.indices, S_sel)), True)
    return chosen[..., :S_sel]


def attention(p: Params, pre: str, h: torch.Tensor, cfg: dict, rnd: Rounding,
              chunk: int, dense: bool) -> torch.Tensor:
    """NSA attention of h [B, S, dim] -> [B, S, dim]. The selected branch
    attends to all keys under a mask (`dense`, whose gradient is a few
    matmuls) or to the gathered keys of its blocks (cheaper forward at
    long S); the two compute the same function."""
    B, S, _ = h.shape
    H, G, dk, dv = cfg["n_heads"], cfg["n_kv_groups"], cfg["d_k"], cfg["d_v"]
    hg = H // G
    l, d, l_sel, w = cfg["l"], cfg["d"], cfg["l_sel"], cfg["w"]
    base, rscale = cfg.get("rope_base", 10000.0), cfg.get("rope_scale", 1.0)
    scale = 1.0 / math.sqrt(dk)
    dev = h.device
    pos = torch.arange(S, device=dev)

    def kv(name, dd):
        return rnd.mm(h, p[pre + name]).view(B, S, G, dd).transpose(1, 2)   # [B, G, S, dd]

    Q = rope(rnd.mm(h, p[pre + "W_Q"]).view(B, S, H, dk).transpose(1, 2), pos, base, rscale)
    Q = Q.transpose(1, 2).reshape(B, S, G, hg, dk)
    K_sel, V_sel = rope(kv("W_K_sel", dk), pos, base, rscale), kv("W_V_sel", dv)
    K_win, V_win = rope(kv("W_K_win", dk), pos, base, rscale), kv("W_V_win", dv)
    K_raw, V_raw = rope(kv("W_K_cmp", dk), pos, base, rscale), kv("W_V_cmp", dv)
    S_cmp = 0 if S < l else (S - l) // d + 1
    S_sel = -(-S // l_sel)
    if S_cmp:
        idx = (torch.arange(S_cmp, device=dev) * d)[:, None] + torch.arange(l, device=dev)
        K_cmp, V_cmp = K_raw[:, :, idx].mean(3), V_raw[:, :, idx].mean(3)
        M = overlap_map(S, l, d, l_sel, dev)

    qp = Q.mean(3)                                                       # [B, S, G, dk]
    z = rnd.mm(F.silu(rnd.mm(qp, p[pre + "gate.w1"]) + p[pre + "gate.b1"]),
               p[pre + "gate.w2"]) + p[pre + "gate.b2"]
    gates = torch.softmax(z / max(cfg.get("gate_temp", 1.0), 1e-6), dim=-1)
    bi = torch.arange(B, device=dev)[:, None, None, None]
    gi = torch.arange(G, device=dev)[None, None, :, None]
    outs = []
    for a in range(0, S, chunk):
        b = min(S, a + chunk)
        t = pos[a:b]
        q = rnd(Q[:, a:b])
        # compressed branch, and the selection scores from its softmax
        nc = n_cmp_visible(t, l, d)
        ncm = int(nc[-1]) if S_cmp else 0
        if ncm:
            s_c = torch.einsum("bsghd,bgcd->bsghc", q, rnd(K_cmp[:, :, :ncm])) * scale
            vis = torch.arange(ncm, device=dev)[None, :] < nc[:, None]          # [c, ncm]
            s_c = s_c.masked_fill(~vis[None, :, None, None, :], float("-inf"))
            p_c = torch.softmax(s_c, -1)
            p_c = torch.where((nc > 0)[None, :, None, None, None], p_c,
                              torch.zeros((), device=dev))
            O_cmp = torch.einsum("bsghc,bgcv->bsghv", rnd(p_c), rnd(V_cmp[:, :, :ncm]))
            p_grp = (p_c.detach() @ M[:ncm]).sum(3)                          # [B, c, G, S_sel]
        else:
            O_cmp = torch.zeros((B, b - a, G, hg, dv), device=dev)
            p_grp = torch.zeros((B, b - a, G, S_sel), device=dev)
        # selected blocks
        chosen = select_blocks(p_grp, t, cfg)                                # [B, c, G, S_sel]
        if dense:
            kp = torch.arange(b, device=dev)
            ok = chosen.repeat_interleave(l_sel, -1)[..., :b] & (kp <= t[:, None])[None, :, None]
            s_s = torch.einsum("bsghd,bgkd->bsghk", q, rnd(K_sel[:, :, :b])) * scale
            s_s = s_s.masked_fill(~ok[:, :, :, None, :], float("-inf"))
            O_sel = torch.einsum("bsghk,bgkv->bsghv", rnd(torch.softmax(s_s, -1)),
                                 rnd(V_sel[:, :, :b]))
        else:
            width = max(cfg["n_sel"], 1 + cfg.get("force_local", 2))
            blk = torch.arange(S_sel, device=dev)
            ids = torch.where(chosen, blk, torch.full_like(blk, S_sel)).sort(-1).values
            ids = ids[..., :width]                                           # [B, c, G, W]
            keys = (ids[..., None] * l_sel + torch.arange(l_sel, device=dev)).flatten(-2)
            ok = (ids[..., None] < S_sel).expand(*ids.shape, l_sel).flatten(-2) & \
                (keys <= t[None, :, None, None])
            keys = keys.clamp(max=S - 1)
            Kg, Vg = K_sel[bi, gi, keys], V_sel[bi, gi, keys]                # [B, c, G, N, D]
            s_s = torch.einsum("bsghd,bsgnd->bsghn", q, rnd(Kg)) * scale
            s_s = s_s.masked_fill(~ok[:, :, :, None, :], float("-inf"))
            O_sel = torch.einsum("bsghn,bsgnv->bsghv", rnd(torch.softmax(s_s, -1)), rnd(Vg))
        # sliding window
        lo = max(0, a - w + 1)
        kp = torch.arange(lo, b, device=dev)
        band = (kp[None, :] <= t[:, None]) & (kp[None, :] > t[:, None] - w)
        s_w = torch.einsum("bsghd,bgkd->bsghk", q, rnd(K_win[:, :, lo:b])) * scale
        s_w = s_w.masked_fill(~band[None, :, None, None, :], float("-inf"))
        O_win = torch.einsum("bsghk,bgkv->bsghv", rnd(torch.softmax(s_w, -1)),
                             rnd(V_win[:, :, lo:b]))
        g = gates[:, a:b, :, :, None, None]                                 # [B, c, G, 3, 1, 1]
        O = g[:, :, :, 0] * O_cmp + g[:, :, :, 1] * O_sel + g[:, :, :, 2] * O_win
        outs.append(O.reshape(B, b - a, H * dv))
    return rnd.mm(torch.cat(outs, 1), p[pre + "W_O"])


def block(p: Params, i: int, x: torch.Tensor, cfg: dict, rnd: Rounding,
          chunk: int, dense: bool) -> torch.Tensor:
    pre = f"blocks.{i}."
    eps = cfg.get("rmsnorm_eps", 1e-6)
    x = rnd(x + attention(p, pre + "attn.", rmsnorm(x, p[pre + "attn_norm"], eps), cfg, rnd,
                          chunk, dense))
    m = rmsnorm(x, p[pre + "mlp_norm"], eps)
    return rnd(x + rnd.mm(F.silu(rnd.mm(m, p[pre + "mlp.w_in"])), p[pre + "mlp.w_out"]))


class _Recompute(torch.autograd.Function):
    """fn(x, *weights), its intermediates recomputed in the backward."""

    @staticmethod
    def forward(ctx, fn, x, *ws):
        ctx.fn = fn
        ctx.save_for_backward(x, *ws)
        with torch.no_grad():
            return fn(x, *ws)

    @staticmethod
    def backward(ctx, gy):
        x, *ws = ctx.saved_tensors
        xs = [x.detach().requires_grad_(True)] + [w.detach().requires_grad_(True) for w in ws]
        with torch.enable_grad():
            y = ctx.fn(*xs)
        grads = torch.autograd.grad(y, xs, gy, allow_unused=True)
        return (None, *grads)


def hidden(p: Params, tokens: torch.Tensor, cfg: dict, rnd: Rounding, chunk: int,
           training: bool) -> torch.Tensor:
    """The last block's output [B, S, dim] for tokens [B, S]. Training
    recomputes each block in the backward and takes the dense selected
    branch; otherwise the gathered one."""
    x = rnd(p["embed"][tokens])
    for i in range(cfg["n_layers"]):
        names = layer_names(cfg, i)
        if training:
            def fn(x_, *ws, i=i, names=names):
                return block(dict(zip(names, ws)), i, x_, cfg, rnd, chunk, True)
            x = _Recompute.apply(fn, x, *[p[n] for n in names])
        else:
            x = block(p, i, x, cfg, rnd, chunk, False)
    return x


def logits_at(p: Params, x: torch.Tensor, cfg: dict, rnd: Rounding) -> torch.Tensor:
    return rnd(rnd.mm(rmsnorm(x, p["final_norm"], cfg.get("rmsnorm_eps", 1e-6)), p["lm_head"]))


def loss_and_grads(p: Params, tokens: torch.Tensor, cfg: dict, rnd: Rounding,
                   rows: int = 1, chunk: int = 1024) -> tuple:
    """Mean next-token cross entropy of tokens [B, S+1] and its gradient
    (name -> tensor), in blocks of `rows` rows, each block's blocks
    recomputed in the backward."""
    B, S1 = tokens.shape
    n = B * (S1 - 1)
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    grads = {k: torch.zeros_like(v) for k, v in p.items()}
    total = torch.zeros((), device=tokens.device)
    for r in range(0, B, rows):
        tok = tokens[r:r + rows]
        with torch.enable_grad():
            x = hidden(leaves, tok[:, :-1], cfg, rnd, chunk, training=True)
            lg = logits_at(leaves, x, cfg, rnd)
            nll = F.cross_entropy(lg.reshape(-1, lg.shape[-1]), tok[:, 1:].reshape(-1),
                                  reduction="sum")
            gs = torch.autograd.grad(nll / n, list(leaves.values()), allow_unused=True)
        for k, g in zip(leaves, gs):
            if g is not None:
                grads[k] += g
        total += nll.detach()
    return total / n, grads


@torch.no_grad()
def served_logits(p: Params, tokens: torch.Tensor, positions: Sequence[int], cfg: dict,
                  rnd: Rounding, chunk: int = 1024) -> torch.Tensor:
    """Logits [len(positions), vocab] at the given positions of one
    sequence tokens [1, T]: a full forward pass, no cache."""
    x = hidden(p, tokens, cfg, rnd, chunk, training=False)
    idx = torch.as_tensor(list(positions), device=tokens.device)
    return logits_at(p, x[0, idx], cfg, rnd)


# ---------------------------------------------------------------- optimizer

B1, B2, EPS = 0.9, 0.999, 1e-8


def lr_at(count: int, hp: dict) -> float:
    """Linear warm-up from 0 to lr over warmup_steps, then a cosine to
    0.1 lr at max(steps, warmup_steps + 1)."""
    peak, warm = hp["lr"], hp["warmup_steps"]
    if count < warm:
        return peak * count / warm
    decay = float(max(hp["steps"], warm + 1) - warm)
    c = min(count - warm, decay)
    return peak * (0.9 * 0.5 * (1 + math.cos(math.pi * c / decay)) + 0.1)


def adamw_step(p: Params, g: Params, state: dict, hp: dict,
               storage: torch.dtype = torch.float32) -> None:
    """One step in place: clip to max_grad_norm by the global norm, Adam
    with bias correction at the incremented count, decoupled weight
    decay, the rate at the count before the increment; the new parameters
    are then held in `storage`, the parameter type the configuration
    states (moments stay float32)."""
    norm = math.sqrt(sum(float(v.double().square().sum()) for v in g.values()))
    clip = 1.0 if norm < hp["max_grad_norm"] else hp["max_grad_norm"] / norm
    count = state["count"]
    lr = lr_at(count, hp)
    c1, c2 = 1 - B1 ** (count + 1), 1 - B2 ** (count + 1)
    for k in p:
        gk = g[k] * clip
        mu = state["mu"][k].mul_(B1).add_(gk, alpha=1 - B1)
        nu = state["nu"][k].mul_(B2).addcmul_(gk, gk, value=1 - B2)
        u = (mu / c1) / ((nu / c2).sqrt() + EPS) + hp.get("weight_decay", 0.0) * p[k]
        p[k] -= lr * u
        p[k] = p[k].to(storage).float()
    state["count"] = count + 1


def adamw_state(p: Params, count: int) -> dict:
    return {"mu": {k: torch.zeros_like(v) for k, v in p.items()},
            "nu": {k: torch.zeros_like(v) for k, v in p.items()}, "count": count}


def train_steps(p0: Params, batches: Sequence[torch.Tensor], cfg: dict, hp: dict,
                count: int, rnd: Optional[Rounding] = None, rows: int = 1,
                chunk: int = 1024, batch_rows: Optional[slice] = None,
                storage: torch.dtype = torch.float32) -> dict:
    """Runs len(batches) steps from parameters p0 (copied to float32):
    each step's loss, the first step's clipped gradient (what Adam
    receives), and the parameters after the last step. A batch is tokens
    [B, S+1], or [accum, B, S+1]: micro-batches whose gradients and losses
    are averaged. `batch_rows` trains on those rows of each (micro-)batch
    alone (a planted fault); parameters are held in `storage` between
    steps."""
    rnd = rnd or Rounding()
    p = {k: v.detach().float().clone() for k, v in p0.items()}
    state = adamw_state(p, count)
    losses, first = [], None
    for tok in batches:
        micro = tok if tok.dim() == 3 else tok[None]
        if batch_rows is not None:
            micro = micro[:, batch_rows]
        g, loss = None, 0.0
        for m in micro:
            lm, gm = loss_and_grads(p, m, cfg, rnd, rows, chunk)
            loss += float(lm) / len(micro)
            g = gm if g is None else {k: g[k] + gm[k] for k in g}
            del gm
        if len(micro) > 1:
            g = {k: v / len(micro) for k, v in g.items()}
        losses.append(loss)
        if first is None:
            norm = math.sqrt(sum(float(v.double().square().sum()) for v in g.values()))
            clip = 1.0 if norm < hp["max_grad_norm"] else hp["max_grad_norm"] / norm
            first = {k: v * clip for k, v in g.items()}
        adamw_step(p, g, state, hp, storage)
        del g
    return {"losses": losses, "grad1": first, "params": p}
