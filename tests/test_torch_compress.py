"""Average ϕ pooling in bf16 at long S (CPU).

The port sums each compressed window from its own d-sized chunk sums in
float32 and rounds once (ops/compress.py::avg_pool_phi), so a bf16 result
is the exact window mean rounded to bf16: within 2 bf16 ulps of the
window mean computed in float64 from the same bf16 inputs (the ulp of a
value v taken as 2^(floor(log2 |v|) - 7), floored at the smallest normal).
A running sum kept in bf16 (the form of the JAX package's default,
`exact=False`) cancels as S grows, by up to 0.25 at S = 16384 for
N(0.1, 1) inputs. The float32 comparisons against the JAX package are in
tests/test_torch_ops.py. Decode emits each compressed token as the mean
of its l raw tokens (core/decode.py); prefill must give the same bf16
values.
"""

import numpy as np
import pytest
import torch

from nsa_vibe_tpu_torch.core.cache import init_cache
from nsa_vibe_tpu_torch.core.config import NSAConfig
from nsa_vibe_tpu_torch.core.decode import nsa_prefill_via_decode
from nsa_vibe_tpu_torch.core.nsa import init_nsa_params, nsa_prefill
from nsa_vibe_tpu_torch.ops.compress import avg_pool_phi


def _bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    a = v.double().abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def _pool64(x: torch.Tensor, l: int, d: int) -> torch.Tensor:
    """Window means in float64, one window at a time."""
    xs = x.double()
    S_cmp = (xs.shape[-2] - l) // d + 1
    win = xs.unfold(-2, l, d)                                   # [..., S_cmp, D, l]
    assert win.shape[-3] == S_cmp
    return win.mean(dim=-1)


@pytest.mark.parametrize("mu", [0.1, 1.0])
def test_bf16_avg_pool_within_two_ulps_at_16k(mu):
    S, l, d = 16384, 32, 16
    x = torch.from_numpy(np.random.RandomState(0).randn(1, 2, S, 64) + mu).to(torch.bfloat16)
    got = avg_pool_phi(x, l, d)
    want = _pool64(x, l, d)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape == (1, 2, (S - l) // d + 1, 64)
    ulps = ((got.double() - want).abs() / _bf16_ulp(want)).max()
    assert float(ulps) <= 2.0, float(ulps)


def test_bf16_prefill_compressed_tokens_equal_decode_emissions():
    """At S = 512 in bf16: the compressed tokens of nsa_prefill's aux equal,
    within 1 bf16 ulp, the ones the decode step emits token by token."""
    cfg = NSAConfig(dim=64, n_heads=4, n_kv_groups=2, d_k=16, d_v=16, l=32, d=16, l_sel=64,
                    n_sel=4, w=64)
    params = init_nsa_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                             dtype=torch.bfloat16)
    S = 512
    x = (torch.randn(1, S, cfg.dim, generator=torch.Generator().manual_seed(1)) + 0.5
         ).to(torch.bfloat16)
    with torch.no_grad():
        _, aux = nsa_prefill(params, x, cfg)
        cache = init_cache(cfg, 1, S, torch.bfloat16, "cpu")
        _, cache = nsa_prefill_via_decode(params, x, cache, cfg)
    n = aux["K_cmp"].shape[2]
    assert n == (S - cfg.l) // cfg.d + 1
    for pre, dec in ((aux["K_cmp"], cache.k_cmp[:, :, :n]), (aux["V_cmp"], cache.v_cmp[:, :, :n])):
        ulps = ((pre.double() - dec.double()).abs() / _bf16_ulp(dec)).max()
        assert float(ulps) <= 1.0, float(ulps)
