"""The plain reference against the port's CPU path at a tiny size in
float32, for the train step and for prefill followed by decode, and the
comparison failing when the port runs in a lower precision."""

import pytest
import torch

from perfbench.reference import tinylm as ref
from perfbench.tests import tiny

TIGHT_TRAIN = {"loss1": 1e-5, "loss": 1e-5, "grad1": 1e-4, "change": 1e-4}
TIGHT_SERVE = {"logit_gap": 1e-4}


@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_agree_in_float32(accum):
    out = tiny.run(tiny.cell("train", TIGHT_TRAIN, accum=accum))
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0


def test_prefill_and_decode_agree_in_float32():
    out = tiny.run(tiny.cell("serve", TIGHT_SERVE), seconds=1.0)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 4


def test_comparison_fails_in_bfloat16_training():
    out = tiny.run(tiny.cell("train", TIGHT_TRAIN, dtype="bfloat16"))
    assert not out["correct"], out["checks"]


def test_comparison_fails_in_bfloat16_serving():
    # long answers: some bfloat16 logit puts another token first
    res = tiny.cell("serve", TIGHT_SERVE, dtype="bfloat16", answers={"a": 48, "b": 64},
                    capacity=300 + 64 + 4, check_requests=4)
    out = tiny.run(res, seconds=2.0)
    assert not out["correct"], out["checks"]


def test_served_logits_equal_the_last_rows_of_a_longer_pass():
    cfg = dict(tiny.TINY)
    from perfbench import weights
    p = weights.make(cfg, 5, tiny.CPU)
    tok = torch.randint(0, 256, (1, 200), generator=torch.Generator().manual_seed(0))
    rnd = ref.Rounding()
    a = ref.served_logits(p, tok, [150, 199], cfg, rnd, chunk=64)
    b = ref.served_logits(p, tok, [150, 199], cfg, rnd, chunk=200)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_fp8_rounding_rounds_and_passes_gradients():
    x = torch.linspace(-3, 3, 101, requires_grad=True)
    y = ref.Rounding("fp8")(x)
    assert 0 < (y - x).abs().max() < 0.2 and len(torch.unique(y.detach())) < 101
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))


def test_dense_and_gathered_selected_branch_agree():
    from perfbench import weights
    cfg = dict(tiny.TINY)
    p = weights.make(cfg, 6, tiny.CPU)
    tok = torch.randint(0, 256, (2, 160), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a = ref.hidden(p, tok, cfg, ref.Rounding(), 64, training=True)
        b = ref.hidden(p, tok, cfg, ref.Rounding(), 64, training=False)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
