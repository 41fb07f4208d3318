"""utils/flops.py (the port's copy) vs nsa_vibe_tpu/utils/flops.py: the
same FLOP counts and key reads on three configurations (integers, exact);
mfu against the H100 peak."""

import pytest

from nsa_vibe_tpu.core.config import ModelConfig as JModelConfig
from nsa_vibe_tpu.core.config import NSAConfig as JNSAConfig
from nsa_vibe_tpu.utils import flops as jflops
from nsa_vibe_tpu_torch.core.config import ModelConfig, NSAConfig
from nsa_vibe_tpu_torch.utils import flops as tflops

CONFIGS = [   # (model kw, nsa kw, batch, seq)
    (dict(n_layers=12), dict(dim=768, n_heads=12, n_kv_groups=2, d_k=64, d_v=64, l=32, d=16,
                             l_sel=64, n_sel=16, w=512), 8, 2048),          # m7c, train cell
    (dict(n_layers=12), dict(dim=768, n_heads=12, n_kv_groups=2, d_k=64, d_v=64, l=32, d=16,
                             l_sel=64, n_sel=16, w=512), 32, 4096),         # m7c, pod profile
    (dict(n_layers=2, vocab_size=64, mlp_ratio=3.0),
     dict(dim=48, n_heads=6, n_kv_groups=2, d_k=16, d_v=16, l=8, d=4, l_sel=16, n_sel=4,
          w=16), 3, 77),                                                   # small, odd S
]


@pytest.mark.parametrize("mkw,nkw,batch,seq", CONFIGS)
def test_flop_counts_equal_jax(mkw, nkw, batch, seq):
    jm = JModelConfig(nsa=JNSAConfig(**nkw), **mkw)
    tm = ModelConfig(nsa=NSAConfig(**nkw), **mkw)
    assert tflops.train_step_flops(tm, batch, seq) == jflops.train_step_flops(jm, batch, seq)
    assert tflops.attention_key_reads(seq, tm.nsa) == jflops.attention_key_reads(seq, jm.nsa)


def test_mfu_uses_the_h100_peak():
    assert tflops.H100_BF16_PEAK_FLOPS == 989e12
    assert tflops.mfu(989e12, 1.0) == {"achieved_tflops": 989.0, "mfu_pct": 100.0}
    assert tflops.mfu(1e12, 0.5, peak=1e13)["mfu_pct"] == 20.0
