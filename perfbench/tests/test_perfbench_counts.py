"""The frozen FLOP and byte counts against values worked out by hand and
against the port's own accounting."""

import json
from pathlib import Path

import pytest

from perfbench.counts import attention, flops

ROOT = Path(__file__).resolve().parents[2]
C125 = json.loads((ROOT / "perfbench/configs/m7c-125m.json").read_text())
C350 = json.loads((ROOT / "perfbench/configs/m7c-350m.json").read_text())


@pytest.mark.parametrize("s,cap", [(1, 4), (5, 5), (9, 4), (2048, 1024), (100, 512)])
def test_sum_min_by_brute_force(s, cap):
    assert flops.sum_min(s, cap) == sum(min(t + 1, cap) for t in range(s))


@pytest.mark.parametrize("s", [1, 31, 32, 33, 47, 48, 100, 2048])
def test_sum_num_cmp_by_brute_force(s):
    assert flops.sum_num_cmp(s, 32, 16) == sum(flops.num_cmp(t + 1, 32, 16) for t in range(s))


def test_dense_flops_of_m7c_125m_by_hand():
    # per layer: Q and W_O 2*768*768 each, six K/V 2*768*128, MLP 2*2*768*3072
    per_layer = 2 * 1179648 + 2 * 3 * 196608 + 2 * 2 * 768 * 3072
    assert per_layer == 12976128
    assert flops.dense_per_token(C125) == 12 * per_layer + 2 * 768 * 256


@pytest.mark.parametrize("cfg,mflop", [(C125, 613.5), (C350, 2125.6)])
def test_train_flops_a_token(cfg, mflop):
    # the per-token figures PERF.md records from the port's utils/flops.py
    assert round(flops.train_step_flops(cfg, 1, 2048) / 2048 / 1e6, 1) == mflop


@pytest.mark.parametrize("cfg", [C125, C350])
@pytest.mark.parametrize("batch,seq", [(32, 2048), (4, 16384), (1, 65536)])
def test_frozen_copy_equals_the_ports_count(cfg, batch, seq):
    from nsa_vibe_tpu_torch.core.config import ModelConfig, NSAConfig
    from nsa_vibe_tpu_torch.utils.flops import train_step_flops

    keys = ("dim", "n_heads", "n_kv_groups", "d_k", "d_v", "l", "d", "l_sel", "n_sel", "w")
    mcfg = ModelConfig(vocab_size=cfg["vocab_size"], n_layers=cfg["n_layers"],
                       nsa=NSAConfig(**{k: cfg[k] for k in keys}))
    assert flops.train_step_flops(cfg, batch, seq) == train_step_flops(mcfg, batch, seq)["total"]


def test_decode_flops_sum_to_prefill_without_the_map():
    # the token at position t sees the keys row t of a prefill sees; the
    # Eq. 9 map is dense over the blocks of the sequence so far
    cfg = dict(C125, n_layers=1)
    P = 700
    no_map = dict(cfg, l_sel=cfg["l_sel"])
    total = sum(flops.decode_flops(no_map, t) for t in range(P))
    reads = flops.key_reads(P, cfg)
    H, G = cfg["n_heads"], cfg["n_kv_groups"]
    att = sum(reads.values()) * H * 2 * 128 + reads["cmp"] * H * 2 * 64
    maps = sum(G * 2 * flops.num_cmp(t + 1, 32, 16) * -(-(t + 1) // 64) for t in range(P))
    assert total == flops.dense_per_token(cfg) * P + att + maps


def test_attention_work_by_hand():
    cfg = dict(C125, n_layers=1)
    w = attention.prefill_work(cfg, 1, 64, train=False)
    # keys: cmp 1+2+3 at t = 31, 47, 63 -> sum 1*16 + 2*16 + 3*1 = 51 ... by brute force
    keys = sum(flops.num_cmp(t + 1, 32, 16) + min(t + 1, 1024) + min(t + 1, 512)
               for t in range(64))
    assert w["ops"] == keys * 12 * 2 * 128
    q = o = 64 * 12 * 64 * 2
    lse = 64 * 12 * 4
    kv = 2 * (2 * 64 + 3) * 128 * 2
    assert w["bytes"] == q + 3 * (o + lse) + kv
    t = attention.prefill_work(cfg, 1, 64, train=True)
    assert t["ops"] == 3 * w["ops"] and t["bytes"] == w["bytes"] + 3 * o + q + kv
    d = attention.decode_sel_work(cfg, 5000)
    assert d["ops"] == 1024 * 12 * 2 * 128
    assert d["bytes"] == 12 * 128 * 2 + 2 * 1024 * 128 * 2
    assert attention.least_seconds({"ops": 989e12, "bytes": 1.0}, 989e12, 3.35e12) == 1.0
