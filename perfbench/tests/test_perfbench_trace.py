"""The trace's summary on a made-up timeline, and kernel names."""

from types import SimpleNamespace

import torch

from perfbench import trace


class Ev:
    def __init__(self, name, a, b, dev=torch.autograd.DeviceType.CUDA):
        self.n, self.a, self.b, self.dev = name, a, b, dev

    def name(self):
        return self.n

    def device_type(self):
        return self.dev

    def start_ns(self):
        return self.a

    def duration_ns(self):
        return self.b - self.a


def test_summary_of_a_made_up_window():
    events = [Ev("void (anonymous namespace)::sel_attn_union_kernel<64>(int)", 10, 30),
              Ev("void at::native::add_kernel(float*)", 25, 50),
              Ev("ampere_gemm", 70, 90),
              Ev("host_op", 0, 100, torch.autograd.DeviceType.CPU),
              Ev("before_window", -50, -10)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    spans = [("window", 0, 100), ("step", 0, 60), ("sync", 60, 100)]
    s = trace.summarise(prof, {"sel_attn_union_kernel"}, spans)
    assert abs(s["window_s"] - 100e-9) < 1e-18
    assert abs(s["busy_s"] - 60e-9) < 1e-18           # [10, 50] and [70, 90]
    assert abs(s["own_s"] - 20e-9) < 1e-18
    assert abs(s["device_s"] - 65e-9) < 1e-18
    gaps = dict(s["idle_gaps"])             # [0, 10] in step; [50, 70], [90, 100] in sync
    assert abs(gaps["step"] - 10e-9) < 1e-18 and abs(gaps["sync"] - 30e-9) < 1e-18


def test_kernel_base_names():
    names = {
        "void nsa::sel::(anonymous namespace)::sel_bwd_kv_mma_kernel<64>(nsa::sel::KvArgs)":
            "sel_bwd_kv_mma_kernel",
        "_ZN3nsa3sel12_GLOBAL__N_121sel_bwd_kv_mma_kernelILi64EEEvNS0_6KvArgsE":
            "sel_bwd_kv_mma_kernel",
        "_Z21select_cmp_mma_kernelI13__nv_bfloat16EvT_": "select_cmp_mma_kernel",
        "nvjet_tst_192x192_64x3_2x1_v_bz_coopB_NNN": "nvjet_tst_192x192_64x3_2x1_v_bz_coopB_NNN",
    }
    for raw, base in names.items():
        assert trace.base_name(raw) == base


def test_spans_only_when_tracing():
    off, on = trace.Spans(False), trace.Spans(True)
    with off("a"):
        pass
    with on("b"):
        pass
    assert off.done == [] and [n for n, _, _ in on.done] == ["b"]
