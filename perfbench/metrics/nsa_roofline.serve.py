"""Least time of the window's prefill and decode-selection attention work
(counts/attention.py) over the device time of the port's own kernels, in percent."""

from perfbench.counts.peaks import HBM_BYTES_PER_S, PEAK_FLOPS
from perfbench.counts.attention import least_seconds


def read(rec, trace):
    if not trace or "ttft_ms" not in rec or trace["own_s"] <= 0:
        return None
    work = {"ops": rec["nsa_ops"], "bytes": rec["nsa_bytes"]}
    return 100.0 * least_seconds(work, PEAK_FLOPS[rec["dtype"]], HBM_BYTES_PER_S) / trace["own_s"]
