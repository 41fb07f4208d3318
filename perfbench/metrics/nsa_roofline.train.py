"""Least time of the window's NSA attention work (counts/attention.py) over the
device time of the port's own kernels, in percent."""

from perfbench.counts.peaks import HBM_BYTES_PER_S, PEAK_FLOPS
from perfbench.counts.attention import least_seconds


def read(rec, trace):
    if not trace or not rec.get("steps") or trace["own_s"] <= 0:
        return None
    return 100.0 * least_seconds(rec["nsa_work"], PEAK_FLOPS[rec["dtype"]],
                                 HBM_BYTES_PER_S) / trace["own_s"]
