"""Forward model FLOPs of the tokens prefilled and decoded, each at its own depth,
over the wall time and the bf16 peak, in percent."""

from perfbench.counts.peaks import PEAK_FLOPS


def read(rec, trace):
    if "ttft_ms" not in rec:
        return None
    return 100.0 * rec["flops"] / rec["wall_s"] / PEAK_FLOPS[rec["dtype"]]
