"""Model FLOPs of the window's steps (counts/flops.py, recompute not counted)
over the wall time and the bf16 peak, in percent."""

from perfbench.counts.peaks import PEAK_FLOPS


def read(rec, trace):
    if not rec.get("steps"):
        return None
    return 100.0 * rec["train_flops"] / rec["wall_s"] / PEAK_FLOPS[rec["dtype"]]
