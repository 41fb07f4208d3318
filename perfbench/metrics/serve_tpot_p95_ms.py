"""95th percentile over the requests completed in the window of
(last token time - first token time) / (tokens - 1), from CUDA events."""

from perfbench.stats import percentile


def read(rec, trace):
    return percentile(rec.get("tpot_ms") or [], 95)
