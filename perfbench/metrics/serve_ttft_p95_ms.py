"""95th percentile of time to first token over every request sent in the window
(CUDA events: from the client's previous request's last token to the first token)."""

from perfbench.stats import percentile


def read(rec, trace):
    return percentile(rec.get("ttft_ms") or [], 95)
