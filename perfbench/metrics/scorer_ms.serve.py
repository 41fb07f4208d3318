"""Device time an admission of prefill's scorer: the port's `prefill.score`
spans (the fused select_cmp, or select_blocks and the compressed branch on
the long route; one a layer), summed between their CUDA events."""

from perfbench.port_trace import per


def read(rec, summary):
    return per(rec.get("admitted"), ["prefill.score"], device=True)
