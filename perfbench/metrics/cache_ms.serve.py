"""Device time an admission of the cache writes: the port's `prefill.cache`
spans (cache_from_prefill, one a layer) and `cache.admit` spans (admit_row
into the running batch), summed between their CUDA events."""

from perfbench.port_trace import per


def read(rec, summary):
    return per(rec.get("admitted"), ["prefill.cache", "cache.admit"], device=True)
