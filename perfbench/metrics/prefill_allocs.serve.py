"""The caching allocator's cudaMalloc calls and retries an admission
during prefill: the port's counter `prefill.device_allocs`."""

from perfbench.port_trace import counter_per


def read(rec, summary):
    return counter_per(rec.get("admitted"), "prefill.device_allocs")
