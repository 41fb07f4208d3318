"""Host time an admission of the prefill: the port's `prefill` span
(model_prefill_with_caches) on the host clock."""

from perfbench.port_trace import per


def read(rec, summary):
    return per(rec.get("admitted"), ["prefill"], device=False)
