"""The port's own spans and counters (nsa_vibe_tpu_torch/utils/trace.py),
recorded inside the port while the profiler ran the window: the train
step's `train.step`, `train.forward`, `train.backward`, `train.optimizer`;
prefill's `prefill`, `prefill.score`, `prefill.cache`, admission's
`cache.admit`; the counter `prefill.device_allocs`. Set-up and the
reference run outside the profiler, so the record holds the window alone.
A port without the recorder, or a window that recorded nothing, gives
None."""

from __future__ import annotations

from typing import Optional, Sequence


def _recorder():
    try:
        from nsa_vibe_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


def per(n, names: Sequence[str], device: bool) -> Optional[float]:
    """The summed milliseconds of every span named in `names` over n: host
    time, or with device=True the time between each span's CUDA events."""
    tr = _recorder()
    if tr is None or not n:
        return None
    record = tr.spans()
    ms = [x for name in names for x in tr.durations(record, name, device=device)]
    return sum(ms) / n if ms else None


def counter_per(n, name: str) -> Optional[float]:
    """The counter `name` over n."""
    tr = _recorder()
    if tr is None or not n:
        return None
    v = tr.counters().get(name)
    return None if v is None else v / n
