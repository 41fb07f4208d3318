"""Host time a step of the whole train step: the port's `train.step` span on
the host clock, the host's issue of a step."""

from perfbench.port_trace import per


def read(rec, summary):
    return per(rec.get("steps"), ["train.step"], device=False)
