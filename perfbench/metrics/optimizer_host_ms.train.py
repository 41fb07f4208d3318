"""Host time a step of the optimizer: the port's `train.optimizer` span on
the host clock, the issue of its launches."""

from perfbench.port_trace import per


def read(rec, summary):
    return per(rec.get("steps"), ["train.optimizer"], device=False)
