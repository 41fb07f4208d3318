"""Device time a step of the optimizer: the port's `train.optimizer` span
(global norm, clipping and the AdamW update of every leaf), between its
CUDA events."""

from perfbench.port_trace import per


def read(rec, summary):
    return per(rec.get("steps"), ["train.optimizer"], device=True)
