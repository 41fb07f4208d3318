"""Device time a step of the forward: the port's `train.forward` spans
(model_forward and the loss, each micro-batch), between their CUDA events."""

from perfbench.port_trace import per


def read(rec, summary):
    return per(rec.get("steps"), ["train.forward"], device=True)
