"""Device time a step of the backward: the port's `train.backward` spans
(torch.autograd.grad, each micro-batch; remat's recomputation inside),
between their CUDA events."""

from perfbench.port_trace import per


def read(rec, summary):
    return per(rec.get("steps"), ["train.backward"], device=True)
