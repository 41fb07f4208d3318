"""Share of the trainable leaves that the optimizer updated through the
multi-tensor kernels over the window, in %: the port's counters
`optimizer.fused_leaves` and `optimizer.plain_leaves` (train/optim.py). A
port without them reads nothing."""

from perfbench.port_trace import counter_per


def read(rec, summary):
    n = rec.get("steps")
    fused = counter_per(n, "optimizer.fused_leaves")
    plain = counter_per(n, "optimizer.plain_leaves")
    if fused is None and plain is None:
        return None
    fused, plain = fused or 0.0, plain or 0.0
    return 100.0 * fused / (fused + plain) if fused + plain else None
