"""Device time a step of every operation that is not one of the port's own kernels
(cuBLAS, PyTorch's kernels, copies), from the trace."""

def read(rec, trace):
    if not trace or not rec.get("steps"):
        return None
    return 1e3 * (trace["device_s"] - trace["own_s"]) / rec["steps"]
