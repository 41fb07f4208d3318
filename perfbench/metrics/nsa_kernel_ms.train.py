"""Device time a step of the port's own kernels, from the trace."""

def read(rec, trace):
    if not trace or not rec.get("steps") or trace["own_s"] <= 0:
        return None
    return 1e3 * trace["own_s"] / rec["steps"]
