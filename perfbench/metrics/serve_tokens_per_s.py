"""Output tokens of all slots over the window's wall time."""

def read(rec, trace):
    return rec["tokens"] / rec["wall_s"] if "ttft_ms" in rec else None
