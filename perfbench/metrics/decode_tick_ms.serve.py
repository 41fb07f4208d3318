"""The replayed ticks' CUDA-event time over their count."""

def read(rec, trace):
    if not rec.get("ticks"):
        return None
    return rec["tick_ms"] / rec["ticks"]
