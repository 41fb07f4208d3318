"""Tokens trained (B x S x accum a step) over the window's wall time."""

def read(rec, trace):
    return rec["tokens"] / rec["wall_s"] if rec.get("steps") else None
