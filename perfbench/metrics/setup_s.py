"""Set-up: process start to the first timed step, the build included."""

def read(rec, trace):
    return rec.get("setup_s")
