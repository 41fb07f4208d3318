"""Share of the traced window in which no operation ran on the device, in percent."""

def read(rec, trace):
    if not trace or not rec.get("steps"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
