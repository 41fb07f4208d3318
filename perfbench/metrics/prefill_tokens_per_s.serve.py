"""Prompt tokens over the summed CUDA-event time of the window's admissions
(prefill, first token, admit_row)."""

def read(rec, trace):
    if not rec.get("admit_ms"):
        return None
    return rec["prompt_tokens"] / (rec["admit_ms"] * 1e-3)
