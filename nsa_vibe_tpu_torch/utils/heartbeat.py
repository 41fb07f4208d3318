"""Heartbeat: one JSON line per beat with training vitals (the port's own
copy of nsa_vibe_tpu/utils/heartbeat.py; utils/watchdog.py reads the
file itself, so the JAX module's reader `last_beat` is not copied)."""

from __future__ import annotations

import json
import os
import time
from typing import Any


class Heartbeat:
    def __init__(self, path: str, rank: int = 0):
        self.path = path
        self.rank = rank
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def beat(self, step: int, **fields: Any) -> None:
        rec = {"ts": time.time(), "rank": self.rank, "step": step, **fields}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
