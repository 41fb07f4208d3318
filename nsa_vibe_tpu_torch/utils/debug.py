"""Structured debug logging (the port's own copy of
nsa_vibe_tpu/utils/debug.py): `NSA-LOG <tag> k=v` lines on stderr, enabled
by NSA_DEBUG_LOG, rate-limited per tag by NSA_LOG_LIMIT (0: no limit).
"""

from __future__ import annotations

import os
import sys
from collections import defaultdict

_counts: dict = defaultdict(int)


def _enabled() -> bool:
    return os.getenv("NSA_DEBUG_LOG", "0").lower() in ("1", "true", "yes", "on")


def _limit() -> int:
    try:
        return int(os.getenv("NSA_LOG_LIMIT", "0"))
    except ValueError:
        return 0


def log(tag: str, **fields) -> None:
    """Emit `NSA-LOG tag k=v ...` when NSA_DEBUG_LOG is on."""
    if not _enabled():
        return
    limit = _limit()
    _counts[tag] += 1
    if limit > 0 and _counts[tag] > limit:
        return
    kv = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"NSA-LOG {tag} {kv}", file=sys.stderr, flush=True)


def reset_counts() -> None:
    _counts.clear()
