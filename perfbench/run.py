#!/usr/bin/env python3
"""The benchmark of nsa_vibe_tpu_torch, one cell of BENCHMARK.json per run.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for; without them it exits 3 and prints no result. The last line of
standard output is the result (JSON); the last lines of standard error
give each number compared beside its limit. See perfbench/README.md.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from perfbench.caches import use_checkout_caches  # noqa: E402

use_checkout_caches()

from perfbench.harness import main, process_start  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], process_start()))
