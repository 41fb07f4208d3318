"""Writes the ptxas numbers (registers, stack frame, spill stores, spill
loads) of the kernels chip_smoke.py reports, compiled from a given csrc
directory, as the JSON file chip_smoke.py's build phase holds the tree's
kernels to (nsa_vibe_tpu_torch/csrc/ptxas_baseline.json).

    git archive <commit> nsa_vibe_tpu_torch/csrc | tar -x -C artifacts/base
    python scripts/ptxas_baseline.py artifacts/base/nsa_vibe_tpu_torch/csrc \\
        nsa_vibe_tpu_torch/csrc/ptxas_baseline.json [--commit <commit>]

Needs nvcc (the card's machine); builds into artifacts/ptxas_baseline_build.
"""

import argparse
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from nsa_vibe_tpu_torch.ops.cuda import build as kbuild  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("csrc")
    ap.add_argument("out")
    ap.add_argument("--commit", default="")
    args = ap.parse_args()
    kbuild.CSRC = Path(args.csrc).resolve()
    kbuild.BUILD_ROOT = Path("artifacts", "ptxas_baseline_build").resolve()
    kbuild._LIB = None
    kbuild.build(force=True)
    report = cs.ptxas_report(kbuild.BUILD_LOG, cs.PTXAS_REPORTED)
    names = cs.demangle([r[0] for r in report])
    kernels = {cs.ptxas_key(n): cs.ptxas_numbers(regs, frame)
               for (_, regs, frame), n in zip(report, names)}
    nvcc = os.popen(f"{kbuild.nvcc_path()} --version").read().strip().splitlines()[-1]
    head = {"commit": args.commit, "nvcc": nvcc,
            "fields": ["registers", "stack frame", "spill stores", "spill loads"]}
    rows = [f"  {json.dumps(k)}: {json.dumps(v)}" for k, v in sorted(kernels.items())]
    with open(args.out, "w") as f:   # one kernel a line
        f.write("{\n" + "".join(f" {json.dumps(k)}: {json.dumps(v)},\n" for k, v in head.items())
                + ' "kernels": {\n' + ",\n".join(rows) + "\n }\n}\n")
    for k, v in kernels.items():
        print(f"{k}: {v}")
    print(f"{len(kernels)} kernels -> {args.out}")


if __name__ == "__main__":
    main()
