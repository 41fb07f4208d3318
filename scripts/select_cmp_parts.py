"""Where the bf16 fused scorer's time goes, on one CUDA card.

    python scripts/select_cmp_parts.py

Builds variants of nsa_vibe_tpu_torch/csrc/select_cmp_mma.cu, each with one
part compiled out or replaced (edited copies of the sources under
artifacts/select_cmp_parts/, git-ignored), links each with select_cmp.cu
into a library of its own, and times `select_cmp` under each at the m7c
serve shape (4 x 2048), the train shape with lse (8 x 2048) and the fused
route's longest prompt (1 x 16384), in turns (each variant twice, the
second round in reverse order), beside banded_attn in cmp mode (pass 1's
walk alone). Variants: the kernel as built; `argmax_top_n`, the top-n's
argmax passes at every S_sel (its rank per block off); `no_top_n`;
`no_map` (no chunk_scores); `no_pass2` (no second walk, nor the map);
`no_pass2_no_top_n`. A variant's outputs are wrong where a part is
missing; only `argmax_top_n` must give the kernel's bits, and the script
checks that it does. Times are device times of 20 launches with the
stream held (chip_smoke.time_ms); it prints the card's name and power
limit first.
"""

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from nsa_vibe_tpu_torch.ops.block_index import build_M_csl_on, num_cmp_blocks  # noqa: E402
from nsa_vibe_tpu_torch.ops.cuda import build as kbuild  # noqa: E402
from nsa_vibe_tpu_torch.ops.cuda import select_cmp as sc_mod  # noqa: E402
from nsa_vibe_tpu_torch.ops.cuda.banded_attn import banded_attn  # noqa: E402

OUT = ROOT / "artifacts" / "select_cmp_parts"
TOP_N = "  scorer::top_n(acc, sel, sp, b, g, s0, nt);"
MAP = "    scorer::chunk_scores(p_s, PP, acc, sp, nt, k0, min(k0 + KC, n_vis_tile), M);"
PASS2 = "  for (int j = 0; j < J; ++j) {"
RANK = "  if (S_sel <= 32) {"
# variant -> edits (file, text, replacement)
VARIANTS = {
    "kernel": [],
    "argmax_top_n": [("select_blocks.cuh", RANK, "  if (false) {")],
    "no_top_n": [("select_cmp_mma.cu", TOP_N, "")],
    "no_map": [("select_cmp_mma.cu", MAP, "")],
    "no_pass2": [("select_cmp_mma.cu", PASS2, "  for (int j = 0; j < 0; ++j) {")],
    "no_pass2_no_top_n": [("select_cmp_mma.cu", PASS2, "  for (int j = 0; j < 0; ++j) {"),
                          ("select_cmp_mma.cu", TOP_N, "")],
}
FUNCS = ("nsa_error_string", "nsa_select_cmp_max_s_sel", "nsa_select_cmp_mma",
         "nsa_select_cmp_mma_smem_bytes")
SHAPES = {"serve": (4, 2048, False), "train (lse)": (8, 2048, True), "16k": (1, 16384, False)}


def build_variants() -> dict:
    """name -> ctypes library of select_cmp.cu + the variant's select_cmp_mma.cu."""
    shutil.rmtree(OUT, ignore_errors=True)
    nvcc, procs = kbuild.nvcc_path(), {}
    for name, edits in VARIANTS.items():
        src = OUT / name
        shutil.copytree(kbuild.CSRC, src)
        for f, text, new in edits:
            code = (src / f).read_text()
            if text not in code:
                raise SystemExit(f"{name}: {f} no longer holds {text!r}")
            (src / f).write_text(code.replace(text, new))
        for f in ("select_cmp.cu", "select_cmp_mma.cu"):
            procs[name, f] = subprocess.Popen(
                [nvcc, *kbuild.ARCH, *kbuild.CFLAGS, "-I", str(src), "-c", str(src / f), "-o",
                 str(src / (f + ".o"))], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
    for (name, f), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name} {f}:\n{log}")
    libs = {}
    for name in VARIANTS:
        src = OUT / name
        subprocess.run([nvcc, *kbuild.ARCH, "-shared", "-o", str(src / "lib.so"),
                        str(src / "select_cmp.cu.o"), str(src / "select_cmp_mma.cu.o")],
                       check=True)
        lib = ctypes.CDLL(str(src / "lib.so"))
        for fn in FUNCS:
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = kbuild.SIGNATURES[fn]
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("select_cmp_parts: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda")
    full = kbuild.library()   # the tree's build, for banded_attn
    libs = build_variants()
    cfg = cs.M7C_125M.nsa
    gen = torch.Generator(device=dev).manual_seed(0)
    bad = False
    for label, (B, S, lse) in SHAPES.items():
        S_cmp = num_cmp_blocks(S, cfg.l, cfg.d)
        Q, Kc, Vc = (torch.randn(s, generator=gen, device=dev).bfloat16()
                     for s in ((B, S, cfg.n_kv_groups, cfg.h_per_group, cfg.d_k),
                               (B, cfg.n_kv_groups, S_cmp, cfg.d_k),
                               (B, cfg.n_kv_groups, S_cmp, cfg.d_v)))
        M = build_M_csl_on(S, cfg.l, cfg.d, cfg.l_sel, dev)
        kw = dict(scale=cfg.d_k ** -0.5, l=cfg.l, d=cfg.d, l_sel=cfg.l_sel, n_top=cfg.n_sel,
                  return_lse=lse)
        kbuild._LIB = full
        band = cs.time_ms(lambda: banded_attn(Q, Kc, Vc, mode="cmp", l=cfg.l, d=cfg.d,
                                              scale=kw["scale"]), 20, hold=True)
        ms, outs = {name: [] for name in libs}, {}
        for name in list(libs) + list(reversed(libs)):
            kbuild._LIB = libs[name]
            outs[name] = sc_mod.select_cmp(Q, Kc, Vc, M, **kw)
            ms[name].append(cs.time_ms(lambda: sc_mod.select_cmp(Q, Kc, Vc, M, **kw), 20,
                                       hold=True))
        same = all(torch.equal(a, b) for a, b in zip(outs["kernel"], outs["argmax_top_n"]))
        bad |= not same
        print(f"[parts] {label} (B={B}, S={S}, S_sel={M.shape[1]}): banded_attn cmp {band:.4f} ms; "
              + "; ".join(f"{n} {v[0]:.4f} / {v[1]:.4f}" for n, v in ms.items())
              + f" ms; argmax_top_n gives the kernel's bits: {same}")
        del Q, Kc, Vc, M, outs
    kbuild._LIB = full
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
