"""Build and bind the CUDA kernels of `nsa_vibe_tpu_torch/csrc/`.

Each `.cu` source is compiled by its own `nvcc` process (all started
together) for `sm_90a` into an object with a plain C interface; the
objects are linked into one shared library that is loaded with `ctypes`.
Nothing includes PyTorch's headers, so a build takes seconds.

The build runs at first use into `nsa_vibe_tpu_torch/_build/<hash>/`
(listed in .gitignore), keyed by a hash of the sources and flags, so a
checkout builds its own kernels and an edited source rebuilds. Nothing
here runs at import time.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD_ROOT = PKG / "_build"
SOURCES = ("select_cmp.cu", "sel_attn.cu", "sel_attn_fwd_mma.cu", "banded_fwd_mma.cu",
           "banded_bwd.cu", "sel_attn_bwd.cu", "banded_attn.cu", "select_blocks.cu",
           "banded_bwd_1p.cu", "sel_attn_bwd_1p.cu", "win_bwd_diag.cu", "banded_bwd_mma.cu",
           "select_blocks_mma.cu", "select_cmp_mma.cu", "banded_bwd_gated_mma.cu",
           "adamw_mt.cu")
HEADERS = ("common.cuh", "bwd_common.cuh", "banded_common.cuh", "sel_bwd.cuh", "tc.cuh",
           "select_blocks.cuh", "banded_fwd_mma.cuh", "banded_bwd_mma.cuh")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xptxas", "-v", "-Xcompiler", "-fPIC", "-lineinfo"]

P, I, F, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong

# C signatures of the library (argtypes, restype); every pointer and the
# stream are c_void_p so that 64-bit addresses pass whole
SIGNATURES = {
    "nsa_error_string": ([I], ctypes.c_char_p),
    "nsa_select_cmp": ([P] * 9 + [I] * 14 + [F, I, I, P], I),
    "nsa_select_cmp_max_s_sel": ([], I),
    "nsa_select_cmp_smem_bytes": ([I] * 5, LL),
    "nsa_select_cmp_mma": ([P] * 9 + [I] * 14 + [F, I, I, I, P], I),
    "nsa_select_cmp_mma_smem_bytes": ([I] * 6, LL),
    "nsa_sel_attn": ([I] + [P] * 9 + [I] * 9 + [F, P], I),
    "nsa_sel_attn_smem_bytes": ([I] * 5, LL),
    "nsa_sel_attn_ws_floats": ([I] * 2, LL),
    "nsa_sel_attn_union": ([P] * 8 + [I] * 10 + [F, P], I),
    "nsa_sel_attn_union_smem_bytes": ([I] * 6, LL),
    "nsa_banded_fwd_mma": ([P] * 7 + [I] * 12 + [F, I, P], I),
    "nsa_banded_fwd_mma_smem_bytes": ([I] * 3, LL),
    "nsa_banded_bwd": ([P] * 8 + [I] * 11 + [F, I, I, P], I),
    "nsa_banded_bwd_smem_bytes": ([I] * 2, LL),
    "nsa_sel_attn_bwd": ([I] + [P] * 19 + [I] * 16 + [F, P], I),
    "nsa_sel_attn_bwd_smem_bytes": ([I] * 9, LL),
    "nsa_banded_attn": ([P] * 7 + [I] * 12 + [F, I, P], I),
    "nsa_banded_attn_smem_bytes": ([I] * 4, LL),
    "nsa_select_blocks": ([P] * 4 + [I] * 14 + [F, I, P], I),
    "nsa_select_blocks_smem_bytes": ([I] * 4, LL),
    "nsa_select_blocks_mma": ([P] * 4 + [I] * 14 + [F, I, I, P], I),
    "nsa_select_blocks_mma_smem_bytes": ([I] * 4, LL),
    "nsa_banded_bwd_1p": ([P] * 13 + [I] * 11 + [F, I, I, I, P], I),
    "nsa_banded_bwd_1p_smem_bytes": ([I] * 2, LL),
    "nsa_banded_bwd_1p_slots": ([I] * 3, I),
    "nsa_sel_attn_bwd_1p": ([I] + [P] * 19 + [I] * 12 + [F, P], I),
    "nsa_sel_attn_bwd_1p_smem_bytes": ([I] * 3, LL),
    "nsa_sel_attn_bwd_kv_rows": ([I] * 3, I),
    "nsa_win_bwd_diag": ([P] * 12 + [I] * 8 + [F, I, I, P], I),
    "nsa_win_bwd_diag_smem_bytes": ([I] * 2, LL),
    "nsa_win_bwd_diag_strip_keys": ([I] * 3, I),
    "nsa_banded_bwd_1p_mma": ([P] * 13 + [I] * 11 + [F, I, I, P], I),
    "nsa_banded_bwd_1p_mma_rows": ([I] * 2, I),
    "nsa_banded_bwd_1p_mma_smem_bytes": ([I] * 2, LL),
    "nsa_win_bwd_diag_mma": ([P] * 12 + [I] * 8 + [F, I, I, P], I),
    "nsa_win_bwd_diag_mma_smem_bytes": ([I] * 3, LL),
    "nsa_win_bwd_diag_mma_strip_keys": ([I] * 4, I),
    "nsa_banded_bwd_dq_mma": ([P] * 8 + [I] * 11 + [F, I, I, P], I),
    "nsa_banded_bwd_dq_mma_smem_bytes": ([I] * 3, LL),
    "nsa_adamw_mt_max_leaves": ([], I),
    "nsa_adamw_mt_norm": ([I, P, P, I, LL, I, F, P, P], I),
    "nsa_adamw_mt_finalize": ([P, I, P, P, P, P], I),
    "nsa_adamw_mt_update": ([I] + [P] * 5 + [I, LL, I] + [P] * 5 + [F] * 8 + [P], I),
}

_LIB = None
BUILD_LOG = ""   # compiler output (ptxas register/shared-memory report) of the last build


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(ARCH + CFLAGS).encode())
    return h.hexdigest()[:16]


def build(force: bool = False) -> Path:
    """Compile the sources (in parallel) and link the shared library;
    returns its path. Raises with the compiler output on failure."""
    global BUILD_LOG
    out_dir = BUILD_ROOT / _source_hash()
    lib_path = out_dir / "libnsa_kernels.so"
    if lib_path.exists() and not force:
        return lib_path
    # objects go to a directory of this process's own, so that processes
    # building at once never write the same file
    obj_dir = out_dir / f"obj.{os.getpid()}"
    obj_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    logs, objs, failed = [], [], []
    with contextlib.ExitStack() as stack:
        procs = []
        for name in SOURCES:
            obj = obj_dir / (Path(name).stem + ".o")
            out = stack.enter_context(open(obj_dir / (Path(name).stem + ".log"), "w+"))
            cmd = [nvcc, *ARCH, *CFLAGS, "-I", str(CSRC), "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((name, obj, out, subprocess.Popen(cmd, stdout=out,
                                                           stderr=subprocess.STDOUT)))
        took = {}
        while len(took) < len(procs):     # each source's wall time, for the log
            for name, _, _, proc in procs:
                if name not in took and proc.poll() is not None:
                    took[name] = time.perf_counter() - t0
            time.sleep(0.05)
        for name, obj, out, proc in procs:
            out.seek(0)
            logs.append(f"== nvcc {name} (rc {proc.returncode}, {took[name]:.1f} s)\n{out.read()}")
            objs.append(str(obj))
            if proc.returncode != 0:
                failed.append(name)
    BUILD_LOG = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{BUILD_LOG}")
    tmp = out_dir / f"libnsa_kernels.{os.getpid()}.so"
    link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp), *objs],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    BUILD_LOG += f"\n== link (rc {link.returncode})\n{link.stdout}"
    if link.returncode != 0:
        raise RuntimeError(f"link failed:\n{BUILD_LOG}")
    os.replace(tmp, lib_path)   # atomic: a concurrent loader sees all or nothing
    shutil.rmtree(obj_dir)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _LIB = lib
    return _LIB
