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

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD_ROOT = PKG / "_build"
SOURCES = ("select_cmp.cu", "sel_attn.cu", "win_attn.cu")
HEADERS = ("common.cuh",)
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xptxas", "-v", "-Xcompiler", "-fPIC", "-lineinfo"]

P, I, F, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong

# C signatures of the library (argtypes, restype); every pointer and the
# stream are c_void_p so that 64-bit addresses pass whole
SIGNATURES = {
    "nsa_error_string": ([I], ctypes.c_char_p),
    "nsa_select_cmp": ([I, P, P, P, P, P, P] + [I] * 14 + [F, I, P], I),
    "nsa_select_cmp_max_s_sel": ([], I),
    "nsa_select_cmp_smem_bytes": ([I] * 5, LL),
    "nsa_sel_attn": ([I, P, P, P, P, P, P] + [I] * 9 + [F, P], I),
    "nsa_sel_attn_smem_bytes": ([I] * 5, LL),
    "nsa_win_attn": ([I, P, P, P, P] + [I] * 8 + [F, I, P], I),
    "nsa_win_attn_smem_bytes": ([I] * 4, LL),
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
    procs = []
    for name in SOURCES:
        obj = obj_dir / (Path(name).stem + ".o")
        cmd = [nvcc, *ARCH, *CFLAGS, "-I", str(CSRC), "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, objs, failed = [], [], []
    for name, obj, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== nvcc {name} (rc {proc.returncode})\n{out}")
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
