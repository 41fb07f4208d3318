"""Native (C++) host packer, bound with ctypes (the port's own copy of
nsa_vibe_tpu/native/__init__.py).

packer.cpp is built with g++ (-O3 -std=c++17 -shared -fPIC) at first use
into nsa_vibe_tpu_torch/_build/native/_packer_<hash>.so, keyed by the
source's content hash, so an edit to packer.cpp builds it again. Nothing
is written next to the source, and the JAX package's build function is
never called. `native_available()` is False when the library does not build
(no g++): train/data.py::make_batches then packs in Python under
native=None and raises under native=True.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).with_name("packer.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build" / "native"
CXX = "g++"
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_ERROR: Optional[Exception] = None   # why the library did not build, once tried


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"_packer_{digest}.so"


def _build_and_load() -> ctypes.CDLL:
    so = library_path()
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.tmp{os.getpid()}")
        try:
            subprocess.run([CXX, "-O3", "-std=c++17", "-shared", "-fPIC", str(SRC), "-o",
                            str(tmp)], check=True, capture_output=True, text=True, timeout=120)
            os.replace(tmp, so)   # another process building at once never sees a partial file
        except subprocess.CalledProcessError as e:
            raise RuntimeError(f"{CXX} failed on {SRC}: {e.stderr.strip()[-2000:]}") from e
        finally:
            tmp.unlink(missing_ok=True)
    lib = ctypes.CDLL(str(so))
    lib.packer_new.restype = ctypes.c_void_p
    lib.packer_new.argtypes = [ctypes.c_int64, ctypes.c_int64]
    lib.packer_feed.restype = None
    lib.packer_feed.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
    lib.packer_ready.restype = ctypes.c_int64
    lib.packer_ready.argtypes = [ctypes.c_void_p]
    lib.packer_next.restype = ctypes.c_int32
    lib.packer_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.packer_buffered.restype = ctypes.c_int64
    lib.packer_buffered.argtypes = [ctypes.c_void_p]
    lib.packer_free.restype = None
    lib.packer_free.argtypes = [ctypes.c_void_p]
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    """The library, built on the first call; None (and _ERROR set) when it
    does not build. A failed build is not tried again in this process."""
    global _LIB, _ERROR
    with _LOCK:
        if _LIB is None and _ERROR is None:
            try:
                _LIB = _build_and_load()
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                _ERROR = e
    return _LIB


def native_available() -> bool:
    return _get_lib() is not None


class ByteStreamPacker:
    """Streaming byte tokenizer + fixed-length packer (C++ backed).

    feed(text_or_bytes) buffers tokens; next_batch() returns a
    [batch, seq_len+1] int32 array or None. The same packing as
    train/data.py::pack_token_stream (tests/test_torch_native_packer.py).
    """

    def __init__(self, seq_len: int, batch_size: int):
        lib = _get_lib()
        if lib is None:
            raise RuntimeError(f"native packer unavailable: {_ERROR}")
        self._lib = lib
        self.seq_len = seq_len
        self.batch_size = batch_size
        self._h = lib.packer_new(seq_len, batch_size)
        if not self._h:
            raise RuntimeError(f"packer_new({seq_len}, {batch_size}) failed")

    def feed(self, data) -> None:
        if isinstance(data, str):
            data = data.encode("utf-8", errors="ignore")
        elif isinstance(data, np.ndarray):
            data = np.ascontiguousarray(data.astype(np.uint8)).tobytes()
        if data:
            self._lib.packer_feed(self._h, data, len(data))

    @property
    def ready(self) -> int:
        return int(self._lib.packer_ready(self._h))

    @property
    def buffered_tokens(self) -> int:
        return int(self._lib.packer_buffered(self._h))

    def next_batch(self) -> Optional[np.ndarray]:
        out = np.empty((self.batch_size, self.seq_len + 1), np.int32)
        ok = self._lib.packer_next(self._h, out.ctypes.data_as(ctypes.c_void_p))
        return out if ok else None

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.packer_free(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - GC timing
        self.close()
