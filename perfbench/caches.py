"""Every build and kernel cache of the system at a fixed path inside the
checkout, so that only a checkout's first run builds and compiles. Called
by the entry scripts before anything imports torch."""

import os
from pathlib import Path

CACHE = Path(__file__).resolve().parents[1] / ".perfbench_cache"


def use_checkout_caches() -> None:
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
