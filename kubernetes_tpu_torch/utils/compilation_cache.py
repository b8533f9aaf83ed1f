"""The kernel build directory, reused across processes.

Counterpart of kubernetes_tpu/utils/compilation_cache.py. There the cache
holds jax's compiled executables; here it is the directory that
ops/build.py compiles the CUDA sources into. A library already there and
newer than its sources is loaded as it is, so only the first process after
a source change pays `nvcc`.

The entry points call `enable_persistent_cache()` before they build
(chip_smoke.py does); tests leave the default.
"""

from __future__ import annotations

import os
from pathlib import Path

from . import knobs

DEFAULT_CACHE_DIR = str(
    Path(__file__).resolve().parents[2] / "build" / "torch_kernels")


def enable_persistent_cache(path: str = "") -> str:
    """Point ops/build.py at the build directory; returns it.

    Honors KTPU_COMPILATION_CACHE: a directory, or "0"/"off"/"disable"
    for no reuse (every build compiles anew, into the default directory),
    in which case "" is returned as the reference does."""
    from ..ops import build

    env = knobs.get_str("KTPU_COMPILATION_CACHE")
    if env.lower() in ("0", "off", "disable"):
        build.BUILD_DIR = Path(DEFAULT_CACHE_DIR)
        build.REUSE = False
        return ""
    cache_dir = path or env or DEFAULT_CACHE_DIR
    os.makedirs(cache_dir, exist_ok=True)
    build.BUILD_DIR = Path(cache_dir)
    build.REUSE = True
    return cache_dir
