"""Builds the port's CUDA sources into shared libraries and loads them.

Each source under `csrc/` (and `probes/csrc/`) is compiled by `nvcc` into
its own library with a plain C interface, `build/torch_kernels/lib<stem>.so`
at the repository root (gitignored), rebuilt when the source or a header it
may include is newer than the library, and loaded with ctypes. `build`
starts one `nvcc` per stale source, all at once, and waits for them
together. Nothing here runs at import: the CPU tests import every module,
and there is no `nvcc` without the CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-fmad=false")

# headers a source may include (the scan kernel's argument set)
HEADER_DIR = Path(__file__).resolve().parent / "csrc"

_LIBS: Dict[Path, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    return str(path) if path.exists() else "nvcc"


def library_path(source: Path) -> Path:
    return BUILD_DIR / f"lib{Path(source).stem}.so"


def _stale(source: Path) -> bool:
    """The library is missing, or older than its source or a header."""
    out = library_path(source)
    if not out.exists():
        return True
    inputs = [source, *source.parent.glob("*.cuh"),
              *HEADER_DIR.glob("*.cuh")]
    return out.stat().st_mtime < max(p.stat().st_mtime for p in inputs)


def build(sources: Iterable[Path], verbose: bool = False
          ) -> Dict[Path, float]:
    """Compile every source whose library is missing or older than it,
    one `nvcc` process per source, all started together. Returns the
    wall seconds until each source's library was in place (0.0 where it
    was reused). Raises RuntimeError with the compiler's output if one
    fails; with `verbose` prints ptxas's register and spill report."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    seconds = {}
    for src in map(Path, sources):
        if not _stale(src):
            seconds[src] = 0.0
            continue
        out = library_path(src)
        tmp = out.with_suffix(f".{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(HEADER_DIR), "-o", str(tmp),
               str(src)]
        if verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    failed = []
    for src, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[src] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src.name} ({proc.returncode}):"
                          f"\n{log}")
            continue
        if verbose and log:
            print(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def load(source: Path) -> ctypes.CDLL:
    """The source's library, built if it is stale, loaded once per
    process."""
    source = Path(source)
    lib = _LIBS.get(source)
    if lib is None:
        build([source])
        lib = _LIBS[source] = ctypes.CDLL(str(library_path(source)))
    return lib
