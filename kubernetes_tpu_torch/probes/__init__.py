"""Hopper probes: the counterparts of the TPU probe kernels in scripts/.

`probe_scan` (scripts/probe_pallas.py), `probe_layouts`
(scripts/probe_pallas2.py) and `probe_fixed_cost`
(scripts/probe_fixed_cost.py) each build their kernels from
`csrc/probes.cu` at first use, run them on CUDA tensors, keep a plain
PyTorch version of each beside its wrapper (which CPU tensors go to), count
their launches, and have a `main()`:

    python -m kubernetes_tpu_torch.probes.probe_scan
"""

from __future__ import annotations

import ctypes
import time
from pathlib import Path
from typing import Callable, List, Tuple

import torch

from ..ops import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "probes.cu"

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "probe_scan_launch": (_P, _P, _P, _I, _I, _P),
    "probe_int64_launch": (_P, _P, _I, _P),
    "probe_layouts_launch": (_I, _P, _P, _P, _I, _I, _P),
    "fixed_cost_launch": (ctypes.POINTER(_P), ctypes.POINTER(_I), _P),
}


def lib() -> ctypes.CDLL:
    """The probes' library, built from csrc/probes.cu if it is stale."""
    so = build.load(SOURCE)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(so, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return so


def check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def time_launch(fn: Callable[[], object]) -> Tuple[float, float]:
    """One call of `fn` on the card: (host wall ms from submit to
    synchronize, CUDA-event ms around it)."""
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    fn()
    e1.record()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, e0.elapsed_time(e1)


def event_ms(fn: Callable[[], object], runs: int = 3) -> List[float]:
    """CUDA-event ms of `runs` calls of `fn`, each alone."""
    return [time_launch(fn)[1] for _ in range(runs)]
