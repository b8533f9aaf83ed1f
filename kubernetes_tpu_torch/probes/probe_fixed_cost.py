"""probe_fixed_cost: the Hopper counterpart of the TPU probe
scripts/probe_fixed_cost.py (:17-70), which asked whether a scan launch's
fixed cost is the staging of its arguments or the program. A trivial
kernel takes the scan kernel's own argument set through the same path: the
ctypes call with a pointer array in ArgPtr order and an integer array in
ArgDim order (ops/scan_kernel.py ARG_PTRS, ops/csrc/scan_args.cuh), the
same parameter block, one block of 1024 threads and the same dynamic
shared memory, at the TPU probe's shapes (Np = 5248, VZ = 128, TCp = 32,
Bp = 1024, a 216-entry scalar table). Its body sets out [8, Bp] to -1 and
adds one B_real times. The TPU copied the four carries through
input/output aliases; CUDA updates them in place, so none is copied.

It reports the first launch of the kernel in the process (its library
loaded just before) and the minimum of 4 steady launches, each as host
wall time (submit to synchronize) and as CUDA-event time, and the minimum
of 4 launches with B_real = 0 (the body reduced to the -1 fill), the
launch alone.

    python -m kubernetes_tpu_torch.probes.probe_fixed_cost
"""

from __future__ import annotations

import ctypes
from typing import Dict, List

import torch

from ..ops.scan_kernel import ARG_PTRS, MODE_FULL, n_scalars, smem_bytes
from . import check, lib, stream, time_launch

# the TPU probe's shapes, and the template/constraint/resource counts that
# give its TCp and its 216 scalars
Np, VZ, TCp, Bp = 5248, 128, 32, 1024
T, C, R, SR, K, CP = 4, 2, 11, 8, 1, 8
RP = 16
STEADY = 4

# kernel launches; the plain version does not count
LAUNCHES = 0


def arguments(device) -> tuple:
    """(tensors by ARG_PTRS name, dims in ArgDim order) of a scan launch
    at the probe's shapes: zero statics and carries, B_real = Bp."""
    i32, f32 = torch.int32, torch.float32

    def z(*shape, dtype=i32):
        return torch.zeros(shape, dtype=dtype, device=device)

    meta = z(1 + Bp)
    meta[0] = Bp
    tensors = {
        "meta": meta, "match": z(Bp, 256, dtype=torch.int8),
        "scalars": z(n_scalars(T, C, R, 0)), "alloc": z(RP, Np),
        "stat": z(T * SR, Np), "zid": z(K, Np), "regrow_f": z(TCp, Np),
        "zvalid_node_s": z(TCp, Np), "zvalid_s": z(TCp, VZ),
        "konn_f": z(TCp, Np), "konn_s": z(TCp, Np), "shasall": z(8, Np),
        "valid_n": z(8, Np), "prow_f": z(TCp, Np), "prow_s": z(TCp, Np),
        "logw": z(Np + 2, dtype=f32), "gmat": z(8, 128, dtype=f32),
        "requested": z(RP, Np), "nzpc": z(8, Np), "cnt_fn": z(TCp, Np),
        "cnt_sn": z(TCp, Np), "out": z(8, Bp), "work": z(3, Np),
    }
    dims = [T, C, Np, R, SR, TCp, K, CP, Bp, 0, smem_bytes(T, C, R, 0),
            MODE_FULL, 1, 0, RP, *[1] * 8]
    return tensors, dims


def fixed_cost(tensors: Dict[str, torch.Tensor], dims: List[int]) -> None:
    """One launch of the trivial kernel with the scan kernel's arguments;
    writes tensors["out"]. CPU tensors go to the plain version."""
    global LAUNCHES
    out = tensors["out"]
    if out.device.type == "cpu":
        out.copy_(fixed_cost_reference(tensors["meta"], out.shape[1]))
        return
    ptrs = [tensors[k].data_ptr() if k in tensors else 0 for k in ARG_PTRS]
    check("fixed_cost", lib().fixed_cost_launch(
        (ctypes.c_void_p * len(ptrs))(*ptrs),
        (ctypes.c_int * len(dims))(*dims), stream(out)))
    LAUNCHES += 1


def fixed_cost_reference(meta: torch.Tensor, bp: int) -> torch.Tensor:
    """Plain PyTorch version: out [8, Bp] = -1 plus B_real increments."""
    breal = max(int(meta[0]), 0)
    return torch.full((8, bp), -1 + breal, dtype=torch.int32,
                      device=meta.device)


def measure(device="cuda") -> Dict:
    """The first launch and the minimum of STEADY launches, host wall ms
    (submit to synchronize) and CUDA-event ms, the same with B_real = 0,
    and whether the out rows equal the plain version after each."""
    tensors, dims = arguments(device)
    lib()  # build and load outside the timed launches

    def run():
        fixed_cost(tensors, dims)

    first_wall, first_ev = time_launch(run)
    runs = [time_launch(run) for _ in range(STEADY)]
    ok = torch.equal(tensors["out"],
                     fixed_cost_reference(tensors["meta"], Bp))
    tensors["meta"][0] = 0
    empty = [time_launch(run) for _ in range(STEADY)]
    ok = ok and torch.equal(tensors["out"],
                            fixed_cost_reference(tensors["meta"], Bp))
    tensors["meta"][0] = Bp
    return {"first_wall_ms": first_wall, "first_event_ms": first_ev,
            "steady_wall_ms": min(r[0] for r in runs),
            "steady_event_ms": min(r[1] for r in runs),
            "empty_wall_ms": min(r[0] for r in empty),
            "empty_event_ms": min(r[1] for r in empty),
            "runs": runs, "equal": ok}


def main() -> int:
    m = measure()
    print(f"fixed cost, scan argument set at Np={Np} Bp={Bp}: first launch "
          f"{m['first_wall_ms']:.3f} ms wall / {m['first_event_ms']:.3f} ms "
          f"events; steady (min of {STEADY}) {m['steady_wall_ms']:.3f} ms "
          f"wall / {m['steady_event_ms']:.3f} ms events; B_real = 0 "
          f"{m['empty_wall_ms']:.3f} ms wall / {m['empty_event_ms']:.3f} ms "
          f"events; == plain version: {m['equal']}")
    return 0 if m["equal"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
