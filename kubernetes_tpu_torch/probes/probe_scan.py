"""probe_scan and probe_int64: the Hopper counterparts of the TPU probe
scripts/probe_pallas.py (`run`, :19-61, and the int64 kernel, :64-77).

probe_scan asks how much one sequential step costs when it is the scan
kernel stripped to its skeleton: fit, score, first-max argmax, and the
update of the chosen node, B = 512 steps over N = 5120 f32 lanes, the
scratch row `util` in shared memory (the TPU's VMEM scratch). Every node
fits 6 pods of 0.5 in 3.0, so the first decisions are 0, 1, 2, ...
probe_int64 checks int64 arithmetic inside a kernel.

    python -m kubernetes_tpu_torch.probes.probe_scan
"""

from __future__ import annotations

import torch

from . import check, event_ms, lib, stream

B, N = 512, 5120          # the TPU probe's steps and padded node axis
OUT_LANES = 128

# kernel launches per wrapper; the plain versions do not count
LAUNCHES = {"probe_scan": 0, "probe_int64": 0}


def inputs(device) -> tuple:
    """The TPU probe's inputs: req f32 [B, 1] of 0.5, alloc f32 [1, N] of
    3.0."""
    req = torch.full((B, 1), 0.5, dtype=torch.float32, device=device)
    alloc = torch.full((1, N), 3.0, dtype=torch.float32, device=device)
    return req, alloc


def _check_inputs(req, alloc) -> None:
    if req.dtype != torch.float32 or alloc.dtype != torch.float32 \
            or req.dim() != 2 or req.shape[1] != 1 or alloc.dim() != 2 \
            or alloc.shape[0] != 1 or req.device != alloc.device \
            or not (req.is_contiguous() and alloc.is_contiguous()):
        raise ValueError("probe_scan: req must be f32 [B, 1] and alloc f32 "
                         "[1, N], contiguous, on one device")


def probe_scan(req: torch.Tensor, alloc: torch.Tensor) -> torch.Tensor:
    """out int32 [B, 128]: row b is step b's chosen lane. CPU tensors go to
    the plain version, CUDA tensors to the kernel."""
    _check_inputs(req, alloc)
    if req.device.type == "cpu":
        return probe_scan_reference(req, alloc)
    steps, n = req.shape[0], alloc.shape[1]
    out = torch.empty((steps, OUT_LANES), dtype=torch.int32,
                      device=req.device)
    check("probe_scan", lib().probe_scan_launch(
        req.data_ptr(), alloc.data_ptr(), out.data_ptr(), steps, n,
        stream(req.device)))
    LAUNCHES["probe_scan"] += 1
    return out


def probe_scan_reference(req: torch.Tensor,
                         alloc: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the TPU kernel's body, step by step."""
    steps, n = req.shape[0], alloc.shape[1]
    util = torch.zeros(n, dtype=torch.float32, device=req.device)
    a = alloc[0]
    out = torch.empty((steps, OUT_LANES), dtype=torch.int32,
                      device=req.device)
    for b in range(steps):
        r = req[b, 0]
        fits = util + r <= a
        score = torch.where(fits, a - util, torch.full_like(util, -1.0))
        best = torch.argmax(score)            # the first maximum
        util[best] += r
        out[b] = best.to(torch.int32)
    return out


def probe_int64(a: torch.Tensor) -> torch.Tensor:
    """o = a * 2 + 1 on an int64 tensor."""
    if a.dtype != torch.int64 or not a.is_contiguous():
        raise ValueError("probe_int64: a must be a contiguous int64 tensor")
    if a.device.type == "cpu":
        return probe_int64_reference(a)
    o = torch.empty_like(a)
    check("probe_int64", lib().probe_int64_launch(
        a.data_ptr(), o.data_ptr(), a.numel(), stream(a.device)))
    LAUNCHES["probe_int64"] += 1
    return o


def probe_int64_reference(a: torch.Tensor) -> torch.Tensor:
    return a * 2 + 1


def int64_input(device) -> torch.Tensor:
    """The TPU probe's input: arange(8 * 128) as int64 [8, 128]."""
    return torch.arange(8 * 128, dtype=torch.int64,
                        device=device).reshape(8, 128)


def main() -> int:
    req, alloc = inputs("cuda")
    out = probe_scan(req, alloc)
    times = event_ms(lambda: probe_scan(req, alloc))
    first = out[:8, 0].tolist()
    ok = torch.equal(out, probe_scan_reference(req, alloc))
    print(f"probe_scan B={B} N={N}: {min(times):.3f} ms "
          f"({min(times) / B * 1e3:.2f} us/step); first 8 decisions: {first}; "
          f"== plain version: {ok}")
    a = int64_input("cuda")
    r = probe_int64(a)
    ok64 = torch.equal(r, probe_int64_reference(a))
    print(f"int64 in a kernel: {r[0, :3].tolist()}; == plain version: {ok64}")
    return 0 if ok and ok64 and first == list(range(8)) else 1


if __name__ == "__main__":
    raise SystemExit(main())
