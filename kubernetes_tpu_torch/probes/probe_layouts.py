"""probe_layouts: the Hopper counterpart of the TPU probe
scripts/probe_pallas2.py (`try_kernel`, :12-74), which asked which scratch
and layout primitives a sequential-grid kernel could use. Three kernels
over B = 64 sequential steps, N = 5120 lanes, req f32 [64, 128], alloc f32
[1, 5120], out f32 [64, 128], with the scratch row `util` in shared memory:

- k1: scratch init and a row write, out[b] = req[b] + util[0];
- k2: adds the first-max argmax of alloc - util, out[b] = best;
- k3: adds the one-hot update util[best] += req[b, 0].

Each prints OK with its first decisions, or FAIL, and is held to its plain
version.

    python -m kubernetes_tpu_torch.probes.probe_layouts
"""

from __future__ import annotations

import torch

from . import check, lib, stream

B, N = 64, 5120
OUT_LANES = 128
KERNELS = {1: "k1 scratch init + row write", 2: "k2 + argmax",
           3: "k3 + one-hot update"}

# kernel launches (k1, k2 and k3); the plain version does not count
LAUNCHES = 0


def inputs(device) -> tuple:
    """The TPU probe's inputs: req f32 [B, 128] of 0.5, alloc f32 [1, N] of
    3.0."""
    req = torch.full((B, OUT_LANES), 0.5, dtype=torch.float32, device=device)
    alloc = torch.full((1, N), 3.0, dtype=torch.float32, device=device)
    return req, alloc


def probe_layouts(k: int, req: torch.Tensor,
                  alloc: torch.Tensor) -> torch.Tensor:
    """Kernel k (1, 2 or 3) over req's B steps: out f32 [B, 128]. CPU
    tensors go to the plain version, CUDA tensors to the kernel."""
    global LAUNCHES
    if k not in KERNELS:
        raise ValueError(f"probe_layouts: kernel {k} is not one of 1, 2, 3")
    if req.dtype != torch.float32 or alloc.dtype != torch.float32 \
            or req.dim() != 2 or req.shape[1] != OUT_LANES \
            or alloc.dim() != 2 or alloc.shape[0] != 1 \
            or req.device != alloc.device \
            or not (req.is_contiguous() and alloc.is_contiguous()):
        raise ValueError("probe_layouts: req must be f32 [B, 128] and alloc "
                         "f32 [1, N], contiguous, on one device")
    if req.device.type == "cpu":
        return probe_layouts_reference(k, req, alloc)
    out = torch.empty_like(req)
    check(f"probe_layouts k{k}", lib().probe_layouts_launch(
        k, req.data_ptr(), alloc.data_ptr(), out.data_ptr(), req.shape[0],
        alloc.shape[1], stream(req.device)))
    LAUNCHES += 1
    return out


def probe_layouts_reference(k: int, req: torch.Tensor,
                            alloc: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel k: the TPU bodies k1-k3, step by
    step."""
    steps, n = req.shape[0], alloc.shape[1]
    util = torch.zeros(n, dtype=torch.float32, device=req.device)
    a = alloc[0]
    out = torch.empty_like(req)
    for b in range(steps):
        if k == 1:
            out[b] = req[b] + util[0]
            continue
        best = torch.argmax(a - util)         # the first maximum
        if k == 3:
            util[best] += req[b, 0]
        out[b] = best.to(torch.float32)
    return out


def main() -> int:
    req, alloc = inputs("cuda")
    ok = True
    for k, name in KERNELS.items():
        try:
            out = probe_layouts(k, req, alloc)
            same = torch.equal(out, probe_layouts_reference(k, req, alloc))
        except RuntimeError as e:
            print(f"{name}: FAIL {e}")
            ok = False
            continue
        ok = ok and same
        status = "OK" if same else "FAIL (differs from the plain version)"
        print(f"{name}: {status}; decisions: {out[:8, 0].tolist()}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
