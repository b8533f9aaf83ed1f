"""Fixture: every torch host-sync sink fires (checked as a hot-path
file)."""
import torch


def readbacks(ys):
    total = torch.sum(ys)
    rows = total.tolist()              # torch-tolist
    host = ys.cpu()                    # torch-cpu
    arr = host.numpy()                 # torch-numpy (host is tainted too)
    back = ys.to("cpu")                # torch-to-cpu
    kw = total.to(device="cpu")        # torch-to-cpu
    torch.cuda.synchronize()           # torch-synchronize
    return rows, arr, back, kw


def waits(n):
    ev = torch.cuda.Event()
    ev.record()
    ev.synchronize()                   # torch-event-sync
    torch.cuda.current_stream().synchronize()   # torch-event-sync
    out = torch.zeros(n)
    return out.tolist()                # torch-tolist through torch.zeros


def propagation(carry):
    a, b = carry["x"] * 2, carry["y"]
    return a.cpu(), b.numpy()          # torch-cpu, torch-numpy via unpack
