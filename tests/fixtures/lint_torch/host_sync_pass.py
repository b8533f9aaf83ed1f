"""Fixture: host-only code, device-to-device moves and pragma'd
intentional torch syncs -> clean."""
import numpy as np
import torch


def host_only(rows):
    arr = np.asarray(rows)
    return arr.tolist(), int(arr.shape[0])   # numpy, not torch


def stays_on_device(ys, dev):
    a = ys.to(dev)                     # to a device: no host copy
    b = ys.to(torch.int32)             # a dtype change on its device
    c = ys.to("cuda", non_blocking=True)
    return a, b, c, ys.shape[0], ys.dtype    # metadata never syncs


# ktpu: allow-sync(fixture: harvest decode reads verdicts by design)
def pragma_function(ys):
    return ys.cpu().numpy().tolist()


def pragma_line(ys):
    total = torch.sum(ys)
    # ktpu: allow-sync(fixture: measured fence inside a timing window)
    torch.cuda.synchronize()
    return total.tolist()  # ktpu: allow-sync(fixture: one intended readback)
