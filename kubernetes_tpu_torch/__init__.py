"""kubernetes_tpu_torch — the PyTorch/CUDA port of kubernetes_tpu.

The JAX package `kubernetes_tpu` stays the reference. This package mirrors
its module paths and names, so each module here has a counterpart there,
and it imports neither `jax` nor anything of `kubernetes_tpu`: host-only
modules are carried over as copies.

Layout (the slice ported so far):
  api/        typed API objects, Quantity math, label selectors (copies)
  utils/      serde (copy) and the knobs this package reads
  scheduler/  the host helpers the encoders need (partial copies)
  models/     dense cluster encoding; its device half holds torch tensors
  testing/    synthetic cluster generators (copy)
  ops/        the per-template prologue in torch, the batched scan session
              and its hand-written CUDA kernel (ops/csrc/)
  device.py   device resolution: CUDA unless the caller asks for the CPU
"""
