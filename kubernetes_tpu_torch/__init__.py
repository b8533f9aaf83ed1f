"""kubernetes_tpu_torch — the PyTorch/CUDA port of kubernetes_tpu.

The JAX package `kubernetes_tpu` stays the reference. This package mirrors
its module paths and names, so each module here has a counterpart there,
and it imports neither `jax` nor anything of `kubernetes_tpu`: host-only
modules are carried over as copies.

Layout (the slice ported so far):
  api/        typed API objects, Quantity math, label selectors (copies)
  utils/      serde, metrics, tracing, configz (copies), devtime and the
              knobs this package reads
  scheduler/  the backend (tpu_backend.py: the session ladder, the
              dispatch/harvest pipeline, churn through the cache listener,
              fault recovery) and what it stands on: the scheduler cache,
              framework types, degradation ladder, metrics (copies or ports)
  models/     dense cluster encoding; its device half holds torch tensors
  testing/    synthetic cluster generators (copy), the churn classifiers'
              wrappers and the fault injector
  ops/        the per-template prologue in torch, the batched scan session
              and its hand-written CUDA kernel (ops/csrc/)
  device.py   device resolution: CUDA unless the caller asks for the CPU
"""
