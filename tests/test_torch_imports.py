"""The PyTorch/CUDA port stands alone: it imports neither `jax` nor the
JAX package, its host-only modules are faithful copies, and its device
picker never falls back to the CPU unless asked."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from kubernetes_tpu_torch import device as port_device

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "kubernetes_tpu_torch"
PORT_SOURCES = sorted(p.relative_to(ROOT).as_posix()
                      for p in PORT.rglob("*.py")) + ["chip_smoke.py"]
PORT_MODULES = sorted(
    ".".join(Path(p).with_suffix("").parts).removesuffix(".__init__")
    for p in PORT_SOURCES if p.startswith("kubernetes_tpu_torch/")
)
# copied verbatim from the reference package (same relative path)
VERBATIM = (
    "api/__init__.py", "api/types.py", "api/quantity.py", "api/labels.py",
    "api/taints.py", "utils/serde.py", "models/vocab.py",
    "models/selectors.py", "testing/synth.py", "testing/__init__.py",
    "models/pod_encoder.py", "utils/metrics.py", "utils/tracing.py",
    "utils/configz.py", "utils/selfstats.py", "scheduler/metrics.py",
    "scheduler/core.py", "scheduler/framework/interface.py",
    "scheduler/framework/types.py", "scheduler/framework/snapshot.py",
    "scheduler/framework/runtime.py", "scheduler/internal/__init__.py",
    "scheduler/internal/cache.py", "scheduler/plugins/helper.py",
    "scheduler/plugins/volumes.py", "scheduler/volume_device.py",
    "volume/csi_translation.py",
    "api/storage.py", "api/apps.py", "api/autoscaling.py", "api/batch.py",
    "api/certificates.py", "api/discovery.py", "api/metrics.py",
    "api/networking.py", "api/rbac.py", "store/__init__.py", "store/wal.py",
    "store/kv.py", "apiserver/__init__.py", "apiserver/requestcontext.py",
    "apiserver/server.py", "client/__init__.py", "client/workqueue.py",
    "client/clientset.py", "client/informer.py", "client/events.py",
    "client/leaderelection.py", "volume/__init__.py", "volume/binder.py",
    "scheduler/plugins/nodebasic.py", "scheduler/plugins/noderesources.py",
    "scheduler/plugins/podtopologyspread.py",
    "scheduler/plugins/interpodaffinity.py", "scheduler/plugins/nodelabel.py",
    "scheduler/plugins/selectorspread.py",
    "scheduler/plugins/serviceaffinity.py",
    "scheduler/plugins/volumebinding.py",
    "scheduler/plugins/defaultpreemption.py",
    "scheduler/plugins/coscheduling.py", "scheduler/plugins/registry.py",
    "scheduler/apis/__init__.py", "scheduler/apis/config.py",
    "scheduler/apis/legacy.py", "scheduler/extender.py",
    "scheduler/internal/queue.py", "scheduler/internal/nominator.py",
    "scheduler/preemption.py", "scheduler/scheduler.py",
)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "kubernetes_tpu")


def test_every_port_module_imports_with_jax_blocked():
    """Each module imports in a fresh process whose meta path refuses
    jax and the reference package."""
    code = (
        "import importlib, sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'kubernetes_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'kubernetes_tpu')]\n"
        "print('imported', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "imported" in res.stdout


@pytest.mark.parametrize("rel", PORT_SOURCES)
def test_port_source_names_no_jax_or_reference_import(rel):
    tree = ast.parse((ROOT / rel).read_text(), filename=rel)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            # importlib.import_module("jax") and the like
            if node.value in ("jax", "jaxlib", "kubernetes_tpu") \
                    or node.value.startswith(("jax.", "kubernetes_tpu.")):
                bad.append(node.value)
    assert not bad, f"{rel} names {bad}"


@pytest.mark.parametrize("rel", VERBATIM)
def test_host_copy_is_verbatim(rel):
    assert (PORT / rel).read_text() == \
        (ROOT / "kubernetes_tpu" / rel).read_text()


def test_knob_defaults_match_reference():
    from kubernetes_tpu.utils import knobs as ref_knobs
    from kubernetes_tpu_torch.utils import knobs

    for name, knob in knobs.registry().items():
        ref = ref_knobs.registry()[name]
        assert (knob.kind, knob.default) == (ref.kind, ref.default), name


def test_resolve_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        port_device.resolve_device()
    with pytest.raises(RuntimeError):
        port_device.resolve_device("cuda")
    assert port_device.resolve_device("cpu") == torch.device("cpu")


def test_resolve_device_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert port_device.resolve_device() == torch.device("cuda")


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a card the smoke script exits non-zero and prints no
    result line."""
    res = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=tmp_path,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
