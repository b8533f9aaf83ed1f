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
    "apiserver/http.py", "apiserver/auth.py", "apiserver/flowcontrol.py",
    "apiserver/audit.py", "apiserver/webhook.py", "apiserver/crd.py",
    "apiserver/aggregator.py", "utils/featuregate.py",
    "controllers/__init__.py", "controllers/base.py",
    "controllers/volumeprotection.py", "apiserver/admission.py",
    "controllers/replicaset.py", "controllers/deployment.py",
    "controllers/daemonset.py", "controllers/statefulset.py",
    "controllers/job.py", "controllers/namespace.py",
    "controllers/garbagecollector.py", "controllers/endpoints.py",
    "controllers/nodelifecycle.py",
)
# the controllers and admission (ROADMAP.md Queue 1, 10a): all verbatim;
# the manager, which imports every controller, is not ported yet
CONTROLLER_SLICE = tuple(
    r for r in VERBATIM
    if r.startswith("controllers/") or r == "apiserver/admission.py")


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


def test_whatif_modules_are_checked():
    """The what-if planner's modules are among the sources the two checks
    above read."""
    for rel in ("kubernetes_tpu_torch/ops/whatif.py",
                "kubernetes_tpu_torch/ops/whatif_kernel.py",
                "kubernetes_tpu_torch/scheduler/preemption_device.py"):
        assert rel in PORT_SOURCES
        assert ".".join(Path(rel).with_suffix("").parts) in PORT_MODULES


def test_matrix_slice_modules_are_checked():
    """The modules the HTTP apiserver, schedule_batch and the kernel build
    cache brought are among the sources the two checks above read."""
    for rel in ("apiserver/http.py", "apiserver/auth.py",
                "apiserver/flowcontrol.py", "apiserver/audit.py",
                "apiserver/webhook.py", "apiserver/crd.py",
                "apiserver/aggregator.py", "utils/featuregate.py",
                "ops/batch.py", "utils/compilation_cache.py"):
        rel = f"kubernetes_tpu_torch/{rel}"
        assert rel in PORT_SOURCES
        assert ".".join(Path(rel).with_suffix("").parts) in PORT_MODULES


def test_mesh_slice_modules_are_checked():
    """The mesh's modules (parallel/, the sharded session) are among the
    sources the two checks above read, and import with jax blocked."""
    for rel in ("parallel/__init__.py", "parallel/partition.py",
                "parallel/sharded.py", "ops/sharded_scan.py"):
        rel = f"kubernetes_tpu_torch/{rel}"
        assert rel in PORT_SOURCES
        mod = ".".join(Path(rel).with_suffix("").parts).removesuffix(
            ".__init__")
        assert mod in PORT_MODULES


def test_controller_slice_modules_are_checked():
    """The controllers and admission are among the sources the two
    checks above read (no jax, nothing of the reference), import with jax
    and the reference blocked, and are held verbatim; the manager is not
    ported with them."""
    assert len(CONTROLLER_SLICE) == 13
    for rel in CONTROLLER_SLICE:
        rel = f"kubernetes_tpu_torch/{rel}"
        assert rel in PORT_SOURCES
        mod = ".".join(Path(rel).with_suffix("").parts).removesuffix(
            ".__init__")
        assert mod in PORT_MODULES
    assert "kubernetes_tpu_torch.controllers" in PORT_MODULES
    assert "kubernetes_tpu_torch.apiserver.admission" in PORT_MODULES
    assert not (PORT / "controllers" / "manager.py").exists()


def test_compilation_cache_moves_the_build_dir(tmp_path, monkeypatch):
    """enable_persistent_cache points ops/build.py at its directory (the
    argument, else KTPU_COMPILATION_CACHE, else build/torch_kernels), where
    a library newer than its source is reused; "off" reuses nothing."""
    from kubernetes_tpu_torch.ops import build
    from kubernetes_tpu_torch.utils import compilation_cache as cc

    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    monkeypatch.setattr(build, "REUSE", build.REUSE)
    monkeypatch.delenv("KTPU_COMPILATION_CACHE", raising=False)
    assert cc.enable_persistent_cache() == cc.DEFAULT_CACHE_DIR
    assert build.BUILD_DIR == ROOT / "build" / "torch_kernels"
    src = tmp_path / "k.cu"
    src.write_text("// kernel\n")
    for where, args in ((tmp_path / "a", (str(tmp_path / "a"),)),
                        (tmp_path / "b", ())):
        if not args:
            monkeypatch.setenv("KTPU_COMPILATION_CACHE", str(where))
        assert cc.enable_persistent_cache(*args) == str(where)
        assert build.BUILD_DIR == where and where.is_dir()
        lib = build.library_path(src)
        assert lib.parent == where and build._stale(src)
        lib.write_bytes(b"")
        os.utime(lib, (src.stat().st_mtime + 10,) * 2)
        assert not build._stale(src)          # reused
    for off in ("0", "off", "disable"):
        monkeypatch.setenv("KTPU_COMPILATION_CACHE", off)
        assert cc.enable_persistent_cache(str(tmp_path / "b")) == ""
        assert build.BUILD_DIR == ROOT / "build" / "torch_kernels"
        monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "b")
        assert build._stale(src)              # never reused
        build._BUILT.add(build.library_path(src))
        assert not build._stale(src)          # but built once a process
        build._BUILT.clear()


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
