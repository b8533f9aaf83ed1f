"""The port's ktpu-lint (kubernetes_tpu_torch/analysis/, ROADMAP.md
Queue 1, slice 10g) holds to the reference's own cases and lints the
port.

  * the reference's tests/test_static_analysis.py cases run on the port
    through tests/_dual.py: the fixture corpus at the mirrored
    `kubernetes_tpu_torch/...` paths, pragmas, line-free keys, the
    baseline round trip, and `test_repo_clean`,
    `test_baseline_only_shrinks` and `test_no_stale_baseline_entries`
    over `kubernetes_tpu_torch/` with its empty baseline. The reference's
    fixtures are read from tests/fixtures/lint/ and fed to the port's
    checkers with `kubernetes_tpu` rewritten to the port's package, in
    memory, as _dual.py rewrites the test module (inert_flag.py imports
    the reference's cache, which the port's deny list names as the
    port's). Only the port's side runs here: test_static_analysis.py
    runs the reference's, so no two workers write one lint cache;
  * parity: on every reference fixture, at every path class the
    checkers gate on, the reference's checkers and the port's report the
    same (checker, code, line, scope), waived or not;
  * the torch sinks (tests/fixtures/lint_torch/): each is flagged in a
    hot module and nowhere in a cold one, and pragmas waive them;
  * the CLI, `python -m kubernetes_tpu_torch.analysis`, its knob table
    against the README's port span, and the pragma audit's groups.

The linter is stdlib-ast only, so this module runs in seconds."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from kubernetes_tpu.analysis import core as ref_core
from kubernetes_tpu.analysis import (decision_inert as ref_inert,
                                     host_sync as ref_host_sync,
                                     knob_registry as ref_knob,
                                     lock_order as ref_lock,
                                     seam_pairing as ref_seam)
from kubernetes_tpu_torch.analysis import (core, decision_inert, host_sync,
                                           knob_registry, lock_order,
                                           manifests, seam_pairing)
from kubernetes_tpu_torch.analysis import __main__ as cli

from ._dual import _REF, cases, module_for, run_case

ROOT = Path(__file__).resolve().parents[1]
PORT = "kubernetes_tpu_torch"
FIXTURES = ROOT / "tests" / "fixtures" / "lint"
TORCH_FIXTURES = ROOT / "tests" / "fixtures" / "lint_torch"


def port_text(text: str) -> str:
    """A reference fixture's text as the port's checkers read it."""
    return _REF.sub(PORT, text)


def _port_module():
    mod = module_for("test_static_analysis", PORT)
    if not getattr(mod, "_port_fixtures", False):
        read = mod.read_fixture
        mod.read_fixture = lambda name: port_text(read(name))
        mod._port_fixtures = True
    return mod


CASES = cases("test_static_analysis")


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_reference_case_on_port(case, request):
    _port_module()
    run_case(request, PORT, case)


def test_every_reference_case_runs():
    """The reference's cases, none left off: the repo gate's four among
    them."""
    ids = {c.id for c in CASES}
    assert len(CASES) == 32
    for name in ("test_repo_clean", "test_repo_warm_run_is_fast",
                 "test_baseline_only_shrinks",
                 "test_no_stale_baseline_entries"):
        assert f"test_static_analysis::TestRepoClean::{name}" in ids


# ---------------------------------------------------------------------------
# parity with the reference's checkers on the reference's fixtures

REF_CHECKERS = (ref_host_sync, ref_knob, ref_inert, ref_seam, ref_lock)
PORT_CHECKERS = (host_sync, knob_registry, decision_inert, seam_pairing,
                 lock_order)
# the path classes the checkers gate on, as reference-relative paths
PATHS = ("kubernetes_tpu/ops/fixture_case.py",          # hot
         "kubernetes_tpu/scheduler/tpu_backend.py",     # hot
         "kubernetes_tpu/utils/tracing.py",             # inert
         "kubernetes_tpu/scheduler/explain.py",         # inert
         "kubernetes_tpu/scheduler/fixture_case.py",    # any
         "kubernetes_tpu/utils/knobs.py",               # the registry
         "kubernetes_tpu/scheduler/metrics.py")         # seam-exempt
# sites the port's torch sinks add on a reference fixture: none (the
# reference's fixtures call no .tolist() / .cpu() / .numpy() / .to() /
# .synchronize())
TORCH_EXTRA = {}


def _lint(core_mod, checkers, lock_mod, rel, src):
    tree = ast.parse(src)
    pragmas = core_mod.Pragmas(src, tree)
    scope_of = core_mod.enclosing_func(tree)
    facts = {}
    out = []
    for checker in checkers:
        rule = core_mod.CHECKER_TO_RULE[checker.CHECKER]
        for v in checker.check_file(rel, tree, src, scope_of, facts):
            waived = pragmas.waiver(rule, v.line) is not None
            out.append((v.checker, v.code, v.line, v.func, waived))
    for v in lock_mod.check_global("", {rel: facts}):
        out.append((v.checker, v.code, v.line, v.func, False))
    return sorted(out), facts


FIXTURE_NAMES = sorted(p.name for p in FIXTURES.glob("*.py"))


@pytest.mark.parametrize("rel", PATHS)
@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_checker_parity_on_reference_fixtures(name, rel):
    src = (FIXTURES / name).read_text()
    ref, ref_facts = _lint(ref_core, REF_CHECKERS, ref_lock, rel, src)
    port, port_facts = _lint(core, PORT_CHECKERS, lock_order,
                             port_text(rel), port_text(src))
    assert port == sorted(ref + TORCH_EXTRA.get((name, rel), []))
    assert json.dumps(port_facts, sort_keys=True) == \
        port_text(json.dumps(ref_facts, sort_keys=True))


def test_parity_sees_every_checker_fire():
    """The parity cases are not vacuous: across the fixtures and paths the
    reference's checkers report every code of their fixture corpus."""
    codes = set()
    for p in FIXTURES.glob("*.py"):
        for rel in PATHS:
            codes |= {c[1] for c in _lint(ref_core, REF_CHECKERS, ref_lock,
                                          rel, p.read_text())[0]}
    assert codes >= {"item-call", "scalar-coerce", "numpy-readback",
                     "device-get", "block-until-ready", "env-read",
                     "inert-deny-import", "inert-mutation-call",
                     "seam-unpaired", "lock-cycle"}


# ---------------------------------------------------------------------------
# the torch sinks

HOT = "kubernetes_tpu_torch/ops/fixture_case.py"
COLD = "kubernetes_tpu_torch/utils/fixture_case.py"
TORCH_CODES = {"torch-tolist", "torch-cpu", "torch-numpy", "torch-to-cpu",
               "torch-synchronize", "torch-event-sync"}


def _host_sync(rel, name):
    src = (TORCH_FIXTURES / name).read_text()
    tree = ast.parse(src)
    pragmas = core.Pragmas(src, tree)
    found = host_sync.check_file(rel, tree, src, core.enclosing_func(tree),
                                 {})
    live = [v for v in found if pragmas.waiver("sync", v.line) is None]
    waived = [(v, pragmas.waiver("sync", v.line)) for v in found
              if pragmas.waiver("sync", v.line) is not None]
    return live, waived


def test_torch_flag_corpus_catches_every_sink():
    live, waived = _host_sync(HOT, "host_sync_flag.py")
    assert waived == []
    got = sorted((v.line, v.code) for v in live)
    src = (TORCH_FIXTURES / "host_sync_flag.py").read_text().splitlines()
    # every line marked with a code in the fixture is flagged with it
    want = sorted((i + 1, code) for i, line in enumerate(src)
                  for code in TORCH_CODES if f"# {code}" in line
                  or f", {code}" in line)
    assert got == want
    assert {c for _, c in got} == TORCH_CODES
    assert sum(c == "torch-to-cpu" for _, c in got) == 2
    assert sum(c == "torch-event-sync" for _, c in got) == 2


def test_torch_sinks_quiet_in_cold_modules():
    for name in ("host_sync_flag.py", "host_sync_pass.py"):
        assert _host_sync(COLD, name) == ([], [])


def test_torch_pass_corpus_is_clean_and_pragmas_waive():
    live, waived = _host_sync(HOT, "host_sync_pass.py")
    assert live == []
    # the pragma'd sites are reported as allowed, with their reasons
    assert sorted({v.code for v, _ in waived}) == [
        "torch-cpu", "torch-numpy", "torch-synchronize", "torch-tolist"]
    assert all(r.startswith("fixture: ") for _, r in waived)
    assert len(waived) == 5


def test_to_cpu_reads_the_device_argument():
    call = lambda s: ast.parse(s).body[0].value  # noqa: E731
    assert host_sync._torch_to_cpu(call('x.to("cpu")'))
    assert host_sync._torch_to_cpu(call('x.to(device="cpu")'))
    assert host_sync._torch_to_cpu(call('x.to("cpu", non_blocking=True)'))
    for s in ('x.to("cuda")', "x.to(dev)", "x.to(torch.int32)",
              'x.to(dtype=torch.float32)', 'x.to(device="cuda:0")'):
        assert not host_sync._torch_to_cpu(call(s)), s


# ---------------------------------------------------------------------------
# the port's own policy and its audit

def test_manifests_name_the_port():
    """Every path and dotted module of the port's policy names the port's
    package and an existing module; the lists match the reference's
    entry for entry."""
    from kubernetes_tpu.analysis import manifests as ref

    def mirrored(xs):
        return tuple(_REF.sub(PORT, x) for x in xs)

    assert manifests.HOT_PATHS == mirrored(ref.HOT_PATHS)
    assert manifests.DECISION_INERT_MODULES == mirrored(
        ref.DECISION_INERT_MODULES)
    assert manifests.INERT_DENY_IMPORTS == mirrored(ref.INERT_DENY_IMPORTS)
    assert manifests.SEAM_EXEMPT_MODULES == mirrored(ref.SEAM_EXEMPT_MODULES)
    assert manifests.KNOBS_MODULE == _REF.sub(PORT, ref.KNOBS_MODULE)
    assert manifests.DEVICE_ROOTS == ref.DEVICE_ROOTS | {"torch"}
    for rel in (*manifests.HOT_PATHS, *manifests.DECISION_INERT_MODULES,
                *manifests.SEAM_EXEMPT_MODULES, manifests.KNOBS_MODULE):
        assert (ROOT / rel).exists(), rel
    for dotted in manifests.INERT_DENY_IMPORTS:
        path = ROOT / dotted.replace(".", "/")
        assert path.with_suffix(".py").exists() or path.is_dir(), dotted
    # the taint's attribute and producer names are the port's own
    src = "".join(p.read_text() for p in (ROOT / PORT / "ops").glob("*.py"))
    for rel in ("models/encoding.py", "scheduler/tpu_backend.py"):
        src += (ROOT / PORT / rel).read_text()
    for attr in manifests.DEVICE_ATTRS:
        assert f".{attr}" in src, attr
    for fn in manifests.DEVICE_PRODUCERS:
        assert f"def {fn}(" in src, fn
    assert core.iter_py_files(str(ROOT))[0].startswith(PORT + "/")
    assert all(r.startswith(PORT + "/") for r in core.iter_py_files(
        str(ROOT)))


# every host-sync pragma on the port's hot path says which of these it is
AUDIT_GROUPS = ("session build:", "harvest decode:", "plain version:",
                "dispatch:", "devtime fence:", "host int:", "host column:",
                "pinned host buffer:")


def test_every_sync_pragma_names_its_group():
    report = core.run(use_cache=False)
    assert report.clean
    syncs = [a for a in report.allowed if a.checker == "host-sync"]
    assert syncs
    for a in syncs:
        assert a.path.startswith(PORT + "/") and host_sync._is_hot(a.path)
        assert a.reason.startswith(AUDIT_GROUPS), (a.path, a.line, a.reason)
    # the reference's readback sites have their counterparts here
    assert {a.code for a in syncs} >= {"torch-tolist", "torch-cpu",
                                       "scalar-coerce", "numpy-readback",
                                       "torch-event-sync"}


def test_knob_table_is_the_readme_span():
    """The README's port span is what `--knob-table` renders, and the
    port's check reads the span alone: the reference's table above it
    names knobs the port does not declare."""
    text = (ROOT / "README.md").read_text()
    span = knob_registry._knob_table_span(text)
    assert span != text
    assert span.strip() == cli.knob_table()
    from kubernetes_tpu_torch.utils import knobs

    assert set(manifests.KNOB_TOKEN_RE.findall(span)) == set(
        knobs.registry())
    whole = set(manifests.KNOB_TOKEN_RE.findall(text))
    assert whole - set(knobs.registry()), "the reference's knobs are there"
    assert knob_registry._knob_table_span("no markers\n") == "no markers\n"


def test_knob_check_reads_only_the_span(tmp_path, monkeypatch):
    """A stale token inside the span is reported; outside it, ignored."""
    (tmp_path / PORT / "utils").mkdir(parents=True)
    (tmp_path / PORT / "utils" / "knobs.py").write_text(
        '_declare("KTPU_X", "int", 1, "fixture knob")\n')
    b, e = manifests.KNOB_TABLE_BEGIN, manifests.KNOB_TABLE_END
    readme = tmp_path / "README.md"
    readme.write_text(f"KTPU_OLD\n{b}\nKTPU_X\n{e}\n")
    assert knob_registry.check_global(str(tmp_path), {}) == []
    readme.write_text(f"{b}\nKTPU_X KTPU_OLD\n{e}\n")
    assert [v.code for v in knob_registry.check_global(str(tmp_path), {})] \
        == ["knob-unknown-readme"]
    readme.write_text(f"{b}\n{e}\nKTPU_X\n")
    assert [v.code for v in knob_registry.check_global(str(tmp_path), {})] \
        == ["knob-missing-readme"]


def test_knob_missing_names_the_port_cli(tmp_path):
    """A knob missing from the span is regenerated by the port's CLI,
    whose --knob-table renders the port's table, not the reference's."""
    (tmp_path / PORT / "utils").mkdir(parents=True)
    (tmp_path / PORT / "utils" / "knobs.py").write_text(
        '_declare("KTPU_X", "int", 1, "fixture knob")\n')
    b, e = manifests.KNOB_TABLE_BEGIN, manifests.KNOB_TABLE_END
    (tmp_path / "README.md").write_text(f"{b}\n{e}\n")
    got = knob_registry.check_global(str(tmp_path), {})
    assert [v.code for v in got] == ["knob-missing-readme"]
    assert f"{manifests.CLI} --knob-table" in got[0].message
    assert "scripts/lint.py" not in got[0].message


# ---------------------------------------------------------------------------
# the CLI

def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "kubernetes_tpu_torch.analysis", *args],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        capture_output=True, text=True, timeout=120)


def test_cli_lints_the_port_clean():
    res = _cli("--json", "--no-cache")
    assert res.returncode == 0, res.stdout + res.stderr
    report = json.loads(res.stdout)
    assert report["clean"] and report["violations"] == []
    assert report["files_checked"] == len(core.iter_py_files(str(ROOT)))
    res = _cli("--explain")
    assert res.returncode == 0
    assert "pragma-waived site(s)" in res.stdout
    assert "ktpu-lint: 0 violation(s), 0 baselined" in res.stdout


def test_cli_update_baseline_and_knob_table(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(core, "BASELINE_PATH", str(tmp_path / "b.json"))
    monkeypatch.setattr(core, "CACHE_PATH", str(tmp_path / "c.json"))
    assert cli.main(["--update-baseline"]) == 0
    assert "baseline re-recorded: 0 grandfathered entries" in \
        capsys.readouterr().out
    assert (tmp_path / "b.json").read_text() == \
        (ROOT / PORT / "analysis" / "baseline.json").read_text()
    assert cli.main(["--knob-table"]) == 0
    assert capsys.readouterr().out.strip() == cli.knob_table()
