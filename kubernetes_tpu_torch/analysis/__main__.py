"""ktpu-lint CLI for the port (counterpart of scripts/lint.py).

Usage:
  python -m kubernetes_tpu_torch.analysis
                         lint kubernetes_tpu_torch/ (exit 1 on any
                         non-baselined violation)
  ... --explain          also list pragma-waived sites with their
                         reasons, and any baselined debt
  ... --json             machine-readable report on stdout
  ... --update-baseline  re-record analysis/baseline.json to the current
                         violation set
  ... --knob-table       print the README's port knob table from the
                         live registry (paste it between the README's
                         knob-table markers)
  ... --no-cache         ignore the per-file mtime cache

The checkers and their pragma rules (# ktpu: allow-<rule>(<reason>)):
  host-sync       sync        decision-inert  inert
  knob-registry   knob        seam-pairing    seam
  lock-order      lock
"""

import argparse
import json
import sys


def _default_label(knob, derived) -> str:
    if knob.default is derived:
        return "*(derived)*"
    if knob.default is None or knob.default == "":
        return "*(unset)*"
    if knob.kind == "bool":
        return "`1`" if knob.default else "`0`"
    return f"`{knob.default}`"


def knob_table() -> str:
    """The README's port knob table, rendered from utils/knobs.py's
    registry in the reference's format. The port's knob-registry checker
    fails when the README's span and this registry disagree."""
    # the only mode that imports package runtime code (knobs.py is
    # dependency-free; the checkers themselves never import it)
    from ..utils import knobs

    lines = ["| knob | type | default | meaning |", "|---|---|---|---|"]
    reg = knobs.registry()
    for name in sorted(reg):
        k = reg[name]
        lines.append(f"| `{k.name}` | {k.kind} | "
                     f"{_default_label(k, knobs.DERIVED)} | "
                     f"{k.description} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m kubernetes_tpu_torch."
                                 "analysis", description="ktpu-lint")
    ap.add_argument("--json", action="store_true",
                    help="emit the full report as JSON")
    ap.add_argument("--explain", action="store_true",
                    help="list pragma-waived sites and baselined debt")
    ap.add_argument("--update-baseline", action="store_true",
                    help="re-record analysis/baseline.json")
    ap.add_argument("--knob-table", action="store_true",
                    help="print the README knob table from the registry")
    ap.add_argument("--no-cache", action="store_true",
                    help="ignore the per-file mtime cache")
    args = ap.parse_args(argv)

    if args.knob_table:
        print(knob_table())
        return 0

    from . import core

    if args.update_baseline:
        report = core.update_baseline()
        n = len(report.baselined)
        print(f"baseline re-recorded: {n} grandfathered entr"
              f"{'y' if n == 1 else 'ies'}")
        return 0 if report.clean else 1

    report = core.run(use_cache=not args.no_cache)

    if args.json:
        json.dump(report.to_json(), sys.stdout, indent=2)
        sys.stdout.write("\n")
        return 0 if report.clean else 1

    for v in report.violations:
        print(f"{v.path}:{v.line}: [{v.checker}/{v.code}] {v.message} "
              f"(in {v.func})")
    if args.explain:
        if report.allowed:
            print(f"\n-- {len(report.allowed)} pragma-waived site(s):")
            for a in sorted(report.allowed,
                            key=lambda a: (a.path, a.line)):
                print(f"  {a.path}:{a.line} [{a.checker}/{a.code}] "
                      f"allowed: {a.reason}")
        if report.baselined:
            print(f"\n-- {len(report.baselined)} baselined (grandfathered) "
                  "violation(s):")
            for v in report.baselined:
                print(f"  {v.path}:{v.line} [{v.checker}/{v.code}] {v.key}")
    if report.stale_baseline:
        print(f"\n-- {len(report.stale_baseline)} stale baseline entr"
              f"{'y' if len(report.stale_baseline) == 1 else 'ies'} "
              "(fixed! shrink with --update-baseline):")
        for k in report.stale_baseline:
            print(f"  {k}")

    cached = report.files_from_cache
    print(f"\nktpu-lint: {len(report.violations)} violation(s), "
          f"{len(report.baselined)} baselined, {len(report.allowed)} "
          f"allowed by pragma ({report.files_checked} files, "
          f"{cached} from cache)")
    return 0 if report.clean else 1


if __name__ == "__main__":
    sys.exit(main())
