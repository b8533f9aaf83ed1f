"""Compare the kernels two versions of a CUDA source compile to.

    python3 -m kubernetes_tpu_torch.ops.sass_diff OLD.cu [NEW.cu]

Compiles each source with the flags of `build.py` (each with its own
directory on the include path), once to PTX and once to a cubin with
ptxas's report, and prints for every kernel entry of either: whether its
PTX and its SASS (`cuobjdump -sass`) are equal in the two, and its
registers and spill stores in each. NEW defaults to this tree's
`csrc/scan_full.cu`. Names in the anonymous namespace carry a per-file
hash: the namespace's name is replaced by one token before the
comparison, an entry's own name by another, the entry's index in PTX
labels by nothing, and runs of blanks by one. Needs the CUDA toolkit
(nvcc, cuobjdump, cu++filt); the last line is one JSON object.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Dict, Tuple

from .build import NVCC_FLAGS, _nvcc

FLAGS = tuple(f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                                 "-fPIC"))
# the anonymous namespace's per-file name, with its length in front when
# mangled: _GLOBAL__N__<hash>_<n>_<file>_cu_<hash>
_ANON = re.compile(r"\d*_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}")
_PTX_ENTRY = re.compile(r"^[ \t]*(?:\.\w+[ \t]+)*\.entry[ \t]+(\S+?)[ \t]*\(",
                        re.M)
_PTXAS = re.compile(r"Compiling entry function '(\S+)'.*?"
                    r"(\d+) bytes spill stores.*?Used (\d+) registers",
                    re.S)


def _tool(name: str) -> str:
    return str(Path(_nvcc()).parent / name) if "/" in _nvcc() else name


def _normal(name: str, body: str) -> str:
    """`body` with its entry's name and the namespace's replaced, the
    entry's index taken out of PTX labels, and blanks collapsed (cuobjdump
    aligns its columns to the file's widest instruction)."""
    body = _ANON.sub("ANON", body.replace(name, "ENTRY"))
    body = re.sub(r"\$L__BB\d+_", "$L__BB_", body)
    return re.sub(r"[ \t]+", " ", body)


def compile_source(src: Path, out: Path) -> Tuple[Dict, Dict, Dict]:
    """(PTX per entry, SASS per entry, (registers, spill stores) per
    entry), keyed by mangled name."""
    base = [_nvcc(), *FLAGS, "-I", str(src.parent)]
    ptx, cubin = out / f"{src.stem}.ptx", out / f"{src.stem}.cubin"
    subprocess.run([*base, "-ptx", "-o", str(ptx), str(src)], check=True)
    rep = subprocess.run([*base, "-Xptxas", "-v", "-cubin", "-o", str(cubin),
                          str(src)], check=True, capture_output=True,
                         text=True)
    text = ptx.read_text()
    starts = list(_PTX_ENTRY.finditer(text))
    ptx_by = {}
    for m, nxt in zip(starts, starts[1:] + [None]):
        body = text[m.start():nxt.start() if nxt else len(text)]
        ptx_by[m.group(1)] = _normal(m.group(1), body).rstrip()
    sass = subprocess.run([_tool("cuobjdump"), "-sass", str(cubin)],
                          check=True, capture_output=True, text=True).stdout
    sass_by = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        sass_by[name] = _normal(name, part).rstrip()
    regs = {m.group(1): (int(m.group(3)), int(m.group(2)))
            for m in _PTXAS.finditer(rep.stdout + rep.stderr)}
    return ptx_by, sass_by, regs


def demangle(names) -> Dict[str, str]:
    names = sorted(names)
    res = subprocess.run([_tool("cu++filt")], input="\n".join(names),
                         capture_output=True, text=True, check=True)
    return dict(zip(names, (_ANON.sub("ANON", x)
                            for x in res.stdout.splitlines())))


def compare(old: Path, new: Path) -> Dict:
    with tempfile.TemporaryDirectory() as tmp:
        a_dir, b_dir = Path(tmp, "old"), Path(tmp, "new")
        a_dir.mkdir()
        b_dir.mkdir()
        a, b = compile_source(old, a_dir), compile_source(new, b_dir)
    # match the entries across the two files by their normalized names
    rows = {}
    for side, (ptx, sass, regs) in (("old", a), ("new", b)):
        for mangled, pretty in demangle(ptx).items():
            sass_key = next((k for k in sass if _ANON.sub("ANON", k)
                             == _ANON.sub("ANON", mangled)), None)
            row = rows.setdefault(pretty, {})
            row[side] = {"ptx": ptx[mangled],
                         "sass": sass.get(sass_key, ""),
                         "regs": regs.get(mangled)}
    report = []
    for name in sorted(rows):
        o, n = rows[name].get("old"), rows[name].get("new")
        report.append({
            "kernel": name,
            "ptx_equal": bool(o and n and o["ptx"] == n["ptx"]),
            "sass_equal": bool(o and n and o["sass"] == n["sass"]),
            "old_regs_spill": o and o["regs"],
            "new_regs_spill": n and n["regs"]})
    return {"old": str(old), "new": str(new), "kernels": report}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not 1 <= len(argv) <= 2:
        print(__doc__, file=sys.stderr)
        return 2
    new = Path(argv[1]) if len(argv) > 1 else \
        Path(__file__).resolve().parent / "csrc" / "scan_full.cu"
    got = compare(Path(argv[0]).resolve(), new.resolve())
    for r in got["kernels"]:
        print(f"{r['kernel']}: PTX {'equal' if r['ptx_equal'] else 'DIFFERS'}"
              f", SASS {'equal' if r['sass_equal'] else 'DIFFERS'}; "
              f"registers / spill stores {r['old_regs_spill']} -> "
              f"{r['new_regs_spill']}")
    print(json.dumps(got))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
