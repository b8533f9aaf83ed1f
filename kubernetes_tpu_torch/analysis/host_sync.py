"""host-sync-in-hot-path: no implicit host<->device sync on dispatch paths.

Files under ``manifests.HOT_PATHS`` are the dispatch hot path: the
loop_kernel_ratio target (>=0.70, ROADMAP) dies by a thousand stray
``float(jnp_array)`` readbacks, so any expression that forces a device
value onto the host must carry a ``# ktpu: allow-sync(reason)`` pragma.

The checker runs a small intra-function taint pass. Sources: calls
rooted at jax/jnp/lax/pl/pltpu, the conventional device-value parameter
names, device-holding attributes (``self._carry``), and known producer
calls. Taint propagates through assignment, tuple unpack, subscripts,
attributes, arithmetic, and ternaries. Sinks:

  item-call          ``x.item()`` on a tainted value
  scalar-coerce      ``float(x)`` / ``int(x)`` / ``bool(x)`` on taint
  numpy-readback     ``np.asarray(x)`` / ``np.array(x)`` on taint
  device-get         ``jax.device_get(...)``
  block-until-ready  any ``.block_until_ready()`` (always a sync;
                     intentional in-window fences get a pragma)

The port's copy also roots taint at ``torch`` (manifests.DEVICE_ROOTS)
and knows PyTorch's sync points (``.item()``, ``int()`` / ``float()`` /
``bool()`` and ``np.asarray`` are the codes above):

  torch-tolist       ``x.tolist()`` on a tainted value
  torch-cpu          ``x.cpu()`` on a tainted value
  torch-numpy        ``x.numpy()`` on a tainted value
  torch-to-cpu       ``x.to("cpu")`` / ``x.to(device="cpu")`` on taint
  torch-synchronize  ``torch.cuda.synchronize()`` (always a sync)
  torch-event-sync   any other ``.synchronize()``: an event's or a
                     stream's wait (always a sync)
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set

from . import manifests
from .core import Violation

CHECKER = "host-sync"

_COERCIONS = frozenset({"float", "int", "bool"})
# torch tensor methods that copy a (possibly device) value to the host
_TORCH_READBACKS = {"tolist": "torch-tolist", "cpu": "torch-cpu",
                    "numpy": "torch-numpy"}
_NP_READBACKS = frozenset({"asarray", "array"})

# host-side metadata on arrays: reading these never syncs the device
_HOST_META = frozenset({"shape", "dtype", "ndim", "size", "sharding",
                        "weak_type"})


def _root_name(node: ast.AST) -> str:
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Call)):
        node = node.func if isinstance(node, ast.Call) else node.value
    return node.id if isinstance(node, ast.Name) else ""


def _terminal_name(func: ast.AST) -> str:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def _torch_to_cpu(node: ast.Call) -> bool:
    """True for torch's copy to the host, `.to("cpu")` or
    `.to(device="cpu")` (any other `.to(...)` stays on its device)."""
    args = list(node.args[:1]) + [kw.value for kw in node.keywords
                                  if kw.arg == "device"]
    return any(isinstance(a, ast.Constant) and a.value == "cpu"
               for a in args)


def _scope_nodes(root: ast.AST):
    """Walk `root` without descending into nested def/async def bodies
    (each function is its own taint scope; module scope excludes all
    function bodies)."""
    stack = list(ast.iter_child_nodes(root))
    yield root
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


class _Taint:
    """Intra-function device-value taint (two-pass fixpoint)."""

    def __init__(self, fn: ast.AST):
        self.tainted: Set[str] = set()
        args = getattr(fn, "args", None)
        if args is not None:
            all_args = (list(args.posonlyargs) + list(args.args) +
                        list(args.kwonlyargs))
            for a in all_args:
                if a.arg in manifests.DEVICE_PARAM_NAMES:
                    self.tainted.add(a.arg)
        # two passes so `b = a; c = b` converges regardless of order
        for _ in range(2):
            for node in _scope_nodes(fn):
                if isinstance(node, ast.Assign):
                    if self.is_device(node.value):
                        for t in node.targets:
                            self._taint_target(t)
                elif isinstance(node, ast.AnnAssign) and node.value:
                    if self.is_device(node.value):
                        self._taint_target(node.target)
                elif isinstance(node, ast.AugAssign):
                    if self.is_device(node.value):
                        self._taint_target(node.target)
                elif isinstance(node, ast.NamedExpr):
                    if self.is_device(node.value):
                        self._taint_target(node.target)

    def _taint_target(self, target: ast.AST) -> None:
        if isinstance(target, ast.Name):
            self.tainted.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._taint_target(el)
        elif isinstance(target, ast.Starred):
            self._taint_target(target.value)

    def is_device(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Attribute):
            if node.attr in manifests.DEVICE_ATTRS:
                return True
            if node.attr in _HOST_META:
                return False
            return self.is_device(node.value)
        if isinstance(node, ast.Subscript):
            return self.is_device(node.value)
        if isinstance(node, ast.Call):
            root = _root_name(node.func)
            if root in manifests.DEVICE_ROOTS:
                return True
            if _terminal_name(node.func) in manifests.DEVICE_PRODUCERS:
                return True
            # method call on a device value yields a device value
            if isinstance(node.func, ast.Attribute):
                return self.is_device(node.func.value)
            return False
        if isinstance(node, ast.BinOp):
            return self.is_device(node.left) or self.is_device(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_device(node.operand)
        if isinstance(node, ast.IfExp):
            return self.is_device(node.body) or self.is_device(node.orelse)
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self.is_device(el) for el in node.elts)
        if isinstance(node, ast.Starred):
            return self.is_device(node.value)
        return False


def _is_hot(rel: str) -> bool:
    for entry in manifests.HOT_PATHS:
        if entry.endswith("/"):
            if rel.startswith(entry):
                return True
        elif rel == entry:
            return True
    return False


def _scan_scope(fn: ast.AST, rel: str, scope_of, out: List[Violation]) -> None:
    taint = _Taint(fn)
    for node in _scope_nodes(fn):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        line = node.lineno
        scope = scope_of[line]
        if isinstance(func, ast.Attribute):
            if func.attr == "item" and not node.args and \
                    taint.is_device(func.value):
                out.append(Violation(
                    CHECKER, rel, line, scope, "item-call",
                    "`.item()` on a device value forces a host sync"))
            elif func.attr == "block_until_ready":
                out.append(Violation(
                    CHECKER, rel, line, scope, "block-until-ready",
                    "`block_until_ready` blocks the dispatch thread; "
                    "annotate intentional fences with allow-sync"))
            elif (func.attr in _NP_READBACKS and
                  _root_name(func) in manifests.NUMPY_ROOTS and
                  node.args and taint.is_device(node.args[0])):
                out.append(Violation(
                    CHECKER, rel, line, scope, "numpy-readback",
                    f"`{_root_name(func)}.{func.attr}` on a device value "
                    "is a D2H readback"))
            elif func.attr == "device_get" and _root_name(func) == "jax":
                out.append(Violation(
                    CHECKER, rel, line, scope, "device-get",
                    "`jax.device_get` is an explicit D2H transfer"))
            elif func.attr in _TORCH_READBACKS and \
                    taint.is_device(func.value):
                out.append(Violation(
                    CHECKER, rel, line, scope, _TORCH_READBACKS[func.attr],
                    f"`.{func.attr}()` on a torch value copies it to the "
                    "host and waits for the card"))
            elif func.attr == "to" and _torch_to_cpu(node) and \
                    taint.is_device(func.value):
                out.append(Violation(
                    CHECKER, rel, line, scope, "torch-to-cpu",
                    "`.to(\"cpu\")` on a torch value copies it to the "
                    "host and waits for the card"))
            elif func.attr == "synchronize":
                torch_cuda = (isinstance(func.value, ast.Attribute) and
                              func.value.attr == "cuda" and
                              _root_name(func.value) == "torch")
                out.append(Violation(
                    CHECKER, rel, line, scope,
                    "torch-synchronize" if torch_cuda else "torch-event-sync",
                    "`.synchronize()` blocks the dispatch thread on the "
                    "card; annotate intentional waits with allow-sync"))
        elif isinstance(func, ast.Name):
            if func.id in _COERCIONS and len(node.args) == 1 and \
                    taint.is_device(node.args[0]):
                out.append(Violation(
                    CHECKER, rel, line, scope, "scalar-coerce",
                    f"`{func.id}()` on a device value forces a host sync"))


def check_file(rel: str, tree: ast.Module, src: str, scope_of,
               facts: dict) -> List[Violation]:
    if not _is_hot(rel):
        return []
    out: List[Violation] = []
    # each function gets its own taint context; module level gets one too
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            _scan_scope(node, rel, scope_of, out)
    _scan_scope(tree, rel, scope_of, out)
    # nested functions are walked by both parent and self: dedupe
    seen: Dict[tuple, Violation] = {}
    for v in out:
        seen.setdefault((v.line, v.code, v.message), v)
    return sorted(seen.values(), key=lambda v: (v.line, v.code))
