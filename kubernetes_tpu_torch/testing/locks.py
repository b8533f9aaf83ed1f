"""Dynamic lock-order sentinel: the runtime twin of analysis/lock_order.

The static checker proves the *written* with-nesting is cycle-free;
this sentinel asserts the *observed* acquisition order is, under real
chaos/endurance concurrency. Install patches ``threading.Lock`` /
``threading.RLock`` so every lock created afterwards is a tracked
wrapper: each acquire records (held -> acquired) edges on a per-thread
held stack, labelled by the lock's creation site. At teardown
``assert_cycle_free()`` DFS-checks the edge graph; a cycle means two
threads can take the same pair of locks in opposite orders — a
deadlock that plain soak timing may never hit.

Overhead is one dict update per acquire — negligible next to the soak
itself. Use::

    with lock_order_sentinel() as s:
        ...  # construct Cluster, run chaos
    # exiting uninstalls, then asserts the observed graph is acyclic

Locks created BEFORE install() are untracked (module-level locks from
import time); the chaos suites build their Cluster inside the sentinel
so everything that matters is covered.

``threading.Condition`` on a tracked lock stays correct either way: a
Lock-backed wrapper has no ``_release_save``/``_acquire_restore``/
``_is_owned`` (delegation raises AttributeError), so Condition falls
back to plain ``acquire``/``release`` through the wrapper and wait()
keeps the held stack balanced; an RLock-backed wrapper delegates those
three to the real RLock, whose ownership semantics Condition needs
(the fallback ``_is_owned`` probe mis-answers on re-entrant locks).
During an RLock wait() the label stays on the waiter's stack — the
thread is blocked, so no false edges can be recorded from it.
"""

from __future__ import annotations

import contextlib
import sys
import threading
from typing import Dict, List, Tuple

_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock


class _TrackedLock:
    """Delegating wrapper around a real Lock/RLock with order tracking."""

    __slots__ = ("_ktpu_inner", "_ktpu_label", "_ktpu_sentinel")

    def __init__(self, inner, label: str, sentinel: "LockOrderSentinel"):
        object.__setattr__(self, "_ktpu_inner", inner)
        object.__setattr__(self, "_ktpu_label", label)
        object.__setattr__(self, "_ktpu_sentinel", sentinel)

    def acquire(self, *args, **kwargs):
        got = self._ktpu_inner.acquire(*args, **kwargs)
        if got:
            self._ktpu_sentinel._note_acquire(self._ktpu_label)
        return got

    def release(self):
        self._ktpu_sentinel._note_release(self._ktpu_label)
        self._ktpu_inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.release()
        return False

    def locked(self):
        return self._ktpu_inner.locked()

    def __getattr__(self, name):
        return getattr(self._ktpu_inner, name)

    def __repr__(self):
        return f"<TrackedLock {self._ktpu_label} of {self._ktpu_inner!r}>"


class LockOrderSentinel:
    """Records the global lock-acquisition-order graph while installed."""

    def __init__(self):
        # (held_label, acquired_label) -> example thread name
        self.edges: Dict[Tuple[str, str], str] = {}
        self._held = threading.local()
        self._mu = _REAL_LOCK()
        self._installed = False

    # -- tracking ----------------------------------------------------

    def _stack(self) -> List[str]:
        stack = getattr(self._held, "stack", None)
        if stack is None:
            stack = []
            self._held.stack = stack
        return stack

    def _note_acquire(self, label: str) -> None:
        stack = self._stack()
        new_edges = [(h, label) for h in stack if h != label]
        stack.append(label)
        if new_edges:
            tname = threading.current_thread().name
            with self._mu:
                for e in new_edges:
                    self.edges.setdefault(e, tname)

    def _note_release(self, label: str) -> None:
        stack = self._stack()
        # locks are not always released LIFO: drop the last occurrence
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == label:
                del stack[i]
                return

    # -- install / uninstall ----------------------------------------

    def _creation_label(self) -> str:
        frame = sys._getframe(2)
        fn = frame.f_code.co_filename
        for marker in ("kubernetes_tpu", "tests"):
            idx = fn.find(marker)
            if idx >= 0:
                fn = fn[idx:]
                break
        return f"{fn}:{frame.f_lineno}"

    def install(self) -> None:
        assert not self._installed, "sentinel already installed"
        sentinel = self

        def make_lock():
            return _TrackedLock(_REAL_LOCK(), sentinel._creation_label(),
                                sentinel)

        def make_rlock():
            return _TrackedLock(_REAL_RLOCK(), sentinel._creation_label(),
                                sentinel)

        threading.Lock = make_lock
        threading.RLock = make_rlock
        self._installed = True

    def uninstall(self) -> None:
        if self._installed:
            threading.Lock = _REAL_LOCK
            threading.RLock = _REAL_RLOCK
            self._installed = False

    # -- verdict -----------------------------------------------------

    def find_cycle(self) -> List[str]:
        """One observed acquisition cycle as a label list, or []."""
        graph: Dict[str, set] = {}
        for (a, b) in self.edges:
            graph.setdefault(a, set()).add(b)
            graph.setdefault(b, set())
        WHITE, GRAY, BLACK = 0, 1, 2
        color = {n: WHITE for n in graph}

        def dfs(node, stack):
            color[node] = GRAY
            stack.append(node)
            for nxt in sorted(graph[node]):
                if color[nxt] == GRAY:
                    return stack[stack.index(nxt):]
                if color[nxt] == WHITE:
                    cyc = dfs(nxt, stack)
                    if cyc:
                        return cyc
            color[node] = BLACK
            stack.pop()
            return None

        for start in sorted(graph):
            if color[start] == WHITE:
                cyc = dfs(start, [])
                if cyc:
                    return cyc
        return []

    def assert_cycle_free(self) -> None:
        cyc = self.find_cycle()
        if cyc:
            detail = []
            for i, a in enumerate(cyc):
                b = cyc[(i + 1) % len(cyc)]
                thread = self.edges.get((a, b), "?")
                detail.append(f"  {a} -> {b}  (thread {thread})")
            raise AssertionError(
                "lock-order cycle observed at runtime:\n" +
                "\n".join(detail))


@contextlib.contextmanager
def lock_order_sentinel():
    """Install the sentinel, yield it, uninstall, assert acyclic."""
    s = LockOrderSentinel()
    s.install()
    try:
        yield s
    finally:
        s.uninstall()
    s.assert_cycle_free()
