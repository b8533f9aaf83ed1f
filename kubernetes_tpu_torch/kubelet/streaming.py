"""CRI streaming sessions: exec (interactive), attach, port-forward.

Reference: staging/src/k8s.io/kubelet/pkg/cri/streaming — the kubelet
runs a streaming server; Exec/Attach/PortForward return URLs the
apiserver proxies as SPDY/WebSocket streams (remotecommand). The in-proc
equivalent is a StreamSession: paired stdin/stdout channels with
half-close semantics, handed from the runtime through the kubelet node
API and the apiserver's node proxy — the same three protocols, the same
session lifecycle (open → interactive IO → close with exit code), minus
the wire framing no in-proc boundary would parse.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, List, Optional


class StreamClosed(Exception):
    pass


class StreamSession:
    """One interactive stream (an exec/attach/port-forward instance)."""

    def __init__(self):
        self._stdin: "queue.Queue[Optional[bytes]]" = queue.Queue()
        self._stdout: "queue.Queue[Optional[bytes]]" = queue.Queue()
        self._closed = threading.Event()
        self.exit_code: Optional[int] = None

    # -- client side (apiserver/kubectl) -----------------------------------

    def write_stdin(self, data: bytes) -> None:
        if self._closed.is_set():
            raise StreamClosed("stream is closed")
        self._stdin.put(bytes(data))

    def close_stdin(self) -> None:
        """Half-close: the handler sees EOF (None) and finishes."""
        self._stdin.put(None)

    def read_stdout(self, timeout: Optional[float] = None) -> Optional[bytes]:
        """Next output chunk; None = end of stream."""
        if self._closed.is_set() and self._stdout.empty():
            return None
        try:
            out = self._stdout.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError("no output within timeout")
        return out

    def read_all(self, timeout: float = 5.0) -> bytes:
        chunks: List[bytes] = []
        while True:
            chunk = self.read_stdout(timeout=timeout)
            if chunk is None:
                return b"".join(chunks)
            chunks.append(chunk)

    # -- handler side (runtime) --------------------------------------------

    def handler_read(self, timeout: Optional[float] = None) -> Optional[bytes]:
        """Next stdin chunk; None means EOF (half-close) or session
        close — NEVER mere idleness: an idle-but-open interactive
        session must not look like EOF, or idle shells/port-forwards
        die. `timeout` caps the total wait (None = until EOF/close)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self._closed.is_set() and self._stdin.empty():
                return None
            try:
                return self._stdin.get(timeout=0.2)
            except queue.Empty:
                if deadline is not None and time.monotonic() >= deadline:
                    return None
                continue

    def handler_write(self, data: bytes) -> None:
        self._stdout.put(bytes(data))

    def finish(self, exit_code: int = 0) -> None:
        self.exit_code = exit_code
        self._stdout.put(None)
        self._closed.set()

    @property
    def closed(self) -> bool:
        return self._closed.is_set()

    def close(self) -> None:
        if not self._closed.is_set():
            self._stdin.put(None)
            self._closed.set()
            self._stdout.put(None)


def run_handler_thread(
    session: StreamSession, target: Callable[[StreamSession], int]
) -> None:
    """Drive a session handler on its own thread (the streaming server's
    per-connection goroutine); the handler's return value is the exit
    code."""

    def run():
        try:
            code = target(session)
        except Exception:  # noqa: BLE001 — handler crash = exit 1
            code = 1
        if not session.closed:
            session.finish(code)

    threading.Thread(target=run, daemon=True).start()
