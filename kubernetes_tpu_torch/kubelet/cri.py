"""Container Runtime Interface: the kubelet↔runtime contract + fake impl.

Reference: staging/src/k8s.io/cri-api/pkg/apis/runtime/v1alpha2/api.proto
(RunPodSandbox / CreateContainer / StartContainer / StopContainer /
RemoveContainer / ListPodSandbox / ListContainers) and the fake runtime
kubemark's hollow kubelet wires (pkg/kubelet/cri/remote/fake). The fake
holds sandbox/container state in memory with optional per-op latency so
hollow nodes exercise the full kubelet state machine without a container
runtime.
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

SANDBOX_READY = "SANDBOX_READY"
SANDBOX_NOTREADY = "SANDBOX_NOTREADY"

CONTAINER_CREATED = "CONTAINER_CREATED"
CONTAINER_RUNNING = "CONTAINER_RUNNING"
CONTAINER_EXITED = "CONTAINER_EXITED"


@dataclass
class PodSandbox:
    id: str = ""
    pod_name: str = ""
    pod_namespace: str = ""
    pod_uid: str = ""
    state: str = SANDBOX_READY
    created_at: float = 0.0
    ip: str = ""


@dataclass
class RuntimeContainer:
    id: str = ""
    sandbox_id: str = ""
    name: str = ""
    image: str = ""
    state: str = CONTAINER_CREATED
    created_at: float = 0.0
    started_at: float = 0.0
    finished_at: float = 0.0
    exit_code: int = 0
    restart_count: int = 0
    # log lines (the runtime's per-container log file; ReadLogs in the
    # reference streams these from the CRI log path, kuberuntime_logs.go)
    logs: List[str] = field(default_factory=list)


class CRIError(Exception):
    pass


class FakeRuntimeService:
    """In-memory CRI runtime (fake CRI + fake image service)."""

    def __init__(self, op_latency: float = 0.0, ip_prefix: str = "10.0"):
        """ip_prefix: 2 octets -> pods use prefix.x.y (a /16 podCIDR);
        3 octets -> pods use prefix.y (a /24 podCIDR, kubemark's per-node
        range)."""
        self._lock = threading.Lock()
        self._sandboxes: Dict[str, PodSandbox] = {}
        self._containers: Dict[str, RuntimeContainer] = {}
        self._port_servers: Dict[Tuple[str, int], Callable[[bytes], bytes]] = {}
        self._op_latency = op_latency
        self._ip_prefix = ip_prefix
        self._ip_masklen = 0  # 0 = derive from prefix octet count
        self._ip_counter = 0
        # test hooks: container name -> exit code to fail with on start
        self.fail_starts: Dict[str, int] = {}
        # container name -> exit code ExecSync returns (probes use this)
        self.exec_results: Dict[str, int] = {}

    def _latency(self) -> None:
        if self._op_latency > 0:
            time.sleep(self._op_latency)

    # -- sandboxes ---------------------------------------------------------

    def _alloc_ip(self) -> str:
        """Lowest free address in the range (real CNI IPAM reuses released
        IPs; a monotonic counter would wrap and hand a live pod's IP to a
        new sandbox under churn). Suffix 0 is skipped (network address)."""
        base, size = self._ip_range()
        in_use = {sb.ip for sb in self._sandboxes.values()}
        start = self._ip_counter + 1  # first-fit from last allocation
        for off in range(size - 1):
            n = (start + off - 1) % (size - 1) + 1  # cycle [1, size-1]
            addr = base + n
            ip = ".".join(
                str((addr >> s) & 0xFF) for s in (24, 16, 8, 0)
            )
            if ip not in in_use:
                self._ip_counter = n
                return ip
        raise RuntimeError(f"pod IP range {self._ip_prefix} exhausted")

    def _ip_range(self) -> Tuple[int, int]:
        """(base address as int, range size) from the current CIDR. The
        legacy 2-/3-octet ip_prefix constructor form means /16 and /24."""
        octets = [int(o) for o in self._ip_prefix.split(".")]
        mask = self._ip_masklen if self._ip_masklen else (
            24 if len(octets) == 3 else 16
        )
        octets += [0] * (4 - len(octets))
        base = (octets[0] << 24) | (octets[1] << 16) | (octets[2] << 8) | octets[3]
        base &= (0xFFFFFFFF << (32 - mask)) & 0xFFFFFFFF
        return base, 1 << (32 - mask)

    def set_pod_cidr(self, cidr: str) -> None:
        """CNI range follows the node's centrally-allocated spec.podCIDR
        (controllers/nodeipam.py); the usable range is derived from the
        actual mask length (a /23 hands out 510 addresses, not its first
        /24). The kubelet calls this from its node-status sync; no-op
        when unchanged, existing sandboxes keep their IPs."""
        base, _, masklen = cidr.partition("/")
        mask = int(masklen or 24)
        octets = base.split(".")
        # keep _ip_prefix as the human-readable aligned prefix (tests and
        # exhaustion messages); allocation uses the exact (base, mask)
        prefix = base if mask % 8 else (
            ".".join(octets[:3]) if mask > 16 else ".".join(octets[:2])
        )
        with self._lock:
            if (prefix, mask) != (self._ip_prefix, self._ip_masklen):
                self._ip_prefix = prefix
                self._ip_masklen = mask
                self._ip_counter = 0

    def run_pod_sandbox(self, pod_name: str, pod_namespace: str, pod_uid: str) -> str:
        self._latency()
        with self._lock:
            sid = f"sb-{uuid.uuid4().hex[:12]}"
            self._sandboxes[sid] = PodSandbox(
                id=sid,
                pod_name=pod_name,
                pod_namespace=pod_namespace,
                pod_uid=pod_uid,
                state=SANDBOX_READY,
                created_at=time.time(),
                ip=self._alloc_ip(),
            )
            return sid

    def stop_pod_sandbox(self, sandbox_id: str) -> None:
        self._latency()
        with self._lock:
            sb = self._sandboxes.get(sandbox_id)
            if sb is None:
                raise CRIError(f"sandbox {sandbox_id} not found")
            sb.state = SANDBOX_NOTREADY
            for c in self._containers.values():
                if c.sandbox_id == sandbox_id and c.state == CONTAINER_RUNNING:
                    c.state = CONTAINER_EXITED
                    c.exit_code = 137
                    c.finished_at = time.time()

    def remove_pod_sandbox(self, sandbox_id: str) -> None:
        self._latency()
        with self._lock:
            self._sandboxes.pop(sandbox_id, None)
            self._containers = {
                cid: c
                for cid, c in self._containers.items()
                if c.sandbox_id != sandbox_id
            }

    def list_pod_sandboxes(self) -> List[PodSandbox]:
        with self._lock:
            return [PodSandbox(**vars(s)) for s in self._sandboxes.values()]

    # -- containers --------------------------------------------------------

    def create_container(
        self, sandbox_id: str, name: str, image: str, restart_count: int = 0
    ) -> str:
        self._latency()
        with self._lock:
            if sandbox_id not in self._sandboxes:
                raise CRIError(f"sandbox {sandbox_id} not found")
            cid = f"c-{uuid.uuid4().hex[:12]}"
            self._containers[cid] = RuntimeContainer(
                id=cid,
                sandbox_id=sandbox_id,
                name=name,
                image=image,
                state=CONTAINER_CREATED,
                created_at=time.time(),
                restart_count=restart_count,
                logs=[],
            )
            return cid

    def start_container(self, container_id: str) -> None:
        self._latency()
        with self._lock:
            c = self._containers.get(container_id)
            if c is None:
                raise CRIError(f"container {container_id} not found")
            fail = self.fail_starts.get(c.name)
            if fail is not None:
                c.state = CONTAINER_EXITED
                c.exit_code = fail
                c.finished_at = time.time()
                return
            c.state = CONTAINER_RUNNING
            c.started_at = time.time()
            c.logs.append(f"{time.time():.3f} starting {c.name} ({c.image})")

    def stop_container(self, container_id: str, exit_code: int = 0) -> None:
        self._latency()
        with self._lock:
            c = self._containers.get(container_id)
            if c is None:
                return
            if c.state == CONTAINER_RUNNING:
                c.state = CONTAINER_EXITED
                c.exit_code = exit_code
                c.finished_at = time.time()
                c.logs.append(f"{time.time():.3f} exited with code {exit_code}")

    def remove_container(self, container_id: str) -> None:
        self._latency()
        with self._lock:
            self._containers.pop(container_id, None)

    def list_containers(self) -> List[RuntimeContainer]:
        with self._lock:
            return [
                RuntimeContainer(**{**vars(c), "logs": list(c.logs)})
                for c in self._containers.values()
            ]

    def container_logs(self, container_id: str, tail: Optional[int] = None) -> List[str]:
        """ReadLogs (kuberuntime_logs.go): the container's log lines."""
        with self._lock:
            c = self._containers.get(container_id)
            if c is None:
                raise CRIError(f"container {container_id} not found")
            lines = list(c.logs)
        if tail is not None:
            return lines[-tail:] if tail > 0 else []
        return lines

    def exec_in_container(self, container_id: str, cmd: List[str]) -> Tuple[str, int]:
        """ExecSync: the fake runtime reports its own state (enough to
        give kubectl exec a real transport + state machine to test)."""
        with self._lock:
            c = self._containers.get(container_id)
            if c is None:
                raise CRIError(f"container {container_id} not found")
            if c.state != CONTAINER_RUNNING:
                raise CRIError(f"container {c.name} is not running")
            c.logs.append(f"{time.time():.3f} exec: {' '.join(cmd)}")
            return (
                f"pid 1: {c.name} ({c.image}) uptime "
                f"{time.time() - c.started_at:.1f}s\n",
                self.exec_results.get(c.name, 0),
            )

    # -- streaming (cri/streaming: Exec, Attach, PortForward) --------------

    def exec_stream(self, container_id: str, cmd: List[str]):
        """Exec (streaming): an interactive session against the fake
        runtime's shell — echoes `echo` args, reports state for `ps`,
        echoes back any stdin line prefixed with the container name.
        The reference returns a streaming URL; in-proc the session IS
        the stream."""
        from .streaming import StreamSession, run_handler_thread

        with self._lock:
            c = self._containers.get(container_id)
            if c is None:
                raise CRIError(f"container {container_id} not found")
            if c.state != CONTAINER_RUNNING:
                raise CRIError(f"container {c.name} is not running")
            c.logs.append(f"{time.time():.3f} exec-stream: {' '.join(cmd)}")
        session = StreamSession()

        def shell(s) -> int:
            if cmd and cmd[0] == "echo":
                s.handler_write((" ".join(cmd[1:]) + "\n").encode())
                return 0
            if cmd and cmd[0] == "ps":
                s.handler_write(f"pid 1: {c.name} ({c.image})\n".encode())
                return 0
            # interactive: echo stdin back until EOF
            while True:
                line = s.handler_read()
                if line is None:
                    return 0
                s.handler_write(b"%s> %s" % (c.name.encode(), line))

        run_handler_thread(session, shell)
        return session

    def attach_container(self, container_id: str):
        """Attach: stream the container's output as it is produced
        (existing log lines replayed, then follow until close)."""
        from .streaming import StreamSession, run_handler_thread

        with self._lock:
            c = self._containers.get(container_id)
            if c is None:
                raise CRIError(f"container {container_id} not found")
        session = StreamSession()

        def follow(s) -> int:
            sent = 0
            while not s.closed:
                with self._lock:
                    cc = self._containers.get(container_id)
                    lines = list(cc.logs) if cc is not None else []
                    running = cc is not None and cc.state == CONTAINER_RUNNING
                for line in lines[sent:]:
                    s.handler_write((line + "\n").encode())
                sent = len(lines)
                if not running:
                    return 0
                time.sleep(0.02)
            return 0

        run_handler_thread(session, follow)
        return session

    def register_port_server(self, sandbox_id: str, port: int,
                             handler: Callable[[bytes], bytes]) -> None:
        """Register the in-sandbox server a port-forward connects to (the
        workload process listening on the port)."""
        with self._lock:
            self._port_servers[(sandbox_id, port)] = handler

    def port_forward(self, sandbox_id: str, port: int):
        """PortForward: a bidirectional byte channel to the sandbox's
        port; each stdin chunk gets the server's response on stdout."""
        from .streaming import StreamSession, run_handler_thread

        with self._lock:
            if sandbox_id not in self._sandboxes:
                raise CRIError(f"sandbox {sandbox_id} not found")
            handler = self._port_servers.get((sandbox_id, port))
        if handler is None:
            raise CRIError(
                f"connection refused: nothing listening on {port} "
                f"in sandbox {sandbox_id}"
            )
        session = StreamSession()

        def proxy(s) -> int:
            while True:
                data = s.handler_read()
                if data is None:
                    return 0
                s.handler_write(handler(data))

        run_handler_thread(session, proxy)
        return session

    # -- test helpers ------------------------------------------------------

    def kill_container(self, pod_uid: str, name: str, exit_code: int = 1) -> bool:
        """Simulate a container crash (drives PLEG + restart policy)."""
        with self._lock:
            sandbox_ids = {
                s.id for s in self._sandboxes.values() if s.pod_uid == pod_uid
            }
            for c in self._containers.values():
                if (
                    c.sandbox_id in sandbox_ids
                    and c.name == name
                    and c.state == CONTAINER_RUNNING
                ):
                    c.state = CONTAINER_EXITED
                    c.exit_code = exit_code
                    c.finished_at = time.time()
                    return True
        return False
