"""The port's HTTP apiserver (kubernetes_tpu_torch/apiserver/http.py, with
auth, flowcontrol and audit beneath it) against the reference's.

- The cases of tests/test_http_apiserver.py, test_wire_protocol.py and
  test_watch_backpressure.py run against each package (tests/_dual.py),
  the full-cluster case (hollow kubelets, the controller manager, the
  scheduler and kubectl, each over its own HTTP client) too.
- The same sequence of requests against both packages' HTTPAPIServer
  gives identical status codes and response bodies, and a watch from
  revision 0 identical frames, in JSON and in binary (objects carry their
  uid and creation time, so no byte depends on the clock).
- Interop: each package's RemoteAPIServer, Clientset and informer work
  against the other's server; a list + watch sees the same events in the
  same order as a client of the server's own package.
"""

from __future__ import annotations

import http.client
import importlib
import json
import time

import pytest

from ._dual import PACKAGES, cases, run_case

CASES = [c for m in ("test_http_apiserver", "test_wire_protocol",
                     "test_watch_backpressure") for c in cases(m)]


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_reference_case(case, package, request):
    run_case(request, package, case)


def _mods(package):
    return {name: importlib.import_module(f"{package}.{name}") for name in (
        "api.types", "apiserver.server", "apiserver.http", "utils.serde",
        "store.wal", "client", "testing.synth")}


def _pod(m, name, rev_uid, node=""):
    v1, synth = m["api.types"], m["testing.synth"]
    pod = synth.make_pod(name, cpu="100m", memory="64Mi", node_name=node,
                         labels={"app": "wire"})
    pod.metadata.uid = f"uid-{rev_uid}"
    pod.metadata.creation_timestamp = 1000.0 + rev_uid
    return m["utils.serde"].to_dict(pod)


def _node(m, name, i):
    node = m["testing.synth"].make_node(name, labels={"zone": f"z{i % 2}"})
    node.metadata.uid = f"node-uid-{i}"
    node.metadata.creation_timestamp = 2000.0 + i
    return m["utils.serde"].to_dict(node)


def _request(addr, method, path, body=None, accept=""):
    host, port = addr.rsplit("/", 1)[-1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=10)
    headers = {"Content-Type": "application/json"}
    if accept:
        headers["Accept"] = accept
    data = json.dumps(body).encode() if body is not None else None
    conn.request(method, path, body=data, headers=headers)
    resp = conn.getresponse()
    out = (resp.status, resp.getheader("Content-Type"), resp.read())
    conn.close()
    return out


def _script(m):
    """The request sequence: creates, reads, lists in both encodings, a
    stale update, a missing object, a binding, a status update, deletes."""
    ns = "/api/v1/namespaces/default"
    pods = [_pod(m, f"p{i}", i) for i in range(4)]
    bin_ = m["apiserver.http"].MEDIA_BINARY
    steps = [("POST", "/api/v1/nodes", _node(m, f"n{i}", i), "")
             for i in range(2)]
    steps += [("POST", f"{ns}/pods", p, "") for p in pods]
    steps += [
        ("POST", f"{ns}/pods", pods[0], ""),                  # 409 exists
        ("GET", f"{ns}/pods/p1", None, ""),
        ("GET", f"{ns}/pods/missing", None, ""),              # 404
        ("GET", f"{ns}/pods", None, ""),
        ("GET", f"{ns}/pods", None, bin_),
        ("GET", "/api/v1/nodes", None, bin_),
        ("POST", f"{ns}/pods/p2/binding",
         {"target": {"name": "n1"}}, ""),
        ("POST", f"{ns}/pods/p2/binding",
         {"target": {"name": "n0"}}, ""),                     # 409 bound
        ("PUT", f"{ns}/pods/p3",
         dict(pods[3], metadata=dict(pods[3]["metadata"],
                                     resourceVersion="1")), ""),  # stale
        ("DELETE", f"{ns}/pods/p0", None, ""),
        ("DELETE", f"{ns}/pods/p0", None, ""),                # 404
        ("GET", f"{ns}/pods", None, ""),
        ("GET", "/api", None, ""),
    ]
    return steps


def _watch_frames(m, addr, accept, want, timeout=10.0):
    """A raw watch from revision 0: the frames' bytes, heartbeats dropped,
    until `want` frames have arrived."""
    host, port = addr.rsplit("/", 1)[-1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    headers = {"Accept": accept} if accept else {}
    conn.request("GET", "/api/v1/namespaces/default/pods?watch=true"
                 "&resourceVersion=0", headers=headers)
    resp = conn.getresponse()
    wal = m["store.wal"]
    frames, buf = [], b""
    deadline = time.monotonic() + timeout
    try:
        while len(frames) < want and time.monotonic() < deadline:
            if accept:
                buf += resp.read1(1 << 16)
                end = 0
                for rec, off in wal.iter_records(buf):
                    if rec.op != wal.OP_HEARTBEAT:
                        frames.append(buf[end:off])
                    end = off
                buf = buf[end:]
            else:
                line = resp.readline()
                if line.strip():
                    frames.append(line)
    finally:
        conn.close()
    return frames


def _transcript(package):
    m = _mods(package)
    srv = m["apiserver.http"].HTTPAPIServer(
        api=m["apiserver.server"].APIServer()).start()
    try:
        out = [(method, path) + _request(srv.address, method, path, body,
                                         accept)
               for method, path, body, accept in _script(m)]
        # 4 creates, the binding, the delete
        frames = {enc: _watch_frames(m, srv.address, accept, 6)
                  for enc, accept in (("json", ""), (
                      "binary", m["apiserver.http"].MEDIA_BINARY))}
    finally:
        srv.stop()
    return out, frames


def test_same_requests_same_bytes():
    ref, ref_frames = _transcript("kubernetes_tpu")
    got, frames = _transcript("kubernetes_tpu_torch")
    assert [r[2] for r in ref] == [201, 201, 201, 201, 201, 201, 409, 200,
                                   404, 200, 200, 200, 201, 409, 409, 200,
                                   404, 200, 200]
    for a, b in zip(ref, got):
        assert a == b, a[:2]
    assert len(got) == len(ref)
    for enc in ("json", "binary"):
        assert len(ref_frames[enc]) == 6, enc
        assert frames[enc] == ref_frames[enc], enc


def _events(watch, n, timeout=10.0):
    out = []
    deadline = time.monotonic() + timeout
    while len(out) < n and time.monotonic() < deadline:
        ev = watch.poll(timeout=0.2)
        if ev is not None:
            out.append((ev.type, ev.object.metadata.name, ev.revision,
                        ev.object.spec.node_name))
    return out


def _cross_run(server_pkg, client_pkg):
    """client_pkg's RemoteAPIServer, Clientset and informer against
    server_pkg's HTTPAPIServer: writes through the client, reads back,
    an informer synced to the objects, a watch from revision 0.
    -> (informer's view, watch events)."""
    s, c = _mods(server_pkg), _mods(client_pkg)
    srv = s["apiserver.http"].HTTPAPIServer(
        api=s["apiserver.server"].APIServer()).start()
    remote = c["apiserver.http"].RemoteAPIServer(srv.address)
    cs = c["client"].Clientset(remote)
    factory = c["client"].SharedInformerFactory(cs)
    informer = factory.pods()
    try:
        synth = c["testing.synth"]
        cs.nodes.create(synth.make_node("n0"))
        for i in range(5):
            cs.pods.create(synth.make_pod(f"p{i}", cpu="100m"))
        factory.start()
        assert factory.wait_for_cache_sync(timeout=10.0)
        cs.pods.bind("default", "p1", "n0")
        cs.pods.delete("p3", "default")
        got = cs.pods.get("p1", "default")
        assert type(got).__module__ == f"{client_pkg}.api.types"
        assert got.spec.node_name == "n0"
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            view = {p.metadata.name: p.spec.node_name
                    for p in informer.list()}
            if len(view) == 4 and view.get("p1") == "n0":
                break
            time.sleep(0.05)
        w = remote.watch("pods", "default", since_revision=0)
        try:
            events = _events(w, 7)
        finally:
            w.stop()
        return view, events
    finally:
        factory.stop()
        srv.stop()


@pytest.mark.parametrize("binary", ["1", "0"], ids=["binary", "json"])
@pytest.mark.parametrize("server,client", [
    ("kubernetes_tpu", "kubernetes_tpu_torch"),
    ("kubernetes_tpu_torch", "kubernetes_tpu")])
def test_client_against_other_server(server, client, binary, monkeypatch):
    monkeypatch.setenv("KTPU_WIRE_BINARY", binary)
    view, events = _cross_run(server, client)
    assert view == {"p0": "", "p1": "n0", "p2": "", "p4": ""}
    # a list + watch as the server's own package's client sees it
    same_view, same_events = _cross_run(server, server)
    assert (view, events) == (same_view, same_events)
    assert [e[0] for e in events] == ["ADDED"] * 5 + ["MODIFIED", "DELETED"]
