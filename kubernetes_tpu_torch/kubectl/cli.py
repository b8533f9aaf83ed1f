"""kubectl: the CLI over the clientset.

Reference: staging/src/k8s.io/kubectl (cobra commands over client-go /
cli-runtime builders). The verb set here covers the daily-driver surface:
get / describe / create -f / apply -f (3-way merge via the
last-applied-configuration annotation, pkg/cmd/apply) / delete / scale /
label / annotate / taint / cordon / uncordon / drain (pkg/drain) /
rollout status|restart. Manifests are YAML or JSON in the wire shape
(camelCase, utils/serde).
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import time
from typing import Any, Dict, List, Optional

import yaml

from ..api import types as v1
from ..api.labels import Selector
from ..apiserver.server import APIError, NotFound
from ..utils import serde

LAST_APPLIED = "kubectl.kubernetes.io/last-applied-configuration"

ALIASES = {
    "po": "pods", "pod": "pods",
    "no": "nodes", "node": "nodes",
    "svc": "services", "service": "services",
    "ep": "endpoints",
    "ns": "namespaces", "namespace": "namespaces",
    "cm": "configmaps", "configmap": "configmaps",
    "pv": "persistentvolumes", "persistentvolume": "persistentvolumes",
    "pvc": "persistentvolumeclaims", "persistentvolumeclaim": "persistentvolumeclaims",
    "rc": "replicationcontrollers",
    "rs": "replicasets", "replicaset": "replicasets",
    "deploy": "deployments", "deployment": "deployments",
    "ds": "daemonsets", "daemonset": "daemonsets",
    "sts": "statefulsets", "statefulset": "statefulsets",
    "job": "jobs",
    "cj": "cronjobs", "cronjob": "cronjobs",
    "sc": "storageclasses", "storageclass": "storageclasses",
    "pc": "priorityclasses", "priorityclass": "priorityclasses",
    "pdb": "poddisruptionbudgets", "poddisruptionbudget": "poddisruptionbudgets",
    "lease": "leases",
    "eps": "endpointslices", "endpointslice": "endpointslices",
    "crd": "customresourcedefinitions",
    "hpa": "horizontalpodautoscalers",
    "horizontalpodautoscaler": "horizontalpodautoscalers",
    "quota": "resourcequotas", "resourcequota": "resourcequotas",
    "limits": "limitranges", "limitrange": "limitranges",
}


def _age(ts: Optional[float]) -> str:
    if not ts:
        return "<unknown>"
    s = max(0, int(time.time() - ts))
    if s < 120:
        return f"{s}s"
    if s < 7200:
        return f"{s // 60}m"
    if s < 172800:
        return f"{s // 3600}h"
    return f"{s // 86400}d"


class Kubectl:
    def __init__(self, clientset, out=None, default_namespace: str = "default"):
        self.cs = clientset
        self.out = out if out is not None else sys.stdout
        self.default_ns = default_namespace

    # -- plumbing -----------------------------------------------------------

    def _print(self, *parts: str) -> None:
        print(*parts, file=self.out)

    def _resource(self, name: str) -> str:
        name = name.lower()
        return ALIASES.get(name, name)

    def _kind_to_resource(self, kind: str) -> str:
        for info in self.cs.api.resources():
            try:
                if info.type().kind == kind:
                    return info.name
            except Exception:  # noqa: BLE001 — types without default kind
                continue
        # custom resources: resolve through the CRD names (discovery would
        # serve these in the reference)
        try:
            crds, _ = self.cs.api.list("customresourcedefinitions")
        except APIError:
            crds = []
        for crd in crds:
            if crd.spec.names.kind == kind:
                return crd.spec.names.plural
        raise APIError(f"no resource registered for kind {kind!r}")

    def _client(self, resource: str):
        return self.cs.resource(self._resource(resource))

    def _namespaced(self, resource: str) -> bool:
        info = self.cs.api._info(self._resource(resource))
        return info.namespaced

    def _load_manifests(self, path: str) -> List[Dict]:
        if path == "-":
            text = sys.stdin.read()
        else:
            with open(path) as f:
                text = f.read()
        docs = [d for d in yaml.safe_load_all(text) if d]
        return docs

    def _obj_from_dict(self, doc: Dict):
        kind = doc.get("kind")
        if not kind:
            raise APIError("manifest missing kind")
        resource = self._kind_to_resource(kind)
        info = self.cs.api._info(resource)
        return resource, serde.from_dict(info.type, doc)

    # -- entry --------------------------------------------------------------

    def run(self, argv: List[str]) -> int:
        parser = argparse.ArgumentParser(prog="kubectl", add_help=True)
        parser.add_argument("-n", "--namespace", default=self.default_ns)
        sub = parser.add_subparsers(dest="verb", required=True)

        p = sub.add_parser("get")
        p.add_argument("resource")
        p.add_argument("name", nargs="?")
        p.add_argument("-o", "--output", default="")
        p.add_argument("-l", "--selector", default="")
        p.add_argument("-A", "--all-namespaces", action="store_true")

        p = sub.add_parser("describe")
        p.add_argument("resource")
        p.add_argument("name")

        p = sub.add_parser("create")
        # generator form (`create deployment NAME --image=X ...`,
        # pkg/cmd/create/*) or manifest form (`create -f FILE`)
        p.add_argument("kind", nargs="?")
        p.add_argument("name", nargs="?")
        p.add_argument("extra", nargs="*")  # secret's `generic` etc.
        p.add_argument("-f", "--filename")
        p.add_argument("--image", default="")
        p.add_argument("--replicas", type=int, default=1)
        p.add_argument("--from-literal", dest="from_literal",
                       action="append", default=[])

        p = sub.add_parser("apply")
        p.add_argument("-f", "--filename", required=True)

        p = sub.add_parser("diff")
        p.add_argument("-f", "--filename", required=True)

        p = sub.add_parser("delete")
        p.add_argument("resource", nargs="?")
        p.add_argument("name", nargs="?")
        p.add_argument("-f", "--filename")
        p.add_argument("--cascade", default="background",
                       choices=["background", "foreground", "orphan"])

        p = sub.add_parser("scale")
        p.add_argument("target")  # resource/name
        p.add_argument("--replicas", type=int, required=True)

        p = sub.add_parser("label")
        p.add_argument("resource")
        p.add_argument("name")
        p.add_argument("pairs", nargs="+")
        p.add_argument("--overwrite", action="store_true")

        p = sub.add_parser("annotate")
        p.add_argument("resource")
        p.add_argument("name")
        p.add_argument("pairs", nargs="+")
        p.add_argument("--overwrite", action="store_true")

        p = sub.add_parser("taint")
        p.add_argument("resource")  # must be nodes
        p.add_argument("name")
        p.add_argument("taints", nargs="+")

        for verb in ("cordon", "uncordon"):
            p = sub.add_parser(verb)
            p.add_argument("name")

        p = sub.add_parser("drain")
        p.add_argument("name")
        p.add_argument("--ignore-daemonsets", action="store_true")
        p.add_argument("--force", action="store_true")
        p.add_argument("--grace-period", type=int, default=-1)

        p = sub.add_parser("rollout")
        p.add_argument("action",
                       choices=["status", "restart", "history", "undo"])
        p.add_argument("target")  # deployment/name
        p.add_argument("--to-revision", type=int, default=0)

        p = sub.add_parser("top")
        p.add_argument("resource", choices=["nodes", "node", "pods", "pod", "no", "po"])

        p = sub.add_parser("logs")
        p.add_argument("pod")
        p.add_argument("-c", "--container", default="")
        p.add_argument("--tail", type=int, default=None)

        p = sub.add_parser("exec")
        p.add_argument("pod")
        p.add_argument("-c", "--container", default="")
        p.add_argument("cmd", nargs="+")  # after `--` in real kubectl

        p = sub.add_parser("patch")
        p.add_argument("resource")
        p.add_argument("name")
        p.add_argument("-p", "--patch", required=True)
        p.add_argument("--type", default="strategic",
                       choices=["strategic", "merge", "json"])
        p.add_argument("--subresource", default="", choices=["", "status"])

        p = sub.add_parser("attach")
        p.add_argument("pod")
        p.add_argument("-c", "--container", default="")
        p.add_argument("--read-timeout", type=float, default=2.0)

        p = sub.add_parser("port-forward")
        p.add_argument("pod")
        p.add_argument("port", type=int)
        p.add_argument("--send", default="",
                       help="data to forward (stdin when omitted)")

        p = sub.add_parser("wait")
        p.add_argument("resource")
        p.add_argument("name")
        p.add_argument("--for", dest="condition", required=True,
                       help="delete | condition=Type[=Value] | "
                            "jsonpath-lite field=value")
        p.add_argument("--timeout", type=float, default=30.0)

        p = sub.add_parser("edit")
        p.add_argument("resource")
        p.add_argument("name")

        p = sub.add_parser("explain")
        p.add_argument("field_path")  # resource[.field[.subfield...]]
        p.add_argument("--recursive", action="store_true")

        sub.add_parser("api-resources")

        p = sub.add_parser("expose")
        p.add_argument("target")  # resource/name
        p.add_argument("--port", type=int, required=True)
        p.add_argument("--target-port", dest="target_port", type=int,
                       default=0)
        p.add_argument("--name", default="")
        p.add_argument("--type", default="ClusterIP")
        p.add_argument("--protocol", default="TCP")

        p = sub.add_parser("autoscale")
        p.add_argument("target")  # resource/name
        p.add_argument("--min", dest="min_replicas", type=int, default=1)
        p.add_argument("--max", dest="max_replicas", type=int,
                       required=True)
        p.add_argument("--cpu-percent", dest="cpu_percent", type=int,
                       default=-1)
        p.add_argument("--name", default="")

        p = sub.add_parser("auth")
        p.add_argument("subverb", choices=["can-i"])
        p.add_argument("verb_arg")
        p.add_argument("resource")
        p.add_argument("--as", dest="as_user", default="")
        p.add_argument("--as-group", dest="as_groups", action="append",
                       default=[])

        args = parser.parse_args(argv)
        self._exit_code = 0  # diff sets 1 on found-differences
        try:
            getattr(self, f"cmd_{args.verb.replace('-', '_')}")(args)
            return self._exit_code
        except APIError as e:
            self._print(f"Error: {e}")
            return 1

    # -- verbs --------------------------------------------------------------

    def cmd_get(self, args) -> None:
        resource = self._resource(args.resource)
        client = self._client(resource)
        sel = Selector.parse(args.selector) if args.selector else None
        if args.name:
            ns = args.namespace if self._namespaced(resource) else ""
            items = [client.get(args.name, ns)]
        else:
            ns = None
            if self._namespaced(resource) and not args.all_namespaces:
                ns = args.namespace
            items, _ = client.list(namespace=ns, label_selector=sel)
        if args.output in ("yaml", "json"):
            docs = [serde.to_dict(o) for o in items]
            payload = docs[0] if args.name else {"kind": "List", "items": docs}
            if args.output == "yaml":
                self._print(yaml.safe_dump(payload, sort_keys=False).rstrip())
            else:
                self._print(json.dumps(payload, indent=2))
            return
        if args.output == "name":
            for o in items:
                self._print(f"{resource}/{o.metadata.name}")
            return
        self._table(resource, items, wide=args.output == "wide")

    def _table(self, resource: str, items: List[Any], wide: bool) -> None:
        rows: List[List[str]] = []
        if resource == "pods":
            hdr = ["NAME", "READY", "STATUS", "RESTARTS", "AGE"] + (
                ["NODE"] if wide else []
            )
            for o in items:
                total = len(o.spec.containers or [])
                ready = sum(1 for c in o.status.container_statuses or [] if c.ready)
                restarts = sum(
                    c.restart_count for c in o.status.container_statuses or []
                )
                row = [
                    o.metadata.name,
                    f"{ready}/{total}",
                    o.status.phase or "Pending",
                    str(restarts),
                    _age(o.metadata.creation_timestamp),
                ]
                if wide:
                    row.append(o.spec.node_name or "<none>")
                rows.append(row)
        elif resource == "nodes":
            hdr = ["NAME", "STATUS", "AGE"]
            for o in items:
                ready = next(
                    (c.status for c in o.status.conditions or [] if c.type == "Ready"),
                    "Unknown",
                )
                status = {"True": "Ready", "False": "NotReady"}.get(ready, "NotReady")
                if o.spec.unschedulable:
                    status += ",SchedulingDisabled"
                rows.append([o.metadata.name, status, _age(o.metadata.creation_timestamp)])
        elif resource == "deployments":
            hdr = ["NAME", "READY", "UP-TO-DATE", "AVAILABLE", "AGE"]
            for o in items:
                want = o.spec.replicas if o.spec.replicas is not None else 1
                rows.append([
                    o.metadata.name,
                    f"{o.status.ready_replicas or 0}/{want}",
                    str(o.status.updated_replicas or 0),
                    str(o.status.available_replicas or 0),
                    _age(o.metadata.creation_timestamp),
                ])
        elif resource == "services":
            hdr = ["NAME", "TYPE", "CLUSTER-IP", "PORT(S)", "AGE"]
            for o in items:
                ports = ",".join(
                    f"{p.port}/{p.protocol}" + (f":{p.node_port}" if p.node_port else "")
                    for p in o.spec.ports or []
                )
                rows.append([
                    o.metadata.name,
                    o.spec.type or "ClusterIP",
                    o.spec.cluster_ip or "None",
                    ports or "<none>",
                    _age(o.metadata.creation_timestamp),
                ])
        else:
            hdr = ["NAME", "AGE"]
            for o in items:
                rows.append([o.metadata.name, _age(o.metadata.creation_timestamp)])
        widths = [
            max(len(hdr[i]), *(len(r[i]) for r in rows)) if rows else len(hdr[i])
            for i in range(len(hdr))
        ]
        self._print("   ".join(h.ljust(w) for h, w in zip(hdr, widths)).rstrip())
        for r in rows:
            self._print("   ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip())

    def cmd_describe(self, args) -> None:
        resource = self._resource(args.resource)
        ns = args.namespace if self._namespaced(resource) else ""
        obj = self._client(resource).get(args.name, ns)
        doc = serde.to_dict(obj)
        self._print(f"Name:         {obj.metadata.name}")
        if self._namespaced(resource):
            self._print(f"Namespace:    {obj.metadata.namespace}")
        self._print(f"Labels:       {obj.metadata.labels or '<none>'}")
        self._print(f"Annotations:  {obj.metadata.annotations or '<none>'}")
        for section in ("spec", "status"):
            if section in doc:
                self._print(f"{section.title()}:")
                body = yaml.safe_dump(doc[section], sort_keys=False).rstrip()
                for line in body.splitlines():
                    self._print(f"  {line}")

    def cmd_create(self, args) -> None:
        if args.kind and not args.filename:
            return self._create_generator(args)
        if not args.filename:
            raise APIError("create requires -f FILE or a generator "
                           "(deployment|namespace|configmap|secret|"
                           "serviceaccount)")
        for doc in self._load_manifests(args.filename):
            resource, obj = self._obj_from_dict(doc)
            if self._namespaced(resource) and not obj.metadata.namespace:
                obj.metadata.namespace = args.namespace
            created = self.cs.resource(resource).create(obj)
            self._print(f"{resource}/{created.metadata.name} created")

    def _create_generator(self, args) -> None:
        """kubectl create SUBCOMMAND (pkg/cmd/create/create_{deployment,
        namespace,configmap,secret,serviceaccount}.go): object generators
        for the daily-driver kinds."""
        kind = args.kind
        # `create secret generic NAME`: the type rides in front of name
        if kind == "secret":
            if args.name != "generic" or not args.extra:
                raise APIError("usage: create secret generic NAME "
                               "[--from-literal k=v ...]")
            name = args.extra[0]
        else:
            name = args.name
        if not name:
            raise APIError(f"create {kind} requires NAME")
        literals = {}
        for pair in args.from_literal:
            k, sep, val = pair.partition("=")
            if not sep:
                raise APIError(f"--from-literal {pair!r} is not k=v")
            literals[k] = val
        ns = args.namespace
        if kind in ("namespace", "ns"):
            self.cs.resource("namespaces").create(
                v1.Namespace(metadata=v1.ObjectMeta(name=name)))
            self._print(f"namespace/{name} created")
        elif kind in ("deployment", "deploy"):
            if not args.image:
                raise APIError("create deployment requires --image")
            from ..api import apps

            labels = {"app": name}
            dep = apps.Deployment(
                metadata=v1.ObjectMeta(name=name, namespace=ns,
                                       labels=dict(labels)),
                spec=apps.DeploymentSpec(
                    replicas=args.replicas,
                    selector=v1.LabelSelector(match_labels=dict(labels)),
                    template=v1.PodTemplateSpec(
                        metadata=v1.ObjectMeta(labels=dict(labels)),
                        spec=v1.PodSpec(containers=[
                            v1.Container(name=name, image=args.image)
                        ]),
                    ),
                ),
            )
            self.cs.resource("deployments").create(dep)
            self._print(f"deployment.apps/{name} created")
        elif kind in ("configmap", "cm"):
            self.cs.resource("configmaps").create(v1.ConfigMap(
                metadata=v1.ObjectMeta(name=name, namespace=ns),
                data=dict(literals) or None,
            ))
            self._print(f"configmap/{name} created")
        elif kind == "secret":
            import base64

            self.cs.resource("secrets").create(v1.Secret(
                metadata=v1.ObjectMeta(name=name, namespace=ns),
                data={
                    k: base64.b64encode(val.encode()).decode()
                    for k, val in literals.items()
                } or None,
            ))
            self._print(f"secret/{name} created")
        elif kind in ("serviceaccount", "sa"):
            from ..api.rbac import ServiceAccount

            self.cs.resource("serviceaccounts").create(ServiceAccount(
                metadata=v1.ObjectMeta(name=name, namespace=ns)))
            self._print(f"serviceaccount/{name} created")
        else:
            raise APIError(f"unknown create generator {kind!r}")

    def _apply_merged(self, resource: str, obj, namespace: str):
        """(live_doc | None, merged_doc) for one manifest object — the
        3-way apply computation, shared by apply and diff so what diff
        shows is exactly what apply would write."""
        if self._namespaced(resource) and not obj.metadata.namespace:
            obj.metadata.namespace = namespace
        client = self.cs.resource(resource)
        ns = obj.metadata.namespace if self._namespaced(resource) else ""
        new_doc = serde.to_dict(obj)
        try:
            live = client.get(obj.metadata.name, ns)
        except NotFound:
            return None, new_doc
        live_doc = serde.to_dict(live)
        prev = json.loads(
            (live.metadata.annotations or {}).get(LAST_APPLIED, "{}")
        )
        merged = _three_way_merge(prev, live_doc, new_doc)
        merged.setdefault("metadata", {}).setdefault("annotations", {})[
            LAST_APPLIED
        ] = json.dumps(new_doc)
        # preserve server-populated identity/concurrency fields
        merged["metadata"]["resourceVersion"] = live_doc["metadata"].get(
            "resourceVersion"
        )
        merged["metadata"]["uid"] = live_doc["metadata"].get("uid")
        return live_doc, merged

    def cmd_apply(self, args) -> None:
        """3-way merge apply (reference: kubectl apply,
        staging/src/k8s.io/kubectl/pkg/cmd/apply — last-applied annotation
        + patch computed from (last-applied, live, new); untyped JSON merge
        semantics: lists replace wholesale)."""
        for doc in self._load_manifests(args.filename):
            resource, obj = self._obj_from_dict(doc)
            live_doc, merged = self._apply_merged(
                resource, obj, args.namespace)
            client = self.cs.resource(resource)
            if live_doc is None:
                obj.metadata.annotations = dict(obj.metadata.annotations or {})
                obj.metadata.annotations[LAST_APPLIED] = json.dumps(merged)
                client.create(obj)
                self._print(f"{resource}/{obj.metadata.name} created")
                continue
            info = self.cs.api._info(resource)
            client.update(serde.from_dict(info.type, merged))
            self._print(f"{resource}/{obj.metadata.name} configured")

    def cmd_diff(self, args) -> None:
        """kubectl diff (pkg/cmd/diff/diff.go:39): unified diff between
        the live objects and what apply would produce; exit code 1 when
        any difference is found (the reference's convention)."""
        import difflib

        for doc in self._load_manifests(args.filename):
            resource, obj = self._obj_from_dict(doc)
            live_doc, merged = self._apply_merged(
                resource, obj, args.namespace)
            name = f"{resource}/{obj.metadata.name}"

            def clean(d):
                if d is None:
                    return []
                d = dict(d)
                meta = dict(d.get("metadata") or {})
                # volatile server fields are not semantic differences
                for k in ("resourceVersion", "uid", "creationTimestamp",
                          "generation"):
                    meta.pop(k, None)
                ann = dict(meta.get("annotations") or {})
                ann.pop(LAST_APPLIED, None)
                if ann:
                    meta["annotations"] = ann
                else:
                    meta.pop("annotations", None)
                d["metadata"] = meta
                return json.dumps(d, indent=2, sort_keys=True) \
                    .splitlines(keepends=True)
            lines = list(difflib.unified_diff(
                clean(live_doc), clean(merged),
                fromfile=f"LIVE/{name}", tofile=f"MERGED/{name}",
            ))
            if lines:
                self._exit_code = 1
                for ln in lines:
                    self._print(ln.rstrip("\n"))

    def cmd_delete(self, args) -> None:
        if args.filename:
            for doc in self._load_manifests(args.filename):
                resource, obj = self._obj_from_dict(doc)
                ns = (
                    obj.metadata.namespace or args.namespace
                    if self._namespaced(resource)
                    else ""
                )
                policy = {"foreground": "Foreground", "orphan": "Orphan"}.get(
                    getattr(args, "cascade", "background")
                )
                self.cs.resource(resource).delete(
                    obj.metadata.name, ns, propagation_policy=policy
                )
                self._print(f"{resource}/{obj.metadata.name} deleted")
            return
        if not args.resource or not args.name:
            raise APIError("delete requires RESOURCE NAME or -f FILE")
        resource = self._resource(args.resource)
        ns = args.namespace if self._namespaced(resource) else ""
        policy = {"foreground": "Foreground", "orphan": "Orphan"}.get(
            getattr(args, "cascade", "background")
        )
        self._client(resource).delete(args.name, ns, propagation_policy=policy)
        self._print(f"{resource}/{args.name} deleted")

    def cmd_scale(self, args) -> None:
        resource, name = args.target.split("/", 1)
        resource = self._resource(resource)
        client = self._client(resource)
        ns = args.namespace if self._namespaced(resource) else ""
        obj = client.get(name, ns)
        obj.spec.replicas = args.replicas
        client.update(obj)
        self._print(f"{resource}/{name} scaled")

    def _patch_map(self, args, field: str) -> None:
        resource = self._resource(args.resource)
        client = self._client(resource)
        ns = args.namespace if self._namespaced(resource) else ""
        obj = client.get(args.name, ns)
        current = dict(getattr(obj.metadata, field) or {})
        for pair in args.pairs:
            if pair.endswith("-"):
                current.pop(pair[:-1], None)
                continue
            key, _, value = pair.partition("=")
            if key in current and not args.overwrite and current[key] != value:
                raise APIError(
                    f"'{key}' already has a value; use --overwrite"
                )
            current[key] = value
        setattr(obj.metadata, field, current or None)
        client.update(obj)
        self._print(f"{resource}/{args.name} {field.rstrip('s')}ed")

    def cmd_label(self, args) -> None:
        self._patch_map(args, "labels")

    def cmd_annotate(self, args) -> None:
        self._patch_map(args, "annotations")

    def cmd_taint(self, args) -> None:
        if self._resource(args.resource) != "nodes":
            raise APIError("taint only applies to nodes")
        node = self.cs.nodes.get(args.name)
        taints = list(node.spec.taints or [])
        for spec in args.taints:
            if spec.endswith("-"):
                key = spec[:-1].split("=")[0].split(":")[0]
                taints = [t for t in taints if t.key != key]
                continue
            kv, _, effect = spec.rpartition(":")
            if not effect:
                raise APIError(f"invalid taint spec {spec!r}")
            key, _, value = kv.partition("=")
            taints = [t for t in taints if not (t.key == key and t.effect == effect)]
            taints.append(v1.Taint(key=key, value=value, effect=effect))
        node.spec.taints = taints or None
        self.cs.nodes.update(node)
        self._print(f"node/{args.name} tainted")

    def _set_unschedulable(self, name: str, value: bool) -> None:
        node = self.cs.nodes.get(name)
        node.spec.unschedulable = value
        self.cs.nodes.update(node)

    def cmd_cordon(self, args) -> None:
        self._set_unschedulable(args.name, True)
        self._print(f"node/{args.name} cordoned")

    def cmd_uncordon(self, args) -> None:
        self._set_unschedulable(args.name, False)
        self._print(f"node/{args.name} uncordoned")

    def cmd_drain(self, args) -> None:
        """Cordon + evict every pod (reference: kubectl drain,
        staging/src/k8s.io/kubectl/pkg/drain/drain.go filters: DaemonSet
        pods need --ignore-daemonsets, unmanaged pods need --force)."""
        self._set_unschedulable(args.name, True)
        self._print(f"node/{args.name} cordoned")
        pods, _ = self.cs.pods.list()
        for pod in pods:
            if pod.spec.node_name != args.name:
                continue
            owner = (pod.metadata.owner_references or [None])[0]
            if owner is not None and owner.kind == "DaemonSet":
                if not args.ignore_daemonsets:
                    raise APIError(
                        f"cannot delete DaemonSet-managed pod {pod.metadata.name} "
                        "(use --ignore-daemonsets)"
                    )
                continue  # ignored, left running
            if owner is None and not args.force:
                raise APIError(
                    f"cannot delete unmanaged pod {pod.metadata.name} (use --force)"
                )
            self.cs.pods.delete(pod.metadata.name, pod.metadata.namespace)
            self._print(f"pod/{pod.metadata.name} evicted")
        self._print(f"node/{args.name} drained")

    def cmd_rollout(self, args) -> None:
        resource, name = args.target.split("/", 1)
        resource = self._resource(resource)
        if resource != "deployments":
            raise APIError("rollout supports deployments")
        dep = self.cs.deployments.get(name, args.namespace)
        if args.action == "status":
            want = dep.spec.replicas if dep.spec.replicas is not None else 1
            have = dep.status.available_replicas or 0
            if have >= want:
                self._print(f'deployment "{name}" successfully rolled out')
            else:
                self._print(
                    f"Waiting for deployment \"{name}\" rollout to finish: "
                    f"{have} of {want} updated replicas are available..."
                )
            return
        if args.action in ("history", "undo"):
            return self._rollout_history_undo(dep, name, args)
        # restart: stamp the pod template (kubectl rollout restart's
        # restartedAt annotation) to trigger a new rollout
        tmpl_meta = dep.spec.template.metadata
        tmpl_meta.annotations = dict(tmpl_meta.annotations or {})
        tmpl_meta.annotations["kubectl.kubernetes.io/restartedAt"] = str(time.time())
        self.cs.deployments.update(dep)
        self._print(f"deployment.apps/{name} restarted")

    def _owned_rs_by_revision(self, dep):
        from ..controllers.deployment import rs_revision

        out = []
        for rs in self.cs.replicasets.list(namespace=dep.metadata.namespace)[0]:
            for ref in rs.metadata.owner_references or []:
                if ref.controller and ref.uid == dep.metadata.uid:
                    out.append((rs_revision(rs), rs))
        out.sort(key=lambda t: t[0])
        return out

    def _rollout_history_undo(self, dep, name, args) -> None:
        """kubectl rollout history/undo (staging kubectl/pkg/polymorphichelpers
        history.go / rollback.go): revisions are the owned ReplicaSets'
        deployment.kubernetes.io/revision annotations; undo copies the
        chosen revision's pod template back into the deployment spec
        (client-side rollback, as kubectl does at this version)."""
        from ..controllers.deployment import POD_TEMPLATE_HASH
        from ..utils import serde as _serde

        revisions = self._owned_rs_by_revision(dep)
        if args.action == "history":
            self._print(f"deployment.apps/{name}")
            self._print("REVISION  CHANGE-CAUSE")
            for rev, rs in revisions:
                cause = (rs.metadata.annotations or {}).get(
                    "kubernetes.io/change-cause", "<none>"
                )
                self._print(f"{rev:<9} {cause}")
            return
        if not revisions:
            raise APIError(f"no rollout history found for deployment {name!r}")
        if args.to_revision:
            match = [rs for rev, rs in revisions if rev == args.to_revision]
            if not match:
                raise APIError(
                    f"unable to find revision {args.to_revision} of "
                    f"deployment {name!r}"
                )
            target = match[0]
        else:
            if len(revisions) < 2:
                raise APIError(f"no previous revision to roll back to for {name!r}")
            target = revisions[-2][1]  # latest-1
        tmpl = _serde.from_dict(
            v1.PodTemplateSpec, _serde.to_dict(target.spec.template)
        )
        labels = dict(tmpl.metadata.labels or {})
        labels.pop(POD_TEMPLATE_HASH, None)
        tmpl.metadata.labels = labels or None
        dep.spec.template = tmpl
        self.cs.deployments.update(dep)
        self._print(f"deployment.apps/{name} rolled back")

    def cmd_logs(self, args) -> None:
        """kubectl logs: pods/{name}/log subresource → node proxy →
        kubelet → CRI ReadLogs (registry/core/pod/rest/log.go)."""
        try:
            lines = self.cs.api.pod_logs(
                args.pod, args.namespace, args.container, args.tail
            )
        except KeyError as e:
            raise APIError(str(e))
        for line in lines:
            self._print(line)

    def cmd_exec(self, args) -> None:
        """kubectl exec: pods/{name}/exec → node proxy → CRI ExecSync."""
        try:
            out, code = self.cs.api.pod_exec(
                args.pod, args.namespace, list(args.cmd), args.container
            )
        except KeyError as e:
            raise APIError(str(e))
        if out:
            self._print(out.rstrip("\n"))
        if code != 0:
            raise APIError(f"command terminated with exit code {code}")

    def cmd_patch(self, args) -> None:
        """kubectl patch (pkg/cmd/patch): strategic (RFC 7386 + merge-
        by-patchMergeKey for the known list fields — containers, env,
        ports, volumes, volumeMounts...; tolerations stay atomic, as in
        the reference), merge-patch (RFC 7386 — lists replace
        wholesale), or JSON-patch (RFC 6902 add/replace/remove)."""
        import copy as _copy

        from ..apiserver.webhook import apply_json_patch

        resource = self._resource(args.resource)
        client = self._client(resource)
        ns = args.namespace if self._namespaced(resource) else ""
        obj = client.get(args.name, ns)
        body = serde.to_dict(obj)
        # malformed patches must surface as 'Error: ...' + exit 1 like
        # every other bad input, not a traceback (run() catches APIError)
        try:
            patch = json.loads(args.patch)
            if args.type == "json":
                patched = apply_json_patch(_copy.deepcopy(body), patch)
            elif args.type == "strategic":
                patched = _strategic_merge(body, patch)
            else:
                patched = _merge_patch(body, patch)
            info = self.cs.api._info(resource)
            new_obj = serde.from_dict(info.type, patched)
        except APIError:
            raise
        except Exception as e:  # noqa: BLE001 — json/pointer/shape errors
            raise APIError(f"invalid patch: {e}")
        new_obj.metadata.resource_version = obj.metadata.resource_version
        if args.subresource == "status":
            client.update_status(new_obj)
        else:
            client.update(new_obj)
        self._print(f"{resource}/{args.name} patched")

    def cmd_attach(self, args) -> None:
        """kubectl attach (pkg/cmd/attach): stream the running
        container's output over the apiserver→kubelet attach session
        (kubelet/streaming.py) until the stream closes or goes idle."""
        try:
            session = self.cs.api.pod_attach(
                args.pod, args.namespace, args.container
            )
        except KeyError as e:
            raise APIError(str(e))
        try:
            while True:
                try:
                    chunk = session.read_stdout(timeout=args.read_timeout)
                except TimeoutError:
                    break  # stream idle: detach (real kubectl stays; this
                    # CLI is non-interactive)
                if chunk is None:
                    break
                self.out.write(chunk.decode(errors="replace"))
            self.out.flush()
        finally:
            session.close()

    def cmd_port_forward(self, args) -> None:
        """kubectl port-forward (pkg/cmd/portforward): forward one
        round of data through the pod's port-forward stream. The real
        kubectl binds a local socket; this terminal-less build forwards
        --send (or stdin) and prints the response."""
        data = args.send.encode() if args.send else sys.stdin.buffer.read()
        try:
            session = self.cs.api.pod_portforward(
                args.pod, args.namespace, args.port
            )
        except KeyError as e:
            raise APIError(str(e))
        try:
            if data:
                session.write_stdin(data)
            try:
                reply = session.read_stdout(timeout=5.0)
            except TimeoutError:
                reply = None
            if reply is not None:
                self.out.write(reply.decode(errors="replace"))
                self.out.flush()
        finally:
            session.close()

    def cmd_wait(self, args) -> None:
        """kubectl wait (pkg/cmd/wait): block until --for is met.
        Supports `delete`, `condition=Type[=Value]` (status.conditions),
        and a field=value form over dotted status paths
        (e.g. status.phase=Running)."""
        resource = self._resource(args.resource)
        client = self._client(resource)
        ns = args.namespace if self._namespaced(resource) else ""
        want = args.condition
        deadline = time.time() + args.timeout
        while time.time() < deadline:
            try:
                obj = client.get(args.name, ns)
            except NotFound:
                if want == "delete":
                    self._print(f"{resource}/{args.name} condition met")
                    return
                time.sleep(0.1)
                continue
            if want != "delete" and _wait_condition_met(obj, want):
                self._print(f"{resource}/{args.name} condition met")
                return
            time.sleep(0.1)
        raise APIError(f"timed out waiting for {want!r} on "
                       f"{resource}/{args.name}")

    def cmd_edit(self, args) -> None:
        """kubectl edit (pkg/cmd/edit): dump the live object as YAML,
        hand it to $KUBE_EDITOR/$EDITOR, apply the edited result as an
        update (resourceVersion preserved for optimistic concurrency)."""
        import os
        import subprocess
        import tempfile

        resource = self._resource(args.resource)
        client = self._client(resource)
        ns = args.namespace if self._namespaced(resource) else ""
        obj = client.get(args.name, ns)
        doc = serde.to_dict(obj)
        editor = os.environ.get("KUBE_EDITOR") or os.environ.get("EDITOR")
        if not editor:
            raise APIError("KUBE_EDITOR or EDITOR must be set for edit")
        with tempfile.NamedTemporaryFile(
            "w", suffix=".yaml", delete=False
        ) as f:
            yaml.safe_dump(doc, f, sort_keys=False)
            path = f.name
        try:
            proc = subprocess.run([*editor.split(), path])
            if proc.returncode != 0:
                raise APIError(f"editor exited with code {proc.returncode}")
            with open(path) as f:
                edited = yaml.safe_load(f.read())
            if edited == doc:
                self._print("Edit cancelled, no changes made.")
                return
            info = self.cs.api._info(resource)
            new_obj = serde.from_dict(info.type, edited)
            new_obj.metadata.resource_version = obj.metadata.resource_version
            client.update(new_obj)
            self._print(f"{resource}/{args.name} edited")
        finally:
            os.unlink(path)

    def cmd_explain(self, args) -> None:
        """kubectl explain (pkg/cmd/explain): field documentation from
        the live type schemas — this build derives the schema from the
        dataclass field tree the serde layer already walks, the runtime
        analog of the reference's published OpenAPI."""
        import dataclasses
        import typing

        parts = args.field_path.split(".")
        resource = self._resource(parts[0])
        info = self.cs.api._info(resource)
        typ = info.type
        for seg in parts[1:]:
            hints = typing.get_type_hints(typ)
            fields = {f.name: f for f in dataclasses.fields(typ)} \
                if dataclasses.is_dataclass(typ) else {}
            json_names = {
                serde._json_key(f): f.name for f in fields.values()
            }
            name = json_names.get(seg, seg)
            if name not in fields:
                raise APIError(
                    f"field {seg!r} does not exist in {typ.__name__}"
                )
            typ = _unwrap_type(hints[name])
        self._print(f"KIND:     {info.type.__name__}")
        self._print(f"RESOURCE: {resource}")
        self._print(f"PATH:     {args.field_path}")
        self._print("")
        self._print(f"FIELD TYPE: {_type_name(typ)}")
        if dataclasses.is_dataclass(typ):
            self._print("FIELDS:")
            self._explain_fields(typ, indent=2,
                                 recursive=args.recursive, seen=set())

    def _explain_fields(self, typ, indent: int, recursive: bool, seen) -> None:
        import dataclasses
        import typing

        if typ in seen:
            return  # recursive types (e.g. ObjectMeta loops)
        seen = seen | {typ}
        hints = typing.get_type_hints(typ)
        for f in dataclasses.fields(typ):
            ft = _unwrap_type(hints[f.name])
            self._print(
                " " * indent + f"{serde._json_key(f)}\t<{_type_name(ft)}>"
            )
            if recursive and dataclasses.is_dataclass(ft):
                self._explain_fields(ft, indent + 2, recursive, seen)

    def cmd_api_resources(self, args) -> None:
        """kubectl api-resources: the server's resource table."""
        rows = []
        for name, info in sorted(self.cs.api._resources.items()):
            t = info.type()
            group = (
                t.api_version.split("/", 1)[0]
                if "/" in t.api_version else ""
            )
            rows.append((
                name, group or "v1",
                "true" if info.namespaced else "false",
                getattr(t, "kind", info.type.__name__),
            ))
        hdr = ("NAME", "APIVERSION", "NAMESPACED", "KIND")
        widths = [
            max(len(h), *(len(r[i]) for r in rows))
            for i, h in enumerate(hdr)
        ]
        self._print("   ".join(h.ljust(w) for h, w in zip(hdr, widths)).rstrip())
        for r in rows:
            self._print(
                "   ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip()
            )

    def cmd_expose(self, args) -> None:
        """kubectl expose (pkg/cmd/expose/exposer... generate.go): create
        a Service whose selector is the target's pod labels."""
        resource, name = args.target.split("/", 1)
        resource = self._resource(resource)
        ns = args.namespace
        obj = self._client(resource).get(
            name, ns if self._namespaced(resource) else "")
        if resource == "services":
            raise APIError("cannot expose a service")
        if resource == "pods":
            selector = dict(obj.metadata.labels or {})
        else:  # deployments / replicasets / replicationcontrollers
            sel = getattr(obj.spec, "selector", None)
            if sel is not None and getattr(sel, "match_labels", None):
                selector = dict(sel.match_labels)
            elif isinstance(sel, dict):
                selector = dict(sel)
            else:
                tmpl = getattr(obj.spec, "template", None)
                selector = dict(
                    (tmpl.metadata.labels or {}) if tmpl else {})
        if not selector:
            raise APIError(
                f"couldn't find a selector to expose {args.target}")
        svc = v1.Service(
            metadata=v1.ObjectMeta(name=args.name or name, namespace=ns),
            spec=v1.ServiceSpec(
                selector=selector,
                type=args.type,
                ports=[v1.ServicePort(
                    protocol=args.protocol, port=args.port,
                    target_port=args.target_port or args.port,
                )],
            ),
        )
        self.cs.resource("services").create(svc)
        self._print(f"service/{svc.metadata.name} exposed")

    def cmd_autoscale(self, args) -> None:
        """kubectl autoscale (pkg/cmd/autoscale/autoscale.go): create a
        HorizontalPodAutoscaler targeting the workload."""
        from ..api import autoscaling

        resource, name = args.target.split("/", 1)
        resource = self._resource(resource)
        obj = self._client(resource).get(name, args.namespace)
        hpa = autoscaling.HorizontalPodAutoscaler(
            metadata=v1.ObjectMeta(
                name=args.name or name, namespace=args.namespace),
            spec=autoscaling.HorizontalPodAutoscalerSpec(
                scale_target_ref=autoscaling.CrossVersionObjectReference(
                    kind=getattr(obj, "kind", "") or "Deployment",
                    name=name,
                    api_version=getattr(obj, "api_version", ""),
                ),
                min_replicas=args.min_replicas,
                max_replicas=args.max_replicas,
                target_cpu_utilization_percentage=(
                    args.cpu_percent if args.cpu_percent >= 0 else None),
            ),
        )
        self.cs.resource("horizontalpodautoscalers").create(hpa)
        self._print(
            f"horizontalpodautoscaler.autoscaling/{hpa.metadata.name} "
            "autoscaled")

    def cmd_auth(self, args) -> None:
        """kubectl auth can-i (pkg/cmd/auth/cani.go): evaluate RBAC for
        the current (or impersonated) identity against the server's
        authorizer; plain servers without RBAC always allow."""
        authorizer = getattr(self.cs.api, "authorizer", None)
        if authorizer is None:
            self._print("yes")  # no RBAC surface: everything allowed
            return
        from ..apiserver.auth import UserInfo
        from ..apiserver.requestcontext import current_user

        user = current_user()
        if args.as_user or args.as_groups:
            # the server only honors --as/--as-group if the CALLER holds
            # the impersonate verb (apiserver filters/impersonation.go);
            # without this gate any identity could probe any other's
            # RBAC. No request context = the in-proc loopback client,
            # which (like the reference's loopback credential) is
            # system:masters and may always impersonate.
            caller = user
            def _can_impersonate(resource: str, name: str) -> bool:
                if caller is None:
                    return True
                return (
                    authorizer.authorize(
                        caller, "impersonate", resource, "", name)
                    or authorizer.authorize(
                        caller, "impersonate", resource, "")
                )
            if args.as_user and not _can_impersonate("users", args.as_user):
                raise APIError(
                    f"user {caller.name!r} cannot impersonate users"
                )
            for g in args.as_groups or []:
                if not _can_impersonate("groups", g):
                    raise APIError(
                        f"user {caller.name!r} cannot impersonate groups"
                    )
            # impersonation carries ONLY the passed identity: inheriting
            # the caller's groups (e.g. system:masters) would make every
            # --as query answer "yes" (kubectl drops to exactly
            # --as/--as-group)
            user = UserInfo(
                name=args.as_user or (user.name if user else ""),
                groups=tuple(args.as_groups),
            )
        if user is None:
            raise APIError("no identity: pass --as or authenticate")
        resource = self._resource(args.resource)
        ok = authorizer.authorize(
            user, args.verb_arg, resource, args.namespace or "",
        )
        self._print("yes" if ok else "no")
        if not ok:
            raise APIError(
                f"user {user.name!r} cannot {args.verb_arg} {resource}"
            )

    def cmd_top(self, args) -> None:
        """kubectl top nodes|pods from the metrics API (metrics.k8s.io;
        staging/src/k8s.io/kubectl/pkg/cmd/top)."""
        from ..api.quantity import Quantity

        resource = self._resource(args.resource)
        hdr = ["NAME", "CPU(cores)", "MEMORY(bytes)"]
        if resource == "nodes":
            metrics, _ = self.cs.resource("nodemetrics").list()
            rows = [
                [
                    m.metadata.name,
                    (m.usage or {}).get("cpu", "0m"),
                    _fmt_mem((m.usage or {}).get("memory", "0")),
                ]
                for m in sorted(metrics, key=lambda m: m.metadata.name)
            ]
        else:
            metrics, _ = self.cs.resource("podmetrics").list(
                namespace=args.namespace
            )
            rows = []
            for m in sorted(metrics, key=lambda m: m.metadata.name):
                cpu = sum(
                    Quantity((c.usage or {}).get("cpu", 0)).milli_value()
                    for c in m.containers or []
                )
                mem = sum(
                    Quantity((c.usage or {}).get("memory", 0)).value()
                    for c in m.containers or []
                )
                rows.append([m.metadata.name, f"{cpu}m", _fmt_mem(str(mem))])
        widths = [
            max(len(hdr[i]), *(len(r[i]) for r in rows)) if rows else len(hdr[i])
            for i in range(len(hdr))
        ]
        self._print("   ".join(h.ljust(w) for h, w in zip(hdr, widths)).rstrip())
        for r in rows:
            self._print("   ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip())


def _merge_patch(body: Dict, patch: Any) -> Any:
    """RFC 7386 merge patch: maps merge recursively, null deletes keys,
    everything else (lists, scalars) replaces. (RFC 6902 json patches
    reuse apiserver/webhook.py apply_json_patch — one implementation.)"""
    if not isinstance(patch, dict):
        return patch
    if not isinstance(body, dict):
        body = {}
    out = dict(body)
    for k, pv in patch.items():
        if pv is None:
            out.pop(k, None)
        else:
            out[k] = _merge_patch(out.get(k), pv)
    return out


# strategic-merge patchMergeKey tags for the well-known list fields
# (reference: the `patchMergeKey` struct tags in staging/src/k8s.io/api/
# core/v1/types.go — e.g. PodSpec.Containers `patchMergeKey:"name"`,
# Container.Ports `patchMergeKey:"containerPort"`, ServiceSpec.Ports
# `patchMergeKey:"port"`; PodSpec.Tolerations has NO tag — atomic).
# The reference derives these from codegen'd struct tags; this build's
# types don't carry tags, so the daily-driver set is pinned by hand.
# Fields whose merge key depends on the parent type ("ports") list the
# candidates in order; the first key present in EVERY item of both
# sides wins (untyped JSON has no parent type to dispatch on).
_STRATEGIC_MERGE_KEYS = {
    "containers": ("name",),
    "initContainers": ("name",),
    "ephemeralContainers": ("name",),
    "env": ("name",),
    "ports": ("containerPort", "port"),
    "volumes": ("name",),
    "volumeMounts": ("mountPath",),
    "imagePullSecrets": ("name",),
    "hostAliases": ("ip",),
}


def _strategic_merge(body: Dict, patch: Any, field: str = "") -> Any:
    """Strategic merge patch: RFC 7386 semantics PLUS merge-by-key for
    the known patchMergeKey lists — a patch naming one container by
    `name` updates that container instead of replacing the whole list
    (strategicpatch.StrategicMergePatch list-of-maps behavior)."""
    if isinstance(patch, list):
        key = next(
            (
                k
                for k in _STRATEGIC_MERGE_KEYS.get(field, ())
                if isinstance(body, list)
                and all(isinstance(x, dict) and k in x for x in patch)
                and all(isinstance(x, dict) and k in x for x in body)
            ),
            None,
        )
        if key:
            out = list(body)
            index = {x[key]: i for i, x in enumerate(out)}
            for item in patch:
                if item.get("$patch") == "delete":
                    idx = index.get(item[key])
                    if idx is not None:
                        out[idx] = None
                    continue
                idx = index.get(item[key])
                if idx is not None:
                    out[idx] = _strategic_merge(out[idx], item)
                else:
                    index[item[key]] = len(out)
                    out.append(item)
            return [x for x in out if x is not None]
        # atomic list replace (no merge key) — but never store directive
        # markers into the object as data
        for x in patch:
            if isinstance(x, dict) and "$patch" in x:
                raise ValueError(
                    f"$patch directive in list field {field!r} without a "
                    "known merge key is not supported"
                )
        return patch
    if not isinstance(patch, dict):
        return patch
    if "$patch" in patch:
        # map-level directives (e.g. {"$patch": "delete"} to clear a
        # whole map) — unimplemented; rejecting beats silently storing
        # the marker as object data
        raise ValueError(
            f"map-level $patch directive {patch['$patch']!r} is not supported"
        )
    if not isinstance(body, dict):
        body = {}
    out = dict(body)
    for k, pv in patch.items():
        if pv is None:
            out.pop(k, None)
        else:
            out[k] = _strategic_merge(out.get(k), pv, field=k)
    return out


def _wait_condition_met(obj, want: str) -> bool:
    """condition=Type[=Value] over status.conditions, or a dotted
    field=value check (status.phase=Running)."""
    if want.startswith("condition="):
        spec = want[len("condition="):]
        ctype, _, cval = spec.partition("=")
        cval = cval or "True"
        for cond in getattr(obj.status, "conditions", None) or []:
            if cond.type == ctype and cond.status == cval:
                return True
        return False
    field, _, val = want.partition("=")
    cur: Any = obj
    for part in field.split("."):
        cur = getattr(cur, part, None)
        if cur is None:
            return False
    return str(cur) == val


def _fmt_mem(qty: str) -> str:
    try:
        from ..api.quantity import Quantity

        mib = Quantity(qty).value() // (1024 * 1024)
        return f"{mib}Mi"
    except Exception:  # noqa: BLE001
        return qty


def _three_way_merge(prev: Any, live: Any, new: Any) -> Any:
    """Untyped 3-way JSON merge: fields in new win; fields present in prev
    but gone from new are deleted from live; everything else keeps the live
    value. Lists replace wholesale (JSON-merge-patch semantics; the
    reference additionally does strategic list merges for typed fields)."""
    if not (isinstance(live, dict) and isinstance(new, dict)):
        return new
    prev = prev if isinstance(prev, dict) else {}
    out = dict(live)
    for key in set(prev) - set(new):
        out.pop(key, None)
    for key, val in new.items():
        out[key] = _three_way_merge(prev.get(key), live.get(key), val)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    """Standalone entry: drives a fresh in-proc cluster (demo use)."""
    from ..apiserver.server import APIServer
    from ..client.clientset import Clientset

    return Kubectl(Clientset(APIServer())).run(argv or sys.argv[1:])


def _unwrap_type(tp):
    """Optional[X] -> X; List[X] -> X; Dict stays Dict (explain shows
    the container kind via _type_name)."""
    import typing

    origin = typing.get_origin(tp)
    if origin is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        return _unwrap_type(args[0]) if args else tp
    if origin in (list, tuple):
        args = typing.get_args(tp)
        return _unwrap_type(args[0]) if args else tp
    return tp


def _type_name(tp) -> str:
    import dataclasses
    import typing

    origin = typing.get_origin(tp)
    if origin is dict:
        return "map[string]string"
    if dataclasses.is_dataclass(tp):
        return f"Object({tp.__name__})"
    return getattr(tp, "__name__", str(tp))
