"""CustomResourceDefinitions: dynamic API extension.

Reference: staging/src/k8s.io/apiextensions-apiserver — CRD types
(pkg/apis/apiextensions/types.go CustomResourceDefinition), the serving
path that turns a CRD into live REST endpoints for unstructured objects,
and structural-schema validation (pkg/apiserver/schema). Scoped here to
the control-plane-relevant behavior: creating a CustomResourceDefinition
registers the plural resource with the apiserver (CRUD + watch work
immediately, informers and kubectl included), deletion unregisters it,
and an optional structural schema validates custom objects at admission.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..api import types as v1
from .server import APIServer, Invalid, ResourceInfo


class Unstructured:
    """Schema-less API object (apiextensions' unstructured.Unstructured):
    arbitrary wire fields plus typed metadata access.

    Serde deep-copies the payload in BOTH directions: the apiserver
    promises callers can never alias stored state, and typed dataclasses
    get that from field-by-field rebuild — an unstructured object must
    pay an explicit deep copy instead (the native store's JSON boundary
    provides it for free; the pure-Python store does not)."""

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        self._data: Dict[str, Any] = dict(data or {})
        meta = self._data.get("metadata") or {}
        from ..utils import serde

        self.metadata: v1.ObjectMeta = serde.from_dict(v1.ObjectMeta, meta)

    @property
    def kind(self) -> str:
        return self._data.get("kind", "")

    @property
    def api_version(self) -> str:
        return self._data.get("apiVersion", "")

    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    # serde protocol: metadata (possibly mutated, e.g. uid/resourceVersion
    # stamping) wins over the raw dict copy
    def __serde_to_dict__(self) -> Dict[str, Any]:
        import copy

        from ..utils import serde

        out = copy.deepcopy(self._data)
        out["metadata"] = serde.to_dict(self.metadata)
        return out

    @classmethod
    def __serde_from_dict__(cls, data: Dict[str, Any]) -> "Unstructured":
        import copy

        return cls(copy.deepcopy(data))


# -- CRD API types ----------------------------------------------------------


@dataclass
class CustomResourceDefinitionNames:
    plural: str = ""
    singular: str = ""
    kind: str = ""
    short_names: Optional[List[str]] = None


@dataclass
class JSONSchemaProps:
    """Structural-schema subset (apiextensions JSONSchemaProps): type,
    properties, required, items."""

    type: str = ""
    properties: Optional[Dict[str, "JSONSchemaProps"]] = None
    required: Optional[List[str]] = None
    items: Optional["JSONSchemaProps"] = None


@dataclass
class CustomResourceValidation:
    open_apiv3_schema: Optional[JSONSchemaProps] = field(
        default=None, metadata={"json": "openAPIV3Schema"}
    )


@dataclass
class CustomResourceDefinitionVersion:
    name: str = "v1"
    served: bool = True
    storage: bool = True
    schema: Optional[CustomResourceValidation] = None


@dataclass
class CustomResourceDefinitionSpec:
    group: str = ""
    names: CustomResourceDefinitionNames = field(
        default_factory=CustomResourceDefinitionNames
    )
    scope: str = "Namespaced"  # Namespaced | Cluster
    versions: Optional[List[CustomResourceDefinitionVersion]] = None


@dataclass
class CustomResourceDefinitionStatus:
    accepted_names: Optional[CustomResourceDefinitionNames] = None
    stored_versions: Optional[List[str]] = None


@dataclass
class CustomResourceDefinition:
    metadata: v1.ObjectMeta = field(default_factory=v1.ObjectMeta)
    spec: CustomResourceDefinitionSpec = field(
        default_factory=CustomResourceDefinitionSpec
    )
    status: CustomResourceDefinitionStatus = field(
        default_factory=CustomResourceDefinitionStatus
    )
    kind: str = "CustomResourceDefinition"
    api_version: str = "apiextensions.k8s.io/v1"


# -- schema validation -------------------------------------------------------

_TYPE_CHECKS = {
    "object": lambda v: isinstance(v, dict),
    "array": lambda v: isinstance(v, list),
    "string": lambda v: isinstance(v, str),
    "integer": lambda v: isinstance(v, int) and not isinstance(v, bool),
    "number": lambda v: isinstance(v, (int, float)) and not isinstance(v, bool),
    "boolean": lambda v: isinstance(v, bool),
}


def validate_schema(schema: Optional[JSONSchemaProps], value: Any, path: str = "") -> None:
    """Structural-schema validation (apiextensions-apiserver
    pkg/apiserver/schema/validation.go, subset)."""
    if schema is None:
        return
    if schema.type:
        check = _TYPE_CHECKS.get(schema.type)
        if check is not None and value is not None and not check(value):
            raise Invalid(f"{path or '<root>'}: expected {schema.type}")
    if isinstance(value, dict):
        for req in schema.required or []:
            if req not in value:
                raise Invalid(f"{path or '<root>'}: required field {req!r} missing")
        for key, sub in (schema.properties or {}).items():
            if key in value:
                validate_schema(sub, value[key], f"{path}.{key}" if path else key)
    if isinstance(value, list) and schema.items is not None:
        for i, item in enumerate(value):
            validate_schema(schema.items, item, f"{path}[{i}]")


# -- the apiextensions "apiserver" ------------------------------------------


class CRDManager:
    """Turns CRD objects into live resources on an APIServer.

    install() registers the customresourcedefinitions resource and an
    admission hook; each created CRD immediately serves its plural
    resource as Unstructured objects (the reference runs a dedicated
    apiextensions-apiserver behind the aggregator for this; in-proc, the
    dynamic registry IS the serving layer).
    """

    def __init__(self, api: APIServer):
        self.api = api
        self._schemas: Dict[str, JSONSchemaProps] = {}  # resource -> schema
        import threading

        self._lock = threading.Lock()
        # last store revision applied per CRD name: post-write hooks run
        # outside the server's write lock, so two racing writers' hooks
        # can arrive inverted — apply only monotonically by revision
        self._applied_rev: Dict[str, int] = {}

    def install(self) -> "CRDManager":
        self.api.register_resource(
            ResourceInfo(
                "customresourcedefinitions", CustomResourceDefinition, False
            )
        )
        self.api._mutating.append(self._admit)
        self.api._post_write.append(self._on_write)
        # re-register resources for CRDs already in the store (restart path)
        try:
            crds, _ = self.api.list("customresourcedefinitions")
        except Exception:  # noqa: BLE001
            crds = []
        for crd in crds:
            self._register(crd)
        return self

    # admission hook: validate CRDs and custom objects. Serving-state
    # changes happen in _on_write — AFTER the store accepted the write —
    # so a rejected create/update (AlreadyExists/Conflict) can't mutate
    # what is served.
    def _admit(self, resource: str, op: str, obj: Any) -> None:
        if resource == "customresourcedefinitions":
            if op in ("CREATE", "UPDATE"):
                self._validate_crd(obj)
            return
        if resource in self._schemas and op in ("CREATE", "UPDATE"):
            from ..utils import serde

            validate_schema(self._schemas[resource], serde.to_dict(obj))

    def _on_write(self, resource: str, op: str, obj: Any) -> None:
        if resource != "customresourcedefinitions":
            return
        with self._lock:
            rev = int(obj.metadata.resource_version or 0)
            if rev <= self._applied_rev.get(obj.metadata.name, 0):
                return  # a later write's hook already ran
            self._applied_rev[obj.metadata.name] = rev
            if op == "DELETE":
                self.uninstall_crd(obj)
            else:
                self._register(obj)

    @staticmethod
    def _validate_crd(crd: CustomResourceDefinition) -> None:
        names = crd.spec.names
        if not crd.spec.group or not names.plural or not names.kind:
            raise Invalid("CRD needs spec.group, spec.names.plural, spec.names.kind")
        expected = f"{names.plural}.{crd.spec.group}"
        if crd.metadata.name != expected:
            raise Invalid(f"CRD metadata.name must be {expected!r}")

    def _register(self, crd: CustomResourceDefinition) -> None:
        names = crd.spec.names
        self.api.register_resource(
            ResourceInfo(
                names.plural, Unstructured, crd.spec.scope == "Namespaced"
            )
        )
        storage = next(
            (ver for ver in crd.spec.versions or [] if ver.storage),
            None,
        )
        schema = None
        if storage is not None and storage.schema is not None:
            schema = storage.schema.open_apiv3_schema
        if schema is not None:
            self._schemas[names.plural] = schema
        else:
            self._schemas.pop(names.plural, None)

    def uninstall_crd(self, crd: CustomResourceDefinition) -> None:
        """Called on CRD deletion: stop serving the resource (existing
        objects remain in the store, as the reference's finalizer would
        otherwise drain them)."""
        self.api._resources.pop(crd.spec.names.plural, None)
        self._schemas.pop(crd.spec.names.plural, None)
