"""HttpStore: the Store interface over the k8s-shaped REST API.

Counterpart of ``grove_tpu/cluster/client.py``, with the same names, wire
format and status codes.

The typed-client + informer layer of the reference (generated clientsets in
operator/client/ + scheduler/client/, SURVEY §2.1 'Generated clients') in one
class: CRUD verbs map to HTTP calls against grove_tpu_torch.cluster.apiserver (or
any server speaking the same wire shape), and `start()` opens one list+watch
stream per kind feeding the same subscriber callbacks the in-memory Store
emits — so the Engine and all controllers run UNCHANGED against a live
apiserver.
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, Dict, List, Optional

from grove_tpu_torch.api.serialize import export_object
from grove_tpu_torch.api.wire import KIND_REGISTRY, decode_object
from grove_tpu_torch.runtime.clock import Clock
from grove_tpu_torch.runtime.errors import (
    ERR_CONFLICT,
    ERR_CREATE_RESOURCE,
    ERR_FORBIDDEN,
    ERR_NOT_FOUND,
    ERR_TRANSPORT,
    GroveError,
)
from grove_tpu_torch.runtime.store import WatchEvent

# kinds the operator watches (controller/register.py wiring)
DEFAULT_WATCH_KINDS = (
    "PodCliqueSet",
    "PodClique",
    "PodCliqueScalingGroup",
    "PodGang",
    "Pod",
)

_CODE_FOR_STATUS = {
    404: ERR_NOT_FOUND,
    409: ERR_CONFLICT,
    403: ERR_FORBIDDEN,
    422: "ERR_VALIDATION",
}


class _PodSpecShim:
    """The single pod-spec field the watch predicates compare."""

    __slots__ = ("scheduling_gates",)

    def __init__(self, gates) -> None:
        self.scheduling_gates = gates


class _OldView:
    """Predicate-sufficient retention of a watched object for
    WatchEvent.old: shares the decoded metadata and status sub-objects and
    keeps spec only where a registered predicate compares it (PodGang spec
    membership; the Pod scheduling-gate list as a shim). Everything else —
    for Pods, the whole container/env template — is dropped, so the
    informer-local `last` map no longer duplicates a second fully-decoded
    copy of every live object (~47k pod specs in cluster mode)."""

    __slots__ = ("kind", "metadata", "status", "spec")

    def __init__(self, obj) -> None:
        self.kind = obj.kind
        self.metadata = obj.metadata
        self.status = getattr(obj, "status", None)
        if obj.kind == "PodGang":
            self.spec = obj.spec  # podgang_phase_or_spec_changed compares it
        elif obj.kind == "Pod":
            self.spec = _PodSpecShim(obj.spec.scheduling_gates)
        else:
            self.spec = None  # no registered predicate reads old.spec


class HttpStore:
    """Store-compatible client over HTTP. Reads are live (no informer lag);
    watches feed subscribe() callbacks from per-kind reader threads."""

    def __init__(
        self,
        base_url: str,
        clock: Optional[Clock] = None,
        watch_kinds=DEFAULT_WATCH_KINDS,
        username: Optional[str] = None,
    ) -> None:
        self.base_url = base_url.rstrip("/")
        self.clock = clock or Clock()
        self.cache_lag = False  # no informer-staleness modeling client-side
        self.guard = None
        self.error_injectors: Dict[str, Callable] = {}
        self.watch_kinds = tuple(watch_kinds)
        self._watchers: List[Callable[[WatchEvent], None]] = []
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        self._username = username
        self._local = threading.local()

    # -- impersonation ----------------------------------------------------

    def as_user(self, username: str):
        from contextlib import contextmanager

        @contextmanager
        def _cm():
            prev = getattr(self._local, "user", None)
            self._local.user = username
            try:
                yield self
            finally:
                self._local.user = prev

        return _cm()

    # -- HTTP plumbing ----------------------------------------------------

    def _path(self, kind: str, namespace: Optional[str], name: Optional[str]) -> str:
        info = KIND_REGISTRY[kind]
        root = "/api/v1" if not info.group else f"/apis/{info.group}/{info.version}"
        parts = [root]
        if info.namespaced and namespace is not None:
            parts.append(f"namespaces/{urllib.parse.quote(namespace)}")
        parts.append(info.plural)
        if name is not None:
            parts.append(urllib.parse.quote(name))
        return "/".join(parts)

    def _request(
        self,
        method: str,
        path: str,
        body: Optional[dict] = None,
        query: Optional[Dict[str, str]] = None,
        operation: str = "",
    ) -> dict:
        url = self.base_url + path
        if query:
            url += "?" + urllib.parse.urlencode(query)
        data = json.dumps(body).encode() if body is not None else None
        headers = {"Content-Type": "application/json"}
        user = getattr(self._local, "user", None) or self._username
        if user:
            headers["Impersonate-User"] = user
        req = urllib.request.Request(url, data=data, headers=headers, method=method)
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                return json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as e:
            try:
                payload = json.loads(e.read() or b"{}")
            except Exception:
                payload = {}
            raise GroveError(
                _CODE_FOR_STATUS.get(e.code, ERR_CREATE_RESOURCE),
                payload.get("message", str(e)),
                operation or method.lower(),
            ) from None
        except (urllib.error.URLError, TimeoutError, OSError) as e:
            # transport failure (apiserver restart, connection reset, socket
            # timeout): typed like any other store error so callers' retry
            # paths — reconcile requeues, the external scheduler loop —
            # treat it as transient instead of dying on a raw urllib error
            raise GroveError(
                ERR_TRANSPORT, str(e), operation or method.lower()
            ) from None

    # -- watch ------------------------------------------------------------

    def subscribe(self, fn: Callable[[WatchEvent], None]) -> None:
        self._watchers.append(fn)

    def start(self) -> "HttpStore":
        """Open one list+watch stream per kind (informer equivalent)."""
        for kind in self.watch_kinds:
            t = threading.Thread(
                target=self._watch_loop, args=(kind,),
                name=f"watch-{kind}", daemon=True,
            )
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()

    def _watch_loop(self, kind: str) -> None:
        path = self._path(kind, None, None)
        url = self.base_url + path + "?watch=true"
        # informer-local last-seen objects: lets MODIFIED events carry the
        # previous object (WatchEvent.old) so transition predicates work in
        # cluster mode too; a reconnect clears it (old=None fails open).
        # Stored as predicate-sufficient _OldView slices, not full decodes.
        last: dict = {}
        while not self._stop.is_set():
            try:
                with urllib.request.urlopen(url, timeout=None) as resp:
                    for raw in resp:
                        if self._stop.is_set():
                            return
                        line = raw.strip()
                        if not line:
                            continue
                        payload = json.loads(line)
                        obj = decode_object(payload["object"])
                        key = (obj.metadata.namespace, obj.metadata.name)
                        # wire uses k8s event casing; Store uses title case
                        type_ = payload["type"].capitalize()
                        old = last.get(key)
                        if type_ == "Deleted":
                            last.pop(key, None)
                        else:
                            last[key] = _OldView(obj)
                        ev = WatchEvent(
                            type=type_, kind=kind, obj=obj, old=old
                        )
                        for w in list(self._watchers):
                            w(ev)
            except Exception:
                if self._stop.is_set():
                    return
                last.clear()
                self._stop.wait(0.2)  # reconnect (server restart etc.)

    # -- CRUD -------------------------------------------------------------

    def create(self, obj, consume: bool = False, share: bool = False):
        # `consume`/`share` are Store-interface fast-path markers; over
        # HTTP every request body is a private JSON export already
        doc = export_object(obj)
        out = self._request(
            "POST",
            self._path(obj.kind, obj.metadata.namespace, None),
            body=doc,
            operation="create",
        )
        return decode_object(out)

    def get(
        self,
        kind: str,
        namespace: str,
        name: str,
        cached: bool = False,
        readonly: bool = False,
    ):
        # `readonly` is a Store-interface contract marker: over HTTP every
        # response is already a private decode, so it changes nothing here
        try:
            out = self._request(
                "GET", self._path(kind, namespace, name), operation="get"
            )
        except GroveError as e:
            if e.code == ERR_NOT_FOUND:
                return None
            raise
        return decode_object(out)

    def scan(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[Dict[str, str]] = None,
        cached: bool = False,
    ):
        """Store.scan parity: over HTTP a list response is already private
        decoded objects, so scan == iterate the list."""
        return iter(self.list(kind, namespace, label_selector, cached))

    def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[Dict[str, str]] = None,
        cached: bool = False,
    ) -> List[object]:
        query = {}
        if label_selector:
            query["labelSelector"] = ",".join(
                f"{k}={v}" for k, v in sorted(label_selector.items())
            )
        out = self._request(
            "GET",
            self._path(kind, namespace, None),
            query=query or None,
            operation="list",
        )
        return [decode_object(item) for item in out.get("items", [])]

    def update(self, obj, bump_generation: bool = True):
        out = self._request(
            "PUT",
            self._path(obj.kind, obj.metadata.namespace, obj.metadata.name),
            body=export_object(obj),
            operation="update",
        )
        return decode_object(out)

    def update_status(self, obj):
        out = self._request(
            "PUT",
            self._path(obj.kind, obj.metadata.namespace, obj.metadata.name)
            + "/status",
            body=export_object(obj),
            operation="update_status",
        )
        return decode_object(out)

    def delete(self, kind: str, namespace: str, name: str) -> None:
        self._request(
            "DELETE", self._path(kind, namespace, name), operation="delete"
        )

    def read_modify_write(
        self, kind: str, namespace: str, name: str, mutate, attempts: int = 8
    ):
        """Optimistic-concurrency write loop: GET the LIVE object, apply
        `mutate(obj)` (edit in place; return False to skip the write), PUT,
        and retry from a fresh read on 409 — so a racing writer's changes
        are never clobbered (the mutation is re-applied to their version,
        kubectl-style). Returns the updated object, or None if the object
        does not exist / disappeared mid-loop."""
        for _ in range(attempts):
            obj = self.get(kind, namespace, name)
            if obj is None:
                return None
            if mutate(obj) is False:
                return obj
            try:
                return self.update(obj)
            except GroveError as e:
                if e.code != ERR_CONFLICT:
                    raise
        raise GroveError(
            ERR_CONFLICT,
            f"{kind} {namespace}/{name}: write kept conflicting after"
            f" {attempts} attempts",
            "read_modify_write",
        )

    def remove_finalizer(
        self, kind: str, namespace: str, name: str, finalizer: str
    ) -> None:
        """Client-side finalizer drain: the server completes the deletion
        when the list empties."""

        def drop(obj):
            if finalizer not in obj.metadata.finalizers:
                return False
            obj.metadata.finalizers = [
                f for f in obj.metadata.finalizers if f != finalizer
            ]

        self.read_modify_write(kind, namespace, name, drop)

    def delete_collection(
        self,
        kind: str,
        namespace: str,
        label_selector: Optional[Dict[str, str]] = None,
    ) -> int:
        query = {}
        if label_selector:
            query["labelSelector"] = ",".join(
                f"{k}={v}" for k, v in sorted(label_selector.items())
            )
        out = self._request(
            "DELETE",
            self._path(kind, namespace, None),
            query=query or None,
            operation="delete_collection",
        )
        return int(out.get("deleted", 0))
