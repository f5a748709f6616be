"""Envtest-style HTTP apiserver over the in-memory Store.

Counterpart of ``grove_tpu/cluster/apiserver.py``, with the same names, wire
format and status codes.

Speaks the k8s REST wire shape the reference operator talks to:

    GET/POST   /apis/{group}/{version}/namespaces/{ns}/{plural}
    GET/PUT/DELETE  .../{plural}/{name}
    PUT        .../{plural}/{name}/status          (status subresource)
    GET        .../{plural}?watch=true             (list+watch stream)
    DELETE     .../{plural}?labelSelector=...      (delete collection)
    /api/v1/... for core kinds; cluster-scoped paths omit namespaces/{ns}

plus /healthz /readyz /metrics. Admission webhooks (mutating → validating)
are invoked over HTTP on create/update of configured kinds, mirroring the
registration boundary of
upstream operator/internal/webhook/register.go:35-75. Writes carry an
optional Impersonate-User header honored via the store's actor context
(authorizer parity: admission/pcs/authorization/handler.go:51-158).

This is both the e2e harness's fake cluster (reference envtest tier,
SURVEY §4.2) and the wire contract an external scheduler (KAI-equivalent)
can consume PodGangs from.
"""

from __future__ import annotations

import json
import math
import queue
import threading
import urllib.parse
import urllib.request
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Tuple

from grove_tpu_torch.api.serialize import export_object
from grove_tpu_torch.api.wire import (
    KIND_REGISTRY,
    KindInfo,
    decode_object,
    resolve_path_kind,
)
from grove_tpu_torch.observability.metrics import METRICS
from grove_tpu_torch.runtime.clock import Clock
from grove_tpu_torch.runtime.errors import (
    ERR_CONFLICT,
    ERR_FORBIDDEN,
    ERR_NOT_FOUND,
    GroveError,
)
from grove_tpu_torch.runtime.store import Store, WatchEvent


@dataclass
class WebhookRegistration:
    """One admission webhook the server calls for matching writes
    (webhook/register.go registers defaulting, validation, authorization)."""

    name: str
    kinds: List[str]
    url: str
    mutating: bool = False
    operations: Tuple[str, ...] = ("CREATE", "UPDATE")
    # CA bundle file for TLS webhook endpoints (cert.py output)
    ca_file: Optional[str] = None


@dataclass
class AdmissionDenied(Exception):
    message: str


def _http_status_for(err: GroveError) -> int:
    return {
        ERR_NOT_FOUND: 404,
        ERR_CONFLICT: 409,
        ERR_FORBIDDEN: 403,
    }.get(err.code, 500)


@dataclass
class _WatchSub:
    q: "queue.Queue[Optional[WatchEvent]]"
    kind: str
    namespace: Optional[str]
    selector: Optional[Dict[str, str]]


def _sample_profile(seconds: float, hz: float = 100.0) -> str:
    """In-process sampling profiler: aggregate (file:line function) frame
    counts across ALL threads for `seconds` — the whole-process view a
    pprof endpoint gives, without a tracing profiler's overhead."""
    import sys
    import time as _time

    counts: Dict[str, int] = {}
    own = threading.get_ident()
    deadline = _time.monotonic() + seconds
    interval = 1.0 / hz
    samples = 0
    while _time.monotonic() < deadline:
        for tid, frame in sys._current_frames().items():
            if tid == own:
                continue
            while frame is not None:
                code = frame.f_code
                key = f"{code.co_filename}:{frame.f_lineno} {code.co_name}"
                counts[key] = counts.get(key, 0) + 1
                frame = frame.f_back
        samples += 1
        _time.sleep(interval)
    lines = [f"# {samples} samples over {seconds}s at ~{hz:.0f}Hz"]
    for key, n in sorted(counts.items(), key=lambda kv: -kv[1])[:80]:
        lines.append(f"{n:8d} {key}")
    return "\n".join(lines) + "\n"


def parse_label_selector(raw: Optional[str]) -> Optional[Dict[str, str]]:
    if not raw:
        return None
    out: Dict[str, str] = {}
    for part in raw.split(","):
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"unsupported label selector: {raw!r}")
        k, _, v = part.partition("=")
        out[k.strip()] = v.strip()
    return out


class APIServer:
    def __init__(
        self,
        store: Optional[Store] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        webhooks: Optional[List[WebhookRegistration]] = None,
        enable_profiling: bool = False,
        node_provider: Optional[Callable[[], List[dict]]] = None,
    ) -> None:
        self.store = store or Store(Clock())
        self.lock = threading.RLock()
        # GET /nodes source (docs/observability.md): wire-shape node rows
        # — typically NodeHealthMonitor.node_snapshot. Nodes are cluster
        # infrastructure, not store objects, so they arrive by callback;
        # None → an empty list (server without a sim cluster attached).
        self.node_provider = node_provider
        # POST /nodes/{name}/drain and /uncordon (docs/robustness.md):
        # callbacks into the NodeDrainController — name -> wire row, or
        # None for an unknown node. Unset → 404 (no drain controller).
        self.drain_handler: Optional[Callable[[str], Optional[dict]]] = None
        self.uncordon_handler: Optional[Callable[[str], Optional[dict]]] = None
        # admission explain engine (observability/explain.py,
        # docs/observability.md "Admission explain"): GET
        # /gangs/{ns}/{name}/explain, GET /debug/capacity, POST
        # /debug/whatif, and the /debug/journeys pending annotation all
        # serve from it. Unset → 404 (no scheduler attached). Read-only
        # by contract (grovelint GL016), so handlers run WITHOUT
        # server.lock — an explain burst must never stall writes.
        self.explain_engine = None
        # federation tier (federation/router.py, docs/federation.md):
        # GET /federation serves the router's status() document — region
        # registry, placement counts, spillover/re-route counters, the
        # decision-ledger length, and the global quota fold. Arrives by
        # callback like node_provider (the router is sim infrastructure,
        # not a store object). Unset → 404 (no federation tier).
        self.federation_provider: Optional[Callable[[], dict]] = None
        # config-gated like the reference pprof listener (manager.go:108-113)
        # and serialized: concurrent samplers would degrade the whole
        # control plane (every 100Hz stack walk contends on the GIL)
        self.enable_profiling = enable_profiling
        self._profile_lock = threading.Lock()
        self.webhooks = webhooks or []
        self._subs: List[_WatchSub] = []
        self._subs_lock = threading.Lock()
        self.store.subscribe(self._fanout)
        self._httpd = ThreadingHTTPServer((host, port), self._make_handler())
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -------------------------------------------------------

    @property
    def address(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "APIServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="grove-apiserver", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        with self._subs_lock:
            for sub in self._subs:
                sub.q.put(None)
            self._subs.clear()

    # -- watch fanout ----------------------------------------------------

    def _fanout(self, ev: WatchEvent) -> None:
        from grove_tpu_torch.runtime.store import matches_labels

        with self._subs_lock:
            subs = list(self._subs)
        for sub in subs:
            if sub.kind != ev.kind:
                continue
            if (
                sub.namespace is not None
                and ev.obj.metadata.namespace != sub.namespace
            ):
                continue
            if not matches_labels(ev.obj, sub.selector):
                continue
            sub.q.put(ev)

    # -- admission -------------------------------------------------------

    def _call_webhook(
        self, reg: WebhookRegistration, review: dict
    ) -> dict:
        data = json.dumps(review).encode()
        req = urllib.request.Request(
            reg.url,
            data=data,
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        import ssl

        ctx = None
        if reg.url.startswith("https"):
            ctx = ssl.create_default_context(cafile=reg.ca_file)
        with urllib.request.urlopen(req, timeout=10, context=ctx) as resp:
            return json.loads(resp.read())

    def _admit(
        self,
        doc: dict,
        operation: str,
        username: str,
        old_doc: Optional[dict] = None,
    ) -> dict:
        """Run the webhook chain: mutating first, then validating — the
        order register.go implies (defaulting webhook path precedes
        validation)."""
        kind = doc.get("kind", "")
        for reg in self.webhooks:
            if kind not in reg.kinds or operation not in reg.operations:
                continue
            review = {
                "apiVersion": "admission.k8s.io/v1",
                "kind": "AdmissionReview",
                "request": {
                    "operation": operation,
                    "userInfo": {"username": username},
                    "object": doc,
                    "oldObject": old_doc,
                },
            }
            out = self._call_webhook(reg, review).get("response", {})
            if not out.get("allowed", False):
                raise AdmissionDenied(
                    out.get("status", {}).get("message", "admission denied")
                )
            if reg.mutating and out.get("patchedObject") is not None:
                doc = out["patchedObject"]
        return doc

    # -- handler ---------------------------------------------------------

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet
                pass

            # ---- helpers

            def _send_json(self, code: int, payload) -> None:
                # payload: any JSON document (object or array)
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _error(self, code: int, message: str, reason: str = "") -> None:
                self._send_json(
                    code,
                    {
                        "kind": "Status",
                        "status": "Failure",
                        "code": code,
                        "reason": reason,
                        "message": message,
                    },
                )

            def _query_float(self, name: str, default: float):
                """One finite POSITIVE float query parameter, or None
                when the raw value is unparseable, non-finite, or not
                positive (callers 400) — every current caller is a
                window length, where 0 is meaningless."""
                query = urllib.parse.parse_qs(
                    urllib.parse.urlsplit(self.path).query
                )
                raw = (query.get(name) or [None])[0]
                if raw is None:
                    return default
                try:
                    value = float(raw)
                except ValueError:
                    return None
                if not math.isfinite(value) or value <= 0:
                    return None
                return value

            def _body(self) -> dict:
                length = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(length) if length else b"{}"
                return json.loads(raw or b"{}")

            def _route(self):
                """Parse path → (info, namespace, name, subresource, query)."""
                parsed = urllib.parse.urlsplit(self.path)
                query = urllib.parse.parse_qs(parsed.query)
                parts = [
                    urllib.parse.unquote(p)
                    for p in parsed.path.split("/")
                    if p
                ]
                # /api/v1/... (core) or /apis/{group}/{version}/...
                if not parts:
                    return None
                if parts[0] == "api" and len(parts) >= 2:
                    group, version, rest = "", parts[1], parts[2:]
                elif parts[0] == "apis" and len(parts) >= 3:
                    group, version, rest = parts[1], parts[2], parts[3:]
                else:
                    return None
                namespace: Optional[str] = None
                if len(rest) >= 2 and rest[0] == "namespaces":
                    namespace, rest = rest[1], rest[2:]
                if not rest:
                    return None
                info = resolve_path_kind(group, version, rest[0])
                if info is None:
                    return None
                name = rest[1] if len(rest) >= 2 else None
                sub = rest[2] if len(rest) >= 3 else None
                if info.namespaced and namespace is None and name is not None:
                    # namespaced kind addressed without a namespace
                    return None
                if not info.namespaced:
                    namespace = ""
                return info, namespace, name, sub, query

            def _username(self) -> str:
                from grove_tpu_torch.admission.authorization import OPERATOR_USERNAME

                return self.headers.get("Impersonate-User") or OPERATOR_USERNAME

            # ---- verbs

            def do_GET(self):
                path = urllib.parse.urlsplit(self.path).path
                if path in ("/healthz", "/readyz", "/livez"):
                    body = b"ok"
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if path == "/metrics":
                    body = METRICS.prometheus_text().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type", "text/plain; version=0.0.4"
                    )
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if path == "/debug/traces":
                    # span summary: per-span-name count/total/p50/p99
                    # (observability/tracing.py; tracer is process-global —
                    # populated when the operator runs in this process)
                    from grove_tpu_torch.observability.tracing import TRACER

                    return self._send_json(200, TRACER.summary_json())
                if path == "/debug/traces/chrome":
                    # Chrome trace_event array: load in chrome://tracing or
                    # Perfetto (docs/observability.md)
                    from grove_tpu_torch.observability.tracing import TRACER

                    return self._send_json(200, TRACER.chrome_trace())
                if path == "/queues":
                    # quota subsystem summary (docs/quota.md): per-queue
                    # deserved/ceiling/usage/dominant-share + gang counts,
                    # full-scan authoritative (includes implicit queues)
                    from grove_tpu_torch.quota.manager import quota_snapshot

                    with server.lock:
                        items = quota_snapshot(server.store)
                    return self._send_json(
                        200, {"kind": "QueueSummaryList", "items": items}
                    )
                if path == "/nodes":
                    # node health table (docs/robustness.md): name, state
                    # (Ready/NotReady/Lost), cordon flag, drain state,
                    # heartbeat age, capacity, labels, bound-pod count.
                    # NOT under server.lock: in real-cluster mode the
                    # provider's store is an HttpStore pointed back at THIS
                    # server (drain states live in NodeDrain objects), and
                    # the nested request would deadlock on the held lock.
                    # The provider serves from point-in-time copies.
                    items = (
                        server.node_provider()
                        if server.node_provider is not None
                        else []
                    )
                    return self._send_json(
                        200, {"kind": "NodeList", "items": items}
                    )
                if path == "/events":
                    # deduped k8s-style Events (count/first/lastTimestamp),
                    # filterable: ?namespace=...&reason=...&kind=...
                    from grove_tpu_torch.observability.events import EVENTS

                    query = urllib.parse.parse_qs(
                        urllib.parse.urlsplit(self.path).query
                    )

                    def qp(name):
                        return (query.get(name) or [None])[0]

                    items = EVENTS.list(
                        namespace=qp("namespace"),
                        reason=qp("reason"),
                        kind=qp("kind"),
                    )
                    return self._send_json(
                        200,
                        {
                            "kind": "EventList",
                            "items": [e.as_dict() for e in items],
                        },
                    )
                if path == "/debug/profile":
                    query = urllib.parse.parse_qs(
                        urllib.parse.urlsplit(self.path).query
                    )
                    if "seconds" not in query:
                        # wall-attribution report (observability/profile.py,
                        # docs/observability.md): the per-(controller,
                        # shard, phase) self-time ledger — process-global,
                        # populated when the operator runs in this process
                        # with GROVE_TPU_PROFILE=1
                        from grove_tpu_torch.observability.profile import PROFILER

                        return self._send_json(
                            200,
                            dict(
                                {"kind": "ProfileReport"}, **PROFILER.report()
                            ),
                        )
                    # ?seconds=N — pprof-server equivalent: sample every
                    # thread's stack and return aggregated frame counts
                    # (whole-process view, py-spy style — cProfile would
                    # only see this handler thread)
                    if not server.enable_profiling:
                        return self._error(
                            404,
                            "profiling disabled (server.profilingEnabled)",
                        )
                    try:
                        seconds = min(
                            float((query.get("seconds") or ["2"])[0]), 30.0
                        )
                    except ValueError:
                        return self._error(400, "seconds must be a number")
                    if not server._profile_lock.acquire(blocking=False):
                        return self._error(
                            429, "a profile is already in progress"
                        )
                    try:
                        body = _sample_profile(seconds).encode()
                    finally:
                        server._profile_lock.release()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if path == "/debug/capacity":
                    # capacity & fragmentation introspection
                    # (docs/observability.md "Admission explain"):
                    # per-topology-level domain free vectors + the
                    # max-contiguous-slab fragmentation statistic
                    if server.explain_engine is None:
                        return self._error(
                            404,
                            "no explain engine attached to this server"
                            " (scheduler not running in this process)",
                        )
                    return self._send_json(
                        200, server.explain_engine.capacity()
                    )
                if path.startswith("/gangs/") and path.endswith("/explain"):
                    # GET /gangs/{ns}/{name}/explain — the admission
                    # explain verdict: constraint-elimination funnel,
                    # fits_now, blocking stages, binding constraint
                    parts = path.split("/")
                    if len(parts) != 5 or not parts[2] or not parts[3]:
                        return self._error(
                            404, "expected /gangs/{namespace}/{name}/explain"
                        )
                    if server.explain_engine is None:
                        return self._error(
                            404,
                            "no explain engine attached to this server"
                            " (scheduler not running in this process)",
                        )
                    doc = server.explain_engine.explain(parts[2], parts[3])
                    if doc is None:
                        return self._error(
                            404,
                            f"PodGang {parts[2]}/{parts[3]} not found",
                            "NotFound",
                        )
                    return self._send_json(200, doc)
                if path.startswith("/gangs/") and path.endswith("/journey"):
                    # GET /gangs/{ns}/{name}/journey — one PodGang's causal
                    # admission record (observability/journey.py): ordered
                    # phase marks, frontier partition, and the queue-wait/
                    # encode/solve/commit/status decomposition
                    parts = path.split("/")
                    if len(parts) != 5 or not parts[2] or not parts[3]:
                        return self._error(
                            404, "expected /gangs/{namespace}/{name}/journey"
                        )
                    from grove_tpu_torch.observability.journey import JOURNEYS

                    doc = JOURNEYS.journey(parts[2], parts[3])
                    if doc is None:
                        return self._error(
                            404,
                            f"no journey recorded for PodGang"
                            f" {parts[2]}/{parts[3]} (journey tracing"
                            " enabled? GROVE_TPU_JOURNEY=1)",
                            "NotFound",
                        )
                    return self._send_json(
                        200, dict({"kind": "GangJourney"}, **doc)
                    )
                if path == "/debug/journeys":
                    # fleet view: admission-latency decomposition + the
                    # critical-path fold over completed journeys, PLUS
                    # the pending gangs (age, current stage, last explain
                    # verdict when one ran) — stuck gangs are visible
                    # here instead of silently absent (journey gap fix) —
                    # plus the per-window admission summary read through
                    # the SLO observatory's time-series engine (?window=N
                    # seconds; the SLO layer cites the SAME numbers)
                    from grove_tpu_torch.observability.journey import JOURNEYS

                    window_s = self._query_float("window", 300.0)
                    if window_s is None:
                        return self._error(
                            400, "window must be a positive finite number"
                        )
                    pending = (
                        server.explain_engine.pending_journeys()
                        if server.explain_engine is not None
                        else JOURNEYS.pending()
                    )
                    return self._send_json(
                        200,
                        {
                            "kind": "JourneySummary",
                            "enabled": JOURNEYS.enabled,
                            "decomposition": JOURNEYS.decomposition(),
                            "critical_path": JOURNEYS.critical_path(),
                            "window": JOURNEYS.window_summary(window_s),
                            "pending": pending,
                        },
                    )
                if path == "/federation":
                    # federation tier (docs/federation.md): the router's
                    # registry + ledger roll-up — per-region state/
                    # placements/pending, spillovers, re-routes, global
                    # quota fold
                    if server.federation_provider is None:
                        return self._error(
                            404,
                            "no federation router attached to this"
                            " server (single-cluster deployment)",
                        )
                    return self._send_json(
                        200, server.federation_provider()
                    )
                if path == "/debug/slo":
                    # SLO observatory (docs/observability.md "SLO
                    # observatory"): per-objective attainment, error
                    # budget, burn rates, breach state — plus every live
                    # time series reduced over one window (?window=N)
                    from grove_tpu_torch.observability.slo import SLO

                    window_s = self._query_float("window", 300.0)
                    if window_s is None:
                        return self._error(
                            400, "window must be a positive finite number"
                        )
                    return self._send_json(
                        200,
                        dict(
                            {"kind": "SloReport"},
                            **SLO.status(series_window=window_s),
                        ),
                    )
                if path == "/debug/forecast":
                    # diurnal+trend forecaster (docs/observability.md
                    # "Remediation & ledger"): per-series horizon
                    # predictions with confidence bands + skill vs the
                    # persistence baseline (?series=a&series=b&horizon=N;
                    # defaults to the watched set) — read-only: the skill
                    # ring is fed by the remediator's scoring calls,
                    # never by this surface
                    from grove_tpu_torch.observability.forecast import FORECASTER

                    horizon_s = self._query_float("horizon", 0.0)
                    if horizon_s is None:
                        return self._error(
                            400, "horizon must be a positive finite number"
                        )
                    fc_query = urllib.parse.parse_qs(
                        urllib.parse.urlsplit(self.path).query
                    )
                    names = [
                        s for s in fc_query.get("series", []) if s
                    ] or None
                    return self._send_json(
                        200,
                        dict(
                            {"kind": "ForecastReport"},
                            **FORECASTER.report(
                                names=names,
                                horizon=horizon_s or None,
                            ),
                        ),
                    )
                if path == "/debug/ledger":
                    # causal decision→effect ledger (docs/observability.md
                    # "Remediation & ledger"): the bounded ring of
                    # trigger→diagnosis→simulation→action→effect chains
                    # plus per-kind/per-outcome tallies
                    from grove_tpu_torch.observability.ledger import LEDGER

                    return self._send_json(
                        200,
                        dict({"kind": "LedgerReport"}, **LEDGER.status()),
                    )
                route = self._route()
                if route is None:
                    return self._error(404, f"unknown path {self.path}")
                info, namespace, name, _sub, query = route
                try:
                    selector = parse_label_selector(
                        (query.get("labelSelector") or [None])[0]
                    )
                except ValueError as e:
                    return self._error(400, str(e))
                if name is not None:
                    with server.lock:
                        obj = server.store.get(info.kind, namespace or "", name)
                    if obj is None:
                        return self._error(
                            404, f"{info.kind} {namespace}/{name} not found",
                            "NotFound",
                        )
                    return self._send_json(200, export_object(obj))
                if (query.get("watch") or ["false"])[0] == "true":
                    return self._watch(info, namespace, selector)
                with server.lock:
                    objs = server.store.list(info.kind, namespace or None, selector)
                return self._send_json(
                    200,
                    {
                        "apiVersion": info.api_version,
                        "kind": f"{info.kind}List",
                        "items": [export_object(o) for o in objs],
                    },
                )

            def _watch(self, info: KindInfo, namespace, selector):
                sub = _WatchSub(
                    q=queue.Queue(), kind=info.kind,
                    namespace=namespace or None, selector=selector,
                )
                # list+watch without a gap: snapshot synthetic ADDED events
                # and register the live subscription under the store lock
                with server.lock:
                    existing = server.store.list(
                        info.kind, namespace or None, selector
                    )
                    with server._subs_lock:
                        server._subs.append(sub)
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def write_chunk(payload: dict) -> None:
                    line = (json.dumps(payload) + "\n").encode()
                    self.wfile.write(f"{len(line):x}\r\n".encode())
                    self.wfile.write(line + b"\r\n")
                    self.wfile.flush()

                try:
                    for obj in existing:
                        write_chunk(
                            {"type": "ADDED", "object": export_object(obj)}
                        )
                    while True:
                        ev = sub.q.get()
                        if ev is None:
                            break
                        write_chunk(
                            {
                                "type": ev.type.upper(),
                                "object": export_object(ev.obj),
                            }
                        )
                except (BrokenPipeError, ConnectionResetError):
                    pass
                finally:
                    with server._subs_lock:
                        if sub in server._subs:
                            server._subs.remove(sub)

            def do_POST(self):
                if urllib.parse.urlsplit(self.path).path == "/debug/whatif":
                    # hypothetical trial solves (docs/observability.md
                    # "Admission explain"): before/after verdicts for a
                    # gang under drain/remove/add-node or queue rewrites
                    # — commits NOTHING (read-only by GL016 contract)
                    if server.explain_engine is None:
                        return self._error(
                            404,
                            "no explain engine attached to this server"
                            " (scheduler not running in this process)",
                        )
                    try:
                        body = self._body()
                    except ValueError:
                        return self._error(400, "invalid JSON body")
                    try:
                        doc = server.explain_engine.whatif(body)
                    except ValueError as e:
                        return self._error(400, str(e))
                    return self._send_json(200, doc)
                # node lifecycle actions (docs/robustness.md drain flow):
                # POST /nodes/{name}/drain | /nodes/{name}/uncordon
                parts = [
                    urllib.parse.unquote(p)
                    for p in urllib.parse.urlsplit(self.path).path.split("/")
                    if p
                ]
                if len(parts) == 3 and parts[0] == "nodes" and parts[2] in (
                    "drain",
                    "uncordon",
                ):
                    handler = (
                        server.drain_handler
                        if parts[2] == "drain"
                        else server.uncordon_handler
                    )
                    if handler is None:
                        return self._error(
                            404, "no drain controller attached to this server"
                        )
                    # node lifecycle actions are operator-tier: with the
                    # authorizer enabled, only the operator identity or an
                    # exempt service account may evict workloads this way
                    # (the same principals the store guard trusts) — an
                    # anonymous client must not drain a node it could not
                    # delete a managed pod from
                    guard = server.store.guard
                    if guard is not None and guard.enabled:
                        username = self._username()
                        if (
                            username != guard.operator_username
                            and username not in guard.exempt
                        ):
                            return self._error(
                                403,
                                f"{parts[2]} of node {parts[1]!r} is denied"
                                f" for user {username!r}: node lifecycle"
                                " actions require the operator identity or"
                                " an exempt service account",
                                "Forbidden",
                            )
                    # not under server.lock — same nested-self-call rule as
                    # GET /nodes: the controller persists the NodeDrain
                    # intent through its own store, which in real-cluster
                    # mode is an HttpStore calling back into this server
                    row = handler(parts[1])
                    if row is None:
                        return self._error(
                            404, f"node {parts[1]!r} not found", "NotFound"
                        )
                    return self._send_json(200, row)
                route = self._route()
                if route is None:
                    return self._error(404, f"unknown path {self.path}")
                info, namespace, _name, _sub, _query = route
                doc = self._body()
                if doc.get("kind") != info.kind:
                    return self._error(
                        400,
                        f"body kind {doc.get('kind')!r} does not match path "
                        f"kind {info.kind!r}",
                    )
                username = self._username()
                try:
                    doc = server._admit(doc, "CREATE", username)
                    obj = decode_object(doc)
                    if info.namespaced:
                        obj.metadata.namespace = namespace or "default"
                    with server.lock, server.store.as_user(username):
                        stored = server.store.create(obj)
                except AdmissionDenied as e:
                    return self._error(422, e.message, "Invalid")
                except GroveError as e:
                    return self._error(_http_status_for(e), str(e))
                return self._send_json(201, export_object(stored))

            def do_PUT(self):
                route = self._route()
                if route is None:
                    return self._error(404, f"unknown path {self.path}")
                info, namespace, name, sub, _query = route
                if name is None:
                    return self._error(405, "PUT requires a resource name")
                doc = self._body()
                username = self._username()
                try:
                    if sub == "status":
                        with server.lock, server.store.as_user(username):
                            current = server.store.get(
                                info.kind, namespace or "", name
                            )
                            if current is None:
                                return self._error(
                                    404, f"{info.kind} {name} not found",
                                    "NotFound",
                                )
                            incoming = decode_object(doc)
                            current.status = incoming.status
                            # status writes respect optimistic concurrency
                            current.metadata.resource_version = (
                                incoming.metadata.resource_version
                            )
                            stored = server.store.update_status(current)
                        return self._send_json(200, export_object(stored))
                    with server.lock:
                        current = server.store.get(info.kind, namespace or "", name)
                    old_doc = export_object(current) if current is not None else None
                    doc = server._admit(doc, "UPDATE", username, old_doc)
                    obj = decode_object(doc)
                    with server.lock, server.store.as_user(username):
                        # spec-endpoint writes never touch status
                        # (subresource semantics). Re-read UNDER the write
                        # lock: the admission round trip above runs unlocked,
                        # and restoring a pre-webhook snapshot would revert
                        # any status a controller wrote in that window.
                        fresh = server.store.get(
                            info.kind, namespace or "", name
                        )
                        if fresh is not None and hasattr(fresh, "status"):
                            obj.status = fresh.status
                        stored = server.store.update(obj)
                        # apiserver rule: removing the last finalizer of a
                        # deleting object completes the deletion
                        server.store.complete_deletion_if_drained(
                            info.kind, stored.metadata.namespace,
                            stored.metadata.name,
                        )
                except AdmissionDenied as e:
                    return self._error(422, e.message, "Invalid")
                except GroveError as e:
                    return self._error(_http_status_for(e), str(e))
                return self._send_json(200, export_object(stored))

            def do_DELETE(self):
                route = self._route()
                if route is None:
                    return self._error(404, f"unknown path {self.path}")
                info, namespace, name, _sub, query = route
                username = self._username()
                try:
                    if name is None:
                        selector = parse_label_selector(
                            (query.get("labelSelector") or [None])[0]
                        )
                        with server.lock, server.store.as_user(username):
                            n = server.store.delete_collection(
                                info.kind, namespace or "", selector
                            )
                        return self._send_json(200, {"deleted": n})
                    with server.lock:
                        current = server.store.get(info.kind, namespace or "", name)
                    if current is not None:
                        server._admit(
                            export_object(current), "DELETE", username
                        )
                    with server.lock, server.store.as_user(username):
                        server.store.delete(info.kind, namespace or "", name)
                except AdmissionDenied as e:
                    return self._error(403, e.message, "Forbidden")
                except GroveError as e:
                    return self._error(_http_status_for(e), str(e))
                return self._send_json(200, {"status": "Success"})

        return Handler
