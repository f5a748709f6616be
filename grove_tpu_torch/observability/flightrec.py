"""Flight recorder: the postmortem bundle a failing run ships.

Counterpart of ``grove_tpu/observability/flightrec.py``. ``FLIGHTREC``
keeps a bounded per-shard ring of recent telemetry: store-commit digests
(kind, namespace, name, resourceVersion, operation; fed from the store's
``_emit``), finished spans (the tracer's ``FLIGHT_SINK``), event updates
(the event recorder's ``sink``) and reconcile errors. ``trigger(reason,
detail)`` freezes the rings into a bundle directory: ``flight.json`` (the
manifest, the rings, the recent events, and the profiler's and journeys'
snapshots when those layers are on) and ``trace.json`` (the ring's spans as
a Chrome ``trace_event`` array). Dumps are capped per trigger reason
(``max_dumps``). Triggered here by an SLO breach and by explicit calls.
Off by default (``GROVE_TPU_FLIGHTREC=1`` or ``FLIGHTREC.enable()``);
every feed site costs one boolean check while off.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import List, Optional

from grove_tpu_torch.observability.metrics import METRICS

_DEFAULT_CAPACITY = 1024


class FlightRecorder:
    """Process-global (``FLIGHTREC``), thread-safe, bounded."""

    def __init__(self) -> None:
        self.enabled = False
        self.clock = None  # optional virtual clock for vt stamps
        self.out_dir: Optional[str] = None
        self.max_dumps = 8
        self.dumps: List[str] = []
        self._lock = threading.Lock()
        self._rings: List[deque] = [deque(maxlen=_DEFAULT_CAPACITY)]
        self._events: deque = deque(maxlen=_DEFAULT_CAPACITY)
        self._errors: deque = deque(maxlen=256)
        self._dump_seq = 0
        # per-trigger-kind dump budget: reason string -> bundles shipped.
        # max_dumps caps each kind separately, not the process total.
        self._kind_dumps: dict = {}
        self._origin = time.perf_counter()
        env_dir = os.environ.get("GROVE_TPU_FLIGHTREC", "")
        if env_dir not in ("", "0", "false"):
            self.enable(
                out_dir=env_dir if env_dir not in ("1", "true") else None
            )

    # -- lifecycle -------------------------------------------------------

    def enable(
        self,
        num_shards: int = 1,
        capacity: int = _DEFAULT_CAPACITY,
        out_dir: Optional[str] = None,
        max_dumps: int = 8,
        clock=None,
    ) -> "FlightRecorder":
        """Arm the recorder: one ring per keyspace shard (shard stamps
        come with the records — commits carry ``WatchEvent.shard``, spans
        their ``shard`` attribute). Also installs itself as the tracer's
        flight sink and the event recorder's sink."""
        with self._lock:
            self._rings = [
                deque(maxlen=capacity) for _ in range(max(1, num_shards))
            ]
            self._events = deque(maxlen=capacity)
            self._errors = deque(maxlen=256)
            self.out_dir = out_dir
            self.max_dumps = max_dumps
            self.clock = clock
            self._origin = time.perf_counter()
            self.enabled = True
        from grove_tpu_torch.observability import events as _events
        from grove_tpu_torch.observability import tracing as _tracing

        _tracing.FLIGHT_SINK = self
        _events.EVENTS.sink = self
        return self

    def disable(self) -> None:
        from grove_tpu_torch.observability import events as _events
        from grove_tpu_torch.observability import tracing as _tracing

        self.enabled = False
        if _tracing.FLIGHT_SINK is self:
            _tracing.FLIGHT_SINK = None
        if _events.EVENTS.sink is self:
            _events.EVENTS.sink = None

    def reset(self) -> None:
        with self._lock:
            for ring in self._rings:
                ring.clear()
            self._events.clear()
            self._errors.clear()
            self.dumps = []
            self._dump_seq = 0
            self._kind_dumps = {}

    # -- feeds (one boolean check each when disabled) --------------------

    def _t(self) -> float:
        return round(time.perf_counter() - self._origin, 6)

    def _vt(self) -> Optional[float]:
        return round(self.clock.now(), 3) if self.clock is not None else None

    def _ring(self, shard: int) -> deque:
        rings = self._rings
        return rings[shard] if 0 <= shard < len(rings) else rings[0]

    def note_commit(self, ev) -> None:
        """Store-commit digest (fed from Store._emit)."""
        meta = ev.obj.metadata
        self._ring(ev.shard).append(
            {
                "t": self._t(),
                "vt": self._vt(),
                "rec": "commit",
                "op": ev.type,
                "kind": ev.kind,
                "ns": meta.namespace,
                "name": meta.name,
                "rv": meta.resource_version,
            }
        )

    def note_span(self, span) -> None:
        """Finished span (fed from tracing's FLIGHT_SINK hook)."""
        shard = span.attrs.get("shard", 0)
        self._ring(shard if isinstance(shard, int) else 0).append(
            {
                "t": self._t(),
                "rec": "span",
                "name": span.name,
                "ts_us": span.ts_us,
                "dur_us": span.dur_us,
                "tid": span.tid,
                "shard": shard if isinstance(shard, int) else 0,
                "attrs": {
                    k: v
                    for k, v in span.attrs.items()
                    if isinstance(v, (str, int, float, bool))
                },
            }
        )

    def note_event(self, rec) -> None:
        """Deduped Event update (fed from the EventRecorder sink)."""
        self._events.append(
            {
                "t": self._t(),
                "vt": self._vt(),
                "rec": "event",
                "reason": rec.reason,
                "type": rec.type,
                "kind": rec.kind,
                "ns": rec.namespace,
                "name": rec.name,
                "count": rec.count,
                "shard": rec.shard,
            }
        )

    def note_error(self, controller: str, key, exc: BaseException) -> None:
        """A reconcile raised (fed from the engine's completion path)."""
        self._errors.append(
            {
                "t": self._t(),
                "vt": self._vt(),
                "rec": "error",
                "controller": controller,
                "key": "/".join(str(k) for k in key),
                "error": f"{type(exc).__name__}: {exc}",
            }
        )

    # -- dump ------------------------------------------------------------

    def trigger(self, reason: str, detail: str = "") -> Optional[str]:
        """Freeze the rings into a postmortem bundle. Returns the bundle
        directory, or None (disabled / this trigger kind's dump budget
        exhausted — other kinds keep their own budgets)."""
        if not self.enabled:
            return None
        with self._lock:
            if self._kind_dumps.get(reason, 0) >= self.max_dumps:
                return None
            self._kind_dumps[reason] = self._kind_dumps.get(reason, 0) + 1
            self._dump_seq += 1
            seq = self._dump_seq
            shards = [
                {"shard": i, "records": list(ring)}
                for i, ring in enumerate(self._rings)
            ]
            events = list(self._events)
            errors = list(self._errors)
        out_dir = self.out_dir
        if out_dir is None:
            import tempfile

            out_dir = tempfile.mkdtemp(prefix="grove-flightrec-")
            self.out_dir = out_dir
        slug = "".join(
            c if c.isalnum() or c in "-_" else "-" for c in reason
        )[:48]
        bundle = os.path.join(out_dir, f"bundle-{seq:03d}-{slug}")
        os.makedirs(bundle, exist_ok=True)
        manifest = {
            "reason": reason,
            "detail": detail,
            "t": self._t(),
            "vt": self._vt(),
            "shards": shards,
            "events": events,
            "errors": errors,
        }
        # snapshots of the sibling glass-box layers, when they are on —
        # a postmortem with the attribution ledger beats one without
        from grove_tpu_torch.observability.journey import JOURNEYS
        from grove_tpu_torch.observability.profile import PROFILER

        if PROFILER.enabled:
            manifest["profile"] = PROFILER.report(top=32)
        if JOURNEYS.enabled:
            manifest["journeys"] = JOURNEYS.critical_path()
        with open(os.path.join(bundle, "flight.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        with open(os.path.join(bundle, "trace.json"), "w") as f:
            json.dump(self._chrome(shards), f)
        self.dumps.append(bundle)
        METRICS.inc("flightrec_dumps_total")
        from grove_tpu_torch.observability.events import (
            EVENTS,
            REASON_FLIGHT_RECORDED,
            TYPE_WARNING,
        )

        EVENTS.record(
            ("FlightRecorder", "", "cluster"),
            TYPE_WARNING,
            REASON_FLIGHT_RECORDED,
            f"postmortem bundle dumped to {bundle}: {reason}"
            + (f" ({detail})" if detail else ""),
        )
        return bundle

    @staticmethod
    def _chrome(shards: List[dict]) -> List[dict]:
        """The ring's spans as a Chrome trace_event array; the shard rides
        both as a top-level column and as the pid so per-shard work renders
        as separate lanes."""
        out = []
        for entry in shards:
            for rec in entry["records"]:
                if rec.get("rec") != "span":
                    continue
                # the record's OWN shard stamp wins: cluster-wide spans
                # (shard -1) live in ring 0 but must not render as shard 0
                shard = rec.get("shard", entry["shard"])
                out.append(
                    {
                        "name": rec["name"],
                        "ph": "X",
                        "ts": rec["ts_us"],
                        "dur": rec["dur_us"],
                        "pid": shard,
                        "tid": rec["tid"],
                        "shard": shard,
                        "args": rec.get("attrs", {}),
                    }
                )
        out.sort(key=lambda e: e["ts"])
        return out


def load_bundle(path: str) -> dict:
    """Re-read a dumped bundle (the smoke's round-trip check): returns the
    manifest with the chrome trace attached under ``"chrome"``."""
    with open(os.path.join(path, "flight.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(path, "trace.json")) as f:
        manifest["chrome"] = json.load(f)
    return manifest


FLIGHTREC = FlightRecorder()
