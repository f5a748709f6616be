"""Gang journeys: the causal record of one PodGang's admission.

Counterpart of ``grove_tpu/observability/journey.py``. ``JOURNEYS``
records, per PodGang, the chain

    created -> first-scan -> encode -> solve -> commit -> scheduled

with wall (``time.perf_counter``) and virtual-clock stamps, and derives on
completion the admission-latency decomposition: ``queue_wait`` (creation
to the encode of the round that admitted it), that round's ``encode`` and
``solve`` walls (a batched round's walls are every gang's), ``commit``
(solve end to the gang's pods bound) and ``status`` (bind to
Scheduled=True committed). The partitioned frontier stamps the partition
that solved the gang (-1: the residual pass). ``critical_path`` folds the
completed journeys into per-segment shares and the tail journey.

The store stamps ``created`` and drops deleted gangs; the scheduler stamps
the rest (``solver/scheduler.py``, ``solver/frontier.py``). Off by default
(``GROVE_TPU_JOURNEY=1`` or ``JOURNEYS.enable()``); every call site costs
one boolean check while off.

A completed journey feeds the SLO observatory's time series
(``observability/timeseries.py``): ``note_scheduled`` observes its wall
admission latency (the segments' sum) and its virtual one (created to
scheduled on the virtual clock), and ``window_summary`` reads both back
through the same windowed reducers the SLO layer judges with.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from grove_tpu_torch.observability.metrics import METRICS, _quantile
from grove_tpu_torch.observability.timeseries import (
    SERIES_ADMISSION,
    SERIES_ADMISSION_VT,
    TIMESERIES,
)

# journey phases, in causal order
JOURNEY_PHASES = (
    "created",
    "first-scan",
    "encode",
    "solve",
    "commit",
    "scheduled",
)
# the admission-latency decomposition's segments
JOURNEY_SEGMENTS = ("queue_wait", "encode", "solve", "commit", "status")

PARTITION_RESIDUAL = -1  # solved by the global residual pass (or global solve)


class _Journey:
    __slots__ = ("namespace", "name", "marks", "rounds", "partition", "segments", "complete")

    def __init__(self, namespace: str, name: str) -> None:
        self.namespace = namespace
        self.name = name
        self.marks: Dict[str, Tuple[float, Optional[float]]] = {}  # phase -> (wall, vt)
        self.rounds = 0  # solve rounds this gang was encoded into
        self.partition: Optional[int] = None
        self.segments: Optional[Dict[str, float]] = None  # filled on completion
        self.complete = False

    def as_dict(self) -> dict:
        origin = self.marks.get("created") or self.marks.get("first-scan")
        t0 = origin[0] if origin else 0.0
        phases = [
            {
                "phase": ph,
                "t_s": round(self.marks[ph][0] - t0, 9),
                **({"vt": self.marks[ph][1]} if self.marks[ph][1] is not None else {}),
            }
            for ph in JOURNEY_PHASES
            if ph in self.marks
        ]
        doc = {
            "namespace": self.namespace,
            "name": self.name,
            "complete": self.complete,
            "rounds": self.rounds,
            "phases": phases,
        }
        if self.partition is not None:
            doc["partition"] = self.partition
        if self.segments is not None:
            doc["segments"] = {k: round(v, 9) for k, v in self.segments.items()}
            doc["total_s"] = round(sum(self.segments.values()), 9)
        return doc


class JourneyTracker:
    """Process-global (``JOURNEYS``), thread-safe, bounded: active journeys
    are LRU-evicted past ``max_active`` (deleted gangs drop at once), and the
    most recent ``max_completed`` completed ones are kept."""

    def __init__(self, max_active: int = 65_536, max_completed: int = 65_536) -> None:
        self.enabled = os.environ.get("GROVE_TPU_JOURNEY", "") not in ("", "0", "false")
        self.clock = None  # optional virtual clock
        self.max_active = max_active
        self.max_completed = max_completed
        self.completed_total = 0
        self._lock = threading.Lock()
        self._active: "OrderedDict[tuple, _Journey]" = OrderedDict()
        self._done: "OrderedDict[tuple, _Journey]" = OrderedDict()
        # the current solve round's stamps (encode start, encode end, solve
        # end): written once a round, read by every gang the round encoded
        self._round: Optional[Tuple[float, float, float]] = None

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        with self._lock:
            self._active.clear()
            self._done.clear()
            self._round = None
            self.completed_total = 0

    # -- marks -----------------------------------------------------------

    def t(self) -> float:
        return time.perf_counter()

    def _vt(self) -> Optional[float]:
        return round(self.clock.now(), 3) if self.clock is not None else None

    def _get(self, namespace: str, name: str, create: bool) -> Optional[_Journey]:
        key = (namespace, name)
        j = self._active.get(key)
        if j is None and create:
            j = self._active[key] = _Journey(namespace, name)
            while len(self._active) > self.max_active:
                self._active.popitem(last=False)
        return j

    def _mark(self, j: _Journey, phase: str, t: Optional[float] = None) -> None:
        j.marks[phase] = (t if t is not None else self.t(), self._vt())

    def note_created(self, namespace: str, name: str) -> None:
        """A PodGang's creation was committed (the store's hook)."""
        with self._lock:
            j = self._get(namespace, name, create=True)
            if "created" not in j.marks:
                self._mark(j, "created")

    def note_deleted(self, namespace: str, name: str) -> None:
        with self._lock:
            self._active.pop((namespace, name), None)

    def note_seen(self, namespace: str, name: str) -> None:
        """The gang's pods entered a pending scan (the first one wins)."""
        with self._lock:
            j = self._get(namespace, name, create=True)
            if "first-scan" not in j.marks:
                self._mark(j, "first-scan")

    def note_round(self, t_encode0: float, t_encode1: float, t_solve1: float) -> None:
        """One solve round's stamps: encode start, encode end, solve end."""
        with self._lock:
            self._round = (t_encode0, t_encode1, t_solve1)

    def note_encoded(self, namespace: str, name: str) -> None:
        """The gang was in the round's solver input. Every such round counts;
        the admitting round's stamps are the ones kept."""
        with self._lock:
            j = self._get(namespace, name, create=True)
            j.rounds += 1
            if self._round is not None:
                t_enc0, t_enc1, _t_solve1 = self._round
                self._mark(j, "encode", t_enc0)
                self._mark(j, "solve", t_enc1)

    def note_partition(self, namespace: str, name: str, partition: int) -> None:
        """The frontier lane: a partition id, or PARTITION_RESIDUAL."""
        with self._lock:
            j = self._active.get((namespace, name))
            if j is not None:
                j.partition = partition

    def note_commit(self, namespace: str, name: str) -> None:
        """The gang's pods were bound."""
        with self._lock:
            j = self._active.get((namespace, name))
            if j is not None:
                self._mark(j, "commit")

    def note_scheduled(self, namespace: str, name: str) -> None:
        """Scheduled=True was committed: the journey completes and its
        decomposition is derived."""
        now = self.t()
        with self._lock:
            key = (namespace, name)
            j = self._active.pop(key, None)
            if j is None:
                return
            self._mark(j, "scheduled", now)
            rnd = self._round
            marks = j.marks
            created = marks.get("created") or marks.get("first-scan")
            enc0 = marks.get("encode")
            solve0 = marks.get("solve")
            commit = marks.get("commit")
            if created and enc0 and solve0 and commit and rnd is not None:
                t_solve1 = min(rnd[2], commit[0])
                j.segments = {
                    "queue_wait": max(enc0[0] - created[0], 0.0),
                    "encode": max(solve0[0] - enc0[0], 0.0),
                    "solve": max(t_solve1 - solve0[0], 0.0),
                    "commit": max(commit[0] - t_solve1, 0.0),
                    "status": max(now - commit[0], 0.0),
                }
            j.complete = all(ph in marks for ph in JOURNEY_PHASES)
            self._done[key] = j
            self.completed_total += 1
            while len(self._done) > self.max_completed:
                self._done.popitem(last=False)
        METRICS.inc("journeys_completed_total")
        # the SLO observatory's feed (one boolean check while it is off):
        # wall seconds (the segments' sum, the number decomposition()
        # reports) and virtual seconds (created to scheduled)
        if TIMESERIES.enabled:
            if j.segments is not None:
                TIMESERIES.observe(SERIES_ADMISSION, sum(j.segments.values()))
            created = j.marks.get("created") or j.marks.get("first-scan")
            sched = j.marks.get("scheduled")
            if (
                created is not None
                and sched is not None
                and created[1] is not None
                and sched[1] is not None
            ):
                TIMESERIES.observe(SERIES_ADMISSION_VT, max(sched[1] - created[1], 0.0))

    # -- read side -------------------------------------------------------

    def journey(self, namespace: str, name: str) -> Optional[dict]:
        with self._lock:
            # the live journey first: a recreated gang's in-flight journey
            # must not hide behind its previous incarnation's record
            j = self._active.get((namespace, name)) or self._done.get((namespace, name))
            return j.as_dict() if j is not None else None

    def completed(self) -> List[_Journey]:
        with self._lock:
            return list(self._done.values())

    def _age(self, origin, wall_now: float, vt_now: Optional[float]) -> Tuple[float, bool]:
        """(age, virtual): the virtual clock's age where both stamps have
        one, else the wall clock's."""
        if vt_now is not None and origin[1] is not None:
            return max(vt_now - origin[1], 0.0), True
        return max(wall_now - origin[0], 0.0), False

    def pending(self) -> List[dict]:
        """Every active (not yet scheduled) journey, oldest first, with its
        age (virtual seconds where the clock is attached, else wall) and
        its latest phase."""
        wall_now = self.t()
        vt_now = self._vt()
        with self._lock:
            journeys = list(self._active.values())
        rows = []
        for j in journeys:
            origin = j.marks.get("created") or j.marks.get("first-scan")
            doc = j.as_dict()
            if origin is not None:
                age, virtual = self._age(origin, wall_now, vt_now)
                doc["age_s"] = round(age, 3 if virtual else 9)
            else:
                doc["age_s"] = 0.0
            doc["stage"] = next(
                (ph for ph in reversed(JOURNEY_PHASES) if ph in j.marks), "created"
            )
            rows.append(doc)
        rows.sort(key=lambda d: -d["age_s"])
        return rows

    def pending_ages(self) -> List[Tuple[str, float]]:
        """(namespace, oldest pending age) per namespace."""
        wall_now = self.t()
        vt_now = self._vt()
        with self._lock:
            journeys = list(self._active.values())
        oldest: Dict[str, float] = {}
        for j in journeys:
            origin = j.marks.get("created") or j.marks.get("first-scan")
            if origin is None:
                continue
            age, _virtual = self._age(origin, wall_now, vt_now)
            if age > oldest.get(j.namespace, -1.0):
                oldest[j.namespace] = age
        return sorted(oldest.items())

    def window_summary(self, seconds: float = 300.0) -> dict:
        """The windowed admission-latency summary, read through the time
        series the SLO layer judges (so both cite the same numbers); empty
        shells while the engine is off (``decomposition`` serves the
        all-time numbers)."""
        return {
            "window_s": seconds,
            "enabled": TIMESERIES.enabled,
            "wall": TIMESERIES.window(SERIES_ADMISSION, seconds),
            "virtual": TIMESERIES.window(SERIES_ADMISSION_VT, seconds),
        }

    def decomposition(self) -> dict:
        """Admission-latency p50/p99 per segment over completed journeys."""
        samples: Dict[str, List[float]] = {seg: [] for seg in JOURNEY_SEGMENTS}
        totals: List[float] = []
        for j in self.completed():
            if j.segments is None:
                continue
            for seg in JOURNEY_SEGMENTS:
                samples[seg].append(j.segments[seg])
            totals.append(sum(j.segments.values()))
        totals.sort()
        doc = {
            "journeys": len(totals),
            "completed_total": self.completed_total,
            "admission_p50_s": round(_quantile(totals, 0.5), 6) if totals else 0.0,
            "admission_p99_s": round(_quantile(totals, 0.99), 6) if totals else 0.0,
            "segments": {},
        }
        for seg in JOURNEY_SEGMENTS:
            vals = sorted(samples[seg])
            doc["segments"][seg] = {
                "p50_s": round(_quantile(vals, 0.5), 6) if vals else 0.0,
                "p99_s": round(_quantile(vals, 0.99), 6) if vals else 0.0,
                "total_s": round(sum(vals), 6),
            }
        return doc

    def critical_path(self) -> dict:
        """Each segment's share of the total admission latency over every
        completed journey, and the tail journey (the latest completion)."""
        per_seg: Dict[str, float] = {seg: 0.0 for seg in JOURNEY_SEGMENTS}
        tail: Optional[_Journey] = None
        tail_t = -1.0
        n = 0
        for j in self.completed():
            if j.segments is None:
                continue
            n += 1
            for seg in JOURNEY_SEGMENTS:
                per_seg[seg] += j.segments[seg]
            done_t = j.marks.get("scheduled", (0.0, None))[0]
            if done_t > tail_t:
                tail_t, tail = done_t, j
        total = sum(per_seg.values())
        doc = {
            "journeys": n,
            "total_s": round(total, 6),
            "segments": {
                seg: {
                    "total_s": round(v, 6),
                    "share": round(v / total, 4) if total > 0 else 0.0,
                }
                for seg, v in per_seg.items()
            },
        }
        if tail is not None:
            doc["tail"] = tail.as_dict()
        return doc


JOURNEYS = JourneyTracker()
