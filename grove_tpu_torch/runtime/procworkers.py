"""Worker-process control plane: shared-nothing executor over the wire codec.

Counterpart of ``grove_tpu/runtime/procworkers.py``.

The thread executor (runtime/workers.py) proved the determinism contract
— coordinator-only routing/pops/bookkeeping, per-shard worker groups in
batch order, deferred cross-shard fan-out replayed serially — but on GIL
builds its workers time-share one interpreter. This module is the
worker-PROCESS backend docs/control-plane.md §5 designed and deferred:
the same `Engine.enable_workers` surface (GROVE_TPU_CP_BACKEND=process),
one forked OS process per worker group, the process boundary crossed
ONLY by the api/serialize.py wire codec (the WAL's envelope form: no
pickle of store objects on a boundary).

Fork-per-drain generations
--------------------------

Workers are forked at the first remote batch of each `drain()` and exit
when the drain returns. The fork IS the state-shipping mechanism: a
copy-on-write snapshot of the coordinator's entire live state (store
shards, informer caches, cluster sim, disruption broker, expectations)
at the drain boundary — exactly the state the serial drain would read —
so nothing outside the store ever needs replicating across a drain
boundary. Within the drain, the only state that moves is:

- coordinator -> worker: the round's keys + a SYNC STREAM of every
  commit since the worker's last batch (wire envelopes, in the serial
  batch order the coordinator applied them), so worker informer caches
  advance exactly one round behind — the serial cache-lag contract.
- worker -> coordinator: per-key reconcile outcomes + the key's commits
  as wire envelopes (mirror-applied, and re-emitted to every
  coordinator-side consumer, in batch order) + the key's expectations
  entry (runtime/expectations.py `export_key`) so raise/lower survives
  the generation.

Mirrors never exchange resourceVersions: `Store.apply_remote_event`
restamps on apply (per-object rv values are mirror-local because
best-effort Events interleave; the COUNTS every A/B compares are
identical — each apply bumps exactly one shard by one).

WAL ownership
-------------

A worker process owns its shards' WAL streams for the generation's
lifetime: the coordinator's stream handles go inert (`wal.remote`), the
worker's live `note_event` subscription buffers its own commits, and the
generation's stop handshake final-flushes + ships the watermarks back
before `drain()` returns — so the tick-boundary pump cadence and the
acked-prefix audit are unchanged. Crash repatriation: the coordinator
keeps a per-shard ring of the commits it mirror-applied while the
stream was remote; a dead worker's ring replays into the re-localized
stream, so no acked-prefix hole ever opens (the worker never fsyncs
mid-drain — its buffer dies with it, exactly like a crashed serial
store's).

Crash robustness (chaos `worker_crash`)
---------------------------------------

A dead channel (EOF, SIGKILL, stall past the batch deadline) is
detected at the reply phase; the coordinator repatriates the worker's
shards and re-executes its keys inline AT THEIR BATCH POSITIONS from
its own mirror — deterministically equivalent to the worker having run
them (same inputs: the mirror is exact). Protocol corruption fails
closed with a GroveError + flight-recorder bundle. Never a hang (the
reply wait is deadline-bounded), never divergent state.

The coordinator may hold a CUDA context (the scheduler's solves run on the
card); a forked child inherits it but must never touch the card, which
PyTorch forbids after a fork. Workers run reconciles only, and no
reconcile path imports torch; each child freezes the cyclic collector over
the inherited heap (``gc.freeze``) so no inherited device tensor is ever
freed in a child, and leaves only through ``os._exit``.

Worker-pool internals are private to runtime/.
"""

from __future__ import annotations

import json
import os
import signal
import time
from typing import Dict, List, Optional

from grove_tpu_torch.observability.flightrec import FLIGHTREC
from grove_tpu_torch.observability.metrics import METRICS
from grove_tpu_torch.observability.tracing import TRACER
from grove_tpu_torch.runtime.errors import ERR_TRANSPORT, GroveError
from grove_tpu_torch.runtime.flow import ReconcileStepResult

# one generous bound so a wedged worker can never hang the coordinator:
# covers the slowest single-worker round at stress scale with margin
BATCH_DEADLINE_S = 600.0


def backend_from_env() -> str:
    """GROVE_TPU_CP_BACKEND=thread|process (default thread)."""
    backend = os.environ.get("GROVE_TPU_CP_BACKEND", "thread").strip().lower()
    return backend if backend in ("thread", "process") else "thread"


def _encode_error(e: BaseException) -> dict:
    if isinstance(e, GroveError):
        return {
            "grove": True,
            "code": e.code,
            "msg": e.message,
            "op": e.operation,
            "ra": e.requeue_after,
        }
    return {"grove": False, "msg": repr(e)}


def _decode_error(doc: Optional[dict]) -> Optional[Exception]:
    if doc is None:
        return None
    if doc.get("grove"):
        return GroveError(
            doc["code"], doc.get("msg", ""), doc.get("op", ""),
            requeue_after=doc.get("ra"),
        )
    return RuntimeError(doc.get("msg", "worker reconcile error"))


def _decode_result(doc: Optional[dict]):
    if doc is None:
        return None
    return ReconcileStepResult(
        result=doc["result"], requeue_after=doc.get("ra")
    )


class ProcessDrain:
    """Worker-process drain for one Engine (docs/control-plane.md §5).

    Mirrors ParallelDrain's executor surface exactly (`worker_of`,
    `busy_snapshot`, `utilization`, `stats`, `drain`, `close`) so every
    caller — sweep, scale report, glassbox — is backend-agnostic."""

    backend = "process"

    def __init__(self, engine, workers: int) -> None:
        import multiprocessing

        if "fork" not in multiprocessing.get_all_start_methods():
            raise GroveError(
                ERR_TRANSPORT,
                "the worker-process backend needs the fork start method"
                " (POSIX); use GROVE_TPU_CP_BACKEND=thread here",
                "enable-workers",
            )
        self._mp = multiprocessing.get_context("fork")
        self.engine = engine
        # same clamp as the thread backend: worker_of = shard % W can
        # never route beyond S workers
        self.workers = max(2, min(int(workers), engine.num_shards))
        self.reconciles_by_worker = [0] * self.workers
        self._worker_busy_s = [0.0] * self.workers
        # generation state (populated per drain, torn down before the
        # drain returns)
        self._gen_active = False
        self._epoch = 0  # fork-generation counter (event-seq slot spacing)
        self._procs: Dict[int, object] = {}
        self._conns: Dict[int, object] = {}
        self._dead: set = set()
        self._log: List[dict] = []  # sync stream, serial apply order
        self._cursors: Dict[int, int] = {}  # per-worker shipped offset
        self._rings: Dict[int, list] = {}  # per-shard WAL backfill rings
        self._ring_gate: Dict[int, bool] = {}
        self._ring_subscribed: set = set()
        self._recorder_installed = False
        self._muted = False  # recorder off while mirror-applying (the
        # shipped envelope is appended to the log directly, stamped with
        # its true origin — the live emit must not double-log it as o=0)
        self._child_id: Optional[int] = None  # set inside a forked worker
        self._clog: List[object] = []  # child: commits of the running key
        self._recording = False
        self._echo_queue: List[object] = []  # child: commits awaiting echo
        # chaos `worker_crash` arm (sim/chaos.py): SIGKILL this worker
        # right after the next batch is dispatched to it
        self.chaos_kill_worker: Optional[int] = None
        self.crashes = 0
        # boundary accounting (docs/observability.md)
        self.boundary_bytes = 0
        # gray-failure injection (runtime/boundary.py): None = the
        # fault-free channel code, byte-identical to the pre-fault
        # build; armed, every frame carries a sequence number and the
        # dedup/retransmit protocol below tolerates drop/dup/delay
        self._faults = None
        self.boundary_fault_counts = {
            "drop": 0,
            "dup": 0,
            "delay": 0,
            "retransmits": 0,
            "deduped": 0,
        }
        self._tx_seq: Dict[int, int] = {}  # per-worker request seqs
        self._rx_seq: Dict[int, int] = {}  # per-worker reply high-water
        self._last_sent: Dict[int, bytes] = {}  # retransmit buffer
        self._crx_high = 0  # child: request high-water mark
        self._creply_cache: Dict[int, bytes] = {}  # child: seq -> reply
        # cache watermark: sync-log position at the last routing boundary.
        # Records before it are cache-advanceable in worker mirrors (the
        # serial drain advanced its cache for them at that routing);
        # records after it are committed-only until the next round — the
        # serial cache-lag contract, byte for byte. -1 = no routing since
        # the generation forked (nothing advanceable).
        self._cache_mark = -1
        self._pending_cache: List[tuple] = []  # child: (index, ev) stash
        METRICS.set("cp_workers", self.workers)
        METRICS.set("cp_backend_process", 1)
        engine.store._process_drain = self
        engine.round_hook = self._on_round

    # -- ownership map (ParallelDrain-identical) --------------------------

    def worker_of(self, shard: int) -> int:
        if shard < 0:
            return 0
        return shard % self.workers

    def _lane_of(self, shard: int) -> int:
        """worker_of with crash degradation: a dead worker's shards
        repatriate to the coordination plane for the rest of the drain."""
        w = self.worker_of(shard)
        return 0 if w in self._dead else w

    def busy_snapshot(self) -> List[float]:
        return list(self._worker_busy_s)

    def utilization(
        self, wall_seconds: float, since: List[float] = None
    ) -> List[float]:
        if wall_seconds <= 0:
            return [0.0] * self.workers
        base = since or [0.0] * self.workers
        return [
            round((b - b0) / wall_seconds, 4)
            for b, b0 in zip(self._worker_busy_s, base)
        ]

    @property
    def active(self) -> bool:
        """A worker generation is live (mid-drain)."""
        return self._gen_active

    def close(self) -> None:
        if self._gen_active:
            self._stop_gen()
        if getattr(self.engine.store, "_process_drain", None) is self:
            self.engine.store._process_drain = None
        if self.engine.round_hook == self._on_round:
            self.engine.round_hook = None

    def inject_boundary_faults(
        self,
        seed: int,
        drop_rate: float = 0.0,
        dup_rate: float = 0.0,
        delay_rate: float = 0.0,
    ) -> None:
        """Arm seeded drop/dup/delay injection on the wire boundary
        (chaos ``boundary_faults`` arm). Must be armed before the drain
        whose generation should see faults — children inherit the plan
        at fork and compute identical verdicts."""
        from grove_tpu_torch.runtime.boundary import BoundaryFaults

        self._faults = BoundaryFaults(
            seed,
            drop_rate=drop_rate,
            dup_rate=dup_rate,
            delay_rate=delay_rate,
        )

    def _on_round(self) -> None:
        """Engine round hook: routing just ran — everything logged so far
        is now cache-advanced in the serial twin, so worker mirrors may
        advance through it too."""
        if self._gen_active:
            self._cache_mark = len(self._log)

    # -- drive ------------------------------------------------------------

    def drain(self, max_rounds: int) -> int:
        """One engine drain through the shared round loop, with this
        executor substituted. Workers fork lazily at the first batch that
        routes off the coordination plane (idle ticks never fork) and the
        generation is torn down — worker WAL streams final-flushed,
        watermarks shipped home, processes reaped — before returning."""
        try:
            return self.engine._drain_rounds(
                max_rounds, execute_batch=self._run_batch
            )
        finally:
            if self._gen_active:
                self._stop_gen()

    # -- sync recorder ----------------------------------------------------

    def _record(self, ev) -> None:
        """Store-wide system watcher. Coordinator: while a generation is
        live, append every commit — lane-0 reconcile commits arrive here
        via the deferred-capture replay (batch order), mirror-applies and
        coordinator-phase commits live (their emit order IS the serial
        order) — to the sync stream workers mirror from. Worker: while a
        reconcile runs, collect its commits for the reply."""
        if self._child_id is not None:
            if self._recording:
                self._clog.append(ev)
            return
        if self._gen_active and not self._muted:
            self._log.append({"t": ev.type, "o": 0, "ev": ev})

    def _ring_cb(self, shard_index: int):
        def cb(ev, _i=shard_index) -> None:
            # WAL backfill ring: only while the shard's stream is remote,
            # and never Events (outside the durability contract)
            if self._ring_gate.get(_i) and ev.kind != "Event":
                self._rings[_i].append(ev)

        return cb

    def _ship_slice(self, w: int):
        """(base, records): the sync records worker `w` has not seen yet,
        envelope-encoded once (encoding is cached on the record — every
        worker ships the same doc), plus their starting position in the
        log so the worker can gate each against the cache watermark."""
        from grove_tpu_torch.durability.wal import object_envelope

        base = self._cursors.get(w, 0)
        out = []
        for rec in self._log[base:]:
            if "env" not in rec:
                rec["env"] = object_envelope(rec["ev"].obj)
                rec["ev"] = None  # encoded once; every worker ships this doc
            out.append({"t": rec["t"], "o": rec["o"], "env": rec["env"]})
        self._cursors[w] = len(self._log)
        return base, out

    # -- generation lifecycle ---------------------------------------------

    def _start_gen(self) -> None:
        store = self.engine.store
        dur = getattr(store, "_durability", None)
        if dur is not None and dur._committer is not None:
            raise GroveError(
                ERR_TRANSPORT,
                "worker-process backend cannot run under a background WAL"
                " committer thread (fork while another thread may hold the"
                " stream locks); stop the committer first",
                "enable-workers",
            )
        if not self._recorder_installed:
            # registered AFTER arm_deferred_fanout wrapped the store-wide
            # fan-out, so lane-0 capture defers these deliveries into the
            # batch-order replay — the recorder sees the serial order
            store.subscribe_system(self._record)
            self._recorder_installed = True
        self._epoch += 1
        self._log = []
        self._cursors = {}
        self._cache_mark = -1
        self._dead = set()
        self._tx_seq = {}
        self._rx_seq = {}
        self._last_sent = {}
        self._crx_high = 0
        self._creply_cache = {}
        child_shards = [
            i for i in range(self.engine.num_shards) if self.worker_of(i) != 0
        ]
        for i in child_shards:
            if i not in self._ring_subscribed:
                store.subscribe_system(self._ring_cb(i), shard=i)
                self._ring_subscribed.add(i)
            self._rings[i] = []
            self._ring_gate[i] = dur is not None
        if dur is not None:
            for i in child_shards:
                # flush BEFORE the fork: records buffered by coordinator
                # phases since the last pump would otherwise be copied
                # into the child (which final-flushes them) AND stay in
                # this process's buffer (flushed again at the next pump)
                # — duplicate seqs that truncate the durable fold
                dur.wals[i].flush()
                dur.wals[i].remote = True
        # all channels exist before any fork: each child closes every fd
        # that is not its own, so a dead worker's EOF is observable (a
        # sibling holding the write end would mask it)
        channels = {
            w: self._mp.Pipe(duplex=True) for w in range(1, self.workers)
        }
        self._gen_active = True
        procs = {}
        import warnings

        with warnings.catch_warnings():
            # the fork-with-threads hazard this warns about is exactly
            # what the committer guard above rules out; the warning would
            # otherwise print once per generation into smoke artifacts
            warnings.filterwarnings("ignore", category=RuntimeWarning)
            for w in range(1, self.workers):
                p = self._mp.Process(
                    target=self._child_main,
                    args=(w, channels),
                    daemon=True,
                    name=f"cp-worker-{w}",
                )
                p.start()
                procs[w] = p
        for w, (parent_conn, child_conn) in channels.items():
            child_conn.close()
        self._conns = {w: pc for w, (pc, _cc) in channels.items()}
        self._procs = procs

    def _stop_gen(self) -> None:
        dur = getattr(self.engine.store, "_durability", None)
        live = [
            w for w in self._procs
            if w not in self._dead
        ]
        for w in live:
            try:
                self._send(w, {"cmd": "stop"})
            except (OSError, ValueError):
                self._repatriate(w, "stop-send failed")
        for w in live:
            if w in self._dead:
                continue
            bye = self._recv(w, timeout=30.0)
            if bye is None or bye.get("cmd") != "bye":
                self._repatriate(w, "no stop handshake")
                continue
            if dur is not None:
                for wm in bye.get("wal", []):
                    wal = dur.wals[wm["shard"]]
                    # adopt the worker's stream position wholesale: seq
                    # numbering, durable watermarks and the segment cursor
                    # continue exactly where the owner left them
                    wal._seq = wm["seq"]
                    wal.durable_seq = wm["durable_seq"]
                    wal.durable_rv = wm["durable_rv"]
                    wal.flushed_bytes = wm["flushed_bytes"]
                    wal.flushed_records = wm["flushed_records"]
                    if wal._fh is not None:
                        wal._fh.close()
                        wal._fh = None
                    wal._segment_index = wm["segment_index"]
                    wal._segment_bytes = wm["segment_bytes"]
                    self._rings[wm["shard"]] = []
        self._gen_active = False
        for i in list(self._ring_gate):
            self._ring_gate[i] = False
            self._rings[i] = []
        if dur is not None:
            for wal in dur.wals:
                wal.remote = False
        for w, p in self._procs.items():
            p.join(timeout=5.0)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
        for conn in self._conns.values():
            try:
                conn.close()
            except OSError:
                pass
        self._procs = {}
        self._conns = {}

    def kill_all(self) -> None:
        """SIGKILL every live worker (StoreDurability.simulate_crash: the
        control plane dies as ONE failure domain — buffered worker records
        are lost exactly like the coordinator's own buffer). Streams
        re-localize WITHOUT ring replay: a crash loses unacked records by
        definition."""
        if not self._gen_active:
            return
        for w, p in self._procs.items():
            if p.is_alive():
                try:
                    os.kill(p.pid, signal.SIGKILL)
                except (OSError, TypeError):
                    pass
            p.join(timeout=5.0)
        dur = getattr(self.engine.store, "_durability", None)
        if dur is not None:
            for wal in dur.wals:
                wal.remote = False
        self._gen_active = False
        for i in list(self._ring_gate):
            self._ring_gate[i] = False
            self._rings[i] = []
        self._procs = {}
        self._conns = {}

    def _repatriate(self, w: int, why: str) -> None:
        """Worker `w`'s channel died: take its shards back. Its WAL
        streams re-localize and the mirror-applied commits it never
        fsynced backfill from the rings, so the acked prefix stays
        gap-free; its in-flight keys re-execute inline at their batch
        positions (deterministic: the mirror is exact)."""
        if w in self._dead:
            return
        self._dead.add(w)
        self.crashes += 1
        METRICS.inc("cp_worker_crashes_total")
        p = self._procs.get(w)
        if p is not None:
            if p.is_alive():
                try:
                    os.kill(p.pid, signal.SIGKILL)
                except (OSError, TypeError):
                    pass
            p.join(timeout=5.0)
        dur = getattr(self.engine.store, "_durability", None)
        for i in range(self.engine.num_shards):
            if self.worker_of(i) != w:
                continue
            self._ring_gate[i] = False
            if dur is not None:
                wal = dur.wals[i]
                wal.remote = False
                for ev in self._rings.get(i, ()):
                    wal.note_event(ev)
            self._rings[i] = []
        if FLIGHTREC.enabled:
            FLIGHTREC.trigger(
                "cp-worker-crash",
                f"worker {w} {why}; coordinator repatriated its shards"
                " and re-executes its keys inline",
            )

    # -- channel ----------------------------------------------------------

    def _send(self, w: int, msg: dict) -> None:
        if self._faults is None:
            payload = json.dumps(msg, separators=(",", ":")).encode(
                "utf-8"
            )
            self.boundary_bytes += len(payload)
            METRICS.inc("cp_boundary_bytes_total", len(payload))
            self._conns[w].send_bytes(payload)
            return
        # armed: frame with a per-channel sequence number and let the
        # fault plan decide. drop/delay withhold the frame — the
        # retrying _recv below retransmits it (that IS the delay) —
        # dup transmits twice (the worker's seq dedup eats the copy).
        seq = self._tx_seq.get(w, 0) + 1
        self._tx_seq[w] = seq
        payload = json.dumps(
            {"fs": seq, "fm": msg}, separators=(",", ":")
        ).encode("utf-8")
        self._last_sent[w] = payload
        verdict = self._faults.decide("c2w", w, seq)
        if verdict in ("drop", "delay"):
            self.boundary_fault_counts[verdict] += 1
            METRICS.inc("cp_boundary_faults_total")
            return
        self.boundary_bytes += len(payload)
        METRICS.inc("cp_boundary_bytes_total", len(payload))
        self._conns[w].send_bytes(payload)
        if verdict == "dup":
            self.boundary_fault_counts["dup"] += 1
            METRICS.inc("cp_boundary_faults_total")
            self._conns[w].send_bytes(payload)

    def _recv(self, w: int, timeout: float) -> Optional[dict]:
        """One framed reply from worker `w`, deadline-bounded. None means
        the channel is dead (caller repatriates); a live-but-stalled
        worker past the deadline fails CLOSED. With boundary faults
        armed this loop also DEDUPS (stale reply seqs are duplicates)
        and RETRANSMITS the last request on a BackoffPolicy pace —
        withheld or lost frames heal here, inside the same deadline."""
        conn = self._conns[w]
        proc = self._procs[w]
        armed = self._faults is not None
        deadline = time.monotonic() + timeout
        attempt = 0
        next_retx = (
            time.monotonic() + self._faults.retransmit_after(w, 0)
            if armed
            else None
        )
        while True:
            try:
                if conn.poll(0.05):
                    data = conn.recv_bytes()
                    self.boundary_bytes += len(data)
                    METRICS.inc("cp_boundary_bytes_total", len(data))
                    doc = json.loads(data)
                    if armed and isinstance(doc, dict) and "fs" in doc:
                        seq = doc["fs"]
                        if seq <= self._rx_seq.get(w, 0):
                            # duplicate of a reply already consumed
                            self.boundary_fault_counts["deduped"] += 1
                            continue
                        self._rx_seq[w] = seq
                        return doc["fm"]
                    return doc
            except (EOFError, OSError):
                return None
            if not proc.is_alive():
                # drain anything the worker wrote before dying
                try:
                    if conn.poll(0.0):
                        continue
                except (EOFError, OSError):
                    pass
                return None
            now = time.monotonic()
            if now > deadline:
                raise GroveError(
                    ERR_TRANSPORT,
                    f"worker {w} stalled past the {timeout:.0f}s batch"
                    " deadline; failing closed (flight bundle dumped)",
                    "process-drain",
                )
            if armed and now >= next_retx:
                last = self._last_sent.get(w)
                if last is not None:
                    # retransmits bypass injection: one fault per frame
                    # seq models gray loss, and the retry path must be
                    # the reliable one or nothing ever converges
                    try:
                        conn.send_bytes(last)
                    except (OSError, ValueError):
                        return None
                    self.boundary_fault_counts["retransmits"] += 1
                    METRICS.inc("cp_boundary_retransmits_total")
                attempt += 1
                next_retx = now + self._faults.retransmit_after(
                    w, attempt
                )

    # -- coordinator batch path -------------------------------------------

    def _run_batch(self, ctrl, batch: List, now: float) -> None:
        eng = self.engine
        if not self._gen_active:
            # idle ticks never reach here with remote keys before forking:
            # fork lazily only when this drain actually has a batch
            if all(
                self.worker_of(eng._shard_of_key(k)) == 0 for k in batch
            ):
                self._run_local(ctrl, batch, now, {})
                return
            self._start_gen()
        bytes0 = self.boundary_bytes
        groups: Dict[int, List] = {}
        for key in batch:
            groups.setdefault(self._lane_of(eng._shard_of_key(key)), []).append(key)
        ci = next(i for i, c in enumerate(eng.controllers) if c is ctrl)
        dispatched: List[int] = []
        for w, keys in groups.items():
            if w == 0:
                continue
            base, records = self._ship_slice(w)
            try:
                self._send(
                    w,
                    {
                        "cmd": "batch",
                        "ci": ci,
                        "keys": [list(k) for k in keys],
                        "sync": records,
                        "base": base,
                        "cm": self._cache_mark,
                    },
                )
                dispatched.append(w)
            except (OSError, ValueError):
                self._repatriate(w, "batch dispatch failed")
        if self.chaos_kill_worker is not None:
            victim = self.chaos_kill_worker
            if victim in dispatched:
                # chaos `worker_crash`: the process dies MID-ROUND, after
                # the batch left the coordinator — the recovery path must
                # cope whether or not a reply was already in the pipe
                self.chaos_kill_worker = None
                p = self._procs.get(victim)
                if p is not None and p.is_alive():
                    os.kill(p.pid, signal.SIGKILL)
        # lane 0 executes during worker flight (under deferred capture —
        # replayed at batch position below), then the overlap hook spends
        # the remaining flight time on the scheduler's speculative encode
        local_outcomes: Dict[tuple, tuple] = {}
        if 0 in groups:
            self._run_local(ctrl, groups[0], now, local_outcomes, defer=True)
        if eng.overlap_hook is not None:
            eng.overlap_hook()
        # collect replies
        replies: Dict[tuple, dict] = {}
        reply_worker: Dict[tuple, int] = {}
        for w in dispatched:
            if w in self._dead:
                continue
            msg = self._recv(w, timeout=BATCH_DEADLINE_S)
            if msg is None:
                self._repatriate(w, "channel died mid-round")
                continue
            if msg.get("cmd") == "fatal":
                self._repatriate(w, f"fatal: {msg.get('error')}")
                raise GroveError(
                    ERR_TRANSPORT,
                    f"worker {w} failed: {msg.get('error')}",
                    "process-drain",
                )
            results = msg.get("results", [])
            if msg.get("cmd") != "done" or len(results) != len(groups[w]):
                self._repatriate(w, "malformed reply")
                raise GroveError(
                    ERR_TRANSPORT,
                    f"worker {w} reply did not match its batch"
                    f" ({len(results)} results for {len(groups[w])} keys)",
                    "process-drain",
                )
            for key, entry in zip(groups[w], results):
                replies[key] = entry
                reply_worker[key] = w
            self.reconciles_by_worker[w] += len(groups[w])
            busy = sum(e.get("dur", 0.0) for e in results)
            self._worker_busy_s[w] += busy
            METRICS.inc(f"cp_worker_reconciles@{w}", len(groups[w]))
        # coordination point: apply + bookkeeping in serial batch order.
        # Each key lands exactly once, at its batch position: a lane-0
        # key replays its captured deliveries, a worker key mirror-applies
        # its shipped commits (live emission = the serial delivery
        # order), a crashed worker's key re-executes inline right here.
        from grove_tpu_torch.controller.common import contexts_of_store

        ctxs = contexts_of_store(eng.store)
        for key in batch:
            if key in replies:
                entry = replies[key]
                w = reply_worker[key]
                self._muted = True
                try:
                    for doc in entry.get("commits", []):
                        eng.store.apply_remote_event(doc["t"], doc["env"])
                        self._log.append(
                            {"t": doc["t"], "o": w, "env": doc["env"]}
                        )
                finally:
                    self._muted = False
                exp = entry.get("exp")
                if exp is not None and ctxs:
                    ctxs[0].pod_expectations.import_key(
                        f"{key[1]}/{key[2]}", exp[0], exp[1]
                    )
                result = _decode_result(entry.get("r"))
                error = _decode_error(entry.get("e"))
                eng._complete(ctrl, key, result, error, now)
                METRICS.observe(
                    f"reconcile_seconds/{ctrl.name}", entry.get("dur", 0.0)
                )
            elif key in local_outcomes:
                result, error, captured = local_outcomes[key]
                eng._complete(ctrl, key, result, error, now)
                for fn, ev in captured:
                    fn(ev)
            else:
                # crashed worker: deterministic inline re-execution from
                # the coordinator's own mirror, at the key's position
                result = error = None
                try:
                    result = eng._timed(ctrl, key)
                except Exception as e:
                    error = e
                self.reconciles_by_worker[0] += 1
                eng._complete(ctrl, key, result, error, now)
        METRICS.set("cp_boundary_bytes_round", self.boundary_bytes - bytes0)

    def _run_local(
        self, ctrl, keys: List, now: float, outcomes: Dict, defer: bool = False
    ) -> None:
        """Lane 0: the coordinator's own sub-sequence. With defer=True the
        outcomes (and captured deliveries) are returned for batch-order
        completion; otherwise complete immediately (all-local batch — the
        serial path verbatim)."""
        eng = self.engine
        store = eng.store
        t0 = time.perf_counter()
        for key in keys:
            buf = store.begin_deferred_capture() if defer else None
            result = error = None
            try:
                result = eng._timed(ctrl, key)
            except Exception as e:
                error = e
            finally:
                captured = store.end_deferred_capture(buf) if defer else []
            if defer:
                outcomes[key] = (result, error, captured)
            else:
                eng._complete(ctrl, key, result, error, now)
        self._worker_busy_s[0] += time.perf_counter() - t0
        self.reconciles_by_worker[0] += len(keys)
        METRICS.inc("cp_worker_reconciles@0", len(keys))

    # -- worker process ---------------------------------------------------

    def _child_main(self, me: int, channels: Dict[int, tuple]) -> None:
        """Forked worker body. Exits only via os._exit: the child must
        never run the parent's inherited atexit/finalizer chain (shared
        tmpdirs, metric dumps)."""
        conn = None
        try:
            for w, (parent_conn, child_conn) in channels.items():
                if w == me:
                    parent_conn.close()
                    conn = child_conn
                else:
                    parent_conn.close()
                    child_conn.close()
            self._child_setup(me)
            while True:
                frame = json.loads(conn.recv_bytes())
                seq = 0
                if (
                    self._faults is not None
                    and isinstance(frame, dict)
                    and "fs" in frame
                ):
                    seq = frame["fs"]
                    if seq <= self._crx_high:
                        # retransmit of a request already executed:
                        # answer from the cached reply — idempotent, the
                        # batch must never run twice
                        cached = self._creply_cache.get(seq)
                        if cached is not None:
                            conn.send_bytes(cached)
                        continue
                    self._crx_high = seq
                    msg = frame["fm"]
                else:
                    msg = frame
                if msg["cmd"] == "batch":
                    self._child_reply(
                        conn, me, seq, self._child_batch(msg)
                    )
                elif msg["cmd"] == "stop":
                    # the stop handshake carries the WAL watermarks —
                    # never inject on it (the child exits right after,
                    # so the retransmit path could not heal a drop)
                    self._child_reply(
                        conn,
                        me,
                        seq,
                        {"cmd": "bye", "wal": self._child_final_flush(me)},
                        faultable=False,
                    )
                    os._exit(0)
        except EOFError:
            os._exit(0)  # coordinator closed the channel / died
        except BaseException as e:  # noqa: BLE001 — ships the postmortem
            try:
                if conn is not None:
                    conn.send_bytes(
                        json.dumps(
                            {"cmd": "fatal", "error": repr(e)},
                            separators=(",", ":"),
                        ).encode("utf-8")
                    )
            except OSError:
                pass
            os._exit(1)

    def _child_reply(
        self, conn, me: int, seq: int, msg: dict, faultable: bool = True
    ) -> None:
        """Send one reply frame from a worker. Armed: frame with the
        request's seq (monotone — the coordinator dedups on it), cache
        the payload for retransmit-triggered resends, and let the fault
        plan withhold or duplicate the transmit."""
        if self._faults is None:
            conn.send_bytes(
                json.dumps(msg, separators=(",", ":")).encode("utf-8")
            )
            return
        payload = json.dumps(
            {"fs": seq, "fm": msg}, separators=(",", ":")
        ).encode("utf-8")
        # cache keyed by request seq: a retransmitted request resends
        # this exact payload (the cached-reply path bypasses injection)
        self._creply_cache = {seq: payload}
        if faultable:
            verdict = self._faults.decide("w2c", me, seq)
            if verdict in ("drop", "delay"):
                return  # withheld: the coordinator's retransmit heals it
            conn.send_bytes(payload)
            if verdict == "dup":
                conn.send_bytes(payload)
            return
        conn.send_bytes(payload)

    def _child_setup(self, me: int) -> None:
        import gc

        from grove_tpu_torch.api.meta import reset_uid_namespace
        from grove_tpu_torch.controller.common import rebase_event_sequences

        # the inherited heap may hold the coordinator's device tensors: a
        # cyclic collection here would free one in a process that must not
        # touch the card, so everything inherited leaves the collector's view
        gc.freeze()
        self._child_id = me
        self._clog = []
        self._echo_queue = []
        # commits routed by the coordinator before the fork sit in the
        # inherited backlogs: they are committed (COW) but not yet
        # cache-advanced. They advance at the parent's next routing —
        # index -1 puts them before every sync record, so any watermark
        # from a post-fork routing releases them.
        self._pending_cache = []
        for backlog in self.engine._backlogs:
            for ev in backlog:
                self._pending_cache.append((-1, ev))
            backlog.clear()
        # fresh uid incarnation + a disjoint evt-N range per (generation,
        # worker): forked allocators would otherwise re-issue the
        # coordinator's next uid/event name
        reset_uid_namespace()
        rebase_event_sequences(self._epoch * self.workers + me)
        try:
            TRACER.enabled = False
        except AttributeError:
            pass
        store = self.engine.store
        store._process_drain = None
        dur = getattr(store, "_durability", None)
        if dur is not None:
            for i, wal in enumerate(dur.wals):
                wal.remote = self.worker_of(i) != me
        for i in self._ring_gate:
            self._ring_gate[i] = False

    def _child_batch(self, msg: dict) -> dict:
        from grove_tpu_torch.controller.common import contexts_of_store
        from grove_tpu_torch.durability.wal import object_envelope

        eng = self.engine
        store = eng.store
        self._child_apply_sync(
            msg.get("sync", []), msg.get("base", 0), msg.get("cm", -1)
        )
        ctrl = eng.controllers[msg["ci"]]
        keys = [tuple(k) for k in msg["keys"]]
        if ctrl.batch_hook is not None:
            # re-run the coordinator's per-batch hook locally (it builds
            # lazy caches off the frozen informer view — deterministic)
            ctrl.batch_hook(keys)
        ctxs = contexts_of_store(store)
        results = []
        for key in keys:
            t0 = time.perf_counter()
            self._clog = []
            self._recording = True
            result = error = None
            try:
                result = eng._timed(ctrl, key)
            except Exception as e:
                error = e
            finally:
                self._recording = False
            commits = [
                {"t": ev.type, "env": object_envelope(ev.obj)}
                for ev in self._clog
            ]
            self._echo_queue.extend(self._clog)
            entry = {
                "r": None
                if result is None
                else {"result": result.result, "ra": result.requeue_after},
                "e": None if error is None else _encode_error(error),
                "commits": commits,
                "dur": time.perf_counter() - t0,
            }
            if ctxs:
                entry["exp"] = list(
                    ctxs[0].pod_expectations.export_key(f"{key[1]}/{key[2]}")
                )
            results.append(entry)
        # the worker never routes: drop the backlog its own commits fed
        # (cache advance happens through the sync stream instead)
        for backlog in eng._backlogs:
            backlog.clear()
        return {"cmd": "done", "results": results}

    def _child_apply_sync(
        self, records: List[dict], base: int, cm: int
    ) -> None:
        """Advance this worker's mirror by the coordinator's sync slice —
        the serial apply order. A record of our own origin is an ECHO:
        the commit is already in our committed maps and only the cache
        step remains; a foreign record mirror-applies.

        The informer cache advances SEPARATELY, gated by the watermark
        `cm`: a record at log position < cm was routed by the serial
        twin (its round boundary passed), so it is cache-visible; one at
        position >= cm is committed-only until a later batch's watermark
        releases it — a reconcile here must see exactly the frozen
        round view the serial reconcile sees."""
        store = self.engine.store
        if store.cache_lag:
            keep = []
            for i, ev in self._pending_cache:
                if i < cm:
                    store.apply_event_to_cache(ev)
                else:
                    keep.append((i, ev))
            self._pending_cache = keep
        for pos, rec in enumerate(records):
            if rec["o"] == self._child_id:
                if not self._echo_queue:
                    raise GroveError(
                        ERR_TRANSPORT,
                        "sync echo with no matching local commit: the"
                        " mirrors diverged",
                        "process-drain",
                    )
                ev = self._echo_queue.pop(0)
                env = rec["env"]
                if ev.kind != env["kind"] or ev.obj.metadata.name != env["name"]:
                    raise GroveError(
                        ERR_TRANSPORT,
                        f"sync echo mismatch: local {ev.kind}/"
                        f"{ev.obj.metadata.name} vs shipped"
                        f" {env['kind']}/{env['name']}",
                        "process-drain",
                    )
            else:
                ev = store.apply_remote_event(rec["t"], rec["env"])
            if store.cache_lag:
                if base + pos < cm:
                    store.apply_event_to_cache(ev)
                else:
                    self._pending_cache.append((base + pos, ev))

    def _child_final_flush(self, me: int) -> List[dict]:
        """Stop handshake: fsync every owned stream once and report the
        stream positions the coordinator adopts."""
        dur = getattr(self.engine.store, "_durability", None)
        if dur is None:
            return []
        out = []
        for i, wal in enumerate(dur.wals):
            if self.worker_of(i) != me:
                continue
            wal.flush()
            out.append(
                {
                    "shard": i,
                    "seq": wal._seq,
                    "durable_seq": wal.durable_seq,
                    "durable_rv": wal.durable_rv,
                    "flushed_bytes": wal.flushed_bytes,
                    "flushed_records": wal.flushed_records,
                    "segment_index": wal._segment_index,
                    "segment_bytes": wal._segment_bytes,
                }
            )
            if wal._fh is not None:
                wal._fh.close()
                wal._fh = None
        return out

    # -- reporting --------------------------------------------------------

    def stats(self) -> dict:
        return {
            "backend": "process",
            "workers": self.workers,
            "reconciles_by_worker": list(self.reconciles_by_worker),
            "busy_seconds_by_worker": [
                round(b, 3) for b in self._worker_busy_s
            ],
            "worker_crashes": self.crashes,
            "boundary_bytes": self.boundary_bytes,
            "boundary_faults": dict(self.boundary_fault_counts),
        }
