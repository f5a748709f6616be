"""Crash-restart recovery + the store↔WAL attachment.

Counterpart of ``grove_tpu/durability/recovery.py``.

``recover_store`` rebuilds a Store from a durability directory: load the
newest valid snapshot, replay the WAL tail (truncating at the first bad
CRC — the torn-tail policy), decode the surviving envelopes through the
wire codec, and bulk-load them with identity preserved
(``Store.restore_objects`` restores resourceVersion/generation
monotonicity). The recovered store then converges like a failover does:
the caller runs the PR-5 resync machinery — ``engine.requeue_all()``,
``cluster.rebuild_bindings()``, ``monitor.resync()``, fresh
broker/drainer (``SimHarness.cold_restart`` packages exactly that).

``StoreDurability`` is the live attachment: it subscribes to the store's
system watch fanout (the same channel kubelets use — zero new code on
the commit path), buffers records, and group-commits them off the
reconcile path via ``pump()`` (sim tick boundary) or a background
committer thread (real-cluster mode).

``verify_acked_prefix`` is the independent auditor behind the chaos
harness's *no-acked-commit-lost* invariant: it re-reads the durable
prefix from disk and demands the recovered store match it exactly.
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import List, Optional

from grove_tpu_torch.durability.snapshot import write_snapshot
from grove_tpu_torch.durability.wal import (
    WriteAheadLog,
    _iter_durable_state,
    apply_record,
    decode_envelope,
    list_segments,
    list_shard_dirs,
    replay,
    shard_dir_name,
)
from grove_tpu_torch.observability.events import (
    EVENTS,
    REASON_RECOVERY_COMPLETED,
    REASON_SNAPSHOT_TAKEN,
    REASON_WAL_DEGRADED,
    REASON_WAL_RECOVERED,
    REASON_WAL_TORN_TAIL,
    TYPE_NORMAL,
    TYPE_WARNING,
)
from grove_tpu_torch.observability.metrics import METRICS
from grove_tpu_torch.observability.tracing import TRACER
from grove_tpu_torch.runtime.errors import ERR_CONFLICT, GroveError

# the EVENTS ref durability events attach to: the store has no CR of its
# own (it IS the apiserver), so the recorder gets a synthetic singleton
_STORE_REF = ("Store", "", "durability")


@dataclass
class RecoveryReport:
    snapshot_rv: int = 0
    replayed_records: int = 0
    restored_objects: int = 0
    resource_version: int = 0
    torn_tail: bool = False
    wall_seconds: float = 0.0

    def as_dict(self) -> dict:
        return {
            "snapshot_rv": self.snapshot_rv,
            "replayed_records": self.replayed_records,
            "restored_objects": self.restored_objects,
            "resource_version": self.resource_version,
            "torn_tail": self.torn_tail,
            "wall_seconds": round(self.wall_seconds, 4),
            "replay_records_per_sec": round(
                self.replayed_records / self.wall_seconds, 1
            )
            if self.wall_seconds > 0
            else 0.0,
        }


def recover_store(
    directory: str, clock=None, cache_lag: bool = False
):
    """Rebuild a Store from its durability directory.

    Returns ``(store, RecoveryReport)``. The store holds exactly the
    durable prefix: snapshot base + replayed WAL tail, last-write-wins
    per key, torn tail truncated at the first bad CRC. Empty/missing
    directories recover to an empty store (a first boot)."""
    from grove_tpu_torch.durability.snapshot import load_latest_snapshot
    from grove_tpu_torch.runtime.store import Store

    report = RecoveryReport()
    t0 = time.perf_counter()
    with TRACER.span("recovery.replay", directory=directory) as span:
        # sharded layout probe (docs/control-plane.md): per-shard WAL dirs
        # mean a sharded store wrote this directory — recover each shard's
        # self-contained stream and merge; the dir count fixes the shard
        # count (the keyspace map is deterministic, so every object lands
        # back on the shard whose stream carried it). A dir with segments
        # or a snapshot directly inside is the legacy unsharded layout and
        # pins S=1 whatever the ambient knob says (the disk wins). A dir
        # with NEITHER is a first boot: nothing on disk constrains the
        # shape, so the store follows the configured shard count
        # (GROVE_TPU_STORE_SHARDS) — the real-cluster operator boots
        # through recovery even on an empty data dir, and pinning S=1
        # there would silently disable sharding forever.
        from grove_tpu_torch.durability.snapshot import list_snapshots

        shard_dirs = list_shard_dirs(directory)
        # existence probe only (filename scan) — loading the snapshot here
        # would CRC-parse the whole store state twice per recovery
        legacy_layout = bool(list_segments(directory)) or bool(
            list_snapshots(directory)
        )
        if shard_dirs:
            num_shards = shard_dirs[-1][0] + 1
            if len(shard_dirs) != num_shards:
                # a GAP in the shard-NNN sequence means a shard's whole
                # stream is gone (partial copy, external deletion) —
                # recovering it as "empty" would silently drop its acked
                # commits and the audit could never see them
                present = [i for i, _ in shard_dirs]
                raise GroveError(
                    ERR_CONFLICT,
                    f"per-shard WAL layout has gaps: dirs {present} imply"
                    f" {num_shards} shards but only {len(shard_dirs)}"
                    " stream(s) are on disk — refusing to recover with a"
                    " missing shard stream",
                    "recover",
                )
            streams = shard_dirs
        elif legacy_layout:
            num_shards = 1
            streams = [(0, directory)]
        else:
            # first boot: env-/default-configured shape (num_shards=None →
            # the Store constructor's GROVE_TPU_STORE_SHARDS default), no
            # streams to read
            num_shards = None
            streams = []
        state: dict = {}
        shard_rvs: dict = {}
        for shard_idx, stream_dir in streams:
            snap = load_latest_snapshot(stream_dir)
            max_rv = 0
            min_segment = -1
            if snap is not None:
                # scalar report field follows the store's merge rule:
                # per-shard watermarks SUM to the store-level rv
                report.snapshot_rv += snap["rv"]
                max_rv = snap["rv"]
                min_segment = snap.get("wal_seg", -1)
                for env in snap["objects"]:
                    state[(env["kind"], env["ns"], env["name"])] = env
            records, torn, _truncated = replay(
                stream_dir, min_segment=min_segment
            )
            report.torn_tail = report.torn_tail or torn
            report.replayed_records += len(records)
            for rec in records:
                max_rv = max(max_rv, rec.rv)
                apply_record(state, rec)
            shard_rvs[shard_idx] = max_rv
        torn = report.torn_tail
        store = Store(clock, cache_lag=cache_lag, num_shards=num_shards)
        rv_vector = [
            shard_rvs.get(i, 0) for i in range(store.num_shards)
        ]
        objects = [
            decode_envelope(env)
            for _key, env in sorted(state.items())
            if env is not None
        ]
        report.restored_objects = store.restore_objects(
            objects,
            rv=rv_vector[0],
            rv_vector=tuple(rv_vector) if store.num_shards > 1 else None,
        )
        report.resource_version = store.resource_version
        span.set("replayed", report.replayed_records)
        span.set("restored", report.restored_objects)
        span.set("torn_tail", torn)
        span.set("shards", store.num_shards)
    report.wall_seconds = time.perf_counter() - t0
    METRICS.observe("recovery_seconds", report.wall_seconds)
    METRICS.set("recovery_replayed_records", report.replayed_records)
    if torn:
        METRICS.inc("wal_torn_tails_total")
        EVENTS.record(
            _STORE_REF,
            TYPE_WARNING,
            REASON_WAL_TORN_TAIL,
            "torn WAL tail truncated at the first bad CRC during replay",
        )
    EVENTS.record(
        _STORE_REF,
        TYPE_NORMAL,
        REASON_RECOVERY_COMPLETED,
        f"recovered {report.restored_objects} object(s) at rv"
        f" {report.resource_version} (snapshot rv {report.snapshot_rv},"
        f" {report.replayed_records} WAL record(s) replayed"
        f"{', torn tail' if torn else ''})",
    )
    return store, report


def verify_acked_prefix(directory: str, store) -> List[str]:
    """Audit a just-recovered store against the durable prefix on disk.

    Independent of ``recover_store``'s in-memory state: re-reads the
    snapshot + records and demands exact agreement — every acked commit
    present at its exact resourceVersion (*no acked commit lost*), no
    object the log never acked (*no phantom state*), and the store's
    version counter at or past the durable watermark (monotonicity).
    Call it BEFORE new commits land; afterwards the store legitimately
    runs ahead of the log's unflushed buffer."""
    problems: List[str] = []
    seen = set()
    shard_dirs = list_shard_dirs(directory)
    streams = shard_dirs if shard_dirs else [(None, directory)]
    if shard_dirs:
        present = [i for i, _ in shard_dirs]
        if present != list(range(getattr(store, "num_shards", 1))):
            # covers both count mismatch and a GAP in the sequence (a
            # missing stream means lost acked commits the per-stream scan
            # below could never see)
            problems.append(
                f"per-shard WAL layout mismatch: dirs {present} on disk,"
                f" store has {getattr(store, 'num_shards', 1)} shard(s)"
            )
            return problems
    for shard_idx, stream_dir in streams:
        where = "" if shard_idx is None else f" (shard {shard_idx})"
        durable_rv = 0
        for key, env in _iter_durable_state(stream_dir):
            kind, ns, name = key
            if env is None:
                continue  # durably deleted: absence is checked via `seen`
            seen.add(key)
            durable_rv = max(durable_rv, env["rv"])
            obj = store.get(kind, ns, name, readonly=True)
            if obj is None:
                problems.append(
                    f"acked commit lost: {kind} {ns}/{name} rv {env['rv']}"
                    " is durable on disk but missing from the recovered"
                    f" store{where}"
                )
            elif obj.metadata.resource_version != env["rv"]:
                problems.append(
                    f"acked commit diverged: {kind} {ns}/{name} recovered at"
                    f" rv {obj.metadata.resource_version}, durable rv is"
                    f" {env['rv']}{where}"
                )
        # monotonicity per rv sequence: one scalar for the unsharded
        # store, each shard's own watermark when sharded (the scalar sum
        # would mask a single shard's regression)
        watermark = (
            store.resource_version
            if shard_idx is None
            else store.shard_resource_version(shard_idx)
        )
        if watermark < durable_rv:
            problems.append(
                f"resourceVersion regressed{where}: store at {watermark},"
                f" durable watermark {durable_rv}"
            )
    for kind in store.kinds():
        if kind == "Event":
            continue  # fire-and-forget: outside the durability contract
        for obj in store.scan(kind):
            key = (kind, obj.metadata.namespace, obj.metadata.name)
            if key not in seen:
                problems.append(
                    f"phantom object after recovery: {kind}"
                    f" {key[1]}/{key[2]} is in the store but not in the"
                    " durable prefix"
                )
    return problems


class StoreDurability:
    """Live WAL + snapshot attachment for one Store.

    With no attachment the store is byte-identical to an undurable one
    (the subscription is the only coupling). ``pump()`` is the
    off-reconcile-path committer: flush the group-commit buffer, then
    snapshot when enough bytes accumulated since the last one. Sims call
    it at tick boundaries (deterministic); real-cluster mode runs it on
    the background committer thread."""

    def __init__(
        self,
        store,
        directory: str,
        segment_max_bytes: int = 4 * 2**20,
        snapshot_every_bytes: int = 32 * 2**20,
        lock=None,
    ) -> None:
        self.store = store
        # backref for the worker-process backend (runtime/procworkers.py):
        # the drain splits WAL stream ownership across processes and needs
        # the live attachment, which nothing else hangs off the store
        store._durability = self
        self.directory = directory
        # sharded stores (docs/control-plane.md) get one self-contained
        # WAL stream PER KEYSPACE SHARD, each subscribed to that shard's
        # fan-out (never filtering — or waiting on — another shard's
        # traffic) and writing its own shard-NNN/ subdirectory. The
        # unsharded store keeps the single WAL in `directory` itself:
        # S=1 is byte-identical on disk and over the wire.
        self.num_shards = max(1, getattr(store, "num_shards", 1))
        if self.num_shards > 1:
            self.wals = [
                WriteAheadLog(
                    os.path.join(directory, shard_dir_name(i)),
                    segment_max_bytes=segment_max_bytes,
                )
                for i in range(self.num_shards)
            ]
            for i, wal in enumerate(self.wals):
                wal.shard = i  # wall-attribution row per shard stream
                store.subscribe_system(wal.note_event, shard=i)
        else:
            self.wals = [
                WriteAheadLog(directory, segment_max_bytes=segment_max_bytes)
            ]
            store.subscribe_system(self.wals[0].note_event)
        # `wal` stays the single-stream handle (the whole pre-sharding
        # API; shard 0 when sharded — chaos knob tweaks and stats read it)
        self.wal = self.wals[0]
        self.snapshot_every_bytes = snapshot_every_bytes
        # external serialization for the snapshot's store scan (the
        # embedded apiserver's request lock in threaded real-cluster mode;
        # None in single-threaded sims)
        self._store_lock = lock
        self._flushed_at_last_snapshot = 0
        self.snapshots_taken = 0
        self._committer: Optional[threading.Thread] = None
        self._committer_stop: Optional[threading.Event] = None
        # the degradation ladder (docs/robustness.md "Gray failures"):
        # ok -> degraded (fsync latency over SLO: loud, still durable)
        # -> read-only (disk full: mutations rejected via the store's
        # error injectors, deletes still allowed — they free space).
        # Every rung transition emits a registered WalDegraded /
        # WalRecovered event; healthy stores never enter this code.
        self.degraded_mode = "ok"  # ok | degraded | read-only
        self.fsync_slo_seconds = 0.5
        self._saved_injectors: dict = {}

    # -- committer --------------------------------------------------------

    def pump(self) -> int:
        """One group-commit round: flush (fsync) the buffered batch of
        every shard stream, then snapshot + truncate when due. Returns
        records made durable.

        Worker-process backend (runtime/procworkers.py): worker
        generations are drain-scoped — each generation final-flushes the
        streams it owns and ships the watermarks back before the drain
        returns, so by the time the tick-boundary pump runs here every
        stream is local again and nothing special happens. The one
        defensive gate: if a pump ever races a live generation (a
        background committer misconfigured alongside process workers),
        remote streams no-op their flush and auto-snapshot is parked — a
        snapshot would truncate segments another process still holds a
        stale segment index into."""
        flushed = 0
        flush_failed = False
        why = ""
        for wal in self.wals:
            try:
                flushed += wal.flush()
            except OSError as exc:
                # records stay buffered in the stream (nothing acked,
                # nothing lost) — step to read-only instead of crashing
                flush_failed = True
                why = str(exc)
        if flush_failed:
            self._set_degraded_mode("read-only", why)
            return flushed
        lag = max((w.last_fsync_lag for w in self.wals), default=0.0)
        if lag > self.fsync_slo_seconds:
            # durable but SLOW (the fail-slow disk): loud rung — acks
            # still land, operators get the signal before it tips over
            self._set_degraded_mode(
                "degraded",
                f"fsync latency {lag:.3f}s over SLO"
                f" {self.fsync_slo_seconds:.3f}s",
            )
        elif self.degraded_mode != "ok":
            self._set_degraded_mode(
                "ok", "flush healthy; retained buffer drained"
            )
        drain = getattr(self.store, "_process_drain", None)
        if drain is not None and drain.active:
            return flushed
        if self.degraded_mode != "ok":
            # snapshots write to the same sick disk — park auto-snapshot
            # until the ladder steps back to ok
            return flushed
        if (
            sum(w.flushed_bytes for w in self.wals)
            - self._flushed_at_last_snapshot
            >= self.snapshot_every_bytes
        ):
            self.snapshot()
        return flushed

    # -- degradation ladder ----------------------------------------------

    _LADDER = ("ok", "degraded", "read-only")

    def _set_degraded_mode(self, mode: str, why: str) -> None:
        """One rung transition: gauge + registered event + (for the
        read-only rung) the store-side write fence. Idempotent — pump
        calls it every round; same-rung calls are free."""
        if mode == self.degraded_mode:
            return
        prev = self.degraded_mode
        self.degraded_mode = mode
        METRICS.set(
            "wal_degraded_mode", float(self._LADDER.index(mode))
        )
        if mode == "read-only":
            self._fence_writes()
        elif prev == "read-only":
            self._unfence_writes()
        if mode == "ok":
            EVENTS.record(
                _STORE_REF,
                TYPE_NORMAL,
                REASON_WAL_RECOVERED,
                f"WAL recovered from {prev}: {why}",
            )
        else:
            METRICS.inc("wal_degraded_total")
            EVENTS.record(
                _STORE_REF,
                TYPE_WARNING,
                REASON_WAL_DEGRADED,
                f"WAL {mode} (was {prev}): {why}",
            )

    def _fence_writes(self) -> None:
        """Read-only rung: reject create/update through the store's
        fault-injection seam (the one hook every write path already
        runs). Deletes stay allowed — they free the space that got us
        here, same as etcd's NOSPACE alarm semantics."""

        def _reject(_obj):
            METRICS.inc("wal_read_only_writes_rejected_total")
            return GroveError(
                ERR_CONFLICT,
                "store is read-only: WAL cannot make writes durable"
                " (disk full); retry after the disk recovers",
                "wal-read-only",
            )

        self._saved_injectors = {}
        for op in ("create", "update"):
            self._saved_injectors[op] = self.store.error_injectors.get(
                op
            )
            self.store.error_injectors[op] = _reject

    def _unfence_writes(self) -> None:
        for op, prev in self._saved_injectors.items():
            if prev is None:
                self.store.error_injectors.pop(op, None)
            else:
                self.store.error_injectors[op] = prev
        self._saved_injectors = {}

    def snapshot(self) -> str:
        """Snapshot now (scan serialized against concurrent writers when a
        store lock was provided) and truncate the covered WAL segments.
        Sharded: one snapshot per shard stream, each covering exactly its
        shard's objects at the shard's own rv watermark."""
        with self._store_lock if self._store_lock is not None else nullcontext():
            if self.num_shards > 1:
                for i, wal in enumerate(self.wals):
                    path = write_snapshot(
                        wal.directory, self.store, wal, shard=i
                    )
            else:
                path = write_snapshot(self.directory, self.store, self.wal)
            rv = self.store.resource_version
        self._flushed_at_last_snapshot = sum(
            w.flushed_bytes for w in self.wals
        )
        self.snapshots_taken += 1
        EVENTS.record(
            _STORE_REF,
            TYPE_NORMAL,
            REASON_SNAPSHOT_TAKEN,
            f"store snapshot at rv {rv}; WAL truncated",
        )
        return path

    def start_committer(self, interval_s: float = 0.05) -> None:
        """Background group-commit thread (real-cluster mode): acks flow
        to disk every ``interval_s`` without ever blocking a reconcile."""
        if self._committer is not None:
            return
        stop = threading.Event()

        def loop() -> None:
            while not stop.is_set():
                self.pump()
                stop.wait(interval_s)
            self.pump()  # final drain on clean shutdown

        self._committer_stop = stop
        self._committer = threading.Thread(
            target=loop, name="grove-wal-committer", daemon=True
        )
        self._committer.start()

    def stop_committer(self) -> None:
        if self._committer is None:
            return
        self._committer_stop.set()
        self._committer.join(timeout=5.0)
        self._committer = None
        self._committer_stop = None

    def close(self) -> None:
        self.stop_committer()
        for wal in self.wals:
            wal.close()

    # -- crash simulation -------------------------------------------------

    def simulate_crash(self, torn_tail_bytes: int = 0) -> int:
        """The store process dies: committer stops, the unflushed buffer
        is lost, and optionally a torn frame lands on disk (the write the
        crash interrupted). Returns records lost with the process."""
        # kill the WAL first: _dead turns any in-flight or final committer
        # pump into a no-op, so the thread cannot flush the buffer we are
        # about to lose (its shutdown path drains the buffer on purpose —
        # that drain models a CLEAN stop, not a crash). Sharded: every
        # stream dies with the one process; the torn frame lands on shard
        # 0's stream (always carries traffic — cluster-scoped keys pin
        # there), the others crash with clean tails.
        # worker-process backend: the whole control plane dies as one
        # failure domain — SIGKILL the worker processes FIRST so their
        # buffered (never-acked) records die with them, exactly like the
        # coordinator's own buffer below. kill_all repatriates the
        # streams (remote -> local) so the _dead marking lands on live
        # handles.
        drain = getattr(self.store, "_process_drain", None)
        if drain is not None and drain.active:
            drain.kill_all()
        lost = 0
        for i, wal in enumerate(self.wals):
            lost += wal.simulate_crash(
                torn_tail_bytes=torn_tail_bytes if i == 0 else 0
            )
        if self._committer is not None:
            self._committer_stop.set()
            self._committer.join(timeout=5.0)
            self._committer = None
            self._committer_stop = None
        return lost

    # -- stats ------------------------------------------------------------

    def stats(self) -> dict:
        # scalar durable_rv follows the store's rv merge rule (per-shard
        # watermarks sum); at S=1 both forms collapse to the legacy scalar
        return {
            "durable_rv": sum(w.durable_rv for w in self.wals),
            "flushed_records": sum(w.flushed_records for w in self.wals),
            "flushed_bytes": sum(w.flushed_bytes for w in self.wals),
            "pending_records": sum(w.pending() for w in self.wals),
            "segments_on_disk": sum(
                len(list_segments(w.directory)) for w in self.wals
            ),
            "snapshots_taken": self.snapshots_taken,
            "shards": self.num_shards,
            "degraded_mode": self.degraded_mode,
        }
