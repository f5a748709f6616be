"""Write-ahead log: append-only, CRC-framed record of every store commit.

Counterpart of ``grove_tpu/durability/wal.py``, the same format byte for
byte.

Record stream
-------------

Each group-commit batch becomes ONE framed entry (the batch is already
the atomicity unit — one fsync covers it — so the CRC frame and the JSON
encoder invocation are per batch, not per record):

    [u32 payload_len][u32 crc32(payload)][payload]

with a UTF-8 JSON payload that is an ARRAY of record docs::

    [{"seq": n, "op": "put"|"patch"|"delete", "rv": resourceVersion,
      "kind": ..., "ns": ..., "name": ..., "dt": deletionTimestamp|null,
      "obj": <wire doc>}                       # "put" only
      ... "gen": N, "status"/"spec"/"meta": <subtree doc>}, ...]  # "patch"

Docs are the ``api/serialize.py`` wire export (camelCase, the same codec
the HTTP apiserver speaks — no pickle on the control-plane write
path: a pickled log would tie recovery to one code version). The
envelope carries ``ns``/``dt`` explicitly because the wire export drops
empty values: a cluster-scoped object's ``namespace: ""`` and a deletion
at virtual t=0.0 must round-trip exactly.

**Patch records** are the cost story: the store's copy-on-write commits
STRUCTURALLY SHARE untouched subtrees with the previous committed object
(runtime/store.py ``commit_cow``), so an ``is``-identity check on the
watch event's old/new pair proves which subtrees changed — in O(1),
before any serialization. A pod status write then logs ~350 bytes of
status instead of ~1.6 KB of whole pod, which is what keeps WAL overhead
small. Replay applies patches onto the prior state
of the key (the base always exists: every object's first record is its
full create).

Ack contract (group commit)
---------------------------

``note_event`` only *buffers* a reference to the immutable committed
object — no serialization, no I/O — so the commit path (reconcile
bodies) stays non-blocking. A later ``flush()`` — the background
committer in real-cluster mode, the per-tick pump in sims — serializes
the batch, appends, and fsyncs once for the whole group. A commit is
**durable (acked)** only once ``flush()`` returned with its record on
disk: ``durable_rv`` names the highest resourceVersion the log
guarantees to survive a crash. Everything after it is the crash-lossable
tail, and recovery (``recovery.py``) rolls the store back to exactly the
durable prefix.

Torn tails
----------

A crash mid-write leaves a torn final frame (short header, short
payload, or CRC mismatch). Readers stop at the first bad frame and
truncate there — records past a torn frame are unordered garbage by
definition. Segments rotate at ``segment_max_bytes``; snapshots
(``snapshot.py``) truncate the fully-covered ones.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

from grove_tpu_torch.api.serialize import (
    export_object,
    export_object_shared,
    to_dict,
)
from grove_tpu_torch.observability.metrics import METRICS
from grove_tpu_torch.observability.profile import PROFILER

_HEADER = struct.Struct("<II")  # payload length, crc32(payload)

SEGMENT_PREFIX = "wal-"
SEGMENT_SUFFIX = ".seg"

# per-shard WAL layout (docs/control-plane.md): a sharded store's
# durability directory holds one subdirectory per keyspace shard, each a
# complete single-writer WAL+snapshot stream for that shard's slice.
# The UNSHARDED layout (segments directly in the directory) is untouched
# — S=1 stays byte-identical on disk.
SHARD_DIR_PREFIX = "shard-"


def shard_dir_name(index: int) -> str:
    return f"{SHARD_DIR_PREFIX}{index:03d}"


def list_shard_dirs(directory: str) -> List[Tuple[int, str]]:
    """(shard index, absolute path) of every per-shard WAL dir, ordered.
    Empty for an unsharded layout — the caller's sharded/unsharded probe."""
    out = []
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    for name in names:
        if not name.startswith(SHARD_DIR_PREFIX):
            continue
        path = os.path.join(directory, name)
        if not os.path.isdir(path):
            continue
        try:
            out.append((int(name[len(SHARD_DIR_PREFIX):]), path))
        except ValueError:
            continue
    out.sort()
    return out


def _segment_name(index: int) -> str:
    return f"{SEGMENT_PREFIX}{index:08d}{SEGMENT_SUFFIX}"


def segment_index(filename: str) -> Optional[int]:
    if not (
        filename.startswith(SEGMENT_PREFIX)
        and filename.endswith(SEGMENT_SUFFIX)
    ):
        return None
    try:
        return int(filename[len(SEGMENT_PREFIX) : -len(SEGMENT_SUFFIX)])
    except ValueError:
        return None


def list_segments(directory: str) -> List[Tuple[int, str]]:
    """(index, absolute path) of every segment file, index-ordered."""
    out = []
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    for name in names:
        idx = segment_index(name)
        if idx is not None:
            out.append((idx, os.path.join(directory, name)))
    out.sort()
    return out


# ---------------------------------------------------------------------------
# envelope codec (shared with snapshot.py)
# ---------------------------------------------------------------------------


def object_envelope(obj) -> dict:
    """Wire envelope of one committed object: the serialize.py export plus
    the identity fields the export would drop when empty."""
    meta = obj.metadata
    return {
        "rv": meta.resource_version,
        "kind": obj.kind,
        "ns": meta.namespace,
        "name": meta.name,
        "dt": meta.deletion_timestamp,
        "obj": export_object(obj),
    }


def decode_envelope(env: dict):
    """Envelope → typed object with exact identity restored."""
    from grove_tpu_torch.api.wire import decode_object

    obj = decode_object(env["obj"])
    # the wire export drops empty values; the envelope is authoritative
    # for the fields whose empty forms are semantically load-bearing
    obj.metadata.namespace = env["ns"]
    obj.metadata.name = env["name"]
    obj.metadata.deletion_timestamp = env.get("dt")
    return obj


@dataclass
class WalRecord:
    seq: int
    op: str  # "put" | "patch" | "delete"
    rv: int
    kind: str
    namespace: str
    name: str
    envelope: Optional[dict]  # full envelope for "put"; None otherwise
    patch: Optional[dict] = None  # raw payload doc for "patch"

    @property
    def key(self) -> Tuple[str, str, str]:
        return (self.kind, self.namespace, self.name)


def _decode_frame(payload: bytes) -> List[WalRecord]:
    """One CRC-framed payload → its batch of records (legacy single-doc
    payloads decode as a batch of one)."""
    doc = json.loads(payload.decode("utf-8"))
    docs = doc if isinstance(doc, list) else [doc]
    return [_decode_record_doc(d) for d in docs]


def _decode_record_doc(doc: dict) -> WalRecord:
    env = None
    if doc["op"] == "put":
        env = {
            "rv": doc["rv"],
            "kind": doc["kind"],
            "ns": doc["ns"],
            "name": doc["name"],
            "dt": doc.get("dt"),
            "obj": doc["obj"],
        }
    return WalRecord(
        seq=doc.get("seq", 0),
        op=doc["op"],
        rv=doc["rv"],
        kind=doc["kind"],
        namespace=doc["ns"],
        name=doc["name"],
        envelope=env,
        patch=doc if doc["op"] == "patch" else None,
    )


def apply_record(state: dict, rec: WalRecord) -> None:
    """Fold one replayed record into the key→envelope state map (the ONE
    application semantics recovery and the acked-prefix auditor share)."""
    if rec.op == "delete":
        state.pop(rec.key, None)
        return
    if rec.op == "put":
        state[rec.key] = rec.envelope
        return
    # patch: subtree replacement onto the key's prior state. The base
    # always exists (first record per key is its full create; snapshots
    # hold full envelopes) — a missing base means corruption upstream of
    # the CRC layer, surfaced by the acked-prefix audit rather than here.
    env = state.get(rec.key)
    if env is None:
        return
    patch = rec.patch
    doc = env["obj"]
    meta = doc.setdefault("metadata", {})
    if "meta" in patch:
        doc["metadata"] = meta = patch["meta"]
    meta["resourceVersion"] = rec.rv
    if patch.get("gen"):
        meta["generation"] = patch["gen"]
    for subtree in ("status", "spec"):
        if subtree in patch:
            if patch[subtree]:
                doc[subtree] = patch[subtree]
            else:
                doc.pop(subtree, None)
    env["rv"] = rec.rv
    env["dt"] = patch.get("dt")


def read_segment(path: str) -> Tuple[List[WalRecord], Optional[int]]:
    """Decode one segment. Returns (records, torn_offset): torn_offset is
    the byte offset of the first bad frame (None when the file is clean) —
    the truncation point the torn-tail policy cuts at."""
    records: List[WalRecord] = []
    with open(path, "rb") as fh:
        data = fh.read()
    offset = 0
    total = len(data)
    while offset < total:
        header = data[offset : offset + _HEADER.size]
        if len(header) < _HEADER.size:
            return records, offset  # torn header
        length, crc = _HEADER.unpack(header)
        start = offset + _HEADER.size
        payload = data[start : start + length]
        if len(payload) < length or zlib.crc32(payload) != crc:
            return records, offset  # torn/corrupt payload
        try:
            records.extend(_decode_frame(payload))
        except (ValueError, KeyError):
            return records, offset  # undecodable payload: treat as torn
        offset = start + length
    return records, None


class WriteAheadLog:
    """Segmented append-only log with group-commit fsync batching.

    One writer per directory: the store process owns its WAL the way an
    etcd member owns its data dir. ``note_event`` may be called from any
    commit site (it only buffers); ``flush``/``snapshot-truncate`` are
    serialized by ``_io_lock``.
    """

    def __init__(
        self, directory: str, segment_max_bytes: int = 4 * 2**20
    ) -> None:
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.segment_max_bytes = segment_max_bytes
        # owning keyspace shard of this stream (StoreDurability stamps it
        # on sharded stores) — wall-attribution rows then split per shard
        self.shard = 0
        # _lock guards the buffer/seq; _io_lock serializes flush and
        # truncation (lock order: _io_lock -> _lock, never inverted)
        self._lock = threading.Lock()
        self._io_lock = threading.Lock()
        self._buffer: List[tuple] = []  # (seq, op, committed obj)
        self._seq = 0
        self._dead = False  # simulate_crash: the process is gone
        # worker-process backend (runtime/procworkers.py): a stream whose
        # shard is owned by ANOTHER process is marked remote — that
        # process appends to the same directory (one writer per stream
        # still holds; this handle just goes inert, keeping watermarks the
        # owner ships back). Flipped off on repatriation after a worker
        # crash, when the coordinator takes the stream back.
        self.remote = False
        # gray-failure injection (docs/robustness.md "Gray failures"):
        # chaos faults set these; the degradation ladder in
        # StoreDurability reads the symptoms and steps rungs. Both
        # default off — the healthy flush path is byte-identical.
        # fault_slow_fsync models N seconds of extra fsync latency (the
        # fail-slow disk): flush still succeeds, the modeled lag lands
        # in last_fsync_lag for the ladder's SLO compare. No real sleep
        # — determinism and test wall-time both forbid it.
        self.fault_slow_fsync = 0.0
        # fault_disk_full makes flush raise ENOSPC with the batch still
        # BUFFERED — nothing acked, nothing lost; the ladder's read-only
        # rung decides what the store does about it.
        self.fault_disk_full = False
        self.last_fsync_lag = 0.0
        self.durable_seq = 0
        self.durable_rv = 0
        self.flushed_bytes = 0
        self.flushed_records = 0
        # resume AFTER any existing segments (a recovered store re-attaches
        # to the same directory; old segments stay readable behind us)
        existing = list_segments(directory)
        self._segment_index = (existing[-1][0] + 1) if existing else 0
        self._segment_bytes = 0
        self._fh = None  # opened lazily on first flush

    # -- write path ------------------------------------------------------

    def note_event(self, ev) -> None:
        """Buffer one committed watch event (Added/Modified/Deleted). The
        payload objects (new AND old committed state) are immutable, so
        serialization — and the old/new subtree-sharing comparison that
        turns a commit into a small patch record — is safely deferred to
        flush()."""
        if self._dead or self.remote:
            return
        if ev.kind == "Event":
            # fire-and-forget Event objects are best-effort by contract
            # (real etcd TTLs them away); they are outside the durability
            # guarantee and would be ~12% of record volume
            return
        op = "delete" if ev.type == "Deleted" else "put"
        with self._lock:
            self._seq += 1
            self._buffer.append((self._seq, op, ev.obj, ev.old))

    def pending(self) -> int:
        with self._lock:
            return len(self._buffer)

    @staticmethod
    def _meta_unchanged(meta, old_meta) -> bool:
        """True when metadata differs from the previous commit only in the
        version bookkeeping commit_cow restamps. Identity checks carry the
        proof: the cow path shallow-copies metadata, so the mutable
        members are the SAME objects unless a caller replaced them."""
        return (
            meta.labels is old_meta.labels
            and meta.annotations is old_meta.annotations
            and meta.finalizers is old_meta.finalizers
            and meta.owner_references is old_meta.owner_references
            and meta.name == old_meta.name
            and meta.namespace == old_meta.namespace
            and meta.uid == old_meta.uid
            and meta.deletion_timestamp == old_meta.deletion_timestamp
        )

    def _encode(self, seq: int, op: str, obj, old, memo: dict) -> dict:
        """One buffered event → its record doc (framing happens per batch)."""
        meta = obj.metadata
        doc = {
            "seq": seq,
            "op": op,
            "rv": meta.resource_version,
            "kind": obj.kind,
            "ns": meta.namespace,
            "name": meta.name,
        }
        if op == "put":
            # copy-on-write commits share untouched subtrees with the old
            # committed object BY IDENTITY — log only what changed
            spec_shared = old is not None and getattr(
                obj, "spec", None
            ) is getattr(old, "spec", None)
            status_shared = old is not None and getattr(
                obj, "status", None
            ) is getattr(old, "status", None)
            if old is not None and (spec_shared or status_shared):
                doc["op"] = "patch"
                doc["gen"] = meta.generation
                doc["dt"] = meta.deletion_timestamp
                if not self._meta_unchanged(meta, old.metadata):
                    doc["meta"] = to_dict(meta)
                if not status_shared:
                    status = getattr(obj, "status", None)
                    doc["status"] = to_dict(status) if status is not None else {}
                if not spec_shared:
                    doc["spec"] = to_dict(obj.spec)
            else:
                # batch-scoped memo: sibling creates from one desired-state
                # template share subtree identity — serialize each shared
                # spec once per flush, not once per pod
                doc["dt"] = meta.deletion_timestamp
                doc["obj"] = export_object_shared(obj, memo)
        return doc

    def _ensure_segment(self):
        if self._fh is None:
            path = os.path.join(
                self.directory, _segment_name(self._segment_index)
            )
            self._fh = open(path, "ab")
            self._segment_bytes = self._fh.tell()
            METRICS.inc("wal_segments_total")
        return self._fh

    def _rotate(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        self._segment_index += 1
        self._segment_bytes = 0

    def flush(self) -> int:
        """Group commit: serialize the buffered batch, append, fsync ONCE,
        then advance the durable watermark. Returns records flushed."""
        # wall attribution (observability/profile.py): the flush IS the
        # durability layer's share of control-plane wall — one row per
        # shard stream. Disabled profiling costs this one boolean check.
        prof = (
            PROFILER.phase("wal-flush", controller="wal", shard=self.shard)
            if PROFILER.enabled
            else None
        )
        try:
            with self._io_lock:
                return self._flush_locked()
        finally:
            if prof is not None:
                prof.end()

    @staticmethod
    def _coalesce(batch: List[tuple]) -> List[tuple]:
        """Per-key last-write-wins within one group-commit batch.

        A batch is durable atomically (one fsync covers it all), so only
        each key's FINAL state matters to recovery — a pod created and
        status-patched three times in one tick needs one record, not
        four. Kept per key: the LAST object (final state) and the FIRST
        old (the pre-batch committed state the patch-vs-put identity
        check must compare against — cow subtree identity is transitive
        across the intermediate commits). delete→recreate degrades to a
        full put; anything→delete ends as the delete."""
        coalesced: dict = {}
        order: List[tuple] = []
        for seq, op, obj, old in batch:
            meta = obj.metadata
            key = (obj.kind, meta.namespace, meta.name)
            prev = coalesced.get(key)
            if prev is None:
                coalesced[key] = [seq, op, obj, old]
                order.append(key)
            elif op == "delete":
                prev[0], prev[1], prev[2], prev[3] = seq, op, obj, None
            elif prev[1] == "delete":
                # deleted then re-created within the batch: the base is
                # gone — full put of the new object
                prev[0], prev[1], prev[2], prev[3] = seq, op, obj, None
            else:
                prev[0], prev[2] = seq, obj  # keep the FIRST old
        if len(order) == len(batch):
            return batch
        return [tuple(coalesced[key]) for key in order]

    def _flush_locked(self) -> int:
        if self._dead or self.remote:
            return 0
        if self.fault_disk_full:
            # the batch stays buffered: nothing was acked, so nothing is
            # lost — the ladder turns this into read-only, not a crash
            raise OSError(28, "No space left on device (injected)")
        with self._lock:
            batch, self._buffer = self._buffer, []
        if not batch:
            return 0
        t_flush = time.perf_counter()
        last_seq = batch[-1][0]
        batch = self._coalesce(batch)
        memo: dict = {}  # one per batch: the buffer pins the objects alive
        docs = [
            self._encode(seq, op, obj, old, memo)
            for seq, op, obj, old in batch
        ]
        payload = json.dumps(docs, separators=(",", ":")).encode("utf-8")
        data = _HEADER.pack(len(payload), zlib.crc32(payload)) + payload
        t0 = time.perf_counter()
        fh = self._ensure_segment()
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
        fsync_lag = time.perf_counter() - t0
        if self.fault_slow_fsync > 0.0:
            # the fail-slow disk: model the extra latency (observed, not
            # slept) so the ladder's SLO compare sees the symptom
            fsync_lag += self.fault_slow_fsync
        self.last_fsync_lag = fsync_lag
        METRICS.observe("wal_fsync_seconds", fsync_lag)
        METRICS.inc("wal_flushed_bytes_total", len(data))
        METRICS.inc("wal_records_total", len(batch))
        self._segment_bytes += len(data)
        self.flushed_bytes += len(data)
        self.flushed_records += len(batch)
        self.durable_seq = last_seq
        self.durable_rv = max(
            self.durable_rv,
            max(obj.metadata.resource_version for _s, _o, obj, _old in batch),
        )
        if self._segment_bytes >= self.segment_max_bytes:
            self._rotate()
        # whole group-commit cost (coalesce + encode + write + fsync):
        # what "WAL enabled" adds to the control plane's wall clock
        METRICS.observe(
            "wal_flush_seconds", time.perf_counter() - t_flush
        )
        return len(batch)

    def truncate_segments_through(self, last_index: int) -> int:
        """Delete every closed segment with index <= last_index (snapshot
        log truncation). The caller must hold no records beyond the
        snapshot in those segments — snapshot.py flushes first and cuts at
        the current segment boundary."""
        removed = 0
        for idx, path in list_segments(self.directory):
            if idx <= last_index:
                try:
                    os.unlink(path)
                    removed += 1
                except OSError:
                    pass
        return removed

    def cut_segment(self) -> int:
        """Close the current segment and start a fresh one; returns the
        index of the last CLOSED segment (snapshot truncation boundary)."""
        with self._io_lock:
            self._flush_locked()
            closed = self._segment_index
            self._rotate()
            return closed

    # -- crash simulation (chaos harness / tests) ------------------------

    def simulate_crash(self, torn_tail_bytes: int = 0) -> int:
        """Model the store process dying NOW: the unflushed buffer is lost
        with the process, and (optionally) the final disk write is torn —
        ``torn_tail_bytes`` of a half-written frame land after the last
        durable record. Returns the number of records lost."""
        with self._io_lock:
            with self._lock:
                lost = len(self._buffer)
                self._buffer = []
                self._dead = True
            if torn_tail_bytes > 0:
                fh = self._ensure_segment()
                # a plausible torn frame: a valid-looking header promising
                # more payload than ever hit the disk
                frame = _HEADER.pack(torn_tail_bytes + 64, 0xDEADBEEF)
                frame += b"\x00" * torn_tail_bytes
                fh.write(frame)
                fh.flush()
            if self._fh is not None:
                self._fh.close()
                self._fh = None
        return lost

    def close(self) -> None:
        with self._io_lock:
            self._flush_locked()
            if self._fh is not None:
                self._fh.close()
                self._fh = None
            self._dead = True


def replay(
    directory: str, min_segment: int = -1
) -> Tuple[List[WalRecord], bool, int]:
    """Read the durable record stream: every record in segments with
    index > min_segment (the snapshot's coverage boundary — deletes carry
    no fresh resourceVersion, so the cut is positional, not rv-based), in
    log order, truncating at the first bad frame (torn-tail policy: a torn
    frame ends the replayable prefix — later segments, if any, postdate
    the tear and are discarded too). Returns (records, torn, truncated_files).
    Truncation REWRITES the torn segment to its good prefix and removes
    later segments, so a recovered store that re-attaches appends after a
    clean tail."""
    out: List[WalRecord] = []
    torn = False
    truncated = 0
    segments = list_segments(directory)
    for pos, (idx, path) in enumerate(segments):
        if idx <= min_segment:
            continue
        records, torn_offset = read_segment(path)
        out.extend(records)
        if torn_offset is not None:
            torn = True
            with open(path, "rb+") as fh:
                fh.truncate(torn_offset)
            truncated += 1
            for _later_idx, later_path in segments[pos + 1 :]:
                try:
                    os.unlink(later_path)
                    truncated += 1
                except OSError:
                    pass
            break
    return out, torn, truncated


def _iter_durable_state(
    directory: str,
) -> Iterator[Tuple[Tuple[str, str, str], Optional[dict]]]:
    """(key, envelope|None) pairs of the durable prefix: snapshot base plus
    replayed records, last-write-wins per key (None = deleted). Shared by
    recovery and the acked-prefix verifier."""
    from grove_tpu_torch.durability.snapshot import load_latest_snapshot

    snap = load_latest_snapshot(directory)
    state: dict = {}
    min_segment = -1
    if snap is not None:
        min_segment = snap.get("wal_seg", -1)
        for env in snap["objects"]:
            state[(env["kind"], env["ns"], env["name"])] = env
    records, _torn, _truncated = replay(directory, min_segment=min_segment)
    present = {k for k, v in state.items() if v is not None}
    live: dict = {k: v for k, v in state.items()}
    for rec in records:
        apply_record(live, rec)
    # normalize: deleted keys read as None so callers can distinguish
    # "durably deleted" from "never existed"
    out = {k: None for k in present if k not in live}
    out.update(live)
    return iter(sorted(out.items()))
