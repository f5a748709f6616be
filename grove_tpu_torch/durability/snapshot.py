"""Periodic full-store snapshots + WAL truncation.

Counterpart of ``grove_tpu/durability/snapshot.py``.

A snapshot is the whole committed object population at one
resourceVersion, wire-serialized (the same envelope the WAL frames
carry) and CRC-guarded:

    [u32 crc32(body)][body]        body = JSON {"rv": N, "objects": [env...]}

Written atomically (temp file + rename) so a crash mid-snapshot leaves
the previous snapshot intact; a CRC mismatch at load time falls back to
the next-older snapshot (and ultimately to an empty base — the WAL still
replays from rv 0 in that case). After a successful snapshot every WAL
segment it covers is deleted and older snapshots are pruned: the log
stays bounded by write volume between snapshots, not by uptime.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import List, Optional, Tuple

from grove_tpu_torch.durability.wal import WriteAheadLog, object_envelope
from grove_tpu_torch.observability.metrics import METRICS

_CRC = struct.Struct("<I")

SNAPSHOT_PREFIX = "snapshot-"
SNAPSHOT_SUFFIX = ".snap"


def _snapshot_name(rv: int) -> str:
    return f"{SNAPSHOT_PREFIX}{rv:016d}{SNAPSHOT_SUFFIX}"


def list_snapshots(directory: str) -> List[Tuple[int, str]]:
    """(rv, absolute path) of every snapshot file, rv-ordered."""
    out = []
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    for name in names:
        if not (
            name.startswith(SNAPSHOT_PREFIX)
            and name.endswith(SNAPSHOT_SUFFIX)
        ):
            continue
        try:
            rv = int(name[len(SNAPSHOT_PREFIX) : -len(SNAPSHOT_SUFFIX)])
        except ValueError:
            continue
        out.append((rv, os.path.join(directory, name)))
    out.sort()
    return out


def write_snapshot(
    directory: str,
    store,
    wal: Optional[WriteAheadLog] = None,
    shard: Optional[int] = None,
) -> str:
    """Snapshot the store's committed state and truncate the WAL behind it.

    Ordering: flush + cut the WAL segment FIRST, so every record covered
    by the snapshot sits in a closed segment; then write the snapshot
    atomically; only then delete the covered segments and older
    snapshots. A crash between any two steps leaves a recoverable
    directory (at worst both the snapshot and the log cover the same
    records — replay is idempotent last-write-wins).

    With ``shard=k`` (sharded stores, docs/control-plane.md) the snapshot
    covers ONE keyspace shard — its objects via the store's per-shard
    scan, its rv watermark from the shard's own sequence — and lands in
    that shard's WAL directory: each shard's stream stays a
    self-contained single-writer WAL+snapshot pair, recovered and merged
    by ``recover_store``."""
    closed_through = wal.cut_segment() if wal is not None else -1
    objects = []
    kinds = store.kinds() if shard is None else store.shard_kinds(shard)
    for kind in kinds:
        if kind == "Event":
            # fire-and-forget Events are outside the durability contract
            # (the WAL skips them; real etcd TTLs them away) — a snapshot
            # that carried them would resurrect stale Events on recovery
            continue
        scan = (
            store.scan(kind) if shard is None else store.shard_scan(shard, kind)
        )
        for obj in scan:
            objects.append(object_envelope(obj))
    rv = (
        store.resource_version
        if shard is None
        else store.shard_resource_version(shard)
    )
    # "wal_seg": the last WAL segment this snapshot covers — replay resumes
    # at the NEXT segment. Positional, not rv-based: delete records carry
    # the deleted object's (old) resourceVersion, so an rv cut would drop
    # them and resurrect deleted objects.
    body = json.dumps(
        {"rv": rv, "wal_seg": closed_through, "objects": objects},
        separators=(",", ":"),
    ).encode("utf-8")
    path = os.path.join(directory, _snapshot_name(rv))
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(_CRC.pack(zlib.crc32(body)))
        fh.write(body)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    if wal is not None:
        wal.truncate_segments_through(closed_through)
    for old_rv, old_path in list_snapshots(directory):
        if old_rv < rv:
            try:
                os.unlink(old_path)
            except OSError:
                pass
    METRICS.inc("wal_snapshots_total")
    return path


def load_snapshot_file(path: str) -> Optional[dict]:
    """One snapshot file → {"rv", "objects"} or None when CRC-corrupt."""
    try:
        with open(path, "rb") as fh:
            data = fh.read()
    except OSError:
        return None
    if len(data) < _CRC.size:
        return None
    (crc,) = _CRC.unpack(data[: _CRC.size])
    body = data[_CRC.size :]
    if zlib.crc32(body) != crc:
        return None
    try:
        doc = json.loads(body.decode("utf-8"))
    except ValueError:
        return None
    if not isinstance(doc, dict) or "rv" not in doc:
        return None
    return doc


def load_latest_snapshot(directory: str) -> Optional[dict]:
    """Newest CRC-valid snapshot (corrupt ones are skipped, newest first)."""
    for _rv, path in reversed(list_snapshots(directory)):
        doc = load_snapshot_file(path)
        if doc is not None:
            return doc
    return None
