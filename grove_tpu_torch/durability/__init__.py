"""Durability layer under the in-memory store.

Counterpart of ``grove_tpu/durability``; its files are the JAX package's
byte for byte, so a log written by either package recovers in the other.
The reference operator is stateless because etcd holds every object it
owns; our ``runtime/store.py`` *is* the etcd stand-in, so this package is
its disk: an append-only, CRC-framed write-ahead log of every commit
(``wal.py``), periodic full snapshots with log truncation
(``snapshot.py``), and the crash-restart recovery path that rebuilds a
Store from disk tolerating a torn tail (``recovery.py``).

Everything is opt-in: a Store without an attached ``StoreDurability`` is
byte-identical to one without it (the WAL observes commits through the same
``subscribe_system`` watch fanout every other consumer uses — zero new
code on the write path).
"""

from grove_tpu_torch.durability.recovery import (
    RecoveryReport,
    StoreDurability,
    recover_store,
    verify_acked_prefix,
)
from grove_tpu_torch.durability.snapshot import load_latest_snapshot, write_snapshot
from grove_tpu_torch.durability.wal import WriteAheadLog

__all__ = [
    "RecoveryReport",
    "StoreDurability",
    "WriteAheadLog",
    "load_latest_snapshot",
    "recover_store",
    "verify_acked_prefix",
    "write_snapshot",
]
