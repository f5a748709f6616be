"""Create/delete expectations store.

Counterpart of ``grove_tpu/runtime/expectations.py``.

Re-host of reference operator/internal/expect/expectations.go:33-136.
Compensates for stale informer caches: after issuing creates/deletes, the
controller records the UIDs it expects to (dis)appear; the replica-diff
computation then folds pending expectations in instead of trusting the cache.
Self-heals by syncing against observed state.
"""

from __future__ import annotations

from typing import Dict, Iterable, Set, Tuple


class ExpectationsStore:
    def __init__(self, name: str = "") -> None:
        self.name = name
        self._creates: Dict[str, Set[str]] = {}
        self._deletes: Dict[str, Set[str]] = {}

    # -- record ----------------------------------------------------------

    def expect_creations(self, key: str, uids: Iterable[str]) -> None:
        self._creates.setdefault(key, set()).update(uids)

    def expect_deletions(self, key: str, uids: Iterable[str]) -> None:
        self._deletes.setdefault(key, set()).update(uids)

    # -- observe ---------------------------------------------------------

    def observed_creation(self, key: str, uid: str) -> None:
        self._creates.get(key, set()).discard(uid)

    def observed_deletion(self, key: str, uid: str) -> None:
        self._deletes.get(key, set()).discard(uid)

    # -- query (folded into replica diff) --------------------------------

    def pending(self, key: str, observed_uids: Iterable[str]) -> Tuple[Set[str], Set[str]]:
        """Returns (pending_creates, pending_deletes) after self-healing
        against the observed UID set (SyncExpectations,
        expectations.go:112-136): an expected create already visible is done;
        an expected delete no longer visible is done."""
        observed = set(observed_uids)
        pending_creates = self._creates.get(key, set()) - observed
        self._creates[key] = set(pending_creates)
        pending_deletes = self._deletes.get(key, set()) & observed
        self._deletes[key] = set(pending_deletes)
        return pending_creates, pending_deletes

    def delete_expectations(self, key: str) -> None:
        self._creates.pop(key, None)
        self._deletes.pop(key, None)

    # -- shipping across the process boundary (runtime/procworkers.py) -----

    def export_key(self, key: str) -> Tuple[list, list]:
        """One key's pending UID sets in sorted wire form: a worker process
        ships the entry back after each reconcile so the coordinator
        carries the raise or lower into the next drain."""
        return (
            sorted(self._creates.get(key) or ()),
            sorted(self._deletes.get(key) or ()),
        )

    def import_key(self, key: str, creates: Iterable[str], deletes: Iterable[str]) -> None:
        """Adopt a peer process's entry for ``key`` verbatim (empty both
        ways is no entry, as ``pending`` reads it)."""
        creates = set(creates)
        deletes = set(deletes)
        if creates or deletes:
            self._creates[key] = creates
            self._deletes[key] = deletes
        else:
            self._creates.pop(key, None)
            self._deletes.pop(key, None)
