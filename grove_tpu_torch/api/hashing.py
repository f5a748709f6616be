"""Deterministic object hashing for rolling-update triggers.

Counterpart of ``grove_tpu/api/hashing.py``.

Equivalent of the reference's ComputeHash over all pod templates
(reference operator/internal/controller/podcliqueset/reconcilespec.go:110-123
and internal/utils/kubernetes object hashing): a generation hash of the PCS
template that, when changed, starts a rolling update; and a per-clique
pod-template hash stamped as the `grove.io/pod-template-hash` label.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import threading
from typing import Any


def _normalize(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {
            f.name: _normalize(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
        }
    if isinstance(obj, dict):
        return {str(k): _normalize(v) for k, v in sorted(obj.items())}
    if isinstance(obj, (list, tuple)):
        return [_normalize(v) for v in obj]
    return obj


def compute_hash(obj: Any) -> str:
    """Stable short hash of any dataclass/dict tree."""
    payload = json.dumps(_normalize(obj), sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def _clique_template_payload(clique_template, priority_class_name: str = ""):
    """The hashed view of one clique: mirrors the reference, which hashes a
    PodTemplateSpec carrying the clique's labels/annotations with the PCS
    template's priorityClassName overlaid (component/utils/podclique.go)."""
    return {
        "name": clique_template.name,
        "labels": dict(clique_template.labels),
        "annotations": dict(clique_template.annotations),
        "roleName": clique_template.spec.role_name,
        "priorityClassName": priority_class_name,
        "podSpec": _normalize(clique_template.spec.pod_spec),
    }


# Hash memoization. A CR's spec is immutable per (uid, generation) — the
# store bumps generation on every spec write — so template hashes can be
# cached on that key instead of re-normalizing the whole template tree on
# every reconcile (profiling: _normalize was a top-3 control-plane cost).
# Unsaved objects (no uid / generation 0, e.g. webhook-time) are never
# cached.
#
# Eviction is FIFO of the oldest QUARTER, not wholesale clear: each live CR
# holds ~5 keys (generation hash + one per clique) and superseded
# generations age out naturally, so insertion order approximates liveness.
# A wholesale clear at 8,192 thrashes the cache at scale — a
# 2,000-set population holds ~10k live keys, so every clear forced every
# reconcile to re-normalize whole template trees (profiled: 12M _normalize
# calls, ~30% of the 2,000-set converge; the "+40% per-reconcile at 2x
# objects" growth was mostly this). Entries are ~100 bytes (tuple key +
# 16-char hash), so the full cap holds roughly 26 MB and covers ~50k live
# CRs; each eviction drops a ~6.5 MB quarter.
_HASH_CACHE: dict = {}
_HASH_CACHE_MAX = 262_144
_EVICT_LOCK = threading.Lock()


def _cached(key, compute):
    if key is None:
        return compute()
    h = _HASH_CACHE.get(key)
    if h is None:
        if len(_HASH_CACHE) >= _HASH_CACHE_MAX:
            # dicts iterate in insertion order: drop the oldest quarter.
            # Concurrent reconcile threads (Engine.drain_concurrent) may
            # race here — the lock keeps the snapshot-and-delete atomic,
            # and pop(None) tolerates a key another thread already evicted.
            with _EVICT_LOCK:
                if len(_HASH_CACHE) >= _HASH_CACHE_MAX:
                    for stale in list(
                        itertools.islice(
                            iter(_HASH_CACHE), _HASH_CACHE_MAX // 4
                        )
                    ):
                        _HASH_CACHE.pop(stale, None)
        h = compute()
        # Insert under the same lock as eviction: the eviction snapshot
        # iterates the dict, and an unlocked concurrent insert is only safe
        # by the grace of CPython's GIL (free-threaded builds would raise
        # "dictionary changed size during iteration"). Uncontended in the
        # warm path, which never reaches here.
        with _EVICT_LOCK:
            _HASH_CACHE[key] = h
    return h


def _gen_key(owner, scope: str):
    meta = owner.metadata
    if meta.uid and meta.generation:
        return (meta.uid, meta.generation, scope)
    return None


def compute_pcs_generation_hash(pcs) -> str:
    """Hash of every clique's pod template (not replica counts — scaling is
    not an update); changing it starts the rolling update flow
    (reconcilespec.go:72-123)."""

    def compute():
        pcn = pcs.spec.template.priority_class_name
        parts = [
            _clique_template_payload(c, pcn) for c in pcs.spec.template.cliques
        ]
        return compute_hash({"cliques": parts})

    return _cached(_gen_key(pcs, "pcs-generation"), compute)


def compute_pod_template_hash(clique_template, priority_class_name: str = "") -> str:
    return compute_hash(_clique_template_payload(clique_template, priority_class_name))


def pod_template_hash_for(pcs, clique_name: str):
    """Cached per-(uid, generation, clique) pod-template hash; None when the
    PCS template has no such clique."""

    def compute():
        tmpl = pcs.spec.template.clique_template(clique_name)
        if tmpl is None:
            return None
        return compute_pod_template_hash(
            tmpl, pcs.spec.template.priority_class_name
        )

    return _cached(_gen_key(pcs, f"clique:{clique_name}"), compute)
