"""The store's canonical dump.

Counterpart of ``store_dump`` in ``grove_tpu/sim/recovery.py``: the wire
documents of the whole committed population, the byte-comparable state the
sharded store's inert A/B (``sim/scale.inert_ab``) is judged on. The rest of
that module (the durability round trip and the cold restart) is not ported.
"""

from __future__ import annotations

from grove_tpu_torch.api.serialize import export_object


def store_dump(store, canonical_uids: bool = False, include_events: bool = True) -> dict:
    """``kind/namespace/name`` -> wire document of every committed object.
    ``canonical_uids`` renumbers uids by position (sorted key order), so
    two runs in one process, whose uid counter is global, compare equal
    when everything else is. ``include_events=False`` leaves out the
    fire-and-forget Event objects."""
    out = {}
    for kind in store.kinds():
        if kind == "Event" and not include_events:
            continue
        for obj in store.scan(kind):
            out[f"{kind}/{obj.metadata.namespace}/{obj.metadata.name}"] = export_object(obj)
    if canonical_uids:
        mapping = {}
        for key in sorted(out):
            uid = out[key].get("metadata", {}).get("uid")
            if uid and uid not in mapping:
                mapping[uid] = f"uid-canonical-{len(mapping)}"
        for doc in out.values():
            meta = doc.get("metadata", {})
            if meta.get("uid") in mapping:
                meta["uid"] = mapping[meta["uid"]]
            for ref in meta.get("ownerReferences", []) or []:
                if ref.get("uid") in mapping:
                    ref["uid"] = mapping[ref["uid"]]
    return out
