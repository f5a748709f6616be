"""kubectl-tree-style resource rendering, store-agnostic.

Counterpart of ``grove_tpu/api/inspect.py``.

Works over any store exposing ``list(kind, namespace, label_selector)`` —
the in-memory sim store and the live-apiserver HTTP client alike — so the
same tree the quickstart shows (pcs > pclq/pcsg > pg > pod; reference
README.md:26) renders for both tiers.
"""

from __future__ import annotations

import io

from grove_tpu_torch.api import names as namegen


def render_describe(store, kind: str, namespace: str, name: str) -> str:
    """kubectl-describe-style single-object view: metadata, spec highlights,
    status counters + conditions + typed lastErrors, and the Events whose
    message names the object (events are materialized as store objects —
    controller/common.py record_event)."""
    obj = store.get(kind, namespace, name)
    if obj is None:
        return ""
    out = io.StringIO()
    out.write(f"Name:       {obj.metadata.name}\n")
    out.write(f"Namespace:  {obj.metadata.namespace}\n")
    out.write(f"Kind:       {obj.kind}\n")
    if obj.metadata.labels:
        labels = ", ".join(
            f"{k}={v}" for k, v in sorted(obj.metadata.labels.items())
        )
        out.write(f"Labels:     {labels}\n")
    out.write(f"Generation: {obj.metadata.generation}\n")
    spec = getattr(obj, "spec", None)
    if spec is not None and hasattr(spec, "replicas"):
        out.write(f"Replicas:   {spec.replicas}\n")
    status = getattr(obj, "status", None)
    if status is not None:
        for field in (
            "phase",
            "replicas",
            "ready_replicas",
            "scheduled_replicas",
            "available_replicas",
            "updated_replicas",
            "placement_score",
        ):
            val = getattr(status, field, None)
            if val is not None:
                label = field.replace("_", " ").title().replace(" ", "")
                out.write(f"Status.{label}: {val}\n")
        conds = getattr(status, "conditions", None) or []
        if conds:
            out.write("Conditions:\n")
            for c in conds:
                out.write(
                    f"  {c.type}={c.status}"
                    f" reason={getattr(c, 'reason', '') or '-'}"
                    f" message={getattr(c, 'message', '') or '-'}\n"
                )
        last_errors = getattr(status, "last_errors", None) or []
        if last_errors:
            out.write("LastErrors:\n")
            for err in last_errors:
                out.write(
                    f"  {getattr(err, 'code', '?')}"
                    f" op={getattr(err, 'operation', '-')}"
                    f" {getattr(err, 'description', '')}\n"
                )
    # events live in the default namespace regardless of the object's (the
    # ring buffer is cluster-scoped); match the message on a word boundary so
    # `simple1` never inherits `simple10`'s events (children like
    # `simple1-0-...` still match their own names when described directly)
    import re

    word = re.compile(rf"\b{re.escape(name)}\b")
    events = [
        e
        for e in store.list("Event", None)
        if word.search(str(e.spec.get("message", "")))
    ]
    # store listing is lexicographic by name (evt-10 < evt-2): order
    # chronologically before truncating to the newest 20 (the numeric name
    # suffix breaks ties within one virtual-clock instant)
    def _event_order(e):
        suffix = e.metadata.name.rsplit("-", 1)[-1]
        return (
            e.spec.get("timestamp", 0),
            int(suffix) if suffix.isdigit() else 0,
        )

    events.sort(key=_event_order)
    if events:
        out.write("Events:\n")
        for e in events[-20:]:
            out.write(
                f"  t={e.spec.get('timestamp', 0):.0f}s"
                f" {e.spec.get('involvedKind', '?')}"
                f" {e.spec.get('reason', '?')}: {e.spec.get('message', '')}\n"
            )
    return out.getvalue()


def render_tree(store, namespace: str = "default") -> str:
    out = io.StringIO()
    for pcs in store.list("PodCliqueSet", namespace):
        out.write(f"pcs/{pcs.metadata.name}\n")
        sel = namegen.default_labels(pcs.metadata.name)
        for pcsg in store.list("PodCliqueScalingGroup", namespace, sel):
            st = pcsg.status
            out.write(
                f"  pcsg/{pcsg.metadata.name} replicas={pcsg.spec.replicas}"
                f" scheduled={st.scheduled_replicas}"
                f" available={st.available_replicas}\n"
            )
        for pclq in store.list("PodClique", namespace, sel):
            st = pclq.status
            out.write(
                f"  pclq/{pclq.metadata.name} replicas={st.replicas}"
                f" ready={st.ready_replicas} scheduled={st.scheduled_replicas}\n"
            )
        for pg in store.list("PodGang", namespace, sel):
            groups = ", ".join(
                f"{g.name}(min={g.min_replicas},pods={len(g.pod_references)})"
                for g in pg.spec.pod_groups
            )
            out.write(f"  pg/{pg.metadata.name} [{groups}]\n")
        for pod in store.list("Pod", namespace, sel):
            gates = "gated" if pod.spec.scheduling_gates else "ungated"
            node = pod.status.node_name or "-"
            out.write(
                f"    pod/{pod.metadata.name} {pod.status.phase} {gates}"
                f" node={node}\n"
            )
    return out.getvalue()
