"""Admission explain engine: "why is my gang Pending, and what would
unblock it?"

Counterpart of ``grove_tpu/observability/explain.py``. For a pending
PodGang it replays a constraint-elimination funnel over one snapshot of the
store (the data layer is ``solver/introspect.py``), each stage a read-only
recount of the input the next round will consume:

    cluster      which cluster owns the gang (one cluster: no federation)
    node-health  the schedulable mask (cordon / NotReady / Lost)
    capacity     per-resource free capacity against the gang's floor
    topology     the largest required-level domain's cover of the floor
    quota        ceiling holds, and the DRF rank with who is ahead
    disruption   monitor holds and the storm breaker
    partition    the frontier partition (or the residual pass)
    solve        a solo trial and a trial of the whole order

and returns a verdict: ``fits_now``, the failing stages (``blocked_on``)
with surviving node counts, and the binding constraint. The solve stage
runs the next round's encode, pad, order and kernels (the fill kernel in
every trial solve, the DRF kernels in the order when Queue CRs exist), so
``fits_now`` predicts the next solve.

The engine is read-only: it commits, binds and evicts nothing, and
``Store.resource_version_vector()`` and
``DeltaSolveState.state_fingerprint()`` are the same before and after any
explain, capacity or what-if burst. ``whatif`` evaluates the target's
verdict again over an overlay (drain, remove or add nodes, rewrite a
queue's deserved share or ceiling), gangs drained from a node re-pending
whole.

The disruption stage reads the scheduler's node-health monitor (a held gang
is ``held``, never ``fits_now``) and its disruption broker (an open storm
breaker while armed); the ``cluster`` stage's ``cluster_context`` waits for
the federation tier.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from grove_tpu_torch.api import names as namegen
from grove_tpu_torch.api.meta import ObjectMeta, deep_copy, get_condition
from grove_tpu_torch.api.types import COND_PODGANG_SCHEDULED, Queue, QueueSpec
from grove_tpu_torch.observability.events import (
    DETAIL_DISRUPTION_HOLD,
    DETAIL_INSUFFICIENT_CAPACITY,
    DETAIL_NO_NODES,
    DETAIL_QUEUE_POSITION,
    DETAIL_QUOTA_CEILING,
    DETAIL_TOPOLOGY_FRAGMENTATION,
    DETAIL_UNSATISFIABLE,
)
from grove_tpu_torch.observability.journey import JOURNEYS
from grove_tpu_torch.observability.metrics import METRICS
from grove_tpu_torch.quota.oracle import dominant_share_of
from grove_tpu_torch.sim.cluster import Node
from grove_tpu_torch.solver import introspect

# the funnel's stages, in elimination order
FUNNEL_STAGES = (
    "cluster",
    "node-health",
    "capacity",
    "topology",
    "quota",
    "disruption",
    "partition",
    "solve",
)

# detail slug -> the stage that owns it (the binding constraint)
_SLUG_STAGE = {
    DETAIL_NO_NODES: "node-health",
    DETAIL_INSUFFICIENT_CAPACITY: "capacity",
    DETAIL_TOPOLOGY_FRAGMENTATION: "topology",
    DETAIL_UNSATISFIABLE: "topology",
    DETAIL_QUOTA_CEILING: "quota",
    DETAIL_QUEUE_POSITION: "quota",
    DETAIL_DISRUPTION_HOLD: "disruption",
}


def _store_rv(store):
    """The store's resourceVersion, or None for a store without one."""
    return getattr(store, "resource_version", None)


def _is_scheduled(gang) -> bool:
    cond = get_condition(gang.status.conditions, COND_PODGANG_SCHEDULED)
    return cond is not None and cond.is_true()


def _retry_torn(fn):
    """``fn()``, tried up to three times on RuntimeError: a scheduler round
    on another thread can change a dict the snapshot iterates, which is
    transient."""
    last_err = None
    for _ in range(3):
        try:
            return fn()
        except RuntimeError as e:
            last_err = e
    raise last_err


class ExplainEngine:
    """One scheduler's explain face. Thread-safe; its only state is the
    bounded cache of last verdicts."""

    def __init__(self, scheduler, max_cached: int = 4096) -> None:
        self.scheduler = scheduler
        self.max_cached = max_cached
        self._lock = threading.Lock()
        # (ns, name) -> slim last verdict, LRU-bounded (pending journeys'
        # annotation)
        self._verdicts: "OrderedDict[tuple, dict]" = OrderedDict()
        self.explains_total = 0
        self.whatifs_total = 0
        # federation hook: a (namespace, name) -> str callback naming the
        # cluster that owns the gang; None on one cluster
        self.cluster_context = None

    # -- faces -----------------------------------------------------------

    def explain(self, namespace: str, name: str) -> Optional[dict]:
        """The verdict for one PodGang, or None when there is no such
        PodGang."""
        sched = self.scheduler
        gang = sched.store.get("PodGang", namespace, name, readonly=True)
        if gang is None:
            return None
        t0 = time.perf_counter()
        if _is_scheduled(gang):
            doc = {
                "kind": "GangExplain",
                "namespace": namespace,
                "name": name,
                "state": "scheduled",
                "fits_now": True,
                "binding_constraint": None,
                "blocked_on": [],
                "funnel": [],
                "message": "gang is scheduled (Scheduled=True); nothing to explain",
            }
        else:
            doc = _retry_torn(
                lambda: self._evaluate(introspect.collect_pending(sched), namespace, name)
            )
        self._finish(namespace, name, doc, t0)
        return doc

    def capacity(self) -> dict:
        """Per-level domain free vectors and the fragmentation statistic
        (``introspect.capacity_report``)."""
        doc = dict({"kind": "CapacityReport"}, **introspect.capacity_report(self.scheduler))
        doc["resource_version"] = _store_rv(self.scheduler.store)
        return doc

    def whatif(self, body: dict) -> dict:
        """The target gang's verdict before and after a list of hypothetical
        actions, committing nothing. Raises ValueError on a malformed
        request."""
        gang_ref = body.get("gang") or {}
        namespace = gang_ref.get("namespace", "default")
        name = gang_ref.get("name")
        if not name:
            raise ValueError("whatif: body.gang.name is required")
        actions = body.get("actions") or []
        if not isinstance(actions, list) or not actions:
            raise ValueError("whatif: body.actions must be a non-empty list")
        before = self.explain(namespace, name)
        if before is None:
            raise ValueError(f"whatif: PodGang {namespace}/{name} not found")
        after, applied = _retry_torn(
            lambda: self._evaluate_hypothetical(namespace, name, actions)
        )
        self.whatifs_total += 1
        return {
            "kind": "WhatIfReport",
            "gang": {"namespace": namespace, "name": name},
            "actions": applied,
            "before": before,
            "after": after,
            "flipped": bool(before.get("fits_now")) != bool(after.get("fits_now")),
        }

    def last_verdict(self, namespace: str, name: str) -> Optional[dict]:
        """The slim cached last verdict, or None."""
        with self._lock:
            return self._verdicts.get((namespace, name))

    def pending_journeys(self) -> List[dict]:
        """Every active (unscheduled) journey with its age and stage,
        annotated with this engine's last verdict where one was computed."""
        rows = JOURNEYS.pending()
        for row in rows:
            v = self.last_verdict(row["namespace"], row["name"])
            if v is not None:
                row["last_verdict"] = v
        return rows

    # -- internals -------------------------------------------------------

    def _finish(self, namespace, name, doc, t0: float) -> None:
        doc["evaluated_in_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
        slim = {
            "state": doc.get("state"),
            "fits_now": doc.get("fits_now"),
            "binding_constraint": doc.get("binding_constraint"),
            "detail": doc.get("detail"),
            "evaluated_at_rv": doc.get("resource_version"),
        }
        with self._lock:
            self._verdicts[(namespace, name)] = slim
            self._verdicts.move_to_end((namespace, name))
            while len(self._verdicts) > self.max_cached:
                self._verdicts.popitem(last=False)
        self.explains_total += 1
        METRICS.observe("explain_verdict_seconds", time.perf_counter() - t0)

    def _evaluate(
        self,
        view,
        namespace: str,
        name: str,
        queue_crs: Optional[dict] = None,
        usage: Optional[dict] = None,
        hypothetical: bool = False,
    ) -> dict:
        """The funnel over one PendingView (live or overlay)."""
        sched = self.scheduler
        key = (namespace, name)
        target = next(
            (s for s in view.specs if s["namespace"] == namespace and s["gang_name"] == name),
            None,
        )
        monitor_held = key in set(view.held_monitor)
        if target is None and monitor_held:
            target = view.held_specs.get(key)
        doc: dict = {
            "kind": "GangExplain",
            "namespace": namespace,
            "name": name,
            "state": "held" if monitor_held else "pending",
            "hypothetical": hypothetical,
            "resource_version": _store_rv(sched.store),
        }
        if target is None:
            # a PodGang with no pending pods this instant: nothing to solve
            doc.update(
                {
                    "state": "no-pending-pods",
                    "fits_now": False,
                    "binding_constraint": None,
                    "blocked_on": [],
                    "funnel": [],
                    "message": "the gang has no pending (ungated,"
                    " unscheduled) pods this instant — controllers may"
                    " still be materializing them",
                }
            )
            return doc

        funnel: List[dict] = []

        def stage(name_, surviving, ok, detail):
            funnel.append(
                {"stage": name_, "surviving_nodes": int(surviving), "ok": bool(ok), "detail": detail}
            )

        # 0. cluster: never a blocker; the whole node population survives
        stage(
            "cluster",
            view.total_nodes,
            True,
            self.cluster_context(namespace, name)
            if self.cluster_context is not None
            else "single-cluster (no federation tier)",
        )

        # 1. node-health
        n_sched = len(view.nodes)
        stage(
            "node-health",
            n_sched,
            n_sched > 0,
            f"{n_sched} of {view.total_nodes} nodes schedulable"
            " (cordoned/NotReady/Lost masked)",
        )

        # 2. capacity
        floor = introspect.spec_floor_demand(target)
        hosts = 0
        total_free: Dict[str, float] = {}
        for node in view.nodes:
            row = view.free.get(node.name, {})
            for r, q in row.items():
                total_free[r] = total_free.get(r, 0.0) + q
            if any(
                all(row.get(r, 0.0) >= q for r, q in grp["demand"].items())
                for grp in target["groups"]
            ):
                hosts += 1
        short = sorted(r for r, q in floor.items() if q > total_free.get(r, 0.0) + 1e-9)
        cap_ok = hosts > 0 and not short
        if cap_ok:
            cap_detail = f"{hosts} nodes can host >=1 pod; cluster free covers the gang floor"
        elif short:
            cap_detail = f"cluster free cannot cover the gang floor for {'/'.join(short)}"
        else:
            cap_detail = "no single node fits any pod of the gang"
        stage("capacity", hosts, cap_ok, cap_detail)

        # 3. topology
        surviving_topo = hosts
        req_key = target.get("required_key")
        if req_key is not None and n_sched:
            level_keys = [lvl.key for lvl in sched.topology.spec.levels]
            if req_key not in level_keys:
                surviving_topo = 0
                stage(
                    "topology",
                    0,
                    False,
                    f"required pack key {req_key!r} is not a cluster topology level",
                )
            else:
                surviving_topo = self._topology_stage(
                    view, floor, req_key, level_keys[: level_keys.index(req_key) + 1], stage
                )
        else:
            stage(
                "topology",
                surviving_topo,
                True,
                "no gang-level required pack constraint"
                if req_key is None
                else "no schedulable nodes to judge",
            )

        # 4. quota
        crs = queue_crs if queue_crs is not None else sched.quota.queue_crs()
        ordered, held_quota = introspect.order_view(sched, list(view.specs), queue_crs=crs, usage=usage)
        held_reason = next(
            (
                reason
                for spec, reason in held_quota
                if spec["namespace"] == namespace and spec["gang_name"] == name
            ),
            None,
        )
        rank = next(
            (
                i
                for i, s in enumerate(ordered)
                if s["namespace"] == namespace and s["gang_name"] == name
            ),
            None,
        )
        queue_doc = {"name": target["queue"], "active": bool(crs)}
        if rank is not None:
            queue_doc["rank"] = rank
            queue_doc["ahead"] = [s["name"] for s in ordered[:rank]][:16]
            queue_doc["ahead_count"] = rank
        if crs:
            cr = crs.get(target["queue"])
            u = usage if usage is not None else introspect.queue_usage(sched)
            queue_doc["dominant_share"] = round(
                dominant_share_of(
                    u.get(target["queue"], {}),
                    dict(cr.spec.deserved) if cr is not None else {},
                ),
                6,
            )
        if held_reason is not None:
            quota_detail = held_reason
        elif rank is not None:
            quota_detail = f"rank {rank} of {len(ordered)} in this round's solve order"
        elif not crs:
            quota_detail = "quota inert (no Queue CRs)"
        else:
            quota_detail = "not in this round's order"
        stage("quota", surviving_topo, held_reason is None, quota_detail)
        doc["queue"] = queue_doc

        # 5. disruption
        broker = sched.broker
        breaker_open = bool(broker is not None and broker.active() and broker.breaker_open)
        if monitor_held:
            dis_detail = (
                "gang is in the node-health monitor's requeue backoff"
                " (released into a later round)"
            )
        elif breaker_open:
            dis_detail = "storm breaker OPEN: preemption/reclaim-assisted admission is paused"
        else:
            dis_detail = "no holds; breaker closed"
        stage("disruption", surviving_topo, not monitor_held, dis_detail)

        # 6. partition
        partition = None
        if not hypothetical and sched.frontier is not None and sched.delta is not None:
            enc, free_mat = sched.delta.encoding_view()
            if enc is not None and free_mat is not None:
                plan = sched.frontier.plan_for(enc)
                if plan is not None and rank is not None:
                    part_of = sched.frontier.assign(plan, enc, free_mat, ordered)
                    partition = int(part_of[rank])
        if partition is None:
            part_detail = "frontier off (global solve)"
        elif partition < 0:
            part_detail = "assigned to the global RESIDUAL pass"
        else:
            part_detail = f"assigned to frontier partition {partition}"
        stage("partition", surviving_topo, True, part_detail)
        if partition is not None:
            doc["partition"] = "residual" if partition < 0 else partition

        # 7. solve: solo, then the whole order
        solo_res, solo_prob, solo_err = introspect.solve_view_safe(
            sched, view.nodes, view.free, [target]
        )
        solo_ok = bool(solo_res is not None and solo_res.admitted[0])
        full_admitted = False
        if rank is not None and not monitor_held:
            full_res, _full_prob, _full_err = introspect.solve_view_safe(
                sched, view.nodes, view.free, ordered
            )
            # a competitor with a broken constraint leaves full_res None:
            # the real round would fail on it before judging this gang
            if full_res is not None:
                full_admitted = bool(full_res.admitted[rank])
        fits_now = full_admitted and held_reason is None and not monitor_held
        stage(
            "solve",
            surviving_topo,
            fits_now,
            f"solo trial {'admits' if solo_ok else 'rejects'};"
            f" full-order trial {'admits' if full_admitted else 'rejects'}"
            + (f" (constraint error: {solo_err})" if solo_err else ""),
        )

        # verdict
        slug = text = None
        if monitor_held:
            slug, text = DETAIL_DISRUPTION_HOLD, dis_detail
        elif held_reason is not None:
            slug, text = DETAIL_QUOTA_CEILING, held_reason
        elif not fits_now:
            if n_sched == 0:
                # uncordoning is the fix, not capacity
                slug = DETAIL_NO_NODES
                text = "no schedulable nodes (all cordoned/NotReady/Lost)"
            elif solo_err is not None:
                slug, text = DETAIL_UNSATISFIABLE, solo_err
            elif solo_ok:
                slug = DETAIL_QUEUE_POSITION
                text = (
                    f"admitted solo, but outcompeted at rank {rank}"
                    f" ({rank} gangs ahead in the"
                    f" {'fair-share' if crs else 'priority'} order)"
                )
            else:
                cls = introspect.classify_rejections(solo_prob, solo_res, [target])
                slug, text = cls.get(0, (DETAIL_INSUFFICIENT_CAPACITY, "solo trial rejected"))
        doc.update(
            {
                "fits_now": fits_now,
                "binding_constraint": _SLUG_STAGE.get(slug, "solve") if slug else None,
                "detail": slug,
                "detail_text": text,
                "blocked_on": [f for f in funnel if not f["ok"]],
                "funnel": funnel,
            }
        )
        if fits_now:
            doc["message"] = "the next solve admits this gang absent intervening churn"
        return doc

    @staticmethod
    def _topology_stage(view, floor, req_key, path_keys, stage) -> int:
        """The topology stage for a required pack key: how many domains of
        that level cover the gang's floor alone. Returns the nodes of the
        covering domains."""
        domains: Dict[tuple, List] = {}
        for node in view.nodes:
            path = tuple(node.labels.get(k, "") for k in path_keys)
            domains.setdefault(path, []).append(node)
        best_cover, best_name = 0.0, ""
        covered_nodes = 0
        covered_domains = 0
        need = {r: q for r, q in floor.items() if q > 0}
        for path, members in sorted(domains.items()):
            dom_free: Dict[str, float] = {}
            for node in members:
                for r, q in view.free.get(node.name, {}).items():
                    dom_free[r] = dom_free.get(r, 0.0) + q
            cover = min(dom_free.get(r, 0.0) / q for r, q in need.items()) if need else 1.0
            if cover > best_cover:
                best_cover, best_name = cover, path[-1]
            if cover >= 1.0 - 1e-9:
                covered_domains += 1
                covered_nodes += len(members)
        topo_ok = covered_domains > 0
        stage(
            "topology",
            covered_nodes,
            topo_ok,
            f"{covered_domains} of {len(domains)} {req_key} domains cover the gang floor"
            if topo_ok
            else f"no single {req_key} domain covers the gang"
            f" floor (best: {best_name!r} at {best_cover:.0%})"
            " — free capacity is fragmented across domains",
        )
        return covered_nodes

    # -- what-if overlays ------------------------------------------------

    def _evaluate_hypothetical(
        self, namespace: str, name: str, actions: List[dict]
    ) -> Tuple[dict, List[dict]]:
        sched = self.scheduler
        cluster = sched.cluster
        removed: set = set()
        added: List = []
        drained: List = []  # gangs evicted whole by hypothetical drains
        crs = dict(sched.quota.queue_crs())
        crs_touched = False
        applied: List[dict] = []
        for act in actions:
            kind = (act.get("action") or "").replace("_", "-")
            if kind in ("drain-node", "remove-node"):
                node_name = act.get("node")
                if cluster.node(node_name) is None:
                    raise ValueError(f"whatif: unknown node {node_name!r}")
                removed.add(node_name)
                if kind == "drain-node":
                    drained.extend(self._gangs_on(node_name))
                applied.append({"action": kind, "node": node_name})
            elif kind == "add-nodes":
                count = int(act.get("count", 1))
                like = act.get("like")
                template = cluster.node(like) if like else None
                if template is None and like:
                    raise ValueError(f"whatif: unknown node {like!r}")
                if template is None:
                    raise ValueError(
                        "whatif: add-nodes needs `like: <node>` to clone capacity/topology from"
                    )
                host_key = "kubernetes.io/hostname"
                for _ in range(count):
                    nm = f"whatif-{len(added)}-{template.name}"
                    labels = dict(template.labels)
                    if host_key in labels:
                        labels[host_key] = nm
                    added.append(Node(name=nm, capacity=dict(template.capacity), labels=labels))
                applied.append({"action": kind, "count": count, "like": like})
            elif kind == "set-queue":
                qname = act.get("queue")
                if not qname:
                    raise ValueError("whatif: set-queue needs `queue`")
                cr = crs.get(qname)
                if cr is not None:
                    cr = deep_copy(cr)
                else:
                    cr = Queue(metadata=ObjectMeta(name=qname), spec=QueueSpec())
                if act.get("deserved") is not None:
                    cr.spec.deserved = {r: float(v) for r, v in act["deserved"].items()}
                if act.get("ceiling") is not None:
                    cr.spec.ceiling = {r: float(v) for r, v in act["ceiling"].items()}
                crs[qname] = cr
                crs_touched = True
                applied.append(
                    {
                        "action": kind,
                        "queue": qname,
                        "deserved": dict(cr.spec.deserved),
                        "ceiling": dict(cr.spec.ceiling),
                    }
                )
            else:
                raise ValueError(
                    f"whatif: unknown action {act.get('action')!r}"
                    " (drain-node | remove-node | add-nodes | set-queue)"
                )

        all_nodes = [n for n in cluster.nodes if n.name not in removed] + added
        sched_nodes = [n for n in all_nodes if n.schedulable]
        free = cluster.node_free_all(sched_nodes)
        usage = introspect.queue_usage(sched) if crs else None
        extra_specs: List[dict] = []
        for gang in drained:
            # the hypothetical eviction gives the gang's bound usage back on
            # surviving nodes (a removed node's capacity leaves with it) and
            # takes it off its queue's ledger
            spec = introspect.gang_spec_from_cr(sched.store, sched, gang)
            extra_specs.append(spec)
            for group in gang.spec.pod_groups:
                for ref in group.pod_references:
                    bound = cluster.bindings.get((ref.namespace, ref.name))
                    pod = sched.store.get("Pod", ref.namespace, ref.name, readonly=True)
                    if pod is None:
                        continue
                    reqs = pod.spec.total_requests()
                    if bound is not None and bound in free:
                        row = free[bound]
                        for r, q in reqs.items():
                            row[r] = row.get(r, 0.0) + q
                    if usage is not None and bound is not None:
                        qrow = usage.setdefault(spec["queue"], {})
                        for r, q in reqs.items():
                            qrow[r] = qrow.get(r, 0.0) - q
        view = introspect.collect_pending(sched, nodes=sched_nodes, free=free, all_nodes=all_nodes)
        existing = {(s["namespace"], s["gang_name"]) for s in view.specs}
        for spec in extra_specs:
            if (spec["namespace"], spec["gang_name"]) not in existing:
                view.specs.append(spec)
        after = self._evaluate(
            view,
            namespace,
            name,
            queue_crs=crs if (crs or crs_touched) else None,
            usage=usage,
            hypothetical=True,
        )
        return after, applied

    def _gangs_on(self, node_name: str) -> List:
        """Every scheduled gang with a pod bound to the node (the drain
        controller's gang-whole relocation), in binding-key order."""
        sched = self.scheduler
        seen = set()
        out = []
        for (ns, pod_name), bound in sorted(sched.cluster.bindings.items()):
            if bound != node_name:
                continue
            pod = sched.store.get("Pod", ns, pod_name, readonly=True)
            if pod is None:
                continue
            gname = pod.metadata.labels.get(namegen.LABEL_PODGANG)
            if not gname or (ns, gname) in seen:
                continue
            seen.add((ns, gname))
            gang = sched.store.get("PodGang", ns, gname, readonly=True)
            if gang is not None and _is_scheduled(gang):
                out.append(gang)
        return out
