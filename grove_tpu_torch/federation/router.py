"""FederationRouter: the global gang router over K simulated clusters.

Counterpart of ``grove_tpu/federation/router.py``; every region's harness
solves on ``device`` (the card unless the caller passes ``device="cpu"``).

Each cluster is a full :class:`SimHarness` — its own store shards, WAL
dir, quota accountant, monitor/broker/drainer, and optional workers —
sharing ONE virtual clock so the federation converge loop can drive
them in lockstep (``SimHarness.tick_once``/``next_wake``). Placement
policy (docs/federation.md):

- **home affinity** — a PodCliqueSet lands in its home region (the
  ``federation.grove.io/home`` label, an explicit argument, or the
  first region) whenever that region is Ready; data gravity means the
  router never proactively load-balances a placeable workload away.
- **spillover** — reactive: a gang pending past ``spill_after`` whose
  home cluster's explain verdict says it cannot admit now (and is not
  quota-capped or disruption-held — those block everywhere) moves to
  the best admissible sibling, ranked on (fragmentation delta,
  −headroom, region) from ``introspect.federation_score_inputs``, in
  GLOBAL DRF order over the union frontier with the level-3 quota fold
  as the usage ledger.
- **cluster_crash** — a whole region dies; every placement it held
  re-routes to surviving clusters through the same scoring core and
  re-admits under the ordinary broker/budget machinery. ``rejoin``
  rebuilds a fresh harness on the shared clock; placements do NOT fail
  back (the decision ledger records where everything went and why).

The spill pass orders the union of every region's pending gangs with
``introspect.order_view(..., usage=global_usage())``: with tenant Queue CRs
applied (``apply`` / ``apply_queue``) that is the DRF order of
``csrc/drf.cu`` over the level-3 fold, not a region's local ledger.

K=1 is inert: the converge loop reduces exactly to the bare harness's (no
spill pass, same idle-jump arithmetic). All ``_``-prefixed state is
private to this package.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from grove_tpu_torch.api import names as namegen
from grove_tpu_torch.api.meta import deep_copy, get_condition
from grove_tpu_torch.api.types import COND_PODGANG_SCHEDULED, PodCliqueSet
from grove_tpu_torch.federation.quota import GlobalQuotaFold
from grove_tpu_torch.observability.events import (
    EVENTS,
    REASON_CLUSTER_HEALED,
    REASON_CLUSTER_LOST,
    REASON_CLUSTER_PARTITIONED,
    REASON_CLUSTER_REJOINED,
    REASON_GANG_REQUEUED,
    REASON_GANG_SPILLED,
)
from grove_tpu_torch.observability.metrics import METRICS
from grove_tpu_torch.runtime.clock import VirtualClock
from grove_tpu_torch.runtime.store import Store
from grove_tpu_torch.sim.harness import SimHarness
from grove_tpu_torch.solver import introspect

# explain-verdict detail slugs that block admission EVERYWHERE — quota
# is global (the level-3 fold), and a monitor hold releases locally —
# so spilling on them would burn a move without unblocking anything
_NO_SPILL_DETAILS = ("quota-ceiling", "disruption-hold")


@dataclass
class FederatedCluster:
    """One region's registry row: the live harness (None while Lost),
    its diurnal phase offset, and lifecycle bookkeeping."""

    region: str
    harness: Optional[SimHarness]
    phase_offset: float = 0.0
    index: int = 0
    state: str = "Ready"  # Ready | Lost | Partitioned
    lost_at: Optional[float] = None
    crashes: int = 0
    # partition ≠ crash (docs/federation.md): an unreachable region's
    # harness stays ALIVE and keeps converging on the shared clock — the
    # router just cannot talk to it. `reachable` is the fault plane;
    # `state` flips to Partitioned only once the router's suspicion
    # timeout expires.
    reachable: bool = True
    unreachable_since: Optional[float] = None
    partitions: int = 0


def pcs_floor_demand(pcs: PodCliqueSet) -> Dict[str, float]:
    """Aggregate floor demand of one PCS template (per-clique floor ×
    template replicas) — the routing score's demand vector when no live
    PodGang spec exists (initial placement, crash re-route)."""
    out: Dict[str, float] = {}
    replicas = max(1, int(getattr(pcs.spec, "replicas", 1) or 1))
    for clq in pcs.spec.template.cliques:
        n = (
            clq.spec.min_available
            if clq.spec.min_available is not None
            else clq.spec.replicas
        )
        for c in clq.spec.pod_spec.containers:
            for r, q in c.requests.items():
                out[r] = out.get(r, 0.0) + float(q) * n * replicas
    return out


class FederationRouter:
    """Owns K clusters and every cross-cluster placement decision."""

    def __init__(
        self,
        regions: List[str],
        num_nodes: int = 16,
        phase_offsets: Optional[List[float]] = None,
        spill_after: float = 30.0,
        partition_suspect_after: float = 30.0,
        durability_root: Optional[str] = None,
        harness_factory: Optional[Callable] = None,
        device=None,
    ) -> None:
        from grove_tpu_torch.utils.platform import resolve_device

        if not regions:
            raise ValueError("federation: at least one region required")
        if len(set(regions)) != len(regions):
            raise ValueError("federation: duplicate region names")
        self.clock = VirtualClock()
        self.spill_after = spill_after
        # how long a region may be unreachable before the router suspects
        # a partition (fences + spills its still-pending gangs); matches
        # the region's own lease expiry on the shared clock
        self.partition_suspect_after = partition_suspect_after
        self.num_nodes = num_nodes
        self._durability_root = durability_root
        self._factory = harness_factory
        # every region's solver device; resolved before any harness exists,
        # so a missing card raises first
        self.device = resolve_device(device) if harness_factory is None else device
        # region -> FederatedCluster, in registration order (the
        # deterministic tick / tie-break order)
        self._clusters: "OrderedDict[str, FederatedCluster]" = OrderedDict()
        # (ns, pcs name) -> (pristine pre-defaulting template, home region)
        self._specs: Dict[Tuple[str, str], Tuple[PodCliqueSet, str]] = {}
        # (ns, pcs name) -> current region
        self._placements: Dict[Tuple[str, str], str] = {}
        # queue name -> pristine Queue template (applied to every cluster)
        self._queues: Dict[str, object] = {}
        # the routing ledger: every place/spill/reroute/strand/rejoin,
        # vt-stamped, with score inputs and the home verdict that drove it
        self._decisions: List[dict] = []
        # (ns, pcs name) spilled off a partitioned region, by region: the
        # stale copies still sitting in the unreachable store that heal
        # reconciliation must delete (the one write a partition forbids)
        self._partition_spills: Dict[str, List[Tuple[str, str]]] = {}
        # lifetime counters (bench "federation" block / GET /federation)
        self.spillovers = 0
        self.reroutes = 0
        self.partition_spills = 0
        self.fold = GlobalQuotaFold(len(regions))
        offsets = phase_offsets or [0.0] * len(regions)
        if len(offsets) != len(regions):
            raise ValueError("federation: one phase offset per region")
        for i, region in enumerate(regions):
            cl = FederatedCluster(
                region=region,
                harness=self._build_harness(region),
                phase_offset=float(offsets[i]),
                index=i,
            )
            self._install_context(cl)
            self._clusters[region] = cl
        METRICS.set("federation_clusters_ready", float(len(regions)))
        METRICS.set(
            "federation_quota_fold_depth", float(self.fold.depth)
        )

    # -- construction ----------------------------------------------------

    def _build_harness(self, region: str) -> SimHarness:
        if self._factory is not None:
            return self._factory(region, self.clock)
        durability_dir = None
        if self._durability_root is not None:
            import os

            durability_dir = os.path.join(self._durability_root, region)
        return SimHarness(
            num_nodes=self.num_nodes,
            store=Store(self.clock, cache_lag=True),
            durability_dir=durability_dir,
            device=self.device,
        )

    def _install_context(self, cl: FederatedCluster) -> None:
        """Arm this cluster's explain engine with the funnel's "which
        cluster and why" stage (observability/explain.py stage 0)."""
        region = cl.region
        router = self

        def _ctx(namespace: str, name: str) -> str:
            why = "home placement"
            holder = router._clusters.get(region)
            if holder is not None and holder.harness is not None:
                gang = holder.harness.store.get(
                    "PodGang", namespace, name, readonly=True
                )
                if gang is not None:
                    pcs_name = gang.metadata.labels.get(
                        namegen.LABEL_PART_OF
                    )
                    d = router._decision_for(namespace, pcs_name)
                    if d is not None:
                        if d["kind"] == "spill":
                            why = (
                                f"spilled from {d['from']}"
                                f" ({d.get('why', 'home cannot admit')})"
                            )
                        elif d["kind"] == "reroute":
                            why = (
                                f"re-routed from lost cluster {d['from']}"
                            )
                        else:
                            why = (
                                "home-affinity placement"
                                f" (home {d['home']})"
                            )
            return (
                f"cluster {region} of {len(router._clusters)}: {why}"
            )

        if cl.harness is not None:
            cl.harness.explain.cluster_context = _ctx

    def _decision_for(
        self, namespace: str, pcs_name: Optional[str]
    ) -> Optional[dict]:
        if not pcs_name:
            return None
        for d in reversed(self._decisions):
            if d["namespace"] == namespace and d["name"] == pcs_name:
                return d
        return None

    # -- registry faces --------------------------------------------------

    def clusters(self) -> List[FederatedCluster]:
        return list(self._clusters.values())

    def cluster(self, region: str) -> Optional[FederatedCluster]:
        return self._clusters.get(region)

    def placements(self) -> Dict[Tuple[str, str], str]:
        return dict(self._placements)

    def decisions(self) -> List[dict]:
        return [dict(d) for d in self._decisions]

    def _ready(self) -> List[FederatedCluster]:
        """Clusters the router may ROUTE to/through: Ready AND reachable.
        An unreachable region drops out of routing the instant the fault
        lands (the router's calls to it would hang), even before the
        suspicion timeout flips its state to Partitioned."""
        return [
            cl
            for cl in self._clusters.values()
            if cl.state == "Ready" and cl.reachable
        ]

    def _live(self) -> List[FederatedCluster]:
        """Clusters whose control plane is RUNNING (everything but Lost):
        a partitioned region keeps converging on the shared clock — it
        just cannot be routed to or read by the router."""
        return [
            cl
            for cl in self._clusters.values()
            if cl.state != "Lost" and cl.harness is not None
        ]

    def _record(self, kind: str, namespace: str, name: str, **kw) -> dict:
        d = dict(
            {
                "vt": self.clock.now(),
                "kind": kind,
                "namespace": namespace,
                "name": name,
            },
            **kw,
        )
        self._decisions.append(d)
        return d

    # -- user actions ----------------------------------------------------

    def apply(self, pcs, home: Optional[str] = None):
        """Route one PodCliqueSet (or tenant Queue — fanned out to every
        cluster): home affinity first, score-ranked fallback only when
        the home region is Lost."""
        from grove_tpu_torch.api.types import Queue

        if isinstance(pcs, Queue):
            return self.apply_queue(pcs)
        home = (
            home
            or pcs.metadata.labels.get(namegen.LABEL_FEDERATION_HOME)
            or next(iter(self._clusters))
        )
        if home not in self._clusters:
            raise ValueError(f"federation: unknown region {home!r}")
        key = (pcs.metadata.namespace or "default", pcs.metadata.name)
        template = deep_copy(pcs)
        target = home
        why = "home ready"
        if self._clusters[home].state != "Ready":
            ranked = self._rank_targets(
                pcs_floor_demand(template), exclude=None
            )
            if not ranked:
                raise ValueError(
                    "federation: no Ready cluster to place"
                    f" {key[0]}/{key[1]} (home {home} is Lost)"
                )
            target = ranked[0][1]
            why = f"home {home} is Lost; best surviving score"
        applied = self._clusters[target].harness.apply(pcs)
        self._specs[key] = (template, home)
        self._placements[key] = target
        self._record(
            "place", key[0], key[1], home=home, to=target, why=why
        )
        return applied

    def apply_queue(self, queue):
        """Tenant Queues are GLOBAL: the same CR lands in every Ready
        cluster (and re-lands on rejoin), so the per-cluster DRF trees
        agree and the level-3 fold is comparing like with like."""
        self._queues[queue.metadata.name] = deep_copy(queue)
        applied = None
        for cl in self._ready():
            applied = cl.harness.apply_queue(deep_copy(queue))
        return applied

    def delete(self, name: str, namespace: str = "default") -> None:
        key = (namespace, name)
        region = self._placements.pop(key, None)
        self._specs.pop(key, None)
        if region is not None:
            cl = self._clusters.get(region)
            if cl is not None and cl.harness is not None:
                cl.harness.delete(name, namespace)

    # -- convergence -----------------------------------------------------

    def converge(
        self, max_ticks: int = 60, tick_seconds: float = 1.0
    ) -> int:
        """Drive every Ready cluster in lockstep on the shared clock —
        per tick: each harness's tick_once() in region order, then (only
        when siblings exist) one spillover pass. With K=1 this loop IS
        ``SimHarness.converge`` — same idle test, same wake jump, same
        store guard.
        """
        ticks = 0
        for _ in range(max_ticks):
            work = self._partition_suspect_tick()
            ready = self._ready()
            live = self._live()
            bound = started = 0
            # EVERY live harness ticks — a partitioned region's control
            # plane keeps converging on the shared clock (partition ≠
            # crash); only routing below is restricted to `ready`
            for cl in live:
                w, b, s = cl.harness.tick_once()
                work += w
                bound += b
                started += s
            if len(ready) > 1:
                work += self._spill_tick(ready)
            ticks += 1
            if bound == 0 and started == 0 and work == 0:
                wakes = [
                    w
                    for w in (
                        cl.harness.next_wake() for cl in live
                    )
                    if w is not None
                ]
                suspect_wake = self._next_suspect_deadline()
                if suspect_wake is not None:
                    wakes.append(suspect_wake)
                if len(ready) > 1:
                    # a pending gang becomes spill-eligible at
                    # creation + spill_after: that moment is a wake
                    # deadline too, or the loop idles out before the
                    # spillover pass ever gets to judge it
                    spill_wake = self._next_spill_deadline(ready)
                    if spill_wake is not None:
                        wakes.append(spill_wake)
                wake = min(wakes) if wakes else None
                if wake is not None and wake - self.clock.now() <= 120.0:
                    self.clock.advance(
                        max(wake - self.clock.now(), 0.0)
                    )
                    continue
                break
            self.clock.advance(tick_seconds)
        from grove_tpu_torch.analysis.sanitize import store_guard_enabled

        if store_guard_enabled():
            for cl in self._ready():
                cl.harness.store.verify_readonly_integrity()
        return ticks

    # -- partition suspicion ---------------------------------------------

    def _next_suspect_deadline(self) -> Optional[float]:
        """Earliest instant an unreachable-but-not-yet-Partitioned region
        crosses ``partition_suspect_after`` — a converge wake deadline,
        or the loop would idle out before ever suspecting."""
        best: Optional[float] = None
        for cl in self._clusters.values():
            if (
                cl.state == "Ready"
                and not cl.reachable
                and cl.unreachable_since is not None
            ):
                due = cl.unreachable_since + self.partition_suspect_after
                if best is None or due < best:
                    best = due
        return best

    def _partition_suspect_tick(self) -> int:
        """Flip Ready-but-unreachable regions past the suspicion timeout
        to Partitioned: fence their admission (the region's own lease
        expiry on the shared clock — it may no longer flip gangs to
        Scheduled), then spill ONLY its still-pending placements.
        Anything the region already Scheduled stays bound there —
        invariant F3: no PodGang is ever Scheduled in two clusters
        across a partition/heal cycle. Because the fence lands before
        the store read, the Scheduled set cannot grow under us, so
        "pending at suspect time" is an honest one-shot judgment."""
        now = self.clock.now()
        work = 0
        for cl in self._clusters.values():
            if (
                cl.state != "Ready"
                or cl.reachable
                or cl.unreachable_since is None
                or now - cl.unreachable_since
                < self.partition_suspect_after
            ):
                continue
            cl.state = "Partitioned"
            cl.partitions += 1
            # fence FIRST: a fenced scheduler cannot newly bind, so the
            # pending/Scheduled split read below is final (F3 holds by
            # construction, not by luck of tick ordering)
            cl.harness.scheduler.admission_fenced = True
            METRICS.inc("federation_cluster_partitions_total")
            METRICS.set(
                "federation_clusters_ready", float(len(self._ready()))
            )
            EVENTS.record(
                ("Cluster", "", cl.region),
                "Warning",
                REASON_CLUSTER_PARTITIONED,
                f"region {cl.region} partitioned after"
                f" {self.partition_suspect_after:.0f}s unreachable;"
                " admission fenced, spilling pending gangs",
            )
            work += 1
            work += self._spill_partitioned(cl)
        return work

    def _spill_partitioned(self, cl: FederatedCluster) -> int:
        """Move the partitioned region's placements whose PCS has NO
        Scheduled gang to the best surviving sibling. The stale copy
        cannot be deleted from the unreachable store — heal
        reconciliation does that — so remember each spilled key in
        ``_partition_spills``."""
        region = cl.region
        moved = 0
        victims = sorted(
            key for key, r in self._placements.items() if r == region
        )
        for key in victims:
            ns, pcs_name = key
            gangs = [
                g
                for g in cl.harness.store.list("PodGang")
                if g.metadata.labels.get(namegen.LABEL_PART_OF)
                == pcs_name
                and g.metadata.namespace == ns
            ]
            if any(
                (
                    c := get_condition(
                        g.status.conditions, COND_PODGANG_SCHEDULED
                    )
                )
                is not None
                and c.is_true()
                for g in gangs
            ):
                # already Scheduled inside the partition: it stays bound
                # there (F3) — the region keeps running it behind the
                # partition and nothing re-routes
                continue
            template, home = self._specs[key]
            ranked = self._rank_targets(
                pcs_floor_demand(template), exclude=region
            )
            if not ranked:
                continue  # stays pending behind the fence until heal
            _sortkey, target, inputs, _admits = ranked[0]
            self._clusters[target].harness.apply(deep_copy(template))
            self._placements[key] = target
            self._partition_spills.setdefault(region, []).append(key)
            self.partition_spills += 1
            METRICS.inc("federation_partition_spills_total")
            EVENTS.record(
                ("PodCliqueSet", ns, pcs_name),
                "Warning",
                REASON_GANG_SPILLED,
                f"partition-spilled {region} -> {target}"
                " (pending behind partition)",
            )
            self._record(
                "partition-spill",
                ns,
                pcs_name,
                home=home,
                to=target,
                score=dict(inputs),
                **{"from": region},
            )
            moved += 1
        return moved

    # -- spillover core --------------------------------------------------

    def _next_spill_deadline(
        self, ready: List[FederatedCluster]
    ) -> Optional[float]:
        """Earliest FUTURE instant a currently-pending gang crosses the
        ``spill_after`` age threshold (None when nothing is pending or
        everything eligible was already judged this tick — an
        already-eligible gang the spill pass declined stays declined
        until some other wake changes cluster state)."""
        now = self.clock.now()
        best: Optional[float] = None
        for cl in ready:
            for gang in self._pending_gangs(cl.harness):
                due = gang.metadata.creation_timestamp + self.spill_after
                if due > now and (best is None or due < best):
                    best = due
        return best

    def global_usage(self) -> Dict[str, Dict[str, float]]:
        """The level-3 fold's root: per-queue usage summed across every
        Ready cluster's accountant — the DRF ledger that makes a
        tenant's deserved share global."""
        partials: List[dict] = [{} for _ in range(self.fold.num_clusters)]
        for cl in self._clusters.values():
            if (
                cl.state == "Ready"
                and cl.reachable
                and cl.index < len(partials)
            ):
                partials[cl.index] = introspect.queue_usage(
                    cl.harness.scheduler
                )
        self.fold.refold(partials)
        return self.fold.root()

    def _pending_gangs(self, harness: SimHarness) -> List:
        out = []
        for gang in harness.store.list("PodGang"):
            cond = get_condition(
                gang.status.conditions, COND_PODGANG_SCHEDULED
            )
            if cond is None or not cond.is_true():
                out.append(gang)
        return out

    def _rank_targets(
        self,
        floor: Dict[str, float],
        exclude: Optional[str],
        spec: Optional[dict] = None,
    ) -> List[tuple]:
        """Candidate Ready clusters ranked best-first on the frontier-
        style score: (fragmentation delta, −headroom, region). When a
        solver ``spec`` is given, clusters whose read-only trial solve
        rejects it rank strictly behind every admitting cluster."""
        ranked = []
        for cl in self._ready():
            if cl.region == exclude:
                continue
            inputs = introspect.federation_score_inputs(
                cl.harness.scheduler, floor
            )
            admits = True
            if spec is not None:
                view = introspect.collect_pending(cl.harness.scheduler)
                res, _prob, err = introspect.solve_view_safe(
                    cl.harness.scheduler, view.nodes, view.free, [spec]
                )
                admits = bool(
                    err is None
                    and res is not None
                    and res.admitted[0]
                )
            ranked.append(
                (
                    (
                        0 if admits else 1,
                        inputs["frag_delta"],
                        -inputs["headroom"],
                        cl.region,
                    ),
                    cl.region,
                    inputs,
                    admits,
                )
            )
        ranked.sort(key=lambda row: row[0])
        return ranked

    def _spill_tick(self, ready: List[FederatedCluster]) -> int:
        """One spillover pass: walk the union pending frontier in global
        DRF order (cross-cluster fold as the usage ledger) and move at
        most ONE gang whose home explain verdict blocks local admission
        to its best admissible sibling. One move per tick keeps every
        collected view consistent and the decision ledger replayable."""
        now = self.clock.now()
        usage = self.global_usage()
        specs: List[dict] = []
        origin_of: Dict[Tuple[str, str], str] = {}
        crs = None
        order_sched = None
        for cl in ready:
            sched = cl.harness.scheduler
            if order_sched is None:
                order_sched = sched
                crs = sched.quota.queue_crs()
            view = introspect.collect_pending(sched)
            for spec in view.specs:
                specs.append(spec)
                origin_of[(spec["namespace"], spec["gang_name"])] = (
                    cl.region
                )
        if not specs:
            return 0
        ordered, _held = introspect.order_view(
            order_sched, specs, queue_crs=crs, usage=usage
        )
        for spec in ordered:
            ns, gname = spec["namespace"], spec["gang_name"]
            origin_region = origin_of.get((ns, gname))
            if origin_region is None:
                continue
            origin = self._clusters[origin_region]
            gang = origin.harness.store.get(
                "PodGang", ns, gname, readonly=True
            )
            if gang is None:
                continue
            if now - gang.metadata.creation_timestamp < self.spill_after:
                continue
            pcs_name = gang.metadata.labels.get(namegen.LABEL_PART_OF)
            if not pcs_name:
                continue
            key = (ns, pcs_name)
            if self._placements.get(key) != origin_region:
                continue  # already moved (zombie pending deletion)
            # the move is PCS-whole (data gravity: a workload's gangs
            # stay together) — only spill when nothing is placed yet
            siblings = [
                g
                for g in origin.harness.store.list("PodGang")
                if g.metadata.labels.get(namegen.LABEL_PART_OF)
                == pcs_name
                and g.metadata.namespace == ns
            ]
            if any(
                (
                    c := get_condition(
                        g.status.conditions, COND_PODGANG_SCHEDULED
                    )
                )
                is not None
                and c.is_true()
                for g in siblings
            ):
                continue
            verdict = origin.harness.explain.explain(ns, gname)
            if verdict is None or verdict.get("fits_now"):
                continue
            if verdict.get("state") != "pending":
                continue
            if verdict.get("detail") in _NO_SPILL_DETAILS:
                continue
            floor = introspect.spec_floor_demand(spec)
            ranked = self._rank_targets(
                floor, exclude=origin_region, spec=spec
            )
            ranked = [row for row in ranked if row[3]]  # admitting only
            if not ranked:
                continue
            _sortkey, target, inputs, _admits = ranked[0]
            template, home = self._specs[key]
            origin.harness.delete(pcs_name, ns)
            self._clusters[target].harness.apply(deep_copy(template))
            self._placements[key] = target
            self.spillovers += 1
            METRICS.inc("federation_spillovers_total")
            why = (
                f"home verdict {verdict.get('detail')}"
                f" ({verdict.get('binding_constraint')})"
            )
            EVENTS.record(
                ("PodGang", ns, gname),
                "Normal",
                REASON_GANG_SPILLED,
                f"spilled {origin_region} -> {target}: {why}",
            )
            self._record(
                "spill",
                ns,
                pcs_name,
                home=home,
                to=target,
                why=why,
                score=dict(inputs),
                home_verdict={
                    "fits_now": verdict.get("fits_now"),
                    "detail": verdict.get("detail"),
                    "binding_constraint": verdict.get(
                        "binding_constraint"
                    ),
                },
            )
            return 1
        return 0

    # -- region lifecycle ------------------------------------------------

    def crash_cluster(self, region: str) -> dict:
        """Kill a whole region mid-traffic: the harness (store, WAL
        buffer, controllers) is gone; every placement it held re-routes
        to surviving clusters through the scoring core and re-admits
        under the ordinary broker/budget machinery. Placements that find
        no Ready cluster are stranded (re-placeable via apply)."""
        cl = self._clusters.get(region)
        if cl is None or cl.state != "Ready":
            raise ValueError(
                f"federation: cannot crash {region!r} (not Ready)"
            )
        victims = sorted(
            key for key, r in self._placements.items() if r == region
        )
        cl.harness.engine.close()
        cl.harness = None
        cl.state = "Lost"
        cl.lost_at = self.clock.now()
        cl.crashes += 1
        METRICS.inc("federation_cluster_crashes_total")
        METRICS.set(
            "federation_clusters_ready", float(len(self._ready()))
        )
        EVENTS.record(
            ("Cluster", "", region),
            "Warning",
            REASON_CLUSTER_LOST,
            f"region {region} lost with {len(victims)} placements",
        )
        rerouted, stranded = [], []
        for key in victims:
            ns, name = key
            template, home = self._specs[key]
            ranked = self._rank_targets(
                pcs_floor_demand(template), exclude=region
            )
            if not ranked:
                del self._placements[key]
                stranded.append(key)
                self._record(
                    "strand", ns, name, home=home, **{"from": region}
                )
                continue
            _sortkey, target, inputs, _admits = ranked[0]
            self._clusters[target].harness.apply(deep_copy(template))
            self._placements[key] = target
            self.reroutes += 1
            METRICS.inc("federation_reroutes_total")
            EVENTS.record(
                ("PodCliqueSet", ns, name),
                "Warning",
                REASON_GANG_REQUEUED,
                f"re-routed {region} -> {target} (cluster lost)",
            )
            self._record(
                "reroute",
                ns,
                name,
                home=home,
                to=target,
                score=dict(inputs),
                **{"from": region},
            )
            rerouted.append(key)
        return {
            "region": region,
            "victims": [list(k) for k in victims],
            "rerouted": [list(k) for k in rerouted],
            "stranded": [list(k) for k in stranded],
        }

    def partition_cluster(self, region: str) -> FederatedCluster:
        """Cut the router's link to a Ready region. Unlike
        ``crash_cluster`` the harness stays ALIVE and keeps converging
        on the shared clock — only the router's view goes dark. Nothing
        moves yet: the suspicion timeout in ``_partition_suspect_tick``
        decides when (and what) to spill."""
        cl = self._clusters.get(region)
        if cl is None or cl.state != "Ready" or not cl.reachable:
            raise ValueError(
                f"federation: cannot partition {region!r}"
                " (not Ready/reachable)"
            )
        cl.reachable = False
        cl.unreachable_since = self.clock.now()
        METRICS.set(
            "federation_clusters_ready", float(len(self._ready()))
        )
        return cl

    def heal_cluster(self, region: str) -> dict:
        """Heal a partition: unfence admission, reconcile by deleting
        the stale copies of PCS keys the suspect pass spilled elsewhere
        (the one write the partition forbade), and return the region to
        routing. Spilled placements do NOT fail back — same no-fail-back
        rule as crash/rejoin — so each key ends Scheduled in exactly one
        cluster (F3)."""
        cl = self._clusters.get(region)
        if cl is None or cl.reachable or cl.harness is None:
            raise ValueError(
                f"federation: cannot heal {region!r} (not partitioned)"
            )
        stale = self._partition_spills.pop(region, [])
        for ns, pcs_name in stale:
            cl.harness.delete(pcs_name, ns)
        # tenant Queues applied while the region was dark never reached
        # it — re-apply the full set so the DRF trees agree again
        for queue in self._queues.values():
            cl.harness.apply_queue(deep_copy(queue))
        cl.reachable = True
        cl.unreachable_since = None
        cl.state = "Ready"
        cl.harness.scheduler.admission_fenced = False
        METRICS.set(
            "federation_clusters_ready", float(len(self._ready()))
        )
        EVENTS.record(
            ("Cluster", "", region),
            "Normal",
            REASON_CLUSTER_HEALED,
            f"region {region} healed; reconciled {len(stale)} stale"
            " spilled copies",
        )
        self._record(
            "heal", "", region, reconciled=[list(k) for k in stale]
        )
        return {
            "region": region,
            "reconciled": [list(k) for k in stale],
        }

    def rejoin_cluster(self, region: str) -> FederatedCluster:
        """Restore a Lost region with a FRESH harness on the shared
        clock (tenant Queues re-applied so the DRF trees agree again).
        No fail-back: placements stay where the crash re-routed them.
        The Ready flip is LAST — a spillover walk interleaved with this
        call must never route into a half-built region."""
        cl = self._clusters.get(region)
        if cl is None or cl.state != "Lost":
            raise ValueError(
                f"federation: cannot rejoin {region!r} (not Lost)"
            )
        cl.harness = self._build_harness(region)
        self._install_context(cl)
        for queue in self._queues.values():
            cl.harness.apply_queue(deep_copy(queue))
        cl.state = "Ready"
        cl.lost_at = None
        METRICS.set(
            "federation_clusters_ready", float(len(self._ready()))
        )
        EVENTS.record(
            ("Cluster", "", region),
            "Normal",
            REASON_CLUSTER_REJOINED,
            f"region {region} rejoined with a fresh control plane",
        )
        self._record("rejoin", "", region)
        return cl

    # -- inspection ------------------------------------------------------

    def explain(self, namespace: str, name: str) -> Optional[dict]:
        """The federated explain verdict: find the cluster holding the
        gang and return ITS verdict (the funnel's opening stage already
        answers "which cluster and why"), annotated with the region."""
        for cl in self._ready():
            doc = cl.harness.explain.explain(namespace, name)
            if doc is not None:
                doc["cluster"] = cl.region
                return doc
        return None

    def status(self) -> dict:
        """``GET /federation`` / ``cli federation``: registry + ledger
        roll-up."""
        clusters = []
        for cl in self._clusters.values():
            row = {
                "region": cl.region,
                "state": cl.state,
                "phaseOffset": cl.phase_offset,
                "crashes": cl.crashes,
                "reachable": cl.reachable,
                "partitions": cl.partitions,
                "placements": sum(
                    1
                    for r in self._placements.values()
                    if r == cl.region
                ),
            }
            if cl.harness is not None:
                row["nodes"] = len(cl.harness.cluster.nodes)
                row["resourceVersion"] = getattr(
                    cl.harness.store, "resource_version", None
                )
                row["pendingGangs"] = len(
                    self._pending_gangs(cl.harness)
                )
            if cl.lost_at is not None:
                row["lostAt"] = cl.lost_at
            clusters.append(row)
        return {
            "kind": "FederationStatus",
            "clusters": clusters,
            "spillovers": self.spillovers,
            "reroutes": self.reroutes,
            "partitionSpills": self.partition_spills,
            "decisions": len(self._decisions),
            "foldDepthHistogram": self.fold.fold_depth_histogram(),
            "globalUsage": self.global_usage(),
        }


def federation_artifact(
    seed: int = 2026,
    regions: int = 3,
    num_nodes: int = 8,
    rounds: int = 3,
    device=None,
) -> dict:
    """The bench ``"federation"`` block's isolated scenario: seeded
    multi-region placement storm with one mid-run region crash +
    rejoin. Deterministic in (seed, shape) — the routing ledger length
    and counters are replayable."""
    import random
    import time as _time

    from grove_tpu_torch.sim.chaos import chaos_workload

    t0 = _time.perf_counter()
    names = [f"r{i}" for i in range(regions)]
    router = FederationRouter(
        names,
        num_nodes=num_nodes,
        phase_offsets=[i * 200.0 for i in range(regions)],
        spill_after=5.0,
        device=device,
    )
    rng = random.Random(seed)
    applied = 0
    for rnd in range(rounds):
        for pcs in chaos_workload(n_each=1):
            pcs.metadata.name = f"{pcs.metadata.name}-{rnd}"
            pcs.metadata.labels[namegen.LABEL_FEDERATION_HOME] = (
                rng.choice(names)
            )
            router.apply(pcs)
            applied += 1
        router.converge(max_ticks=40)
        if rnd == rounds // 2 and regions > 1:
            crash = router.crash_cluster(names[0])
            router.converge(max_ticks=40)
            router.rejoin_cluster(names[0])
            router.converge(max_ticks=20)
    status = router.status()
    return {
        "seed": seed,
        "regions": regions,
        "nodes_per_region": num_nodes,
        "applied": applied,
        "spillovers": router.spillovers,
        "reroutes": router.reroutes,
        "decisions": len(router.decisions()),
        "fold_depth_histogram": status["foldDepthHistogram"],
        "crash": {
            "victims": len(crash["victims"]),
            "rerouted": len(crash["rerouted"]),
            "stranded": len(crash["stranded"]),
        }
        if regions > 1
        else None,
        "wall_s": round(_time.perf_counter() - t0, 3),
    }
