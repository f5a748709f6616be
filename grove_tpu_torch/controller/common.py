"""Shared controller machinery: the operator context and the component
protocol.

Counterpart of ``grove_tpu/controller/common.py``: each reconciler iterates an
ordered list of components, each owning one child kind with sync/delete, and
the helpers they share (the desired-child memo, Events, status writes,
adoption, topology translation, startup dependencies, the rolling update's
template push).
"""

from __future__ import annotations

import threading
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol

from grove_tpu_torch.api import names as namegen
from grove_tpu_torch.api.topology import ClusterTopology
from grove_tpu_torch.api.types import (
    PodCliqueScalingGroupConfig,
    PodCliqueSet,
    SchedTopologyConstraint,
    TopologyPackConstraint,
)
from grove_tpu_torch.runtime.clock import Clock
from grove_tpu_torch.runtime.expectations import ExpectationsStore
from grove_tpu_torch.runtime.store import Store

FINALIZER = "grove.io/operator"

# the live OperatorContexts: a forked worker process (runtime/procworkers.py)
# inherits every context's ``_event_seq``, so each child moves its contexts
# into an Event-name range of its own (``rebase_event_sequences``). Weak
# values (a context dies with its harness), keyed by a registration count so
# the order is the same in a forked child.
_LIVE_CONTEXTS: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()
_CTX_SEQ = 0

# spacing between the per-slot Event name ranges, far above any run's Event
# count (the ring keeps 1,000 live Events)
EVENT_SEQ_STRIDE = 10_000_000


def live_contexts() -> List["OperatorContext"]:
    return [ctx for _, ctx in sorted(_LIVE_CONTEXTS.items())]


def contexts_of_store(store) -> List["OperatorContext"]:
    """The live contexts operating ``store``, in registration order (how
    the process drain finds the expectations of the engine it drains)."""
    return [ctx for ctx in live_contexts() if ctx.store is store]


def rebase_event_sequences(slot: int) -> None:
    """Move every live context's Event sequence into the range ``slot``
    owns (slot 0, the coordinator, keeps the natural one). A freshly forked
    worker calls it once before it reconciles: ``slot`` is unique per
    (fork generation, worker), since an earlier generation's Events live on
    in the inherited store."""
    if slot <= 0:
        return
    for ctx in live_contexts():
        with ctx._event_lock:
            ctx._event_seq += slot * EVENT_SEQ_STRIDE


# eq=False: keep identity __eq__/__hash__ (a value-eq dataclass is
# unhashable, and the weak registry holds instances)
@dataclass(eq=False)
class OperatorContext:
    """Everything a component needs (the reference passes client/scheme/
    eventRecorder; we pass the store + clock + topology + expectations)."""

    store: Store
    clock: Clock
    topology: Optional[ClusterTopology] = None
    # disruption broker (grove_tpu/disruption): the rolling-update flow
    # asks it before taking a replica's gangs down; None (bare tests) or an
    # un-armed broker (no budgets/drains) allows everything untouched
    disruption: Optional[object] = None
    pod_expectations: ExpectationsStore = field(
        default_factory=lambda: ExpectationsStore("pod")
    )
    events: List[str] = field(default_factory=list)
    _event_seq: int = 0
    # sequence + memo guards: reconciles run on parallel worker threads
    # under the thread drain (runtime/workers.py) — a bare
    # `_event_seq += 1` is a read-modify-write race there, and two workers
    # building the same desired-memo key must not interleave the eviction
    # scan. Uncontended lock acquires are the only serial-path cost.
    _event_lock: object = field(default_factory=threading.Lock)
    _memo_lock: object = field(default_factory=threading.Lock)
    max_events: int = 1000  # ring buffer (k8s Events have a TTL; we cap)
    # desired-child memo: the EXPECTED PodCliques/PCSGs of a set are a pure
    # function of (pcs uid, generation) — rebuilding the label dicts /
    # startup-dep JSON / template hashes on every reconcile was a flat
    # per-reconcile component-rebuild cost. Entries are reused READ-ONLY
    # (create_or_adopt only reads; Store.create commits a private copy).
    _desired_memo: Dict[tuple, object] = field(default_factory=dict)
    # sized above the live population at stress scale (10,240 sets × 2
    # entries each) so steady state never evicts a live key
    _desired_memo_max: int = 65536

    def __post_init__(self) -> None:
        global _CTX_SEQ
        _CTX_SEQ += 1
        _LIVE_CONTEXTS[_CTX_SEQ] = self

    def desired_cache(self, key: tuple, build):
        """Memoized desired-children build for `key` (kind, uid, generation).
        A generation bump changes the key; stale generations age out LRU
        (hits move to the end, so insertion order is recency). The lock
        covers the hit-bump and the eviction scan — worker threads from
        the parallel drain share this memo; `build()` runs outside it (a
        racing duplicate build is benign, a torn eviction scan is not)."""
        with self._memo_lock:
            hit = self._desired_memo.pop(key, None)
            if hit is not None:
                self._desired_memo[key] = hit
                return hit
            if len(self._desired_memo) >= self._desired_memo_max:
                # drop the least-recently-used quarter
                for stale in list(self._desired_memo)[
                    : self._desired_memo_max // 4
                ]:
                    self._desired_memo.pop(stale, None)
        value = build()
        with self._memo_lock:
            self._desired_memo[key] = value
        return value

    def record_event(
        self,
        kind: str,
        reason: str,
        message: str,
        namespace: str = "default",
        name: Optional[str] = None,
        type: str = "Normal",
    ) -> None:
        """k8s-Event equivalent: kept as a readable log AND materialized as an
        Event object in the store (the reference emits corev1 Events on every
        important transition — SURVEY §5). Capped as a ring buffer so long
        sims don't accumulate unbounded Event objects.

        Also forwarded to the process-global deduping EventRecorder
        (observability/events.py) — the view `GET /events` serves. Most call
        sites pass the object name as the message; `name` defaults to it so
        dedup identity works without touching every site."""
        from grove_tpu_torch.observability.events import EVENTS

        EVENTS.record((kind, namespace, name or message), type, reason, message)
        self.events.append(f"{kind} {reason}: {message}")
        from grove_tpu_torch.api.meta import ObjectMeta
        from grove_tpu_torch.api.types import GenericObject

        # atomic sequence allocation: parallel reconcile workers may
        # record events concurrently; a torn
        # read-modify-write here would collide two evt-N names and
        # silently drop one best-effort Event (and its rv bump) —
        # breaking the serial-twin commit-count equality
        with self._event_lock:
            self._event_seq += 1
            seq = self._event_seq
        try:
            self.store.create(
                GenericObject(
                    kind="Event",
                    metadata=ObjectMeta(name=f"evt-{seq}"),
                    spec={
                        "involvedKind": kind,
                        "reason": reason,
                        "message": message,
                        "timestamp": self.clock.now(),
                    },
                ),
                consume=True,  # fire-and-forget: no private pickled copy
            )
        except Exception:
            pass  # events are best-effort (conflict on replayed names etc.)
        expired = seq - self.max_events
        if expired > 0:
            try:
                self.store.delete("Event", "default", f"evt-{expired}")
            except Exception:
                pass


class Component(Protocol):
    kind: str

    def sync(self, ctx: OperatorContext, owner) -> None: ...

    def delete(self, ctx: OperatorContext, owner) -> None: ...


def shared_template_spec(spec):
    """Embed a PCS TEMPLATE spec into an EXPECTED child object WITHOUT
    copying. The template usually comes from a zero-copy readonly PCS view,
    so the returned spec ALIASES committed store state: the expected object
    may only flow into [create_or_adopt]/[Store.create] (both copy-on-
    write); never mutate it. One helper so the invariant has one home
    instead of per-call-site comments."""
    return spec


def status_shadow(view):
    """Shadow object over a zero-copy readonly store view: SHARES metadata
    and spec (read-only by the scan/readonly contract) with a PRIVATE
    status clone, so a mutating status flow can run against it without
    touching committed store state. The one sanctioned way to do this —
    pair with [write_status_if_changed] for the write side. The clone is
    condition-aware-shallow (api/meta.clone_status): status flows only
    assign fields or set_condition."""
    from grove_tpu_torch.api.meta import clone_status

    return type(view)(
        metadata=view.metadata,
        spec=view.spec,
        status=clone_status(view.status),
    )


def write_status_if_changed(
    ctx: OperatorContext, kind: str, namespace: str, name: str, status
) -> bool:
    """Write `status` only when it differs from the live object's status.

    The shared tail of every status flow: reconcilers compute the proposed
    status on a zero-copy readonly view (no serialization), and this helper
    owns the compare / mutable re-get / liveness re-check / write — one
    place to fix, three reconcilers using it. Steady-state (unchanged)
    reconciles return without touching the store. Returns True on write.
    """
    from grove_tpu_torch.runtime.store import commit_status

    view = ctx.store.get(kind, namespace, name, readonly=True)
    if view is None or view.metadata.deletion_timestamp is not None:
        return False
    if status == view.status:
        return False
    # copy-on-write commit: the new committed object shares metadata/spec
    # with `view` and takes `status` (the caller's private shadow copy) —
    # no mutable re-get, no pickling (HttpStore falls back internally)
    return commit_status(ctx.store, view, status) is not None


def record_last_error(
    ctx: OperatorContext, kind: str, namespace: str, name: str, err
) -> None:
    """Persist a typed error on the object's status (errors.go:88-103
    LastErrors). Skips the write when the same code+description is already
    recorded — a timestamp-only rewrite would emit a self-watch event and
    defeat the workqueue's backoff with an immediate re-reconcile."""
    view = ctx.store.get(kind, namespace, name, readonly=True)
    if view is None:
        return
    entry = {
        "code": err.code,
        "description": str(err),
        "observedAt": ctx.clock.now(),
    }
    existing = view.status.last_errors
    if existing and all(
        existing[0].get(k) == entry[k] for k in ("code", "description")
    ):
        return
    fresh = ctx.store.get(kind, namespace, name)  # mutable copy for the write
    if fresh is None:
        return
    fresh.status.last_errors = [entry]
    try:
        ctx.store.update_status(fresh)
    except Exception:
        pass  # a failing status write must not mask the original error


def create_or_adopt(ctx: OperatorContext, desired) -> None:
    """Create the child if missing; otherwise adopt label/annotation drift.

    Spec is NOT adopted (it is owned by the child's own controller / HPA),
    and neither is the pod-template-hash label: the hash only moves together
    with a spec push during a rolling update (the replica-by-replica
    orchestrator does both atomically) — otherwise pods would be replaced
    against the old spec.
    """
    ns = desired.metadata.namespace
    # readonly view for the steady-state no-drift comparison; re-get a
    # mutable copy only when adoption actually writes
    current = ctx.store.get(desired.kind, ns, desired.metadata.name, readonly=True)
    if current is None:
        # share=True: `desired` may be a memoized desired-state object
        # (desired_cache) reused read-only by later reconciles — the store
        # commits a private-spined copy and never stamps identity back
        ctx.store.create(desired, share=True)
        return
    if current.metadata.deletion_timestamp is not None:
        return
    from grove_tpu_torch.controller.podclique.status import UPDATE_IN_PROGRESS_ANNOTATION

    want_labels = dict(desired.metadata.labels)
    cur_hash = current.metadata.labels.get(namegen.LABEL_POD_TEMPLATE_HASH)
    if cur_hash is not None:
        want_labels[namegen.LABEL_POD_TEMPLATE_HASH] = cur_hash
    want_annotations = dict(desired.metadata.annotations)
    # the update-in-progress marker is owned by the rolling updater too
    if UPDATE_IN_PROGRESS_ANNOTATION in current.metadata.annotations:
        want_annotations[UPDATE_IN_PROGRESS_ANNOTATION] = (
            current.metadata.annotations[UPDATE_IN_PROGRESS_ANNOTATION]
        )
    if (
        current.metadata.labels != want_labels
        or current.metadata.annotations != want_annotations
    ):
        current = ctx.store.get(desired.kind, ns, desired.metadata.name)
        current.metadata.labels = want_labels
        current.metadata.annotations = want_annotations
        ctx.store.update(current, bump_generation=False)


def find_scaling_group_config_for_clique(
    configs: List[PodCliqueScalingGroupConfig], clique_name: str
) -> Optional[PodCliqueScalingGroupConfig]:
    """component/utils FindScalingGroupConfigForClique."""
    for cfg in configs:
        if clique_name in cfg.clique_names:
            return cfg
    return None


def translate_topology_constraint(
    tc, topology: Optional[ClusterTopology]
) -> Optional[SchedTopologyConstraint]:
    """Operator-side level *name* → scheduler-side topology *key* translation
    (docs/designs/topology.md:541-616): the user's packDomain becomes the
    `required` key; the topology's narrowest level becomes the auto-generated
    `preferred` key; spreadDomain becomes a TopologySpreadConstraint.

    Memoized per topology INSTANCE keyed by the four translated fields: the
    translation is a pure function of (those fields, topology levels), and
    the gang sync re-runs it for every PodGroup of every reconcile — at
    stress scale the same handful of template shapes translate millions of
    times. The shared result is immutable by the committed-object contract."""
    if tc is None or topology is None:
        return None
    memo_key = (
        tc.pack_domain,
        tc.spread_domain,
        tc.spread_min_domains,
        tc.spread_when_unsatisfiable,
    )
    memo = getattr(topology, "_translate_memo", None)
    if memo is None:
        memo = {}
        object.__setattr__(topology, "_translate_memo", memo)
    if memo_key in memo:
        return memo[memo_key]
    pack = spread = None
    if tc.pack_domain is not None:
        pack = TopologyPackConstraint(
            required=topology.translate_pack_domain(tc.pack_domain),
            preferred=topology.narrowest_key(),
        )
    if tc.spread_domain is not None:
        from grove_tpu_torch.api.types import (
            SPREAD_DO_NOT_SCHEDULE,
            TopologySpreadConstraint,
        )

        spread = TopologySpreadConstraint(
            topology_key=topology.translate_pack_domain(tc.spread_domain),
            min_domains=tc.spread_min_domains or 2,
            when_unsatisfiable=(
                tc.spread_when_unsatisfiable or SPREAD_DO_NOT_SCHEDULE
            ),
        )
    result = (
        None
        if pack is None and spread is None
        else SchedTopologyConstraint(pack_constraint=pack, spread_constraint=spread)
    )
    memo[memo_key] = result
    return result


def pcs_child_selector(pcs_name: str) -> Dict[str, str]:
    return dict(namegen.default_labels(pcs_name))


def resolve_starts_after(
    pcs: PodCliqueSet,
    pcs_replica: int,
    clique_name: str,
    owner_pcsg_fqn: Optional[str] = None,
    owner_pcsg_replica: Optional[int] = None,
) -> List[Dict[str, object]]:
    """Resolve startup dependencies to (parent PCLQ FQN, minAvailable) pairs —
    the grove-initc contract (`--podcliques=<fqn>:<minAvailable>`,
    reference initc/cmd/opts/options.go; FQN resolution
    pcsg components/podclique/podclique.go:349-409).

    - InOrder: the dependency chain is the template clique order.
    - Explicit: template startsAfter names.
    - A dependency inside the *same* scaling-group replica resolves to that
      replica's sibling PCLQ; a standalone dependency resolves to the PCS
      replica's PCLQ; a dependency on another scaling group's clique resolves
      to that group's base replicas (0..minAvailable-1).
    """
    from grove_tpu_torch.api.types import STARTUP_EXPLICIT, STARTUP_IN_ORDER

    tmpl = pcs.spec.template
    startup = tmpl.startup_type
    dep_names: List[str] = []
    if startup == STARTUP_IN_ORDER:
        clique_order = [c.name for c in tmpl.cliques]
        idx = clique_order.index(clique_name)
        if idx > 0:
            dep_names = [clique_order[idx - 1]]
    elif startup == STARTUP_EXPLICIT:
        clique = tmpl.clique_template(clique_name)
        dep_names = list(clique.spec.starts_after) if clique else []

    out: List[Dict[str, object]] = []
    for dep in dep_names:
        dep_template = tmpl.clique_template(dep)
        if dep_template is None:
            continue
        dep_min_available = dep_template.spec.min_available or 1
        dep_sg = find_scaling_group_config_for_clique(
            tmpl.pod_clique_scaling_group_configs, dep
        )
        if dep_sg is None:
            fqn = namegen.podclique_name(pcs.metadata.name, pcs_replica, dep)
            out.append({"pclq": fqn, "min_available": dep_min_available})
        elif (
            owner_pcsg_fqn is not None
            and owner_pcsg_replica is not None
            and clique_name in dep_sg.clique_names
        ):
            # same-group sibling within the same PCSG replica
            fqn = namegen.podclique_name(owner_pcsg_fqn, owner_pcsg_replica, dep)
            out.append({"pclq": fqn, "min_available": dep_min_available})
        else:
            # another scaling group: wait on its base replicas
            dep_sg_fqn = namegen.pcsg_name(pcs.metadata.name, pcs_replica, dep_sg.name)
            for r in range(dep_sg.min_available or 1):
                fqn = namegen.podclique_name(dep_sg_fqn, r, dep)
                out.append({"pclq": fqn, "min_available": dep_min_available})
    return out


def apply_template_to_pclq(ctx: OperatorContext, pcs, pclq, clique_name: str) -> bool:
    """Push the PCS template's current spec + pod-template-hash (+ the
    update-in-progress marker that suspends MinAvailableBreached) onto one
    PodClique — the single write both rolling-update orchestrators share
    (PCS replica updater for standalone cliques, PCSG updater for its own
    replicas). Returns True when a write happened."""
    import json as _json

    from grove_tpu_torch.api.hashing import pod_template_hash_for
    from grove_tpu_torch.api.meta import deep_copy
    from grove_tpu_torch.controller.podclique.pods import STARTUP_DEPS_ANNOTATION
    from grove_tpu_torch.controller.podclique.status import (
        UPDATE_IN_PROGRESS_ANNOTATION,
    )

    tmpl_root = pcs.spec.template
    tmpl = tmpl_root.clique_template(clique_name)
    if tmpl is None or pclq.metadata.deletion_timestamp is not None:
        return False
    want_hash = pod_template_hash_for(pcs, clique_name)
    changed = False
    if pclq.metadata.labels.get(namegen.LABEL_POD_TEMPLATE_HASH) != want_hash:
        new_spec = deep_copy(tmpl.spec)
        # preserve HPA-scaled replica counts on standalone cliques
        sg = find_scaling_group_config_for_clique(
            tmpl_root.pod_clique_scaling_group_configs, clique_name
        )
        if sg is None and pclq.spec.auto_scaling_config is not None:
            new_spec.replicas = pclq.spec.replicas
        pclq.spec = new_spec
        pclq.metadata.labels[namegen.LABEL_POD_TEMPLATE_HASH] = want_hash
        pcsg_fqn = pclq.metadata.labels.get(namegen.LABEL_PCSG)
        pcs_replica = int(
            pclq.metadata.labels.get(namegen.LABEL_PCS_REPLICA_INDEX, "0")
        )
        sg_replica = pclq.metadata.labels.get(namegen.LABEL_PCSG_REPLICA_INDEX)
        deps = resolve_starts_after(
            pcs,
            pcs_replica,
            clique_name,
            owner_pcsg_fqn=pcsg_fqn,
            owner_pcsg_replica=int(sg_replica) if sg_replica is not None else None,
        )
        if deps:
            pclq.metadata.annotations[STARTUP_DEPS_ANNOTATION] = _json.dumps(deps)
        else:
            pclq.metadata.annotations.pop(STARTUP_DEPS_ANNOTATION, None)
        changed = True
    if UPDATE_IN_PROGRESS_ANNOTATION not in pclq.metadata.annotations:
        pclq.metadata.annotations[UPDATE_IN_PROGRESS_ANNOTATION] = "true"
        changed = True
    if changed:
        ctx.store.update(pclq)
    return changed
