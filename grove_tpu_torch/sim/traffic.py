"""Seeded serving traffic generator: the workload the SLO observatory
measures against.

Counterpart of ``grove_tpu/sim/traffic.py``. One prefill/decode fleet per
tenant behind a router clique, driven by a demand model generated
deterministically from one seed on the virtual clock (the module reads no
wall clock, not even ``perf_counter``: a traffic trace replays bit for
bit):

- **diurnal wave**: demand follows a day/night sine (period, amplitude and
  per-tenant phase from the seed);
- **flash crowds**: a seeded schedule of step surges (start, duration,
  magnitude), the tail events autoscaling must absorb;
- **tenant skew**: per-tenant Zipf-ish weights, so one tenant dominates
  while the tail trickles;
- **prefill:decode ratio drift**: the share of demand landing on the
  prefill against the decode scaling group drifts sinusoidally.

:class:`ServingScenario` applies one prefill/decode-shaped PodCliqueSet per
tenant (two PodCliqueScalingGroups with HPA scale configs and a fixed
router clique), then drives the HPA loop each step: demand, observed
utilization per scaling group, ``autoscale/hpa.py`` walks replicas, scaled
PodGangs materialize and the gang solver admits them on ``device`` (the
card unless the caller passes ``device="cpu"``). It measures the serving
signals the SLO layer judges: scale-up latency (HPA bump to gang Ready,
virtual seconds), time under min replicas and the per-target demand trace.
``faults`` is a seeded ``(vt, callable)`` schedule, so node loss and drains
land mid-flash-crowd. ``serving_artifact`` is one such day with the
observatory armed; its one wall-clock output, ``admission_p99_s`` /
``p99_lt_1s``, comes from the metrics registry's admission histogram.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from grove_tpu_torch.api import names as namegen
from grove_tpu_torch.api.load import load_podcliquesets
from grove_tpu_torch.api.pod import is_ready
from grove_tpu_torch.observability.metrics import METRICS, _quantile
from grove_tpu_torch.observability.timeseries import (
    SERIES_SCALEUP_LATENCY,
    TIMESERIES,
)

_SERVING_YAML = """
apiVersion: grove.io/v1alpha1
kind: PodCliqueSet
metadata:
  name: placeholder
spec:
  replicas: 1
  template:
    cliques:
      - name: router
        spec:
          roleName: role-router
          replicas: 1
          podSpec:
            containers:
              - name: router
                image: busybox:stable
                resources:
                  requests:
                    cpu: 250m
      - name: prefill
        spec:
          roleName: role-prefill
          replicas: 1
          podSpec:
            containers:
              - name: prefill
                image: busybox:stable
                resources:
                  requests:
                    cpu: 1
      - name: decode
        spec:
          roleName: role-decode
          replicas: 1
          podSpec:
            containers:
              - name: decode
                image: busybox:stable
                resources:
                  requests:
                    cpu: 500m
    podCliqueScalingGroups:
      - name: prefill
        cliqueNames:
          - prefill
        scaleConfig:
          maxReplicas: {max_prefill}
          metrics:
            - type: Resource
              resource:
                name: cpu
                target:
                  type: Utilization
                  averageUtilization: 80
      - name: decode
        cliqueNames:
          - decode
        scaleConfig:
          maxReplicas: {max_decode}
          metrics:
            - type: Resource
              resource:
                name: cpu
                target:
                  type: Utilization
                  averageUtilization: 80
"""


# nodes the composed chaos fault takes down mid-flash-crowd (and the
# node-axis delta the solver warm-up runs first: N and N-FAULT_NODES)
FAULT_NODES = 3


# the warm-up gang: the same 1-pod/1-group shape a scaled prefill/decode
# replica arrives as (shapes, not request values, set what a first solve
# pays for)
_WARM_YAML = """
apiVersion: grove.io/v1alpha1
kind: PodCliqueSet
metadata:
  name: placeholder
spec:
  replicas: 1
  template:
    cliques:
      - name: w
        spec:
          roleName: role-w
          replicas: 1
          podSpec:
            containers:
              - name: w
                image: busybox:stable
                resources:
                  requests:
                    cpu: 500m
"""


@dataclass
class FlashCrowd:
    start: float
    duration: float
    magnitude: float  # multiplier on top of the diurnal demand

    def active(self, t: float) -> bool:
        return self.start <= t < self.start + self.duration


class TrafficModel:
    """Pure demand function ``demand(t)`` — seeded at construction, then
    deterministic in virtual time. Units are *replica-equivalents*: a
    demand of 3.0 on a scaling group means three replicas' worth of work
    is arriving.

    ``phase_offset`` shifts the whole model along the virtual-time axis
    (the federation tier's per-REGION diurnal offset — each cluster's
    load peaks at a different virtual hour, so follow-the-sun spillover
    is directly benchable): ``TrafficModel(..., phase_offset=dx)`` at
    ``t`` equals the unshifted model at ``t + dx`` exactly, including
    flash crowds, and the seeded construction draws are untouched by
    the offset (same seed ⇒ same weights/phases/crowds at any offset).
    """

    def __init__(
        self,
        seed: int,
        tenants: List[str],
        base: float = 3.0,
        amplitude: float = 0.6,
        period: float = 600.0,
        skew: float = 1.0,
        flash_crowds: int = 2,
        flash_magnitude: float = 3.0,
        flash_duration: float = 90.0,
        ratio: float = 0.55,
        ratio_drift: float = 0.25,
        horizon: float = 1800.0,
        phase_offset: float = 0.0,
    ) -> None:
        rng = random.Random(seed)
        self.tenants = list(tenants)
        self.base = base
        self.amplitude = amplitude
        self.period = period
        self.ratio = ratio
        self.ratio_drift = ratio_drift
        self.horizon = horizon
        self.phase_offset = phase_offset
        # tenant skew: Zipf-ish 1/(rank+1)^skew weights, rank order seeded
        ranks = list(range(len(self.tenants)))
        rng.shuffle(ranks)
        raw = [1.0 / (r + 1.0) ** skew for r in ranks]
        total = sum(raw)
        self.weights = {
            tenant: w / total for tenant, w in zip(self.tenants, raw)
        }
        # per-tenant diurnal phase offsets (staggered peaks)
        self.phases = {
            tenant: rng.uniform(0.0, period) for tenant in self.tenants
        }
        # flash-crowd schedule: seeded starts in the middle 80% of the
        # horizon so surges land on a warmed-up system
        self.crowds = sorted(
            (
                FlashCrowd(
                    start=rng.uniform(0.1 * horizon, 0.9 * horizon),
                    duration=flash_duration * rng.uniform(0.7, 1.3),
                    magnitude=flash_magnitude * rng.uniform(0.8, 1.2),
                )
                for _ in range(flash_crowds)
            ),
            key=lambda c: c.start,
        )

    def flash_multiplier(self, t: float) -> float:
        t = t + self.phase_offset
        m = 1.0
        for crowd in self.crowds:
            if crowd.active(t):
                m = max(m, crowd.magnitude)
        return m

    def prefill_share(self, t: float) -> float:
        """Share of demand landing on prefill at ``t`` (drifts in
        [ratio - drift/2, ratio + drift/2], clamped to (0.05, 0.95))."""
        share = self.ratio + 0.5 * self.ratio_drift * math.sin(
            2.0 * math.pi * (t + self.phase_offset) / (self.period * 1.7)
        )
        return min(0.95, max(0.05, share))

    def demand(self, t: float) -> Dict[str, Dict[str, float]]:
        """tenant -> {"prefill": d, "decode": d} replica-equivalents."""
        # flash_multiplier/prefill_share apply the region offset
        # internally — pass raw t so the shift lands exactly once
        flash = self.flash_multiplier(t)
        local = t + self.phase_offset
        out: Dict[str, Dict[str, float]] = {}
        n = max(1, len(self.tenants))
        for tenant in self.tenants:
            wave = 1.0 + self.amplitude * math.sin(
                2.0 * math.pi * (local + self.phases[tenant]) / self.period
            )
            total = self.base * n * self.weights[tenant] * wave * flash
            share = self.prefill_share(t)
            out[tenant] = {
                "prefill": total * share,
                "decode": total * (1.0 - share),
            }
        return out


class ServingScenario:
    """One prefill/decode serving fleet under generated traffic.

    ``step(dt)`` advances one observation interval: demand at the current
    RUN-RELATIVE virtual time (t=0 is the first step — warm-up and fleet
    construction burn virtual seconds that must not consume the traffic
    model's horizon) becomes observed utilization on each scaling group's
    HPA, due faults fire (``faults`` schedule times are run-relative
    too), and the harness converges (the observatory samples at its tick
    boundaries). Scale-up latency and time-under-min-replicas are
    measured here because only the scenario knows when a scale decision
    happened."""

    def __init__(
        self,
        seed: int = 2026,
        tenants: int = 3,
        num_nodes: int = 24,
        max_prefill: int = 12,
        max_decode: int = 12,
        model: Optional[TrafficModel] = None,
        harness=None,
        faults: Optional[List[Tuple[float, Callable[[], None]]]] = None,
        warm: bool = True,
        device=None,
    ) -> None:
        from grove_tpu_torch.sim.harness import SimHarness

        self.tenant_names = [f"tenant-{i}" for i in range(tenants)]
        self.model = model or TrafficModel(seed, self.tenant_names)
        self.harness = harness or SimHarness(num_nodes=num_nodes, device=device)
        self.faults = sorted(faults or [], key=lambda f: f[0])
        self._fired = 0
        self.t0: Optional[float] = None  # set by the first step()
        self.scale_ups = 0
        self.scale_downs = 0
        self.time_under_min = 0.0  # virtual seconds any group sat < min
        self.scaleup_samples: List[float] = []
        self._pending_scaleups: Dict[Tuple[str, str], Tuple[float, int]] = {}
        yaml = _SERVING_YAML.format(
            max_prefill=max_prefill, max_decode=max_decode
        )
        for tenant in self.tenant_names:
            pcs = load_podcliquesets(yaml)[0]
            pcs.metadata.name = "serve"
            pcs.metadata.namespace = tenant
            pcs.metadata.labels[namegen.LABEL_QUEUE] = tenant
            self.harness.apply(pcs)
        self.harness.converge(max_ticks=120)
        if warm:
            self._warm_solver()
        # any scale decisions during warm-up are not serving signal
        self.harness.autoscaler.scale_log.clear()

    def _warm_solver(self) -> None:
        """Run the solve shapes the traffic will hit once before measuring:
        the first solve of a shape pays the kernel build and load and the
        allocator's first requests, and an admission-latency measurement
        that bills those to one arbitrary mid-flash-crowd journey is
        measuring process warm-up, not the serving path. Scale-up bursts arrive as
        batches of 1-pod scaled gangs (1..~16 pending per tick), and the
        composed chaos fault shrinks the schedulable node axis by
        FAULT_NODES — so burst the gang buckets at N AND at
        N - FAULT_NODES, then delete the warm-up population."""
        h = self.harness
        yaml = _WARM_YAML
        serial = 0
        names: List[str] = []

        def burst(count: int) -> None:
            nonlocal serial
            for _ in range(count):
                pcs = load_podcliquesets(yaml)[0]
                pcs.metadata.name = f"warm-{serial:03d}"
                pcs.metadata.namespace = self.tenant_names[0]
                serial += 1
                names.append(pcs.metadata.name)
                h.apply(pcs)
            h.converge(max_ticks=60)

        # phase 1: gang buckets at full N (a flash crowd can scale every
        # group at once: tenants × 2 groups × several replicas ⇒ batches
        # past 16 pending in one tick land in the 32 bucket)
        for count in (32, 16, 8, 4, 2, 1):
            burst(count)
        # phase 2: the composed fault's shapes — REAL node crashes (the
        # rescue/requeue solve path compiles its own recovery-pin shapes,
        # which a cordon would not touch), bursts at N - FAULT_NODES,
        # then the nodes rejoin
        victims = [n.name for n in h.cluster.nodes[:FAULT_NODES]]
        for name in victims:
            h.cluster.crash_node(name)
        h.converge(max_ticks=240)
        for count in (32, 16, 8, 4, 2, 1):
            burst(count)
        for name in victims:
            h.cluster.restart_node(name)
        h.converge(max_ticks=240)
        for name in names:
            h.delete(name, self.tenant_names[0])
        names.clear()
        h.converge(max_ticks=120)

    # -- target bookkeeping ----------------------------------------------

    def _targets(self) -> List[Tuple[str, str]]:
        """(namespace, scaling-group name) for every HPA-driven group."""
        return [
            (tenant, f"serve-0-{group}")
            for tenant in self.tenant_names
            for group in ("prefill", "decode")
        ]

    def _pcsg(self, key: Tuple[str, str]):
        return self.harness.store.get(
            "PodCliqueScalingGroup", key[0], key[1], readonly=True
        )

    def _replicas(self, key: Tuple[str, str]) -> int:
        pcsg = self._pcsg(key)
        return int(pcsg.spec.replicas) if pcsg is not None else 0

    def _min_replicas(self, key: Tuple[str, str]) -> int:
        hpa = self.harness.store.get(
            "HorizontalPodAutoscaler", key[0], key[1], readonly=True
        )
        if hpa is None:
            return 1
        return int(hpa.spec.get("minReplicas") or 1)

    def _ready_replicas(self, key: Tuple[str, str]) -> int:
        ns, group = key
        pods = self.harness.store.list(
            "Pod", ns, {namegen.LABEL_PCSG: group}
        )
        return sum(1 for p in pods if is_ready(p))

    # -- driving ---------------------------------------------------------

    def step(self, dt: float = 10.0) -> None:
        """One observation interval: fire due faults, feed utilization,
        converge, account scale events and readiness."""
        now = self.harness.clock.now()
        if self.t0 is None:
            self.t0 = now
        rel = now - self.t0
        while self._fired < len(self.faults) and self.faults[self._fired][0] <= rel:
            self.faults[self._fired][1]()
            self._fired += 1
        demands = self.model.demand(rel)
        for ns, group in self._targets():
            role = "prefill" if group.endswith("prefill") else "decode"
            d = demands[ns][role]
            current = max(1, self._replicas((ns, group)))
            util = 100.0 * d / current
            self.harness.metrics_provider.set(
                "PodCliqueScalingGroup", ns, group, util
            )
            if TIMESERIES.enabled:
                TIMESERIES.gauge(f"traffic_demand/{ns}/{role}", d, vt=now)
            METRICS.set(f"traffic_demand/{ns}-{role}", d)
        self.harness.converge(max_ticks=int(dt), tick_seconds=1.0)
        end = self.harness.clock.now()
        if end - now < dt:
            self.harness.advance(dt - (end - now))
        # one guaranteed sampling round per step at the post-converge
        # instant: converge only samples while it ticks, so an idle system
        # would otherwise contribute NO "all ready" samples and every
        # windowed mean would be biased toward the scale-up dips
        if TIMESERIES.enabled:
            from grove_tpu_torch.observability.slo import SLO

            TIMESERIES.sample(self.harness.clock.now())
            SLO.evaluate(self.harness.clock.now())
        self._account(self.harness.clock.now(), max(dt, end - now))

    def _account(self, now: float, dt: float) -> None:
        """Post-converge bookkeeping: DRAIN the HPA's vt-stamped scale
        log (the decision instant survives the converge that absorbed
        it; consuming by popleft keeps the bounded deque's wraparound
        from silently skipping events a positional cursor would miss),
        complete pending scale-up latency measurements, accrue
        time-under-min."""
        log = self.harness.autoscaler.scale_log
        group_names = {g for _, g in self._targets()}
        while log:
            t_dec, kind, ns, name, previous, desired = log.popleft()
            if kind != "PodCliqueScalingGroup" or name not in group_names:
                continue
            key = (ns, name)
            if desired > previous:
                self.scale_ups += 1
                METRICS.inc("serving_scale_events_total")
                # the FIRST decision starts the clock; a further bump
                # while one is pending re-arms at the higher desired
                # count (the user experiences the full ramp)
                t0 = self._pending_scaleups.get(key, (t_dec, desired))[0]
                self._pending_scaleups[key] = (t0, desired)
            else:
                self.scale_downs += 1
                METRICS.inc("serving_scale_events_total")
                self._pending_scaleups.pop(key, None)
        for key in self._targets():
            ready = self._ready_replicas(key)
            pending = self._pending_scaleups.get(key)
            if pending is not None and ready >= pending[1]:
                latency = max(now - pending[0], 0.0)
                self.scaleup_samples.append(latency)
                self._pending_scaleups.pop(key, None)
                if TIMESERIES.enabled:
                    TIMESERIES.observe(
                        SERIES_SCALEUP_LATENCY, latency, vt=now
                    )
            if ready < self._min_replicas(key):
                self.time_under_min += dt

    def run(self, duration: float, dt: float = 10.0) -> None:
        t_end = self.harness.clock.now() + duration
        while self.harness.clock.now() < t_end:
            self.step(dt)


def default_slos() -> List[str]:
    """The standing serving objectives (grammar form — docs/observability
    "SLO observatory"): virtual-time admission p99, cluster ready
    fraction, and scale-up p99. Scaled to sim time: windows are minutes,
    not the production hours the burn-rate table documents."""
    return [
        "admission_latency_vt:p99 < 60s over 1m target 90%"
        " budget 5m burn 3x 1m/5m",
        "ready_fraction:mean >= 0.88 over 1m target 95% budget 5m"
        " burn 3x 1m/5m",
        f"{SERIES_SCALEUP_LATENCY}:p99 < 120s over 2m target 80%"
        " budget 5m burn 3x 1m/5m",
    ]


def serving_artifact(
    seed: int = 2026,
    tenants: int = 3,
    num_nodes: int = 24,
    duration: float = 1200.0,
    dt: float = 10.0,
    with_fault: bool = True,
    flightrec_dir: Optional[str] = None,
    tap: Optional[Callable[[str, int, float], None]] = None,
    device=None,
) -> dict:
    """The bench ``"serving"`` block: a seeded diurnal + flash-crowd run
    with the full observatory armed, optionally composing a node crash
    into the first flash crowd. Reports SLO attainment/budget per
    objective, scale-up latency p50/p99, time-under-min, per-tenant queue
    wait, and the steady-state admission-p99 gate evaluated through the
    flash crowd. ``device``: the card unless the caller passes ``"cpu"``;
    without one and without CUDA this raises before anything is reset."""
    from grove_tpu_torch.utils.platform import resolve_device
    from grove_tpu_torch.observability.journey import JOURNEYS
    from grove_tpu_torch.observability.slo import SLO
    from grove_tpu_torch.observability.timeseries import (
        SERIES_ADMISSION,
        SERIES_QUEUE_WAIT,
        install_serving_collector,
    )

    device = resolve_device(device)
    TIMESERIES.reset()
    SLO.reset()
    # build (and solver-warm) the fleet BEFORE arming the observatory:
    # the measured window must start after the warm-up absorbed the first
    # solves of each shape, or the admission p99 reports process warm-up. The traffic model's horizon is the RUN
    # duration (step() drives it in run-relative time), so the seeded
    # flash-crowd schedule always lands inside the measured window.
    model = TrafficModel(
        seed, [f"tenant-{i}" for i in range(tenants)], horizon=duration
    )
    scenario = ServingScenario(
        seed=seed, tenants=tenants, num_nodes=num_nodes, model=model,
        device=device,
    )
    h = scenario.harness
    JOURNEYS.enable()
    JOURNEYS.reset()
    TIMESERIES.enable(clock=h.clock)
    TIMESERIES.tap = tap
    SLO.enable()
    JOURNEYS.clock = h.clock
    collector = install_serving_collector(
        h.store, scheduler=h.scheduler, clock=h.clock
    )
    if flightrec_dir is not None:
        from grove_tpu_torch.observability.flightrec import FLIGHTREC

        FLIGHTREC.enable(out_dir=flightrec_dir, clock=h.clock)
    for text in default_slos():
        SLO.add(text)
    if with_fault and scenario.model.crowds:
        # FAULT_NODES nodes die right as the first flash crowd peaks —
        # capacity squeeze mid-surge, the everything-at-once shape the
        # serving day is built around; they rejoin when the crowd passes
        crowd = scenario.model.crowds[0]
        victims = [n.name for n in h.cluster.nodes[:FAULT_NODES]]

        def _crash() -> None:
            for name in victims:
                h.cluster.crash_node(name)

        def _restore() -> None:
            for name in victims:
                h.cluster.restart_node(name)

        scenario.faults = [
            (crowd.start + 5.0, _crash),
            (crowd.start + crowd.duration, _restore),
        ]
    scenario.run(duration, dt=dt)
    status = SLO.status()
    admission = TIMESERIES.window(SERIES_ADMISSION, duration)
    scaleups = sorted(scenario.scaleup_samples)
    queue_wait = {}
    for tenant in scenario.tenant_names:
        doc = TIMESERIES.window(f"{SERIES_QUEUE_WAIT}/{tenant}", duration)
        if doc.get("n"):
            queue_wait[tenant] = {
                "mean_s": round(doc["mean"], 3),
                "max_s": round(doc["max"], 3),
            }
    objectives = {
        row["name"]: {
            "attainment": row["attainment"],
            "budget_remaining": row["budget_remaining"],
            "state": row["state"],
            "breaches": row["breaches"],
            "recoveries": row["recoveries"],
        }
        for row in status["objectives"]
    }
    p99_wall = admission.get("p99", 0.0) if admission.get("count") else 0.0
    doc = {
        "seed": seed,
        "tenants": tenants,
        "duration_vt_s": duration,
        "flash_crowds": len(scenario.model.crowds),
        "fault_injected": bool(with_fault and scenario.model.crowds),
        "objectives": objectives,
        "breaches": sum(o["breaches"] for o in objectives.values()),
        "recoveries": sum(o["recoveries"] for o in objectives.values()),
        "scale_ups": scenario.scale_ups,
        "scale_downs": scenario.scale_downs,
        "scaleup_latency_vt": {
            # the repo's one quantile index rule (metrics._quantile) — the
            # block's p99 must agree with the SLO objective judging the
            # same series
            "n": len(scaleups),
            "p50_s": round(_quantile(scaleups, 0.5), 3) if scaleups else 0.0,
            "p99_s": round(_quantile(scaleups, 0.99), 3) if scaleups else 0.0,
        },
        "time_under_min_vt_s": round(scenario.time_under_min, 1),
        "queue_wait_vt": queue_wait,
        "admission_p99_s": round(p99_wall, 6),
        # the serving gate: steady-state churn admission p99
        # stays under 1 s (wall) THROUGH the flash crowd + fault
        "p99_lt_1s": bool(p99_wall < 1.0),
    }
    if flightrec_dir is not None:
        from grove_tpu_torch.observability.flightrec import FLIGHTREC

        doc["flight_bundles"] = list(FLIGHTREC.dumps)
    SLO.disable()
    TIMESERIES.disable()
    TIMESERIES.tap = None
    # the collector's closure pins the whole scenario harness — a stale
    # one firing on a later re-enable would feed a dead store's gauges
    TIMESERIES.remove_collector(collector)
    JOURNEYS.disable()
    return doc
