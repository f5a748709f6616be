"""Partitioned solver frontier: the pending gangs solved as per-slab
subproblems, stacked into batched wave dispatches.

Counterpart of ``grove_tpu/solver/frontier.py``. The cluster is cut into
the slabs of the broadest topology level with two or more domains (each a
contiguous node range of the delta state's ``NodeEncoding``); each pending
gang goes to one slab, or to the residual:

- **Assignment** (host, deterministic, capacity-aware): a gang whose
  recovery pins or spread survivors resolve inside one slab is forced
  there; a gang whose pins span slabs, with a spread constraint, preferring
  a level broader than the slab level, demanding a resource no node has,
  or fitting no slab's remaining free capacity goes to the residual; every
  other gang goes to the feasible slab with the most headroom, whose
  remaining capacity is then debited by the gang's demand.
- **Independence**: a subproblem holds only its slab's nodes and gangs, so
  solving the subproblems together composes to solving them one by one.
  The residual pass then runs the leftover gangs, and every gang a slab
  rejected, through the global ``solve_waves`` against the capacity the
  slabs left, in their DRF order.
- **Batched execution**: subproblems of one padded (gang, node) shape are
  stacked on a lane axis, and each (wave, chunk) of the stack is one
  ``kernel.solve_waves_stacked`` dispatch (a ``torch.func.vmap`` of the
  wave core; the fill kernel runs once per fill for every lane). The host
  encode of bucket k+1 overlaps the device's bucket k through a one-worker
  thread; after the last bucket the host encodes the residual's gangs
  instead.

``GangScheduler.frontier_selfcheck`` re-solves every subproblem alone
through ``solve_waves``, recomposes them in order and asserts the batched
composite equal bit for bit: admissions, placements, scores and
allocations. A tick with one slab, or with every gang residual, returns
None and the caller runs the global solve.

The JAX module's journey stamp (``JOURNEYS.note_partition``) is not
ported: the port has no gang journeys.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from grove_tpu_torch.observability.metrics import METRICS
from grove_tpu_torch.observability.tracing import TRACER
from grove_tpu_torch.solver.encode import (
    _assemble_problem,
    _next_pow2,
    build_problem_cached,
    encode_gangs,
    level_index_for_key,
    slice_encoding,
)
from grove_tpu_torch.solver.kernel import solve_waves, solve_waves_stacked
from grove_tpu_torch.solver.types import PackingResult

# subproblems are small (a slab's worth of gangs): their gang axis pads to
# powers of two from this floor, not from the global solve's 32
MIN_SUB_GANG_BUCKET = 8
RESIDUAL = -1

_RESULT_FIELDS = ("admitted", "placed", "score", "chosen_level", "alloc")


def frontier_devices() -> list:
    """Devices the stacked lanes spread over: ``GROVE_TPU_FRONTIER_DEVICES=N``
    takes cards ``cuda:0`` .. ``cuda:N-1``, ``all`` every card. The default
    (unset, 0 or 1, or fewer than two cards) is ``[None]``: every stack on
    the scheduler's own device."""
    raw = os.environ.get("GROVE_TPU_FRONTIER_DEVICES", "").strip().lower()
    if raw in ("", "0", "1") or not torch.cuda.is_available():
        return [None]
    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if raw != "all":
        try:
            devs = devs[: max(int(raw), 1)]
        except ValueError:
            return [None]
    return devs if len(devs) > 1 else [None]


class FrontierPlan:
    """Partition table for one NodeEncoding: the frontier level, its
    contiguous node slabs, and the per-slab sub-encodings built on first
    use."""

    __slots__ = ("level", "starts", "ends", "num_partitions", "_sub_encodings")

    def __init__(self, level: int, starts: np.ndarray, ends: np.ndarray):
        self.level = level
        self.starts = starts  # [K] int, slab [start, end) per partition
        self.ends = ends
        self.num_partitions = len(starts)
        # (partition, pad_to) -> slice_encoding(...) result
        self._sub_encodings: Dict[Tuple[int, int], tuple] = {}

    def partition_of_node(self, idx: int) -> int:
        """Partition owning global (topology-sorted) node index `idx`."""
        return int(np.searchsorted(self.starts, idx, side="right") - 1)

    def sub_encoding(self, enc, k: int, pad_to: int) -> tuple:
        key = (k, pad_to)
        sub = self._sub_encodings.get(key)
        if sub is None:
            sub = slice_encoding(enc, int(self.starts[k]), int(self.ends[k]), pad_to)
            self._sub_encodings[key] = sub
        return sub


class FrontierState:
    """Partitioned-frontier solve state of one GangScheduler, attached by
    ``GangScheduler.enable_frontier()`` (which needs the delta state: the
    plan rides its cached NodeEncoding and maintained free matrix)."""

    def __init__(self, topology) -> None:
        self.topology = topology
        self._plan: Optional[FrontierPlan] = None
        self._plan_enc = None  # the NodeEncoding the plan was cut from
        # lifetime counters (stats())
        self.solves = 0  # partitioned solves run
        self.degenerate = 0  # ticks that went to the global path
        self.subproblems_total = 0
        self.assigned_total = 0
        self.residual_total = 0
        self.dispatches_total = 0
        self.last_subproblems = 0
        self.last_residual_fraction = 0.0
        self.last_overlap_occupancy = 0.0
        self.selfcheck_seconds = 0.0
        # fill kernel launches from inside solve_waves_stacked and the gang
        # rows they took (0 on the CPU)
        self.stacked_fill_launches = 0
        self.stacked_fill_rows = 0
        # the last solve's buckets: (g_pad, n_pad, real lanes, stacked lanes,
        # dispatches, fill launches) each
        self.last_buckets: List[tuple] = []
        # the devices stacks run on; [None] is the scheduler's own device
        self.devices = frontier_devices()
        self.last_devices_used = 1
        # the pool that runs one stack per device (multi-device runs only),
        # built once for the state's lifetime
        self._device_pool = None
        # the residual's speculative gang encode: hits reused it, misses
        # (slab rejects joined the residual) encoded again
        self.residual_overlap_hits = 0
        self.residual_overlap_misses = 0

    # -- registration API ----------------------------------------------------

    def invalidate(self) -> None:
        """Drop the plan: code that changes frontier inputs outside the
        watched channels calls this, and the next solve cuts it again."""
        self._plan = None
        self._plan_enc = None

    def close(self) -> None:
        """Release the device pool (built by multi-device runs only)."""
        if self._device_pool is not None:
            self._device_pool.shutdown(wait=False, cancel_futures=True)
            self._device_pool = None

    # -- plan ----------------------------------------------------------------

    def plan_for(self, enc) -> Optional[FrontierPlan]:
        """The partition plan of this NodeEncoding: the slabs of the broadest
        topology level with two or more domains; None when every level is
        one domain. Cached per encoding identity either way, so a
        degenerate topology is not scanned again every tick."""
        if self._plan_enc is enc:
            return self._plan
        self._plan = None
        self._plan_enc = enc
        topo = enc.topo
        if topo.size == 0:
            return None
        for level in range(topo.shape[1]):
            width = int(topo[:, level].max()) + 1
            if width >= 2:
                starts = enc.seg_starts[level, :width].astype(np.int64)
                ends = enc.seg_ends[level, :width].astype(np.int64)
                self._plan = FrontierPlan(level, starts, ends)
                return self._plan
        return None

    # -- assignment ----------------------------------------------------------

    def _pin_nodes(self, spec: dict) -> List[str]:
        pins = []
        if spec.get("gang_pinned_node"):
            pins.append(spec["gang_pinned_node"])
        for grp in spec["groups"]:
            if grp.get("pinned_node"):
                pins.append(grp["pinned_node"])
        pins.extend(spec.get("spread_survivor_nodes") or ())
        return pins

    def assign(self, plan: FrontierPlan, enc, free: np.ndarray, gang_specs: List[dict]) -> np.ndarray:
        """Deterministic gang → partition map (RESIDUAL = -1), in the
        caller's (DRF) order, over the maintained free matrix: per-partition
        free is a slab reduction, debited by each assigned gang's demand
        (float64, as the JAX package computes it)."""
        g = len(gang_specs)
        part_of = np.full((g,), RESIDUAL, dtype=np.int64)
        if g == 0:
            return part_of
        rindex = {r: j for j, r in enumerate(enc.resource_names)}
        remaining = np.add.reduceat(free, plan.starts, axis=0).astype(np.float64)
        level_keys = enc.level_keys
        for i, spec in enumerate(gang_specs):
            if spec.get("spread_key"):
                continue  # a balanced fill wants the broad view: residual
            pref = level_index_for_key(level_keys, spec.get("preferred_key"))
            if 0 <= pref < plan.level:
                continue  # prefers a domain broader than a partition
            pins = self._pin_nodes(spec)
            forced = {
                plan.partition_of_node(enc.node_index[n]) for n in pins if n in enc.node_index
            }
            if len(forced) > 1:
                continue  # survivors span partitions
            dvec = np.zeros((free.shape[1],), dtype=np.float64)
            unknown = False
            for grp in spec["groups"]:
                for r, q in grp["demand"].items():
                    j = rindex.get(r)
                    if j is None:
                        if q > 0:
                            unknown = True
                        continue
                    dvec[j] += q * grp["count"]
            if unknown:
                continue  # demands a resource no node supplies
            if forced:
                k = forced.pop()
            else:
                pos = dvec > 0
                if pos.any():
                    with np.errstate(divide="ignore"):
                        head = np.min(remaining[:, pos] / dvec[pos], axis=1)
                else:
                    head = remaining.sum(axis=1)
                k = int(np.argmax(head))
                if pos.any() and head[k] < 1.0:
                    continue  # fits no single partition: residual
            part_of[i] = k
            remaining[k] -= dvec
        return part_of

    # -- solve ---------------------------------------------------------------

    def solve(self, sched, gang_specs: List[dict], problem):
        """Partitioned solve of the tick's pending gangs. Returns a composite
        :class:`PackingResult` in the global problem's index space, or None
        when the tick is degenerate (one slab, or every gang residual): the
        caller then runs the global solve."""
        enc, free = sched.delta.encoding_view()
        if enc is None or free is None:
            return None
        plan = self.plan_for(enc)
        if plan is None:
            self.degenerate += 1
            METRICS.inc("frontier_degenerate_total")
            return None
        part_of = self.assign(plan, enc, free, gang_specs)
        parts_used = sorted({int(k) for k in part_of if k >= 0})
        if not parts_used:
            self.degenerate += 1
            METRICS.inc("frontier_degenerate_total")
            return None
        with TRACER.span(
            "solve.partition", subproblems=len(parts_used), gangs=len(gang_specs)
        ) as span:
            result = self._solve_partitioned(
                sched, gang_specs, problem, enc, free, plan, part_of, parts_used
            )
            span.set("residual", int((part_of < 0).sum()))
        return result

    def _build_lane(
        self, enc, free, plan, k: int, idxs: List[int], gang_specs: List[dict],
        pad_gangs: int, pad_groups: int, n_pad: int, resource_names: List[str],
    ):
        """One partition's subproblem at the bucket's padded node count."""
        s, e = int(plan.starts[k]), int(plan.ends[k])
        topo_local, seg_starts, seg_ends, node_names, node_index = plan.sub_encoding(enc, k, n_pad)
        capacity = np.zeros((n_pad, free.shape[1]), dtype=np.float32)
        capacity[: e - s] = free[s:e]
        return _assemble_problem(
            capacity, topo_local, seg_starts, seg_ends, node_names, resource_names,
            list(enc.level_keys), node_index, [gang_specs[i] for i in idxs], pad_gangs,
            pad_groups,
        )

    @staticmethod
    def _stack_bucket(problems: List) -> Dict[str, np.ndarray]:
        """Stack same-(G,P,N) subproblems on a leading lane axis: the domain
        axis padded to the bucket's widest, the lane axis to a power of two
        with inert lanes (zero everywhere, -1 on the sentinel fields)."""
        d_max = max(p.seg_starts.shape[1] for p in problems)
        b_pad = _next_pow2(len(problems))

        def seg(a):
            out = np.zeros((a.shape[0], d_max), dtype=a.dtype)
            out[:, : a.shape[1]] = a
            return out

        fields = {
            "capacity": [p.capacity for p in problems],
            "topo": [p.topo for p in problems],
            "seg_starts": [seg(p.seg_starts) for p in problems],
            "seg_ends": [seg(p.seg_ends) for p in problems],
            "demand": [p.demand for p in problems],
            "count": [p.count for p in problems],
            "min_count": [p.min_count for p in problems],
            "req_level": [p.req_level for p in problems],
            "pref_level": [p.pref_level for p in problems],
            "group_req": [p.group_req for p in problems],
            "group_pin": [p.group_pin for p in problems],
            "gang_pin": [p.gang_pin for p in problems],
            "spread_level": [p.spread_level for p in problems],
            "spread_min": [p.spread_min for p in problems],
            "spread_required": [p.spread_required for p in problems],
            # assigned gangs never carry spread state: every lane's seed is
            # the zero-width placeholder
            "spread_seed": [
                np.zeros((p.spread_level.shape[0], 0), dtype=np.int32) for p in problems
            ],
        }
        stack = {}
        for name, mats in fields.items():
            arr = np.stack(mats)
            if b_pad > arr.shape[0]:
                pad = np.zeros((b_pad - arr.shape[0],) + arr.shape[1:], dtype=arr.dtype)
                if name in ("req_level", "pref_level", "group_req", "group_pin", "gang_pin",
                            "spread_level"):
                    pad -= 1  # the -1 sentinels
                arr = np.concatenate([arr, pad])
            stack[name] = arr
        return stack

    def _solve_partitioned(
        self, sched, gang_specs, problem, enc, free, plan, part_of, parts_used,
    ):
        t0 = time.perf_counter()
        pad_groups = problem.max_groups
        resource_names = list(problem.resource_names)
        # lanes grouped into buckets by their padded (gang, node) shape, each
        # bucket one stacked dispatch set; one pass over the assignment
        # builds every partition's gang list
        idxs_by_part: Dict[int, List[int]] = {}
        for i, k in enumerate(part_of):
            if k >= 0:
                idxs_by_part.setdefault(int(k), []).append(i)
        buckets: Dict[Tuple[int, int], List[dict]] = {}
        for k in parts_used:
            idxs = idxs_by_part[k]
            n_real = int(plan.ends[k] - plan.starts[k])
            lane = {
                "k": k,
                "idxs": idxs,
                "n_real": n_real,
                "g_pad": _next_pow2(max(len(idxs), MIN_SUB_GANG_BUCKET)),
                "n_pad": _next_pow2(max(n_real, 8)),
            }
            buckets.setdefault((lane["g_pad"], lane["n_pad"]), []).append(lane)
        bucket_keys = sorted(buckets)

        devices = [sched.device if d is None else d for d in self.devices]
        devices_used = 1

        def encode_bucket(key):
            """One bucket's lane problems and its stacks, [(device, stack,
            real lanes)]: one stack, or with D devices the lanes split into
            D contiguous groups in lane order (a lane's tensors, chunks and
            seeds are its own, so the split composes bit for bit)."""
            g_pad, n_bucket = key
            lanes_k = buckets[key]
            for lane in lanes_k:
                lane["problem"] = self._build_lane(
                    enc, free, plan, lane["k"], lane["idxs"], gang_specs, g_pad, pad_groups,
                    n_bucket, resource_names,
                )
            n_groups = min(len(devices), len(lanes_k))
            per = (len(lanes_k) + n_groups - 1) // n_groups
            groups = [lanes_k[i : i + per] for i in range(0, len(lanes_k), per)]
            return [
                (devices[d], self._stack_bucket([l["problem"] for l in grp]), len(grp))
                for d, grp in enumerate(groups)
            ]

        dispatches = 0
        execute_wall = 0.0
        overlapped = 0.0
        bucket_results: Dict[tuple, dict] = {}
        # gangs residual at assignment time: the speculative encode's target
        # (slab rejects are known only from the results: they force a miss)
        assigned_residual = [i for i in range(len(part_of)) if part_of[i] == RESIDUAL]
        pre_encoded = None
        pre_encoded_idxs = None

        def solve_stack(dev, stack):
            return solve_waves_stacked(
                stack, chunk_size=sched.chunk_size, max_waves=sched.max_waves, device=dev,
            )

        def run(stacks):
            """Solve a bucket's stacks (on the double buffer's worker thread:
            solve_waves_stacked makes its card current there)."""
            nonlocal devices_used
            t = time.perf_counter()
            if len(stacks) == 1:
                # one stack: its result as it is (consumers index real lanes
                # and gangs only, so trimming the padded lanes would copy
                # every [B,G,P,N] alloc for nothing)
                dev, stack, _n = stacks[0]
                out = solve_stack(dev, stack)
                out["wall"] = time.perf_counter() - t
                return out
            devices_used = max(devices_used, len(stacks))
            if self._device_pool is None:
                self._device_pool = ThreadPoolExecutor(
                    max_workers=len(self.devices), thread_name_prefix="frontier-dev"
                )
            futs = [self._device_pool.submit(solve_stack, dev, stack) for dev, stack, _n in stacks]
            outs = [(fut.result(), n) for fut, (_d, _s, n) in zip(futs, stacks)]
            # merge the per-device groups back in lane order, padded lanes cut
            merged = {
                field: np.concatenate([out[field][:n] for out, n in outs])
                for field in _RESULT_FIELDS
            }
            for key in ("dispatches", "fill_launches", "fill_rows"):
                merged[key] = sum(out[key] for out, _n in outs)
            merged["wall"] = time.perf_counter() - t
            return merged

        def encode_residual():
            """The residual's gang encode, overlapped with the device; the
            hit path hands it to build_problem_cached (encode_gangs is pure:
            equal bit for bit either way)."""
            nonlocal pre_encoded, pre_encoded_idxs
            pre_encoded_idxs = list(assigned_residual)
            pre_encoded = encode_gangs(
                [gang_specs[i] for i in pre_encoded_idxs], resource_names,
                list(enc.level_keys), None, pad_groups,
            )

        self.last_buckets = []

        def collect(key, stacks, out):
            nonlocal dispatches, execute_wall
            bucket_results[key] = out
            dispatches += out["dispatches"]
            execute_wall += out["wall"]
            self.stacked_fill_launches += out["fill_launches"]
            self.stacked_fill_rows += out["fill_rows"]
            self.last_buckets.append(
                key + (len(buckets[key]), sum(len(s["demand"]) for _d, s, _n in stacks),
                       out["dispatches"], out["fill_launches"])
            )

        if len(bucket_keys) == 1 and not assigned_residual:
            # one bucket and nothing to pre-encode: nothing to overlap, so
            # no worker thread
            stacks = encode_bucket(bucket_keys[0])
            collect(bucket_keys[0], stacks, run(stacks))
        elif bucket_keys:
            with ThreadPoolExecutor(max_workers=1) as pool:
                pending = list(bucket_keys)
                next_stacks = encode_bucket(pending[0])
                while pending:
                    key = pending.pop(0)
                    stacks = next_stacks
                    t_submit = time.perf_counter()
                    future = pool.submit(run, stacks)
                    next_stacks = None
                    if pending:
                        next_stacks = encode_bucket(pending[0])
                    elif assigned_residual and pre_encoded is None:
                        encode_residual()
                    encode_elapsed = time.perf_counter() - t_submit
                    out = future.result()
                    collect(key, stacks, out)
                    overlapped += min(encode_elapsed, out["wall"])

        # the residual: the leftover gangs against the capacity the slabs
        # left (original units), through the global solve. Slab rejects join
        # it: a gang confined to a slab too fragmented for it still sees the
        # whole cluster this tick
        rejected: set = set()
        for key, out in bucket_results.items():
            for li, lane in enumerate(buckets[key]):
                for gi, g_global in enumerate(lane["idxs"]):
                    if not out["admitted"][li, gi]:
                        rejected.add(g_global)
        residual_idxs = [
            i for i in range(len(part_of)) if part_of[i] == RESIDUAL or i in rejected
        ]
        free_after = np.array(free, dtype=np.float32)
        rindex = {r: j for j, r in enumerate(enc.resource_names)}
        for key, out in bucket_results.items():
            for li, lane in enumerate(buckets[key]):
                s = int(plan.starts[lane["k"]])
                n_real = lane["n_real"]
                for gi, g_global in enumerate(lane["idxs"]):
                    if not out["admitted"][li, gi]:
                        continue
                    spec = gang_specs[g_global]
                    for p, grp in enumerate(spec["groups"]):
                        counts = out["alloc"][li, gi, p, :n_real]
                        if not counts.any():
                            continue
                        for r, q in grp["demand"].items():
                            j = rindex.get(r)
                            if j is not None:
                                free_after[s : s + n_real, j] -= counts * np.float32(q)
        residual_result = None
        if residual_idxs:
            residual_specs = [gang_specs[i] for i in residual_idxs]
            if pre_encoded is not None and residual_idxs == pre_encoded_idxs:
                # overlap hit: the gang arrays were encoded while the device
                # ran the slabs; only the capacity half is assembled now
                self.residual_overlap_hits += 1
                METRICS.inc("frontier_residual_overlap_hits_total")
                residual_problem = build_problem_cached(
                    enc, free_after, residual_specs, None, pad_groups, pre_encoded=pre_encoded
                )
            else:
                # miss: slab rejects joined the residual after the speculative
                # encode (or nothing was pre-encoded): encode now
                if pre_encoded is not None:
                    self.residual_overlap_misses += 1
                    METRICS.inc("frontier_residual_overlap_misses_total")
                residual_problem = build_problem_cached(
                    enc, free_after, residual_specs, None, pad_groups
                )
            residual_result = solve_waves(
                residual_problem, chunk_size=sched.chunk_size, max_waves=sched.max_waves,
                with_alloc=True, device=sched.device,
            )

        composite = self._compose(
            problem, plan, buckets, bucket_results, residual_idxs, residual_result
        )
        composite.solve_seconds = execute_wall + (
            residual_result.solve_seconds if residual_result else 0.0
        )

        self.solves += 1
        self.last_subproblems = len(parts_used)
        self.subproblems_total += len(parts_used)
        self.assigned_total += int((part_of >= 0).sum())
        self.residual_total += len(residual_idxs)
        self.dispatches_total += dispatches + (0 if residual_result is None else 1)
        self.last_residual_fraction = len(residual_idxs) / max(len(gang_specs), 1)
        self.last_overlap_occupancy = overlapped / max(execute_wall, 1e-9)
        self.last_devices_used = devices_used
        METRICS.set("frontier_devices", devices_used)
        METRICS.inc("frontier_solves_total")
        METRICS.set("frontier_subproblems", self.last_subproblems)
        METRICS.set("frontier_residual_fraction", round(self.last_residual_fraction, 4))
        METRICS.set("frontier_batched_dispatches", dispatches)
        METRICS.set("frontier_overlap_occupancy", round(self.last_overlap_occupancy, 4))
        METRICS.observe("frontier_solve_seconds", time.perf_counter() - t0)

        if sched.frontier_selfcheck:
            self._selfcheck(
                sched, problem, plan, buckets, bucket_results, residual_idxs, residual_result,
                composite,
            )
        return composite

    def _compose(
        self, problem, plan, buckets, bucket_results, residual_idxs, residual_result,
    ) -> PackingResult:
        """Fold the subproblem and residual results into the global
        problem's [G, P, N] index space (a subproblem's node columns shift
        by its slab's start; the residual's are global already)."""
        g_pad = problem.num_gangs
        p_max = problem.max_groups
        n = problem.num_nodes
        admitted = np.zeros((g_pad,), dtype=bool)
        placed = np.zeros((g_pad, p_max), dtype=np.int32)
        score = np.zeros((g_pad,), dtype=np.float32)
        chosen_level = np.full((g_pad,), -1, dtype=np.int32)
        alloc = np.zeros((g_pad, p_max, n), dtype=np.int32)
        for key, out in bucket_results.items():
            for li, lane in enumerate(buckets[key]):
                s = int(plan.starts[lane["k"]])
                n_real = lane["n_real"]
                for gi, g_global in enumerate(lane["idxs"]):
                    admitted[g_global] = out["admitted"][li, gi]
                    placed[g_global] = out["placed"][li, gi]
                    score[g_global] = out["score"][li, gi]
                    chosen_level[g_global] = out["chosen_level"][li, gi]
                    alloc[g_global, :, s : s + n_real] = out["alloc"][li, gi, :, :n_real]
        if residual_result is not None:
            for ri, g_global in enumerate(residual_idxs):
                admitted[g_global] = residual_result.admitted[ri]
                placed[g_global] = residual_result.placed[ri]
                score[g_global] = residual_result.score[ri]
                chosen_level[g_global] = residual_result.chosen_level[ri]
                alloc[g_global] = residual_result.alloc[ri]
        return PackingResult(
            admitted=admitted,
            placed=placed,
            score=score,
            chosen_level=chosen_level,
            alloc=alloc,
            free_after=None,  # a composite: the subproblems' units differ
            solve_seconds=0.0,
        )

    def _selfcheck(
        self, sched, problem, plan, buckets, bucket_results, residual_idxs, residual_result,
        composite,
    ) -> None:
        """The frontier A/B: every subproblem solved alone through
        ``solve_waves`` on the same arrays and the scheduler's device, the
        results recomposed in order, and the batched composite asserted
        equal bit for bit (scores included). The residual already ran
        through ``solve_waves``, so this pins the stacked dispatch, the
        stacking and padding, the worker thread and the composition."""
        t0 = time.perf_counter()
        ref_results: Dict[tuple, dict] = {}
        for key, out in bucket_results.items():
            ref = {f: np.zeros_like(out[f]) for f in _RESULT_FIELDS}
            for li, lane in enumerate(buckets[key]):
                solo = solve_waves(
                    lane["problem"], chunk_size=sched.chunk_size, max_waves=sched.max_waves,
                    with_alloc=True, device=sched.device,
                )
                for field in _RESULT_FIELDS:
                    got = getattr(solo, field)
                    ref[field][li] = got
                    if not np.array_equal(out[field][li], got):
                        raise AssertionError(
                            "partitioned frontier diverged from the solo solve on"
                            f" {field!r} (partition {lane['k']}, bucket {key})"
                        )
            ref_results[key] = ref
        ref_composite = self._compose(
            problem, plan, buckets, ref_results, residual_idxs, residual_result
        )
        for field in _RESULT_FIELDS:
            if not np.array_equal(getattr(composite, field), getattr(ref_composite, field)):
                raise AssertionError(
                    "partitioned frontier composite diverged from the sequential"
                    f" recomposition on {field!r}"
                )
        elapsed = time.perf_counter() - t0
        self.selfcheck_seconds += elapsed
        sched.last_selfcheck_seconds += elapsed

    # -- reporting -----------------------------------------------------------

    def stats(self) -> dict:
        """Lifetime counters (the JAX bench's "frontier" block)."""
        return {
            "solves": self.solves,
            "degenerate_ticks": self.degenerate,
            "subproblems_total": self.subproblems_total,
            "assigned_gangs_total": self.assigned_total,
            "residual_gangs_total": self.residual_total,
            "residual_fraction": round(
                self.residual_total / max(self.assigned_total + self.residual_total, 1), 4
            ),
            "batched_dispatches_total": self.dispatches_total,
            "last_overlap_occupancy": round(self.last_overlap_occupancy, 4),
            "devices": len(self.devices),
            "last_devices_used": self.last_devices_used,
            "residual_overlap_hits": self.residual_overlap_hits,
            "residual_overlap_misses": self.residual_overlap_misses,
            "ab_overhead_ms": round(self.selfcheck_seconds * 1e3, 1),
        }
