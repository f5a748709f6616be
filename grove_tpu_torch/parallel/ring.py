"""Explicit-collective ring tier of the multi-GPU solver.

Counterpart of ``grove_tpu/parallel/ring.py`` (``shard_map`` with
``lax.ppermute`` and ``lax.psum``). One gang's per-domain feasibility
aggregates, the tables behind every candidate decision of the selector
(``ops/packing.py::_aggregate_tables``), over a node-sharded cluster:

- local capped fits and their inclusive cumsums on each rank's slab;
- a RING exclusive prefix of the per-rank totals: size−1 neighbour hops
  (``torch.distributed.batch_isend_irecv``, each rank sending to the next
  and receiving from the previous), turning the local cumsums into global
  prefix sums without the whole node axis on any rank;
- an owner-computes boundary gather: each rank computes the global prefix
  at the domain boundaries inside its slab, and one all_gather of the
  ``[2·L·D, P]`` and ``[2·L·D, R]`` tables hands every rank the owner's
  values (selected, not summed). On gloo the hops and the gather pass
  through host memory.

``domain_aggregates`` is the same tables on one device, the plain version
the ring is held to.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from grove_tpu_torch.ops.fill import _pods_fit_per_node
from grove_tpu_torch.ops.nodeaxis import all_gather_stack
from grove_tpu_torch.utils.platform import resolve_device


def _ring_exclusive_shard_prefix(v: torch.Tensor, group, stage: bool) -> torch.Tensor:
    """Exclusive prefix sum of per-rank values around the ring: after hop s
    each rank holds the value of the rank s positions back; it adds the
    hops that belong to its prefix (and zeros for the others, as the JAX
    module adds them). size−1 neighbour send/recv pairs."""
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    nxt = dist.get_global_rank(group, (rank + 1) % size)
    prv = dist.get_global_rank(group, (rank - 1) % size)
    acc = torch.zeros_like(v)
    carry = v.contiguous()
    for s in range(1, size):
        send = carry.cpu() if stage else carry
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send, nxt, group), dist.P2POp(dist.irecv, recv, prv, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        carry = recv.to(v.device)
        acc = acc + (carry if rank >= s else torch.zeros_like(carry))
    return acc


def _bounds(seg_starts: np.ndarray, seg_ends: np.ndarray) -> np.ndarray:
    """Flat boundary list: the starts, then the ends, of every (level,
    domain) — ``[2·L·D]``."""
    return np.concatenate([seg_starts.reshape(-1), seg_ends.reshape(-1)]).astype(np.int64)


def _tables(cs_k_at: np.ndarray, cs_free_at: np.ndarray, levels: int, d_max: int, p_dim: int):
    """(K [L,P,D], free_agg [L,D,R]) from the prefix values at the starts
    and the ends, in numpy float32 as the JAX module takes them apart."""
    ld = levels * d_max
    K = (cs_k_at[ld:] - cs_k_at[:ld]).reshape(levels, d_max, p_dim).transpose(0, 2, 1)
    free_agg = (cs_free_at[ld:] - cs_free_at[:ld]).reshape(levels, d_max, -1)
    return K, free_agg


def _capped_fits(capacity: torch.Tensor, demand: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """``[P, n]`` float32: pods of each group fitting per node, capped at its
    count."""
    k = _pods_fit_per_node(capacity, demand)  # [P, n]
    return torch.minimum(k, count.unsqueeze(-1)).to(torch.float32)


def domain_aggregates_ring(
    mesh,
    capacity: np.ndarray,  # [N, R]
    topo: np.ndarray,  # [N, L] (unused directly; bounds encode the slabs)
    seg_starts: np.ndarray,  # [L, D]
    seg_ends: np.ndarray,  # [L, D]
    demand: np.ndarray,  # [P, R] one gang's per-pod demands
    count: np.ndarray,  # [P]
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-level, per-domain aggregates for ONE gang against the cluster
    with its node axis sharded over the last axis of the ``DeviceMesh``:
    K[l, p, d] = pods of group p fitting in domain d of level l,
    free_agg[l, d, r] = free capacity.
    Every rank calls it with the whole arrays and gets the whole tables.
    Runs on ``device`` (default: the card; raises without one). Raises
    ``ValueError`` when the node axis does not divide over the ranks.

    Returns numpy (K [L, P, D], free_agg [L, D, R])."""
    device = resolve_device(device)
    group = mesh.get_group(mesh.mesh_dim_names[-1])
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    stage = dist.get_backend(group) == "gloo"
    n = capacity.shape[0]
    if n % size:
        raise ValueError(f"node axis {n} not divisible by mesh size {size}")
    levels, d_max = seg_starts.shape
    p_dim = demand.shape[0]
    n_local = n // size
    lo = rank * n_local
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    cap = up(capacity[lo : lo + n_local])
    bidx = up(_bounds(seg_starts, seg_ends))

    # local capped fits + inclusive cumsums along the local slab
    k = _capped_fits(cap, up(demand.astype(np.float32)), up(count.astype(np.int32)))
    cs_k_local = torch.cumsum(k, 1)  # [P, nl]
    cs_free_local = torch.cumsum(cap, 0)  # [nl, R]
    base_k = _ring_exclusive_shard_prefix(cs_k_local[:, -1], group, stage)  # [P]
    base_free = _ring_exclusive_shard_prefix(cs_free_local[-1, :], group, stage)  # [R]

    # owner-computes boundary gather: the exclusive global prefix at index i
    # is base + the local inclusive cumsum at i − lo − 1 (the base itself at
    # the slab start); index n, the global total, is the last rank's
    rel = bidx - lo
    rel_c = torch.clamp(rel - 1, 0, n_local - 1)
    owner = torch.clamp(torch.div(bidx, n_local, rounding_mode="floor"), max=size - 1)

    def at_bounds(cs_local, base):
        # cs_local [W, nl] inclusive → [B, W] at the boundaries this rank owns
        vals = torch.where((rel == 0).unsqueeze(-1), base.unsqueeze(0),
                           cs_local[:, rel_c].T + base.unsqueeze(0))
        total = cs_local[:, -1] + base
        vals = torch.where((bidx == n).unsqueeze(-1), total.unsqueeze(0), vals)
        gathered = all_gather_stack(vals, group, stage)  # [size, B, W]
        return gathered.gather(0, owner[None, :, None].expand(1, *vals.shape)).squeeze(0)

    cs_k_at = at_bounds(cs_k_local, base_k).cpu().numpy()  # [2LD, P]
    cs_free_at = at_bounds(cs_free_local.T, base_free).cpu().numpy()  # [2LD, R]
    return _tables(cs_k_at, cs_free_at, levels, d_max, p_dim)


def domain_aggregates(
    capacity: np.ndarray,
    topo: np.ndarray,
    seg_starts: np.ndarray,
    seg_ends: np.ndarray,
    demand: np.ndarray,
    count: np.ndarray,
    device: Optional[torch.device] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """The tables of :func:`domain_aggregates_ring` on one device over the
    whole node axis (the plain version the ring is held to)."""
    device = resolve_device(device)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    cap = up(capacity)
    bidx = up(_bounds(seg_starts, seg_ends))
    k = _capped_fits(cap, up(demand.astype(np.float32)), up(count.astype(np.int32)))
    cs_k = torch.cat([torch.zeros_like(k[:, :1]), torch.cumsum(k, 1)], 1)  # [P, N+1]
    cs_free = torch.cat([torch.zeros_like(cap[:1]), torch.cumsum(cap, 0)], 0)  # [N+1, R]
    levels, d_max = seg_starts.shape
    return _tables(cs_k[:, bidx].T.cpu().numpy(), cs_free[bidx].cpu().numpy(), levels, d_max,
                   demand.shape[0])
