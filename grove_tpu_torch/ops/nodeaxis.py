"""The node axis of a solve: whole on one device, or sharded over ranks.

The JAX package shards the solver's node axis by GSPMD: XLA partitions the
prefix sums, boundary gathers and reductions over nodes mechanically
(``grove_tpu/parallel/sharded.py``). PyTorch has no partitioner for the
port's host wave loop and hand-written fill, so the solver core
(``ops/packing.py``) takes a :class:`NodeAxis` and asks it for every
operation that crosses nodes (``parallel/sharded.py`` builds the sharded
ones):

- ``table``: the exclusive prefix table ``[..., n+1]`` of a per-node tensor,
  at this rank's positions, with the fixed association of
  ``ops.fill._seg_cumsum`` over the GLOBAL axis (float tables bit for bit);
- ``spans`` / ``row_spans`` / ``gather``: table entries at global domain
  boundaries;
- ``all``: an all-of over nodes; ``full``: a node-sharded tensor at full
  width;
- ``fill``: the fill on this rank's node slab;
- ``index`` / ``global_n``: global node positions.

``WHOLE`` (the default everywhere) is the whole axis on one device: each
operation is the single-device code, the same torch ops the solver issued
before it took a node axis, no collective runs, and the fill is the
caller's own. A sharded axis holds a ``torch.distributed``
process group; every rank must call the solver with the same replicated
arguments, so that all ranks call the same collectives in the same order
(nothing on the path branches on node-local data).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from grove_tpu_torch.ops.fill import (
    _pods_fit_per_node,
    _scan_segments,
    _seg_cumsum,
    _segment_offsets,
    _segment_scan,
)


def all_gather_stack(t: torch.Tensor, group, stage: bool) -> torch.Tensor:
    """``[size, *t.shape]``: every rank's ``t`` in ``group``, in rank order,
    on ``t``'s device. ``stage``: through host memory (gloo)."""
    src = t.contiguous()
    device = src.device
    if stage:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.stack(parts).to(device)


def shard_bounds(n: int, size: int, rank: int) -> Tuple[int, int]:
    """(first node, node count) of ``rank``'s slab of an axis of ``n`` nodes
    over ``size`` ranks. Raises ``ValueError`` unless every rank holds whole
    segments of the fixed-association scan: ``n % size == 0`` and
    ``S % size == 0`` for S = ``_scan_segments(n)`` (a segment split across
    ranks would change a float prefix sum's association)."""
    if size < 1 or not 0 <= rank < size:
        raise ValueError(f"rank {rank} outside a node axis of {size} ranks")
    if n % size:
        raise ValueError(f"node axis {n} not divisible by {size} ranks")
    s = _scan_segments(n)
    if s % size:
        raise ValueError(
            f"node axis {n} has {s} scan segments, not a multiple of {size} ranks:"
            " a rank would hold part of a segment"
        )
    n_local = n // size
    return rank * n_local, n_local


class NodeAxis:
    """The node axis of one solve (see the module docstring). ``NodeAxis()``
    is the whole axis on one device; ``NodeAxis(n, group)`` shards ``n``
    nodes over ``group``, rank r holding nodes ``[r·n/size, (r+1)·n/size)``
    in the group's rank order. On a gloo group the collectives are staged
    through host memory (gloo's send and receive take CPU tensors only).
    ``collectives`` counts the collectives called."""

    def __init__(self, n: Optional[int] = None, group=None):
        self.group = group
        self.n = n
        self.collectives = 0
        if group is None:
            self.rank, self.size, self.lo, self.n_local = 0, 1, 0, n
            self.stage = False
            return
        if n is None:
            raise ValueError("a sharded node axis needs its global node count")
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.lo, self.n_local = shard_bounds(n, self.size, self.rank)
        self.segments = _scan_segments(n)
        self.stage = dist.get_backend(group) == "gloo"

    @property
    def sharded(self) -> bool:
        return self.group is not None

    # -- collectives -----------------------------------------------------

    def _all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``[size, *t.shape]``: every rank's ``t``, in rank order."""
        self.collectives += 1
        return all_gather_stack(t, self.group, self.stage)

    def _pick(self, gathered: torch.Tensor, owner: torch.Tensor) -> torch.Tensor:
        """Each element from its owner's row of ``gathered [size, ...]``:
        a selection, never a sum, so a −0.0 stays −0.0."""
        return gathered.gather(0, owner.expand(gathered.shape[1:]).unsqueeze(0)).squeeze(0)

    def _owner_and_local(self, idx: torch.Tensor):
        """Owner rank and local table position of global table indices in
        [0, n]: rank r's table holds entries lo_r .. lo_r + n_local; the
        entry at a slab boundary is on both sides (bit-equal), its owner is
        the rank the slab starts on."""
        owner = torch.clamp(torch.div(idx, self.n_local, rounding_mode="floor"), max=self.size - 1)
        return owner, torch.clamp(idx - self.lo, 0, self.n_local)

    # -- the operations ----------------------------------------------------

    def index(self, n_local: int, device) -> torch.Tensor:
        """Global positions of this rank's nodes, ``[n_local]`` int64."""
        index = torch.arange(n_local, device=device)
        return index + self.lo if self.sharded else index

    def global_n(self, n_local: int) -> int:
        """Nodes of the whole axis (``n_local`` for the whole axis)."""
        return self.n if self.sharded else n_local

    def table(self, a: torch.Tensor, dim: int = -1, total: bool = False):
        """Exclusive prefix table of per-node ``a`` along ``dim`` (size n+1
        there): entry j is the sum over global nodes [0, j). Sharded, this
        rank holds entries ``lo .. lo + n_local`` (size n_local + 1), each
        equal bit for bit to the whole axis' entry: the segment count S
        comes from the global n, each rank scans its S/size segments, and
        one all_gather of the ``[..., S]`` segment totals (with each rank's
        last in-segment prefix) feeds the same offset product. With
        `total`, also the entry at n (the global sum), ``[...]``."""
        if not self.sharded:
            zero_shape = list(a.shape)
            zero_shape[dim] = 1
            tbl = torch.cat([torch.zeros(zero_shape, dtype=a.dtype, device=a.device),
                             _seg_cumsum(a, dim)], dim)
            return (tbl, tbl.select(dim, -1)) if total else tbl
        a = a.movedim(dim, -1)
        lead = a.shape[:-1]
        s = self.segments
        if s <= 1:  # one rank (shard_bounds): the plain scan of _seg_cumsum
            out = torch.cumsum(a, -1, dtype=a.dtype)
            head = torch.zeros(lead, dtype=a.dtype, device=a.device)
            tot = out[..., -1]
        else:
            sl, width = s // self.size, self.n // s
            local, totals = _segment_scan(a.reshape(lead + (sl, width)))
            mine = torch.cat([totals, local[..., -1, -1:]], -1)  # [..., sl + 1]
            gathered = self._all_gather(mine)  # [size, ..., sl + 1]
            all_totals = gathered[..., :sl].movedim(0, -2).reshape(lead + (s,)).contiguous()
            offs = _segment_offsets(all_totals)
            first = self.rank * sl
            out = (local + offs[..., first : first + sl].unsqueeze(-1)).reshape(a.shape)
            lasts = gathered[..., sl]  # [size, ...]: each rank's last in-segment prefix
            # the entry at lo is the previous rank's last inclusive prefix,
            # the same add of the same two numbers
            head = (lasts[self.rank - 1] + offs[..., first - 1] if self.rank
                    else torch.zeros(lead, dtype=a.dtype, device=a.device))
            tot = lasts[-1] + offs[..., -1]
        tbl = torch.cat([head.unsqueeze(-1), out], -1).movedim(-1, dim)
        return (tbl, tot) if total else tbl

    def spans(self, table: torch.Tensor, dim: int,
              pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]]) -> List[torch.Tensor]:
        """``table[ends] − table[starts]`` along ``dim`` for each (starts,
        ends) pair of 1-D global index tensors; sharded, one collective for
        all pairs."""
        dim = dim % table.dim()
        if not self.sharded:
            lead = (slice(None),) * dim
            return [table[lead + (e,)] - table[lead + (s,)] for s, e in pairs]
        idx = torch.cat([torch.cat([s, e]) for s, e in pairs])
        owner, local = self._owner_and_local(idx)
        vals = self._all_gather(table.index_select(dim, local))
        shape = [1] * table.dim()
        shape[dim] = -1
        picked = self._pick(vals, owner.view(shape))
        out, at = [], 0
        for s, e in pairs:
            w = s.shape[0]
            starts = picked.narrow(dim, at, w)
            ends = picked.narrow(dim, at + w, w)
            out.append(ends - starts)
            at += 2 * w
        return out

    def row_spans(self, table: torch.Tensor, rows: torch.Tensor,
                  pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]]) -> List[torch.Tensor]:
        """``table[rows, ends] − table[rows, starts]`` for each (starts,
        ends) pair: ``[*rows.shape, D]`` spans of the rows ``rows`` of a
        ``[U, n+1]`` table (the dedup path's per-gang rows of ``cs_pair``);
        sharded, the spans of every row in one collective, then the rows."""
        if not self.sharded:
            row = rows.unsqueeze(-1)
            return [table[row, e] - table[row, s] for s, e in pairs]
        return [span[rows] for span in self.spans(table, 1, pairs)]

    def gather(self, table: torch.Tensor, dim: int,
               idxs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """``table.gather(dim, i)`` for each global index tensor ``i``;
        sharded, one collective for all."""
        if not self.sharded:
            return [table.gather(dim, i) for i in idxs]
        idx = torch.cat(list(idxs), dim)
        owner, local = self._owner_and_local(idx)
        picked = self._pick(self._all_gather(table.gather(dim, local)), owner)
        return list(picked.split([i.shape[dim] for i in idxs], dim))

    def all(self, ok: torch.Tensor) -> torch.Tensor:
        """All-of over the node axis of a per-rank bool result (an int32
        MIN: gloo reduces no bool)."""
        if not self.sharded:
            return ok
        self.collectives += 1
        t = ok.to(torch.int32)
        device = t.device
        if self.stage:
            t = t.cpu()
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self.group)
        return t.to(device).to(torch.bool)

    def full(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """A node-sharded tensor at full width along ``dim``."""
        if not self.sharded:
            return t
        return torch.cat(list(self._all_gather(t).unbind(0)), dim)

    def fill(self, fill):
        """The fill on this rank's node slab: ``fill`` itself for the whole
        axis. Sharded: the fill takes nodes in order, so on rank s a group's
        fill is the local fill with ``count' = max(count − B_s, 0)``, B_s the
        capped fits of the earlier ranks' nodes — one all_gather of the
        ``[C]`` per-rank fit totals per group, then one P=1 call of ``fill``
        (a kernel launch on the card). A group's fits depend on the capacity
        the previous group left, so the groups go one by one, chained through
        each call's ``free_after``. ``placed`` is the global
        ``min(count, Σ fits)``, what the prefix fill places over all nodes."""
        if not self.sharded:
            return fill

        def fill_shard(free, mask, demand, count, with_free_after=True):
            p_dim = demand.shape[1]
            mask = mask.to(torch.bool)
            allocs, placed = [], []
            free_p = free
            for p in range(p_dim):
                cnt = count[:, p : p + 1]
                k = _pods_fit_per_node(free_p, demand[:, p])
                k = torch.minimum(torch.where(mask, k, 0), cnt)
                totals = self._all_gather(k.sum(-1, dtype=torch.int64))  # [size, C]
                before = totals[: self.rank].sum(0)
                cnt_here = torch.clamp(cnt - before.unsqueeze(-1), min=0).to(torch.int32)
                alloc, _, free_p = fill(
                    free_p, mask, demand[:, p : p + 1].contiguous(), cnt_here.contiguous(),
                    with_free_after=with_free_after or p < p_dim - 1,
                )
                allocs.append(alloc)
                placed.append(torch.minimum(cnt, totals.sum(0).unsqueeze(-1)).to(torch.int32))
            return torch.cat(allocs, 1), torch.cat(placed, 1), free_p

        return fill_shard


WHOLE = NodeAxis()
