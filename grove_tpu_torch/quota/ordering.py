"""DRF fair-share ordering: a hand-written CUDA scan and its plain twin.

Counterpart of ``grove_tpu/quota/ordering.py``, whose ``fair_order`` runs a
jitted ``lax.scan``. Each step picks the active queue with the lowest
dominant share and emits its next pending gang, charging that gang's demand
to that queue's row before the next step:

    share[q,r] = U[q,r]/D[q,r] where D > 0, else U[q,r]*BIG
    dom[q]     = max_r share[q,r]
    pick       = argmin over queues of (dom if active else +inf), ties to
                 the lowest queue index (queues are sorted by name)
    emit (pick, taken[pick]); U[pick] += demand[pick, taken[pick]]

Steps after every queue drains emit (-1, -1). ``fair_order_scan`` launches
``csrc/drf.cu`` for CUDA tensors and runs ``fair_order_ref`` (a step loop
of the same float32 operations in the same order) for CPU tensors; both are
bit-equal to the JAX scan and to ``quota/oracle.py``.

A step charges only the picked queue's row, so queue q's dominant share
after k charges is a function of q and k alone. The kernel runs the scan in
two phases on that fact: a ``[Q, G]`` table of those shares (each stored as
its key, ``order_keys``), built over all queues in parallel, then a merge
that takes the first-index argmin over the queues' heads at each step.
``share_table_ref`` and ``merge_ref`` are the two phases in plain PyTorch
(the kernels' plain versions, on any device), and ``fair_order_merge_ref``
chains them (the tests hold it to the scan on the CPU).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from grove_tpu_torch.ops import _build
from grove_tpu_torch.utils.platform import resolve_device

# float32-safe "worse than any entitled share" multiplier for zero-deserved
# queues (overflow to inf is the same everywhere)
BIG = np.float32(1e18)

# the merge's key of +inf, and of a drained queue (see order_keys)
KEY_INF = 0xFF800000


def fair_order_ref(deserved, usage, demand, counts, steps: int) -> torch.Tensor:
    """The scan in plain PyTorch: ``steps`` steps over deserved/usage
    ``[Q,R]`` f32, demand ``[Q,G,R]`` f32 and counts ``[Q]`` i32, returning
    ``[steps, 2]`` i32 (queue, slot) rows."""
    q_dim, g_dim = demand.shape[0], demand.shape[1]
    big = torch.tensor(BIG, dtype=torch.float32, device=deserved.device)
    one = torch.ones((), dtype=torch.float32, device=deserved.device)
    entitled = deserved > 0
    safe = torch.where(entitled, deserved, one)
    u = usage.clone()
    taken = torch.zeros((q_dim,), dtype=torch.int32, device=deserved.device)
    out = torch.full((steps, 2), -1, dtype=torch.int32, device=deserved.device)
    for t in range(steps):
        share = torch.where(entitled, u / safe, u * big)
        dom = share.amax(1)
        active = taken < counts
        if not bool(active.any()):
            break
        key = torch.where(active, dom, torch.inf)
        q = int(torch.argmin(key))
        slot = int(taken[q])
        out[t, 0] = q
        out[t, 1] = slot
        u[q] = u[q] + demand[q, min(slot, g_dim - 1)]
        taken[q] += 1
    return out


def _dominant_share(deserved, u):
    """max over the last axis of (u/d where d > 0, else u*BIG), NaN first."""
    entitled = deserved > 0
    one = torch.ones((), dtype=torch.float32, device=u.device)
    big = torch.tensor(BIG, dtype=torch.float32, device=u.device)
    return torch.where(entitled, u / torch.where(entitled, deserved, one), u * big).amax(-1)


def share_table_ref(deserved, usage, demand):
    """Phase 1 in plain PyTorch: ``[Q, G]`` f32, entry ``[q, k]`` the
    dominant share of queue q after its first k charges (the usage fold in
    k order, one add per resource, as the scan charges), and the ``[Q, R]``
    usage after G charges, from which a queue with more than G pending gangs
    goes on charging demand row G-1."""
    g_dim = demand.shape[1]
    u = usage.clone()
    table = torch.empty((demand.shape[0], g_dim), dtype=torch.float32, device=demand.device)
    for k in range(g_dim):
        table[:, k] = _dominant_share(deserved, u)
        u = u + demand[:, k]
    return table, u


def order_keys(dom) -> torch.Tensor:
    """The keys the kernel's table holds, as int64: the uint32 map of each
    float whose unsigned order is the scan's argmin order (−0.0 onto +0.0,
    NaN to 0 so it comes first, +inf to ``KEY_INF``)."""
    dom = torch.where(dom == 0, torch.zeros_like(dom), dom)
    bits = dom.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    key = torch.where(bits >= 0x80000000, bits ^ 0xFFFFFFFF, bits | 0x80000000)
    return torch.where(torch.isnan(dom), torch.zeros_like(key), key)


def merge_ref(table, tail, deserved, demand, counts, steps: int) -> torch.Tensor:
    """Phase 2 in plain PyTorch over :func:`share_table_ref`'s table and tail
    (on any device): per step the first-index argmin of the queues' keys
    (the head ``table[q, taken[q]]`` while active, ``KEY_INF`` once drained).
    Returns what :func:`fair_order_ref` returns."""
    q_dim, g_dim = table.shape
    heads = order_keys(table)
    tail = tail.clone()
    counts = counts.tolist()
    taken = [0] * q_dim
    keys = torch.where(torch.tensor(counts, device=table.device) > 0, heads[:, 0], KEY_INF)
    active = sum(c > 0 for c in counts)
    rows = []
    while len(rows) < steps and active > 0:
        q = int(torch.argmin(keys))
        rows.append((q, taken[q]))
        taken[q] += 1
        k = taken[q]
        active -= k == counts[q]
        if k >= counts[q]:
            keys[q] = KEY_INF
        elif k < g_dim:
            keys[q] = heads[q, k]
        else:  # past the table: charge demand row G-1, as the gather clamps
            if k > g_dim:
                tail[q] = tail[q] + demand[q, g_dim - 1]
            keys[q] = order_keys(_dominant_share(deserved[q], tail[q]))
    out = torch.full((steps, 2), -1, dtype=torch.int32)
    if rows:
        out[: len(rows)] = torch.tensor(rows, dtype=torch.int32)
    return out.to(table.device)


def fair_order_merge_ref(deserved, usage, demand, counts, steps: int) -> torch.Tensor:
    """The kernels' two phases in plain PyTorch, for the tests: the share
    table, then the merge. Returns what :func:`fair_order_ref` returns."""
    table, tail = share_table_ref(deserved, usage, demand)
    return merge_ref(table, tail, deserved, demand, counts, steps)


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"fair_order: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"fair_order: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"fair_order: {name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"fair_order: {name} must be contiguous")


_SHARES_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_MERGE_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _kernel():
    lib = _build.load("drf")
    if lib.grove_drf_merge.argtypes is None:
        lib.grove_drf_shares.argtypes = _SHARES_ARGTYPES
        lib.grove_drf_shares.restype = ctypes.c_int
        lib.grove_drf_merge.argtypes = _MERGE_ARGTYPES
        lib.grove_drf_merge.restype = ctypes.c_int
        lib.grove_drf_merge_shared_queues.argtypes = []
        lib.grove_drf_merge_shared_queues.restype = ctypes.c_int
        lib.grove_drf_error_string.argtypes = [ctypes.c_int]
        lib.grove_drf_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err, phase):
    if err != 0:
        raise RuntimeError(
            f"fair_order {phase} kernel launch failed: "
            + lib.grove_drf_error_string(err).decode()
        )


def _stream(device):
    with torch.cuda.device(device):
        return torch.cuda.current_stream(device).cuda_stream


def share_table_cuda(deserved, usage, demand, counts):
    """Phase 1 on the card: launches ``drf_shares_kernel`` on the current
    stream and returns (table, tail) for :func:`merge_cuda`. The table is
    ``[Q, G]`` int32 holding the uint32 keys of :func:`order_keys`, in an
    allocation padded to 16 bytes (the merge stages it by bulk copies);
    entries at or past a queue's count are not written."""
    q_dim, g_dim, r_dim = demand.shape
    device = demand.device
    _check("deserved", deserved, torch.float32, (q_dim, r_dim), device)
    _check("usage", usage, torch.float32, (q_dim, r_dim), device)
    _check("demand", demand, torch.float32, (q_dim, g_dim, r_dim), device)
    _check("counts", counts, torch.int32, (q_dim,), device)
    flat = torch.empty((-(-q_dim * g_dim // 4) * 4,), dtype=torch.int32, device=device)
    table = flat[: q_dim * g_dim].view(q_dim, g_dim)
    tail = torch.empty((q_dim, r_dim), dtype=torch.float32, device=device)
    lib = _kernel()
    err = lib.grove_drf_shares(
        deserved.data_ptr(), usage.data_ptr(), demand.data_ptr(), counts.data_ptr(),
        table.data_ptr(), tail.data_ptr(), q_dim, g_dim, r_dim, _stream(device),
    )
    _raise_on(lib, err, "shares")
    share_table_cuda.launches += 1
    return table, tail


def merge_cuda(table, tail, deserved, demand, counts, steps: int) -> torch.Tensor:
    """Phase 2 on the card: launches ``drf_merge_kernel`` on the current
    stream over the table and tail of :func:`share_table_cuda` (the tail is
    charged in place) and returns the ``[steps, 2]`` i32 rows. Above one warp
    the kernel keeps a taken count per queue in shared memory, and past
    ``grove_drf_merge_shared_queues()`` (57,600) in a zeroed ``[Q]`` buffer
    allocated here."""
    q_dim, g_dim, r_dim = demand.shape
    device = demand.device
    _check("table", table, torch.int32, (q_dim, g_dim), device)
    padded = -(-q_dim * g_dim // 4) * 16  # bytes the merge's bulk copies read
    if table.data_ptr() % 16 or (
        table.untyped_storage().nbytes() - table.storage_offset() * 4 < padded
    ):
        raise ValueError("fair_order: table must start a 16-byte-padded allocation"
                         " (as share_table_cuda makes it)")
    _check("tail", tail, torch.float32, (q_dim, r_dim), device)
    _check("deserved", deserved, torch.float32, (q_dim, r_dim), device)
    _check("demand", demand, torch.float32, (q_dim, g_dim, r_dim), device)
    _check("counts", counts, torch.int32, (q_dim,), device)
    lib = _kernel()
    taken = (torch.zeros((q_dim,), dtype=torch.int32, device=device)
             if q_dim > lib.grove_drf_merge_shared_queues() else None)
    out = torch.empty((steps, 2), dtype=torch.int32, device=device)
    err = lib.grove_drf_merge(
        table.data_ptr(), tail.data_ptr(), deserved.data_ptr(), demand.data_ptr(),
        counts.data_ptr(), out.data_ptr(), None if taken is None else taken.data_ptr(),
        q_dim, g_dim, r_dim, steps, _stream(device),
    )
    _raise_on(lib, err, "merge")
    merge_cuda.launches += 1
    return out


# launches on the card since the last reset, each counted where its kernel
# is launched (a pass launches each once; the plain CPU path never counts)
share_table_cuda.launches = 0
merge_cuda.launches = 0


def fair_order_scan(deserved, usage, demand, counts, steps: int) -> torch.Tensor:
    """``steps`` steps of the scan on the tensors' device: the two CUDA
    kernels (share table, then merge) for CUDA tensors, :func:`fair_order_ref`
    for CPU tensors."""
    if demand.device.type == "cuda":
        table, tail = share_table_cuda(deserved, usage, demand, counts)
        return merge_cuda(table, tail, deserved, demand, counts, steps)
    if demand.device.type == "cpu":
        return fair_order_ref(deserved, usage, demand, counts, steps)
    raise ValueError(f"fair_order: unsupported device {demand.device}")


def fair_order(
    deserved: np.ndarray,  # [Q, R] float32
    usage: np.ndarray,  # [Q, R] float32
    demand: np.ndarray,  # [Q, G, R] float32, queue-local priority order
    counts: np.ndarray,  # [Q] int32 pending gangs per queue
    device=None,
) -> np.ndarray:
    """The ordering pass on ``device`` (default: the card; raises without
    one). Returns ``[T, 2]`` int32 (queue, slot) rows, T = counts.sum(),
    in solve order: the first T steps of the scan, which are the JAX
    scan's rows trimmed to T."""
    device = resolve_device(device)
    q_dim = deserved.shape[0]
    r_dim = deserved.shape[1] if deserved.ndim == 2 else 0
    g_dim = demand.shape[1] if demand.ndim == 3 else 0
    total = int(counts.sum())
    if total == 0 or q_dim == 0:
        return np.zeros((0, 2), dtype=np.int32)
    if r_dim == 0:
        # degenerate: no resources anywhere -> every share is 0, ordering
        # degrades to deterministic queue-index round-robin via zero tensors
        r_dim = 1
        deserved = np.zeros((q_dim, 1), np.float32)
        usage = np.zeros((q_dim, 1), np.float32)
        demand = np.zeros((q_dim, max(g_dim, 1), 1), np.float32)

    def upload(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)

    order = fair_order_scan(
        upload(deserved, np.float32),
        upload(usage, np.float32),
        upload(demand, np.float32),
        upload(counts, np.int32),
        total,
    )
    return order.cpu().numpy()
