"""The port's batched fill against the JAX package's fill and Pallas kernel.

Inputs come from seeded numpy and go to both frameworks unchanged. Every
output is compared bit for bit: the fill's arithmetic is integer prefix
math plus IEEE divide/floor and a multiply-subtract of integer-valued
floats, exact in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grove_tpu.ops.packing import _fill
from grove_tpu.ops.pallas_fill import pallas_fill_batch
from grove_tpu_torch.ops.fill import _launch_shape, fill_batch, fill_batch_ref


def _inputs(seed, n, r, p, g, shared, zero_demand, zero_count):
    rng = np.random.default_rng(seed)
    shape = (n, r) if shared else (g, n, r)
    free = rng.integers(0, 32, shape).astype(np.float32)
    demand = rng.integers(1, 4, (g, p, r)).astype(np.float32)
    if zero_demand:  # demand 0 = no limit on that resource (whole rows too)
        demand[rng.random((g, p, r)) < 0.3] = 0.0
        demand[0, 0] = 0.0
    count = rng.integers(0, 6, (g, p)).astype(np.int32)
    if zero_count:
        count[rng.random((g, p)) < 0.4] = 0
    mask = rng.random((g, n)) < 0.5
    return free, mask, demand, count


def _torch(*arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


_JAX_FILL = {
    shared: jax.jit(jax.vmap(_fill, in_axes=(None if shared else 0, 0, 0, 0)))
    for shared in (True, False)
}

CASES = [
    pytest.param(seed, zd, zc, id=f"seed{seed}-zdemand{int(zd)}-zcount{int(zc)}")
    for seed in (0, 1, 2)
    for zd, zc in ((False, False), (True, False), (False, True), (True, True))
]


@pytest.mark.parametrize("seed,zero_demand,zero_count", CASES)
def test_ref_matches_pallas_kernel_interpret(seed, zero_demand, zero_count):
    free, mask, demand, count = _inputs(seed, 256, 3, 4, 8, True, zero_demand, zero_count)
    alloc, placed = pallas_fill_batch(
        jnp.asarray(free).T,
        jnp.asarray(mask.astype(np.float32))[:, None, :],
        jnp.asarray(demand),
        jnp.asarray(count)[..., None],
        interpret=True,
    )
    t_alloc, t_placed, _ = fill_batch_ref(*_torch(free, mask, demand, count))
    np.testing.assert_array_equal(np.asarray(alloc), t_alloc.numpy())
    np.testing.assert_array_equal(np.asarray(placed)[..., 0], t_placed.numpy())


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_gang"])
@pytest.mark.parametrize("seed,zero_demand,zero_count", CASES)
def test_ref_matches_jax_fill_per_gang(seed, zero_demand, zero_count, shared):
    free, mask, demand, count = _inputs(seed, 200, 2, 3, 6, shared, zero_demand, zero_count)
    # fill_batch on CPU tensors dispatches to fill_batch_ref and launches nothing
    before = fill_batch.launches
    t_alloc, t_placed, t_free = fill_batch(*_torch(free, mask, demand, count))
    assert fill_batch.launches == before
    assert t_alloc.dtype == torch.int32 and t_placed.dtype == torch.int32
    assert t_free.dtype == torch.float32 and t_free.shape == (6, 200, 2)
    # _fill is one gang's fill; vmapped over the gangs (free shared or not)
    alloc, placed, free_after = _JAX_FILL[shared](
        jnp.asarray(free), jnp.asarray(mask), jnp.asarray(demand), jnp.asarray(count)
    )
    np.testing.assert_array_equal(np.asarray(alloc), t_alloc.numpy())
    np.testing.assert_array_equal(np.asarray(placed), t_placed.numpy())
    np.testing.assert_array_equal(np.asarray(free_after), t_free.numpy())


def test_fill_batch_rejects_other_devices():
    free, mask, demand, count = _inputs(4, 16, 2, 1, 2, True, False, False)
    with pytest.raises(ValueError, match="unsupported device"):
        fill_batch(*_torch(free, mask, demand, count, device="meta"))


@pytest.mark.parametrize("fill", [fill_batch, fill_batch_ref], ids=["fill_batch", "ref"])
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_gang"])
def test_without_free_after_same_alloc_and_placed(fill, shared):
    args = _torch(*_inputs(8, 64, 2, 3, 5, shared, True, True))
    alloc, placed, free_after = fill(*args)
    alloc2, placed2, none = fill(*args, with_free_after=False)
    assert none is None and free_after is not None
    assert torch.equal(alloc, alloc2) and torch.equal(placed, placed2)


def test_ref_matches_jax_fill_when_prefix_wraps():
    """A zero-demand group with a count of 2^30: every capped fit is 2^20,
    the int32 prefix passes 2^31 after 2,048 nodes and wraps, and pods are
    taken again past the wrap — in both frameworks alike."""
    free, mask, demand, count = _inputs(9, 4096, 2, 2, 3, True, False, False)
    mask[:] = True
    demand[:, 0] = 0.0
    count[:, 0] = 1 << 30
    t_alloc, t_placed, t_free = fill_batch_ref(*_torch(free, mask, demand, count))
    # the prefix wrapped at node 2,048 and reads below the count again from
    # node 3,073 on
    assert int(t_alloc[:, 0, 1024:3073].abs().sum()) == 0
    assert bool((t_alloc[:, 0, 3073:] == 1 << 20).all())
    alloc, placed, free_after = _JAX_FILL[True](
        jnp.asarray(free), jnp.asarray(mask), jnp.asarray(demand), jnp.asarray(count)
    )
    np.testing.assert_array_equal(np.asarray(alloc), t_alloc.numpy())
    np.testing.assert_array_equal(np.asarray(placed), t_placed.numpy())
    np.testing.assert_array_equal(np.asarray(free_after), t_free.numpy())


@pytest.mark.parametrize(
    "shape,want",
    [
        # the wave solver's chunk: 8 CTAs per gang, two on each of 128 SMs
        ((32, 3, 5120, 2), (8, 320, 640, 640 * 9 + 3 * 56)),
        ((33, 3, 5120, 2), (8, 320, 640, 640 * 9 + 3 * 56)),  # 264 CTAs
        ((66, 3, 5120, 2), (4, 640, 1280, 1280 * 9 + 3 * 56)),
        ((67, 3, 5120, 2), (2, 1024, 2560, 2560 * 9 + 3 * 56)),
        ((133, 3, 5120, 2), (1, 1024, 5120, 5120 * 9 + 3 * 56)),
        ((1, 1, 1, 1), (8, 32, 4, 4 * 5 + 52)),  # N < K: 7 empty slices
        ((32, 3, 5000, 2), (8, 320, 628, 628 * 9 + 3 * 56)),  # ragged slices
        ((200, 3, 6144, 2), (1, 1024, 6144, 6144 * 9 + 3 * 56)),  # above 48 KB
        ((200, 1, 20000, 2), (2, 1024, 10000, 10000 * 9 + 56)),  # K raised to fit
        ((1, 2, 40000, 4), (8, 1024, 5000, 5000 * 17 + 2 * 64)),
        ((32, 3, 0, 2), (8, 32, 0, 3 * 56)),
    ],
)
def test_launch_shape(shape, want):
    k, threads, slice_, smem = _launch_shape(*shape)
    assert (k, threads, slice_, smem) == want
    c, p, n, r = shape
    assert k * slice_ >= n and slice_ % 4 == 0 and threads % 32 == 0
    assert smem <= 227 * 1024 and slice_ <= 16 * threads


def test_launch_shape_rejects_what_shared_memory_cannot_hold():
    with pytest.raises(ValueError, match="shared memory"):
        _launch_shape(1, 1, 140_000, 2)
    assert _launch_shape(1, 1, 131_072, 2)[0] == 8
    with pytest.raises(ValueError, match="shared memory"):
        _launch_shape(1, 1, 120_000, 4)
