"""Tests of the port that need the card (marked ``gpu``; skipped without CUDA).

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed:

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

The CUDA fill kernel is held bit for bit against its plain PyTorch version,
alone and inside the wave solver; the solver on the card is also held
against the same solver on the CPU (which the CPU tests hold against the
JAX package).
"""

import numpy as np
import pytest
import torch

from grove_tpu_torch.models.scenarios import build_stress_problem
from grove_tpu_torch.ops.fill import fill_batch, fill_batch_ref
from grove_tpu_torch.solver.kernel import solve_waves

FIELDS = ("admitted", "placed", "score", "chosen_level", "alloc", "free_after")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the fill kernel has no CPU mode)")
    return torch.device("cuda")


def _fill_inputs(seed, shared, density):
    rng = np.random.default_rng(seed)
    c, p, n, r = 32, 3, 5120, 2
    free = rng.integers(0, 129, (n, r) if shared else (c, n, r)).astype(np.float32)
    mask = rng.random((c, n)) < density
    demand = rng.integers(0, 9, (c, p, r)).astype(np.float32)
    demand[rng.random((c, p, r)) < 0.2] = 0.0
    count = rng.integers(0, 40, (c, p)).astype(np.int32)
    count[rng.random((c, p)) < 0.2] = 0
    return free, mask, demand, count


@pytest.mark.gpu
@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_gang"])
def test_cuda_kernel_matches_plain_version(cuda, shared, density):
    args = [torch.from_numpy(a).to(cuda) for a in _fill_inputs(5, shared, density)]
    before = fill_batch.launches
    got = fill_batch(*args)
    torch.cuda.synchronize()
    assert fill_batch.launches == before + 1
    for a, b in zip(got, fill_batch_ref(*args)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.gpu
def test_cuda_kernel_rejects_wrong_dtype(cuda):
    free, mask, demand, count = _fill_inputs(6, True, 0.5)
    args = [torch.from_numpy(a).to(cuda) for a in (free, mask, demand, count.astype(np.int64))]
    with pytest.raises(TypeError, match="count"):
        fill_batch(*args)


@pytest.mark.gpu
def test_cuda_solve_matches_plain_fill_and_cpu(cuda):
    problem = build_stress_problem(512, 1024)
    before = fill_batch.launches
    kern = solve_waves(problem, chunk_size=32, device=cuda)
    assert fill_batch.launches > before
    plain = solve_waves(problem, chunk_size=32, device=cuda, fill=fill_batch_ref)
    cpu = solve_waves(problem, chunk_size=32, device="cpu")
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(kern, name), getattr(plain, name), err_msg=name)
        np.testing.assert_array_equal(getattr(kern, name), getattr(cpu, name), err_msg=name)
