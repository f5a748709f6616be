"""State carried across: problems from other encoders, arrays to the device.

``problem_from_arrays`` accepts any object or dict holding
``PackingProblem``'s numpy fields (for example a problem encoded by the JAX
package, duck-typed) and returns the port's ``PackingProblem`` with every
array copied at its own dtype. ``problem_to_device`` uploads the node-side
tensors that every wave of the solver reads.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Union

import numpy as np
import torch

from grove_tpu_torch.solver.types import PackingProblem

_FIELDS = tuple(f.name for f in dataclasses.fields(PackingProblem))


def problem_from_arrays(obj: Union[Mapping, object]) -> PackingProblem:
    """The port's ``PackingProblem`` from an object or dict with its fields.
    Arrays are copied with their dtypes unchanged; name lists are copied;
    missing optional fields stay None."""
    get = obj.get if isinstance(obj, Mapping) else (
        lambda name: getattr(obj, name, None)
    )
    values = {}
    for name in _FIELDS:
        value = get(name)
        if isinstance(value, np.ndarray):
            value = value.copy()
        elif isinstance(value, list):
            value = [list(v) if isinstance(v, list) else v for v in value]
        if value is not None:
            values[name] = value
    return PackingProblem(**values)


def problem_to_device(
    problem: PackingProblem, device: Union[str, torch.device]
) -> Dict[str, torch.Tensor]:
    """Node-side tensors on ``device``: ``capacity [N,R] f32``, ``topo [N,L]
    i32``, ``seg_starts``/``seg_ends [L,D] i32`` (dtypes as encoded)."""
    return {
        name: torch.from_numpy(np.ascontiguousarray(getattr(problem, name))).to(
            device
        )
        for name in ("capacity", "topo", "seg_starts", "seg_ends")
    }
