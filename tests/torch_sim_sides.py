"""One package's names, as the sim scenarios' worlds read them.

``sim_side("grove_tpu")`` and ``sim_side("grove_tpu_torch", device="cpu")``
give ``models/scenarios.run_churn_world``, ``run_scale_world``,
``run_sims_world`` and ``run_operator_world`` the same names from either
package, both built by ``models/scenarios.package_names``. The JAX side's
``demo_text`` runs the JAX demo's own ``main`` on a temporary manifest and
keeps what it prints less its backend note; the port's is
``grove_tpu_torch.sim.demo.run_demo``. Used by the CPU tests and by
``scripts/scheduler_reference.py``.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import os
import sys
import tempfile
import types

from grove_tpu_torch.models.scenarios import package_names, port_names


def jax_demo_text(text: str) -> str:
    """What ``python -m grove_tpu.sim.demo <manifest>`` prints, less its
    ``note:`` line."""
    from grove_tpu.sim import demo

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "manifest.yaml")
        with open(path, "w") as f:
            f.write(text)
        argv, sys.argv = sys.argv, ["demo", path]
        out = io.StringIO()
        try:
            with contextlib.redirect_stdout(out):
                demo.main()
        finally:
            sys.argv = argv
    return "".join(line for line in out.getvalue().splitlines(keepends=True)
                   if not line.startswith("note: "))


def sim_side(root: str, device=None) -> types.SimpleNamespace:
    if root == "grove_tpu_torch":
        return port_names(device)
    return package_names(lambda path: importlib.import_module(f"{root}.{path}"),
                         jax_demo_text, root)
