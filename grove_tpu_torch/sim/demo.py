"""Quickstart demo: apply a PodCliqueSet manifest to the simulated cluster and
print the materialized resource tree (the reference README.md:26 flow).

Counterpart of ``grove_tpu/sim/demo.py``, on the card:

    python -m grove_tpu_torch.sim.demo grove_tpu_torch/models/samples/simple1.yaml

The card is probed first; an unhealthy card raises (the port never falls
back to the CPU). ``--device cpu`` runs the demo on the CPU and skips the
probe.
"""

from __future__ import annotations

import argparse
from typing import Optional

from grove_tpu_torch.sim.harness import SimHarness


def run_demo(manifest_text: str, nodes: int = 32, device=None) -> str:
    """Apply the manifest, converge, and return what the demo prints."""
    harness = SimHarness(num_nodes=nodes, device=device)
    applied = harness.apply_yaml(manifest_text)
    ticks = harness.converge()
    return (
        f"applied {', '.join(p.metadata.name for p in applied)}; "
        f"converged in {ticks} virtual ticks "
        f"(t={harness.clock.now():.0f}s)\n\n" + harness.tree()
    )


def main(argv: Optional[list] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("manifest", help="PodCliqueSet YAML (reference CR format)")
    parser.add_argument("--nodes", type=int, default=32)
    parser.add_argument("--device", default=None, help="torch device (default: the card)")
    args = parser.parse_args(argv)
    if args.device is None:
        from grove_tpu_torch.utils.platform import ensure_healthy_backend

        ensure_healthy_backend(timeout_s=45.0)
    with open(args.manifest) as f:
        text = f.read()
    print(run_demo(text, nodes=args.nodes, device=args.device), end="")


if __name__ == "__main__":
    main()
