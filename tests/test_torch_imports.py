"""The PyTorch port imports neither JAX nor anything of the JAX package."""

import ast
import pathlib
import subprocess
import sys
import textwrap

REPO = pathlib.Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "grove_tpu")


def _port_modules():
    pkg = REPO / "grove_tpu_torch"
    mods = []
    for path in sorted(pkg.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def _blocked(name: str) -> bool:
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)


def test_port_modules_import_with_jax_and_grove_tpu_blocked():
    mods = _port_modules()
    assert "grove_tpu_torch.ops.packing" in mods and len(mods) >= 20
    assert "grove_tpu_torch.solver.frontier" in mods
    for name in ("parallel.sharded", "parallel.ring", "parallel.multihost", "ops.nodeaxis",
                 "observability.journey", "observability.profile", "observability.explain",
                 "solver.introspect", "cluster.grpcsolver", "cluster.protos.solver_pb2",
                 "cluster.protos.health_pb2", "observability.timeseries", "observability.slo",
                 "observability.forecast", "observability.ledger", "observability.flightrec",
                 "observability.logging", "observability.hostinfo", "runtime.aggregate",
                 "utils.platform", "disruption", "disruption.broker", "disruption.drain",
                 "controller", "controller.nodehealth", "controller.remediate",
                 "runtime.backoff", "runtime.shards", "runtime.workqueue", "autoscale",
                 "autoscale.hpa", "api.load", "api.serialize", "api.hashing", "api.inspect",
                 "runtime.engine", "runtime.expectations", "runtime.indexer", "runtime.flow",
                 "config.operator", "admission.defaulting", "admission.validation",
                 "admission.authorization", "controller.common", "controller.register",
                 "controller.podclique.pods", "controller.podclique.status",
                 "controller.podclique.reconciler", "controller.podcliqueset.reconciler",
                 "controller.podcliqueset.components.infra",
                 "controller.podcliqueset.components.podclique",
                 "controller.podcliqueset.components.podgang",
                 "controller.podcliqueset.components.replica",
                 "controller.podcliqueset.components.scalinggroup",
                 "controller.podcliqueset.components.rollingupdate",
                 "controller.podcliquescalinggroup.reconciler", "utils.concurrent",
                 "initc.waiter", "sim.harness", "sim.deltachurn", "sim.scale",
                 "sim.multitenant", "sim.voluntary", "sim.demo", "sim.recovery",
                 "solver.oracle", "cluster.cert", "cluster.lease", "cluster.crdgen",
                 "cluster.autotopo", "cluster.client", "cluster.apidocs", "cluster.apiserver",
                 "cluster.webhook", "cluster.extscheduler", "cluster.manager",
                 "analysis", "analysis.sanitize", "sim.traffic", "sim.remediation",
                 "sim.chaos", "federation", "federation.quota", "federation.router",
                 "version", "cli", "__main__", "initc.__main__", "analysis.engine",
                 "analysis.inventory", "analysis.rules",
                 *(f"analysis.rules.{m}" for m in (
                     "clocks", "scheduling", "storepath", "jaxrules", "observability", "locks",
                     "apiwire", "dirtymask", "shardrules", "frontierrule", "glassbox",
                     "explainrule", "slorules", "workerrules", "ledgerrules", "procrules",
                     "federationrule", "grayfail"))):
        assert f"grove_tpu_torch.{name}" in mods
    script = textwrap.dedent(
        f"""
        import sys
        BLOCKED = {BLOCKED!r}

        class Block:
            def find_spec(self, name, path=None, target=None):
                if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {str(REPO)!r})
        import importlib
        for mod in {mods!r} + ["chip_smoke"]:
            importlib.import_module(mod)
        leaked = [m for m in sys.modules
                  if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
        assert not leaked, leaked
        print("ok", len({mods!r}))
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        timeout=120, cwd=str(REPO),
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("ok")


def test_sources_name_no_blocked_module():
    """Static check: no import statement of the port or of chip_smoke.py
    names jax, jaxlib or grove_tpu (lazy imports inside functions too)."""
    files = sorted((REPO / "grove_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad = [n for n in names if _blocked(n)]
            assert not bad, f"{path}: imports {bad}"


def test_sidecar_module_imports_without_grpc_and_protobuf():
    """grpcio and protobuf are optional: with both blocked (and JAX and the
    JAX package too) the sidecar module imports, ``solve_decoded`` solves on
    the CPU, and the wire layer raises only when it is used."""
    script = textwrap.dedent(
        f"""
        import sys
        BLOCKED = {BLOCKED!r} + ("grpc", "google.protobuf")

        class Block:
            def find_spec(self, name, path=None, target=None):
                if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {str(REPO)!r})
        from grove_tpu_torch.api.topology import ClusterTopology
        from grove_tpu_torch.cluster import grpcsolver
        from grove_tpu_torch.models.scenarios import stress_gang_specs
        from grove_tpu_torch.sim.cluster import make_nodes

        assert grpcsolver.grpc is None and grpcsolver.pb is None
        out = grpcsolver.solve_decoded(make_nodes(32), stress_gang_specs(8, seed=0),
                                       ClusterTopology(), device="cpu")
        assert len(out["placements"]) == 8 and any(p["admitted"] for p in out["placements"])
        for use in (lambda: grpcsolver.SolverServer(device="cpu"),
                    lambda: grpcsolver.SolverClient("127.0.0.1:1"),
                    lambda: grpcsolver.build_request(make_nodes(2), [])):
            try:
                use()
            except RuntimeError as exc:
                assert "grpcio" in str(exc) or "protobuf" in str(exc), exc
            else:
                raise AssertionError("the wire layer ran without grpc and protobuf")
        leaked = [m for m in sys.modules
                  if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
        assert not leaked, leaked
        print("ok")
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        timeout=120, cwd=str(REPO),
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("ok")
