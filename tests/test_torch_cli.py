"""The port's entry points (grove_tpu_torch/{cli,__main__,version}.py,
initc/__main__.py) against the JAX package's, on the CPU.

- Sim mode: every subcommand of ``models/scenarios.cli_sim_commands`` at
  the CLI's default of 32 nodes, the ten samples applied, and the error
  paths, each through ``grove_tpu_torch.cli.main(["--device", "cpu", ...])``
  and ``grove_tpu.cli.main([...])`` in this process on the same argv: the
  same exit code (or the same exception) and the same stdout less the uid's
  per-process token and, in trace, profile and journey, the durations
  (``mask_cli_stdout``). The singletons both CLIs read (TRACER, PROFILER,
  JOURNEYS, EVENTS, the uid sequence) are reset before each case and left
  off after it (ROADMAP C.8).
- Live mode: a port ``start_operator(device="cpu")`` and a JAX one, each on
  a free port, driven by each package's CLI with ``--apiserver`` (apply,
  get, tree, describe, scale, drain, uncordon, delete) and converged with
  ``converge_once`` between the writes: the same exit codes and stdout less
  the uid's token, the apiserver's address and the wall-clock timestamps,
  and the same resource versions.
- initc: each package's ``main`` against a live port apiserver, the cases
  of tests/test_initc_binary.py: the same exit codes and messages.
- Every subcommand of the JAX CLI but ``bench`` is offered with the same
  flags; without ``--device`` and without a card the sim-backed commands and
  ``run`` raise; ROADMAP C.9 (``federation --output json`` raises
  ``NameError``) holds in both; ``version`` equals the JAX package's.
"""

import contextlib
import io
import os
import pathlib
import re
import subprocess
import sys
import threading
import time

import pytest
import torch

import grove_tpu
import grove_tpu.cli as jax_cli
import grove_tpu_torch
import grove_tpu_torch.cli as port_cli
from grove_tpu_torch.models.scenarios import (
    CLI_QUEUE_SAMPLE,
    CLI_SAMPLE,
    CLUSTER_CONFIG_YAML,
    _http_json,
    cli_live_converged,
    cli_sim_commands,
    mask_cli_stdout,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
NODES = 32  # the CLI's default


def _reset_singletons():
    """Both packages' glass-box singletons off and empty, the event
    recorder unsharded, a fresh uid sequence (the JAX package's tests can
    leave them on: ROADMAP C.8)."""
    for root in ("grove_tpu", "grove_tpu_torch"):
        tracing = __import__(f"{root}.observability.tracing", fromlist=["TRACER"])
        profile = __import__(f"{root}.observability.profile", fromlist=["PROFILER"])
        journey = __import__(f"{root}.observability.journey", fromlist=["JOURNEYS"])
        events = __import__(f"{root}.observability.events", fromlist=["EVENTS"])
        meta = __import__(f"{root}.api.meta", fromlist=["reset_uid_namespace"])
        for singleton in (tracing.TRACER, profile.PROFILER, journey.JOURNEYS):
            singleton.disable()
            singleton.reset()
        events.EVENTS.reset()
        events.EVENTS.shard_fn = None
        meta.reset_uid_namespace()


@pytest.fixture(autouse=True)
def _fresh_singletons():
    _reset_singletons()
    yield
    _reset_singletons()


def _run(main, argv):
    """(exit code or the exception's type and text, stdout, stderr) of one
    in-process CLI call."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except Exception as e:  # both CLIs must raise alike
            rc = (type(e).__name__, str(e))
    return rc, out.getvalue(), err.getvalue()


def _both(argv):
    """Each CLI on the same argv from the repository root (the port on the
    CPU), singletons reset before each."""
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        _reset_singletons()
        want = _run(jax_cli.main, list(argv))
        _reset_singletons()
        got = _run(port_cli.main, ["--device", "cpu"] + list(argv))
    finally:
        os.chdir(cwd)
    return got, want


@pytest.fixture(scope="module")
def config_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "operator-config.yaml"
    path.write_text(CLUSTER_CONFIG_YAML)
    return str(path)


@pytest.mark.parametrize("name", list(cli_sim_commands(NODES)))
def test_sim_command_matches_jax(name, config_path):
    argv = cli_sim_commands(NODES, config_path)[name]
    (rc, out, _), (want_rc, want_out, _) = _both(argv)
    assert rc == want_rc == 0
    assert mask_cli_stdout(name, out) == mask_cli_stdout(name, want_out)


_PCS_SAMPLES = sorted(p.name for p in (REPO / "samples").glob("*.yaml")
                      if p.name not in ("multitenant-queues.yaml", "cluster-topology-tpu.yaml"))

# more argv: every PodCliqueSet sample applied, other kinds and flags, and
# the error paths (usage errors exit 2, a missing object 1)
_CASES = {
    **{f"apply {s}": ["apply", f"samples/{s}"] for s in _PCS_SAMPLES},
    "apply queues sample": ["apply", CLI_QUEUE_SAMPLE],
    "tree without manifests": ["tree"],
    "tree bad --scale": ["tree", CLI_SAMPLE, "--scale", "workers=x"],
    "tree unknown group": ["tree", CLI_SAMPLE, "--scale", "nosuch=2"],
    "get pods": ["get", CLI_SAMPLE, "--kind", "Pod", "--namespace", "default"],
    "get unknown kind": ["get", CLI_SAMPLE, "--kind", "Bogus"],
    "get --watch without apiserver": ["get", CLI_SAMPLE, "--watch"],
    "get nothing": ["get"],
    "describe podclique": ["describe", "simple1-0-frontend", CLI_SAMPLE, "--kind", "PodClique"],
    "describe missing": ["describe", "nosuch", CLI_SAMPLE],
    "queues without manifests": ["queues"],
    "queues wrong kind": ["queues", "samples/cluster-topology-tpu.yaml"],
    "nodes bare cluster": ["nodes"],
    "capacity bare cluster": ["capacity"],
    "explain unknown gang": ["explain", CLI_SAMPLE, "--gang", "nosuch"],
    "journey one gang": ["journey", CLI_SAMPLE, "--gang", "simple1-0"],
    "whatif no action": ["whatif", CLI_SAMPLE, "--gang", "simple1-0"],
    "whatif bad resource map": ["whatif", CLI_SAMPLE, "--gang", "simple1-0", "--set-queue", "q",
                                "--deserved", "cpu"],
    "whatif add nodes": ["whatif", CLI_SAMPLE, "--gang", "simple1-0", "--add-nodes", "2",
                         "--like", "node-0"],
    "slo without apiserver": ["slo"],
    "federation without apiserver": ["federation"],
    "forecast without apiserver": ["forecast"],
    "ledger without apiserver": ["ledger"],
    "config-check invalid": ["config-check", "samples/simple1.yaml"],
    "validate queues": ["validate", CLI_QUEUE_SAMPLE],
}


@pytest.mark.parametrize("name", list(_CASES))
def test_other_argv_matches_jax(name):
    (rc, out, err), (want_rc, want_out, want_err) = _both(_CASES[name])
    assert rc == want_rc
    assert mask_cli_stdout(name, out) == mask_cli_stdout(name, want_out)
    assert err == want_err


def test_validate_reports_an_invalid_manifest_as_jax(tmp_path):
    bad = tmp_path / "bad.yaml"
    text = (REPO / CLI_SAMPLE).read_text().replace("replicas: 1", "replicas: -1", 1)
    assert text != (REPO / CLI_SAMPLE).read_text()
    bad.write_text(text)
    (rc, out, _), (want_rc, want_out, _) = _both(["validate", str(bad)])
    assert rc == want_rc == 1
    assert out == want_out and "INVALID" in out


# every subcommand of grove_tpu/cli.py but bench
_SUBCOMMANDS = ("validate", "apply", "delete", "scale", "tree", "get", "describe", "queues",
                "nodes", "drain", "uncordon", "trace", "profile", "journey", "slo", "federation",
                "forecast", "ledger", "explain", "capacity", "whatif", "config-check", "crds",
                "api-docs", "detect-topology", "run")


@pytest.mark.parametrize("sub", _SUBCOMMANDS)
def test_subcommand_offers_the_jax_flags(sub):
    def help_text(main, argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as ex:
            main(argv)
        assert ex.value.code == 0
        return out.getvalue()

    want = help_text(jax_cli.main, [sub, "--help"])
    got = help_text(port_cli.main, [sub, "--help"])
    # the usage lines wrap at the program's name, which differs
    assert got.replace("grove-tpu-torch", "grove-tpu").split() == want.split()


def test_bench_is_not_offered():
    with contextlib.redirect_stderr(io.StringIO()), pytest.raises(SystemExit) as ex:
        port_cli.main(["bench"])
    assert ex.value.code == 2


@pytest.mark.parametrize("sub", ["apply", "tree", "get", "describe", "queues", "nodes", "trace",
                                 "profile", "journey", "explain", "capacity", "whatif", "run"])
def test_without_device_a_sim_backed_command_raises_without_a_card(sub):
    if torch.cuda.is_available():
        pytest.skip("the card is present: the CLI runs on it")
    argv = {"describe": ["describe", "simple1", CLI_SAMPLE],
            "whatif": ["whatif", CLI_SAMPLE, "--gang", "simple1-0", "--drain", "node-0"],
            "run": ["run"]}.get(sub, [sub, CLI_SAMPLE])
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        with contextlib.redirect_stdout(io.StringIO()), \
                pytest.raises(RuntimeError, match="no CUDA device available"):
            port_cli.main(argv)
    finally:
        os.chdir(cwd)


def test_federation_json_raises_name_error_as_in_jax(monkeypatch):
    """ROADMAP C.9: ``_cmd_federation`` prints with ``json``, which cli.py
    never imports at module scope; the port keeps the fault."""
    for module in (jax_cli, port_cli):
        monkeypatch.setattr(module, "_fetch_server_json", lambda *a: {"regions": {}})
        with pytest.raises(NameError, match="name 'json' is not defined"):
            module.main(["federation", "--apiserver", "http://x", "--output", "json"])
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert module.main(["federation", "--apiserver", "http://x"]) == 0
        assert out.getvalue().startswith("federation: 0 cluster(s)")


def test_version_equals_jax():
    from grove_tpu import version as jax_version
    from grove_tpu_torch import version as port_version

    assert grove_tpu_torch.__version__ == grove_tpu.__version__
    assert port_version.get().__dict__ == jax_version.get().__dict__
    assert (port_version.VERSION, port_version.INIT_WAITER_CONTRACT) == (
        jax_version.VERSION, jax_version.INIT_WAITER_CONTRACT)


def test_python_m_runs_the_cli():
    proc = subprocess.run([sys.executable, "-m", "grove_tpu_torch", "validate", CLI_SAMPLE],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == "samples/simple1.yaml: simple1: OK\n"


# ---------------------------------------------------------------------------
# live mode: each package's CLI against its own operator
# ---------------------------------------------------------------------------

_RESOURCE_VERSIONS = re.compile(r"resourceVersion: \S+")
_LIVE_STEPS = ("apply", "get", "tree", "describe", "scale", "tree scaled", "get pods", "drain",
               "uncordon", "delete")


def _drive_live(root: str, cli_main, device_args):
    """Boot ``root``'s operator on 32 nodes, then the live steps through
    ``cli_main``; name -> (rc, stdout masked)."""
    manager = __import__(f"{root}.cluster.manager", fromlist=["start_operator"])
    cluster = __import__(f"{root}.sim.cluster", fromlist=["make_nodes"])
    kw = {"device": "cpu"} if root == "grove_tpu_torch" else {}
    _reset_singletons()
    rt = manager.start_operator(nodes=cluster.make_nodes(NODES), **kw)
    url = rt.apiserver.address
    out = {}

    def settle(done, what):
        for _ in range(200):
            rt.converge_once()
            if done():
                return
        raise AssertionError(f"{root}: {what} not reached")

    def step(name, *argv):
        rc, text, _ = _run(cli_main, device_args + list(argv) + ["--apiserver", url])
        # stepped by converge_once, the resource versions are the same in
        # both packages (a `run` child's follow its lease's renewals)
        out[name] = (rc, mask_cli_stdout(name, text, url), _RESOURCE_VERSIONS.findall(text))

    def drained():
        nodes = _http_json("GET", f"{url}/nodes")["items"]
        return any(n["name"] == f"node-{NODES - 1}" and n["drain"] == "Drained" for n in nodes)

    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        step("apply", "apply", CLI_SAMPLE)
        settle(lambda: cli_live_converged(url, 1), "simple1 converged")
        step("get", "get", "--kind", "PodGang")
        step("tree", "tree")
        step("describe", "describe", "simple1")
        step("scale", "scale", "simple1", "--replicas", "2")
        settle(lambda: cli_live_converged(url, 2), "two replicas converged")
        step("tree scaled", "tree")
        step("get pods", "get", "--kind", "Pod", "--namespace", "default")
        step("drain", "drain", f"node-{NODES - 1}")
        settle(drained, "the last node drained")
        step("uncordon", "uncordon", f"node-{NODES - 1}")
        step("delete", "delete", "simple1")
        settle(lambda: True, "one round after the delete")
    finally:
        os.chdir(cwd)
        rt.shutdown()
        _reset_singletons()
    return out


@pytest.fixture(scope="module")
def live_runs():
    return (_drive_live("grove_tpu_torch", port_cli.main, ["--device", "cpu"]),
            _drive_live("grove_tpu", jax_cli.main, []))


@pytest.mark.parametrize("step", _LIVE_STEPS)
def test_live_step_matches_jax(step, live_runs):
    got, want = (run[step] for run in live_runs)
    assert got == want
    assert got[0] == 0


# ---------------------------------------------------------------------------
# initc: each package's waiter against a live port apiserver
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def apiserver():
    from grove_tpu_torch.cluster.apiserver import APIServer

    server = APIServer().start()
    yield server
    server.stop()


def _pod(name, gang, pclq):
    from grove_tpu_torch.api import names as namegen
    from grove_tpu_torch.api.meta import ObjectMeta
    from grove_tpu_torch.api.pod import Pod

    return Pod(metadata=ObjectMeta(name=name, namespace="default", labels={
        namegen.LABEL_PODGANG: gang, namegen.LABEL_PODCLIQUE: pclq}))


def _set_ready(client, name):
    from grove_tpu_torch.api.meta import Condition, set_condition
    from grove_tpu_torch.api.pod import COND_POD_READY

    pod = client.get("Pod", "default", name)
    set_condition(pod.status.conditions,
                  Condition(type=COND_POD_READY, status="True", reason="Started"), time.time())
    client.update_status(pod)


def _initc_mains():
    from grove_tpu.initc.__main__ import main as jax_main
    from grove_tpu_torch.initc.__main__ import main as port_main

    return port_main, jax_main


def _pod_info(tmp_path, gang):
    (tmp_path / "namespace").write_text("default\n")
    (tmp_path / "podgang").write_text(gang + "\n")
    return str(tmp_path)


@pytest.mark.parametrize("case", ["no parents", "malformed flag", "no apiserver",
                                  "pod-info missing", "times out", "parents ready"])
def test_initc_exit_code_and_message_match_jax(case, apiserver, tmp_path, monkeypatch):
    from grove_tpu_torch.cluster.client import HttpStore

    monkeypatch.delenv("GROVE_APISERVER", raising=False)
    url = apiserver.address
    gang = f"{case.replace(' ', '-')}-0"
    info = _pod_info(tmp_path, gang)
    argv = {
        "no parents": [],
        "malformed flag": ["--apiserver", "http://127.0.0.1:1", "--podcliques", "not-a-flag"],
        "no apiserver": ["--podcliques", f"{gang}-a:1"],
        "pod-info missing": ["--apiserver", url, "--pod-info-dir", str(tmp_path / "none"),
                             "--podcliques", f"{gang}-a:1"],
        "times out": ["--apiserver", url, "--pod-info-dir", info, "--podcliques", f"{gang}-a:1",
                      "--poll-interval", "0.1", "--timeout", "0.6"],
        "parents ready": ["--apiserver", url, "--pod-info-dir", info, "--podcliques",
                          f"{gang}-a:2", "--poll-interval", "0.1", "--timeout", "30"],
    }[case]
    client = HttpStore(url)
    if case in ("times out", "parents ready"):
        for i in range(2):
            client.create(_pod(f"{gang}-a-{i}", gang, f"{gang}-a"))
    if case == "parents ready":
        for i in range(2):
            _set_ready(client, f"{gang}-a-{i}")
    results = [_run(main, argv) for main in _initc_mains()]
    assert results[0] == results[1]
    assert results[0][0] == {"no parents": 0, "malformed flag": 2, "no apiserver": 2,
                             "pod-info missing": 2, "times out": 1, "parents ready": 0}[case]


@pytest.mark.parametrize("which", ["port", "jax"])
def test_initc_blocks_until_parents_ready(which, apiserver, tmp_path):
    from grove_tpu_torch.cluster.client import HttpStore

    gang = f"block-{which}-0"
    client = HttpStore(apiserver.address)
    for i in range(2):
        client.create(_pod(f"{gang}-prefill-{i}", gang, f"{gang}-prefill"))
    main = dict(zip(("port", "jax"), _initc_mains()))[which]
    result = {}
    argv = ["--apiserver", apiserver.address, "--pod-info-dir", _pod_info(tmp_path, gang),
            "--podcliques", f"{gang}-prefill:2", "--poll-interval", "0.1", "--timeout", "30"]
    waiter = threading.Thread(target=lambda: result.update(out=_run(main, argv)), daemon=True)
    waiter.start()
    time.sleep(0.5)
    assert waiter.is_alive(), result
    _set_ready(client, f"{gang}-prefill-0")
    time.sleep(0.5)
    assert waiter.is_alive(), "initc unblocked below minAvailable"
    _set_ready(client, f"{gang}-prefill-1")
    waiter.join(timeout=20)
    rc, out, _ = result["out"]
    assert rc == 0 and out == "grove-tpu-initc: all parent cliques ready; starting\n"
