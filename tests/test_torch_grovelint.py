"""grovelint over the port (grove_tpu_torch/analysis) against the JAX package's.

- Every fixture snippet of tests/test_grovelint.py (bad and good twin of each
  rule, the pragma contract's snippets) goes through both engines'
  ``lint_source``, its path under ``grove_tpu/`` mapped to
  ``grove_tpu_torch/``: the same violations (rule, line, column, message with
  the path mapped) and suppressions. GL005 checks torch hygiene in the port,
  so its JAX fixtures are replaced by torch fixtures for each class it flags.
- The live-tree mutations of tests/test_grovelint.py, grafted onto the
  port's own sources: the rule fires as often as on the JAX source, and the
  port's untouched source is clean for it.
- The port's whole tree: 0 violations and the JAX tree's 9 suppressions
  (rule, mapped path and justification); the port's inventory of event
  reasons, metric names and profiler phases equals the JAX package's;
  ``scripts/torch_lint.py --no-check`` exits 0.
"""

import json
import pathlib
import subprocess
import sys

import pytest

from grove_tpu.analysis import engine as jax_engine
from grove_tpu.analysis import inventory as jax_inventory
from grove_tpu_torch.analysis import engine as port_engine
from grove_tpu_torch.analysis import inventory as port_inventory
from tests.test_grovelint import FIXTURES

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _port(text: str) -> str:
    return text.replace("grove_tpu/", "grove_tpu_torch/").replace("grove_tpu.", "grove_tpu_torch.")


def _view(report, to_port=False):
    """(rule, line, col, message) of violations and suppressions, each with
    ``grove_tpu/`` mapped to ``grove_tpu_torch/`` on the JAX side."""
    fix = _port if to_port else (lambda t: t)
    return ([(v.rule, v.line, v.col, fix(v.message)) for v in report.violations],
            [(v.rule, v.line, v.col, fix(v.message), v.justification)
             for v in report.suppressed])


# the engine contract's snippets (tests/test_grovelint.py section 3)
_PRAGMA_SNIPPETS = {
    "justified": "import time\n\ndef tick(self):\n"
                 "    t = time.time()  # grovelint: disable=GL001 -- boot anchor\n",
    "preceding-line": "import time\n\ndef tick(self):\n"
                      "    # grovelint: disable=GL001 -- boot anchor\n    t = time.time()\n",
    "bare": "import time\n\ndef tick(self):\n    t = time.time()  # grovelint: disable=GL001\n",
    "bare-wildcard": "import time\n\ndef tick(self):\n    t = time.time()  # grovelint: disable=*\n",
    "other-rule": "import time\n\ndef tick(self):\n"
                  "    t = time.time()  # grovelint: disable=GL007 -- wrong rule\n",
    "unregistered-reason": "def emit(self, ref):\n"
                           "    EVENTS.record(ref, 'Warning', 'GangDeferredX', 'm')\n",
    "registered-reason": "def emit(self, ref):\n"
                         "    EVENTS.record(ref, 'Warning', 'GangDeferred', 'm')\n",
}

_SNIPPETS = [(f"{rule} {twin}", fx["rel"], fx[twin])
             for rule, fx in sorted(FIXTURES.items()) if rule != "GL005"
             for twin in ("bad", "good")] + [
    (f"pragma {name}", "grove_tpu/sim/fixture.py", src)
    for name, src in _PRAGMA_SNIPPETS.items()]


@pytest.mark.parametrize("name,rel,src", _SNIPPETS, ids=[s[0] for s in _SNIPPETS])
def test_fixture_snippet_lints_as_in_jax(name, rel, src):
    want = jax_engine.lint_source(src, rel)
    got = port_engine.lint_source(src, _port(rel))
    assert _view(got) == _view(want, to_port=True)
    assert got.ok == want.ok
    if name.endswith(" bad"):
        assert name.split()[0] in {v.rule for v in got.violations}


# GL005 in the port: one bad snippet a class the rule flags (the region kind
# varies), its good twin the same code outside any device region
_TORCH_HEAD = "import time\nimport torch\n\n"
_GL005 = {
    "print": ("@torch.library.custom_op('t::op', mutates_args=())\n"
              "def op(x: torch.Tensor) -> torch.Tensor:\n    print(x)\n    return x.clone()\n",
              "`print()`"),
    "global": ("def solve(x):\n    def lane(v):\n        global SEEN\n        return v\n"
               "    return torch.func.vmap(lane)(x)\n", "`global` mutation"),
    "float64-attr": ("@torch.library.custom_op('t::op', mutates_args=())\n"
                     "def op(x: torch.Tensor) -> torch.Tensor:\n"
                     "    return x.to(torch.float64)\n", "`torch.float64` dtype"),
    "float64-literal": ("def solve(x):\n    return torch.vmap(lambda v: v.to('float64'))(x)\n",
                        "'float64' dtype literal"),
    "item": ("@op.register_vmap\ndef op_vmap(info, in_dims, x):\n"
             "    return x.sum().item(), 0\n", "`.item()` host sync"),
    "tolist": ("def solve(x):\n    def lane(v):\n        return v.tolist()\n"
               "    return torch.func.vmap(lane)(x)\n", "`.tolist()` host sync"),
    "cpu": ("@op.register_fake\ndef op_fake(x):\n    return x.cpu()\n", "`.cpu()` host sync"),
    "synchronize": ("def solve(x):\n    def lane(v):\n        torch.cuda.synchronize()\n"
                    "        return v\n    return torch.func.vmap(lane)(x)\n",
                    "`torch.cuda.synchronize()` host sync"),
    "wall-clock": ("@torch.library.register_kernel('t::op', 'cpu')\ndef op_cpu(x):\n"
                   "    t = time.perf_counter()\n    return x\n", "wall-clock `time.perf_counter()`"),
}


def _unregioned(src: str) -> str:
    """The same body, but plain: no torch.library decorator, no vmap."""
    lines = [ln for ln in src.splitlines() if not ln.startswith("@")]
    return "\n".join(ln.replace("torch.func.vmap(lane)", "lane").replace(
        "torch.vmap(", "(") for ln in lines) + "\n"


@pytest.mark.parametrize("cls", sorted(_GL005))
def test_gl005_flags_each_torch_class_inside_a_device_region(cls):
    src, message = _GL005[cls]
    rel = "grove_tpu_torch/ops/fixture.py"
    bad = port_engine.lint_source(_TORCH_HEAD + src, rel)
    hits = [v.message for v in bad.violations if v.rule == "GL005"]
    assert any(message in m for m in hits), hits
    good = port_engine.lint_source(_TORCH_HEAD + _unregioned(src), rel)
    assert not [v for v in good.violations if v.rule == "GL005"], good.render_human()
    # path scope: the same device region outside ops/, solver/kernel.py and
    # quota/ordering.py is not GL005's
    assert not [v for v in port_engine.lint_source(
        _TORCH_HEAD + src, "grove_tpu_torch/sim/fixture.py").violations if v.rule == "GL005"]


@pytest.mark.parametrize("src,message", [
    ("from grove_tpu_torch.ops import _build\n\n_LIB = _build.load('fill')\n",
     "`_build.load()` at module import"),
    ("import ctypes\n\nLIB = ctypes.CDLL('libfill.so')\n", "`ctypes.CDLL()` at module import"),
    ("import triton\n", "`import triton` at module import"),
    ("class K:\n    lib = _build.load_all(['fill'])\n", "`_build.load_all()` at module import"),
], ids=["build-load", "ctypes", "triton", "class-body"])
def test_gl005_flags_a_kernel_build_at_import(src, message):
    rel = "grove_tpu_torch/quota/ordering.py"
    hits = [v.message for v in port_engine.lint_source(src, rel).violations if v.rule == "GL005"]
    assert any(message in m for m in hits), hits
    # inside a function (first use) it is the port's rule, not a violation
    lazy = "def load():\n" + "".join(f"    {ln}\n" for ln in src.splitlines() if ln)
    assert not [v for v in port_engine.lint_source(lazy, rel).violations if v.rule == "GL005"]


# tests/test_grovelint.py's live-tree mutations: (rule, source, rogue text)
_MUTATIONS = [
    ("GL011", "grove_tpu/controller/nodehealth.py",
     "\n\ndef _rogue_fast_path(store, kind, key):\n    store._committed[kind].pop(key, None)\n"),
    ("GL013", "grove_tpu/runtime/engine.py",
     "\n\ndef _rogue_shard_tap(store):\n    for shard in store._shards:\n"
     "        shard.system_watchers.clear()\n"),
    ("GL014", "grove_tpu/solver/scheduler.py",
     "\n\ndef _rogue_replan(sched, plan, starts):\n    sched.frontier._plan = plan\n"
     "    sched.frontier.subproblems_total = 0\n    sched.frontier._plan.starts = starts\n"),
    ("GL015", "grove_tpu/runtime/engine.py",
     "\n\ndef _rogue_cook_coverage(key, seconds):\n    PROFILER._hist.clear()\n"
     "    PROFILER._toplevel_s = seconds\n    PROFILER.enabled = True\n"),
    ("GL016", "grove_tpu/solver/introspect.py",
     "\n\ndef _rogue_bind(scheduler, pod):\n    scheduler.cluster.bind(pod, 'node-0')\n"),
    ("GL017", "grove_tpu/sim/harness.py",
     "\n\ndef _rogue_fabricate_history(name):\n    TIMESERIES._series[name] = None\n"
     "    TIMESERIES._now = 0.0\n"),
    ("GL018", "grove_tpu/solver/scheduler.py",
     "\n\ndef _rogue_steal_backlog(engine):\n    ev = engine._backlogs[1].popleft()\n"
     "    engine._backlog_rotation = 0\n"),
    ("GL019", "grove_tpu/controller/remediate.py",
     "\n\ndef _rogue_quiet_drain(self, node):\n    self.drainer.request_drain(node)\n"),
    ("GL020", "grove_tpu/runtime/procworkers.py",
     "\n\ndef _rogue_ship_object(conn, obj):\n    conn.send(obj)\n    return conn.recv()\n"),
    ("GL021", "grove_tpu/sim/chaos.py",
     "\n\ndef _rogue_move(router, key, region):\n    router._placements[key] = region\n"
     "    router.reroutes += 1\n"),
    ("GL022", "grove_tpu/sim/chaos.py",
     "\n\ndef _rogue_quiet(monitor, sd, drain):\n    monitor._suspicion.clear()\n"
     "    sd.degraded_mode = 'ok'\n"),
]
_DELETIONS = [
    ("GL003", "grove_tpu/solver/scheduler.py",
     "nodes = [n for n in self.cluster.nodes if n.schedulable]", "nodes = list(self.cluster.nodes)"),
    ("GL002", "grove_tpu/solver/scheduler.py",
     'and not broker.grant(victims_chosen, "preemption")', "and False"),
    ("GL002", "grove_tpu/controller/podcliqueset/components/rollingupdate.py",
     "_disruption_granted", "_always_true"),
]


def _rule_count(engine, rule, src, rel):
    rules = [r for r in engine.default_rules() if r.id == rule]
    return sum(1 for v in engine.lint_source(src, rel, rules).violations if v.rule == rule)


@pytest.mark.parametrize("rule,rel,rogue", _MUTATIONS, ids=[f"{m[0]}-{m[1].split('/')[-1]}"
                                                            for m in _MUTATIONS])
def test_grafted_mutation_fires_as_in_jax(rule, rel, rogue):
    jax_src, port_src = (ROOT / rel).read_text(), (ROOT / _port(rel)).read_text()
    assert _rule_count(port_engine, rule, port_src, _port(rel)) == 0
    want = _rule_count(jax_engine, rule, jax_src + rogue, rel)
    assert want > 0
    assert _rule_count(port_engine, rule, port_src + rogue, _port(rel)) == want


@pytest.mark.parametrize("rule,rel,old,new", _DELETIONS,
                         ids=[f"{d[0]}-{d[1].split('/')[-1]}" for d in _DELETIONS])
def test_deleted_invariant_fails_as_in_jax(rule, rel, old, new):
    port_src = (ROOT / _port(rel)).read_text()
    assert old in port_src, f"mutation anchor vanished from the port's {rel}: {old!r}"
    assert _rule_count(port_engine, rule, port_src, _port(rel)) == 0
    assert _rule_count(port_engine, rule, port_src.replace(old, new), _port(rel)) > 0


# GL005's regions in the port's own tree (no JAX counterpart): a host sync
# or a print grafted into the fill's custom op, its vmap rule and the
# packing solve's vmapped lane must each be flagged, so that the rule's
# region detection is held to the real code, not only to fixtures
_GL005_GRAFTS = [
    ("custom-op", "grove_tpu_torch/ops/fill.py",
     "    if free_after is None:\n        free_after = demand.new_empty((0,))\n",
     "    print(placed.sum().item())\n", ("`print()`", "`.item()` host sync")),
    ("register-vmap", "grove_tpu_torch/ops/fill.py",
     "    b = info.batch_size\n", "    torch.cuda.synchronize()\n",
     ("`torch.cuda.synchronize()` host sync",)),
    ("vmapped-lane", "grove_tpu_torch/ops/packing.py",
     "            grouped, pinned, spread, uniform=uniform, fill=fill,\n        )\n",
     "        print(accept.tolist())\n", ("`print()`", "`.tolist()` host sync")),
]


@pytest.mark.parametrize("rel,anchor,rogue,messages", [g[1:] for g in _GL005_GRAFTS],
                         ids=[g[0] for g in _GL005_GRAFTS])
def test_gl005_flags_a_graft_into_the_port_trees_regions(rel, anchor, rogue, messages):
    src = (ROOT / rel).read_text()
    assert src.count(anchor) == 1, f"graft anchor vanished from {rel}: {anchor!r}"
    rules = [r for r in port_engine.default_rules() if r.id == "GL005"]
    assert not port_engine.lint_source(src, rel, rules).violations
    grafted = port_engine.lint_source(src.replace(anchor, anchor + rogue), rel, rules)
    hits = [v.message for v in grafted.violations]
    line = src[:src.index(anchor) + len(anchor)].count("\n") + 1
    assert {v.line for v in grafted.violations} == {line}, hits
    for message in messages:
        assert any(message in m for m in hits), hits
    # the same line outside the regions is not GL005's
    assert not port_engine.lint_source(src + "\n\ndef plain(x):\n" + rogue, rel,
                                       rules).violations


@pytest.fixture(scope="module")
def port_report():
    """The port's whole-tree lint, with ``scripts/torch_lint.py --no-check``
    running beside it in a process of its own (the port only: no JAX)."""
    script = subprocess.Popen([sys.executable, "scripts/torch_lint.py", "--no-check", "--json"],
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        report = port_engine.run_repo_lint(ROOT)
        out, err = script.communicate(timeout=300)
    finally:
        if script.poll() is None:
            script.kill()
    return report, (script.returncode, out, err)


def test_port_tree_lints_clean_with_the_jax_suppressions(port_report):
    report, _ = port_report
    assert report.ok, "\n" + report.render_human()
    assert report.files_scanned >= 160
    # the JAX tree's suppressions: its pragmas live in these four files
    jax_files = ["grove_tpu/runtime/clock.py", "grove_tpu/sim/chaos.py",
                 "grove_tpu/controller/podcliquescalinggroup/reconciler.py",
                 "grove_tpu/controller/nodehealth.py"]
    want = jax_engine.lint_paths(ROOT, jax_files).suppressed
    assert len(want) == 9

    def key(v, fix):
        return (v.rule, fix(v.path), v.justification)

    assert sorted(key(v, str) for v in report.suppressed) == sorted(key(v, _port) for v in want)


def test_torch_lint_script_exits_zero(port_report):
    _, (rc, out, err) = port_report
    assert rc == 0, out + err
    doc = json.loads(out)
    assert doc["ok"] and doc["suppression_count"] == 9 and not doc["violations"]
    assert doc["drift"] == []


def test_rule_registry_matches_jax():
    from grove_tpu.analysis.rules import ALL_RULES as JAX_RULES
    from grove_tpu_torch.analysis.rules import ALL_RULES

    assert [r.id for r in ALL_RULES] == [r.id for r in JAX_RULES]
    assert [r.id for r in ALL_RULES] == [f"GL{i:03d}" for i in range(1, 23)]
    names = {r.id: r.name for r in ALL_RULES}
    assert names.pop("GL005") == "torch-hygiene"
    assert names == {r.id: r.name for r in JAX_RULES if r.id != "GL005"}


@pytest.mark.parametrize("collector", ["emitted_event_reasons", "emitted_metric_names",
                                       "emitted_profile_phases"])
def test_inventory_equals_jax(collector):
    got = getattr(port_inventory, collector)(ROOT)
    want = getattr(jax_inventory, collector)(ROOT)
    assert set(got) == set(want)
    if collector == "emitted_profile_phases":
        assert len(got) == 13  # the PHASE_* names resolve: dequeue, drain, snapshot, ...
