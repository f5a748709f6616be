"""The port's admission (defaulting, validation, authorization) and operator
configuration against the JAX package's, on the CPU.

Every case of ``tests/test_admission.py`` (and the authorization and config
cases of ``tests/test_config_cli_auth.py``) runs on both packages' objects,
built from the same sample YAML: the defaulted PodCliqueSet's wire document,
and every validation's error list, must be equal, and each case keeps the
JAX test's own assert on the port's answer.
"""

from __future__ import annotations

import copy

import pytest

from tests.test_torch_operator import (  # noqa: F401 (the autouse fixture)
    JAX,
    PORT,
    SIDES,
    _fresh_singletons,
    harness,
    sample,
)


def _adm(side):
    return side.mod("admission.defaulting"), side.mod("admission.validation")


def defaulted(side):
    defaulting, _ = _adm(side)
    return defaulting.default_podcliqueset(sample(side))


def topology(side):
    return side.mod("api.topology").ClusterTopology()


def tc(side, **kw):
    return side.types.TopologyConstraint(**kw)


# case name -> (mutate(side, pcs) -> (pcs, topology or None), expected substring or None)
def _dup(side, pcs):
    pcs.spec.template.cliques[1].name = "frontend"
    return pcs, None


def _min_avail(side, pcs):
    pcs.spec.template.cliques[0].spec.min_available = 10
    return pcs, None


def _sg_autoscaler(side, pcs):
    pcs.spec.template.cliques[1].spec.auto_scaling_config = side.types.AutoScalingConfig(
        max_replicas=4, min_replicas=2)
    return pcs, None


def _overlap(side, pcs):
    pcs = sample(side)
    cfg = pcs.spec.template.pod_clique_scaling_group_configs[0]
    other = copy.deepcopy(cfg)
    other.name = "sgb"
    other.clique_names = ["compute", "logger"]
    pcs.spec.template.pod_clique_scaling_group_configs.append(other)
    return _adm(side)[0].default_podcliqueset(pcs), None


def _unknown_sg(side, pcs):
    pcs.spec.template.pod_clique_scaling_group_configs[0].clique_names = ["nope"]
    return pcs, None


def _scale_min(side, pcs):
    pcs.spec.template.cliques[0].spec.auto_scaling_config.min_replicas = 1
    pcs.spec.template.cliques[0].spec.min_available = 2
    return pcs, None


def _delay(side, pcs):
    pcs.spec.template.termination_delay = 0
    return pcs, None


def _startup(side, pcs):
    pcs.spec.template.startup_type = "Bogus"
    return pcs, None


def _explicit(deps, startup="STARTUP_EXPLICIT"):
    def mutate(side, pcs):
        pcs = sample(side)
        pcs.spec.template.startup_type = getattr(side.types, startup)
        for i, after in deps.items():
            pcs.spec.template.cliques[i].spec.starts_after = after
        return _adm(side)[0].default_podcliqueset(pcs), None
    return mutate


def _sg_member_tc(side, pcs):
    sg = pcs.spec.template.pod_clique_scaling_group_configs[0]
    sg.topology_constraint = tc(side, pack_domain="ici-block")
    pcs.spec.template.cliques[1].topology_constraint = tc(side, pack_domain="slice")
    return pcs, topology(side)


def _name_budget(side, pcs):
    pcs.metadata.name = "x" * 60
    return pcs, None


def _pack(parent, child=None, with_topology=True):
    def mutate(side, pcs):
        pcs.spec.template.topology_constraint = tc(side, pack_domain=parent)
        if child is not None:
            pcs.spec.template.cliques[0].topology_constraint = tc(side, pack_domain=child)
        return pcs, topology(side) if with_topology else None
    return mutate


def _spread(template_kw, clique_kw=None, with_topology=True, default=False):
    def mutate(side, pcs):
        if template_kw is not None:
            pcs.spec.template.topology_constraint = tc(side, **template_kw)
        if clique_kw is not None:
            pcs.spec.template.cliques[0].topology_constraint = tc(side, **clique_kw)
        if default:
            _adm(side)[0].default_podcliqueset(pcs)
        return pcs, topology(side) if with_topology else None
    return mutate


def _forbidden(side, pcs):
    pcs.spec.template.cliques[0].spec.pod_spec.extra["nodeName"] = "n1"
    return pcs, None


CREATE_CASES = {
    "valid": (lambda side, pcs: (pcs, None), None),
    "duplicate_clique_names": (_dup, "unique"),
    "minavailable_exceeds_replicas": (_min_avail, "minAvailable must not be greater than replicas"),
    "sg_member_with_own_autoscaler": (_sg_autoscaler, "scaling group"),
    "overlapping_scaling_groups": (_overlap, "overlap"),
    "unknown_sg_clique": (_unknown_sg, "unidentified"),
    "scaleconfig_minreplicas_below_minavailable": (_scale_min,
                                                   "greater than or equal to minAvailable"),
    "termination_delay_positive": (_delay, "terminationDelay"),
    "bad_startup_type": (_startup, "cliqueStartupType"),
    "cycle": (_explicit({0: ["logger"], 3: ["frontend"]}), "circular"),
    "self_dependency": (_explicit({0: ["frontend"]}), "refer to itself"),
    "unknown_dependency": (_explicit({0: ["ghost"]}), "unknown cliques"),
    "inorder_ignores_starts_after": (_explicit({0: ["ghost"]}, "STARTUP_IN_ORDER"), None),
    "valid_dag": (_explicit({1: ["frontend"], 2: ["frontend", "prefetch"]}), None),
    "sg_member_constraint_against_group": (_sg_member_tc, "stricter"),
    "name_budget": (_name_budget, "exceeds"),
    "pack_slice": (_pack("slice"), None),
    "child_broader_than_parent": (_pack("slice", "zone"), "stricter"),
    "bogus_parent_domain": (_pack("bogus", "slice", with_topology=False),
                            "unknown topology domain"),
    "spread_defaults": (_spread({"spread_domain": "host"}, default=True), None),
    "pack_and_spread": (_spread({"spread_domain": "host", "pack_domain": "slice"},
                                default=True), None),
    "spread_on_clique": (_spread(None, {"spread_domain": "host"}), "template-level"),
    "spread_not_narrower": (_spread({"pack_domain": "host", "spread_domain": "slice"}),
                            "strictly narrower"),
    "spread_min_domains": (_spread({"spread_domain": "host", "spread_min_domains": 1}),
                           "at least 2"),
    "spread_when_unsatisfiable": (_spread({"spread_domain": "host",
                                           "spread_when_unsatisfiable": "Sometimes"}),
                                  "spreadWhenUnsatisfiable"),
    "spread_unknown_domain": (_spread({"spread_domain": "bogus"}, with_topology=False),
                              "unknown topology domain"),
    "spread_with_clique_pack": (_spread({"spread_domain": "host"},
                                        {"pack_domain": "ici-block"}), "cannot be combined"),
    "forbidden_podspec_fields": (_forbidden, "nodeName"),
}


def test_defaulting_matches_jax():
    docs = [side.export_object(defaulted(side)) for side in SIDES]
    assert docs[1] == docs[0]
    tmpl = defaulted(PORT).spec.template
    assert tmpl.startup_type == PORT.types.STARTUP_ANY_ORDER
    assert tmpl.termination_delay == 4 * 3600
    assert tmpl.headless_service_config.publish_not_ready_addresses is True
    for clique in tmpl.cliques:
        assert clique.spec.min_available == clique.spec.replicas
        assert clique.spec.pod_spec.restart_policy == "Always"
        assert clique.spec.pod_spec.extra["terminationGracePeriodSeconds"] == 30
    assert tmpl.cliques[0].spec.auto_scaling_config.min_replicas == 3
    sg = tmpl.pod_clique_scaling_group_configs[0]
    assert (sg.replicas, sg.min_available, sg.scale_config.min_replicas) == (1, 1, 1)


def test_defaulting_keeps_existing_values():
    out = []
    for side in SIDES:
        pcs = sample(side)
        pcs.spec.template.termination_delay = 60.0
        pcs.spec.template.cliques[1].spec.min_available = 1
        _adm(side)[0].default_podcliqueset(pcs)
        out.append(side.export_object(pcs))
    assert out[1] == out[0]
    assert out[1]["spec"]["template"]["terminationDelay"] in (60.0, "60s", 60)


@pytest.mark.parametrize("case", sorted(CREATE_CASES))
def test_validation_create_matches_jax(case):
    mutate, expect = CREATE_CASES[case]
    errors = []
    for side in SIDES:
        pcs, topo = mutate(side, defaulted(side))
        kw = {} if topo is None else {"topology": topo}
        errors.append(_adm(side)[1].validate_podcliqueset(pcs, **kw).errors)
    assert errors[1] == errors[0]
    if expect is None:
        assert errors[1] == []
    else:
        assert any(expect in e for e in errors[1]), errors[1]


def _replicas_negative(side, new):
    new.spec.template.cliques[0].spec.replicas = -3
    new.spec.template.cliques[0].spec.min_available = -3


def _node_name(side, new):
    new.spec.template.cliques[0].spec.pod_spec.extra["nodeName"] = "n"


def _allowed(side, new):
    new.spec.replicas = 3
    new.spec.template.cliques[0].spec.pod_spec.containers[0].image = "new:img"


def _startup_type(side, new):
    new.spec.template.startup_type = side.types.STARTUP_IN_ORDER


def _rename(side, new):
    new.spec.template.cliques[0].name = "renamed"


def _min_available(side, new):
    new.spec.template.cliques[0].spec.min_available = 1


def _sg_names(side, new):
    new.spec.template.pod_clique_scaling_group_configs[0].clique_names = ["prefetch"]


UPDATE_CASES = {
    "reruns_create_rules": (_replicas_negative, "must be greater than 0"),
    "create_only_fields_not_enforced": (_node_name, None),
    "allowed_update": (_allowed, None),
    "startup_type_immutable": (_startup_type, "cliqueStartupType"),
    "clique_composition_immutable": (_rename, "composition"),
    "min_available_immutable": (_min_available, "minAvailable"),
    "sg_clique_names_immutable": (_sg_names, "cliqueNames"),
}


@pytest.mark.parametrize("case", sorted(UPDATE_CASES) + ["clique_order_inorder"])
def test_validation_update_matches_jax(case):
    errors = []
    for side in SIDES:
        old = defaulted(side)
        if case == "clique_order_inorder":
            old.spec.template.startup_type = side.types.STARTUP_IN_ORDER
            new = copy.deepcopy(old)
            cl = new.spec.template.cliques
            new.spec.template.cliques = [cl[1], cl[0]] + cl[2:]
            expect = "order cannot be changed"
        else:
            new = copy.deepcopy(old)
            mutate, expect = UPDATE_CASES[case]
            mutate(side, new)
        errors.append(_adm(side)[1].validate_podcliqueset_update(new, old).errors)
    assert errors[1] == errors[0]
    if expect is None:
        assert errors[1] == []
    else:
        assert any(expect in e for e in errors[1]), errors[1]


@pytest.mark.parametrize("edges,want", [
    ({"a": ["b"], "b": ["c"], "c": ["a"], "d": ["a"]}, [["a", "b", "c"]]),
    ({"a": [], "b": ["a"], "c": ["a", "b"]}, []),
    ({"a": ["a"]}, [["a"]]),
])
def test_dependency_graph_matches_jax(edges, want):
    out = []
    for side in SIDES:
        g = _adm(side)[1].PodCliqueDependencyGraph()
        for node, deps in edges.items():
            g.add_dependencies(node, deps)
        out.append(g.strongly_connected_cliques())
    assert out[1] == out[0] == want


@pytest.mark.parametrize("levels,expect", [
    (None, None),
    ([("host", "kubernetes.io/hostname"), ("zone", "topology.kubernetes.io/zone")],
     "broadest to narrowest"),
    ([("zone", "a"), ("zone", "b")], "duplicate domain"),
    ([("floor", "x")], "unknown domain"),
])
def test_cluster_topology_validation_matches_jax(levels, expect):
    errors = []
    for side in SIDES:
        topo_mod = side.mod("api.topology")
        topo = topo_mod.ClusterTopology()
        if levels is not None:
            topo.spec.levels = [topo_mod.TopologyLevel(d, k) for d, k in levels]
        errors.append(_adm(side)[1].validate_cluster_topology(topo).errors)
    assert errors[1] == errors[0]
    assert (errors[1] == []) if expect is None else any(expect in e for e in errors[1])


def test_queue_defaulting_and_validation_match_jax():
    text = (PORT.mod("models.scenarios").SAMPLES_DIR / "multitenant-queues.yaml").read_text()
    out = []
    for side in SIDES:
        defaulting, validation = _adm(side)
        rows = []
        for obj in side.load_manifest_objects(text):
            if obj.kind != "Queue":
                continue
            defaulting.default_queue(obj)
            rows.append((side.export_object(obj), validation.validate_queue(obj).errors))
            bad = copy.deepcopy(obj)
            bad.spec.parent = "nope"
            rows.append(validation.validate_queue(bad).errors)
        out.append(rows)
    assert out[1] == out[0]
    assert out[1][0][1] == [] and out[1][1]


# -- authorization (tests/test_config_cli_auth.py) -----------------------------


def test_authorization_guard_matches_jax():
    out = []
    for side in SIDES:
        auth = side.mod("admission.authorization")
        h = harness(side)
        h.apply(sample(side))
        h.converge()
        pod = h.store.get("Pod", "default", "simple1-0-frontend-0")
        pcs = h.store.get("PodCliqueSet", "default", "simple1")
        guard = auth.AuthorizationGuard(enabled=True, exempt_users=["admin-sa"])
        own = side.mod("api.pod").Pod(metadata=side.mod("api.meta").ObjectMeta(name="own-pod"))
        decisions = [guard.check("dev-user", "delete", pod),
                     guard.check(auth.OPERATOR_USERNAME, "delete", pod),
                     guard.check("admin-sa", "delete", pod),
                     guard.check("dev-user", "update", pcs),
                     auth.AuthorizationGuard(enabled=False).check("dev-user", "delete", pod),
                     guard.check("dev-user", "delete", own)]
        out.append([(d.allowed, d.reason) for d in decisions])
    assert out[1] == out[0]
    assert [a for a, _ in out[1]] == [False, True, True, True, True, True]
    assert "managed by the grove operator" in out[1][0][1]


def test_authorization_enforced_through_store():
    """authorizer config → the store's guard: a user's write to a managed
    child is refused, the operator's controllers and the user's own
    PodCliqueSet write proceed."""
    for side in SIDES:
        cfg = side.mod("config.operator").load_operator_configuration(
            "authorizer: {enabled: true}")
        h = harness(side, config=cfg)
        h.apply(sample(side))
        h.converge()
        assert all(side.is_ready(p) for p in h.store.list("Pod"))
        with h.store.as_user("dev-user"):
            with pytest.raises(side.mod("runtime.errors").GroveError,
                               match="managed by the grove operator"):
                h.store.delete("Pod", "default", "simple1-0-frontend-0")
            pcs = h.store.get("PodCliqueSet", "default", "simple1")
            pcs.spec.replicas = 1
            h.store.update(pcs)
    # the port's GroveError is its own class: the JAX store's is not one
    assert PORT.mod("runtime.errors").GroveError is not JAX.mod("runtime.errors").GroveError


@pytest.mark.parametrize("text,err", [
    ("", None),
    ("logLevel: debug\nauthorizer: {enabled: true, exemptServiceAccounts: [a]}\n"
     "clusterTopology: {enabled: true, name: tpu-v5e}\n"
     "solver: {chunkSize: 256, maxWaves: 8, priorityClasses: {critical: 100}}", None),
    ("logLevel: verbose", "logLevel"),
    ("controllers: {podClique: {concurrentSyncs: 0}}", "concurrentSyncs"),
    ("leaderElection: {enabled: true, leaseDuration: 5, renewDeadline: 10}",
     "leaseDuration"),
])
def test_operator_configuration_matches_jax(text, err):
    out = []
    for side in SIDES:
        load = side.mod("config.operator").load_operator_configuration
        if err is None:
            cfg = load(text)
            out.append(repr(cfg).replace(side.root + ".", ""))
        else:
            with pytest.raises(ValueError, match=err) as exc:
                load(text)
            out.append(str(exc.value))
    assert out[1] == out[0]
