"""The port's real-cluster tools against the JAX package's, on the CPU.

CRD and API-reference generation (``cluster/crdgen``, ``cluster/apidocs``)
byte for byte against the JAX package's output and the committed
``deploy/crds/`` and ``docs/api-reference.md``; topology detection
(``cluster/autotopo``) on the node sets of ``tests/test_autotopo.py``; the
webhook certificates (``cluster/cert``: the cases of ``tests/test_certs.py``,
and each package's TLS webhook server serving the other's certificates);
the file leader lock of ``cluster/manager``.
"""

from __future__ import annotations

import json
import pathlib
import ssl
import subprocess
import time
import urllib.request
import warnings

import pytest
import yaml

from grove_tpu.api.serialize import export_object as j_export_object
from grove_tpu.cluster import apidocs as j_apidocs
from grove_tpu.cluster import autotopo as j_autotopo
from grove_tpu.cluster import cert as j_cert
from grove_tpu.cluster import crdgen as j_crdgen
from grove_tpu.sim.cluster import make_nodes as j_make_nodes
from grove_tpu_torch.admission.validation import validate_cluster_topology
from grove_tpu_torch.api.serialize import export_object
from grove_tpu_torch.cluster import apidocs, autotopo, cert, crdgen
from grove_tpu_torch.cluster.manager import FileLeaderLock
from grove_tpu_torch.sim.cluster import make_nodes

REPO = pathlib.Path(__file__).resolve().parents[1]


# -- generation ---------------------------------------------------------------


def test_render_crds_equals_jax_and_the_committed_files():
    assert crdgen.render_crds() == j_crdgen.render_crds()
    assert crdgen.CRD_KINDS == j_crdgen.CRD_KINDS
    for kind in crdgen.CRD_KINDS:
        crd = crdgen.generate_crd(kind)
        assert crd == j_crdgen.generate_crd(kind)
        path = REPO / "deploy" / "crds" / f"{crd['metadata']['name']}.yaml"
        assert yaml.safe_load(path.read_text()) == crd, path


def test_write_crds_writes_what_jax_writes(tmp_path):
    ours = crdgen.write_crds(str(tmp_path / "port"))
    theirs = j_crdgen.write_crds(str(tmp_path / "jax"))
    assert [pathlib.Path(p).name for p in ours] == [pathlib.Path(p).name for p in theirs]
    for a, b in zip(ours, theirs):
        assert pathlib.Path(a).read_bytes() == pathlib.Path(b).read_bytes()


def test_crd_schema_covers_the_sample_manifest():
    crd = crdgen.generate_crd("PodCliqueSet")
    spec = crd["spec"]["versions"][0]["schema"]["openAPIV3Schema"]["properties"]["spec"]
    clique = spec["properties"]["template"]["properties"]["cliques"]["items"]["properties"]
    assert {"name", "spec", "topologyConstraint"} <= set(clique)
    assert crd["spec"]["versions"][0]["subresources"] == {"status": {}}


def test_api_reference_equals_jax_and_the_committed_doc():
    doc = apidocs.render_api_reference()
    assert doc == j_apidocs.render_api_reference()
    assert doc == (REPO / "docs" / "api-reference.md").read_text()
    for kind in ("PodCliqueSet", "PodClique", "PodCliqueScalingGroup", "ClusterTopology",
                 "PodGang", "OperatorConfiguration"):
        assert f"### {kind}" in doc


# -- topology detection ---------------------------------------------------------


def _node(name, **labels):
    return (name, labels)


NODE_SETS = {
    "cross_cutting": [_node(f"n{i}", **{"topology.kubernetes.io/zone": f"z{i // 4}",
                                        "kubernetes.io/hostname": f"n{i}",
                                        "team": f"team-{i % 3}"}) for i in range(8)],
    "constant": [_node(f"n{i}", **{"kubernetes.io/os": "linux",
                                   "kubernetes.io/hostname": f"n{i}"}) for i in range(4)],
    "equivalent": [_node(f"n{i}", **{"kubernetes.io/hostname": f"n{i}", "node-uid": f"uid-{i}",
                                     "topology.kubernetes.io/zone": f"z{i // 2}"})
                   for i in range(4)],
    "unknown_key": [_node(f"n{i}", **{"topology.kubernetes.io/zone": f"z{i // 8}",
                                      "example.com/rack": f"r{i // 2}",
                                      "kubernetes.io/hostname": f"n{i}"}) for i in range(16)],
    "eight_levels": [_node(f"n{i}", **{f"example.com/l{d}": f"v{i // (2 ** (8 - d))}"
                                       for d in range(9)}) for i in range(512)],
}


def _detect(module, nodes):
    """(levels, the ClusterTopology's spec as wire JSON, warnings)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        levels = module.detect_topology_levels(nodes)
        topo = module.detect_topology(nodes)
    spec = [(lvl.domain, lvl.key) for lvl in topo.spec.levels]
    return levels, topo.metadata.name, spec, sorted(str(w.message) for w in caught)


@pytest.mark.parametrize("name", sorted(NODE_SETS))
def test_detect_topology_equals_jax(name):
    ours = _detect(autotopo, NODE_SETS[name])
    assert ours == _detect(j_autotopo, NODE_SETS[name])
    if name == "eight_levels":  # the broadest levels go, and the warning names them
        assert len(ours[2]) == 7 and any("example.com/l0" in w for w in ours[3])
    else:
        assert validate_cluster_topology(autotopo.detect_topology(NODE_SETS[name])).ok


def test_detect_topology_on_the_harness_nodes_equals_jax():
    ours = autotopo.detect_topology(make_nodes(32))
    theirs = j_autotopo.detect_topology(j_make_nodes(32))
    assert [lvl.domain for lvl in ours.spec.levels] == ["cluster", "slice", "ici-block", "host"]
    assert json.dumps(export_object(ours), sort_keys=True) == json.dumps(
        j_export_object(theirs), sort_keys=True)


@pytest.mark.parametrize("nodes", [[], [_node("a", x="1"), _node("b", y="2")]],
                         ids=["no_nodes", "no_hierarchy"])
def test_detection_errors_as_jax(nodes):
    with pytest.raises(autotopo.TopologyDetectionError) as ours:
        autotopo.detect_topology(nodes)
    with pytest.raises(j_autotopo.TopologyDetectionError) as theirs:
        j_autotopo.detect_topology(nodes)
    assert str(ours.value) == str(theirs.value)


def test_load_nodes_file_equals_jax(tmp_path):
    bare = tmp_path / "bare.yaml"
    bare.write_text("- name: a\n  labels: {k: v}\n- name: b\n  labels: {k: v}\n")
    nodelist = tmp_path / "list.yaml"
    nodelist.write_text("kind: NodeList\nitems:\n  - metadata: {name: a, labels: {k: v}}\n")
    assert autotopo.load_nodes_file(str(bare)) == [("a", {"k": "v"}), ("b", {"k": "v"})]
    for path in (bare, nodelist):
        assert autotopo.load_nodes_file(str(path)) == j_autotopo.load_nodes_file(str(path))


# -- certificates ---------------------------------------------------------------


def _openssl(*args) -> str:
    return subprocess.run(["openssl", *args], check=True, capture_output=True,
                          text=True).stdout


def _cert_shape(paths) -> dict:
    """What both packages' certificates must share (the keys are random)."""
    text = _openssl("x509", "-text", "-noout", "-in", str(paths.server_cert))
    san = text.split("Subject Alternative Name:")[1].strip().splitlines()[0]
    verify = subprocess.run(["openssl", "verify", "-CAfile", str(paths.ca_cert),
                             str(paths.server_cert)], capture_output=True, text=True)
    return {
        "subject": _openssl("x509", "-subject", "-noout", "-in",
                            str(paths.server_cert)).replace(" ", "").strip(),
        "issuer": _openssl("x509", "-issuer", "-noout", "-in",
                           str(paths.server_cert)).replace(" ", "").strip(),
        "san": san,
        "verifies": verify.returncode == 0,
        "files": sorted(p.name for p in pathlib.Path(paths.ca_cert).parent.iterdir()),
    }


@pytest.mark.parametrize("host", ["10.0.0.5", "grove-tpu.grove-system.svc"])
def test_generate_certs_as_jax(tmp_path, host):
    ours = _cert_shape(cert.generate_certs(str(tmp_path / "port"), host=host))
    assert ours == _cert_shape(j_cert.generate_certs(str(tmp_path / "jax"), host=host))
    assert ours["subject"].endswith("CN=grove-tpu-webhook") and ours["verifies"]
    assert host in ours["san"] and "localhost" in ours["san"]


def test_ensure_certs_reuses_rotates_and_regenerates(tmp_path):
    first = cert.ensure_certs(str(tmp_path / "a"))
    before = first.server_cert.read_bytes()
    assert cert.ensure_certs(str(tmp_path / "a")).server_cert.read_bytes() == before
    cert.generate_certs(str(tmp_path / "b"), days=1)  # inside the 30-day window
    before = (tmp_path / "b" / "tls.crt").read_bytes()
    assert cert.ensure_certs(str(tmp_path / "b")).server_cert.read_bytes() != before
    first.server_key.unlink()
    assert cert.ensure_certs(str(tmp_path / "a")).server_key.exists()


def _review(url: str, ca_file: str) -> dict:
    """One AdmissionReview of the default topology over HTTPS."""
    from grove_tpu_torch.api.topology import default_cluster_topology

    review = {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
              "request": {"operation": "CREATE", "userInfo": {"username": "u"},
                          "object": export_object(default_cluster_topology())}}
    req = urllib.request.Request(url + "/webhooks/validate-clustertopology",
                                 data=json.dumps(review).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    ctx = ssl.create_default_context(cafile=ca_file)
    with urllib.request.urlopen(req, timeout=10, context=ctx) as resp:
        return json.loads(resp.read())


def test_each_webhook_server_serves_the_other_packages_certs(tmp_path):
    from grove_tpu.cluster.webhook import WebhookServer as JWebhookServer
    from grove_tpu_torch.cluster.webhook import WebhookServer

    ours = cert.ensure_certs(str(tmp_path / "port"))
    theirs = j_cert.ensure_certs(str(tmp_path / "jax"))
    answers = []
    for server_cls, paths, cert_cls in ((JWebhookServer, ours, j_cert.CertPaths),
                                        (WebhookServer, theirs, cert.CertPaths)):
        server = server_cls(certs=cert_cls(paths.ca_cert, paths.server_cert,
                                           paths.server_key)).start()
        try:
            assert server.address.startswith("https://")
            answers.append(_review(server.address, str(paths.ca_cert)))
        finally:
            server.stop()
    assert answers[0] == answers[1]
    assert answers[0]["response"]["allowed"] is True


# -- the file leader lock -------------------------------------------------------


def test_file_leader_lock_excludes_and_hands_over(tmp_path):
    path = str(tmp_path / "leader.lock")
    a, b = FileLeaderLock(path), FileLeaderLock(path)
    assert a.try_acquire() and not b.try_acquire()
    a.release()
    assert b.try_acquire()
    b.release()


def test_stale_file_leader_lock_is_stolen(tmp_path):
    import os

    path = str(tmp_path / "leader.lock")
    assert FileLeaderLock(path, stale_after=0.2).try_acquire()
    old = time.time() - 10  # a crashed leader: no heartbeat since
    os.utime(path, (old, old))
    b = FileLeaderLock(path, stale_after=0.2)
    assert b.try_acquire()
    b.release()
