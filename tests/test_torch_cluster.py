"""The port's real-cluster tier against the JAX package's, on the CPU.

Every world crosses as wire documents (JSON over HTTP), never as objects.
- **Wire parity**: one scripted request sequence against each package's
  ``APIServer`` over its own in-memory store on a virtual clock, with each
  package's webhook server and no controllers (create, get, list with a
  label selector, update with a conflict, update-status, delete with
  finalizers, delete-collection, a webhook denial, malformed requests, and
  a watch that sees it all): the status codes and bodies equal once the
  uid's incarnation token is dropped.
- **Glass-box faces**: ``GET /events`` (``EventRecord.as_dict``) and
  ``GET /metrics`` over the same recorded events and metrics; then, on a
  converged operator over the BASELINE samples and an unschedulable set,
  ``/queues``, ``/debug/capacity``, ``/gangs/{ns}/{name}/explain``, ``POST
  /debug/whatif`` and ``/events``, equal to the JAX operator's.
- **Cross-package clients**: the port's ``HttpStore`` drives the JAX
  apiserver and the JAX client the port's: the same objects and the same
  watch stream.
- **The operator over HTTP** (``start_operator(device="cpu")``, the cases
  of ``tests/test_cluster_mode.py`` and ``tests/test_concurrent_engine.py``):
  the samples, the TLS webhook's denial, the authorizer, the HPA, a delete
  draining its finalizers, the threaded drain, the external scheduler in a
  subprocess, and (τ) (``models/scenarios.run_cluster_world``) cut to 8
  sets on 64 nodes; the census by kind, gang phases and pod readiness equal
  to the JAX runtime's on the same manifests.
- **Entry points**: ``start_operator()`` and ``run_external_scheduler()``
  without a device raise where CUDA is absent, and leave nothing running.
"""

from __future__ import annotations

import importlib
import json
import pathlib
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from collections import Counter

import pytest
import yaml

from grove_tpu_torch.models.scenarios import (
    BASELINE_SAMPLES,
    port_names,
    run_cluster_world,
    strip_timing,
)
from tests.torch_sim_sides import sim_side

REPO = pathlib.Path(__file__).resolve().parents[1]
ROOTS = ("grove_tpu", "grove_tpu_torch")
PCS = "/apis/grove.io/v1alpha1/namespaces/default/podcliquesets"
PCLQ = "/apis/grove.io/v1alpha1/namespaces/default/podcliques"
PG = "/apis/scheduler.grove.io/v1alpha1/namespaces/default/podgangs"
PODS = "/api/v1/namespaces/default/pods"
_UID = re.compile(r"uid-[0-9a-f]{8}-")


def mod(root: str, path: str):
    return importlib.import_module(f"{root}.{path}")


def canon(doc):
    """A response body with each uid's incarnation token dropped (the
    sequence number stays)."""
    return json.loads(_UID.sub("uid-", json.dumps(doc, sort_keys=True)))


def call(base: str, method: str, path: str, doc=None, user=None):
    """(status, JSON body) of one request; errors are answers too."""
    headers = {"Content-Type": "application/json"}
    if user:
        headers["Impersonate-User"] = user
    data = json.dumps(doc).encode() if doc is not None else None
    req = urllib.request.Request(base + path, data=data, headers=headers, method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read() or b"null")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def get(base: str, path: str):
    status, body = call(base, "GET", path)
    assert status == 200, (path, status, body)
    return body


def sample_doc(name="simple1.yaml") -> dict:
    return yaml.safe_load((REPO / "samples" / name).read_text())


def start(root: str, **kw):
    """``start_operator`` of one package; the port's on the CPU."""
    if root == "grove_tpu_torch":
        kw["device"] = "cpu"
    return mod(root, "cluster.manager").start_operator(**kw)


def converge(rt, predicate, timeout: float = 60.0, dump=None) -> int:
    deadline = time.time() + timeout
    rounds = 0
    while time.time() < deadline:
        rt.converge_once()
        rounds += 1
        if predicate():
            return rounds
        time.sleep(0.05)
    raise AssertionError(f"did not converge within {timeout}s"
                         + (f": {dump()}" if dump is not None else ""))


@pytest.fixture(autouse=True)
def _fresh():
    for root in ROOTS:
        mod(root, "observability.metrics").METRICS.reset()
        mod(root, "observability.events").EVENTS.reset()
        mod(root, "api.meta").reset_uid_namespace()
    yield
    for root in ROOTS:
        for path, name in (("observability.tracing", "TRACER"), ("observability.events", "EVENTS"),
                           ("observability.journey", "JOURNEYS"),
                           ("observability.flightrec", "FLIGHTREC"),
                           ("observability.timeseries", "TIMESERIES")):
            getattr(mod(root, path), name).clock = None
        mod(root, "observability.events").EVENTS.reset()
        mod(root, "observability.metrics").METRICS.reset()


def _gang(name, labels=None, finalizers=None) -> dict:
    meta = {"name": name, "namespace": "default", "labels": labels or {}}
    if finalizers:
        meta["finalizers"] = finalizers
    return {"apiVersion": "scheduler.grove.io/v1alpha1", "kind": "PodGang", "metadata": meta,
            "spec": {"podGroups": []}}


class _Watch:
    """Lines of one watch stream, read on a thread until ``last`` shows."""

    def __init__(self, url: str, last: str) -> None:
        self.lines = []
        self._done = threading.Event()

        def read():
            with urllib.request.urlopen(url, timeout=30) as resp:
                for raw in resp:
                    line = raw.strip()
                    if not line:
                        continue
                    ev = json.loads(line)
                    self.lines.append(ev)
                    if ev["object"]["metadata"]["name"] == last:
                        break
            self._done.set()

        self._thread = threading.Thread(target=read, daemon=True)
        self._thread.start()

    def wait(self, timeout: float = 10.0) -> list:
        assert self._done.wait(timeout), "the watch never saw its last object"
        return [(ev["type"], ev["object"]["metadata"]["name"],
                 ev["object"]["metadata"]["resourceVersion"],
                 (ev["object"].get("status") or {}).get("phase")) for ev in self.lines]


def _wire_script(root: str):
    """The scripted sequence on one package's bare apiserver."""
    clock = mod(root, "runtime.clock").VirtualClock()
    store = mod(root, "runtime.store").Store(clock)
    hooks = mod(root, "cluster.webhook").WebhookServer().start()
    server = mod(root, "cluster.apiserver").APIServer(
        store=store, webhooks=hooks.registrations()).start()
    base, steps = server.address, []
    try:
        seed = call(base, "POST", PG, _gang("g0"))  # the watch's initial list holds it
        steps.append(seed)
        watch = _Watch(base + PG + "?watch=true", last="zz-end")
        time.sleep(0.2)
        steps.append(call(base, "POST", PG, _gang("g1", {"app": "a"})))
        g1 = steps[-1][1]
        steps.append(call(base, "POST", PG, _gang("g2", {"app": "b"})))
        steps.append(call(base, "POST", PG, _gang("g1", {"app": "a"})))  # exists: 409
        steps.append(call(base, "GET", PG + "/g1"))
        steps.append(call(base, "GET", PG + "?labelSelector=app%3Da"))
        steps.append(call(base, "GET", PG + "?labelSelector=app"))  # malformed: 400
        edited = json.loads(json.dumps(g1))
        edited["metadata"]["labels"]["tier"] = "x"
        steps.append(call(base, "PUT", PG + "/g1", edited))
        steps.append(call(base, "PUT", PG + "/g1", edited))  # stale resourceVersion: 409
        fresh = steps[-2][1]
        fresh["status"] = {"phase": "Starting"}
        steps.append(call(base, "PUT", PG + "/g1/status", fresh))
        steps.append(call(base, "PUT", PG + "/nope/status", fresh))  # 404
        steps.append(call(base, "POST", PG, _gang("g3", finalizers=["example.com/hold"])))
        steps.append(call(base, "DELETE", PG + "/g3"))
        held = call(base, "GET", PG + "/g3")
        steps.append(held)
        held[1]["metadata"]["finalizers"] = []
        steps.append(call(base, "PUT", PG + "/g3", held[1]))  # the last finalizer: gone
        steps.append(call(base, "GET", PG + "/g3"))
        steps.append(call(base, "DELETE", PG + "/g2"))
        steps.append(call(base, "DELETE", PG + "/g2"))
        bad = sample_doc()
        bad["metadata"]["name"] = "badset"
        bad["spec"]["template"]["cliques"][0]["spec"]["minAvailable"] = 99
        steps.append(call(base, "POST", PCS, bad))  # the validating webhook denies: 422
        steps.append(call(base, "POST", PCS, sample_doc()))  # defaulted by the mutating one
        steps.append(call(base, "POST", PCS, _gang("wrong-kind")))  # 400
        steps.append(call(base, "PUT", PCS, sample_doc()))  # no name: 405
        steps.append(call(base, "GET", "/apis/nope/v1/things"))  # 404
        steps.append(call(base, "DELETE", PG + "?labelSelector=app%3Da"))
        steps.append(call(base, "GET", PG))
        steps.append(call(base, "POST", PG, _gang("zz-end")))
        stream = watch.wait()
    finally:
        server.stop()
        hooks.stop()
    return canon(steps), stream


def test_wire_sequence_equals_jax():
    jax_steps, jax_stream = _wire_script("grove_tpu")
    steps, stream = _wire_script("grove_tpu_torch")
    assert [s[0] for s in steps] == [s[0] for s in jax_steps]
    for i, (ours, theirs) in enumerate(zip(steps, jax_steps)):
        assert ours == theirs, i
    assert stream == jax_stream
    codes = [s[0] for s in steps]
    assert 409 in codes and 422 in codes and 405 in codes and 400 in codes and 404 in codes
    assert {t for t, *_ in stream} == {"ADDED", "MODIFIED", "DELETED"}


# -- the glass-box faces --------------------------------------------------------


def _recorded_faces(root: str) -> dict:
    """``GET /events`` (all, and filtered) and ``GET /metrics`` after the
    same events and metrics were recorded on a virtual clock."""
    events = mod(root, "observability.events")
    metrics = mod(root, "observability.metrics").METRICS
    clock = mod(root, "runtime.clock").VirtualClock()
    events.EVENTS.clock = clock
    for i, (ref, type_, reason) in enumerate([
            (("PodGang", "default", "g1"), "Normal", "GangAdmitted"),
            (("Pod", "default", "p1"), "Normal", "PodBound"),
            (("PodGang", "default", "g1"), "Normal", "GangAdmitted"),
            (("PodGang", "team-a", "g2"), "Warning", "Unschedulable"),
            (("PodClique", "team-a", "c1"), "Normal", "PodCreateSuccessful")]):
        clock.advance(1.5 + i)
        events.EVENTS.record(ref, type_, reason, f"message {i}")
    records = [r.as_dict() for r in events.EVENTS.list()]
    metrics.inc("reconcile_total/podclique", 3)
    metrics.inc("gangs_admitted_total")
    metrics.set("workqueue_depth/podclique", 2)
    for v in (0.001, 0.02, 0.5):
        metrics.observe("reconcile_seconds/podclique", v)
    server = mod(root, "cluster.apiserver").APIServer().start()
    try:
        base = server.address
        out = {"as_dict": records, "events": get(base, "/events"),
               "warning": get(base, "/events?namespace=team-a&reason=Unschedulable"),
               "kind": get(base, "/events?kind=PodGang")}
        with urllib.request.urlopen(base + "/metrics", timeout=10) as resp:
            out["metrics"] = resp.read().decode()
        for ep in ("/healthz", "/readyz", "/livez"):
            with urllib.request.urlopen(base + ep, timeout=10) as resp:
                out[ep] = resp.read().decode()
        out["no_explain"] = call(base, "GET", "/debug/capacity")
        out["no_federation"] = call(base, "GET", "/federation")
        out["no_drain"] = call(base, "POST", "/nodes/n0/drain")
        out["journeys"] = get(base, "/debug/journeys")
        out["no_journey"] = call(base, "GET", "/gangs/default/g1/journey")
        out["bad_window"] = call(base, "GET", "/debug/slo?window=-1")
        out["slo"] = get(base, "/debug/slo?window=60")
        out["forecast"] = get(base, "/debug/forecast?horizon=30")
        out["bad_horizon"] = call(base, "GET", "/debug/forecast?horizon=inf")
        out["ledger"] = get(base, "/debug/ledger")
        out["traces"] = get(base, "/debug/traces")
        out["chrome"] = get(base, "/debug/traces/chrome")
        out["queues"] = get(base, "/queues")
        out["nodes"] = get(base, "/nodes")
    finally:
        server.stop()
    return out


def test_events_and_metrics_faces_equal_jax():
    ours = _recorded_faces("grove_tpu_torch")
    assert ours == _recorded_faces("grove_tpu")
    assert ours["events"]["items"] == ours["as_dict"]
    assert [e["reason"] for e in ours["warning"]["items"]] == ["Unschedulable"]
    admitted = [e for e in ours["as_dict"] if e["reason"] == "GangAdmitted"]
    assert [e["count"] for e in admitted] == [2] and ours["/healthz"] == "ok"
    assert ours["no_explain"][0] == ours["no_federation"][0] == ours["no_drain"][0] == 404


def _node_of_first_pod(base: str, gang: str) -> str:
    pods = get(base, PODS)["items"]
    return sorted(p["status"]["nodeName"] for p in pods
                  if p["metadata"]["name"].startswith(gang) and p["status"].get("nodeName"))[0]


def _running(base: str, gang: str) -> bool:
    return any(g["metadata"]["name"] == gang and (g.get("status") or {}).get("phase") == "Running"
               for g in get(base, PG)["items"])


def _ready(pod: dict) -> bool:
    return any(c["type"] == "Ready" and c["status"] == "True"
               for c in (pod.get("status") or {}).get("conditions") or [])


def census(base: str, rt) -> dict:
    """The converged world as both packages must show it."""
    store = rt.apiserver.store
    with rt.apiserver.lock:
        kinds = {k: sum(1 for _ in store.scan(k)) for k in sorted(store.kinds())}
    pods = get(base, PODS)["items"]
    gangs = get(base, PG)["items"]
    return {
        "kinds": kinds,
        "gangs": sorted((g["metadata"]["name"], (g.get("status") or {}).get("phase"))
                        for g in gangs),
        "pods": sorted((p["metadata"]["name"], _ready(p), p["status"].get("nodeName"))
                       for p in pods),
    }


def _events_view(base: str) -> list:
    """Every event record and its count; a pending gang's count grows with
    the rounds it waits, so that count stays out."""
    return sorted((e["involvedObject"]["kind"], e["involvedObject"]["name"], e["reason"],
                   None if e["reason"] == "GangDeferred" else e["count"])
                  for e in get(base, "/events")["items"])


def _samples_world(root: str) -> dict:
    """The BASELINE samples applied one at a time over HTTP, each converged
    before the next, then a set no node can hold; the glass-box faces."""
    rt = start(root)
    base, out = rt.apiserver.address, {}
    try:
        for name, filename in BASELINE_SAMPLES.items():
            doc = sample_doc(filename)
            assert call(base, "POST", PCS, doc)[0] == 201
            gang = doc["metadata"]["name"] + "-0"
            converge(rt, lambda: _running(base, gang)
                     and all(_ready(p) for p in get(base, PODS)["items"]))
        big = sample_doc()
        big["metadata"]["name"] = "big"
        for clique in big["spec"]["template"]["cliques"]:
            clique["spec"]["podSpec"]["containers"][0]["resources"] = {
                "requests": {"cpu": "500"}}
        assert call(base, "POST", PCS, big)[0] == 201
        # its gang and pods exist and stay Pending (simple1's base gang: 9 pods)
        converge(rt, lambda: sum(p["metadata"]["name"].startswith("big-0-")
                                 for p in get(base, PODS)["items"]) >= 9)
        for _ in range(2):
            rt.converge_once()
        out["census"] = census(base, rt)
        out["queues"] = get(base, "/queues")
        out["capacity"] = strip_timing(get(base, "/debug/capacity"))
        out["explain"] = strip_timing(get(base, "/gangs/default/big-0/explain"))
        out["explain_missing"] = call(base, "GET", "/gangs/default/nope/explain")
        node = _node_of_first_pod(base, "simple1-0")
        out["whatif"] = strip_timing(call(base, "POST", "/debug/whatif", {
            "gang": {"namespace": "default", "name": "big-0"},
            "actions": [{"action": "drain-node", "node": node}]})[1])
        out["whatif_bad"] = call(base, "POST", "/debug/whatif", {"gang": {}})
        out["events"] = _events_view(base)
        out["nodes"] = sorted((n["name"], n["state"], n.get("pods"))
                              for n in get(base, "/nodes")["items"])
    finally:
        rt.shutdown()
    return canon(out)


def test_samples_and_glass_box_faces_over_http_equal_jax():
    ours = _samples_world("grove_tpu_torch")
    theirs = _samples_world("grove_tpu")
    for key in theirs:
        assert ours[key] == theirs[key], key
    assert all(ready for _name, ready, _node in ours["census"]["pods"]
               if not _name.startswith("big-"))
    assert ours["explain"]["state"] != "Scheduled" and ours["explain_missing"][0] == 404
    assert ours["whatif_bad"][0] == 400


# -- cross-package clients --------------------------------------------------------


def _client_script(client_root: str, server_root: str):
    """One package's HttpStore against the other's apiserver: CRUD, a
    conflict retried by read_modify_write, finalizers, delete_collection
    and the watch stream, as wire documents."""
    client_mod = mod(client_root, "cluster.client")
    export = mod(client_root, "api.serialize").export_object
    types = mod(client_root, "api.types")
    meta = mod(client_root, "api.meta")
    errors = mod(client_root, "runtime.errors")
    clock = mod(server_root, "runtime.clock").VirtualClock()
    server = mod(server_root, "cluster.apiserver").APIServer(
        store=mod(server_root, "runtime.store").Store(clock)).start()
    client = client_mod.HttpStore(server.address, watch_kinds=("PodGang",))
    racer = client_mod.HttpStore(server.address)
    seen = []
    client.subscribe(lambda ev: seen.append(
        (ev.type, ev.obj.metadata.name, ev.obj.metadata.resource_version,
         None if ev.old is None else ev.old.metadata.resource_version)))
    client.start()
    out = []
    try:
        time.sleep(0.2)
        for name, labels in (("a", {"app": "x"}), ("b", {"app": "y"}), ("c", {"app": "x"})):
            gang = types.PodGang(metadata=meta.ObjectMeta(name=name, namespace="default",
                                                          labels=labels))
            out.append(export(client.create(gang)))
        out.append(export(client.get("PodGang", "default", "a")))
        out.append(client.get("PodGang", "default", "zz"))
        out.append([export(o) for o in client.list("PodGang", "default", {"app": "x"})])
        raced = []

        def mutate(live):
            if not raced:  # a racing writer between our GET and PUT
                raced.append(True)
                fresh = racer.get("PodGang", "default", "a")
                fresh.metadata.labels = {"racer": "wrote"}
                racer.update(fresh)
            live.metadata.annotations = {"rmw": "applied"}

        out.append(export(client.read_modify_write("PodGang", "default", "a", mutate)))
        stale = client.get("PodGang", "default", "b")
        moved = client.get("PodGang", "default", "b")
        moved.metadata.labels = {"app": "y", "tier": "t"}
        client.update(moved)  # the resourceVersion moves past `stale`'s
        try:
            client.update(stale)
            out.append("no conflict")
        except errors.GroveError as e:
            out.append(("conflict", e.code))
        b = client.get("PodGang", "default", "b")
        b.status.phase = "Starting"
        out.append(export(client.update_status(b)))
        b = client.get("PodGang", "default", "b")
        b.metadata.finalizers = ["example.com/hold"]
        client.update(b)
        client.delete("PodGang", "default", "b")
        out.append(export(client.get("PodGang", "default", "b")))
        client.remove_finalizer("PodGang", "default", "b", "example.com/hold")
        out.append(client.get("PodGang", "default", "b"))
        out.append(client.delete_collection("PodGang", "default", {"app": "x"}))
        out.append([export(o) for o in client.scan("PodGang")])
        end = types.PodGang(metadata=meta.ObjectMeta(name="zz-end", namespace="default"))
        client.create(end)
        deadline = time.time() + 10
        while time.time() < deadline and not any(s[1] == "zz-end" for s in seen):
            time.sleep(0.02)
    finally:
        client.stop()
        racer.stop()
        server.stop()
    # uids are the server's to give: compared as present, not by number
    return json.loads(re.sub(r'"uid-[0-9a-f]{8}-[0-9]+"', '"uid"', json.dumps(out))), seen


def test_each_client_drives_the_other_packages_apiserver():
    runs = {(c, s): _client_script(c, s) for c in ROOTS for s in ROOTS}
    want = runs[("grove_tpu", "grove_tpu")]
    for key, got in runs.items():
        assert got == want, key
    out, seen = runs[("grove_tpu_torch", "grove_tpu")]
    assert ["conflict", "ERR_CONFLICT"] in out
    assert out[6]["metadata"]["labels"] == {"racer": "wrote"}  # the racer's write survived
    assert out[6]["metadata"]["annotations"] == {"rmw": "applied"}
    assert {s[0] for s in seen} == {"Added", "Modified", "Deleted"}


def test_informer_keeps_a_slim_old_view():
    from grove_tpu_torch.api.pod import Pod
    from grove_tpu_torch.api.types import PODGANG_SCHEDULING_GATE, Container
    from grove_tpu_torch.cluster.apiserver import APIServer
    from grove_tpu_torch.cluster.client import HttpStore, _OldView
    from grove_tpu_torch.controller.register import pod_status_transition

    server = APIServer().start()
    client = HttpStore(server.address, watch_kinds=("Pod",))
    events = []
    client.subscribe(events.append)
    client.start()
    try:
        time.sleep(0.2)
        pod = Pod()
        pod.metadata.name = "slim-0"
        pod.spec.containers = [Container(name="main", image="busybox")]
        pod.spec.scheduling_gates = [PODGANG_SCHEDULING_GATE]
        created = client.create(pod)
        created.spec.scheduling_gates = []
        client.update(created)
        deadline = time.time() + 10
        while time.time() < deadline and not any(ev.type == "Modified" for ev in events):
            time.sleep(0.02)
        mod_ev = next(ev for ev in events if ev.type == "Modified")
        assert isinstance(mod_ev.old, _OldView) and not hasattr(mod_ev.old.spec, "containers")
        assert mod_ev.old.spec.scheduling_gates == [PODGANG_SCHEDULING_GATE]
        assert pod_status_transition(mod_ev) is True
    finally:
        client.stop()
        server.stop()


def test_profile_endpoint_samples_and_is_gated():
    from grove_tpu_torch.cluster.apiserver import APIServer

    on, off = APIServer(enable_profiling=True).start(), APIServer().start()
    try:
        with urllib.request.urlopen(on.address + "/debug/profile?seconds=0.2", timeout=10) as r:
            text = r.read().decode()
        assert text.startswith("#") and "samples over" in text
        assert call(on.address, "GET", "/debug/profile?seconds=abc")[0] == 400
        assert call(off.address, "GET", "/debug/profile?seconds=0.1")[0] == 404
        report = get(off.address, "/debug/profile")  # the wall-attribution report
        assert report["kind"] == "ProfileReport"
    finally:
        on.stop()
        off.stop()


# -- the operator over HTTP -------------------------------------------------------


def _lifecycle(root: str) -> dict:
    """tests/test_cluster_mode.py's TLS and authorizer cases in one run: the
    validating webhook's denial, simple1 to Running, an out-of-band delete
    the authorizer forbids, the HPA scaling the workers group, then the
    delete that drains every finalizer."""
    rt = start(root, with_tls=True, with_authorizer=True)
    base, out = rt.apiserver.address, {}
    try:
        assert rt.webhooks.address.startswith("https://")
        bad = sample_doc()
        bad["metadata"]["name"] = "badset"
        bad["spec"]["template"]["cliques"][0]["spec"]["minAvailable"] = 99
        out["denied"] = call(base, "POST", PCS, bad)
        created = call(base, "POST", PCS, sample_doc(), user="kubectl-user")
        out["defaulted"] = created[1]["spec"]["template"].get("terminationDelay")
        converge(rt, lambda: _running(base, "simple1-0")
                 and all(_ready(p) for p in get(base, PODS)["items"]))
        out["running"] = census(base, rt)
        pclq = sorted(p["metadata"]["name"] for p in get(base, PCLQ)["items"])[0]
        out["forbidden"] = call(base, "DELETE", f"{PCLQ}/{pclq}", user="random-user")
        rt.metrics_provider.set("PodCliqueScalingGroup", "default", "simple1-0-workers", 300.0)
        converge(rt, lambda: any(g["metadata"]["name"].startswith("simple1-0-workers-")
                                 for g in get(base, PG)["items"]))
        out["scaled"] = get(base, "/apis/grove.io/v1alpha1/namespaces/default/"
                            "podcliquescalinggroups/simple1-0-workers")["spec"]["replicas"]
        assert call(base, "DELETE", PCS + "/simple1")[0] == 200
        converge(rt, lambda: not get(base, PCS)["items"] and not get(base, PODS)["items"])
        out["deleted"] = census(base, rt)
    finally:
        rt.shutdown()
    return canon(out)


def test_tls_webhooks_authorizer_hpa_and_delete_over_http_equal_jax():
    ours = _lifecycle("grove_tpu_torch")
    assert ours == _lifecycle("grove_tpu")
    assert ours["denied"][0] == 422 and "minAvailable" in ours["denied"][1]["message"]
    assert ours["forbidden"][0] == 403
    assert "managed by the grove operator" in ours["forbidden"][1]["message"]
    assert ours["scaled"] > 1 and ours["defaulted"] is not None
    assert not ours["deleted"]["pods"] and not ours["deleted"]["gangs"]


def _simple1(root: str, **kw) -> dict:
    rt = start(root, **kw)
    base = rt.apiserver.address
    try:
        assert call(base, "POST", PCS, sample_doc())[0] == 201
        converge(rt, lambda: _running(base, "simple1-0")
                 and all(_ready(p) for p in get(base, PODS)["items"]), timeout=90)
        return canon(census(base, rt))
    finally:
        rt.shutdown()


def test_threaded_operator_converges_as_jax_serial():
    """drain_concurrent under the operator (MaxConcurrentReconciles) ends
    where the JAX operator's serial drain ends."""
    ours = _simple1("grove_tpu_torch", threaded=True)
    assert ours == _simple1("grove_tpu", threaded=False)
    assert len(ours["pods"]) >= 9


_EXT_SCHEDULER = """
import sys
from grove_tpu_torch.cluster.extscheduler import run_external_scheduler
from grove_tpu_torch.sim.cluster import make_nodes
run_external_scheduler(sys.argv[1], make_nodes(16), poll=0.05, kubelet=True, device="cpu")
"""


def test_external_scheduler_subprocess_consumes_the_podgang_contract():
    """The port's operator without its scheduler; the port's external
    scheduler in a subprocess (on the CPU) binds over the wire. The world
    ends where the JAX operator's in-process scheduler ends it."""
    rt = start("grove_tpu_torch", with_scheduler=False)
    assert rt.scheduler is None and rt.cluster is None
    base = rt.apiserver.address
    proc = subprocess.Popen([sys.executable, "-c", _EXT_SCHEDULER, base], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        assert call(base, "POST", PCS, sample_doc())[0] == 201

        def done():
            if proc.poll() is not None:
                raise AssertionError(f"external scheduler died: {proc.stdout.read()}")
            gangs = get(base, PG)["items"]
            return any((g.get("status") or {}).get("phase") == "Running"
                       and (g.get("status") or {}).get("placementScore") is not None
                       for g in gangs) and all(_ready(p) for p in get(base, PODS)["items"])

        converge(rt, done, timeout=120)
        ours = canon(census(base, rt))
    finally:
        proc.kill()
        proc.wait(timeout=10)
        rt.shutdown()
    assert all(node for _n, _ready_, node in ours["pods"])
    theirs = _simple1("grove_tpu")
    assert ours["kinds"] == theirs["kinds"] and ours["gangs"] == theirs["gangs"]
    assert [p[:2] for p in ours["pods"]] == [p[:2] for p in theirs["pods"]]


def test_cluster_world_cut_equals_jax():
    """(τ) cut to 8 sets on 64 nodes through both packages' real-cluster
    tier (TLS webhooks, authorizer, deploy/operator.yaml's solver config)."""
    pkgs = {"grove_tpu": sim_side("grove_tpu"), "grove_tpu_torch": port_names("cpu")}
    got = {}
    for root, pkg in pkgs.items():
        rec = run_cluster_world(pkg, 8, 64, device="cpu" if root.endswith("torch") else None)
        walls = rec.pop("walls")
        assert walls["rounds"] >= 2 and walls["reconciles"] > 0
        got[root] = rec
    ours, theirs = got["grove_tpu_torch"], got["grove_tpu"]
    for key in ("world", "census", "gangs", "pods", "events"):
        assert ours[key] == theirs[key], key
    assert ours["pods"]["ready"] == ours["pods"]["total"] > 0
    assert set(ours["gangs"]) == {"Running"} and ours["census"]["PodCliqueSet"] == 8


# -- entry points ---------------------------------------------------------------


def test_entry_points_raise_without_cuda_and_leave_nothing_running(monkeypatch):
    import torch

    from grove_tpu_torch.cluster.extscheduler import run_external_scheduler
    from grove_tpu_torch.cluster.manager import start_operator
    from grove_tpu_torch.sim.cluster import make_nodes

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    threads = threading.active_count()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        start_operator()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        start_operator(with_scheduler=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_external_scheduler("http://127.0.0.1:9", make_nodes(2))
    assert threading.active_count() == threads


def test_event_counts_are_what_the_recorder_holds():
    """``GET /events`` is the recorder's dedup view: counts add up."""
    from grove_tpu_torch.observability.events import EVENTS

    rt = start("grove_tpu_torch")
    try:
        base = rt.apiserver.address
        assert call(base, "POST", PCS, sample_doc())[0] == 201
        converge(rt, lambda: _running(base, "simple1-0"))
        items = get(base, "/events")["items"]
        assert items == [r.as_dict() for r in EVENTS.list()]
        reasons = Counter(e["reason"] for e in items)
        assert reasons["GangAdmitted"] == 1 and reasons["PodBound"] >= 9
    finally:
        rt.shutdown()
