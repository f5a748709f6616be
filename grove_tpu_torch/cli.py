"""grove-tpu-torch CLI: apply manifests to the simulated control plane or a
live apiserver, inspect the resource tree, validate manifests, run the
operator.

    python -m grove_tpu_torch apply samples/simple1.yaml
    python -m grove_tpu_torch validate samples/*.yaml
    python -m grove_tpu_torch tree samples/simple1.yaml --scale workers=3
    python -m grove_tpu_torch --device cpu queues samples/multitenant-queues.yaml

Counterpart of ``grove_tpu/cli.py``, with its subcommands, flags, output
and exit codes, less ``bench``. The subcommands that simulate manifests
(``apply``, ``tree``, ``get``, ``describe``, ``queues``, ``nodes``,
``trace``, ``profile``, ``journey``, ``explain``, ``capacity``,
``whatif``) and ``run`` solve on the card; ``--device`` (before the
subcommand) picks another torch device. Without a card and without
``--device cpu`` they raise: the port never falls back to the CPU. The
manifest checks, the generators and every ``--apiserver`` read need no
device.
"""

from __future__ import annotations

import argparse
import sys
from typing import List


def _cmd_validate(args) -> int:
    """Admission-check manifests of any webhook-validated kind: the same
    defaulting+validation the operator's webhooks run, offline
    (PodCliqueSet and ClusterTopology — mirroring the reference's two
    validating-webhook targets)."""
    from grove_tpu_torch.admission.defaulting import (
        default_podcliqueset,
        default_queue,
    )
    from grove_tpu_torch.admission.validation import (
        validate_cluster_topology,
        validate_podcliqueset,
        validate_queue,
    )
    from grove_tpu_torch.api.load import load_manifest_objects
    from grove_tpu_torch.api.topology import ClusterTopology
    from grove_tpu_torch.api.types import PodCliqueSet, Queue

    failed = 0
    for path in args.manifests:
        with open(path) as f:
            try:
                objs = load_manifest_objects(f.read())
                for obj in objs:
                    if not isinstance(
                        obj, (PodCliqueSet, ClusterTopology, Queue)
                    ):
                        raise ValueError(
                            f"kind {obj.kind!r} has no admission validator"
                        )
            except Exception as exc:
                print(f"{path}: LOAD ERROR: {exc}")
                failed += 1
                continue
        for obj in objs:
            if isinstance(obj, ClusterTopology):
                res = validate_cluster_topology(obj)
            elif isinstance(obj, Queue):
                default_queue(obj)
                res = validate_queue(obj)
            else:
                default_podcliqueset(obj)
                res = validate_podcliqueset(obj, ClusterTopology())
            if res.ok:
                print(f"{path}: {obj.metadata.name}: OK")
                for w in res.warnings:
                    print(f"  warning: {w}")
            else:
                failed += 1
                print(f"{path}: {obj.metadata.name}: INVALID")
                for e in res.errors:
                    print(f"  {e}")
    return 1 if failed else 0


def _cmd_apply(args) -> int:
    if args.apiserver:
        return _wire_apply(args)
    device = _ensure_backend(args)
    from grove_tpu_torch.sim.harness import SimHarness

    harness = SimHarness(num_nodes=args.nodes, device=device)
    for path in args.manifests:
        with open(path) as f:
            applied = harness.apply_yaml(f.read())
        print(f"applied {', '.join(p.metadata.name for p in applied)}")
    ticks = harness.converge()
    print(f"converged in {ticks} virtual ticks (t={harness.clock.now():.0f}s)\n")
    print(harness.tree(), end="")
    return 0


def _wire_client(url: str, watch_kinds=()):
    from grove_tpu_torch.cluster.client import HttpStore

    if "://" not in url:
        url = f"http://{url}"  # kubectl-style bare host:port
    return HttpStore(url, watch_kinds=watch_kinds)


def _check_kind(kind: str, verb: str) -> bool:
    from grove_tpu_torch.api.wire import KIND_REGISTRY

    if kind in KIND_REGISTRY:
        return True
    print(
        f"{verb}: unknown kind {kind!r} (known:"
        f" {', '.join(sorted(KIND_REGISTRY))})",
        file=sys.stderr,
    )
    return False


def _sim_from_manifests(args):
    """Converged sim harness from the command's manifest args (shared sim
    bootstrap of tree/get/describe)."""
    device = _ensure_backend(args)
    from grove_tpu_torch.sim.harness import SimHarness

    harness = SimHarness(num_nodes=args.nodes, device=device)
    for path in args.manifests:
        with open(path) as f:
            harness.apply_yaml(f.read())
    harness.converge()
    return harness


def _wire_apply(args) -> int:
    """kubectl-style create-or-update against a LIVE apiserver: POST each
    manifest document; on 409 re-read the live object, carry its
    resourceVersion + finalizers, and PUT the new spec (the server's
    mutating/validating webhooks run on both paths)."""
    import yaml

    from grove_tpu_torch.api.wire import decode_object
    from grove_tpu_torch.runtime.errors import ERR_CONFLICT, GroveError

    store = _wire_client(args.apiserver)
    failed = 0
    for path in args.manifests:
        try:
            with open(path) as f:
                docs = [d for d in yaml.safe_load_all(f.read()) if d]
        except (OSError, yaml.YAMLError) as exc:
            print(f"{path}: LOAD ERROR: {exc}", file=sys.stderr)
            failed += 1
            continue
        for doc in docs:
            # kubectl -n semantics: the flag names the namespace for
            # manifests that don't carry one (decode_object would otherwise
            # default it before the CLI could tell the difference); tolerate
            # an explicit `metadata:` null the way decode_object does
            if isinstance(doc, dict):
                meta = doc.get("metadata") or {}
                meta.setdefault("namespace", args.namespace)
                doc["metadata"] = meta
            try:
                obj = decode_object(doc)
            except Exception as exc:
                print(f"{path}: DECODE ERROR: {exc}", file=sys.stderr)
                failed += 1
                continue
            try:
                created = store.create(obj)
                print(f"{obj.kind.lower()}/{created.metadata.name} created")
            except GroveError as e:
                if e.code != ERR_CONFLICT:
                    print(
                        f"{path}: {obj.metadata.name}: {e.message}",
                        file=sys.stderr,
                    )
                    failed += 1
                    continue

                # create-or-update: graft the manifest's desired state onto
                # whatever is live NOW, re-applied per conflict retry so a
                # racing writer is never clobbered
                def configure(live, manifest=obj):
                    live.spec = manifest.spec
                    live.metadata.labels = manifest.metadata.labels
                    live.metadata.annotations = manifest.metadata.annotations

                try:
                    updated = store.read_modify_write(
                        obj.kind,
                        obj.metadata.namespace,
                        obj.metadata.name,
                        configure,
                    )
                except GroveError as e2:
                    print(
                        f"{path}: {obj.metadata.name}: {e2.message}",
                        file=sys.stderr,
                    )
                    failed += 1
                    continue
                if updated is None:
                    print(
                        f"{path}: {obj.metadata.name}: conflict but object"
                        " not found",
                        file=sys.stderr,
                    )
                    failed += 1
                else:
                    print(
                        f"{obj.kind.lower()}/{obj.metadata.name} configured"
                    )
    return 1 if failed else 0


def _cmd_delete(args) -> int:
    """kubectl-style delete against a live apiserver (finalizers drain
    server-side; the controllers' delete flows run as in-cluster)."""
    from grove_tpu_torch.runtime.errors import GroveError

    store = _wire_client(args.apiserver)
    failed = 0
    for name in args.names:
        try:
            store.delete(args.kind, args.namespace, name)
            print(f"{args.kind.lower()}/{name} deleted")
        except GroveError as e:
            print(f"delete {name}: {e.message}", file=sys.stderr)
            failed += 1
    return 1 if failed else 0


def _cmd_scale(args) -> int:
    """kubectl-style scale for PodCliqueSet / PodCliqueScalingGroup /
    PodClique replicas via read-modify-write on the live apiserver (the
    validation webhook enforces minAvailable and immutability rules; the
    mutation is re-applied per conflict retry so racing writers are never
    clobbered)."""
    from grove_tpu_torch.runtime.errors import GroveError

    store = _wire_client(args.apiserver)
    seen = {}

    def set_replicas(live):
        spec = getattr(live, "spec", None)
        if spec is None or not hasattr(spec, "replicas"):
            raise _NotScalable(args.kind)
        seen["old"] = spec.replicas
        spec.replicas = args.replicas

    try:
        updated = store.read_modify_write(
            args.kind, args.namespace, args.name, set_replicas
        )
    except _NotScalable:
        print(f"scale: kind {args.kind} is not scalable", file=sys.stderr)
        return 1
    except GroveError as e:
        print(f"scale {args.name}: {e.message}", file=sys.stderr)
        return 1
    if updated is None:
        print(
            f"scale: {args.kind.lower()}/{args.name} not found",
            file=sys.stderr,
        )
        return 1
    print(
        f"{args.kind.lower()}/{args.name} scaled: replicas {seen['old']} ->"
        f" {args.replicas}"
    )
    return 0


class _NotScalable(Exception):
    pass


def _cmd_tree(args) -> int:
    if args.apiserver:
        # live-cluster tree: pure reads, no sim, no device
        from grove_tpu_torch.api.inspect import render_tree
        from grove_tpu_torch.runtime.errors import GroveError

        if args.manifests or args.scale:
            print(
                "tree: --apiserver renders live objects; manifests/--scale"
                " do not apply (use apply/scale verbs instead)",
                file=sys.stderr,
            )
            return 2
        try:
            print(
                render_tree(_wire_client(args.apiserver), args.namespace),
                end="",
            )
        except GroveError as e:
            print(f"tree: {args.apiserver}: {e.message}", file=sys.stderr)
            return 1
        return 0
    if not args.manifests:
        print(
            "tree: provide manifests to simulate, or --apiserver URL to"
            " render a live cluster",
            file=sys.stderr,
        )
        return 2
    harness = _sim_from_manifests(args)
    for spec in args.scale or []:
        name, sep, replicas_str = spec.partition("=")
        if not sep or not replicas_str.isdigit():
            print(
                f"--scale expects GROUP=REPLICAS (a non-negative integer),"
                f" got {spec!r}",
                file=sys.stderr,
            )
            return 2
        replicas = int(replicas_str)
        matched = [
            g
            for g in harness.store.list("PodCliqueScalingGroup")
            if g.metadata.name.endswith(f"-{name}") or g.metadata.name == name
        ]
        if not matched:
            print(f"no scaling group matches {name!r}", file=sys.stderr)
            return 1
        for pcsg in matched:
            if replicas < pcsg.spec.min_available:
                print(
                    f"{pcsg.metadata.name}: replicas {replicas} below"
                    f" minAvailable {pcsg.spec.min_available}",
                    file=sys.stderr,
                )
                return 1
            pcsg.spec.replicas = replicas
            harness.store.update(pcsg)
    harness.converge()
    print(harness.tree(args.namespace), end="")
    return 0


def _cmd_get(args) -> int:
    import yaml

    from grove_tpu_torch.api.serialize import export_object

    if args.apiserver and args.manifests:
        print(
            "get: --apiserver reads live objects; manifests are not applied"
            " (POST them to the apiserver instead)",
            file=sys.stderr,
        )
        return 2
    if not args.apiserver and not args.manifests:
        print(
            "get: provide manifests to simulate, or --apiserver URL to read"
            " a live cluster",
            file=sys.stderr,
        )
        return 2
    if args.watch and not args.apiserver:
        print("get: --watch requires --apiserver", file=sys.stderr)
        return 2

    if not _check_kind(args.kind, "get"):
        return 2

    if args.apiserver:
        # kubectl-style read against a LIVE apiserver (no sim, no device)
        from grove_tpu_torch.runtime.errors import GroveError

        if args.watch:
            return _watch_kind(args)
        try:
            objs = _wire_client(args.apiserver).list(args.kind, args.namespace)
        except GroveError as e:
            print(f"get: {args.apiserver}: {e.message}", file=sys.stderr)
            return 1
    else:
        harness = _sim_from_manifests(args)
        objs = harness.store.list(args.kind, args.namespace)

    if not objs:
        print(f"no {args.kind} objects", file=sys.stderr)
        return 1
    print(
        yaml.safe_dump_all(
            [export_object(o) for o in objs], sort_keys=False
        ),
        end="",
    )
    return 0


def _watch_kind(args) -> int:
    """kubectl get --watch: stream Added/Modified/Deleted events for one
    kind from the live apiserver until interrupted."""
    import threading

    from grove_tpu_torch.runtime.errors import GroveError

    store = _wire_client(args.apiserver, watch_kinds=(args.kind,))
    try:
        # preflight: the watch loop retries connection errors silently by
        # design (informer semantics) — an unreachable/wrong server must
        # fail the command up front like the non-watch path does
        store.list(args.kind, args.namespace)
    except GroveError as e:
        print(f"get: {args.apiserver}: {e.message}", file=sys.stderr)
        return 1

    done = threading.Event()

    def on_event(ev):
        obj = ev.obj
        if args.namespace and obj.metadata.namespace != args.namespace:
            return
        status = getattr(obj, "status", None)
        phase = getattr(status, "phase", "") or ""
        try:
            print(
                f"{ev.type:<9} {obj.kind.lower()}/{obj.metadata.name}"
                f" rv={obj.metadata.resource_version}"
                + (f" phase={phase}" if phase else ""),
                flush=True,
            )
        except (BrokenPipeError, OSError):
            # stdout is gone (e.g. `... --watch | head`): end the watch
            # instead of letting the client's reconnect loop re-list the
            # snapshot against the apiserver forever
            done.set()

    store.subscribe(on_event)
    store.start()
    try:
        print(
            f"watching {args.kind} on {store.base_url} (Ctrl-C to stop)",
            flush=True,
        )
    except (BrokenPipeError, OSError):
        done.set()
    try:
        while not done.is_set():
            # short slices keep Ctrl-C responsive on every platform (a long
            # main-thread Event.wait is not SIGINT-interruptible on Windows)
            done.wait(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        store.stop()
    return 0


def _cmd_describe(args) -> int:
    """kubectl-describe-style view: metadata, status counters, conditions,
    typed lastErrors, and the object's Events — live (--apiserver) or after
    simulating manifests."""
    from grove_tpu_torch.api.inspect import render_describe

    if not _check_kind(args.kind, "describe"):
        return 2
    if args.apiserver:
        if args.manifests:
            print(
                "describe: --apiserver reads live objects; manifests are"
                " not applied (use the apply verb instead)",
                file=sys.stderr,
            )
            return 2
        from grove_tpu_torch.runtime.errors import GroveError

        try:
            out = render_describe(
                _wire_client(args.apiserver),
                args.kind,
                args.namespace,
                args.name,
            )
        except GroveError as e:
            print(f"describe: {args.apiserver}: {e.message}", file=sys.stderr)
            return 1
    else:
        if not args.manifests:
            print(
                "describe: provide manifests to simulate, or --apiserver URL",
                file=sys.stderr,
            )
            return 2
        harness = _sim_from_manifests(args)
        out = render_describe(
            harness.store, args.kind, args.namespace, args.name
        )
    if not out:
        print(
            f"describe: {args.kind.lower()}/{args.name} not found",
            file=sys.stderr,
        )
        return 1
    print(out, end="")
    return 0


def _print_trace_summary(summary: dict, top: int) -> None:
    """Render a /debug/traces-shaped summary as an aligned table, widest
    total first."""
    spans = summary.get("spans", {})
    if not spans:
        print("no spans recorded (tracing enabled?)")
        return
    rows = sorted(spans.items(), key=lambda kv: -kv[1]["total_s"])[:top]
    name_w = max(len(n) for n, _ in rows)
    print(
        f"{'span':<{name_w}}  {'count':>7}  {'total_s':>9}  {'p50_s':>9}"
        f"  {'p99_s':>9}  {'max_s':>9}"
    )
    for name, agg in rows:
        print(
            f"{name:<{name_w}}  {agg['count']:>7}  {agg['total_s']:>9.4f}"
            f"  {agg['p50_s']:>9.6f}  {agg['p99_s']:>9.6f}"
            f"  {agg['max_s']:>9.6f}"
        )
    dropped = summary.get("dropped", 0)
    if dropped:
        print(f"({dropped} oldest spans dropped by the bounded buffer)")


def _cmd_trace(args) -> int:
    """Span-level latency view: pretty-print the top-N slowest span names —
    from a live apiserver's /debug/traces (--apiserver), or by running the
    manifests through a traced sim. --chrome writes the Chrome trace_event
    JSON for chrome://tracing / Perfetto."""
    import json as _json

    if args.apiserver:
        import urllib.request

        url = args.apiserver
        if "://" not in url:
            url = f"http://{url}"
        try:
            with urllib.request.urlopen(f"{url}/debug/traces", timeout=10) as r:
                summary = _json.loads(r.read())
            if args.chrome:
                with urllib.request.urlopen(
                    f"{url}/debug/traces/chrome", timeout=30
                ) as r:
                    with open(args.chrome, "wb") as f:
                        f.write(r.read())
                print(f"chrome trace written to {args.chrome}")
        except (OSError, ValueError) as e:
            # ValueError covers json.JSONDecodeError: a 200 from something
            # that is not this apiserver (proxy page, wrong port) must fail
            # with the friendly message, not a traceback
            print(f"trace: {url}: {e}", file=sys.stderr)
            return 1
        if not summary.get("enabled", False):
            print(
                "note: tracing is disabled on the server"
                " (set GROVE_TPU_TRACE=1)",
                file=sys.stderr,
            )
        _print_trace_summary(summary, args.top)
        return 0

    if not args.manifests:
        print(
            "trace: provide manifests to simulate, or --apiserver URL to"
            " read a live operator's traces",
            file=sys.stderr,
        )
        return 2
    from grove_tpu_torch.observability.tracing import TRACER

    TRACER.enable()
    TRACER.reset()
    harness = _sim_from_manifests(args)
    _print_trace_summary(TRACER.summary_json(), args.top)
    print()
    print(f"top {args.top} slowest spans:")
    for sp in TRACER.slowest(args.top):
        attrs = " ".join(
            f"{k}={v}" for k, v in sp.attrs.items() if k != "vt"
        )
        print(f"  {sp.dur_us / 1e6:>9.6f}s  {sp.name}  {attrs}")
    if args.chrome:
        with open(args.chrome, "w") as f:
            _json.dump(TRACER.chrome_trace(), f)
        print(f"\nchrome trace written to {args.chrome}")
    # keep the harness alive through the export (watch threads etc.)
    del harness
    return 0


def _print_profile_report(doc: dict, top: int) -> None:
    """Render the wall-attribution report (docs/observability.md): top
    phase sinks by total self-time, per-controller roll-up, coverage."""
    if not doc.get("enabled", False):
        print(
            "note: the wall-attribution profiler is disabled on the server"
            " (set GROVE_TPU_PROFILE=1)",
            file=sys.stderr,
        )
    print(
        f"attributed {doc.get('attributed_seconds', 0.0):.3f}s over"
        f" {doc.get('covered_wall_seconds', 0.0):.3f}s of covered wall"
        + (
            f" (coverage {doc['coverage']:.1%})"
            if "coverage" in doc
            else ""
        )
    )
    rows = [
        (
            ph["controller"],
            str(ph["shard"]) if ph["shard"] >= 0 else "-",
            ph["phase"],
            str(ph["count"]),
            f"{ph['total_s']:.4f}",
            f"{ph['p50_s'] * 1e6:.0f}",
            f"{ph['p99_s'] * 1e6:.0f}",
        )
        for ph in doc.get("phases", [])[:top]
    ]
    if rows:
        _print_table(
            ("CONTROLLER", "SHARD", "PHASE", "COUNT", "TOTAL-S", "P50-µS",
             "P99-µS"),
            rows,
        )
    by_ctrl = doc.get("by_controller") or {}
    if by_ctrl:
        print()
        print(
            "per controller: "
            + "  ".join(
                f"{c}={s:.3f}s"
                for c, s in sorted(by_ctrl.items(), key=lambda kv: -kv[1])
            )
        )


def _cmd_profile(args) -> int:
    """Wall-attribution view (docs/observability.md): where control-plane
    seconds went, per (controller, shard, phase) — from a live apiserver's
    GET /debug/profile, or by converging manifests under a profiled sim."""
    if args.apiserver:
        doc = _fetch_server_json(args.apiserver, "/debug/profile", "profile")
        if doc is None:
            return 1
        _print_profile_report(doc, args.top)
        return 0

    if not args.manifests:
        print(
            "profile: provide manifests to simulate, or --apiserver URL to"
            " read a live operator's attribution report",
            file=sys.stderr,
        )
        return 2
    from grove_tpu_torch.observability.profile import PROFILER

    PROFILER.enable()
    PROFILER.reset()
    # no coverage claim here: the sim bootstrap (harness build, manifest
    # apply) is outside the attribution window by design — the gated
    # coverage measurement lives in `make profile-smoke` / the bench
    harness = _sim_from_manifests(args)
    _print_profile_report(PROFILER.report(), args.top)
    del harness
    return 0


def _print_slo_report(doc: dict) -> None:
    """Render one SloReport (docs/observability.md "SLO observatory"):
    a table of objectives, then the non-internal series appendix."""
    objectives = doc.get("objectives") or []
    if not objectives:
        print(
            "no SLO objectives defined"
            + ("" if doc.get("enabled") else " (engine disabled)")
        )
    for row in objectives:
        att = row.get("attainment")
        budget = row.get("budget_remaining")
        print(
            f"{row['name']}: {row['state'].upper()}  attainment="
            + (f"{att:.4f}" if att is not None else "-")
            + "  budget_remaining="
            + (f"{budget:.2%}" if budget is not None else "-")
            + f"  burn fast/slow={row['burn_rate_fast']:g}x/"
            f"{row['burn_rate_slow']:g}x  breaches={row['breaches']}"
            f" recoveries={row['recoveries']}"
        )
        print(f"    {row['spec']}")
    series = doc.get("series") or {}
    shown = 0
    for name in sorted(series):
        if name.startswith("slo:"):
            continue  # engine-internal good/bad indicator series
        win = series[name]
        if win.get("kind") == "dist":
            print(
                f"  {name}: n={win.get('count', 0)}"
                + (
                    f" p50={win['p50']:.4f} p99={win['p99']:.4f}"
                    f" max={win['max']:.4f}"
                    if win.get("count")
                    else ""
                )
            )
        elif win.get("kind") == "gauge" and win.get("n"):
            print(
                f"  {name}: n={win['n']} last={win['last']:.4f}"
                f" mean={win['mean']:.4f} min={win['min']:.4f}"
                f" max={win['max']:.4f}"
            )
        shown += 1
        if shown >= 24:
            print("  ...")
            break


def _cmd_slo(args) -> int:
    """SLO observatory report: per-objective attainment, error budget,
    burn rates, breach state — from a live apiserver's GET /debug/slo
    (the engine runs in the operator process)."""
    if not args.apiserver:
        print(
            "slo: --apiserver URL required (the SLO engine lives in the"
            " operator process; arm it with GROVE_TPU_TIMESERIES=1"
            " GROVE_TPU_SLO=1)",
            file=sys.stderr,
        )
        return 2
    doc = _fetch_server_json(
        args.apiserver, f"/debug/slo?window={args.window}", "slo"
    )
    if doc is None:
        return 1
    _print_slo_report(doc)
    return 0


def _print_federation_status(doc: dict) -> None:
    print(
        f"federation: {len(doc.get('clusters', []))} cluster(s),"
        f" spillovers={doc.get('spillovers', 0)}"
        f" reroutes={doc.get('reroutes', 0)}"
        f" decisions={doc.get('decisions', 0)}"
    )
    rows = [("REGION", "STATE", "PHASE", "PLACEMENTS", "PENDING", "NODES")]
    for cl in doc.get("clusters", []):
        rows.append(
            (
                cl.get("region", "?"),
                cl.get("state", "?"),
                f"{cl.get('phaseOffset', 0.0):g}s",
                str(cl.get("placements", 0)),
                str(cl.get("pendingGangs", "-")),
                str(cl.get("nodes", "-")),
            )
        )
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    for row in rows:
        print("  " + "  ".join(c.ljust(w) for c, w in zip(row, widths)))
    usage = doc.get("globalUsage") or {}
    for queue in sorted(usage):
        vec = ", ".join(
            f"{r}={usage[queue][r]:g}" for r in sorted(usage[queue])
        )
        print(f"  queue {queue}: {vec or 'idle'}")


def _cmd_federation(args) -> int:
    """Federation registry + routing ledger roll-up: per-region state,
    placements, spillover/re-route counters, and the global (level-3
    fold) per-queue usage — from a live apiserver's GET /federation."""
    if not args.apiserver:
        print(
            "federation: --apiserver URL required (the router lives in"
            " the operator process; single-cluster deployments serve"
            " 404 here)",
            file=sys.stderr,
        )
        return 2
    doc = _fetch_server_json(args.apiserver, "/federation", "federation")
    if doc is None:
        return 1
    if args.output == "json":
        print(json.dumps(doc, indent=2, sort_keys=True))
        return 0
    _print_federation_status(doc)
    return 0


def _print_forecast_report(doc: dict) -> None:
    state = "enabled" if doc.get("enabled") else "disabled"
    print(
        f"forecaster: {state}, period={doc.get('period_s', 0):g}s"
        f" horizon={doc.get('horizon_s', 0):g}s"
        f" history={doc.get('history_s', 0):g}s"
    )
    forecasts = doc.get("forecasts", [])
    if not forecasts:
        print(
            "  no series (watch some via FORECASTER.watch() or pass"
            " --series)"
        )
        return
    for fc in forecasts:
        line = (
            f"  {fc['series']}: model={fc.get('model', '?')}"
            f" n={fc.get('n', 0)}"
        )
        if "last" in fc:
            line += f" last={fc['last']:.4f} sigma={fc.get('sigma', 0):.4f}"
        if "skill" in fc:
            line += (
                f" mae={fc['mae']:.4f} vs naive={fc['persistence_mae']:.4f}"
                f" skill={fc['skill']:+.4f}"
            )
        print(line)
        peak = fc.get("peak")
        if peak is not None:
            print(
                f"    peak {peak['mean']:.4f} at t={peak['at_s']:.0f}s;"
                f" {len(fc.get('points', []))} point(s), band ±"
                f"{2.0 * fc.get('sigma', 0.0):.4f}"
            )


def _cmd_forecast(args) -> int:
    """Per-series horizon forecasts with confidence bands + skill vs the
    persistence baseline — from a live apiserver's GET /debug/forecast
    (the forecaster reads the operator process's time-series rings)."""
    if not args.apiserver:
        print(
            "forecast: --apiserver URL required (the forecaster lives in"
            " the operator process; arm it with GROVE_TPU_TIMESERIES=1"
            " GROVE_TPU_FORECAST=1)",
            file=sys.stderr,
        )
        return 2
    query = "&".join(f"series={s}" for s in (args.series or []))
    if args.horizon:
        query += ("&" if query else "") + f"horizon={args.horizon}"
    doc = _fetch_server_json(
        args.apiserver,
        "/debug/forecast" + (f"?{query}" if query else ""),
        "forecast",
    )
    if doc is None:
        return 1
    _print_forecast_report(doc)
    return 0


def _print_ledger_report(doc: dict) -> None:
    state = "enabled" if doc.get("enabled") else "disabled"
    flip = doc.get("flip_confirmed_rate")
    delta = doc.get("mean_budget_delta")
    print(
        f"ledger: {state}, {doc.get('recorded_total', 0)} recorded"
        f" ({doc.get('retained', 0)} retained),"
        f" {doc.get('executed', 0)} executed /"
        f" {doc.get('skipped', 0)} skipped"
        + (f", flip-confirmed {flip:.0%}" if flip is not None else "")
        + (
            f", mean budget delta {delta:+.4f}"
            if delta is not None
            else ""
        )
    )
    rows = []
    for e in doc.get("entries", []):
        eff = e.get("effect") or {}
        d = eff.get("budget_delta")
        rows.append(
            (
                str(e["id"]),
                f"{e['vt']:g}",
                e["trigger"]["kind"],
                e["action"]["kind"],
                e["action"].get("target", "") or "-",
                e["outcome"],
                f"{d:+.4f}" if d is not None else (e.get("reason") or "-"),
            )
        )
    if rows:
        _print_table(
            ("ID", "VT", "TRIGGER", "ACTION", "TARGET", "OUTCOME",
             "ΔBUDGET/REASON"),
            rows,
        )


def _cmd_ledger(args) -> int:
    """The causal decision→effect ledger: every remediation the
    controller considered, as trigger→diagnosis→simulation→action→effect
    chains — from a live apiserver's GET /debug/ledger."""
    if not args.apiserver:
        print(
            "ledger: --apiserver URL required (the ledger lives in the"
            " operator process; arm it with GROVE_TPU_LEDGER=1)",
            file=sys.stderr,
        )
        return 2
    doc = _fetch_server_json(args.apiserver, "/debug/ledger", "ledger")
    if doc is None:
        return 1
    _print_ledger_report(doc)
    return 0


def _print_journey(doc: dict) -> None:
    name = f"{doc.get('namespace')}/{doc.get('name')}"
    state = "complete" if doc.get("complete") else "in flight"
    extra = ""
    if "partition" in doc:
        part = doc["partition"]
        extra = f", frontier partition {part}" if part >= 0 else ", residual"
    print(f"PodGang {name}: {state}, {doc.get('rounds', 0)} solve round(s){extra}")
    rows = [
        (
            ph["phase"],
            f"+{ph['t_s']:.6f}s",
            f"vt={ph['vt']:g}" if "vt" in ph else "-",
        )
        for ph in doc.get("phases", [])
    ]
    if rows:
        _print_table(("PHASE", "T", "VIRTUAL"), rows)
    if doc.get("segments"):
        print()
        print(
            "admission decomposition: "
            + "  ".join(
                f"{k}={v:.6f}s" for k, v in doc["segments"].items()
            )
            + f"  (total {doc.get('total_s', 0.0):.6f}s)"
        )


def _cmd_journey(args) -> int:
    """One PodGang's causal admission timeline (docs/observability.md
    "Gang journeys"): created → first-scan → encode → solve → commit →
    scheduled, with the queue-wait/service/solver split — from a live
    apiserver's GET /gangs/{ns}/{name}/journey, or by converging manifests
    under a journey-traced sim."""
    if args.apiserver:
        if not args.gang:
            print(
                "journey: --apiserver mode needs --gang NAME"
                " (and --namespace)",
                file=sys.stderr,
            )
            return 2
        doc = _fetch_server_json(
            args.apiserver,
            f"/gangs/{args.namespace}/{args.gang}/journey",
            "journey",
        )
        if doc is None:
            return 1
        _print_journey(doc)
        return 0

    if not args.manifests:
        print(
            "journey: provide manifests to simulate, or --apiserver URL to"
            " read a live operator's journeys",
            file=sys.stderr,
        )
        return 2
    from grove_tpu_torch.observability.journey import JOURNEYS

    JOURNEYS.enable()
    JOURNEYS.reset()
    harness = _sim_from_manifests(args)
    if args.gang:
        doc = JOURNEYS.journey(args.namespace, args.gang)
        if doc is None:
            print(
                f"journey: no journey recorded for PodGang"
                f" {args.namespace}/{args.gang}",
                file=sys.stderr,
            )
            return 1
        _print_journey(doc)
    else:
        # no gang named: every PodGang the converge admitted, worst last
        gangs = sorted(
            (j.as_dict() for j in JOURNEYS.completed()),
            key=lambda d: d.get("total_s", 0.0),
        )
        for doc in gangs:
            _print_journey(doc)
            print()
        summary = JOURNEYS.decomposition()
        print(
            f"{summary['journeys']} journeys: admission p50"
            f" {summary['admission_p50_s']:.6f}s / p99"
            f" {summary['admission_p99_s']:.6f}s"
        )
    del harness
    return 0


def _print_explain(doc: dict) -> None:
    """Render one GangExplain verdict (docs/observability.md "Admission
    explain"): headline, then the constraint-elimination funnel."""
    head = f"{doc.get('namespace')}/{doc.get('name')}: "
    state = doc.get("state")
    if state == "scheduled":
        print(head + "SCHEDULED (nothing to explain)")
        return
    if doc.get("fits_now"):
        print(head + "FITS NOW — " + doc.get("message", ""))
    else:
        slug = doc.get("detail") or "?"
        print(
            head
            + f"BLOCKED on {doc.get('binding_constraint')} ({slug}): "
            + (doc.get("detail_text") or doc.get("message") or "")
        )
    funnel = doc.get("funnel") or []
    if funnel:
        rows = [
            (
                ("✗ " if not f.get("ok") else "  ") + f["stage"],
                str(f.get("surviving_nodes", "")),
                f.get("detail", ""),
            )
            for f in funnel
        ]
        _print_table(("STAGE", "NODES", "DETAIL"), rows)
    q = doc.get("queue") or {}
    if q.get("ahead"):
        print(
            f"ahead in order ({q.get('ahead_count')}):"
            f" {', '.join(q['ahead'])}"
        )
    if "partition" in doc:
        print(f"frontier partition: {doc['partition']}")


def _print_capacity(doc: dict) -> None:
    print(
        f"{doc.get('nodes')} schedulable of {doc.get('totalNodes')} nodes;"
        f" total free: {_fmt_resource_map(doc.get('totalFree', {}))}"
    )
    if doc.get("superDomainLevel"):
        print(f"super-domain level: {doc['superDomainLevel']}")
    rows = []
    for lvl in doc.get("levels", []):
        rows.append(
            (
                lvl.get("domain", lvl["key"]),
                str(lvl.get("domainCount", 0)),
                _fmt_resource_map(lvl.get("fragmentation", {})),
                _fmt_resource_map(lvl.get("largestDomainFree", {})),
            )
        )
    if rows:
        _print_table(
            ("LEVEL", "DOMAINS", "FRAGMENTATION", "LARGEST-FREE"), rows
        )


def _cmd_explain(args) -> int:
    """Admission explain verdict for one PodGang — from a live
    apiserver's GET /gangs/{ns}/{name}/explain, or after simulating
    manifests (the still-pending gangs are the interesting ones)."""
    if args.apiserver:
        if not args.gang:
            print(
                "explain: --apiserver mode needs --gang NAME"
                " (and --namespace)",
                file=sys.stderr,
            )
            return 2
        doc = _fetch_server_json(
            args.apiserver,
            f"/gangs/{args.namespace}/{args.gang}/explain",
            "explain",
        )
        if doc is None:
            return 1
        _print_explain(doc)
        return 0
    if not args.manifests:
        print(
            "explain: provide manifests to simulate, or --apiserver URL"
            " to query a live operator",
            file=sys.stderr,
        )
        return 2
    harness = _sim_from_manifests(args)
    gangs = (
        [args.gang]
        if args.gang
        else [
            g.metadata.name
            for g in harness.store.list("PodGang", args.namespace)
        ]
    )
    for i, gang in enumerate(gangs):
        doc = harness.explain.explain(args.namespace, gang)
        if doc is None:
            print(
                f"explain: PodGang {args.namespace}/{gang} not found",
                file=sys.stderr,
            )
            return 1
        if i:
            print()
        _print_explain(doc)
    return 0


def _cmd_capacity(args) -> int:
    """Capacity & fragmentation introspection — GET /debug/capacity on a
    live apiserver, or after simulating manifests."""
    if args.apiserver:
        doc = _fetch_server_json(
            args.apiserver, "/debug/capacity", "capacity"
        )
        if doc is None:
            return 1
        _print_capacity(doc)
        return 0
    device = _ensure_backend(args)
    from grove_tpu_torch.sim.harness import SimHarness

    harness = SimHarness(num_nodes=args.nodes, device=device)
    for path in args.manifests:
        with open(path) as f:
            harness.apply_yaml(f.read())
    if args.manifests:
        harness.converge()
    _print_capacity(harness.explain.capacity())
    return 0


def _whatif_body(args) -> dict:
    actions = []
    for node in args.drain or []:
        actions.append({"action": "drain-node", "node": node})
    for node in args.remove or []:
        actions.append({"action": "remove-node", "node": node})
    if args.add_nodes:
        actions.append(
            {
                "action": "add-nodes",
                "count": args.add_nodes,
                "like": args.like,
            }
        )
    if args.set_queue:
        act = {"action": "set-queue", "queue": args.set_queue}
        for field_name, raw in (
            ("deserved", args.deserved),
            ("ceiling", args.ceiling),
        ):
            if raw:
                try:
                    act[field_name] = {
                        k: float(v)
                        for k, _, v in (
                            part.partition("=") for part in raw.split(",")
                        )
                    }
                except ValueError:
                    raise _BadResourceMap(field_name, raw)
        actions.append(act)
    return {
        "gang": {"namespace": args.namespace, "name": args.gang},
        "actions": actions,
    }


class _BadResourceMap(Exception):
    def __init__(self, field_name: str, raw: str) -> None:
        self.field_name = field_name
        self.raw = raw


def _cmd_whatif(args) -> int:
    """Hypothetical trial solve: would the gang fit if N nodes were
    drained/removed/added or a queue's entitlement changed? POST
    /debug/whatif on a live apiserver, or against a simulated cluster.
    Commits nothing either way."""
    try:
        body = _whatif_body(args)
    except _BadResourceMap as e:
        print(
            f"whatif: --{e.field_name} expects RES=VALUE[,RES=VALUE],"
            f" got {e.raw!r}",
            file=sys.stderr,
        )
        return 2
    if not body["actions"]:
        print(
            "whatif: give at least one action (--drain/--remove/"
            "--add-nodes --like/--set-queue)",
            file=sys.stderr,
        )
        return 2
    if args.apiserver:
        doc = _post_server_json_body(
            args.apiserver, "/debug/whatif", body, "whatif"
        )
        if doc is None:
            return 1
    else:
        if not args.manifests:
            print(
                "whatif: provide manifests to simulate, or --apiserver"
                " URL for a live operator",
                file=sys.stderr,
            )
            return 2
        harness = _sim_from_manifests(args)
        try:
            doc = harness.explain.whatif(body)
        except ValueError as e:
            print(f"whatif: {e}", file=sys.stderr)
            return 1
    before, after = doc.get("before", {}), doc.get("after", {})
    print(
        f"before: fits_now={before.get('fits_now')}"
        f" (binding: {before.get('binding_constraint')})"
    )
    print(
        f"after:  fits_now={after.get('fits_now')}"
        f" (binding: {after.get('binding_constraint')})"
    )
    print(
        "verdict FLIPS under this hypothetical"
        if doc.get("flipped")
        else "verdict unchanged"
    )
    return 0


def _post_server_json_body(apiserver: str, path: str, body: dict, label: str):
    """POST a JSON document to a live apiserver; returns the JSON response
    or None after printing the error."""
    import json as _json
    import urllib.error
    import urllib.request

    url = apiserver if "://" in apiserver else f"http://{apiserver}"
    req = urllib.request.Request(
        f"{url}{path}",
        data=_json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return _json.loads(r.read())
    except urllib.error.HTTPError as e:
        try:
            doc = _json.loads(e.read())
            msg = doc.get("message", str(e))
        except ValueError:
            msg = str(e)
        print(f"{label}: {url}: {msg}", file=sys.stderr)
        return None
    except (OSError, ValueError) as e:
        print(f"{label}: {url}: {e}", file=sys.stderr)
        return None


def _fmt_resource_map(m: dict) -> str:
    return ",".join(f"{k}={g:g}" for k, g in sorted(m.items())) or "-"


def _print_table(headers: tuple, rows: list) -> None:
    """Aligned-column table (kubectl-get style); shared by the queue and
    node views."""
    widths = [
        max(len(headers[c]), max(len(r[c]) for r in rows))
        for c in range(len(headers))
    ]
    print("  ".join(h.ljust(w) for h, w in zip(headers, widths)))
    for r in rows:
        print("  ".join(v.ljust(w) for v, w in zip(r, widths)))


def _fetch_server_json(apiserver: str, path: str, label: str):
    """GET a JSON document from a live apiserver (scheme-defaulted);
    returns None after printing the error."""
    import json as _json
    import urllib.request

    url = apiserver if "://" in apiserver else f"http://{apiserver}"
    try:
        with urllib.request.urlopen(f"{url}{path}", timeout=10) as r:
            return _json.loads(r.read())
    except (OSError, ValueError) as e:
        print(f"{label}: {url}: {e}", file=sys.stderr)
        return None


def _print_queue_table(items: list) -> None:
    if not items:
        print("no queues (and no queue-attributed usage)")
        return
    rows = [
        (
            it["name"] + ("" if it.get("defined", True) else " (implicit)"),
            _fmt_resource_map(it.get("deserved", {})),
            _fmt_resource_map(it.get("ceiling", {})),
            _fmt_resource_map(it.get("usage", {})),
            f"{it.get('dominantShare', 0.0):.3f}",
            str(it.get("admittedGangs", 0)),
            str(it.get("pendingGangs", 0)),
        )
        for it in items
    ]
    _print_table(
        ("NAME", "DESERVED", "CEILING", "USAGE", "SHARE", "ADMITTED",
         "PENDING"),
        rows,
    )


def _cmd_queues(args) -> int:
    """Per-queue quota summary (docs/quota.md): deserved/ceiling/usage,
    dominant share, admitted/pending gangs — from a live apiserver's
    GET /queues, or after simulating manifests (Queue + PodCliqueSet docs)."""
    if args.apiserver:
        doc = _fetch_server_json(args.apiserver, "/queues", "queues")
        if doc is None:
            return 1
        _print_queue_table(doc.get("items", []))
        return 0

    if not args.manifests:
        print(
            "queues: provide manifests to simulate (Queue + PodCliqueSet"
            " docs), or --apiserver URL to read a live cluster",
            file=sys.stderr,
        )
        return 2
    device = _ensure_backend(args)
    from grove_tpu_torch.api.load import load_manifest_objects
    from grove_tpu_torch.quota.manager import quota_snapshot
    from grove_tpu_torch.sim.harness import SimHarness

    from grove_tpu_torch.api.types import PodCliqueSet, Queue

    harness = SimHarness(num_nodes=args.nodes, device=device)
    for path in args.manifests:
        with open(path) as f:
            for obj in load_manifest_objects(f.read()):
                if not isinstance(obj, (PodCliqueSet, Queue)):
                    print(
                        f"queues: {path}: kind {obj.kind!r} is not"
                        " simulated here (Queue / PodCliqueSet only)",
                        file=sys.stderr,
                    )
                    return 2
                harness.apply(obj)
    harness.converge()
    _print_queue_table(quota_snapshot(harness.store))
    return 0


def _print_node_table(items: list) -> None:
    if not items:
        print("no nodes")
        return
    rows = [
        (
            it.get("name", "?"),
            it.get("state", "?")
            + (" (cordoned)" if it.get("cordoned") else ""),
            it.get("drain") or "-",
            f"{it.get('heartbeatAgeSeconds', 0.0):.1f}s",
            str(it.get("boundPods", 0)),
            _fmt_resource_map(it.get("capacity", {})),
        )
        for it in items
    ]
    _print_table(
        ("NAME", "STATE", "DRAIN", "HEARTBEAT-AGE", "PODS", "CAPACITY"), rows
    )


def _cmd_nodes(args) -> int:
    """Node health table (docs/robustness.md): lifecycle state, heartbeat
    age, bound pods, capacity — from a live apiserver's GET /nodes, or
    after simulating manifests on a synthetic cluster."""
    if args.apiserver:
        doc = _fetch_server_json(args.apiserver, "/nodes", "nodes")
        if doc is None:
            return 1
        _print_node_table(doc.get("items", []))
        return 0

    device = _ensure_backend(args)
    from grove_tpu_torch.sim.harness import SimHarness

    harness = SimHarness(num_nodes=args.nodes, device=device)
    for path in args.manifests:
        with open(path) as f:
            harness.apply_yaml(f.read())
    if args.manifests:
        harness.converge()
    _print_node_table(harness.node_monitor.node_snapshot())
    return 0


def _post_server_json(apiserver: str, path: str, label: str):
    """POST (no body) to a live apiserver; returns the JSON document or
    None after printing the error."""
    import json as _json
    import urllib.error
    import urllib.request

    url = apiserver if "://" in apiserver else f"http://{apiserver}"
    req = urllib.request.Request(f"{url}{path}", data=b"", method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return _json.loads(r.read())
    except urllib.error.HTTPError as e:
        try:
            doc = _json.loads(e.read())
            msg = doc.get("message", str(e))
        except ValueError:
            msg = str(e)
        print(f"{label}: {url}: {msg}", file=sys.stderr)
        return None
    except (OSError, ValueError) as e:
        print(f"{label}: {url}: {e}", file=sys.stderr)
        return None


def _cmd_drain(args) -> int:
    """Gang-aware node drain (docs/robustness.md): cordon the node and
    evict its gangs whole, budget-checked, with trial-solved pre-placement
    — POST /nodes/{name}/drain on a live apiserver."""
    doc = _post_server_json(
        args.apiserver, f"/nodes/{args.node}/drain", "drain"
    )
    if doc is None:
        return 1
    print(
        f"node {doc.get('name', args.node)} draining; watch progress with"
        f" `cli nodes --apiserver {args.apiserver}` (DRAIN column)"
    )
    return 0


def _cmd_uncordon(args) -> int:
    """Return a drained/cordoned node to service — POST
    /nodes/{name}/uncordon on a live apiserver."""
    doc = _post_server_json(
        args.apiserver, f"/nodes/{args.node}/uncordon", "uncordon"
    )
    if doc is None:
        return 1
    print(f"node {doc.get('name', args.node)} uncordoned")
    return 0


def _cmd_crds(args) -> int:
    from grove_tpu_torch.cluster.crdgen import render_crds, write_crds

    if args.output_dir:
        for path in write_crds(args.output_dir):
            print(path)
        return 0
    print(render_crds(), end="")
    return 0


def _cmd_detect_topology(args) -> int:
    """Automatic topology detection (reference roadmap item, shipped here):
    infer the ClusterTopology CR from node labels and print it."""
    import yaml

    from grove_tpu_torch.admission.validation import validate_cluster_topology
    from grove_tpu_torch.api.serialize import export_object
    from grove_tpu_torch.cluster.autotopo import (
        TopologyDetectionError,
        detect_topology,
        load_nodes_file,
    )

    if args.file:
        nodes = load_nodes_file(args.file)
    else:
        from grove_tpu_torch.sim.cluster import make_nodes

        nodes = make_nodes(args.sim_nodes)
    try:
        topo = detect_topology(nodes, name=args.name)
    except TopologyDetectionError as e:
        print(f"detect-topology: {e}", file=sys.stderr)
        return 1
    res = validate_cluster_topology(topo)
    if not res.ok:  # defensive: detection guarantees a valid CR
        print(f"detect-topology: invalid result: {res.errors}", file=sys.stderr)
        return 1
    print(yaml.safe_dump(export_object(topo), sort_keys=False), end="")
    return 0


def _cmd_api_docs(args) -> int:
    from grove_tpu_torch.cluster.apidocs import render_api_reference, write_api_reference

    if args.write:
        print(write_api_reference(args.write))
        return 0
    print(render_api_reference(), end="")
    return 0


def _cmd_run(args) -> int:
    """Run the real-cluster operator: embedded apiserver (or external via
    --apiserver), webhook server, controllers, solver-backed scheduler.
    Serves /healthz /readyz /metrics; optional leader-election lock."""
    device = _ensure_backend(args)
    import threading

    from grove_tpu_torch.cluster.manager import start_operator
    from grove_tpu_torch.config.operator import load_operator_configuration_file
    from grove_tpu_torch.sim.cluster import make_nodes

    config = (
        load_operator_configuration_file(args.config) if args.config else None
    )
    nodes = make_nodes(args.nodes)
    topology = None
    if args.auto_detect_topology:
        from grove_tpu_torch.cluster.autotopo import TopologyDetectionError, detect_topology

        try:
            topology = detect_topology(nodes)
        except TopologyDetectionError as exc:
            print(f"error: topology detection failed: {exc}", file=sys.stderr)
            return 1
        print(
            "detected topology: "
            + " > ".join(lvl.domain for lvl in topology.spec.levels)
        )
    if args.leader_election and not args.apiserver:
        # election on a PRIVATE embedded apiserver is vacuous: each replica
        # would win its own lease and all of them would lead. HA requires
        # every replica to elect on ONE shared apiserver.
        print(
            "warning: --leader-election without --apiserver elects on this"
            " process's own embedded apiserver — replicas must share one"
            " apiserver (--apiserver URL) for the election to exclude them",
            file=sys.stderr,
        )
    if args.durability_dir and args.apiserver:
        print(
            "warning: --durability-dir applies to the EMBEDDED apiserver's"
            " store; an external apiserver owns its own durability —"
            " ignoring it",
            file=sys.stderr,
        )
    rt = start_operator(
        nodes=nodes,
        topology=topology,
        config=config,
        with_tls=args.tls,
        with_authorizer=args.authorizer,
        threaded=args.threaded,
        apiserver_url=args.apiserver,
        leader_lock_path=args.leader_lock,
        leader_election=True if args.leader_election else None,
        durability_dir=args.durability_dir,
        device=device,
    )
    if rt.apiserver is not None:
        print(f"apiserver:  {rt.apiserver.address}")
    if args.durability_dir:
        print(f"durability: {args.durability_dir} (WAL + snapshots)")
    if rt.webhooks is not None:
        print(f"webhooks:   {rt.webhooks.address}")
    print("operator running; Ctrl-C to stop", flush=True)
    stop = threading.Event()
    try:
        rt.run(stop)
    except KeyboardInterrupt:
        pass
    finally:
        rt.shutdown()
    return 0


def _cmd_config_check(args) -> int:
    from grove_tpu_torch.config.operator import load_operator_configuration_file

    try:
        cfg = load_operator_configuration_file(args.config)
    except Exception as exc:
        print(f"INVALID: {exc}")
        return 1
    print(
        f"OK: logLevel={cfg.log_level} solver.chunkSize={cfg.solver.chunk_size}"
        f" authorizer.enabled={cfg.authorizer.enabled}"
    )
    return 0


def _ensure_backend(args):
    """The device of a sim-backed command or ``run``: ``--device``, else the
    card, which is probed first (``ensure_healthy_backend``, memoized). No
    card, or an unhealthy one, raises: the port never falls back to the CPU.
    Commands that need no device (validate, config-check, the generators,
    every ``--apiserver`` read) never call it."""
    from grove_tpu_torch.utils.platform import ensure_healthy_backend, resolve_device

    device = resolve_device(args.device)
    if device.type == "cuda":
        ensure_healthy_backend(timeout_s=45.0)
    return device


def main(argv: List[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="grove-tpu-torch", description=__doc__)
    parser.add_argument(
        "--device",
        default=None,
        help="torch device of the sim-backed commands and `run` (default:"
        " cuda, the card; raises without one)",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("validate", help="admission-check manifests")
    p.add_argument("manifests", nargs="+")
    p.set_defaults(fn=_cmd_validate)

    p = sub.add_parser(
        "apply",
        help=(
            "apply manifests — to the simulated control plane, or to a live"
            " apiserver with --apiserver URL (create-or-update)"
        ),
    )
    p.add_argument("manifests", nargs="+")
    p.add_argument("--nodes", type=int, default=32)
    p.add_argument("--apiserver", help="apply to a live apiserver instead")
    p.add_argument("--namespace", default="default")
    p.set_defaults(fn=_cmd_apply)

    p = sub.add_parser("delete", help="delete objects on a live apiserver")
    p.add_argument("names", nargs="+")
    p.add_argument("--apiserver", required=True)
    p.add_argument("--kind", default="PodCliqueSet")
    p.add_argument("--namespace", default="default")
    p.set_defaults(fn=_cmd_delete)

    p = sub.add_parser(
        "scale", help="set replicas on a live apiserver (read-modify-write)"
    )
    p.add_argument("name")
    p.add_argument("--replicas", type=int, required=True)
    p.add_argument("--apiserver", required=True)
    p.add_argument("--kind", default="PodCliqueSet")
    p.add_argument("--namespace", default="default")
    p.set_defaults(fn=_cmd_scale)

    p = sub.add_parser(
        "tree",
        help=(
            "dump the pcs>pclq/pcsg>pg>pod tree — simulated (apply"
            " manifests first) or live with --apiserver URL"
        ),
    )
    p.add_argument("manifests", nargs="*")
    p.add_argument("--nodes", type=int, default=32)
    p.add_argument("--scale", action="append", metavar="GROUP=REPLICAS")
    p.add_argument("--apiserver", help="render a live apiserver instead")
    p.add_argument("--namespace", default="default")
    p.set_defaults(fn=_cmd_tree)

    p = sub.add_parser(
        "get",
        help=(
            "export live objects as YAML — from a real apiserver"
            " (--apiserver URL) or after applying manifests to a sim"
        ),
    )
    p.add_argument("manifests", nargs="*")
    p.add_argument("--kind", default="PodGang")
    p.add_argument("--nodes", type=int, default=32)
    p.add_argument("--apiserver", help="read from a live apiserver instead")
    p.add_argument(
        "--namespace",
        default=None,
        help="filter to one namespace (default: all namespaces)",
    )
    p.add_argument(
        "--watch",
        action="store_true",
        help="stream Added/Modified/Deleted events (requires --apiserver)",
    )
    p.set_defaults(fn=_cmd_get)

    p = sub.add_parser(
        "describe",
        help=(
            "kubectl-describe one object (conditions, lastErrors, events)"
            " — live with --apiserver or after simulating manifests"
        ),
    )
    p.add_argument("name")
    p.add_argument("manifests", nargs="*")
    p.add_argument("--kind", default="PodCliqueSet")
    p.add_argument("--nodes", type=int, default=32)
    p.add_argument("--apiserver", help="read from a live apiserver instead")
    p.add_argument("--namespace", default="default")
    p.set_defaults(fn=_cmd_describe)

    p = sub.add_parser(
        "queues",
        help=(
            "per-queue quota summary (deserved/usage/share, gang counts) —"
            " live with --apiserver URL or after simulating manifests"
        ),
    )
    p.add_argument("manifests", nargs="*")
    p.add_argument("--nodes", type=int, default=32)
    p.add_argument("--apiserver", help="read GET /queues from a live server")
    p.set_defaults(fn=_cmd_queues)

    p = sub.add_parser(
        "nodes",
        help=(
            "node health table (state, heartbeat age, bound pods) — live"
            " with --apiserver URL or after simulating manifests"
        ),
    )
    p.add_argument("manifests", nargs="*")
    p.add_argument("--nodes", type=int, default=32)
    p.add_argument("--apiserver", help="read GET /nodes from a live server")
    p.set_defaults(fn=_cmd_nodes)

    p = sub.add_parser(
        "drain",
        help=(
            "drain a node on a live apiserver: cordon + budget-checked"
            " gang-whole eviction with pre-placement (docs/robustness.md)"
        ),
    )
    p.add_argument("node", help="node name")
    p.add_argument(
        "--apiserver", required=True, help="apiserver URL (host:port)"
    )
    p.set_defaults(fn=_cmd_drain)

    p = sub.add_parser(
        "uncordon",
        help="return a drained/cordoned node to service on a live apiserver",
    )
    p.add_argument("node", help="node name")
    p.add_argument(
        "--apiserver", required=True, help="apiserver URL (host:port)"
    )
    p.set_defaults(fn=_cmd_uncordon)

    p = sub.add_parser(
        "trace",
        help=(
            "pretty-print the slowest trace spans — from a live apiserver"
            " (--apiserver URL) or by running manifests through a traced sim"
        ),
    )
    p.add_argument("manifests", nargs="*")
    p.add_argument("--nodes", type=int, default=32)
    p.add_argument("--apiserver", help="read /debug/traces from a live server")
    p.add_argument("--top", type=int, default=15, help="span rows to show")
    p.add_argument(
        "--chrome",
        metavar="PATH",
        help="also write the Chrome trace_event JSON (chrome://tracing)",
    )
    p.set_defaults(fn=_cmd_trace)

    p = sub.add_parser(
        "profile",
        help=(
            "wall-attribution report: where control-plane seconds went per"
            " (controller, shard, phase) — from a live apiserver"
            " (--apiserver URL) or a profiled sim converge"
        ),
    )
    p.add_argument("manifests", nargs="*")
    p.add_argument("--nodes", type=int, default=32)
    p.add_argument(
        "--apiserver", help="read /debug/profile from a live server"
    )
    p.add_argument("--top", type=int, default=15, help="phase rows to show")
    p.set_defaults(fn=_cmd_profile)

    p = sub.add_parser(
        "journey",
        help=(
            "one PodGang's admission timeline (created → scanned → encoded"
            " → solved → committed → scheduled) with the queue-wait/"
            "service/solver split — from a live apiserver or a sim"
        ),
    )
    p.add_argument("manifests", nargs="*")
    p.add_argument("--nodes", type=int, default=32)
    p.add_argument(
        "--apiserver",
        help="read /gangs/{ns}/{name}/journey from a live server",
    )
    p.add_argument("--namespace", default="default")
    p.add_argument(
        "--gang",
        help="PodGang name (sim mode defaults to every admitted gang)",
    )
    p.set_defaults(fn=_cmd_journey)

    p = sub.add_parser(
        "slo",
        help=(
            "SLO observatory report: per-objective attainment, error"
            " budget, burn rates, breach state (GET /debug/slo)"
        ),
    )
    p.add_argument(
        "--apiserver", help="read /debug/slo from a live server"
    )
    p.add_argument(
        "--window",
        type=float,
        default=300.0,
        help="series-appendix window in seconds (default 300)",
    )
    p.set_defaults(fn=_cmd_slo)

    p = sub.add_parser(
        "federation",
        help=(
            "multi-cluster federation status: per-region state and"
            " placements, spillover/re-route counters, global per-queue"
            " usage (GET /federation)"
        ),
    )
    p.add_argument(
        "--apiserver", help="read /federation from a live server"
    )
    p.add_argument(
        "-o",
        "--output",
        choices=("table", "json"),
        default="table",
        help="output format (default table)",
    )
    p.set_defaults(fn=_cmd_federation)

    p = sub.add_parser(
        "forecast",
        help=(
            "per-series horizon forecasts: diurnal+trend predictions with"
            " confidence bands and skill vs the persistence baseline"
            " (GET /debug/forecast)"
        ),
    )
    p.add_argument(
        "--apiserver", help="read /debug/forecast from a live server"
    )
    p.add_argument(
        "--series",
        action="append",
        help="series to forecast (repeatable; default: the watched set)",
    )
    p.add_argument(
        "--horizon",
        type=float,
        default=0.0,
        help="forecast horizon in seconds (default: the forecaster's)",
    )
    p.set_defaults(fn=_cmd_forecast)

    p = sub.add_parser(
        "ledger",
        help=(
            "causal decision→effect ledger: every remediation considered,"
            " as trigger→diagnosis→simulation→action→effect chains"
            " (GET /debug/ledger)"
        ),
    )
    p.add_argument(
        "--apiserver", help="read /debug/ledger from a live server"
    )
    p.set_defaults(fn=_cmd_ledger)

    p = sub.add_parser(
        "explain",
        help=(
            "why is this PodGang Pending, and what binds it — the"
            " constraint-elimination funnel (node health → capacity →"
            " topology → quota → disruption → solve) from a live"
            " apiserver or a sim"
        ),
    )
    p.add_argument("manifests", nargs="*")
    p.add_argument("--nodes", type=int, default=32)
    p.add_argument(
        "--apiserver",
        help="read /gangs/{ns}/{name}/explain from a live server",
    )
    p.add_argument("--namespace", default="default")
    p.add_argument(
        "--gang",
        help="PodGang name (sim mode defaults to every gang)",
    )
    p.set_defaults(fn=_cmd_explain)

    p = sub.add_parser(
        "capacity",
        help=(
            "per-topology-level free capacity + the fragmentation"
            " statistic (largest contiguous domain vs total free)"
        ),
    )
    p.add_argument("manifests", nargs="*")
    p.add_argument("--nodes", type=int, default=32)
    p.add_argument(
        "--apiserver", help="read /debug/capacity from a live server"
    )
    p.set_defaults(fn=_cmd_capacity)

    p = sub.add_parser(
        "whatif",
        help=(
            "hypothetical trial solve: would the gang fit if nodes were"
            " drained/removed/added or a queue's entitlement changed?"
            " Commits nothing"
        ),
    )
    p.add_argument("manifests", nargs="*")
    p.add_argument("--nodes", type=int, default=32)
    p.add_argument(
        "--apiserver", help="POST /debug/whatif to a live server"
    )
    p.add_argument("--namespace", default="default")
    p.add_argument("--gang", required=True, help="target PodGang name")
    p.add_argument(
        "--drain", action="append", metavar="NODE",
        help="hypothetically drain NODE (gang-whole relocation)",
    )
    p.add_argument(
        "--remove", action="append", metavar="NODE",
        help="hypothetically remove NODE (capacity only)",
    )
    p.add_argument(
        "--add-nodes", type=int, metavar="N",
        help="hypothetically add N nodes cloned from --like",
    )
    p.add_argument(
        "--like", metavar="NODE",
        help="template node for --add-nodes (capacity + topology)",
    )
    p.add_argument(
        "--set-queue", metavar="QUEUE",
        help="hypothetically rewrite QUEUE's entitlement",
    )
    p.add_argument(
        "--deserved", metavar="RES=V[,RES=V]",
        help="deserved shares for --set-queue",
    )
    p.add_argument(
        "--ceiling", metavar="RES=V[,RES=V]",
        help="ceiling for --set-queue",
    )
    p.set_defaults(fn=_cmd_whatif)

    p = sub.add_parser("config-check", help="validate an operator config file")
    p.add_argument("config")
    p.set_defaults(fn=_cmd_config_check)

    p = sub.add_parser("crds", help="print or write the CRD manifests")
    p.add_argument("--output-dir", metavar="DIR")
    p.set_defaults(fn=_cmd_crds)

    p = sub.add_parser(
        "api-docs", help="render the API reference from the typed model"
    )
    p.add_argument("--write", metavar="PATH", help="write to PATH instead of stdout")
    p.set_defaults(fn=_cmd_api_docs)

    p = sub.add_parser(
        "detect-topology",
        help="infer the ClusterTopology CR from node labels",
    )
    p.add_argument(
        "--file",
        metavar="NODES_YAML",
        help="node list (k8s NodeList, Node manifests, or [{name, labels}])",
    )
    p.add_argument(
        "--sim-nodes",
        type=int,
        default=16,
        help="detect from a synthetic sim cluster of N nodes (demo)",
    )
    p.add_argument("--name", default="default", help="CR name")
    p.set_defaults(fn=_cmd_detect_topology)

    p = sub.add_parser(
        "run", help="run the operator against a real (HTTP) apiserver"
    )
    p.add_argument("--config", help="operator configuration file")
    p.add_argument("--nodes", type=int, default=32)
    p.add_argument(
        "--apiserver", help="external apiserver URL (default: embedded)"
    )
    p.add_argument("--tls", action="store_true", help="TLS webhook serving")
    p.add_argument(
        "--authorizer", action="store_true", help="enable the authorizer webhook"
    )
    p.add_argument("--leader-lock", help="leader-election lock file path")
    p.add_argument(
        "--leader-election",
        action="store_true",
        help="lease-based leader election over the apiserver "
        "(coordination.k8s.io/v1 Lease; HA across hosts)",
    )
    p.add_argument(
        "--threaded",
        action="store_true",
        default=None,  # tri-state: unset defers to GROVE_TPU_CP_WORKERS
        # (docs/control-plane.md §5 — cluster mode maps the parallel-CP
        # opt-in onto threaded reconciles); the flag pins True
        help="run concurrent reconciles in real threads (concurrentSyncs)",
    )
    p.add_argument(
        "--durability-dir",
        help="durable control plane (docs/robustness.md): recover the"
        " embedded apiserver's store from this directory's snapshot+WAL"
        " at boot and log every commit to it (WAL + periodic snapshots,"
        " background group-commit thread)",
    )
    p.add_argument(
        "--auto-detect-topology",
        action="store_true",
        help="infer the ClusterTopology from node labels at startup",
    )
    p.set_defaults(fn=_cmd_run)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
