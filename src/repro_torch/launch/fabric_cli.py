#!/usr/bin/env python
"""fabric_cli: drive a FlowMesh FabricService from the command line.

The port's copy of the reference's ``scripts/fabric_cli.py``: the same
subcommands and flags on ``repro_torch.fabric`` and
``repro_torch.scenarios``, with ``SimExecutor`` as there.

Every subcommand speaks the same request/response API the examples and
tests use — in-process by default, or across real sockets with ``--url``
against a fabric started by ``serve``.

    PYTHONPATH=src python -m repro_torch.launch.fabric_cli templates
    PYTHONPATH=src python -m repro_torch.launch.fabric_cli validate my_flow.json
    PYTHONPATH=src python -m repro_torch.launch.fabric_cli submit my_flow.json
    PYTHONPATH=src python -m repro_torch.launch.fabric_cli submit --template rlhf \
        --param tenant=acme --param model=llama-3.2-1b
    PYTHONPATH=src python -m repro_torch.launch.fabric_cli demo

    # cross-process: serve a fabric (optionally journaled to a CAS dir),
    # submit to it, and tail a job's live event feed
    PYTHONPATH=src python -m repro_torch.launch.fabric_cli serve --port 8123 \
        --journal /tmp/fabric-cas
    PYTHONPATH=src python -m repro_torch.launch.fabric_cli --url http://127.0.0.1:8123 \
        submit --template distill --no-drain
    PYTHONPATH=src python -m repro_torch.launch.fabric_cli --url http://127.0.0.1:8123 \
        tail <job_id>

    # offline provenance: replay a journal straight from the CAS
    PYTHONPATH=src python -m repro_torch.launch.fabric_cli tail <job_id> \
        --journal /tmp/fabric-cas

    # retention: fold old segments into a snapshot, then reclaim the
    # unreferenced blobs (also available live: POST /admin/{compact,gc});
    # the fold applies the quota + retention config persisted in the CAS
    # operator document, so offline compaction agrees with the live service
    PYTHONPATH=src python -m repro_torch.launch.fabric_cli compact --journal /tmp/fabric-cas
    PYTHONPATH=src python -m repro_torch.launch.fabric_cli gc --journal /tmp/fabric-cas
    PYTHONPATH=src python -m repro_torch.launch.fabric_cli retention --journal /tmp/fabric-cas

    # scheduled retention: the serve loop compacts + sweeps on its own once
    # the un-folded tail crosses the thresholds (keeping a floor of
    # segments for tail consumers); flags override the operator document,
    # and the effective config is written back for offline agreement
    PYTHONPATH=src python -m repro_torch.launch.fabric_cli serve --journal /tmp/fabric-cas \
        --compact-every-segments 64 --keep-segments 4 --retention-jobs 5000

    # warm standby: a second process tails the same CAS read-only
    # (GET /jobs, /jobs/{id}, /jobs/{id}/events, /admin/replication); if
    # the primary dies, promote fences it off the journal head and flips
    # the follower read-write in place (DESIGN.md §10)
    PYTHONPATH=src python -m repro_torch.launch.fabric_cli follow --port 8124 \
        --journal /tmp/fabric-cas
    PYTHONPATH=src python -m repro_torch.launch.fabric_cli --url http://127.0.0.1:8124 \
        promote

    # observability (DESIGN.md §11): one workflow's replay-derived span
    # tree (add --chrome for an about://tracing trace_event file), and the
    # wall-clock Prometheus exposition
    PYTHONPATH=src python -m repro_torch.launch.fabric_cli --url http://127.0.0.1:8123 \
        trace <job_id>
    PYTHONPATH=src python -m repro_torch.launch.fabric_cli trace <job_id> \
        --journal /tmp/fabric-cas --chrome > job.trace.json
    PYTHONPATH=src python -m repro_torch.launch.fabric_cli --url http://127.0.0.1:8123 \
        metrics

    # admin auth: started with a token, mutating /admin/* and the quota
    # write require it (reads and /metrics stay open); clients send the
    # same flag (or FABRIC_ADMIN_TOKEN in the environment for both sides)
    PYTHONPATH=src python -m repro_torch.launch.fabric_cli serve --port 8123 \
        --journal /tmp/fabric-cas --admin-token s3cret
    PYTHONPATH=src python -m repro_torch.launch.fabric_cli --url http://127.0.0.1:8123 \
        --admin-token s3cret compact

    # digital-twin scenarios (DESIGN.md §15): replay a declarative traffic
    # scenario — deterministic virtual time in-process, or open-loop wall
    # clock against a live fabric with --url (fault targets map to PIDs);
    # `sweep` replays the identical schedule per EDF deadline-boost value
    PYTHONPATH=src python -m repro_torch.launch.fabric_cli scenario compile \
        scenarios/steady_mix.yaml
    PYTHONPATH=src python -m repro_torch.launch.fabric_cli scenario run \
        scenarios/steady_mix.yaml --trajectory BENCH_fabric.json
    PYTHONPATH=src python -m repro_torch.launch.fabric_cli --url http://127.0.0.1:8123 \
        scenario run scenarios/worker_preemption.yaml --pid worker-a=4242
    PYTHONPATH=src python -m repro_torch.launch.fabric_cli scenario sweep \
        scenarios/burst_deadline.yaml --boosts 0,0.05,0.5,2
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import sys
import threading

from repro_torch.core.cas import DiskCAS
from repro_torch.core.journal import EventJournal
from repro_torch.core.transport import LeaseTransport
from repro_torch.fabric import (TERMINAL_STATUSES as _TERMINAL, ClusterAPI,
                                FabricAPI, FabricHTTPServer, FabricService,
                                FollowerAPI, FollowerFabric, RemoteAPI,
                                RetentionPolicy, configured_admission,
                                configured_retention, load_operator_doc,
                                render_template, snapshot_fold,
                                validate_spec)


def _parse_params(pairs: list[str]) -> dict:
    out = {}
    for pair in pairs or []:
        if "=" not in pair:
            sys.exit(f"--param expects k=v, got {pair!r}")
        k, v = pair.split("=", 1)
        try:
            out[k] = json.loads(v)      # numbers, bools, lists...
        except json.JSONDecodeError:
            out[k] = v                  # plain string
    return out


def _print(payload) -> None:
    print(json.dumps(payload, indent=2, default=str))


#: CLI flag -> RetentionPolicy field (a negative count means "unbounded")
_RETENTION_FLAGS = (("retention_jobs", "max_terminal_jobs", True),
                    ("feed_window", "feed_window", True),
                    ("result_index_cap", "max_result_index", True),
                    ("compact_every_segments", "compact_every_segments", True),
                    ("compact_every_bytes", "compact_every_bytes", True),
                    ("keep_segments", "keep_segments", False))


def _retention_overrides(args) -> dict:
    """The retention fields the operator set on this command line."""
    out = {}
    for flag, field, noneable in _RETENTION_FLAGS:
        v = getattr(args, flag, None)
        if v is not None:
            out[field] = None if (noneable and v < 0) else v
    return out


def _resolve_retention(args, doc) -> tuple[RetentionPolicy, str]:
    """Documented precedence (DESIGN.md §9): live flag > CAS operator
    document > built-in default — flags patch individual fields on top of
    whichever base applies."""
    overrides = _retention_overrides(args)
    try:
        base = configured_retention(doc)
        source = "operator-doc" if doc is not None else "default"
        if overrides:
            base = dataclasses.replace(base, **overrides)
            source = "flag"
    except ValueError as e:     # policy validation -> usage error, not a
        sys.exit(f"invalid retention config: {e}")      # raw traceback
    return base, source


def cmd_templates(api, args) -> int:
    code, payload = api.handle("GET", "/workflows/templates")
    _print(payload)
    return 0 if code == 200 else 1


def cmd_validate(api, args) -> int:
    if args.spec:
        with open(args.spec) as f:
            doc = json.load(f)
    else:
        doc = render_template(args.template, **_parse_params(args.param))
    errors = validate_spec(doc)
    if errors:
        print("INVALID:")
        for e in errors:
            print(f"  - {e}")
        return 1
    n = len(doc.get("ops", []))
    print(f"OK: {n} operators, tenant={doc.get('tenant', 'default')!r}")
    return 0


def cmd_submit(api, args) -> int:
    if args.spec:
        with open(args.spec) as f:
            body = {"spec": json.load(f)}
    else:
        body = {"template": args.template,
                "params": _parse_params(args.param)}
    code, job = api.handle("POST", "/workflows", body)
    if code != 201:
        print(f"HTTP {code}", file=sys.stderr)
        _print(job)
        return 1
    if not args.no_drain:
        api.handle("POST", "/drain", {})
        _, job = api.handle("GET", f"/jobs/{job['job_id']}")
        _, lineage = api.handle("GET", f"/jobs/{job['job_id']}/lineage")
        _, usage = api.handle("GET", f"/tenants/{job['tenant']}/usage")
        _print({"job": job, "lineage": lineage["lineage"], "usage": usage})
    else:
        # drain is what flushes the journal; without it the buffered events
        # (at least the submission) must still reach the CAS before exit
        svc = getattr(api, "service", None)
        if svc is not None and svc.journal is not None:
            svc.journal.flush()
        _print(job)
    return 0


def cmd_demo(api, args) -> int:
    """Three tenants, overlapping distill specs, one live fabric."""
    for tenant in ("acme", "globex", "initech"):
        code, job = api.handle("POST", "/workflows", {
            "template": "distill", "params": {"tenant": tenant}})
        print(f"submitted {job['job_id']} for {tenant} (HTTP {code})")
    api.handle("POST", "/pump", {"max_steps": 25})
    code, extra = api.handle("POST", "/workflows", {
        "template": "batch-eval", "params": {"tenant": "acme"}})
    print(f"submitted {extra['job_id']} mid-flight (HTTP {code})")
    api.handle("POST", "/drain", {})
    for tenant in ("acme", "globex", "initech"):
        _, u = api.handle("GET", f"/tenants/{tenant}/usage")
        print(f"{tenant:8s} executed={u['ops']['executed']} "
              f"deduped={u['ops']['deduped']} spend=${u['spend']['usd']:.4f}")
    _, h = api.handle("GET", "/health")
    print(f"health: {h['status']}, executions={h['executions']}, "
          f"dedup_savings={h['dedup_savings']}")
    return 0


def cmd_serve(api, args) -> int:
    """Expose the fabric over real sockets (auto-pumped)."""
    server = FabricHTTPServer(api, host=args.host, port=args.port)
    # a clean SIGTERM (docker stop, CI teardown) must flush the journal
    def _sigterm(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _sigterm)
    print(f"fabric listening on {server.url}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.stop()
    return 0


def cmd_follow(api, args) -> int:
    """Serve a warm-standby follower: read-only HTTP over a tailed journal.

    The follower bootstraps from the chain's snapshot, then a tail thread
    parks on ``CAS.watch_ref`` and folds new segments as the primary
    flushes them. ``promote`` (or ``POST /admin/promote``) fences the old
    primary off the head ref and flips this same process read-write."""
    cas = DiskCAS(args.journal)
    retention = None
    if _retention_overrides(args):      # pin: flags > doc > default
        retention, _ = _resolve_retention(args, load_operator_doc(cas))
    follower = FollowerFabric(cas, seed=args.seed, retention=retention,
                              auto_promote=args.auto_promote,
                              lease_ttl_s=args.head_lease_ttl)
    if args.remote_workers:
        # the promoted primary serves remote lanes (fresh transport per
        # takeover: lease tables are process-local, never replayed)
        follower.transport_factory = (
            lambda: LeaseTransport(lease_ttl_s=args.lease_ttl))
    stats = follower.catch_up()
    fapi = FollowerAPI(follower, admin_token=args.admin_token)
    server = FabricHTTPServer(fapi, host=args.host, port=args.port,
                              auto_pump=False)
    # a promoted follower is a live fabric: start driving the engine
    fapi.on_promoted = lambda svc: server.enable_pump()

    def _sigterm(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _sigterm)
    print(f"follower listening on {server.url}", flush=True)
    print(f"tailing {args.journal}: {len(follower.state.jobs)} jobs, "
          f"head={stats['head']}", flush=True)
    tail = threading.Thread(target=follower.tail_loop,
                            args=(server._stop, server.lock), daemon=True)
    tail.start()
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.stop()
    return 0


def cmd_promote(api, args) -> int:
    """Promote a served follower to primary (fences the old primary)."""
    code, payload = api.handle("POST", "/admin/promote", {})
    _print(payload)
    return 0 if code == 200 else 1


def cmd_tail(api, args) -> int:
    """Follow a job's event feed: live over HTTP, or offline from a journal."""
    if args.journal and not args.url:
        journal = EventJournal(DiskCAS(args.journal))
        base = journal.base_state()
        if base is not None:
            print(f"# snapshot base: {base['events']} events folded over "
                  f"{len(base['jobs'])} jobs", file=sys.stderr)
        n = 0
        for e in journal.replay():
            d = e.to_dict()
            if args.job_id in (None, d.get("dag_id")):
                print(json.dumps(d, default=str))
                n += 1
        print(f"# {n} events replayed from {journal.head}", file=sys.stderr)
        return 0
    if not args.url:
        sys.exit("tail needs --url (live feed) or --journal (offline replay)")
    if not args.job_id:
        sys.exit("tail over --url requires a job id")
    cursor = args.since
    while True:
        code, feed = api.handle(
            "GET", f"/jobs/{args.job_id}/events?since={cursor}&wait_s=5")
        if code != 200:
            print(f"HTTP {code}", file=sys.stderr)
            _print(feed)
            return 1
        for e in feed["events"]:
            print(json.dumps(e, default=str))
        cursor = feed["cursor"]
        if feed["status"] in _TERMINAL and not feed["events"]:
            print(f"# job {args.job_id}: {feed['status']}", file=sys.stderr)
            return 0


def cmd_trace(api, args) -> int:
    """One workflow's span tree (or Chrome trace_event export): live over
    HTTP, or offline by restoring the journal — both derive the spans from
    the same event stream, so the documents are identical (DESIGN.md §11)."""
    path = f"/jobs/{args.job_id}/trace"
    if args.chrome:
        path += "?format=chrome"
    if not args.url:
        cas = DiskCAS(args.journal)
        journal = EventJournal(cas)
        if journal.head is None:
            print("empty journal (no head ref)", file=sys.stderr)
            return 1
        doc = load_operator_doc(cas)
        retention, _ = _resolve_retention(args, doc)
        svc = FabricService(seed=args.seed, cas=cas, journal=journal,
                            retention=retention)
        configured_admission(doc, svc.admission)
        svc.restore_from_journal()
        api = FabricAPI(svc)
    code, payload = api.handle("GET", path)
    _print(payload)
    return 0 if code == 200 else 1


def cmd_metrics(api, args) -> int:
    """Dump the fabric's Prometheus exposition (``GET /metrics``)."""
    code, payload = api.handle("GET", "/metrics")
    if code != 200:
        print(f"HTTP {code}", file=sys.stderr)
        _print(payload)
        return 1
    print(payload, end="" if str(payload).endswith("\n") else "\n")
    return 0


def cmd_compact(api, args) -> int:
    """Fold old journal segments into a snapshot node (retention)."""
    if args.url:
        code, stats = api.handle("POST", "/admin/compact",
                                 {"keep_segments": args.keep})
        _print(stats)
        return 0 if code == 200 else 1
    cas = DiskCAS(args.journal)
    journal = EventJournal(cas)
    if journal.head is None:
        print("empty journal (no head ref)", file=sys.stderr)
        return 1
    # fold with the persisted operator document: fair-share weights and the
    # retention trim only replay correctly if compaction sees the same
    # config the live fabric charged/evicted by (DESIGN.md §9); flags
    # override, defaults apply when the store carries no document
    doc = load_operator_doc(cas)
    retention, _ = _resolve_retention(args, doc)
    keep = args.keep
    if keep is None:    # as documented: the doc's keep_segments, else 0
        keep = retention.keep_segments if doc is not None else 0
    stats = journal.compact(
        snapshot_fold(configured_admission(doc), retention=retention),
        keep_segments=keep)
    _print(stats)
    return 0


def cmd_gc(api, args) -> int:
    """Mark-and-sweep the CAS from its named refs (journal heads). The
    response payload reports the reclamation (blobs + bytes)."""
    if args.url:
        code, stats = api.handle("POST", "/admin/gc", {})
        _print(stats)
        return 0 if code == 200 else 1
    _print(DiskCAS(args.journal).gc())
    return 0


def cmd_retention(api, args) -> int:
    """Show the effective retention config: live from /admin/retention, or
    offline from the CAS operator document + chain footprint."""
    if args.url:
        code, status = api.handle("GET", "/admin/retention")
        _print(status)
        return 0 if code == 200 else 1
    cas = DiskCAS(args.journal)
    doc = load_operator_doc(cas)
    retention, source = _resolve_retention(args, doc)
    _print({"policy": retention.to_dict(), "source": source,
            "journal": EventJournal(cas).chain_stats()})
    return 0


def cmd_scenario(api, args) -> int:
    """Digital-twin scenarios (DESIGN.md §15): compile, run, or sweep."""
    from repro_torch.scenarios import (FaultActions, ScenarioError,
                                       append_trajectory, load_scenario,
                                       run_open_loop, run_virtual,
                                       sweep_edf_boost)
    try:
        sc = load_scenario(args.file)
    except ScenarioError as e:
        print("INVALID SCENARIO:", file=sys.stderr)
        for err in e.errors:
            print(f"  - {err}", file=sys.stderr)
        return 1

    if args.action == "compile":
        arrivals, faults = sc.schedule(args.scenario_seed)
        with_deadline = sum(1 for a in arrivals if a.deadline_s is not None)
        print(f"{sc.name}: {len(arrivals)} arrivals over {sc.duration_s}s "
              f"({with_deadline} with deadlines), {len(faults)} faults")
        for a in arrivals[:args.head]:
            dl = f" deadline={a.deadline_s}s" if a.deadline_s else ""
            print(f"  t={a.t:10.3f}  {a.tenant:<12} {a.kind:<12} "
                  f"variant={a.variant}{dl}")
        if len(arrivals) > args.head:
            print(f"  ... {len(arrivals) - args.head} more")
        for f in faults:
            print(f"  t={f.t:10.3f}  FAULT {f.kind} -> {f.target}")
        return 0

    if args.action == "sweep":
        try:
            boosts = [float(x) for x in args.boosts.split(",") if x.strip()]
        except ValueError:
            sys.exit(f"--boosts expects comma-separated numbers, "
                     f"got {args.boosts!r}")
        rows = sweep_edf_boost(sc, boosts, seed=args.scenario_seed)
        print(f"{'boost':>8} {'hit_rate':>9} {'p50_s':>9} {'p95_s':>9} "
              f"{'p99_s':>9} {'$/job':>10}")
        for r in rows:
            print(f"{r['deadline_boost']:>8} {r['slo_hit_rate']:>9} "
                  f"{r['p50_s']:>9} {r['p95_s']:>9} {r['p99_s']:>9} "
                  f"{r['per_job_usd']:>10}")
        if args.out:
            with open(args.out, "w") as f:
                json.dump(rows, f, indent=2)
                f.write("\n")
        return 0

    # run
    try:
        actions = FaultActions.from_pids(args.pid)
    except ValueError as e:
        sys.exit(f"--pid: {e}")
    if args.url:
        report = run_open_loop(sc, api, seed=args.scenario_seed,
                               time_scale=args.time_scale, actions=actions,
                               settle_timeout_s=args.settle_timeout)
    else:
        report = run_virtual(sc, seed=args.scenario_seed,
                             deadline_boost=args.boost, actions=actions)
    _print(report)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
    if args.trajectory:
        warning = append_trajectory(args.trajectory, report)
        print(f"appended to {args.trajectory}", file=sys.stderr)
        if warning:
            print(warning, file=sys.stderr)
    jobs = report["jobs"]
    if jobs["submitted"] == 0 or jobs["completed"] == 0:
        print(f"scenario {sc.name}: no completed jobs "
              f"({jobs})", file=sys.stderr)
        return 1
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="fabric_cli", description=__doc__)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--url", help="drive a remote fabric (from `serve`) "
                                  "instead of an in-process one")
    ap.add_argument("--admin-token", metavar="TOKEN",
                    default=os.environ.get("FABRIC_ADMIN_TOKEN"),
                    help="bearer token for mutating /admin/* and quota "
                         "routes: `serve`/`follow` require it from "
                         "clients, client commands send it (default: "
                         "$FABRIC_ADMIN_TOKEN; unset = open)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("templates", help="list workflow templates")

    for name, help_ in (("validate", "validate a spec without running it"),
                        ("submit", "submit a spec / template and run it")):
        p = sub.add_parser(name, help=help_)
        p.add_argument("spec", nargs="?", help="path to a JSON spec document")
        p.add_argument("--template", help="named template instead of a file")
        p.add_argument("--param", action="append", default=[],
                       help="template parameter k=v (repeatable)")
        if name == "submit":
            p.add_argument("--no-drain", action="store_true",
                           help="submit only; do not run to idle")
            p.add_argument("--journal", metavar="DIR",
                           help="journal the run to this CAS directory "
                                "(restores prior history first)")
            submit_parser = p

    sub.add_parser("demo", help="multi-tenant dedup demo")

    p = sub.add_parser("serve", help="serve the fabric over HTTP")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="0 picks a free port (printed at startup)")
    p.add_argument("--journal", metavar="DIR",
                   help="CAS directory for the event journal; restores "
                        "prior history when one exists")
    p.add_argument("--commit-latency", type=float, metavar="SECONDS",
                   dest="commit_latency",
                   help="adaptive group commit: cut a journal segment when "
                        "the oldest buffered event is this many wall-clock "
                        "seconds old, instead of every fixed batch of "
                        "events (bounds post-crash loss to this window; "
                        "see DESIGN.md §12)")
    p.add_argument("--admin-token", metavar="TOKEN", dest="admin_token",
                   default=argparse.SUPPRESS,
                   help="require this bearer token on mutating /admin/* "
                        "and quota routes (also honored before the "
                        "subcommand; unset = open)")
    p.add_argument("--remote-workers", action="store_true",
                   help="lease batches to out-of-process worker processes "
                        "(python -m repro_torch.launch.worker_main) over "
                        "POST /worker/* "
                        "instead of executing in-process; no bootstrap "
                        "lanes — workers join by registering")
    p.add_argument("--lease-ttl", type=float, default=10.0,
                   metavar="SECONDS",
                   help="wall-clock lease TTL for remote workers; a lease "
                        "not renewed within it requeues its batch "
                        "(heartbeat interval is TTL/4)")
    p.add_argument("--head-lease-ttl", type=float, default=None,
                   metavar="SECONDS", dest="head_lease_ttl",
                   help="heartbeat a liveness lease on the journal head "
                        "ref with this TTL: followers running "
                        "`follow --auto-promote` take over within one TTL "
                        "of this process going silent (unset = no lease; "
                        "manual promotion only)")
    serve_parser = p

    p = sub.add_parser("follow",
                       help="serve a warm-standby follower of a journaled "
                            "fabric (read-only until promoted)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="0 picks a free port (printed at startup)")
    p.add_argument("--journal", metavar="DIR", required=True,
                   help="CAS directory holding the primary's journal")
    p.add_argument("--admin-token", metavar="TOKEN", dest="admin_token",
                   default=argparse.SUPPRESS,
                   help="require this bearer token on mutating /admin/* "
                        "and quota routes once promoted (and on promote "
                        "itself; unset = open)")
    p.add_argument("--auto-promote", action="store_true",
                   help="self-heal: when the primary's head-ref liveness "
                        "lease (serve --head-lease-ttl) expires, promote "
                        "this follower automatically — no operator action; "
                        "N followers racing is safe (epoch CAS, losers "
                        "resume tailing)")
    p.add_argument("--head-lease-ttl", type=float, default=None,
                   metavar="SECONDS", dest="head_lease_ttl",
                   help="lease TTL this follower heartbeats with AFTER "
                        "winning an election (defaults to no lease: the "
                        "new primary would then need manual failover)")
    p.add_argument("--remote-workers", action="store_true",
                   help="after promotion, lease batches to out-of-process "
                        "workers (same as serve --remote-workers)")
    p.add_argument("--lease-ttl", type=float, default=10.0,
                   metavar="SECONDS",
                   help="worker lease TTL used after promotion with "
                        "--remote-workers")
    follow_parser = p

    sub.add_parser("promote",
                   help="promote a served follower (--url) to primary; "
                        "fences the old primary's journal appends")

    p = sub.add_parser("tail", help="follow a job's event feed")
    p.add_argument("job_id", nargs="?")
    p.add_argument("--since", type=int, default=-1,
                   help="resume cursor (default: from the beginning)")
    p.add_argument("--journal", metavar="DIR",
                   help="offline: replay events from this CAS directory")

    p = sub.add_parser("trace",
                       help="one workflow's replay-derived span tree "
                            "(--chrome: trace_event JSON for "
                            "about://tracing)")
    p.add_argument("job_id")
    p.add_argument("--chrome", action="store_true",
                   help="emit Chrome trace_event JSON instead of the tree")
    p.add_argument("--journal", metavar="DIR",
                   help="offline: restore this CAS directory's journal "
                        "and derive the trace from it")

    sub.add_parser("metrics",
                   help="dump the Prometheus text exposition "
                        "(GET /metrics; needs --url)")

    p = sub.add_parser("compact",
                       help="fold old journal segments into a snapshot")
    p.add_argument("--journal", metavar="DIR",
                   help="CAS directory holding the journal (offline mode)")
    p.add_argument("--keep", type=int, default=None,
                   help="newest segments to keep un-compacted (default: the "
                        "operator document's keep_segments, else 0)")
    compact_parser = p

    p = sub.add_parser("gc", help="mark-and-sweep unreferenced CAS blobs "
                                  "(reports reclaimed blobs/bytes)")
    p.add_argument("--journal", metavar="DIR",
                   help="CAS directory to sweep (offline mode)")

    p = sub.add_parser("retention",
                       help="show the effective retention policy + footprint")
    p.add_argument("--journal", metavar="DIR",
                   help="CAS directory to inspect (offline mode)")
    retention_parser = p

    p = sub.add_parser(
        "scenario",
        help="digital-twin traffic scenarios: run (virtual in-process, or "
             "open-loop against --url), compile (print the deterministic "
             "schedule), sweep (EDF deadline-boost calibration)")
    p.add_argument("action", choices=("run", "compile", "sweep"))
    p.add_argument("file", help="path to a scenario YAML/JSON document")
    p.add_argument("--scenario-seed", type=int, default=None, metavar="N",
                   dest="scenario_seed",
                   help="override the document's seed (same seed = "
                        "identical arrival schedule)")
    p.add_argument("--time-scale", type=float, default=None,
                   metavar="X", dest="time_scale",
                   help="live runs: wall seconds per schedule second "
                        "(default: the document's time_scale)")
    p.add_argument("--settle-timeout", type=float, default=None,
                   metavar="SECONDS", dest="settle_timeout",
                   help="live runs: budget for the queue to drain after "
                        "the last arrival (default: the document's "
                        "settle_s)")
    p.add_argument("--pid", action="append", default=[], metavar="NAME=PID",
                   help="map a scenario fault target to a live process: "
                        "firing sends SIGKILL (repeatable; unmapped "
                        "targets report fired=false)")
    p.add_argument("--boost", type=float, default=None, metavar="B",
                   help="virtual runs: override the admission "
                        "deadline_boost for this run")
    p.add_argument("--boosts", default="0,0.01,0.05,0.2,0.5,2,5",
                   help="sweep: comma-separated deadline_boost values")
    p.add_argument("--head", type=int, default=12, metavar="N",
                   help="compile: arrivals to print before eliding")
    p.add_argument("--trajectory", nargs="?", const="BENCH_fabric.json",
                   default=None, metavar="FILE",
                   help="append the report to this trajectory JSON list "
                        "(default file: BENCH_fabric.json; warns non-"
                        "gating on SLO regression vs the same machine+"
                        "scenario+mode)")
    p.add_argument("--out", metavar="FILE",
                   help="also write the full report/sweep JSON here")

    # retention flags: override the persisted operator document field-wise
    # (live flag > CAS document > default); negative count = unbounded
    for p in (serve_parser, submit_parser, compact_parser, retention_parser,
              follow_parser):
        g = p.add_argument_group("retention")
        g.add_argument("--retention-jobs", type=int, metavar="N",
                       help="keep at most N terminal job records (<0: all)")
        g.add_argument("--feed-window", type=int, metavar="K",
                       help="window per-job feeds to K events with an "
                            "explicit truncation marker (<0: unbounded)")
        g.add_argument("--result-index-cap", type=int, metavar="N",
                       help="keep at most N dedup result-index entries "
                            "(<0: unbounded)")
        g.add_argument("--compact-every-segments", type=int, metavar="N",
                       help="auto-compact once N un-folded segments "
                            "accumulate (<0: disable)")
        g.add_argument("--compact-every-bytes", type=int, metavar="M",
                       help="auto-compact once the un-folded tail exceeds "
                            "M bytes (<0: disable)")
        g.add_argument("--keep-segments", type=int, metavar="N",
                       help="tail floor kept un-compacted for consumers")

    args = ap.parse_args(argv)
    if args.cmd in ("validate", "submit") and not (
            args.spec or args.template):
        ap.error(f"{args.cmd} requires a spec file or --template")
    if args.cmd in ("serve", "follow") and args.url:
        ap.error(f"{args.cmd} runs an in-process fabric; it cannot proxy "
                 "--url")
    if args.cmd == "promote" and not args.url:
        ap.error("promote drives a served follower: pass --url")
    if args.cmd in ("compact", "gc", "retention", "trace") and not (
            args.journal or args.url):
        ap.error(f"{args.cmd} needs --journal (offline) or --url (live)")
    if args.cmd == "metrics" and not args.url:
        ap.error("metrics reads a served fabric: pass --url")

    transport = None
    if getattr(args, "remote_workers", False):
        transport = LeaseTransport(lease_ttl_s=args.lease_ttl)
    if args.url:
        # a comma-separated endpoint list drives the whole cluster: reads
        # fan out, writes chase the current primary across failovers
        api = (ClusterAPI(args.url, token=args.admin_token)
               if "," in args.url
               else RemoteAPI(args.url, token=args.admin_token))
    elif args.cmd in ("serve", "submit") and getattr(args, "journal", None):
        cas = DiskCAS(args.journal)     # artifacts + journal share one store
        journal = EventJournal(
            cas, commit_latency_s=getattr(args, "commit_latency", None),
            lease_ttl_s=getattr(args, "head_lease_ttl", None))
        doc = load_operator_doc(cas)
        retention, source = _resolve_retention(args, doc)
        svc = FabricService(seed=args.seed, cas=cas, journal=journal,
                            retention=retention, transport=transport)
        svc.retention_source = source
        # apply the persisted quota config BEFORE restoring: the replay
        # fold charges fair-share vtime under these weights, and the
        # write-back below must not clobber the document with defaults
        configured_admission(doc, svc.admission)
        if journal.head is not None:
            stats = svc.restore_from_journal()
            print(f"restored {stats['jobs']} jobs from "
                  f"{stats['events']} journaled events "
                  f"({stats['interrupted']} interrupted, "
                  f"{stats['from_snapshot']} from snapshot)", flush=True)
        # write the effective config back so offline compact/restore agree
        svc._persist_operator_config()
        if args.cmd == "serve":
            # a long-lived writer claims the head ref (epoch bump): a prior
            # owner — say this same service pre-crash, restarted elsewhere
            # by a supervisor — is fenced from its next append on
            journal.claim()
        api = FabricAPI(svc, admin_token=args.admin_token)
    elif args.cmd in ("compact", "gc", "retention", "follow", "trace",
                      "scenario"):
        api = None          # CAS-direct, or (scenario) builds its own fabric
    else:
        # no journal: nothing durable to compact, but in-memory retention
        # (job cap, feed window, index cap) still honors the flags
        retention, source = _resolve_retention(args, None)
        svc = FabricService(seed=args.seed, retention=retention,
                            transport=transport)
        svc.retention_source = source
        api = FabricAPI(svc, admin_token=args.admin_token)
    return {"templates": cmd_templates, "validate": cmd_validate,
            "submit": cmd_submit, "demo": cmd_demo, "serve": cmd_serve,
            "follow": cmd_follow, "promote": cmd_promote,
            "tail": cmd_tail, "trace": cmd_trace, "metrics": cmd_metrics,
            "compact": cmd_compact, "gc": cmd_gc,
            "retention": cmd_retention,
            "scenario": cmd_scenario}[args.cmd](api, args)


if __name__ == "__main__":
    sys.exit(main())
