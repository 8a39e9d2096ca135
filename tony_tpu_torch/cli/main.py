"""tony: the command-line submission surface.

Rebuild of tony-cli's ClusterSubmitter/status surface (SURVEY.md section 2
"tony-cli"): ``tony submit`` stages and runs a job to completion;
``status`` / ``logs`` / ``stop`` / ``history`` operate on existing apps.
Run as ``python -m tony_tpu_torch.cli``.

The port's copy of ``tony_tpu/cli/main.py``: every subcommand but two,
over the port's client, AM, decode hosts and obs modules. ``history``
lists the same apps root (``~/.tony-tpu/apps``), so it lists either
package's apps. The two left out serve JAX alone: ``tony compiles`` reads
the XLA compile ledger (``obs/compiles.py``), which has no eager
counterpart, and ``tony lint`` runs graft-lint, which checks jit
reachability (``analysis/``).

    tony submit --conf job.toml --src-dir ./my_model -D job.worker.instances=4
    tony status <app-id>
    tony logs <app-id> [--task worker:0]
    tony stop <app-id>
    tony history [--dir DIR]
    tony serve --conf serve.toml [--demo N]
    tony notebook --conf job.toml
    tony chaos --conf job.toml --faults '[...]' [--expect SUCCEEDED]
    tony trace | health | elastic | top [--once] <app-id>
    tony profile [report] <app-id> [--steps N]
    tony perf diff <old> <new>
    tony rm-status --rm-root DIR
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

import grpc

from tony_tpu_torch.cli.client import TonyClient, default_apps_root, resolve_app_dir
from tony_tpu_torch.config.config import TonyConfig
from tony_tpu_torch.rpc import ApplicationRpcClient
from tony_tpu_torch.rpc.auth import read_token


def _read_am_addr(app_dir: str) -> str | None:
    path = os.path.join(app_dir, "am.addr")
    if os.path.exists(path):
        with open(path) as f:
            return f.read().strip()
    return None


def cmd_submit(args: argparse.Namespace) -> int:
    config = TonyConfig.load(args.conf, overrides=args.define, read_env=True)
    client = TonyClient(config, src_dir=args.src_dir or "")
    if args.detach:
        client.stage()
        client.launch_am()
        client.am_address()
        print(client.app_id)
        return 0
    return client.run(quiet=args.quiet)


def _status_dict(app_dir: str) -> dict:
    addr = _read_am_addr(app_dir)
    if addr:
        try:
            with ApplicationRpcClient(addr, timeout_s=3.0, token=read_token(app_dir)) as c:
                s = c.get_application_status()
                return {
                    "state": s.state,
                    "exit_code": s.exit_code,
                    "diagnostics": s.diagnostics,
                    "tensorboard_url": s.tensorboard_url,
                    "tasks": [
                        {
                            "task": f"{t.job_name}:{t.index}",
                            "state": t.state,
                            "exit_code": t.exit_code,
                            "attempt": t.attempt,
                            "log": t.log_path,
                        }
                        for t in s.tasks
                    ],
                }
        except grpc.RpcError:
            pass
    path = os.path.join(app_dir, "status.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {"state": "UNKNOWN", "exit_code": -1, "tasks": []}


def cmd_status(args: argparse.Namespace) -> int:
    app_dir = resolve_app_dir(args.app)
    print(json.dumps(_status_dict(app_dir), indent=2, sort_keys=True))
    return 0


def cmd_logs(args: argparse.Namespace) -> int:
    app_dir = resolve_app_dir(args.app)
    logs_dir = os.path.join(app_dir, "logs")
    if args.am:
        entries = [("am.log", os.path.join(app_dir, "am.log"))]
    else:
        names = sorted(os.listdir(logs_dir)) if os.path.isdir(logs_dir) else []
        if args.task:
            prefix = args.task.replace(":", "_") + "_"
            names = [n for n in names if n.startswith(prefix)]
        entries = [(n, os.path.join(logs_dir, n)) for n in names]
    if not entries:
        print("no logs found", file=sys.stderr)
        return 1
    for name, path in entries:
        print(f"===== {name} =====")
        try:
            with open(path, errors="replace") as f:
                sys.stdout.write(f.read())
        except OSError as e:
            print(f"<unreadable: {e}>")
    return 0


def cmd_stop(args: argparse.Namespace) -> int:
    app_dir = resolve_app_dir(args.app)
    addr = _read_am_addr(app_dir)
    if not addr:
        print("AM address unknown; application may not be running", file=sys.stderr)
        return 1
    try:
        with ApplicationRpcClient(addr, timeout_s=5.0, token=read_token(app_dir)) as c:
            c.stop_application(args.reason)
        print("stop requested")
        return 0
    except grpc.RpcError:
        print("AM unreachable (already finished?)", file=sys.stderr)
        return 1


def cmd_notebook(args: argparse.Namespace) -> int:
    from tony_tpu_torch.cli.notebook import launch_notebook, notebook_config

    base = TonyConfig.load(args.conf, overrides=args.define, read_env=True)
    config = notebook_config(
        base, memory_mb=args.memory_mb, cpus=args.cpus, tpu_chips=args.tpu_chips
    )
    try:
        client, proxy, url = launch_notebook(config, listen_port=args.listen)
    except (RuntimeError, TimeoutError) as e:
        print(f"notebook failed to start: {e}", file=sys.stderr)
        return 1
    print(f"[{client.app_id}] notebook at http://127.0.0.1:{proxy.port}/ "
          f"(proxied to {url})")
    print(f"stop with: tony stop {client.app_id}")
    try:
        return client.monitor(quiet=args.quiet)
    finally:
        proxy.stop()


def cmd_history(args: argparse.Namespace) -> int:
    root = args.dir or default_apps_root()
    rows = []
    if os.path.isdir(root):
        for app_id in sorted(os.listdir(root)):
            status_path = os.path.join(root, app_id, "status.json")
            state = "RUNNING?"
            code = ""
            if os.path.exists(status_path):
                with open(status_path) as f:
                    s = json.load(f)
                state, code = s["state"], s["exit_code"]
            rows.append((app_id, state, str(code)))
    if not rows:
        print("no applications found")
        return 0
    width = max(len(r[0]) for r in rows)
    for app_id, state, code in rows:
        print(f"{app_id:<{width}}  {state:<10} {code}")
    return 0


def cmd_serve(args: argparse.Namespace) -> int:
    """`tony serve`: gang-serving as a first-class job type (docs/SERVE.md
    "Gang serving"). Submits an AM-supervised gang of decode hosts
    (serve/gang.py), runs the routing frontend in THIS process, and either
    drives a demo batch (--demo N) or serves until interrupted. The job is
    stopped on exit; a deliberate stop exits 0. The hosts' default command
    builds their engines on the card; ``job.decode.command`` with
    ``--device cpu`` serves on the CPU."""
    from tony_tpu_torch.config.keys import Keys, job_key
    from tony_tpu_torch.obs import trace
    from tony_tpu_torch.serve.frontend import GangFrontend
    from tony_tpu_torch.serve.gang import GangSettings

    config = TonyConfig.load(args.conf, overrides=args.define, read_env=True)
    config.set(Keys.APPLICATION_FRAMEWORK, "serve")
    if args.hosts:
        config.set(Keys.SERVE_GANG_HOSTS, args.hosts)
    settings = GangSettings.from_config(config)
    gang_type = settings.job_type
    config.set(job_key(gang_type, "instances"), settings.hosts)
    if not config.get_str(job_key(gang_type, "command")):
        config.set(
            job_key(gang_type, "command"),
            f"{sys.executable} -m tony_tpu_torch.serve.gang",
        )
    if settings.prefill_hosts > 0:
        # disaggregated gang: a second task type carries the prefill pool
        # (same worker binary; pool membership comes from the job name)
        ptype = settings.prefill_job_type
        config.set(job_key(ptype, "instances"), settings.prefill_hosts)
        if not config.get_str(job_key(ptype, "command")):
            config.set(
                job_key(ptype, "command"),
                f"{sys.executable} -m tony_tpu_torch.serve.gang",
            )
    client = TonyClient(config, src_dir=args.src_dir or "")
    client.stage()
    client.launch_am()
    fe = None
    deliberate_stop = False
    try:
        am_addr = client.am_address()
        pools = f"gang of {settings.hosts} x {gang_type}"
        if settings.prefill_hosts > 0:
            pools += f" + {settings.prefill_hosts} x {settings.prefill_job_type}"
        print(f"[{client.app_id}] {pools} (model={settings.model})")
        trace.install_from_config(
            config, client.app_dir, client.app_id, proc="frontend"
        )
        from tony_tpu_torch.cluster.backend import Resource
        from tony_tpu_torch.cluster.lease import GangAsk, LeaseStore

        rm_root = config.get_str(Keys.CLUSTER_RM_ROOT, "")
        gang_spec = config.task_spec(gang_type)
        # autoscale asks must mirror the real containers, PER POOL — a
        # heterogeneous gang growing on a prefill backlog must lease a
        # prefill-sized container, not a decode one
        grow_asks = {
            "decode": GangAsk(
                Resource(gang_spec.memory_mb, gang_spec.cpus, gang_spec.tpu_chips),
                node_label=gang_spec.node_label,
            ),
        }
        if settings.prefill_hosts > 0:
            pspec = config.task_spec(settings.prefill_job_type)
            grow_asks["prefill"] = GangAsk(
                Resource(pspec.memory_mb, pspec.cpus, pspec.tpu_chips),
                node_label=pspec.node_label,
            )
        fe = GangFrontend(
            am_addr, settings, app_dir=client.app_dir,
            token=read_token(client.app_dir), app_id=client.app_id,
            lease_store=LeaseStore(rm_root) if rm_root else None,
            grow_asks=grow_asks,
        )
        ready = fe.wait_ready()
        print(f"[{client.app_id}] {ready} decode host(s) serving")
        if args.demo:
            import random

            rng = random.Random(settings.seed)
            prompts = [
                [rng.randrange(1, 128) for _ in range(rng.randrange(3, 12))]
                for _ in range(args.demo)
            ]
            done = fe.run(prompts, max_new_tokens=args.max_new_tokens)
            for rid in sorted(done, key=lambda r: int(r[1:])):
                c = done[rid]
                print(f"  {rid}: {len(c.tokens)} tokens ({c.finish_reason}, "
                      f"ttft {c.ttft_s:.3f}s, hosts {','.join(c.hosts)})")
            deliberate_stop = True
        else:
            print("serving; Ctrl-C to stop")
            try:
                while True:
                    import time as _time

                    _time.sleep(5.0)
            except KeyboardInterrupt:
                deliberate_stop = True
    finally:
        if fe is not None:
            fe.close()
        try:
            with ApplicationRpcClient(
                client.am_address(timeout_s=5.0),
                timeout_s=5.0, token=read_token(client.app_dir),
            ) as c:
                c.stop_application("tony serve exiting")
        except (grpc.RpcError, RuntimeError, TimeoutError):
            pass
    rc = client.monitor(quiet=True)
    return 0 if deliberate_stop else rc


def cmd_chaos(args: argparse.Namespace) -> int:
    """Run one real job under a seeded fault schedule and print the
    recovery-invariant report (docs/CHAOS.md). Exit 0 iff the report is
    clean AND the final state matches --expect (when given) — the JOB is
    allowed to fail; that is often the point of the schedule."""
    from tony_tpu_torch.chaos import parse_faults
    from tony_tpu_torch.chaos.runner import run_chaos_job
    from tony_tpu_torch.config.keys import Keys

    config = TonyConfig.load(args.conf, overrides=args.define, read_env=True)
    faults = args.faults
    if faults.startswith("@"):
        with open(faults[1:]) as f:
            faults = f.read()
    if faults:
        config.set(Keys.CHAOS_FAULTS, faults)
    try:  # malformed/empty schedule: fail before submitting anything
        if not parse_faults(config.get(Keys.CHAOS_FAULTS)):
            raise ValueError("no faults scheduled (chaos.faults is empty)")
    except ValueError as e:
        print(f"bad fault schedule: {e}", file=sys.stderr)
        return 2
    result = run_chaos_job(config, src_dir=args.src_dir or "", quiet=args.quiet)
    print(json.dumps(result.to_dict(), indent=2, sort_keys=True))
    ok = result.report.ok
    if args.expect and result.state != args.expect:
        print(
            f"expected final state {args.expect} but job ended {result.state or 'UNKNOWN'}",
            file=sys.stderr,
        )
        ok = False
    return 0 if ok else 1


def cmd_trace(args: argparse.Namespace) -> int:
    """Merge an application's per-process trace journals into ONE
    Chrome-trace-event JSON (open in Perfetto / chrome://tracing), plus a
    goodput roll-up and cross-host straggler flags (docs/OBS.md)."""
    from tony_tpu_torch.obs.trace_tool import load_journals, merge_chrome, report

    app_dir = resolve_app_dir(args.app)
    # journals can be large (rotating windows per process) — parse once,
    # share across merge and report
    procs = load_journals(os.path.join(app_dir, "trace"))
    merged = merge_chrome(app_dir, procs)
    # count every renderable event (complete X, begin-only B from killed
    # processes, instants) — a job whose every process died early still
    # has exactly the flight-recorder data worth merging
    n_events = sum(
        1 for e in merged["traceEvents"] if e.get("ph") in ("X", "B", "i", "C")
    )
    if n_events == 0:
        print(
            f"no trace journals under {os.path.join(app_dir, 'trace')} "
            "(job predates tracing, or trace.enabled was false)",
            file=sys.stderr,
        )
        return 1
    out_path = args.out or os.path.join(app_dir, "trace.json")
    with open(out_path, "w") as f:
        json.dump(merged, f)
    summary = report(app_dir, procs)
    summary["out"] = out_path
    summary["events"] = len(merged["traceEvents"])
    print(json.dumps(summary, indent=2, sort_keys=True))
    return 0


def cmd_health(args: argparse.Namespace) -> int:
    """Roll up an application's numerics-health verdicts + forensics
    bundles (obs/health.py; docs/OBS.md "Numerics health"). Exit 0 =
    healthy, 1 = tripped, 2 = no health data (job predates the sentinel,
    obs.health.enabled was false, or every process died before a verdict
    landed — absence is reported, never read as healthy)."""
    from tony_tpu_torch.obs import health

    app_dir = resolve_app_dir(args.app)
    roll = health.rollup(app_dir)
    if roll["verdict"] == "unknown":
        print(
            f"no health verdicts under {os.path.join(app_dir, 'health')} "
            "(job predates the sentinel, or obs.health.enabled was false)",
            file=sys.stderr,
        )
        return 2
    if args.bundles:
        bundles = {}
        for name in roll["bundles"]:
            try:
                with open(os.path.join(app_dir, "health", name)) as f:
                    bundles[name] = json.load(f)
            except (OSError, json.JSONDecodeError) as e:
                bundles[name] = {"unreadable": str(e)}
        roll["bundle_contents"] = bundles
    print(json.dumps(roll, indent=2, sort_keys=True))
    return 0 if roll["verdict"] == "healthy" else 1


def cmd_elastic(args: argparse.Namespace) -> int:
    """Audit an application's elastic membership history (docs/ELASTIC.md):
    every declared generation, each trainer journal's reshard boundaries
    with their skipped data ranges, and the current membership. Exit 0 =
    history present, 2 = the job never declared a generation (not an
    elastic job, or it died before the start record)."""
    from tony_tpu_torch.elastic.protocol import (
        journal_files, read_history, read_journal,
    )

    app_dir = resolve_app_dir(args.app)
    history = read_history(app_dir)
    if not history:
        print(
            f"no elastic generations under {os.path.join(app_dir, 'elastic')} "
            "(not an elastic job?)",
            file=sys.stderr,
        )
        return 2
    out = {
        "generations": [r.to_dict() for r in history],
        "current": history[-1].to_dict(),
        "journals": {},
    }
    for path in journal_files(app_dir):
        recs = read_journal(path)
        steps = [r for r in recs if r.get("type") == "step"]
        out["journals"][os.path.basename(path)] = {
            "steps": len(steps),
            "first_step": steps[0]["step"] if steps else None,
            "last_step": steps[-1]["step"] if steps else None,
            "reshards": [r for r in recs if r.get("type") == "reshard"],
        }
    print(json.dumps(out, indent=2, sort_keys=True))
    return 0


def cmd_profile(args: argparse.Namespace) -> int:
    """``tony profile <app_id> [--steps N | --seconds T]``: ask the AM to
    broadcast a bounded capture window to every process of the job, wait
    for the per-process manifests to land, and print the step-anatomy
    report (docs/OBS.md "Step anatomy"). ``tony profile report <app_id>``
    reports on an existing capture without triggering a new one."""
    import time as _time

    from tony_tpu_torch.obs import profile as profile_mod
    from tony_tpu_torch.obs.anatomy import build_anatomy

    target = list(args.target)
    report_only = target and target[0] == "report"
    if report_only:
        target = target[1:]
    if len(target) != 1:
        print("usage: tony profile [report] <app_id>", file=sys.stderr)
        return 2
    app_dir = resolve_app_dir(target[0])
    profile_id = args.id

    if not report_only:
        addr = _read_am_addr(app_dir)
        if not addr:
            print("AM address unknown; application may not be running",
                  file=sys.stderr)
            return 1
        steps = args.steps
        if steps <= 0 and args.seconds <= 0:
            steps = 3  # the useful default: three full steps
        try:
            with ApplicationRpcClient(
                addr, timeout_s=10.0, token=read_token(app_dir)
            ) as c:
                resp = c.start_profile(steps=steps, duration_s=args.seconds)
        except grpc.RpcError as e:
            print(f"AM unreachable: {e}", file=sys.stderr)
            return 1
        if not resp.accepted:
            print(f"profile refused: {resp.message}", file=sys.stderr)
            return 1
        profile_id = resp.profile_id
        note = f" ({resp.message})" if resp.message else ""
        print(f"profile {profile_id} broadcast{note}; waiting for captures",
              file=sys.stderr)
        if args.no_wait:
            print(json.dumps({"profile_id": profile_id}))
            return 0
        # poll for manifests: done when the landed set has been stable for
        # two rounds (a straggler host finishing later still lands — its
        # manifest is on disk for a later `tony profile report`)
        deadline = _time.monotonic() + args.wait
        seen: set[str] = set()
        stable = 0
        while _time.monotonic() < deadline:
            _time.sleep(1.0)
            procs = set(profile_mod.read_manifests(app_dir, profile_id))
            if procs and procs == seen:
                stable += 1
                if stable >= 2:
                    break
            else:
                stable = 0
                seen = procs

    report = build_anatomy(app_dir, profile_id)
    if not report["procs"]:
        where = os.path.join(app_dir, "profile")
        print(
            f"no capture manifests under {where}"
            + (f" for {profile_id}" if profile_id else "")
            + " (no process reached a step boundary inside the window, or "
            "obs.profile.enabled was false)",
            file=sys.stderr,
        )
        return 1 if not report_only else 2
    print(json.dumps(report, indent=2, sort_keys=True))
    return 0


def cmd_top(args: argparse.Namespace) -> int:
    """Live terminal view of one application (docs/OBS.md "SLO + time
    series"): per-host rows off the series journals + AM rollup,
    TTFT/queue-depth sparklines, straggler flags, SLO/health columns."""
    from tony_tpu_torch.obs.top import run_top

    app_dir = resolve_app_dir(args.app)
    try:
        return run_top(app_dir, once=args.once, interval_s=args.interval)
    except KeyboardInterrupt:
        return 0


def cmd_perf(args: argparse.Namespace) -> int:
    """``tony perf diff <old> <new>``: compare two bench reports (or two
    series rollups) under per-section tolerance rules and emit a
    regression verdict. Exit 0 = no regression, 1 = regression(s), 2 =
    unusable input. tests/test_perf_diff.py holds this as a tier-1 gate
    against committed fixtures."""
    from tony_tpu_torch.obs.perf_diff import diff_files

    try:
        verdict = diff_files(args.old, args.new, tol_scale=args.tol_scale)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"cannot diff: {e}", file=sys.stderr)
        return 2
    if not args.full:
        # the printed verdict leads with the judgement; the full key dump
        # stays behind --full so a green diff is one screen
        for k in ("unjudged", "only_old", "only_new"):
            verdict[k] = len(verdict[k])
    print(json.dumps(verdict, indent=2, sort_keys=True))
    return 0 if verdict["ok"] else 1


def cmd_rm_status(args: argparse.Namespace) -> int:
    """Inspect (or clean) the shared ResourceManager lease store — the
    `yarn top` analogue for the cross-job arbitration substrate."""
    from tony_tpu_torch.cluster.lease import LeaseStore

    root = args.rm_root
    if not root and args.conf:
        from tony_tpu_torch.config.config import TonyConfig
        from tony_tpu_torch.config.keys import Keys

        root = TonyConfig.load(args.conf).get_str(Keys.CLUSTER_RM_ROOT, "")
    if not root:
        print(
            "no RM store: pass --rm-root or a --conf with cluster.rm_root set",
            file=sys.stderr,
        )
        return 2
    if not os.path.isdir(os.path.expanduser(root)):
        # inspection must not conjure an empty store out of a typo'd path
        # and report a healthy idle cluster
        print(f"no RM store at {root!r} (directory does not exist)", file=sys.stderr)
        return 2
    store = LeaseStore(root)
    if args.release:
        store.force_release_app(args.release)
        print(f"released all leases of {args.release}")
    print(json.dumps(store.summary(), indent=2))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tony", description=__doc__)
    sub = p.add_subparsers(dest="command", required=True)

    s = sub.add_parser("submit", help="submit a job and wait for completion")
    s.add_argument("--conf", help="TOML config file (the tony.xml analogue)")
    s.add_argument("--src-dir", help="source dir staged into containers")
    s.add_argument(
        "-D", "--define", action="append", default=[], metavar="KEY=VALUE",
        help="config override (repeatable; the -Dtony.k=v analogue)",
    )
    s.add_argument("--detach", action="store_true", help="print app id and return")
    s.add_argument("--quiet", action="store_true")
    s.set_defaults(fn=cmd_submit)

    s = sub.add_parser("status", help="show application status JSON")
    s.add_argument("app")
    s.set_defaults(fn=cmd_status)

    s = sub.add_parser("logs", help="dump task logs")
    s.add_argument("app")
    s.add_argument("--task", help="restrict to one task, e.g. worker:0")
    s.add_argument("--am", action="store_true", help="show the AM log")
    s.set_defaults(fn=cmd_logs)

    s = sub.add_parser(
        "notebook", help="run a single-container notebook and proxy to it"
    )
    s.add_argument("--conf", help="TOML config (cluster/security settings)")
    s.add_argument(
        "-D", "--define", action="append", default=[], metavar="KEY=VALUE",
        help="config override (repeatable)",
    )
    s.add_argument("--listen", type=int, default=0,
                   help="local proxy port (default: ephemeral)")
    s.add_argument("--memory-mb", type=int, default=2048)
    s.add_argument("--cpus", type=int, default=1)
    s.add_argument("--tpu-chips", type=int, default=0)
    s.add_argument("--quiet", action="store_true")
    s.set_defaults(fn=cmd_notebook)

    s = sub.add_parser("stop", help="stop a running application")
    s.add_argument("app")
    s.add_argument("--reason", default="stopped via CLI")
    s.set_defaults(fn=cmd_stop)

    s = sub.add_parser("history", help="list applications")
    s.add_argument("--dir", help="apps root (default ~/.tony-tpu/apps)")
    s.set_defaults(fn=cmd_history)

    s = sub.add_parser(
        "serve",
        help="run a gang-serving job: AM-scheduled decode hosts + a local "
             "routing frontend (docs/SERVE.md)",
    )
    s.add_argument("--conf", help="TOML config (serve.gang.* + job.<type>.*)")
    s.add_argument("--src-dir", help="source dir staged into containers")
    s.add_argument(
        "-D", "--define", action="append", default=[], metavar="KEY=VALUE",
        help="config override (repeatable)",
    )
    s.add_argument(
        "--hosts", type=int, default=0,
        help="override serve.gang.hosts (decode-host container count)",
    )
    s.add_argument(
        "--demo", type=int, default=0, metavar="N",
        help="submit N demo prompts, print completions, stop the job",
    )
    s.add_argument("--max-new-tokens", type=int, default=32)
    s.set_defaults(fn=cmd_serve)

    s = sub.add_parser(
        "chaos",
        help="run a job under a fault schedule and report recovery invariants",
    )
    s.add_argument("--conf", help="TOML config for the job under test")
    s.add_argument("--src-dir", help="source dir staged into containers")
    s.add_argument(
        "-D", "--define", action="append", default=[], metavar="KEY=VALUE",
        help="config override (repeatable)",
    )
    s.add_argument(
        "--faults", default="",
        help="JSON fault schedule (or @file.json); overrides chaos.faults",
    )
    s.add_argument(
        "--expect", default="", choices=["", "SUCCEEDED", "FAILED", "KILLED"],
        help="require this final job state in addition to a clean report",
    )
    s.add_argument("--quiet", action="store_true")
    s.set_defaults(fn=cmd_chaos)

    s = sub.add_parser(
        "trace",
        help="merge an app's trace journals into one Chrome-trace JSON "
             "(Perfetto-loadable) with a goodput/straggler report",
    )
    s.add_argument("app", help="application id or app-dir path")
    s.add_argument(
        "--out", default="",
        help="output path (default <app_dir>/trace.json)",
    )
    s.set_defaults(fn=cmd_trace)

    s = sub.add_parser(
        "health",
        help="roll up an app's numerics-health verdicts and forensics "
             "bundles (exit 0 healthy / 1 tripped / 2 no data)",
    )
    s.add_argument("app", help="application id or app-dir path")
    s.add_argument(
        "--bundles", action="store_true",
        help="inline the forensics bundle contents into the report",
    )
    s.set_defaults(fn=cmd_health)

    s = sub.add_parser(
        "elastic",
        help="audit an app's elastic membership history: generations, "
             "reshard boundaries, skipped data ranges (docs/ELASTIC.md)",
    )
    s.add_argument("app", help="application id or app-dir path")
    s.set_defaults(fn=cmd_elastic)

    s = sub.add_parser(
        "profile",
        help="broadcast a bounded fleet capture window (AM StartProfile) "
             "and print the step-anatomy report; `tony profile report "
             "<app>` reads an existing capture (docs/OBS.md)",
    )
    s.add_argument(
        "target", nargs="+",
        help="application id / app-dir path; prefix with `report` to "
             "report on an existing capture without triggering a new one",
    )
    s.add_argument("--steps", type=int, default=0,
                   help="capture N steps per process (default 3)")
    s.add_argument("--seconds", type=float, default=0.0,
                   help="capture a wall-clock window instead of N steps")
    s.add_argument("--wait", type=float, default=60.0,
                   help="how long to wait for capture manifests")
    s.add_argument("--no-wait", action="store_true",
                   help="trigger and return (report later with "
                        "`tony profile report`)")
    s.add_argument("--id", default="",
                   help="report a specific capture id (default: newest)")
    s.set_defaults(fn=cmd_profile)

    s = sub.add_parser(
        "top",
        help="live per-host view of an app: series sparklines, straggler "
             "flags, SLO/health columns (Ctrl-C exits)",
    )
    s.add_argument("app", help="application id or app-dir path")
    s.add_argument("--once", action="store_true",
                   help="print one frame and exit (scripts, tests)")
    s.add_argument("--interval", type=float, default=2.0,
                   help="refresh period in seconds")
    s.set_defaults(fn=cmd_top)

    s = sub.add_parser(
        "perf",
        help="performance tooling: `perf diff <old> <new>` compares two "
             "bench reports / series rollups and exits 1 on regression",
    )
    psub = s.add_subparsers(dest="perf_command", required=True)
    d = psub.add_parser(
        "diff", help="regression verdict between two reports"
    )
    d.add_argument("old", help="baseline report (BENCH_r*.json, bench.py "
                              "output, or a series rollup)")
    d.add_argument("new", help="candidate report (same shapes)")
    d.add_argument(
        "--tol-scale", type=float, default=1.0,
        help="scale every rule's relative tolerance (noisy rigs > 1.0)",
    )
    d.add_argument(
        "--full", action="store_true",
        help="include the unjudged/one-sided key lists verbatim",
    )
    d.set_defaults(fn=cmd_perf)

    s = sub.add_parser(
        "rm-status",
        help="show the shared ResourceManager store (hosts, leases, queue)",
    )
    s.add_argument("--rm-root", default="", help="lease store directory")
    s.add_argument("--conf", help="TOML config carrying cluster.rm_root")
    s.add_argument(
        "--release", default="", metavar="APP_ID",
        help="force-release a (stale cross-host) app's leases first",
    )
    s.set_defaults(fn=cmd_rm_status)
    return p


def main(argv: list[str] | None = None) -> int:
    logging.basicConfig(level=logging.WARNING)
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
