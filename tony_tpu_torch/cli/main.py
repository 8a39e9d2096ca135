"""tony: the command-line submission surface.

Rebuild of tony-cli's ClusterSubmitter/status surface (SURVEY.md section 2
"tony-cli"): ``tony submit`` stages and runs a job to completion;
``status`` / ``logs`` / ``stop`` / ``history`` operate on existing apps.
Run as ``python -m tony_tpu_torch.cli``.

The port's copy of those five subcommands of ``tony_tpu/cli/main.py``, and
of ``serve`` (a gang of the port's decode hosts behind a routing frontend in
the CLI's process). The reference's others (``chaos``, ``trace``, ``top``,
``profile``, ``notebook``, ...) wait for the rest of the control plane
(ROADMAP queue 1, item 10). ``history`` lists the same apps root
(``~/.tony-tpu/apps``), so it lists either package's apps.

    tony submit --conf job.toml --src-dir ./my_model -D job.worker.instances=4
    tony status <app-id>
    tony logs <app-id> [--task worker:0]
    tony stop <app-id>
    tony history [--dir DIR]
    tony serve --conf serve.toml [--demo N]
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
    return p


def main(argv: list[str] | None = None) -> int:
    logging.basicConfig(level=logging.WARNING)
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
