"""Elastic gang member agent: the user process of every non-chief member.
The port's counterpart of ``tony_tpu/elastic/member.py``.

In the reference the coordinator (member 0, the chief) is one controller
owning every member's devices, and a member's user process only holds its
seat. The port runs one process per rank, so a member's rank takes part
in every collective of the step and its process must train: this agent
runs the job's chief command in this process (``runpy``, from the config
the executor ships in ``TONY_CONF_PATH``) as this member's rank, under
the reference's ``elastic.member`` span, with its log lines and its
``elastic.member_generation`` instants from a watcher thread. A reference
job config therefore runs in the port with only the package name changed.

Chaos ``kill_container`` aimed at this process is the preemption under
test: the survivors' collectives fail, the AM declares a shrink
generation, and they re-form their group without it (``train/loop.py``
``_Elastic``). The AM then relaunches the member; its ``fit()`` finds the
running gang on the run's store and joins it at the grow boundary.

The watcher fences this process once the broadcast has excluded its
member for 10 s: a fenced ghost also gets ABORT on its stale attempt's
heartbeat long before that, so the file path is a backstop, as in the
reference.

Run as ``python -m tony_tpu_torch.elastic.member`` (the job.<type>.command
of elastic member task types). The chief's command is ``python SCRIPT
ARGS``; the member's own task env (``job.<type>.env``) applies, not the
chief's.
"""

from __future__ import annotations

import logging
import os
import runpy
import shlex
import sys
import threading
import time

from tony_tpu_torch.elastic.protocol import ENV_MEMBER, read_generation
from tony_tpu_torch.obs import trace

log = logging.getLogger(__name__)

FENCE_AFTER_S = 10.0


def trainer_argv(command: str) -> list[str]:
    """The chief's command ``python SCRIPT ARGS`` as the argv this process
    runs, ``[SCRIPT, *ARGS]``."""
    argv = shlex.split(command)
    if len(argv) < 2 or not os.path.basename(argv[0]).startswith("python") or \
            argv[1].startswith("-"):
        raise ValueError(f"an elastic member runs the chief's command in its own process, "
                         f"which takes 'python SCRIPT ...'; got {command!r}")
    return argv[1:]


def run_trainer(argv: list[str]) -> int:
    """Run ``argv`` (:func:`trainer_argv`) as ``__main__``; its exit code."""
    saved = sys.argv[:]
    try:
        sys.argv = list(argv)
        # as ``python SCRIPT`` puts the script's directory first
        sys.path.insert(0, os.path.dirname(os.path.abspath(argv[0])))
        runpy.run_path(argv[0], run_name="__main__")
    except SystemExit as e:
        if e.code is None:
            return 0
        return e.code if isinstance(e.code, int) else 1
    finally:
        sys.argv = saved
    return 0


def _watch(app_dir: str, member: int, stop: threading.Event) -> None:
    """Log each generation, emit its instant, and fence this process once
    the broadcast has excluded its member for FENCE_AFTER_S."""
    last_gen = -1
    excluded_since: float | None = None
    while not stop.wait(0.2):
        rec = read_generation(app_dir)
        if rec is not None and rec.generation != last_gen:
            last_gen = rec.generation
            log.info("generation %d (%s): members=%s",
                     rec.generation, rec.boundary, list(rec.members))
            trace.instant("elastic.member_generation", member=member,
                          generation=rec.generation, boundary=rec.boundary)
        if rec is not None and member not in rec.members:
            if excluded_since is None:
                excluded_since = time.monotonic()
            elif time.monotonic() - excluded_since > FENCE_AFTER_S:
                log.warning("member %d fenced out of generation %d for %.0fs; exiting",
                            member, rec.generation, FENCE_AFTER_S)
                trace.flush()
                os._exit(0)
        else:
            excluded_since = None


def main() -> int:
    from tony_tpu_torch.config.config import TonyConfig

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s MEMBER %(levelname)s %(name)s: %(message)s",
    )
    trace.install_from_env()  # join the job's trace spine (no-op untraced)
    app_dir = os.environ.get("TONY_APP_DIR", "")
    member = int(os.environ.get(ENV_MEMBER, os.environ.get("TONY_PROCESS_ID", "0")))
    with open(os.environ["TONY_CONF_PATH"]) as f:
        command = TonyConfig.from_json(f.read()).task_spec("chief").command
    argv = trainer_argv(command)
    log.info("elastic member %d holding its seat (app_dir=%s): training as its rank: %s",
             member, app_dir, " ".join(argv))
    stop = threading.Event()
    watcher = threading.Thread(target=_watch, args=(app_dir, member, stop), daemon=True,
                               name="tony-elastic-member")
    with trace.span("elastic.member", member=member):
        if app_dir:
            watcher.start()
        try:
            code = run_trainer(argv)
        finally:
            stop.set()
    trace.uninstall()
    return code


if __name__ == "__main__":
    sys.exit(main())
