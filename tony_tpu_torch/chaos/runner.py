"""Chaos runner: one real job under a seeded fault schedule + the report.

The port's copy of ``tony_tpu/chaos/runner.py``: the job runs through the
port's client, AM and executors.

The ``tony chaos`` entrypoint (cli/main.py) and the test suite both drive
this: stage and run a genuine job (LocalProcessBackend or
RemoteBackend(local) — every orchestration path real, only the substrate
faked), with ``chaos.*`` config arming the AM/executor injectors, then
re-read the artifacts and emit the invariant report. The run "passes"
when the report is clean — NOT when the job succeeds: many schedules
exist precisely to prove a job fails *visibly and cleanly*.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass

from tony_tpu_torch.chaos.faults import parse_faults
from tony_tpu_torch.chaos.invariants import InvariantReport, check_invariants
from tony_tpu_torch.cli.client import TonyClient
from tony_tpu_torch.config.config import TonyConfig
from tony_tpu_torch.config.keys import Keys

log = logging.getLogger(__name__)


@dataclass
class ChaosRunResult:
    app_id: str
    app_dir: str
    exit_code: int   # the job's client exit code (faults may legitimately fail the job)
    state: str       # final state from status.json ("" if never written)
    report: InvariantReport
    # OOM forensics bundles any process dumped under <app_dir>/oom/ —
    # a RESOURCE_EXHAUSTED death during the run is a finding the
    # post-mortem must surface, not a silent exit code (obs/hbm.py)
    oom_forensics: list[str] | None = None
    # numerics forensics bundles under <app_dir>/health/ (obs/health.py):
    # a tripped sentinel during the run is likewise a post-mortem finding
    # (the invariant checker separately refuses to report clean over a
    # tripped verdict — health-verdict-surfaced)
    health_forensics: list[str] | None = None

    def to_dict(self) -> dict:
        return {
            "app_id": self.app_id,
            "app_dir": self.app_dir,
            "exit_code": self.exit_code,
            "state": self.state,
            "report": self.report.to_dict(),
            "oom_forensics": self.oom_forensics or [],
            "health_forensics": self.health_forensics or [],
        }


def run_chaos_job(config: TonyConfig, src_dir: str = "", quiet: bool = True) -> ChaosRunResult:
    """Run one job under the config's fault schedule and check invariants.

    ``chaos.enabled`` is forced on and the schedule is validated BEFORE
    submission — a typo'd fault type must fail the operator, not arm a
    vacuous run that reports all-clear.
    """
    config.set(Keys.CHAOS_ENABLED, True)
    faults = parse_faults(config.get(Keys.CHAOS_FAULTS))
    if not faults:
        raise ValueError("no faults scheduled (chaos.faults is empty)")
    log.warning("chaos run: %d fault(s): %s", len(faults), "; ".join(f.describe() for f in faults))
    client = TonyClient(config, src_dir=src_dir)
    code = client.run(quiet=quiet)
    state = ""
    status_path = os.path.join(client.app_dir, "status.json")
    if os.path.exists(status_path):
        with open(status_path) as f:
            state = str(json.load(f).get("state", ""))
    report = check_invariants(
        [client.app_dir], rm_root=config.get_str(Keys.CLUSTER_RM_ROOT, "")
    )
    from tony_tpu_torch.obs import health
    from tony_tpu_torch.obs.hbm import forensics_files

    return ChaosRunResult(
        app_id=client.app_id,
        app_dir=client.app_dir,
        exit_code=code,
        state=state,
        report=report,
        oom_forensics=forensics_files(client.app_dir),
        health_forensics=health.forensics_files(client.app_dir),
    )


__all__ = ["ChaosRunResult", "run_chaos_job"]
