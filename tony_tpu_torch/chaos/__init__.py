"""Chaos: fault injection + recovery-invariant checking (docs/CHAOS.md).

The port's copy of ``tony_tpu/chaos/``: the same schedules, hooks,
invariants and runner over the port's control plane.

Two halves:

- :mod:`tony_tpu_torch.chaos.faults` — a declarative, config-driven fault
  schedule (``chaos.*`` keys) fired through cheap hooks in the AM,
  executors, lease store, RPC server, and backends. Hooks are strict
  no-ops unless the process explicitly arms an injector.
- :mod:`tony_tpu_torch.chaos.invariants` — a post-mortem checker that reads a
  finished job's artifacts (status.json, the .jhist journal, the shared
  lease store) and asserts the recovery contract: client-visible terminal
  status, no stranded leases past TTL, no double-booked host capacity,
  monotonic restart generations.

:mod:`tony_tpu_torch.chaos.runner` + ``tony chaos`` run a real job under a
seeded schedule and emit the invariant report — converting recovery bugs
from "found by reading" into "caught by CI".

Only the hook surface is imported here; the checker/runner import heavier
modules and load lazily at their call sites.
"""

from tony_tpu_torch.chaos.faults import (
    ChaosInjector,
    FaultSpec,
    POINTS,
    active_injector,
    chaos_hook,
    install_from_config,
    parse_faults,
    uninstall,
)

__all__ = [
    "ChaosInjector",
    "FaultSpec",
    "POINTS",
    "active_injector",
    "chaos_hook",
    "install_from_config",
    "parse_faults",
    "uninstall",
]
