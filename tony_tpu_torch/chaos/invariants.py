"""Post-mortem recovery-invariant checker.

The port's copy of ``tony_tpu/chaos/invariants.py``, stdlib only like it:
the same invariants over the app dirs the port's AM, executors, lease
store, elastic journals and gang frontend write.

After a (chaos or plain) job finishes, this module re-reads the durable
artifacts the orchestration layer is contractually obliged to leave
behind and verifies the recovery contract — machine-checkable versions of
the guarantees the module docstrings promise in prose:

``terminal-status``
    Every checked job reached a client-visible terminal status:
    ``status.json`` exists, its state is SUCCEEDED/FAILED/KILLED, and the
    exit code is consistent (0 iff SUCCEEDED). This is the invariant the
    fence-path wedge (ADVICE round 5, medium) violated: an AM that hangs
    in teardown never writes the file.

``events-complete``
    The .jhist journal carries an APPLICATION_FINISHED whose state
    matches ``status.json`` — history consumers (portal, latency
    tooling) must never see a job that just stops mid-journal.

``generation-monotonic``
    Restart generations recorded in the journal (GANG_RESTART
    ``generation``, AM-recovery METADATA ``recovered_generation``)
    strictly increase: a generation reuse would let ghost executors from
    a previous incarnation poison the new gang's barrier.

``lease-no-strand``
    No lease-store entry of a terminal job outlives it past reclaim:
    every surviving entry must be reapable — owner provably dead on this
    host (pid reaping catches it on the next locked op) or TTL-expiring
    (survivors reap at ``renewed_at + ttl``). A live owner still holding
    leases for a finished job, or a TTL-less entry with an unreachable
    owner, is a stranded chip.

``lease-no-double-book``
    Per host, the sum of all apps' leased resources never exceeds the
    host's registered capacity — two owners can never hold the same slot.

``lease-events-audit``
    The store's grow/shrink event log (elastic grow-back, serve
    autoscale) is well-formed: every event names its op, owner, app and a
    registered host, in order — the audit trail that makes a capacity
    change attributable after the fact.

``health-verdict-surfaced``
    A job whose numerics sentinel tripped (obs/health.py wrote a
    ``tripped`` verdict under ``<app_dir>/health/``) must not report
    clean: the trip is either the silent-ruin case (job SUCCEEDED on
    NaN'd numbers) or the cause-of-death a restart decision needs — in
    both cases the post-mortem surfaces it as a violation, never swallows
    it into an all-clear.

``slo-surfaced``
    A job whose SLO engine tripped (obs/slo.py wrote a ``tripped``
    verdict under ``<app_dir>/slo/``) must not report clean: a burned
    error budget — TTFT collapse under a partitioned host, goodput below
    floor through a restart — is the contract violation the chaos run
    exists to surface, and the post-mortem must say so even when the job
    itself SUCCEEDED.

``serve-no-request-lost``
    Over every serving ledger the gang frontend left under
    ``<app_dir>/serve/`` (docs/SERVE.md "Gang serving"): every ACCEPTED
    request completed (finish_reason eos/length, with tokens) — a host
    killed mid-stream must have had its in-flight requests re-queued and
    re-prefilled on a survivor, never dropped — and every replay was
    draw-for-draw deterministic (``replay_consistent``): the regenerated
    prefix matched what was already delivered. Explicit admission
    rejections are NOT losses; silent disappearance is.

``serve-ttft-bounded``
    When the ledger records a TTFT contract (``serve.gang.ttft_budget_s``
    > 0), no completed request's time-to-first-token exceeded it — the
    bounded-TTFT-under-kill serving contract.

``handoff-no-block-leak``
    Over every blockwise KV handoff the frontend ledgered (disaggregated
    prefill pools, docs/SERVE.md "Disaggregated serving"): a successful
    handoff accounted for every shipped block on the adopter
    (``shipped == adopted + freed`` — an adopter that silently dropped a
    block would leak it from the refcounted pool), and a failed handoff
    (prefill host killed mid-ship, adopter refused the payload) stranded
    nothing: the request must still have completed via re-prefill on the
    decode host.

``elastic-no-data-loss``
    Over every elastic journal (``<app_dir>/elastic/journal_m*.jsonl``,
    docs/ELASTIC.md): the consumed step sequence is contiguous (no batch
    repeated, none skipped), membership changes only at declared reshard
    boundaries, every gap in a member's participation is exactly covered
    by a declared skip range, and no two consecutive recorded batch
    fingerprints repeat — the machine-checkable form of "the stream
    skipped exactly the dead host's unconsumed batches".

``elastic-loss-continuity``
    At every reshard boundary the post-boundary losses stay within the
    journal's declared tolerance of the pre-boundary window (mean +
    max(z·std, frac·|mean|)) and remain finite: survivors continued the
    SAME training run from in-memory state, not a degraded restart. The
    tolerance is read from the journal's meta record — the post-mortem
    judges by the contract the trainer declared, never one it invents.

The checker reads the store's ``state.json`` RAW (no LeaseStore handle):
going through the store would run its reapers and destroy the evidence.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Any

from tony_tpu_torch.am.events import EventType, read_history
from tony_tpu_torch.cluster.lease import STATE_FILE, _pid_alive, _this_host
from tony_tpu_torch.obs.health import read_verdicts
from tony_tpu_torch.obs.slo import read_verdicts as read_slo_verdicts

TERMINAL_STATES = ("SUCCEEDED", "FAILED", "KILLED")


@dataclass(frozen=True)
class Violation:
    invariant: str
    subject: str  # app id / host / store entry the violation is about
    detail: str

    def to_dict(self) -> dict[str, str]:
        return {"invariant": self.invariant, "subject": self.subject, "detail": self.detail}


@dataclass
class InvariantReport:
    checked_apps: list[str] = field(default_factory=list)
    violations: list[Violation] = field(default_factory=list)
    notes: list[str] = field(default_factory=list)  # non-fatal observations

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_dict(self) -> dict[str, Any]:
        return {
            "ok": self.ok,
            "checked_apps": list(self.checked_apps),
            "violations": [v.to_dict() for v in self.violations],
            "notes": list(self.notes),
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)


def _read_status(app_dir: str) -> dict | None:
    path = os.path.join(app_dir, "status.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _read_events(app_dir: str) -> list[dict]:
    ev_dir = os.path.join(app_dir, "events")
    if not os.path.isdir(ev_dir):
        return []
    events: list[dict] = []
    for name in sorted(os.listdir(ev_dir)):
        if name.endswith(".jhist.jsonl"):
            events.extend(read_history(os.path.join(ev_dir, name)))
    return events


def _check_job(app_dir: str, report: InvariantReport) -> tuple[str, str]:
    """Check one finished job's artifacts; returns (app_id, state)."""
    app_id = os.path.basename(os.path.abspath(app_dir).rstrip("/"))
    report.checked_apps.append(app_id)
    status = _read_status(app_dir)
    if status is None:
        report.violations.append(
            Violation(
                "terminal-status", app_id,
                "no status.json: the client can never learn this job's outcome "
                "(AM wedged or died before _write_status)",
            )
        )
        return app_id, ""
    state = str(status.get("state", ""))
    code = status.get("exit_code")
    if state not in TERMINAL_STATES:
        report.violations.append(
            Violation("terminal-status", app_id, f"non-terminal final state {state!r}")
        )
    if state == "SUCCEEDED" and code != 0:
        report.violations.append(
            Violation("terminal-status", app_id, f"SUCCEEDED with exit_code {code!r}")
        )
    if state in ("FAILED", "KILLED") and code == 0:
        report.violations.append(
            Violation("terminal-status", app_id, f"{state} with exit_code 0")
        )

    events = _read_events(app_dir)
    finished = [e for e in events if e.get("type") == EventType.APPLICATION_FINISHED]
    if not finished:
        report.violations.append(
            Violation("events-complete", app_id, "no APPLICATION_FINISHED in the .jhist journal")
        )
    elif state and finished[-1].get("state") != state:
        report.violations.append(
            Violation(
                "events-complete", app_id,
                f"journal final state {finished[-1].get('state')!r} != status.json {state!r}",
            )
        )

    # journal order is emit order; restarts of either kind must never
    # reuse or rewind a generation — collect in ONE pass so a gang restart
    # after an AM recovery compares against it, not past it
    generations = []
    for e in events:
        if e.get("type") == EventType.GANG_RESTART and "generation" in e:
            generations.append(e["generation"])
        elif e.get("type") == EventType.METADATA and "recovered_generation" in e:
            generations.append(e["recovered_generation"])
    for prev, cur in zip(generations, generations[1:]):
        if cur <= prev:
            report.violations.append(
                Violation(
                    "generation-monotonic", app_id,
                    f"restart generation went {prev} -> {cur} (sequence {generations})",
                )
            )
            break

    # a tripped numerics verdict must reach the post-mortem reader: a
    # SUCCEEDED job hid a ruined run, a FAILED/KILLED one died of (or
    # with) bad numbers — either way the report cannot be clean
    tripped = {
        proc: v for proc, v in read_verdicts(app_dir).items()
        if v.get("verdict") == "tripped"
    }
    if tripped:
        rules = sorted({
            rule for v in tripped.values() for rule in (v.get("rules") or {})
        })
        what = (
            "job SUCCEEDED while the numerics verdict tripped — a silently "
            "ruined run reported clean"
            if state == "SUCCEEDED"
            else f"job ended {state or 'without status'} with a tripped "
            "numerics verdict — the restart decision needs the health "
            "forensics, not an all-clear"
        )
        report.violations.append(
            Violation(
                "health-verdict-surfaced", app_id,
                f"{what} (rules: {', '.join(rules)}; procs: "
                f"{', '.join(sorted(tripped))})",
            )
        )
    # a tripped SLO verdict is the same class of evidence as a tripped
    # numerics verdict: the run burned its error budget, and a clean
    # post-mortem would bury exactly the contract the SLO declares
    tripped_slo = {
        proc: v for proc, v in read_slo_verdicts(app_dir).items()
        if v.get("verdict") == "tripped"
    }
    if tripped_slo:
        names = sorted({
            name for v in tripped_slo.values() for name in (v.get("slos") or {})
        })
        report.violations.append(
            Violation(
                "slo-surfaced", app_id,
                f"job ended {state or 'without status'} with tripped SLO(s) "
                f"{', '.join(names)} (procs: {', '.join(sorted(tripped_slo))})"
                " — the burn-rate verdict must reach the post-mortem, never "
                "an all-clear",
            )
        )
    _check_serve_ledgers(app_dir, app_id, report)
    _check_elastic(app_dir, app_id, report)
    return app_id, state


def _member_gaps(steps: list[dict], member: int) -> list[tuple[int, int]]:
    """[from, to) step ranges inside the journal where ``member`` was NOT
    in the membership (the intervals a skip declaration must cover)."""
    gaps: list[tuple[int, int]] = []
    start = None
    for rec in steps:
        absent = member not in rec.get("members", [])
        if absent and start is None:
            start = rec["step"]
        elif not absent and start is not None:
            gaps.append((start, rec["step"]))
            start = None
    if start is not None:
        gaps.append((start, steps[-1]["step"] + 1))
    return gaps


def _check_elastic(app_dir: str, app_id: str, report: InvariantReport) -> None:
    """Audit the elastic trainer journals: no data repeated or lost across
    generation boundaries, loss trajectory continuous through them."""
    from tony_tpu_torch.elastic.protocol import (
        DEFAULT_TOLERANCE, journal_files, read_journal,
    )

    for path in journal_files(app_dir):
        recs = read_journal(path)
        subject = f"{app_id}/{os.path.basename(path)}"
        meta = next((r for r in recs if r.get("type") == "meta"), {})
        tol = {**DEFAULT_TOLERANCE, **(meta.get("tolerance") or {})}
        steps = [r for r in recs if r.get("type") == "step"]
        reshards = [r for r in recs if r.get("type") == "reshard"]
        losses = [r for r in recs if r.get("type") == "loss"]
        if not steps:
            continue

        # --- elastic-no-data-loss ------------------------------------------
        for a, b in zip(steps, steps[1:]):
            if b["step"] == a["step"] + 1:
                continue
            what = "repeated" if b["step"] <= a["step"] else "skipped"
            report.violations.append(
                Violation(
                    "elastic-no-data-loss", subject,
                    f"step sequence {what} data: {a['step']} -> {b['step']}",
                )
            )
            break
        boundaries = {r.get("at_step") for r in reshards}
        for a, b in zip(steps, steps[1:]):
            if (set(a.get("members", [])) != set(b.get("members", []))
                    and b["step"] not in boundaries):
                report.violations.append(
                    Violation(
                        "elastic-no-data-loss", subject,
                        f"membership changed {a.get('members')} -> "
                        f"{b.get('members')} at step {b['step']} without a "
                        "declared reshard boundary",
                    )
                )
                break
        # every member's absence must be exactly a declared skip range
        # (open ranges -1 close at the journal's end)
        # a shrink declares an OPEN range ([from, -1]); the matching grow
        # re-declares it closed with the same start — journal order wins,
        # and a still-open range closes at the journal's end
        declared: dict[int, dict[int, int]] = {}
        end_step = steps[-1]["step"] + 1
        for r in reshards:
            for m, rng in (r.get("skipped") or {}).items():
                declared.setdefault(int(m), {})[int(rng[0])] = int(rng[1])
        members_seen = {m for rec in steps for m in rec.get("members", [])}
        members_seen |= set(declared)
        for m in sorted(members_seen):
            gaps = _member_gaps(steps, m)
            merged = sorted(
                (lo, end_step if hi < 0 else min(hi, end_step))
                for lo, hi in declared.get(m, {}).items()
                if lo < end_step
            )
            if gaps != merged:
                report.violations.append(
                    Violation(
                        "elastic-no-data-loss", subject,
                        f"member {m}: journal gaps {gaps} != declared "
                        f"skip ranges {merged} — data silently lost or "
                        "skipped without declaration",
                    )
                )
        fps = [(r["step"], r["fp"]) for r in losses if "fp" in r]
        for (s0, f0), (s1, f1) in zip(fps, fps[1:]):
            if f0 == f1:
                report.violations.append(
                    Violation(
                        "elastic-no-data-loss", subject,
                        f"batch fingerprint repeated across steps {s0} -> "
                        f"{s1} (fp={f1}): the stream replayed data",
                    )
                )
                break

        # --- elastic-loss-continuity ---------------------------------------
        window = int(tol.get("window", 8))
        for r in reshards:
            at = r.get("at_step", 0)
            before = [x["loss"] for x in losses if x["step"] < at][-window:]
            after = [x["loss"] for x in losses if x["step"] >= at]
            after = after[: max(window // 2, 1)]
            if not before or not after:
                report.notes.append(
                    f"{subject}: reshard at step {at} has too few recorded "
                    "losses to judge continuity"
                )
                continue
            if any(x != x or x in (float("inf"), float("-inf")) for x in after):
                report.violations.append(
                    Violation(
                        "elastic-loss-continuity", subject,
                        f"non-finite loss after the generation boundary at "
                        f"step {at}",
                    )
                )
                continue
            mean_b = sum(before) / len(before)
            var = (
                sum((x - mean_b) ** 2 for x in before) / (len(before) - 1)
                if len(before) > 1 else 0.0
            )
            bound = mean_b + max(
                float(tol.get("z", 4.0)) * var ** 0.5,
                float(tol.get("frac", 0.25)) * abs(mean_b),
            )
            mean_a = sum(after) / len(after)
            if mean_a > bound:
                report.violations.append(
                    Violation(
                        "elastic-loss-continuity", subject,
                        f"loss discontinuity at the generation boundary "
                        f"(step {at}): post-boundary mean {mean_a:.4f} "
                        f"exceeds the declared tolerance bound {bound:.4f} "
                        f"(pre-boundary mean {mean_b:.4f})",
                    )
                )


def _check_serve_ledgers(app_dir: str, app_id: str, report: InvariantReport) -> None:
    """Audit the gang frontend's request ledgers (serve/frontend.py):
    no accepted request lost, replays deterministic, TTFT under contract."""
    serve_dir = os.path.join(app_dir, "serve")
    if not os.path.isdir(serve_dir):
        return
    names = sorted(
        n for n in os.listdir(serve_dir)
        if n.startswith("requests_") and n.endswith(".json")
    )
    for name in names:
        try:
            with open(os.path.join(serve_dir, name)) as f:
                ledger = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            report.violations.append(
                Violation(
                    "serve-no-request-lost", app_id,
                    f"unreadable serve ledger {name}: {e}",
                )
            )
            continue
        subject = f"{app_id}/{name}"
        budget = float(ledger.get("ttft_budget_s", 0) or 0)
        completed = {
            e.get("rid") for e in ledger.get("requests", [])
            if e.get("finish_reason") in ("eos", "length")
        }
        for h in ledger.get("handoffs", []):
            rid = h.get("rid", "?")
            if h.get("ok"):
                shipped = int(h.get("shipped", 0) or 0)
                adopted = int(h.get("adopted", 0) or 0)
                freed = int(h.get("freed", 0) or 0)
                if shipped != adopted + freed:
                    report.violations.append(
                        Violation(
                            "handoff-no-block-leak", subject,
                            f"handoff for {rid} shipped {shipped} block(s) "
                            f"but the adopter accounted for "
                            f"{adopted} adopted + {freed} freed — the "
                            "difference leaked from the refcounted pool",
                        )
                    )
            elif rid not in completed:
                report.violations.append(
                    Violation(
                        "handoff-no-block-leak", subject,
                        f"handoff for {rid} failed "
                        f"({h.get('message', '') or 'no message'}) and the "
                        "request never completed — a dead prefill host must "
                        "strand nothing: the decode host re-prefills",
                    )
                )
        for rid in ledger.get("pending", []):
            report.violations.append(
                Violation(
                    "serve-no-request-lost", subject,
                    f"request {rid} was accepted but never completed "
                    "(still pending at ledger time)",
                )
            )
        for entry in ledger.get("requests", []):
            rid = entry.get("rid", "?")
            reason = entry.get("finish_reason", "")
            if reason in ("rejected", "draining"):
                continue  # explicit backpressure, not a loss
            if reason not in ("eos", "length") or not entry.get("tokens"):
                report.violations.append(
                    Violation(
                        "serve-no-request-lost", subject,
                        f"request {rid} ended {reason or 'nowhere'} with "
                        f"{entry.get('tokens', 0)} token(s): "
                        f"{entry.get('message', '')}",
                    )
                )
                continue
            if not entry.get("replay_consistent", True):
                report.violations.append(
                    Violation(
                        "serve-no-request-lost", subject,
                        f"request {rid} replayed NON-deterministically "
                        f"(the regenerated prefix diverged after "
                        f"{entry.get('replays', 0)} replay(s))",
                    )
                )
            if budget > 0 and float(entry.get("ttft_s", 0.0)) > budget:
                report.violations.append(
                    Violation(
                        "serve-ttft-bounded", subject,
                        f"request {rid} TTFT {entry.get('ttft_s')}s exceeds "
                        f"the {budget}s contract",
                    )
                )


def _check_store(rm_root: str, terminal_apps: dict[str, str], report: InvariantReport) -> None:
    """Raw-read the lease store and apply the strand/double-book rules."""
    state_path = os.path.join(os.path.abspath(os.path.expanduser(rm_root)), STATE_FILE)
    if not os.path.exists(state_path):
        report.notes.append(f"lease store {rm_root}: no state file (never used)")
        return
    with open(state_path) as f:
        try:
            store = json.load(f)
        except json.JSONDecodeError as e:
            report.violations.append(
                Violation("lease-no-strand", rm_root, f"unreadable store state: {e}")
            )
            return
    here = _this_host()
    now = time.time()

    def reclaimable(entry: dict) -> str:
        """Why this entry will be reclaimed without an operator ('' = never)."""
        if entry.get("owner_host") == here and not _pid_alive(
            int(entry.get("owner_pid", 0)), int(entry.get("owner_start", 0))
        ):
            return "owner dead on this host (pid reap on next store access)"
        ttl = float(entry.get("ttl_s", 0) or 0)
        if ttl > 0:
            lapse = now - float(entry.get("renewed_at", 0) or 0)
            if entry.get("owner_host") == here:
                # owner alive here: local liveness blocks TTL reaping
                return ""
            return f"TTL reaping due in {max(ttl - lapse, 0.0):.0f}s"
        return ""

    for app_id, app in store.get("apps", {}).items():
        if app_id not in terminal_apps:
            continue  # another tenant's live job: not ours to judge
        why = reclaimable(app)
        if why:
            report.notes.append(f"store entry {app_id}: reclaimable ({why})")
        else:
            report.violations.append(
                Violation(
                    "lease-no-strand", app_id,
                    f"leases outlive terminal job ({terminal_apps[app_id]}) with no "
                    f"reclaim path: owner {app.get('owner_host')}:{app.get('owner_pid')} "
                    f"ttl_s={app.get('ttl_s')}",
                )
            )
    for t in store.get("queue", []):
        app_id = t.get("app_id", "")
        if app_id in terminal_apps and not reclaimable(t):
            report.violations.append(
                Violation(
                    "lease-no-strand", app_id,
                    f"queue ticket seq={t.get('seq')} outlives terminal job with no reclaim path",
                )
            )

    # grow/shrink audit trail (LeaseStore._emit_event): every elastic /
    # autoscale capacity change must name an owner and a registered host,
    # in order — an event that fails this is a store whose accounting can
    # no longer be trusted by the double-book check below
    hosts = store.get("hosts", {})
    last_ts = 0.0
    for i, ev in enumerate(store.get("events", [])):
        what = ""
        if not isinstance(ev, dict) or ev.get("op") not in ("grow", "shrink"):
            what = f"malformed op {ev!r}"
        elif not ev.get("app_id") or not ev.get("owner"):
            what = "missing app_id/owner attribution"
        elif ev.get("host") not in hosts:
            what = f"unregistered host {ev.get('host')!r}"
        elif float(ev.get("ts", 0) or 0) + 1.0 < last_ts:
            what = "events out of order"
        if what:
            report.violations.append(
                Violation("lease-events-audit", rm_root, f"event[{i}]: {what}")
            )
            break
        last_ts = max(last_ts, float(ev.get("ts", 0) or 0))

    leased: dict[str, list[int]] = {h: [0, 0, 0] for h in hosts}
    for app_id, app in store.get("apps", {}).items():
        for gang in app.get("gangs", []):
            for ask, host in zip(gang.get("asks", []), gang.get("hosts", [])):
                if host in leased:
                    leased[host][0] += int(ask.get("memory_mb", 0))
                    leased[host][1] += int(ask.get("cpus", 0))
                    leased[host][2] += int(ask.get("tpu_chips", 0))
    for host, (mem, cpus, chips) in leased.items():
        cap = hosts[host]
        if (
            mem > int(cap.get("memory_mb", 0))
            or cpus > int(cap.get("cpus", 0))
            or chips > int(cap.get("tpu_chips", 0))
        ):
            report.violations.append(
                Violation(
                    "lease-no-double-book", host,
                    f"leased (mem={mem} cpus={cpus} chips={chips}) exceeds registered "
                    f"capacity (mem={cap.get('memory_mb')} cpus={cap.get('cpus')} "
                    f"chips={cap.get('tpu_chips')})",
                )
            )


def check_invariants(app_dirs: list[str] | str, rm_root: str = "") -> InvariantReport:
    """Verify the recovery contract over finished application dir(s) and,
    when ``rm_root`` is given, the shared lease store they ran against."""
    if isinstance(app_dirs, str):
        app_dirs = [app_dirs]
    report = InvariantReport()
    terminal_apps: dict[str, str] = {}
    for d in app_dirs:
        app_id, state = _check_job(d, report)
        if state in TERMINAL_STATES:
            terminal_apps[app_id] = state
    if rm_root:
        _check_store(rm_root, terminal_apps, report)
    return report


__all__ = ["InvariantReport", "Violation", "check_invariants", "TERMINAL_STATES"]
