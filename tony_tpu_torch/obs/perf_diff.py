"""``tony perf diff``: cross-run performance regression verdicts. The
port's copy of ``tony_tpu/obs/perf_diff.py``, stdlib only like it.

It compares two bench reports (or two live-series rollups) key by key
under per-section tolerance rules and emits a machine-checkable verdict.
The rules judge the reference's key names (``tokens_per_sec_per_chip``,
``mfu``, ``hbm_mb``, ``step_time_p95_s``, ...), which ``fit()``'s pushes
and final report carry in the port too.

Inputs it understands (auto-detected):

- a driver **BENCH_r*.json wrapper** (``{"parsed": ..., "tail": "...",
  ...}``) — the embedded bench-report JSON line is extracted from the
  tail;
- a raw **bench report** (one JSON line: ``{"metric", "value",
  "extra": {...}}``);
- a **series rollup** (``obs/series.fleet_rollup``) — each proc's numeric
  keys reduce to the median over its recorded points.

Rules: every numeric key flattens to a dotted path and is matched against
an ordered pattern list declaring *direction* (is bigger better?) and a
relative tolerance. Keys matching a ``config`` rule (batch sizes, param
counts, steps) are compared for *identity* — a changed config is reported
separately, never as a perf regression. Keys no rule claims are listed as
``unjudged`` rather than silently dropped: the diff never pretends to
have covered what it cannot judge.
"""

from __future__ import annotations

import json
import re
import statistics
from typing import Any

# (pattern, kind, rel_tol) — FIRST match wins, so configs and exclusions
# outrank the broad latency catch-alls below them. kind: "higher" =
# bigger is better, "lower" = smaller is better, "config" = must match
# exactly, "skip" = meta/noise, never compared.
DEFAULT_RULES: tuple[tuple[str, str, float], ...] = (
    # meta / driver plumbing
    (r"(^|\.)(n|rc|ts|vs_baseline|every|count|step|steps)$", "skip", 0.0),
    (r"(^|\.)(at|last_ts|age_s|_n)$", "skip", 0.0),
    (r"_n$", "skip", 0.0),
    # configuration identity (not performance)
    (r"(n_params|n_active_params|batch|seq|vocab|n_layers|n_heads|"
     r"capacity_factor|top_k|slots_formula|kv_block|window)", "config", 0.0),
    # decomposed-collective overlap (ops/overlap.py, bench `overlap`
    # section): the within-run |on - off| loss delta is a value-safety
    # cross-check (≈0 by construction, asserted directly by tests), not
    # a judged metric — it must outrank the loss rule below or a
    # 1e-7 -> 2e-7 float jitter would flag as an infinite relative
    # regression. Pure-comm step counts are trace-shaped.
    (r"(loss_delta|pure_comm_steps)", "skip", 0.0),
    # quality: loss/perplexity may not silently regress either
    (r"(loss|perplexity)", "lower", 0.02),
    # elastic restart cost (elastic/, bench `elastic` section):
    # a lost step is a regression with ZERO tolerance (the whole point of
    # elastic is losing none); warm-restart seconds and the post-shrink
    # step-time ratio get timing slack. These must outrank the throughput
    # rule below — `goodput.restart_s` would otherwise match its
    # `goodput` pattern and be judged higher-better. Scenario shape
    # (member count, boundary count) is configuration identity.
    (r"(elastic.*(members|reshards)$|generation_changes)", "config", 0.0),
    (r"(lost_steps)", "lower", 0.0),
    (r"(restart_s|reshard_s|shrunk_step_ratio)", "lower", 0.25),
    # disaggregated serving (engine chunked prefill + serve/gang.py pool
    # handoff, bench `decode.disagg`): the chunked/unchunked TPOT-p99
    # ratio is the long-prompt-interference headline — lower is better,
    # and it carries no terminal latency token so it would otherwise go
    # unjudged. The chunk size and the scenario's long-prompt length are
    # configuration identity: silently shrinking the chunk (or the
    # prompt) would make interference look "fixed". The handoff payload
    # is trace-shaped — blocks/bytes scale with the shipped prefix, so
    # the memory catch-all below must not judge a longer handoff as a
    # regression (handoff_ms stays judged by the latency rule).
    (r"tpot_p99_chunked_ratio", "lower", 0.10),
    (r"(chunk_tokens|long_prompt_tokens)", "config", 0.0),
    (r"handoff_.*(bytes|blocks)", "skip", 0.0),
    # MoE fast path (parallel/moe + ops/moe_overlap, bench `moe_top2`):
    # the PR-4 dispatch gate, resolved — the grouped/gather tokens-per-sec
    # ratio is the judged headline (higher is better; it carries no
    # throughput token so it would otherwise go unjudged), and the
    # recorded dispatch decision bits are configuration identity: a
    # silent flip back to gather (or the gate silently ceasing to hold
    # while grouped stays default) must surface as a diff failure, not
    # hide inside a judged metric. The overlap section's chunk size rides
    # the `chunk_tokens` config rule above; its exposed/overlap keys ride
    # the step-anatomy rules below.
    (r"grouped_vs_gather", "higher", 0.05),
    (r"dispatch_(gate_holds|default_grouped)", "config", 0.0),
    # throughput-shaped (and headroom: MORE free HBM is better — this
    # must outrank the broad memory rule below or a headroom collapse
    # would be judged as a memory improvement): higher is better
    (r"(tokens_per_sec|tok_s|tflops|mfu|goodput|headroom|occupancy|"
     r"slots$|requests_per_s|steps_per_s)", "higher", 0.05),
    # step anatomy (obs/anatomy.py): overlap (collective time hidden under
    # compute) and achieved collective bandwidth are higher-better;
    # exposed collective time lower-better. These must outrank the broad
    # memory/latency rules: `achieved_gbps` would otherwise be unjudged
    # and `overlap_frac` has no other match. A collective's payload size
    # is a STATIC property of the compiled program (configuration
    # identity, like n_params) — without the config rule the memory
    # catch-all below would judge a deliberate sharding change's bigger
    # payload as a perf regression even when the step got faster.
    (r"top_collective\.bytes", "config", 0.0),
    (r"(overlap_frac|achieved_gbps)", "higher", 0.05),
    (r"(exposed_collective)", "lower", 0.10),
    # decomposed-collective overlap, bench `overlap` section
    # (collective_overlap_bench): the on/off exposed-collective and
    # step-time ratios are the overlap headline — lower is better, and
    # `step_ms_ratio` carries no terminal latency token so it would
    # otherwise go unjudged. The gradient-bucket budget is SIZED from
    # the measured bandwidth (bucket_bytes_from_report): a changed
    # budget means the measurement changed, not that memory regressed —
    # like top_collective.bytes it is configuration identity and must
    # outrank the memory catch-all below.
    (r"(exposed_ratio|step_ms_ratio)", "lower", 0.10),
    (r"grad_bucket_bytes", "config", 0.0),
    # prefix store (serve/prefix.py, bench `decode.prefix_trace`): hit
    # rate/tokens are higher-better; the TTFT and prefill-FLOPs on/off
    # ratios are the reuse headline — lower is better, and they must
    # outrank the memory rule (flops_ratio carries no memory-ish token
    # but resident bytes do: residency is trace-shaped, skip it)
    (r"prefix_(hit_rate|hit_tokens)", "higher", 0.05),
    (r"prefix.*(ttft|flops).*ratio", "lower", 0.10),
    (r"prefix_(resident|evicted|nodes)", "skip", 0.0),
    # speculative decoding (serve/spec.py, bench `decode.spec_trace`):
    # tokens emitted per decode step, the draft accept rate, and the
    # spec-on/off speedup are the headline — higher is better; rollback
    # counts are trace-shaped (they scale with how much was proposed),
    # skip them. Compile counts fall through to the compile rule below.
    (r"(max_draft|gen_tokens)", "config", 0.0),
    (r"(tokens_per_step|accept_rate|speedup)", "higher", 0.05),
    (r"(spec_rollbacks|draft_proposed|draft_accepted)", "skip", 0.0),
    # quantized serving (serve/cache.py int8/fp8 KV, bench
    # `decode.quant` + `gqa_capacity`): the slot budget — measured
    # max_slots_* and the quant/bf16 ratio — is the capacity headline,
    # higher is better, and it must outrank the memory rule (the keys
    # carry no memory token but a budget collapse must not go unjudged).
    # The stated accuracy tolerance and the KV storage dtype are
    # configuration identity: silently loosening the tolerance (or
    # switching int8 -> fp8) would make a worse kernel look "within
    # tolerance", so drift is a diff failure, not a judged metric.
    (r"(max_slots|slot_ratio)", "higher", 0.05),
    (r"(quant_kv$|tolerance)", "config", 0.0),
    # memory: lower is better, generous tolerance (allocator noise)
    (r"(hbm|bytes|_gb$|_mb$|rss)", "lower", 0.10),
    # compile counts: lower is better (a silent recompile regression)
    (r"(compiles|recompile)", "lower", 0.0),
    # latency-shaped: lower is better
    (r"(ttft|tpot|_ms$|_s$|_seconds$|latency|host_blocked|time)", "lower", 0.10),
)


def load_report(path: str) -> dict[str, Any]:
    """Parse one input file into a raw report dict (see module docstring
    for the accepted shapes). Raises ValueError on unusable input."""
    with open(path, encoding="utf-8") as f:
        raw = json.load(f)
    if not isinstance(raw, dict):
        raise ValueError(f"{path}: not a JSON object")
    if "tail" in raw and isinstance(raw.get("tail"), str):
        # driver wrapper: the bench report is the last JSON-object line of
        # the captured tail (warnings precede it)
        for line in reversed(raw["tail"].splitlines()):
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                report = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(report, dict):
                return report
        # fall back to the driver's parsed headline
        parsed = raw.get("parsed")
        if isinstance(parsed, dict):
            return parsed
        raise ValueError(f"{path}: wrapper carries no parseable bench report")
    if "procs" in raw and isinstance(raw.get("procs"), dict):
        return _rollup_to_report(raw)
    return raw


def _rollup_to_report(rollup: dict[str, Any]) -> dict[str, Any]:
    """Reduce a series rollup to comparable scalars: per proc, the median
    of each numeric key over its points (median, not last — one straggler
    scrape must not define the run)."""
    out: dict[str, Any] = {}
    for proc, rec in sorted(rollup.get("procs", {}).items()):
        values: dict[str, list[float]] = {}
        for point in rec.get("points", []) or []:
            if not isinstance(point, dict):
                continue
            for k, v in point.items():
                if k == "ts" or isinstance(v, bool):
                    continue
                if isinstance(v, (int, float)):
                    values.setdefault(k, []).append(float(v))
        out[proc] = {
            k: round(statistics.median(vs), 6) for k, vs in values.items()
        }
    return out


def flatten(obj: Any, prefix: str = "") -> dict[str, float]:
    """Numeric leaves as dotted keys (bools excluded — they are flags,
    not measurements; strings and lists are structure, not data)."""
    out: dict[str, float] = {}
    if isinstance(obj, dict):
        for k, v in obj.items():
            out.update(flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
        out[prefix] = float(obj)
    return out


def rule_for(key: str, rules=DEFAULT_RULES) -> tuple[str, float] | None:
    for pattern, kind, tol in rules:
        if re.search(pattern, key):
            return kind, tol
    return None


def diff(old: dict[str, Any], new: dict[str, Any], *,
         rules=DEFAULT_RULES, tol_scale: float = 1.0) -> dict[str, Any]:
    """Compare two loaded reports; the verdict dict. ``ok`` is False iff
    any judged key regressed past its tolerance (scaled by ``tol_scale``
    for noisier rigs). The identity diff of any report against itself is
    ok by construction."""
    fo, fn = flatten(old), flatten(new)
    shared = sorted(set(fo) & set(fn))
    out: dict[str, Any] = {
        "compared": 0,
        "regressions": [],
        "improvements": [],
        "config_changed": [],
        "unjudged": [],
        "only_old": sorted(set(fo) - set(fn)),
        "only_new": sorted(set(fn) - set(fo)),
    }
    for key in shared:
        r = rule_for(key, rules)
        if r is None:
            out["unjudged"].append(key)
            continue
        kind, tol = r
        if kind == "skip":
            continue
        a, b = fo[key], fn[key]
        if kind == "config":
            if a != b:
                out["config_changed"].append(
                    {"key": key, "old": a, "new": b}
                )
            continue
        out["compared"] += 1
        base = abs(a)
        delta = (b - a) / base if base > 0 else (0.0 if b == a else float("inf"))
        tol = tol * tol_scale
        entry = {
            "key": key, "old": a, "new": b,
            "delta_frac": round(delta, 4) if delta != float("inf") else "inf",
            "tol": tol, "direction": kind,
        }
        if kind == "higher":
            if delta < -tol:
                out["regressions"].append(entry)
            elif delta > tol:
                out["improvements"].append(entry)
        else:  # lower is better
            if delta > tol:
                out["regressions"].append(entry)
            elif delta < -tol:
                out["improvements"].append(entry)
    # worst first: the headline regression leads the report
    def _sev(e) -> float:
        d = e["delta_frac"]
        return float("inf") if d == "inf" else abs(d)

    out["regressions"].sort(key=_sev, reverse=True)
    out["improvements"].sort(key=_sev, reverse=True)
    out["ok"] = not out["regressions"]
    return out


def diff_files(old_path: str, new_path: str, *,
               tol_scale: float = 1.0) -> dict[str, Any]:
    """Load + diff two report files (the ``tony perf diff`` body)."""
    verdict = diff(
        load_report(old_path), load_report(new_path), tol_scale=tol_scale
    )
    verdict["old"] = old_path
    verdict["new"] = new_path
    return verdict


__all__ = [
    "DEFAULT_RULES", "diff", "diff_files", "flatten", "load_report",
    "rule_for",
]
