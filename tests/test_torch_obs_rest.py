"""The rest of the port's obs package against the reference's, on the CPU:
``perf_diff`` (the reference's fixtures through both), ``device_metrics``
and ``monitor`` (what a process without a card samples), ``anatomy``
(synthetic interval sets through both packages' budget and collective
table, then a real two-rank gloo capture through ``obs/profile.py``) and
``comms`` (the ledger against ``dist.BYTES``)."""

import os

import pytest

from tony_tpu.obs import anatomy as janatomy
from tony_tpu.obs import monitor as jmonitor
from tony_tpu.obs import perf_diff as jperf_diff
from tony_tpu.obs import tpu_metrics
from tony_tpu_torch.obs import anatomy, device_metrics, monitor, perf_diff
from torch_ranks import spawn

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "perf")
BASE = os.path.join(FIXTURES, "bench_base.json")
REGRESSED = os.path.join(FIXTURES, "bench_regressed.json")


# --- perf_diff ----------------------------------------------------------------


@pytest.mark.parametrize("old,new", [(BASE, BASE), (BASE, REGRESSED), (REGRESSED, BASE)],
                         ids=["identity", "regressed", "recovered"])
def test_perf_diff_verdicts_equal_the_reference(old, new):
    got, want = perf_diff.diff_files(old, new), jperf_diff.diff_files(old, new)
    assert got == want
    for key in ("ok", "regressions", "improvements", "unjudged", "config_changed"):
        assert got[key] == want[key], key
    assert got["ok"] == ((old, new) != (BASE, REGRESSED))


def test_perf_diff_judges_fit_keys_like_the_reference():
    """The rules are the reference's, and they judge the keys ``fit()``'s
    pushes and final report now carry under the reference's names (fault
    F1); the elastic summary's shape is configuration."""
    assert perf_diff.DEFAULT_RULES == jperf_diff.DEFAULT_RULES
    judged = ["tokens_per_sec", "tokens_per_sec_per_chip", "mfu", "loss",
              "host_blocked_ms_per_step", "hbm_mb", "hbm_peak_mb", "hbm_limit_mb",
              "startup_compile_s", "step_time_p95_s", "host_blocked_frac",
              "elastic.reshard_s", "peak_allocated_gb"]
    assert {k: perf_diff.rule_for(k)[0] in ("higher", "lower") for k in judged} == \
        dict.fromkeys(judged, True)
    assert perf_diff.rule_for("elastic.reshards")[0] == "config"


# --- device metrics and the process sampler ------------------------------------


def test_device_metrics_empty_without_a_card():
    """No card: no samples, as the reference's source yields none on a
    device without ``memory_stats``."""
    assert device_metrics.device_memory_samples() == []
    assert device_metrics.device_metrics_dict() == {}
    assert tpu_metrics.tpu_metrics_dict() == {}


def test_task_monitor_samples_the_reference_names():
    got = monitor.TaskMonitor(extra_sources=[device_metrics.device_memory_samples])
    want = jmonitor.TaskMonitor()
    for _ in range(2):
        a, b = got.sample(), want.sample()
        assert [s[0] for s in a] == [s[0] for s in b]
    assert [s[0] for s in a] == ["rss_mb", "cpu_percent"]
    assert a[0][1] > 0 and a[1][1] >= 0


# --- anatomy: the reference's rules on the same intervals -----------------------

CASES = {
    "overlap": ({"step_time_s": [0.010], "input_wait_s": [0.002]},
                {"found": True, "step_windows": [(0.0, 0.010)], "compute": [(0.0, 0.004)],
                 "collective": [(0.003, 0.006)],
                 "collective_events": [{"name": "all-reduce", "ts": 0.003, "dur_s": 0.003}]}),
    "pure_comm": ({"step_time_s": [0.010, 0.006], "input_wait_s": [0.002, 0.0]},
                  {"found": True, "step_windows": [(0.0, 0.010), (0.010, 0.016)],
                   "compute": [(0.0, 0.004), (0.0035, 0.0045)],
                   "collective": [(0.003, 0.006), (0.011, 0.015), (0.0125, 0.016)],
                   "collective_events": [
                       {"name": "all-reduce", "ts": 0.003, "dur_s": 0.003},
                       {"name": "all-gather", "ts": 0.011, "dur_s": 0.004},
                       {"name": "all-gather", "ts": 0.0125, "dur_s": 0.0035}]}),
    "no_trace": ({"step_time_s": [0.010, 0.008], "input_wait_s": [0.001, 0.0]},
                 {"found": False}),
    "overrun": ({"step_time_s": [0.004, 0.004, 0.005], "input_wait_s": [0.003]},
                {"found": True, "step_windows": [(0.0, 0.004), (0.004, 0.008)],
                 "compute": [(0.001, 0.0045), (0.006, 0.0061)], "collective": [],
                 "collective_events": []}),
}
LEDGER = [{"name": "all-reduce", "kind": "all-reduce", "bytes": 4096,
           "replica_groups": [[0, 1]]},
          {"name": "reduce-scatter", "kind": "reduce-scatter", "bytes": 64,
           "replica_groups": ""}]


@pytest.mark.parametrize("case", list(CASES))
def test_budget_and_collective_table_equal_the_reference(case):
    manifest, trace_data = CASES[case]
    assert anatomy.step_budget(manifest, trace_data) == \
        janatomy.step_budget(manifest, trace_data)
    assert anatomy.collective_table(trace_data, LEDGER) == \
        janatomy.collective_table(trace_data, LEDGER)
    payload = {"entries": [{"fn": "train.step", "collectives": LEDGER}]}
    assert anatomy.ledger_collectives(payload) == janatomy.ledger_collectives(payload)


# --- a two-rank gloo capture -------------------------------------------------------


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """Four fsdp 2 steps of the tiny config through fit() on two gloo
    ranks, steps 1-3 in the profile window a broadcast request opens on
    each rank."""
    from tony_tpu_torch.obs import profile

    tmp = tmp_path_factory.mktemp("anatomy")
    app = str(tmp / "app")
    profile.write_request(app, steps=3)
    run = {"task": "anatomy", "app": app, "mesh": {"fsdp": 2}, "steps": 4,
           "model": {}, "data": {"global_batch": 4, "seq_len": 32, "vocab_size": 256}}
    return app, [o["runs"][0] for o in spawn(2, "anatomy", {"runs": [run]}, tmp)]


def test_gloo_capture_budget_sums_to_the_step_time(capture):
    """Each rank's budget rows sum to its measured step time within 10%,
    as the reference's capture test holds its own; the trace shows compute
    (the ``aten::`` ops of the step's thread) and gloo's collectives, and
    the collective table pairs the window's ledger with measured time."""
    app, _ = capture
    report = anatomy.build_anatomy(app)
    assert sorted(report["procs"]) == ["rank0", "rank1"]
    assert report["critical_path"]["proc"] in ("rank0", "rank1")
    for proc, rep in report["procs"].items():
        assert rep["steps"] == 3 and rep["device_trace"], proc
        for row in rep["table"]:
            attributed = sum(row[k] for k in ("compute_s", "exposed_collective_s",
                                              "input_wait_s", "host_blocked_s"))
            assert attributed == pytest.approx(row["step_time_s"], rel=0.10), (proc, row)
            assert row["compute_s"] > 0
        assert rep["totals"]["collective_s"] > 0
        paired = [r for r in rep["collectives"] if r.get("bytes") and r.get("total_s")]
        # gloo runs a reduce-scatter as an all-reduce: its bytes join there
        assert {r["kind"] for r in paired} == {"all-gather", "all-reduce"}, \
            rep["collectives"]
        assert all(r["achieved_gbps"] > 0 for r in paired)


def test_comms_ledger_equals_dist_bytes(capture):
    """The ledger's totals by kind are ``dist.BYTES``, on every rank; the
    window's ``comms.json`` holds the rows the profile window saw, which
    the fsdp 2 step fills with gathers and reduce-scatters over fsdp."""
    app, ranks = capture
    for r, out in enumerate(ranks):
        assert out["totals"] == out["bytes"] and sum(out["bytes"].values()) > 0
        assert out["final"]["steps"] == 4
        rows = anatomy.ledger_collectives(anatomy.comms.read_window(
            os.path.dirname(anatomy.profile_mod.read_manifests(app)[f"rank{r}"]["artifact"])))
        names = {row["name"] for row in rows}
        assert {"all-gather.fsdp", "reduce-scatter.fsdp"} <= names, names
        assert all(row["replica_groups"] == [[0, 1]] for row in rows if "fsdp" in row["name"])
