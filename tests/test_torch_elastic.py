"""The port's elastic training (``tony_tpu_torch.elastic`` and elastic
``fit()``) against the JAX package's, on the CPU.

The units run the same inputs through both packages: the topology's
shapes and refusals, the members' substreams and the skip bookkeeping,
the protocol's files (each package's read by the other's readers), the
shadow. The elastic ``fit()`` runs the reference's fixture (global batch
8, seq 32, vocab 128, 12 steps, warmup 2, the tiny float32 config) through
the reference's single controller on this process's CPU devices and
through the port's one process per rank, on gloo ranks
(``tests/torch_ranks.py``): 2 members of 1 rank and of fsdp 2 under the
plan ``{4: (0,), 8: (0, 1)}``, 4 members of 1 rank under ``{3: (0, 2,
3), 6: (0, 1, 2, 3)}``, which renumbers member 2, and 2 members of 1 rank
whose shrink comes from the broadcast file (``generation.json`` written
before the run, which rank 0 alone reads and hands to the other ranks)
and whose grow from the plan ``{6: (0, 1)}``. Both start from the
reference's parameters. Each step's loss and grad norm are held within
1e-4 (only the order of float32 sums differs), the summaries (all but the
measured ``reshard_s``) and the journals' boundaries and skips equal, and
the port's journal passes both packages' invariant checkers alike. Every grown
member rejoins from a copy of the state poisoned with NaN: the broadcast
overwrites all of it.
"""

import json
import os

import jax
import numpy as np
import pytest

from tony_tpu import elastic as jel
from tony_tpu.models import llama as jl
from tony_tpu.parallel.mesh import MeshShape as JMeshShape, build_mesh
from tony_tpu.train import FitConfig as JFitConfig, fit as jfit
from tony_tpu.train import data as jdata
from tony_tpu.train import trainer as jtrainer
from tony_tpu_torch import elastic as pel
from tony_tpu_torch.parallel.mesh import MeshShape
from tony_tpu_torch.train.data import DataConfig
from torch_jobs import check_both
from torch_ranks import spawn

DATA = dict(global_batch=8, seq_len=32, vocab_size=128)
STEPS = 12
PLAN2 = {4: (0,), 8: (0, 1)}
PLAN4 = {3: (0, 2, 3), 6: (0, 1, 2, 3)}
PLAN_FILE = {6: (0, 1)}
# the reference's runs: name -> (members, plan, a shrink declared in the
# broadcast file before the run)
REFS = {"2": (2, PLAN2, False), "4": (4, PLAN4, False), "2-file": (2, PLAN_FILE, True)}
# the port's runs: name -> (reference run, ranks a member)
RUNS = {"2x1": ("2", 1), "2xfsdp2": ("2", 2), "4x1": ("4", 1), "2x1-file": ("2-file", 1)}


# --- topology -----------------------------------------------------------------


@pytest.mark.parametrize("members,per,live", [(2, None, (0, 1)), (2, None, (1,)),
                                              (4, None, (0, 2, 3)),
                                              (2, MeshShape(fsdp=2, tp=2), (0,))])
def test_topology_shapes_like_reference(members, per, live):
    """``shape_for`` gives the shape of the reference's ``mesh_for`` over 8
    devices (ranks here); a rank's place in a live world is its member's
    place among the survivors, member-major."""
    jper = None if per is None else JMeshShape(**{a: getattr(per, a) for a in
                                                  ("dp", "pp", "fsdp", "ep", "tp", "sp")})
    ref = jel.ElasticTopology(members, per_member=jper)
    got = pel.ElasticTopology(members, per_member=per, world=8)
    assert dict(zip(("dp", "pp", "fsdp", "ep", "tp", "sp"), got.shape_for(live).sizes)) \
        == dict(ref.mesh_for(live).shape)
    n = got.ranks_per_member
    assert n == ref.devices_per_member
    for m in range(members):
        for local in range(n):
            rank = got.rank_of(m, local)
            assert got.member_of(rank) == (m, local)
            # the full-strength rank is the reference's device index
            assert ref.member_devices(m)[local] == jax.devices()[rank]
    for place, m in enumerate(sorted(live)):
        assert got.rank_of(m, n - 1, live) == place * n + n - 1


@pytest.mark.parametrize("members,per,match", [
    (2, {"dp": 2, "fsdp": 2}, "member axis"), (3, None, "divisible"),
    (1, None, ">= 2 members"), (2, {"fsdp": 8}, "needs 8 devices")])
def test_topology_refuses_like_reference(members, per, match):
    with pytest.raises(ValueError, match=match):
        jel.ElasticTopology(members, per_member=None if per is None else JMeshShape(**per))
    with pytest.raises(ValueError, match=match):
        pel.ElasticTopology(members, per_member=None if per is None else MeshShape(**per),
                            world=8)


# --- the membership-aware stream -----------------------------------------------


def test_member_rows_and_reference_batches_byte_equal():
    cfg, jcfg = DataConfig(prefetch=0, **DATA), jdata.DataConfig(prefetch=0, **DATA)
    got = pel.ElasticBatchStream(cfg, 4, (0, 1, 2, 3))
    want = jel.ElasticBatchStream(jcfg, 4, (0, 1, 2, 3))
    for m in range(4):
        for step in range(12):
            assert got.member_rows(m, step).tobytes() == want.member_rows(m, step).tobytes()
    a, b = pel.reference_batches(cfg, 4), jel.reference_batches(jcfg, 4)
    for _ in range(12):
        for x, y in zip(next(a), next(b)):
            assert x.numpy().tobytes() == np.asarray(y).tobytes()
    for s in (got, want, a, b):
        s.close()


def test_reshard_skip_deltas_like_reference():
    """The reference's ``TestElasticStream`` sequence through both
    streams: the same deltas and ``skipped``, the survivors' rows
    untouched."""
    cfg = dict(global_batch=4, seq_len=8, vocab_size=64, prefetch=0)
    got = pel.ElasticBatchStream(DataConfig(**cfg), 2, (0, 1))
    want = jel.ElasticBatchStream(jdata.DataConfig(**cfg), 2, (0, 1))
    deltas = []
    for members, n in (((0,), 3), ((0, 1), 2), ((1,), 1), ((0, 1), 2)):
        for _ in range(n):
            x, y = next(got)[0].numpy(), np.asarray(next(want)[0])
            assert x.tobytes() == y.tobytes()
        deltas.append((got.reshard(members, None), want.reshard(members, None)))
    assert [d[0] for d in deltas] == [d[1] for d in deltas]
    assert deltas[1][0] == {1: (3, 5)}
    assert got.skipped == want.skipped == {1: [[3, 5]], 0: [[6, 8]]}
    with pytest.raises(NotImplementedError):
        pel.ElasticBatchStream(DataConfig(global_batch=4, seq_len=8, path="/tmp/x.bin"),
                               2, (0, 1))


# --- the protocol: each package's files through the other's readers ------------


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_protocol_round_trips_across_packages(tmp_path, writer):
    w, r = (pel, jel) if writer == "port" else (jel, pel)
    app = str(tmp_path)
    w.write_generation(app, w.GenerationRecord(0, (0, 1), "start"))
    w.write_generation(app, w.GenerationRecord(1, (0,), "shrink", dead=(1,), reason="kill"))
    latest = r.read_generation(app)
    assert latest.generation == 1 and latest.members == (0,) and latest.dead == (1,)
    assert [h.to_dict() for h in r.read_history(app)] == \
        [h.to_dict() for h in w.read_history(app)]
    # the reader's controller fences on the writer's broadcast
    ctl = r.ElasticController(r.ElasticSettings(members=2, app_dir=app), watch=False)
    try:
        ctl.check()
        rec = ctl.pending()
        assert rec is not None and rec.members == (0,)
        ctl.applied(rec)
        assert ctl.members == (0,) and ctl.generation == 1
    finally:
        ctl.close()
    path = str(tmp_path / "journal_m0.jsonl")
    j = w.ElasticJournal(path, member=0, members=2)
    j.step(0, 0, (0, 1))
    j.loss(0, 0, 1.25, 42)
    j.reshard(generation=1, at_step=1, boundary="shrink", members=(0,), dead=(1,),
              skipped={1: (1, -1)}, reshard_s=0.5)
    j.close()
    recs = r.read_journal(path)
    assert [x["type"] for x in recs] == ["meta", "step", "loss", "reshard"]
    assert recs[2]["fp"] == 42 and recs[3]["skipped"] == {"1": [1, -1]}


def test_settings_from_env_like_reference(monkeypatch):
    assert pel.ElasticSettings.from_env() is None is jel.ElasticSettings.from_env()
    monkeypatch.setenv("TONY_ELASTIC", "1")
    monkeypatch.setenv("TONY_ELASTIC_MEMBERS", "3")
    monkeypatch.setenv("TONY_ELASTIC_MEMBER", "2")
    monkeypatch.setenv("TONY_ELASTIC_POLL_S", "0.25")
    monkeypatch.setenv("TONY_ELASTIC_SHADOW_STEPS", "4")
    monkeypatch.setenv("TONY_APP_DIR", "/nowhere")
    assert vars(pel.ElasticSettings.from_env()) == vars(jel.ElasticSettings.from_env())
    monkeypatch.setenv("TONY_ELASTIC_MEMBERS", "1")
    assert pel.ElasticSettings.from_env() is None is jel.ElasticSettings.from_env()


# --- the shadow -----------------------------------------------------------------


def test_shadow_exact_and_resharded_onto_a_mesh():
    """The fence capture is exact and owns its memory; ``reshard_state``
    puts it back as a rank's state (one rank here: the whole of it); the
    stride shadow keeps its stride and, copied at once on the CPU, drops
    nothing, as the reference's drained worker drops nothing."""
    import torch

    from tony_tpu_torch.models.llama import LlamaConfig
    from tony_tpu_torch.parallel.mesh import build_mesh as pbuild
    from tony_tpu_torch.train.trainer import default_optimizer, make_train_state, tree_leaves

    cfg = LlamaConfig.tiny()
    state = make_train_state(cfg, default_optimizer(), device="cpu")
    state.step, state.opt_state["count"] = 7, 7
    tree = {"step": state.step, "params": state.params, "opt_state": state.opt_state}
    store = pel.ShadowStore(interval_steps=2)
    host = store.capture_sync(7, tree)
    assert store.snapshot()[0] == 7
    with torch.no_grad():
        for t in tree_leaves(state.params):
            t.add_(1.0)            # the live state moves on; the shadow does not
    back = pel.reshard_state(host, pbuild(), model=cfg, device="cpu")
    assert back.step == 7 and back.opt_state["count"] == 7
    for a, b in zip(tree_leaves(back.params), tree_leaves(state.params)):
        torch.testing.assert_close(a.detach() + 1.0, b.detach(), rtol=0, atol=0)
        assert a.requires_grad and a.data_ptr() != b.data_ptr()
    assert not store.maybe_update(3, tree)
    assert store.maybe_update(4, tree) and store.snapshot()[0] == 4
    ref = jel.ShadowStore(interval_steps=2)
    try:
        assert ref.maybe_update(4, {"v": jax.numpy.ones((4,))})
        ref.drain()
        assert store.dropped == ref.dropped == 0
    finally:
        ref.close()
        store.close()


# --- elastic fit() against the reference's ---------------------------------------


def _ref_params(tmp) -> str:
    """The reference fit()'s initial parameters (``make_train_state`` from
    key 0), flattened into an ``.npz`` for the ranks."""
    jcfg = jl.LlamaConfig.tiny()
    mesh = build_mesh(JMeshShape(), devices=jax.devices()[:1])
    state = jtrainer.make_train_state(jax.random.key(0), jcfg, mesh,
                                      jtrainer.default_optimizer())
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[prefix + k] = np.asarray(v)

    walk(jax.tree.map(np.asarray, state.params), "")
    path = tmp / "params.npz"
    np.savez(path, **flat)
    return str(path)


def _journal(app: str) -> list[dict]:
    return jel.read_journal(jel.journal_path(app, 0))


def _app(path, declared: bool) -> str:
    """An elastic dir, with member 1's loss declared in the broadcast file
    when ``declared``."""
    app = str(path)
    if declared:
        pel.write_generation(app, pel.GenerationRecord(1, (0,), "shrink", dead=(1,),
                                                       reason="member lost"))
    return app


@pytest.fixture(scope="module")
def elastic_runs(tmp_path_factory):
    """The reference's elastic fit() runs, and the port's on gloo ranks."""
    tmp = tmp_path_factory.mktemp("elastic")
    params = _ref_params(tmp)
    refs = {}
    for key, (n, plan, declared) in REFS.items():
        seen: list = []
        app = _app(tmp / f"ref{key}", declared)
        final = jfit(JFitConfig(model=jl.LlamaConfig.tiny(), data=jdata.DataConfig(**DATA),
                                steps=STEPS, log_every=1, warmup_steps=2, elastic_members=n,
                                elastic_plan=plan, elastic_dir=app, on_metrics=seen.append))
        refs[key] = {"final": final, "metrics": seen, "journal": _journal(app)}
    ports = {}
    for name, (key, per) in RUNS.items():
        n, plan, declared = REFS[key]
        app = _app(tmp / f"port-{name}", declared)
        fit_kw = {"steps": STEPS, "warmup_steps": 2, "elastic_members": n, "elastic_dir": app,
                  "plan": [[s, list(m)] for s, m in plan.items()]}
        if per > 1:
            fit_kw["mesh"] = {"fsdp": per}
        run = {"task": "elastic", "model": {}, "data": DATA, "params": params,
               "poison": True, "fit": fit_kw}
        out = spawn(n * per, "elastic", {"runs": [run]}, tmp / name)
        ports[name] = {"ranks": [o["runs"][0] for o in out], "journal": _journal(app),
                       "app": app, "jax": [o["jax_loaded"] or o["tony_tpu_loaded"] for o in out]}
    return refs, ports


@pytest.mark.parametrize("name", list(RUNS))
def test_elastic_fit_matches_reference(elastic_runs, name):
    refs, ports = elastic_runs
    ref, port = refs[RUNS[name][0]], ports[name]
    assert not any(port["jax"])
    got = port["ranks"][0]["metrics"]
    assert [m["step"] for m in got] == [m["step"] for m in ref["metrics"]] == \
        list(range(1, STEPS + 1))
    for g, w in zip(got, ref["metrics"]):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4, atol=1e-4,
                                       err_msg=f"{name} step {g['step']} {key}")
    want = {k: v for k, v in ref["final"]["elastic"].items() if k != "reshard_s"}
    for rank in port["ranks"]:
        summary = dict(rank["final"]["elastic"])
        assert summary.pop("reshard_s") > 0
        assert summary == want
    boundaries = [{k: r[k] for k in ("gen", "at_step", "boundary", "members", "dead", "added",
                                     "skipped", "lost_steps")}
                  for r in port["journal"] if r["type"] == "reshard"]
    assert boundaries == [{k: r[k] for k in boundaries[0]}
                          for r in ref["journal"] if r["type"] == "reshard"]
    assert [r["boundary"] for r in boundaries] == ["shrink", "grow"]
    steps = [(r["step"], r["gen"], r["members"]) for r in port["journal"]
             if r["type"] == "step"]
    assert steps == [(r["step"], r["gen"], r["members"]) for r in ref["journal"]
                     if r["type"] == "step"]


@pytest.mark.parametrize("name", list(RUNS))
def test_grown_members_overwritten_and_journal_audited(elastic_runs, name, tmp_path):
    """Each grown rank joined from a NaN-poisoned state and ends with its
    survivor's parameters bit for bit (the same blocks, the same steps
    since); the port's journal in a terminal app dir passes both
    packages' ``check_invariants`` alike."""
    from test_elastic import _mk_terminal_app

    _, ports = elastic_runs
    per = RUNS[name][1]
    ranks = ports[name]["ranks"]
    grows = {m: r["at_step"] for r in ports[name]["journal"] if r["type"] == "reshard"
             for m in r["added"]}
    assert grows
    for rank, run in enumerate(ranks):
        member, local = divmod(rank, per)
        assert run["poisoned"] == ([grows[member]] if member in grows else [])
        twin = ranks[local]                    # member 0's rank of the same blocks
        for key, value in run["params"].items():
            assert np.isfinite(value).all(), (rank, key)
            assert value.tobytes() == twin["params"][key].tobytes(), (rank, key)
    app = _mk_terminal_app(tmp_path)
    with open(jel.journal_path(ports[name]["app"], 0)) as f, \
            open(jel.journal_path(str(app), 0), "w") as g:
        g.write(f.read())
    report = check_both(str(app))
    assert report.ok, report.to_json()
    assert all(r["lost_steps"] == 0 for r in ports[name]["journal"] if r["type"] == "reshard")


def test_journal_loss_records_match_reference(elastic_runs):
    refs, ports = elastic_runs
    got = [(r["step"], r["gen"]) for r in ports["2x1"]["journal"] if r["type"] == "loss"]
    assert got == [(r["step"], r["gen"]) for r in refs["2"]["journal"] if r["type"] == "loss"]
    meta = ports["2x1"]["journal"][0]
    assert meta["type"] == "meta" and meta["members"] == 2 and meta["member"] == 0
    assert json.dumps(meta["tolerance"], sort_keys=True) == \
        json.dumps(refs["2"]["journal"][0]["tolerance"], sort_keys=True)
    assert os.path.basename(jel.journal_path(ports["2x1"]["app"], 0)) == "journal_m0.jsonl"
