"""Sharded checkpoints of the port's training (train/checkpoint.py through
fit()) on gloo ranks of ``tests/torch_ranks.py``, on the CPU.

- At fsdp 2, tp 2, pp 2 (GPipe, one layer a stage), dp 2 x fsdp 2 and
  ep 2 x fsdp 2 (a MoE model, the scan overlap of its ep combine),
  ``fit()`` runs five steps saving at step 3
  and at the end. Fresh rank processes then resume from a directory that
  holds step 3 alone and run steps 4 and 5: their losses and the blocks
  they save at step 5 are bit-equal to the uninterrupted run's (float32;
  the same operations in the same order on the same data).
- A step saved at fsdp 2 restores at fsdp 4, at dp 2 x fsdp 2 and onto
  one process to the same global tensors, bit for bit; a step saved at tp
  2 restores at fsdp 2 and onto one process the same way, as does one
  saved at pp 2 (each stage's file holding its layers), and
  ``shards_from_numpy`` gives each tp rank its blocks and each pp stage
  its layers.
- A save whose second rank is killed once its file is on disk publishes
  nothing, and the next manager reaps its temp directory.
- An unreadable newest step (one rank's file torn) makes every rank fall
  back to the same earlier step.
"""

import shutil

import numpy as np
import pytest
import torch

from tony_tpu_torch.models.llama import LlamaConfig, logical_axes
from tony_tpu_torch.parallel.sharding import tree_specs
from tony_tpu_torch.train.checkpoint import CheckpointManager
from tony_tpu_torch.train.trainer import default_optimizer, make_train_state
from torch_ranks import spawn

DATA = dict(global_batch=4, seq_len=32, vocab_size=256)
DENSE = {"attention_impl": "dot"}
# name -> (world, mesh, model knobs, further FitConfig fields)
CONFIGS = {"fsdp2": (2, {"fsdp": 2}, DENSE, {}),
           "tp2": (2, {"tp": 2}, DENSE, {}),
           "pp2": (2, {"pp": 2}, DENSE, {}),
           "dp2-fsdp2": (4, {"dp": 2, "fsdp": 2}, DENSE, {}),
           "ep2-fsdp2": (4, {"ep": 2, "fsdp": 2}, {**DENSE, "n_experts": 4},
                         {"moe_overlap_impl": "scan"})}


def _fit_run(name, directory):
    _, mesh, model, extra = CONFIGS[name]
    return {"task": "fit", "mesh": mesh, "model": model, "data": DATA, "steps": 5,
            "checkpoint_dir": str(directory), "fit": {"checkpoint_every": 3, **extra}}


def _blocks(step_dir, rank):
    return torch.load(step_dir / f"rank{rank}.pt", weights_only=True)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


def _equal_blocks(a, b):
    assert a["step"] == b["step"] and a["opt_state"]["count"] == b["opt_state"]["count"]
    for part in ("params", "mu", "nu"):
        ta = _leaves(a["params"] if part == "params" else a["opt_state"][part])
        tb = _leaves(b["params"] if part == "params" else b["opt_state"][part])
        assert set(ta) == set(tb)
        for key in ta:
            assert torch.equal(ta[key], tb[key]), f"{part}/{key}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Four spawns: the uninterrupted runs (and the killed save) at world 2
    and 4, then, in fresh processes, the resumed runs and the restores."""
    tmp = tmp_path_factory.mktemp("ckpt")
    first = {name: tmp / f"first-{name}" for name in CONFIGS}
    kill_dir = tmp / "killed"
    two = spawn(2, "fit", {"runs": [_fit_run("fsdp2", first["fsdp2"]),
                                    _fit_run("tp2", first["tp2"]),
                                    _fit_run("pp2", first["pp2"]),
                                    {"task": "killed_save", "mesh": {"fsdp": 2},
                                     "model": DENSE, "checkpoint_dir": str(kill_dir)}],
                           "timeout_s": 30}, tmp / "a2", may_die=(1,))
    four = spawn(4, "fit", {"runs": [_fit_run(n, first[n]) for n in ("dp2-fsdp2", "ep2-fsdp2")]},
                 tmp / "a4")
    killed = {"dir": kill_dir, "listing": sorted(p.name for p in kill_dir.iterdir()),
              "ranks": [r and r["runs"][3] for r in two]}
    uninterrupted = {"fsdp2": two[0]["runs"][0], "tp2": two[0]["runs"][1],
                     "pp2": two[0]["runs"][2],
                     **{n: four[0]["runs"][j] for j, n in enumerate(("dp2-fsdp2", "ep2-fsdp2"))}}
    first_listing = {n: (sorted(p.name for p in d.iterdir()),
                         sorted(p.name for p in (d / "3").iterdir())) for n, d in first.items()}
    # resume from step 3 alone, in fresh rank processes
    resumed_dirs = {}
    for name, d in first.items():
        resumed_dirs[name] = tmp / f"resumed-{name}"
        resumed_dirs[name].mkdir()
        shutil.copytree(d / "3", resumed_dirs[name] / "3")
    # a copy of fsdp 2's steps with the newest's rank 1 file torn
    torn = tmp / "torn"
    shutil.copytree(first["fsdp2"], torn)
    (torn / "5" / "rank1.pt").write_bytes(b"torn")
    restore = {"task": "restore", "model": DENSE, "checkpoint_dir": str(first["fsdp2"])}
    two_b = spawn(2, "fit", {"runs": [_fit_run("fsdp2", resumed_dirs["fsdp2"]),
                                      {**restore, "mesh": {"fsdp": 2},
                                       "checkpoint_dir": str(torn)},
                                      _fit_run("tp2", resumed_dirs["tp2"]),
                                      {**restore, "mesh": {"fsdp": 2},
                                       "checkpoint_dir": str(first["tp2"])},
                                      _fit_run("pp2", resumed_dirs["pp2"]),
                                      {**restore, "mesh": {"fsdp": 2},
                                       "checkpoint_dir": str(first["pp2"])}]}, tmp / "b2")
    four_b = spawn(4, "fit", {"runs": [_fit_run(n, resumed_dirs[n])
                                       for n in ("dp2-fsdp2", "ep2-fsdp2")]
                              + [{**restore, "mesh": {"fsdp": 4}},
                                 {**restore, "mesh": {"dp": 2, "fsdp": 2}}]},
                   tmp / "b4")
    resumed = {"fsdp2": two_b[0]["runs"][0], "tp2": two_b[0]["runs"][2],
               "pp2": two_b[0]["runs"][4],
               **{n: four_b[0]["runs"][j] for j, n in enumerate(("dp2-fsdp2", "ep2-fsdp2"))}}
    return {"first": first, "first_listing": first_listing, "resumed_dirs": resumed_dirs,
            "uninterrupted": uninterrupted, "resumed": resumed, "killed": killed,
            "fell_back": [r["runs"][1] for r in two_b],
            "resharded": {"fsdp4": [r["runs"][2] for r in four_b],
                          "dp2-fsdp2": [r["runs"][3] for r in four_b]},
            "tp2_at_fsdp2": [r["runs"][3] for r in two_b],
            "pp2_at_fsdp2": [r["runs"][5] for r in two_b],
            "jax_loaded": any(r["jax_loaded"] or r["tony_tpu_loaded"]
                              for r in two + four + two_b + four_b if r)}


def _template():
    return make_train_state(LlamaConfig.tiny(**DENSE), default_optimizer(), seed=3,
                            device="cpu")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_a_resumed_run_is_bit_equal_to_the_uninterrupted_one(runs, name):
    """The save at step 3 holds each rank's blocks and rank 0's manifest;
    resumed from it alone, steps 4 and 5 give the uninterrupted run's
    losses and grad norms bit for bit, and the blocks saved at step 5 are
    bit-equal on every rank (parameters, both moments, the counts)."""
    world = CONFIGS[name][0]
    steps, files = runs["first_listing"][name]
    assert steps == ["3", "5"]
    assert files == sorted(["manifest.json"] + [f"rank{r}.pt" for r in range(world)])
    full, again = runs["uninterrupted"][name], runs["resumed"][name]
    assert [m["step"] for m in again["metrics"]] == [4, 5]
    for key in ("loss", "grad_norm"):
        assert [m[key] for m in again["metrics"]] == [m[key] for m in full["metrics"][3:]]
    for r in range(world):
        _equal_blocks(_blocks(runs["first"][name] / "5", r),
                      _blocks(runs["resumed_dirs"][name] / "5", r))


def test_a_step_saved_at_fsdp_2_restores_onto_other_meshes(runs):
    """fsdp 2's step 5 restored at fsdp 4, at dp 2 x fsdp 2 and onto one
    process: the same global parameters and moments, bit for bit, and the
    one-process restore is the two ranks' blocks laid side by side."""
    one, step = CheckpointManager(str(runs["first"]["fsdp2"])).restore(_template())
    assert step == 5 and one.step == 5
    whole = {"params": one.params, "mu": one.opt_state["mu"], "nu": one.opt_state["nu"]}
    for ranks in runs["resharded"].values():
        for got in ranks:
            assert got["step"] == 5 and got["count"] == one.opt_state["count"]
            for part, tree in whole.items():
                for key, want in _leaves(tree).items():
                    np.testing.assert_array_equal(got["whole"][part][key],
                                                  want.detach().numpy(), err_msg=key)
    specs = _leaves(tree_specs(logical_axes(LlamaConfig.tiny(**DENSE))))
    blocks = [_leaves(_blocks(runs["first"]["fsdp2"] / "5", r)["params"]) for r in range(2)]
    for key, want in _leaves(one.params).items():
        dim = next((d for d, e in enumerate(specs[key]) if e == "fsdp"), None)
        parts = [b[key] for b in blocks]
        joined = parts[0] if dim is None else torch.cat(parts, dim)
        assert torch.equal(joined, want.detach()), key


def test_a_step_saved_at_tp_2_restores_at_fsdp_2_and_in_one_process(runs):
    """tp 2's step 5 restored at fsdp 2 and onto one process: the same
    global parameters and moments, bit for bit, and the one-process
    restore is the two tp ranks' blocks laid side by side along their tp
    dims (tp-replicated leaves, the norms, equal on both)."""
    one, step = CheckpointManager(str(runs["first"]["tp2"])).restore(_template())
    assert step == 5 and one.step == 5
    whole = {"params": one.params, "mu": one.opt_state["mu"], "nu": one.opt_state["nu"]}
    for got in runs["tp2_at_fsdp2"]:
        assert got["step"] == 5 and got["count"] == one.opt_state["count"]
        for part, tree in whole.items():
            for key, want in _leaves(tree).items():
                np.testing.assert_array_equal(got["whole"][part][key],
                                              want.detach().numpy(), err_msg=key)
    specs = _leaves(tree_specs(logical_axes(LlamaConfig.tiny(**DENSE))))
    blocks = [_leaves(_blocks(runs["first"]["tp2"] / "5", r)["params"]) for r in range(2)]
    for key, want in _leaves(one.params).items():
        dim = next((d for d, e in enumerate(specs[key]) if e == "tp"), None)
        parts = [b[key] for b in blocks]
        if dim is None:
            assert torch.equal(parts[0], parts[1]), key
        joined = parts[0] if dim is None else torch.cat(parts, dim)
        assert torch.equal(joined, want.detach()), key


def test_a_step_saved_at_pp_2_restores_at_fsdp_2_and_in_one_process(runs):
    """pp 2's step 5 restored at fsdp 2 and onto one process: the same
    global parameters and moments, bit for bit; each stage's file holds
    its layer of the stack (``pp_rules``), the one-process restore the two
    laid end to end, and the leaves pp does not split equal on both."""
    from tony_tpu_torch.parallel.sharding import pp_rules

    one, step = CheckpointManager(str(runs["first"]["pp2"])).restore(_template())
    assert step == 5 and one.step == 5
    whole = {"params": one.params, "mu": one.opt_state["mu"], "nu": one.opt_state["nu"]}
    for got in runs["pp2_at_fsdp2"]:
        assert got["step"] == 5 and got["count"] == one.opt_state["count"]
        for part, tree in whole.items():
            for key, want in _leaves(tree).items():
                np.testing.assert_array_equal(got["whole"][part][key],
                                              want.detach().numpy(), err_msg=key)
    specs = _leaves(tree_specs(logical_axes(LlamaConfig.tiny(**DENSE)), pp_rules()))
    blocks = [_leaves(_blocks(runs["first"]["pp2"] / "5", r)["params"]) for r in range(2)]
    for key, want in _leaves(one.params).items():
        parts = [b[key] for b in blocks]
        if specs[key][:1] == ("pp",):
            assert parts[0].shape[0] == 1, key
            assert torch.equal(torch.cat(parts, 0), want.detach()), key
        else:
            assert torch.equal(parts[0], parts[1]) and torch.equal(parts[0], want.detach()), key


def test_shards_from_numpy_gives_each_pp_stage_its_layers():
    """``shards_from_numpy`` at pp 2 (and pp 2 x fsdp 2) cuts under
    ``pp_rules``: each stage's block of a stacked layer leaf is its layer,
    as the pp step holds it, each other leaf as at pp 1."""
    from tony_tpu_torch.models.convert import shards_from_numpy
    from tony_tpu_torch.parallel.dist import Axis
    from tony_tpu_torch.parallel.mesh import MESH_AXES, Mesh, MeshShape

    cfg = LlamaConfig.tiny(**DENSE)
    rng = np.random.default_rng(1)
    tree = {k: (rng.standard_normal(v.shape).astype(np.float32) if not isinstance(v, dict)
                else {n: rng.standard_normal(t.shape).astype(np.float32) for n, t in v.items()})
            for k, v in make_train_state(cfg, default_optimizer(), device="cpu").params.items()}
    specs = _leaves(tree_specs(logical_axes(cfg)))
    for shape in (MeshShape(pp=2), MeshShape(pp=2, fsdp=2)):
        for rank in range(shape.n_devices):
            coords = np.unravel_index(rank, shape.sizes)
            mesh = Mesh(shape, rank, {a: Axis(a, n, int(i)) for a, n, i in
                                      zip(MESH_AXES, shape.sizes, coords)})
            got = _leaves(shards_from_numpy(tree, cfg, mesh, device="cpu"))
            for key, want in _leaves(tree).items():
                if key.startswith("layers/"):
                    want = np.split(want, 2, 0)[mesh.axis("pp").index]
                for d, entry in enumerate(specs[key]):
                    if entry == "fsdp" and shape.fsdp > 1:
                        want = np.split(want, 2, d)[mesh.axis("fsdp").index]
                np.testing.assert_array_equal(got[key].numpy(), want, err_msg=key)


def test_shards_from_numpy_gives_each_tp_rank_its_blocks():
    """``shards_from_numpy`` at tp 2 (and fsdp 2 x tp 2): each rank's block
    of every leaf is the numpy tree cut along the dims the rules split,
    tp's blocks in tp index order; the norms whole."""
    from tony_tpu_torch.models.convert import shards_from_numpy
    from tony_tpu_torch.parallel.dist import Axis
    from tony_tpu_torch.parallel.mesh import MESH_AXES, Mesh, MeshShape

    cfg = LlamaConfig.tiny(**DENSE)
    rng = np.random.default_rng(0)
    tree = {k: (rng.standard_normal(v.shape).astype(np.float32) if not isinstance(v, dict)
                else {n: rng.standard_normal(t.shape).astype(np.float32) for n, t in v.items()})
            for k, v in make_train_state(cfg, default_optimizer(), device="cpu").params.items()}
    specs = _leaves(tree_specs(logical_axes(cfg)))
    for shape in (MeshShape(tp=2), MeshShape(fsdp=2, tp=2)):
        for rank in range(shape.n_devices):
            coords = np.unravel_index(rank, shape.sizes)
            mesh = Mesh(shape, rank, {a: Axis(a, n, int(i)) for a, n, i in
                                      zip(MESH_AXES, shape.sizes, coords)})
            got = _leaves(shards_from_numpy(tree, cfg, mesh, device="cpu"))
            for key, want in _leaves(tree).items():
                for d, entry in enumerate(specs[key]):
                    axis = mesh.axis(entry) if isinstance(entry, str) else None
                    if axis is not None and axis.size > 1:
                        want = np.split(want, axis.size, d)[axis.index]
                np.testing.assert_array_equal(got[key].numpy(), want, err_msg=key)


def test_a_killed_save_publishes_nothing_and_is_reaped(runs):
    """Rank 1 killed once its file of step 2 is on disk: rank 0 meets the
    broken group in the save's barrier, step 1 stays the newest published
    step, and the next manager reaps step 2's temp directory."""
    killed = runs["killed"]
    names = killed["listing"]
    assert names[0] == "1" and len(names) == 2 and names[1].startswith("2.tmp-"), names
    assert killed["ranks"][0]["raised"] and killed["ranks"][1] is None
    assert (killed["dir"] / names[1] / "rank1.pt").exists()
    manager = CheckpointManager(str(killed["dir"]))
    assert sorted(p.name for p in killed["dir"].iterdir()) == ["1"]
    assert manager.restore(_template())[1] == 1


def test_an_unreadable_newest_step_falls_back_on_every_rank(runs):
    """Step 5's rank 1 file torn: rank 1 cannot read its blocks, so both
    ranks restore step 3."""
    fell = runs["fell_back"]
    assert [f["step"] for f in fell] == [3, 3]
    assert all(f["state_step"] == 3 and f["count"] == 3 for f in fell)


def test_rank_processes_import_no_jax(runs):
    assert not runs["jax_loaded"]
