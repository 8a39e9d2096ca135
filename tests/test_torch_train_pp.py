"""The port's training over pp meshes (``parallel/pipeline.py`` under
``train/trainer.py``, GPipe and 1F1B) against the JAX package's pp step on
the same CPU mesh, on the CPU.

Five float32 steps of the tiny config at 4 layers from the reference's
parameters: pp 2 under both schedules (flash attention and remat; the
port's pallas CE head, its plain version here, against the reference's
scan head, as ``tests/test_torch_train_tp.py`` holds them), pp 4 under
1f1b, pp 2 x dp 2 under gpipe, pp 2 x fsdp 2 x tp 2 under both (eight
ranks), and MoE (``moe_aux_coef`` 0.01, four experts) at pp 2 x ep 2
under gpipe; then pp 2 x sp 2 under ``dot`` and ``flash`` against the
port's own step at sp 2 without pp. Tolerances in
``tests/torch_mesh_parity.py``. Where the batch axes split the rows, two
microbatches: a microbatch is a block of the global batch's rows, cut
over those axes."""

import pytest

from torch_mesh_parity import assert_run_matches, port_runs, reference_params, reference_run

L4 = {"n_layers": 4}
RECIPE = {**L4, "attention_impl": "flash", "flash_block_q": 16, "flash_block_k": 16,
          "remat": True}
DOT = {**L4, "attention_impl": "dot"}
MOE = {**DOT, "n_experts": 4, "moe_aux_coef": 0.01}
# name -> (mesh, the port's model knobs, the reference's, pipeline arguments)
CONFIGS = {
    "pp2-gpipe": ({"pp": 2}, {**RECIPE, "ce_impl": "pallas"}, RECIPE, {}),
    "pp2-1f1b": ({"pp": 2}, {**RECIPE, "ce_impl": "pallas"}, RECIPE,
                 {"pp_schedule": "1f1b"}),
    "pp4-1f1b": ({"pp": 4}, DOT, DOT, {"pp_schedule": "1f1b", "microbatches": 4}),
    "pp2-dp2-gpipe": ({"pp": 2, "dp": 2}, DOT, DOT, {"microbatches": 2}),
    "pp2-fsdp2-tp2-gpipe": ({"pp": 2, "fsdp": 2, "tp": 2}, DOT, DOT, {"microbatches": 2}),
    "pp2-fsdp2-tp2-1f1b": ({"pp": 2, "fsdp": 2, "tp": 2}, DOT, DOT,
                           {"pp_schedule": "1f1b", "microbatches": 2}),
}
MOE_CONFIG = ({"pp": 2, "ep": 2}, MOE, MOE, {"microbatches": 2})
# the port alone: pp 2 x sp 2 against sp 2
SP = {"sp2-dot": ({"sp": 2}, DOT, None, {}),
      "pp2-sp2-dot": ({"pp": 2, "sp": 2}, DOT, None, {"microbatches": 2}),
      "sp2-flash": ({"sp": 2}, {**L4, "attention_impl": "flash"}, None, {}),
      "pp2-sp2-flash": ({"pp": 2, "sp": 2}, {**L4, "attention_impl": "flash"}, None,
                        {"pp_schedule": "1f1b", "microbatches": 2})}


def _ref_kwargs(step: dict) -> dict:
    return {"pp_schedule": step.get("pp_schedule", "gpipe"),
            "n_microbatches": step.get("microbatches", 0)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp")
    _, path = reference_params(tmp, **L4)
    _, moe_path = reference_params(tmp, key=1, **MOE)
    dense = {**CONFIGS, **SP}
    port = port_runs({n: c[:2] for n, c in dense.items()}, path, tmp,
                     {n: c[3] for n, c in dense.items()})
    moe = port_runs({"moe": MOE_CONFIG[:2]}, moe_path, tmp / "moe", {"moe": MOE_CONFIG[3]})
    port["moe"] = moe["moe"]
    port["jax_loaded"] |= moe["jax_loaded"]
    ref = {name: reference_run(mesh_d, ref_knobs, **_ref_kwargs(step))
           for name, (mesh_d, _, ref_knobs, step) in CONFIGS.items()}
    ref["moe"] = reference_run(MOE_CONFIG[0], MOE_CONFIG[2], key=1,
                               **_ref_kwargs(MOE_CONFIG[3]))
    return port, ref


@pytest.mark.parametrize("name", list(CONFIGS))
def test_steps_match_the_reference_on_the_same_mesh(runs, name):
    port, ref = runs
    assert_run_matches(port[name], ref[name], name)


def test_moe_at_pp2_ep2_matches_the_reference(runs):
    """MoE under GPipe: the router's statistics are each microbatch's (all
    of its rows, over the ranks that run it), as the reference's per-
    microbatch aux; no route within 1e-4 of flipping."""
    port, ref = runs
    assert all(r["margin"] > 1e-4 for r in port["moe"]), [r["margin"] for r in port["moe"]]
    assert_run_matches(port["moe"], ref["moe"], "moe")


@pytest.mark.parametrize("impl", ["dot", "flash"])
def test_pp2_sp2_matches_the_ports_sp2_step(runs, impl):
    port, _ = runs
    assert_run_matches(port[f"pp2-sp2-{impl}"], {
        "loss": port[f"sp2-{impl}"][0]["loss"],
        "grad_norm": port[f"sp2-{impl}"][0]["grad_norm"],
        "params": port[f"sp2-{impl}"][0]["params"]}, f"pp2-sp2-{impl}")


def test_pp2_ranks_launch_the_flash_and_ce_passes_the_schedule_implies(runs):
    """Per rank and step at pp 2 (2 layers a stage, 4 microbatches, remat
    saving nothing in a stage), the plain versions here (CPU tensors).
    GPipe: the flash forward twice a layer and microbatch (the forward
    and the block's remat), dq and dk/dv once; the CE head once on every
    rank over the broadcast outputs. 1F1B: the first stage runs each
    microbatch's forward slot, its backward slot's recompute and the
    block's remat (3 forwards), the last stage no forward slot (2); the
    CE head on the last stage alone, once a microbatch."""
    port, _ = runs
    per_stage, M = 2, 4
    for rank, r in enumerate(port["pp2-gpipe"]):
        for step in r["kernels"]:
            assert {k: step[k] for k in ("flash_fwd_plain", "flash_dq_plain",
                                         "flash_dkv_plain", "ce_fwd_plain")} == {
                "flash_fwd_plain": 2 * per_stage * M, "flash_dq_plain": per_stage * M,
                "flash_dkv_plain": per_stage * M, "ce_fwd_plain": 1}, (rank, step)
    for rank, r in enumerate(port["pp2-1f1b"]):
        for step in r["kernels"]:
            assert {k: step[k] for k in ("flash_fwd_plain", "flash_dq_plain",
                                         "ce_fwd_plain")} == {
                "flash_fwd_plain": (3 - rank) * per_stage * M,
                "flash_dq_plain": per_stage * M, "ce_fwd_plain": rank * M}, (rank, step)


def test_rank_processes_import_no_jax(runs):
    port, _ = runs
    assert not port["jax_loaded"]



def test_batches_are_laid_out_by_global_microbatch():
    """``make_batches(mesh=, microbatches=M)`` at dp 2 x pp 2 x fsdp 2: a
    rank's rows are its block of each global microbatch in turn
    (microbatch i the global batch's rows ``[i B/M, (i + 1) B/M)``, cut
    over dp and fsdp), not the i-th M-th of a contiguous block; every pp
    rank of a block gets the same rows; at M 1 the contiguous block; a
    microbatch the batch axes do not split raises."""
    import numpy as np

    from tony_tpu_torch.parallel.dist import Axis
    from tony_tpu_torch.parallel.mesh import MESH_AXES, Mesh, MeshShape
    from tony_tpu_torch.train.data import DataConfig, make_batches, synthetic_batches

    cfg = DataConfig(global_batch=8, seq_len=4, vocab_size=256, prefetch=0)
    whole = next(synthetic_batches(cfg))[0].numpy()
    shape = MeshShape(dp=2, pp=2, fsdp=2)

    def rank_mesh(rank):
        coords = dict(zip(MESH_AXES, (int(c) for c in np.unravel_index(rank, shape.sizes))))
        return coords, Mesh(shape, rank, {a: Axis(a, n, coords[a])
                                          for a, n in zip(MESH_AXES, shape.sizes)})

    for M, want in ((1, lambda b: [2 * b, 2 * b + 1]), (2, lambda b: [b, 4 + b])):
        for rank in range(shape.n_devices):
            coords, mesh = rank_mesh(rank)
            got = next(make_batches(cfg, device="cpu", mesh=mesh, microbatches=M))[0]
            rows = want(coords["dp"] * 2 + coords["fsdp"])    # block of 4 over (dp, fsdp)
            np.testing.assert_array_equal(got.numpy(), whole[rows], err_msg=f"M {M} {coords}")
    with pytest.raises(ValueError, match="even blocks"):
        make_batches(cfg, device="cpu", mesh=rank_mesh(0)[1], microbatches=4)
