"""The port's training over sp meshes (the sequence split over sp, each
attention hook's way of meeting it) against the JAX package's step on the
same CPU mesh, and against the port's own one-rank step, on the CPU.

Five float32 steps of the tiny config at sp 2 under each of ``dot`` and
``flash`` (the sequence gathered), ``ring``, ``ring_flash`` (under remat
``save_attn_kernel``, so its forward is kept and never re-run) and
``ulysses``, and at tp 2 x sp 2 under ``ring_flash``; tolerances in
``tests/torch_mesh_parity.py``. Then MoE at fsdp 2 x ep 2 x sp 2 (eight
ranks): the first step's loss against the reference's one-device loss on
the same batch within 1e-4 (the reference's own check of its ep x sp
sharding, ``tests/test_parallel.py``), and its aux within 1e-6 of the
port's one-rank aux."""

import numpy as np
import pytest

from torch_mesh_parity import (
    DATA, assert_run_matches, port_one_rank, port_runs, reference_params, reference_run,
)
from torch_ranks import spawn

REMAT = dict(remat=True, remat_policy="save_attn_kernel")
# name -> (mesh, model knobs of both packages)
CONFIGS = {
    "sp2-dot": ({"sp": 2}, {"attention_impl": "dot"}),
    "sp2-flash": ({"sp": 2}, {"attention_impl": "flash"}),
    "sp2-ring": ({"sp": 2}, {"attention_impl": "ring"}),
    "sp2-ring_flash": ({"sp": 2}, {"attention_impl": "ring_flash", **REMAT}),
    "sp2-ulysses": ({"sp": 2}, {"attention_impl": "ulysses"}),
    "tp2-sp2-ring_flash": ({"tp": 2, "sp": 2}, {"attention_impl": "ring_flash"}),
}
MOE = {"attention_impl": "dot", "n_experts": 4}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp")
    tree, path = reference_params(tmp)
    moe_tree, moe_path = reference_params(tmp, key=1, n_experts=4)
    port = port_runs(CONFIGS, path, tmp)
    # one step of MoE at fsdp 2 x ep 2 x sp 2 from key 1's parameters
    moe_run = {"mesh": {"fsdp": 2, "ep": 2, "sp": 2}, "steps": 1,
               "data": {**DATA, "global_batch": 8}, "opt": {"lr": 5e-3},
               "params": moe_path, "model": MOE}
    port["moe"] = [r["runs"][0] for r in spawn(8, "train", {"runs": [moe_run]}, tmp / "w8")]
    ref = {name: reference_run(mesh_d, knobs) for name, (mesh_d, knobs) in CONFIGS.items()}
    one = {name: port_one_rank(knobs, tree) for name, (_, knobs) in CONFIGS.items()}
    return port, ref, one, moe_tree


@pytest.mark.parametrize("name", list(CONFIGS))
def test_steps_match_the_reference_on_the_same_mesh(runs, name):
    port, ref, _, _ = runs
    assert_run_matches(port[name], ref[name], name)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_steps_match_the_ports_one_rank_step(runs, name):
    port, _, one, _ = runs
    assert_run_matches(port[name], one[name], name)


def test_ring_flash_launches_per_rank(runs):
    """Under ``ring_flash`` sp index i runs its i + 1 chunk pairs a layer:
    the forward once (remat keeps it), dq and dk/dv once each, and
    nothing for the pair whose keys lie after its queries; the plain
    versions here (CPU tensors)."""
    port, _, _, _ = runs
    layers = 2
    for rank, r in enumerate(port["sp2-ring_flash"]):
        n = layers * (rank + 1)
        for step in r["kernels"]:
            assert {k: step[k] for k in ("flash_fwd_plain", "flash_dq_plain",
                                         "flash_dkv_plain", "flash_fwd")} == {
                "flash_fwd_plain": n, "flash_dq_plain": n, "flash_dkv_plain": n,
                "flash_fwd": 0}, (rank, step)


def test_moe_at_fsdp2_ep2_sp2_matches_the_one_device_loss(runs):
    """The MoE step's loss (the global batch's, before the update) against
    the reference's ``loss_from_pairs`` of its unsharded model on the same
    batch, within 1e-4; its aux (the router's statistics summed over dp,
    fsdp, ep and sp) within 1e-6 of the port's one-rank aux."""
    import torch

    from tony_tpu.models import llama as jl
    from tony_tpu.train import data as jdata
    from tony_tpu_torch.models import llama as pl
    from tony_tpu_torch.models.convert import params_from_numpy

    port, _, _, tree = runs
    data = {**DATA, "global_batch": 8}
    inputs, targets = next(jdata.synthetic_batches(jdata.DataConfig(**data)))
    want = float(jl.loss_from_pairs(tree, inputs, targets, jl.LlamaConfig.tiny(**MOE)))
    cfg = pl.LlamaConfig.tiny(**MOE)
    with torch.no_grad():
        _, aux = pl.loss_and_aux(params_from_numpy(tree, cfg, device="cpu"),
                                 torch.from_numpy(np.asarray(inputs)),
                                 torch.from_numpy(np.asarray(targets)), cfg)
    for r in port["moe"]:
        assert abs(r["loss"][0] - want) < 1e-4, (r["loss"][0], want)
        assert abs(r["aux"][0] - float(aux)) < 1e-6, (r["aux"][0], float(aux))


def test_rank_processes_import_no_jax(runs):
    port, _, _, _ = runs
    assert not port["jax_loaded"]
    assert not any(r.get("jax_loaded") for r in port["moe"])
