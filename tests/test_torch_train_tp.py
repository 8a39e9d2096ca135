"""The port's training over tp meshes (Megatron's column- and row-parallel
trunk, tony_tpu_torch.train with parallel/dist.py's tp collectives)
against the JAX package's step on the same CPU mesh, and against the
port's own one-rank step, on the CPU.

Five float32 steps of the tiny config (4 heads, 2 kv heads) at tp 2 (the
production recipe: flash, remat ``save_attn_kernel``, the pallas CE head,
its plain versions here), tp 4 (the GQA branch: tp does not divide the kv
heads, so wk and wv reach the trunk whole), fsdp 2 x tp 2 with the fsdp
ring off and in its pallas form (the plain chunk), and dp 2 x tp 2;
tolerances in ``tests/torch_mesh_parity.py``. The reference's pallas CE
head does not trace over a multi-device mesh under this jax line (its
custom VJP's varying manual axes differ), so tp 2 is held against the
reference's scan head there, as the one-device tests hold the two heads
within 1e-5 of each other; the ring runs the reference's scan form
wherever the port runs its pallas form, as ``test_torch_train_fsdp.py``
does."""

import pytest

from torch_mesh_parity import (
    assert_run_matches, port_one_rank, port_runs, reference_params, reference_run,
)

RECIPE = dict(attention_impl="flash", flash_block_q=16, flash_block_k=16, remat=True,
              remat_policy="save_attn_kernel")
DOT = {"attention_impl": "dot"}
# name -> (mesh, the port's model knobs, the reference's model knobs)
CONFIGS = {
    "tp2": ({"tp": 2}, {**RECIPE, "ce_impl": "pallas"}, RECIPE),
    "tp4": ({"tp": 4}, {"attention_impl": "flash"}, {"attention_impl": "flash"}),
    "fsdp2-tp2": ({"fsdp": 2, "tp": 2}, DOT, DOT),
    "fsdp2-tp2-pallas": ({"fsdp": 2, "tp": 2}, {**DOT, "overlap_impl": "pallas"},
                         {**DOT, "overlap_impl": "scan"}),
    "dp2-tp2": ({"dp": 2, "tp": 2}, DOT, DOT),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    tree, path = reference_params(tmp)
    port = port_runs(CONFIGS, path, tmp)
    ref = {name: reference_run(mesh_d, ref_knobs)
           for name, (mesh_d, _, ref_knobs) in CONFIGS.items()}
    one = {name: port_one_rank(knobs, tree) for name, (_, knobs, _) in CONFIGS.items()}
    return port, ref, one


@pytest.mark.parametrize("name", list(CONFIGS))
def test_steps_match_the_reference_on_the_same_mesh(runs, name):
    port, ref, _ = runs
    assert_run_matches(port[name], ref[name], name)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_steps_match_the_ports_one_rank_step(runs, name):
    port, _, one = runs
    assert_run_matches(port[name], one[name], name)


def test_tp_ranks_launch_the_one_rank_kernels(runs):
    """At tp 2 under the production recipe each rank runs the flash
    passes once per layer a step on its heads (remat never re-runs the
    forward) and the CE head once a step on the whole vocabulary, as the
    one-rank step does: the same count on each rank, here the plain
    versions (CPU tensors)."""
    port, _, one = runs
    want = one["tp2"]["kernels"]
    assert want[0]["flash_fwd_plain"] == 2 and want[0]["ce_fwd_plain"] == 1
    for r in port["tp2"]:
        assert r["kernels"] == want


def test_rank_processes_import_no_jax(runs):
    port, _, _ = runs
    assert not port["jax_loaded"]
