"""The port's training path (tony_tpu_torch.train, the training forward of
tony_tpu_torch.models.llama) against the JAX package's, on the tiny float32
config with the production recipe: flash attention, remat with
``save_attn_kernel``, the scan CE head, AdamW.

Parameters cross as numpy (``params_from_numpy``); both sides read the
same synthetic batches. Each test states its tolerance."""

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from tony_tpu.models import llama as jl
from tony_tpu.parallel.mesh import MeshShape, build_mesh
from tony_tpu.train import data as jdata
from tony_tpu.train import trainer as jtrainer
from tony_tpu_torch.models.convert import params_from_numpy
from tony_tpu_torch.models.llama import LlamaConfig, loss_from_pairs
from tony_tpu_torch.ops import fused_ce as ce_ops
from tony_tpu_torch.ops.attention import LAUNCHES, reset_launches
from tony_tpu_torch.parallel.mesh import MeshShape as PortMeshShape
from tony_tpu_torch.train import DataConfig, FitConfig, fit
from tony_tpu_torch.train.checkpoint import CheckpointManager
from tony_tpu_torch.train.data import make_batches, synthetic_batches
from tony_tpu_torch.train.trainer import (
    default_optimizer, make_train_state, make_train_step, tree_leaves,
)

RECIPE = dict(attention_impl="flash", remat=True, remat_policy="save_attn_kernel",
              ce_impl="scan", flash_block_q=16, flash_block_k=16)
DATA = dict(global_batch=2, seq_len=32, vocab_size=256)


def _jax_params(jcfg):
    return jl.init_params(jax.random.key(0), jcfg)


def test_five_steps_match_jax_make_train_step():
    """Per-step loss and grad norm of the port's step against the JAX
    ``make_train_step`` on a one-device CPU mesh, five steps from the same
    params and batches, within 1e-4 (absolute and relative). float32 on
    both sides: only the order of sums differs (the reference's flash
    kernels run blockwise in interpret mode, the port's plain versions in
    one pass)."""
    jcfg = jl.LlamaConfig.tiny(**RECIPE)
    mesh = build_mesh(MeshShape(), devices=jax.devices()[:1])
    jopt = jtrainer.default_optimizer(lr=5e-3, warmup_steps=2, decay_steps=5)
    jstate = jtrainer.make_train_state(jax.random.key(0), jcfg, mesh, jopt)
    tree = jax.tree.map(np.asarray, jstate.params)
    jstep = jtrainer.make_train_step(jcfg, mesh, jopt)

    cfg = LlamaConfig.tiny(**RECIPE)
    opt = default_optimizer(lr=5e-3, warmup_steps=2, decay_steps=5)
    state = make_train_state(cfg, opt, params=params_from_numpy(tree, cfg, device="cpu"))
    step = make_train_step(cfg, opt)

    jb = jdata.synthetic_batches(jdata.DataConfig(**DATA))
    pb = synthetic_batches(DataConfig(**DATA))
    for i in range(5):
        ji, jt = next(jb)
        jstate, jm = jstep(jstate, ji, jt)
        state, m = step(state, *next(pb))
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-4,
                                       atol=1e-4, err_msg=f"step {i} {key}")
        assert m["step"] == int(jm["step"]) == i + 1
    want = jax.tree.map(np.asarray, jstate.params)
    got = params_from_numpy(want, cfg, device="cpu")
    for a, b in zip(tree_leaves(state.params), tree_leaves(got)):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), atol=1e-4, rtol=1e-3)


def test_pallas_ce_ten_steps_match_jax_make_train_step():
    """``ce_impl="pallas"`` (the CE kernels' plain versions here; the
    reference's kernels in interpret mode) with the card run's schedule
    (warmup 2 to lr 3e-4, ten steps): per-step loss and grad norm within
    1e-4 of JAX's ``make_train_step`` with the same knobs, float32 on
    both sides. ``ce_block_v`` 96 leaves a padded vocab tile (V 256)."""
    knobs = {**RECIPE, "ce_impl": "pallas", "ce_block_n": 32, "ce_block_v": 96}
    jcfg = jl.LlamaConfig.tiny(**knobs)
    mesh = build_mesh(MeshShape(), devices=jax.devices()[:1])
    jopt = jtrainer.default_optimizer(lr=3e-4, warmup_steps=2, decay_steps=10)
    jstate = jtrainer.make_train_state(jax.random.key(0), jcfg, mesh, jopt)
    tree = jax.tree.map(np.asarray, jstate.params)
    jstep = jtrainer.make_train_step(jcfg, mesh, jopt)

    cfg = LlamaConfig.tiny(**knobs)
    opt = default_optimizer(lr=3e-4, warmup_steps=2, decay_steps=10)
    state = make_train_state(cfg, opt, params=params_from_numpy(tree, cfg, device="cpu"))
    step = make_train_step(cfg, opt)

    jb = jdata.synthetic_batches(jdata.DataConfig(**DATA))
    pb = synthetic_batches(DataConfig(**DATA))
    ce_ops.reset_launches()
    for i in range(10):
        jstate, jm = jstep(jstate, *next(jb))
        state, m = step(state, *next(pb))
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-4,
                                       atol=1e-4, err_msg=f"step {i} {key}")
    assert {k: v for k, v in ce_ops.LAUNCHES.items() if v} == {
        "ce_fwd_plain": 10, "ce_dh_plain": 10, "ce_dw_plain": 10}


def _grads(cfg, params, inputs, targets):
    leaves = [p.detach().clone().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)

    def rebuild(tree):
        return {k: rebuild(v) if isinstance(v, dict) else next(it) for k, v in tree.items()}

    loss = loss_from_pairs(rebuild(params), inputs, targets, cfg)
    return loss, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("policy", ["nothing", "save_attn", "save_gate",
                                    "save_attn_kernel", "save_flash_gate"])
def test_remat_policies_give_the_same_grads(policy):
    """Remat on (each policy) and off give the same loss and grads, within
    1e-6: the same float32 ops run, recomputed or not. Under a policy that
    keeps ``flash_res`` the backward never re-runs the forward kernel
    (its plain version here): one forward per layer."""
    base = LlamaConfig.tiny(**{**RECIPE, "remat": False})
    tree = jax.tree.map(np.asarray, _jax_params(jl.LlamaConfig.tiny()))
    params = params_from_numpy(tree, base, device="cpu")
    inputs, targets = next(synthetic_batches(DataConfig(**DATA)))
    loss0, g0 = _grads(base, params, inputs, targets)
    reset_launches()
    loss, g = _grads(dataclasses.replace(base, remat=True, remat_policy=policy),
                     params, inputs, targets)
    assert abs(loss.item() - loss0.item()) <= 1e-6
    for a, b in zip(g, g0):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    fwd = 1 if policy in ("save_attn_kernel", "save_flash_gate") else 2
    assert LAUNCHES["flash_fwd_plain"] == fwd * base.n_layers
    assert LAUNCHES["flash_dq_plain"] == LAUNCHES["flash_dkv_plain"] == base.n_layers
    assert LAUNCHES["flash_fwd"] == LAUNCHES["flash_dq"] == LAUNCHES["flash_dkv"] == 0


def test_loss_and_grads_match_jax_value_and_grad():
    """The port's loss and every grad against ``jax.value_and_grad`` of the
    reference's ``loss_from_pairs`` (flash + scan CE, GQA 4/2), within 1e-5
    absolute / 1e-4 relative: float32, sums in another order."""
    jcfg = jl.LlamaConfig.tiny(**RECIPE)
    jparams = _jax_params(jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    inputs, targets = next(synthetic_batches(DataConfig(**DATA)))
    jloss, jgrads = jax.value_and_grad(jl.loss_from_pairs)(
        jparams, inputs.numpy(), targets.numpy(), jcfg)
    cfg = LlamaConfig.tiny(**RECIPE)
    loss, grads = _grads(cfg, params_from_numpy(tree, cfg, device="cpu"), inputs, targets)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5, atol=1e-5)
    want = tree_leaves(params_from_numpy(jax.tree.map(np.asarray, jgrads), cfg,
                                         device="cpu"))
    for a, b in zip(grads, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("start", [0, 3])
def test_synthetic_batches_equal_the_reference(start):
    """Token for token (exact): same seed, same stream, same resume point."""
    cfg = dict(global_batch=3, seq_len=16, vocab_size=300, seed=7)
    jb = jdata.synthetic_batches(jdata.DataConfig(**cfg), start_step=start)
    pb = synthetic_batches(DataConfig(**cfg), start_step=start)
    for _ in range(3):
        (ji, jt), (pi, pt) = next(jb), next(pb)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
        assert pi.dtype == torch.int32


def test_prefetched_stream_equals_the_synchronous_one():
    """The prefetch thread keeps the stream's order exactly."""
    cfg = DataConfig(**DATA, prefetch=3)
    a = make_batches(cfg, device="cpu")
    b = make_batches(dataclasses.replace(cfg, prefetch=0), device="cpu")
    try:
        for _ in range(5):
            for x, y in zip(next(a), next(b)):
                torch.testing.assert_close(x, y, atol=0, rtol=0)
    finally:
        a.close()


def _fit_cfg(steps, **kw):
    # warmup past the last step: the schedule's decay length follows
    # cfg.steps (as in the reference), so only a run still warming up
    # has the same learning rates whether it is cut at step 4 or not
    return FitConfig(model=LlamaConfig.tiny(**RECIPE), data=DataConfig(**DATA),
                     steps=steps, log_every=1, lr=5e-3, warmup_steps=10, **kw)


def test_fit_loss_decreases_tiny_model():
    """fit() on the CPU: the loss falls below the uniform ceiling
    ln(256) = 5.55, to < 5.2 as the reference's own fit test requires."""
    cfg = FitConfig(model=LlamaConfig.tiny(**RECIPE),
                    data=DataConfig(global_batch=4, seq_len=32, vocab_size=256),
                    steps=40, log_every=20, lr=5e-3, warmup_steps=2)
    final = fit(cfg, device="cpu")
    assert math.isfinite(final["final_loss"])
    assert final["final_loss"] < 5.2 < math.log(256)
    assert final["mfu"] is None                 # no card, no peak to hold it to
    assert final["step_time_p50_s"] > 0


def test_checkpoint_resume_reproduces_the_trajectory(tmp_path):
    """Eight steps straight against four, a checkpoint, and a resumed run
    to eight: the same per-step losses, within 1e-6 (the same float32 ops
    from the same state and the same batches)."""
    straight: list = []
    fit(_fit_cfg(8, on_metrics=straight.append), device="cpu")
    ckpt = str(tmp_path / "ckpt")
    first: list = []
    fit(_fit_cfg(4, checkpoint_dir=ckpt, checkpoint_every=2,
                 on_metrics=first.append), device="cpu")
    mgr = CheckpointManager(ckpt)
    assert mgr.all_steps() == [2, 4]
    second: list = []
    fit(_fit_cfg(8, checkpoint_dir=ckpt, checkpoint_every=2,
                 on_metrics=second.append), device="cpu")
    assert [m["step"] for m in second] == [5, 6, 7, 8]
    resumed = [m["loss"] for m in first + second]
    np.testing.assert_allclose(resumed, [m["loss"] for m in straight], atol=1e-6)
    assert CheckpointManager(ckpt, keep=3).all_steps() == [4, 6, 8]


def test_checkpoint_falls_back_and_reaps(tmp_path):
    """An unreadable newest step falls back to the previous one; a
    killed save's temp directory is reaped on open."""
    cfg = LlamaConfig.tiny()
    opt = default_optimizer()
    state = make_train_state(cfg, opt, device="cpu")
    mgr = CheckpointManager(str(tmp_path), save_interval_steps=1)
    state.step = 1
    assert mgr.save(1, state)
    state.step = 2
    assert mgr.save(2, state)
    assert not mgr.save(2, state)               # already there
    (tmp_path / "2" / "state.pt").write_bytes(b"torn")
    (tmp_path / "3.tmp-999").mkdir()
    mgr = CheckpointManager(str(tmp_path))
    assert not (tmp_path / "3.tmp-999").exists()
    restored, step = mgr.restore(state)
    assert step == 1 and restored.step == 1
    with pytest.raises(Exception):
        mgr.restore(state, step=2)


def test_entry_points_need_cuda_or_an_explicit_cpu():
    """With no device, the entry points run on CUDA and raise without it;
    what the slice does not port raises NotImplementedError."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    opt = default_optimizer()
    with pytest.raises(RuntimeError, match="CUDA"):
        fit(FitConfig(steps=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_state(LlamaConfig.tiny(), opt)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_batches(DataConfig())
    with pytest.raises(NotImplementedError, match="item 8"):
        fit(FitConfig(mesh_shape=PortMeshShape(tp=2)), device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        fit(FitConfig(mesh_shape=PortMeshShape(sp=2, fsdp=2)), device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        fit(FitConfig(pp_microbatches=4), device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        fit(FitConfig(elastic_members=2), device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        make_train_step(LlamaConfig.tiny_moe(moe_overlap_impl="scan"), opt)
    with pytest.raises(NotImplementedError, match="dots"):
        make_train_step(LlamaConfig.tiny(remat=True, remat_policy="dots"), opt)
    with pytest.raises(NotImplementedError, match="native"):
        make_batches(DataConfig(path="tokens.bin"), device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        make_train_step(LlamaConfig.tiny(), opt, n_microbatches=2)
