"""The port's pipeline schedules (``tony_tpu_torch/parallel/pipeline.py``)
on gloo ranks against the JAX package's on its CPU mesh, on the CPU.

- ``pipeline_apply`` (GPipe) on the toy stages of the reference's
  ``TestPipeline`` (``tanh(h @ W)``, one weight a stage): the outputs, and
  the gradients of ``sum(out ** 2)`` for the stacked weights and the
  input; ``pipeline_train_1f1b`` on those of its ``Test1F1B`` (the same
  stage, a CE head): the loss, and the gradients for the stage weights,
  the head and the input. P 2 and 4, with M below, at and above P. The
  reference's 1F1B tolerance, atol 1e-6, at unit scale: an array whose
  largest magnitude exceeds 1 is held to 1e-6 of it (GPipe's weight
  gradients of ``sum(out ** 2)`` reach 21, where float32's ulp is 1.9e-6
  and the two packages sum the microbatches in another order; the
  reference holds its own GPipe gradients to 1e-4).
- The 1F1B memory claim, the counterpart of the reference's
  ``test_pp_1f1b_memory_is_microbatch_independent``: at P 4, M 32 the
  trainer's 1F1B loss holds under a fifth of the bytes for the backward
  that its GPipe loss holds, at their peaks.
- The refusals read as the reference's: ring, ring_flash and Ulysses
  attention under pp, 1f1b with MoE, a layer count pp does not split, and
  an unknown schedule.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh

from torch_ranks import spawn

# (kind, P, M): GPipe's forward case and backward case, and 1F1B's four,
# at P 2 and 4 (the reference's P 8 case runs at 4), plus M below P
CASES = [("gpipe", 4, 8, 16), ("gpipe", 4, 4, 8), ("gpipe", 4, 3, 8), ("gpipe", 2, 1, 8),
         ("1f1b", 2, 2, 8), ("1f1b", 4, 1, 8), ("1f1b", 4, 6, 8), ("1f1b", 2, 5, 8)]


def _name(kind, P, M, D):
    return f"{kind}-{P}-{M}-{D}"


def _inputs(kind, P, M, D, mb=2):
    """The reference tests' draws: stage weights from key 0 (GPipe) or 1
    (1F1B), inputs from key 9 / 2, the head from key 3, targets from 4."""
    keys = jax.random.split(jax.random.key(0 if kind == "gpipe" else 1), P)
    out = {"Ws": np.asarray(jnp.stack([jax.random.normal(k, (D, D)) * 0.3 for k in keys]))}
    if kind == "gpipe":
        out["x"] = np.asarray(jax.random.normal(jax.random.key(9), (M * mb, D)))
    else:
        out["x"] = np.asarray(jax.random.normal(jax.random.key(2), (M * mb, 4, D)))
        out["head"] = np.asarray(jax.random.normal(jax.random.key(3), (D, 5)) * 0.3)
        out["tgt"] = np.asarray(jax.random.randint(jax.random.key(4), (M * mb, 4), 0, 5))
    return out


def _head_fn(hw, y, t):
    logits = y @ hw
    lse = jax.scipy.special.logsumexp(logits, axis=-1)
    sel = jnp.take_along_axis(logits, t[..., None], axis=-1)[..., 0]
    return jnp.mean(lse - sel)


def _reference(kind, P, M, data):
    """The reference's schedule on a P-device CPU mesh, jitted."""
    from tony_tpu.parallel import microbatch, pipeline_apply, pipeline_train_1f1b, unmicrobatch

    mesh = JMesh(np.array(jax.devices()[:P]).reshape(P), ("pp",))
    Ws, x = jnp.asarray(data["Ws"]), jnp.asarray(data["x"])
    if kind == "gpipe":
        def run(Ws_, x_):
            return unmicrobatch(pipeline_apply(lambda W, h: jnp.tanh(h @ W), Ws_,
                                               microbatch(x_, M), mesh=mesh))

        out = jax.jit(run)(Ws, x)
        gW, gx = jax.jit(jax.grad(lambda a, b: jnp.sum(run(a, b) ** 2), (0, 1)))(Ws, x)
        return {"out": out, "Ws": gW, "x": gx}
    tgt = jnp.asarray(data["tgt"])

    def loss(Ws_, hw, x_):
        return pipeline_train_1f1b(lambda W, h: jnp.tanh(h @ W[0]), _head_fn, Ws_, hw,
                                   microbatch(x_, M), microbatch(tgt, M), mesh=mesh)

    hw = jnp.asarray(data["head"])
    value = jax.jit(loss)(Ws, hw, x)
    gW, gh, gx = jax.jit(jax.grad(loss, (0, 1, 2)))(Ws, hw, x)
    return {"loss": value, "Ws": gW, "head": gh, "x": gx}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    data = {c: _inputs(*c) for c in CASES}
    path = tmp / "inputs.npz"
    np.savez(path, **{f"{_name(*c)}/{k}": v for c, d in data.items() for k, v in d.items()})
    port = {}
    for P in (2, 4):
        cases = [c for c in CASES if c[1] == P]
        run = {"mesh": {"pp": P}, "inputs": str(path),
               "cases": [{"name": _name(*c), "kind": c[0], "M": c[2]} for c in cases]}
        # the 1F1B memory run: the trainer's losses at P 4, M 32
        runs_ = [run] + ([{"task": "pp_memory", "mesh": {"pp": 4}, "microbatches": 32,
                           "model": {"n_layers": 4},
                           "data": {"global_batch": 64, "seq_len": 16, "vocab_size": 256}}]
                         if P == 4 else [])
        ranks = spawn(P, "pipeline", {"runs": runs_}, tmp / f"p{P}")
        for j, c in enumerate(cases):
            port[c] = [r["runs"][0]["cases"][j] for r in ranks]
        if P == 4:
            port["memory"] = [r["runs"][1] for r in ranks]
        port.setdefault("jax_loaded", False)
        port["jax_loaded"] |= any(r["jax_loaded"] or r["tony_tpu_loaded"] for r in ranks)
    ref = {c: _reference(c[0], c[1], c[2], data[c]) for c in CASES}
    return port, ref


@pytest.mark.parametrize("case", CASES, ids=[_name(*c) for c in CASES])
def test_schedule_matches_the_reference(runs, case):
    """Every rank: the values and every gradient within 1e-6 of the
    reference's at unit scale (1e-6 of the array's largest magnitude above
    1)."""
    port, ref = runs
    want = ref[case]
    for rank, got in enumerate(port[case]):
        for key, value in want.items():
            value = np.asarray(value)
            tol = 1e-6 * max(1.0, float(np.abs(value).max()))
            np.testing.assert_allclose(got[key], value, atol=tol, rtol=0,
                                       err_msg=f"{case} rank {rank} {key}")


def test_1f1b_holds_a_fifth_of_gpipes_bytes_for_the_backward(runs):
    """P 4, M 32 (tiny, 4 layers, 64 x 16 tokens): on every stage the 1F1B
    loss's peak of bytes saved for the backward is under a fifth of the
    GPipe loss's (which keeps all 32 microbatches' stage graphs until the
    backward), and the two losses agree."""
    port, _ = runs
    for rank, got in enumerate(port["memory"]):
        gpipe, one = got["gpipe"]["peak_bytes"], got["1f1b"]["peak_bytes"]
        assert one < gpipe / 5, (rank, gpipe, one)
        assert abs(got["gpipe"]["loss"] - got["1f1b"]["loss"]) < 1e-5


def test_rank_processes_import_no_jax(runs):
    port, _ = runs
    assert not port["jax_loaded"]


def _refusal(fn) -> tuple[type, str]:
    with pytest.raises((NotImplementedError, ValueError)) as err:
        fn()
    return err.type, str(err.value)


@pytest.mark.parametrize("case", ["ring", "ring_flash", "ulysses", "1f1b-moe", "layers",
                                  "schedule"])
def test_refusals_read_as_the_references(case):
    """The port's refusal and the reference's: the same exception type and
    message, from the port's ``make_train_step`` (and ``fit()``'s checks)
    and the reference's pp loss / ``make_train_step``."""
    from tony_tpu.models.llama import LlamaConfig as JConfig
    from tony_tpu.parallel.mesh import MeshShape as JShape, build_mesh as jbuild
    from tony_tpu.train import trainer as jtrainer
    from tony_tpu_torch.models.llama import LlamaConfig
    from tony_tpu_torch.parallel.dist import Axis
    from tony_tpu_torch.parallel.mesh import MESH_AXES, Mesh, MeshShape
    from tony_tpu_torch.train import FitConfig
    from tony_tpu_torch.train.loop import _check_config
    from tony_tpu_torch.train.trainer import default_optimizer, make_train_step

    pp, knobs, schedule = 2, {}, "gpipe"
    if case in ("ring", "ring_flash", "ulysses"):
        knobs = {"attention_impl": case}
    elif case == "1f1b-moe":
        knobs, schedule = {"n_experts": 4}, "1f1b"
    elif case == "layers":
        pp = 4
        knobs = {"n_layers": 6}
    else:
        schedule = "zb"
    layers = knobs.pop("n_layers", 2)
    cfg = dataclasses.replace(LlamaConfig.tiny(**knobs), n_layers=layers)
    jcfg = dataclasses.replace(JConfig.tiny(**knobs), n_layers=layers)
    shape = MeshShape(pp=pp)
    mesh = Mesh(shape, 0, {a: Axis(a, n) for a, n in zip(MESH_AXES, shape.sizes)})
    jmesh = jbuild(JShape(pp=pp), devices=jax.devices()[:pp])
    opt = default_optimizer()
    port = _refusal(lambda: make_train_step(cfg, opt, mesh=mesh, pp_schedule=schedule))
    if case == "1f1b-moe":
        toks = jnp.zeros((8, 32), jnp.int32)
        ref = _refusal(lambda: jtrainer.pp_1f1b_loss_from_pairs(
            {}, toks, toks, cfg=jcfg, mesh=jmesh, n_microbatches=4))
    elif case == "schedule":
        ref = _refusal(lambda: jtrainer.make_train_step(
            jcfg, jmesh, jtrainer.default_optimizer(), pp_schedule=schedule))
    else:
        ref = _refusal(lambda: jtrainer._pp_guard(jcfg, jmesh))
    assert port == ref
    # fit() refuses the same before it brings a group up
    fit_cfg = FitConfig(model=cfg, mesh_shape=shape, pp_schedule=schedule)
    assert _refusal(lambda: _check_config(fit_cfg)) == ref
