"""MoE over a dp x fsdp x ep mesh of gloo ranks (tony_tpu_torch.parallel.moe
with ops/moe_overlap.py and the sharded step) against the JAX package, on
the CPU.

The port's ranks are processes of ``tests/torch_ranks.py`` (JAX-free),
one spawn per world size. Each holds its rows of the global batch (split
over dp, fsdp and ep), the whole router and its ``E / ep`` experts.

- ``moe_block`` at ep 2, ep 2 x fsdp 2 and dp 2 x ep 2: ``y``, ``aux``
  and the gradients of ``sum(y * y) + aux`` (router, w1, w3, w2, x),
  assembled whole, against the reference's unsharded ``moe_block`` and
  against its ep path on a CPU mesh of the same shape, at the reference's
  own ep tolerances (``tests/test_grouped_moe.py``: aux 1e-6, y atol
  1e-5, grads atol 1e-4); the x gradient against the unsharded block only.
- The overlapped combine against the port's own blocking combine on the
  same ranks: the scan form's forward bit for bit (the chunks are disjoint
  row slices, each row's grouped matmuls run on tiles of the same 128
  rows, and each sum has the same two terms), the pallas form's (the
  kernels' plain versions here) within 2e-5, chunk sizes bit-equal to
  each other, an indivisible chunk declining to the blocking combine,
  and NaN/inf rows poisoning the same outputs. The reference's overlapped
  forms fail under this jax line (ROADMAP "Reference caveats"), so they
  are no oracle here.
- Five ``make_train_step`` steps at dp 2 x fsdp 2 (no ep: the router's
  global statistics), ep 2 x fsdp 2 (with remat and the scan overlap) and
  dp 2 x ep 2 with the bucketed dp reduction: loss, aux and grad norm
  within 1e-4, parameters atol 1e-4 / rtol 1e-3. dp 2 x fsdp 2 is held
  against the reference's step on the same CPU mesh. The ep meshes are
  held against the reference's one-device step on the global batch: under
  this jax line the reference's ep path returns x cotangents that disagree
  with its own unsharded block (the block test below holds it to y, aux
  and the parameters' gradients only, which its own test checks), and its
  ep step drifts from its one-device step from the first update on.
  Top-k is discrete, so each run asserts that every token's k-th and
  (k+1)-th router probabilities stay more than 1e-4 apart: a route that
  flips fails that check, not the tolerance (key 1's parameters hold a
  margin of 3.1e-4 over the five steps).
- ``fit()`` at ep 2, dp 2 x ep 2 and dp 2 x fsdp 2 trains the one-process
  ``fit()``'s losses and aux within 1e-4.
- Repair: at fsdp 2 with the ring on (``overlap_impl="scan"``), a MoE
  model's expert weights take the blocking gather, never the ring, and
  train as with the ring off (within 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tony_tpu.models import llama as jl
from tony_tpu.ops import moe_overlap as jov
from tony_tpu.parallel import moe as jm
from tony_tpu.parallel.mesh import MeshShape as JMeshShape, build_mesh, set_default_mesh
from tony_tpu.train import data as jdata
from tony_tpu.train import trainer as jtrainer
from tony_tpu_torch.ops import moe_overlap as pov
from torch_ranks import spawn

BASE = dict(dim=32, ffn_dim=64, n_experts=4, top_k=2, capacity_factor=8.0,
            dispatch="grouped")
# 8 sequences of 6 tokens: 48 rows, 24 a rank at ep 2, 12 at four ranks
X_SHAPE = (8, 6, 32)
BLOCK_MESHES = {"ep2": {"ep": 2}, "ep2-fsdp2": {"ep": 2, "fsdp": 2},
                "dp2-ep2": {"dp": 2, "ep": 2}}
# (impl, chunk, poisoned rows) per case; at ep 2 the (dp, fsdp) block
# holds 48 rows: auto 4 chunks of 12, chunk 8 six, 16 three, 7 declines
CASES = {"ep2": [("off", 0, False), ("scan", 0, False), ("pallas", 0, False),
                 ("scan", 8, False), ("scan", 16, False), ("scan", 7, False),
                 ("off", 0, True), ("scan", 0, True), ("pallas", 0, True)],
         "ep2-fsdp2": [("off", 0, False), ("scan", 0, False), ("pallas", 0, False)],
         "dp2-ep2": [("off", 0, False), ("scan", 0, False), ("pallas", 0, False)]}

STEPS = 5
DATA = dict(global_batch=4, seq_len=32, vocab_size=256)
OPT = dict(lr=5e-3, warmup_steps=2, decay_steps=5)
MOE = {"n_experts": 4, "attention_impl": "dot"}
# the reference's parameters, drawn from this key on both sides
KEY = 1
# name -> (mesh, model knobs, grad_bucket_bytes); the reference runs on
# the same mesh where its step agrees with its one-device step
TRAIN = {"dp2-fsdp2": ({"dp": 2, "fsdp": 2}, {}, None),
         "ep2-fsdp2-remat": ({"ep": 2, "fsdp": 2}, {"remat": True, "remat_policy": "nothing",
                                                    "moe_overlap_impl": "scan"}, None),
         "dp2-ep2-buckets": ({"dp": 2, "ep": 2}, {}, 4096)}
RING = {"ring-off": ({"fsdp": 2}, {}, None),
        "ring-scan": ({"fsdp": 2}, {"overlap_impl": "scan"}, None)}
# fit() on the MoE config: name -> (mesh, moe_overlap_impl)
FIT = {"ep2": ({"ep": 2}, "pallas"), "dp2-ep2": ({"dp": 2, "ep": 2}, "scan"),
       "dp2-fsdp2": ({"dp": 2, "fsdp": 2}, "off")}


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flatten(v, f"{prefix}{k}/") if isinstance(v, dict)
                   else {prefix + k: np.asarray(v)})
    return out


def _block_inputs():
    cfg = jm.MoEConfig(**BASE)
    params = jax.tree.map(np.asarray, jm.init_moe_params(jax.random.key(0), cfg,
                                                         dtype=jnp.float32))
    x = np.random.default_rng(1).standard_normal(X_SHAPE).astype(np.float32)
    bad = x.copy()
    bad[0, 5, :] = np.nan
    bad[3, 2, :] = np.inf
    return params, x, bad


def _reference_block(params, x, mesh_d=None):
    """The reference's moe_block: y, aux and the grads of sum(y*y) + aux,
    unsharded or (``mesh_d``) on its ep path over a CPU mesh."""
    cfg = jm.MoEConfig(**BASE)

    def loss(p, xx):
        y, aux = jm.moe_block(p, xx, cfg)
        return jnp.sum(y * y) + aux

    if mesh_d:
        shape = JMeshShape(**mesh_d)
        set_default_mesh(build_mesh(shape, devices=jax.devices()[:shape.n_devices]))
    try:
        y, aux = jax.jit(lambda p, a: jm.moe_block(p, a, cfg))(params, x)
        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, x)
    finally:
        set_default_mesh(None)
    return {"y": np.asarray(y), "aux": float(aux), "x": np.asarray(gx),
            **{k: np.asarray(v) for k, v in gp.items()}}


def _reference_train(name: str, table: dict) -> dict:
    mesh_d, knobs, _ = table[name]
    shape = JMeshShape(**(mesh_d if "ep" not in mesh_d else {}))
    mesh = build_mesh(shape, devices=jax.devices()[:shape.n_devices])
    set_default_mesh(mesh)
    # the reference's overlapped forms fail under this jax line: its
    # blocking combine stands for them (the port's scan form is held to
    # its own blocking combine above)
    knobs = {k: v for k, v in knobs.items() if k != "moe_overlap_impl"}
    cfg = jl.LlamaConfig.tiny_moe(attention_impl="dot", **knobs)
    opt = jtrainer.default_optimizer(**OPT)
    # the parameters the port's ranks start from (params.npz)
    state = jtrainer.make_train_state(jax.random.key(KEY), cfg, mesh, opt)
    step = jtrainer.make_train_step(cfg, mesh, opt)
    # the step's metrics carry no aux: it is read off the trunk before
    # each step, from the parameters the step starts from
    aux_of = jax.jit(lambda p, t: jl.hidden_states_with_aux(p, t, cfg)[1])
    batches = jdata.synthetic_batches(jdata.DataConfig(**DATA))
    out = {"loss": [], "grad_norm": [], "aux": []}
    try:
        for _ in range(STEPS):
            inputs, targets = next(batches)
            out["aux"].append(float(aux_of(state.params, inputs)))
            state, m = step(state, inputs, targets)
            for k in ("loss", "grad_norm"):
                out[k].append(float(m[k]))
    finally:
        set_default_mesh(None)
    out["params"] = _flatten(jax.tree.map(np.asarray, state.params))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_mesh")
    params, x, bad = _block_inputs()
    np.savez(tmp / "block.npz", x=x, x_poisoned=bad, **params)
    init = jtrainer.make_train_state(
        jax.random.key(KEY), jl.LlamaConfig.tiny_moe(),
        build_mesh(JMeshShape(), devices=jax.devices()[:1]), jtrainer.default_optimizer(**OPT))
    tree = jax.tree.map(np.asarray, init.params)
    np.savez(tmp / "params.npz", **_flatten(tree))

    def block_run(name):
        return {"task": "moe_block", "mesh": BLOCK_MESHES[name], "inputs": str(tmp / "block.npz"),
                "cfg": BASE, "cases": [{"impl": i, "chunk": c, "poison": p}
                                       for i, c, p in CASES[name]]}

    def train_run(table, name):
        mesh_d, knobs, bucket = table[name]
        return {"task": "train", "mesh": mesh_d, "steps": STEPS, "data": DATA, "opt": OPT,
                "params": str(tmp / "params.npz"), "grad_bucket_bytes": bucket,
                "model": {**MOE, **knobs}}

    def fit_run(name):
        mesh_d, impl = FIT[name]
        return {"task": "fit", "mesh": mesh_d, "model": MOE, "data": DATA, "steps": 3,
                "fit": {"moe_overlap_impl": impl}}

    port = {}
    two = spawn(2, "moe_block", {"runs": [block_run("ep2")] + [train_run(RING, n) for n in RING]
                                 + [fit_run("ep2")]}, tmp / "w2")
    four = spawn(4, "moe_block", {"runs": [block_run("ep2-fsdp2"), block_run("dp2-ep2")]
                                  + [train_run(TRAIN, n) for n in TRAIN]
                                  + [fit_run(n) for n in FIT if n != "ep2"]}, tmp / "w4")
    port["fit-ep2"] = [r["runs"][-1] for r in two]
    for j, name in enumerate(n for n in FIT if n != "ep2"):
        port[f"fit-{name}"] = [r["runs"][2 + len(TRAIN) + j] for r in four]
    port["ep2"] = [r["runs"][0] for r in two]
    for j, name in enumerate(RING):
        port[name] = [r["runs"][1 + j] for r in two]
    for j, name in enumerate(("ep2-fsdp2", "dp2-ep2")):
        port[name] = [r["runs"][j] for r in four]
    for j, name in enumerate(TRAIN):
        port[name] = [r["runs"][2 + j] for r in four]
    port["jax_loaded"] = any(r["jax_loaded"] or r["tony_tpu_loaded"] for r in two + four)
    ref = {"block": _reference_block(params, x),
           **{f"block-{n}": _reference_block(params, x, m) for n, m in BLOCK_MESHES.items()},
           **{n: _reference_train(n, TRAIN) for n in TRAIN}}
    return port, ref


# --- chunk planning (no ranks) ---------------------------------------------------


def test_chunk_planning_equals_the_reference():
    """``overlap_chunks`` and ``chunk_tokens_from_report`` are copies of the
    reference's: equal over a grid of inputs, the reference test's cases
    included (auto 4/3/2 splits, pinned sizes, every decline leg, the
    sizing rule and its clamps)."""
    for t in (0, 1, 2, 3, 5, 6, 7, 9, 10, 12, 24, 48, 96, 4096, 8192, 16384):
        for c in (0, 1, 2, 3, 6, 7, 8, 12, 24, 48, 100, 2048, 4096):
            assert pov.overlap_chunks(t, c) == jov.overlap_chunks(t, c), (t, c)
    assert pov.overlap_chunks(24, 0) == 4 and pov.overlap_chunks(9, 0) == 3
    assert pov.overlap_chunks(24, 7) is None and pov.overlap_chunks(24, 24) is None
    reports = [None, {}, {"compute_ms": 4.0},
               {"compute_ms": 4.0, "top_collective": {"achieved_gbps": 0.8}},
               {"compute_ms": 4.0, "top_collective": {"achieved_gbps": 0.001}},
               {"compute_ms": 50.0, "top_collective": {"achieved_gbps": 90.0}},
               {"compute_ms": 0.0, "top_collective": {"achieved_gbps": 5.0}}]
    for rep in reports:
        for dim, nbytes in ((1024, 2), (2048, 2), (4096, 4), (0, 2)):
            assert (pov.chunk_tokens_from_report(rep, dim=dim, dtype_bytes=nbytes)
                    == jov.chunk_tokens_from_report(rep, dim=dim, dtype_bytes=nbytes))
    assert pov.chunk_tokens_from_report(reports[3], dim=1024) == 768


# --- moe_block on the ranks -------------------------------------------------------


def _case(port, name, impl, chunk=0, poison=False):
    i = CASES[name].index((impl, chunk, poison))
    return [r["cases"][i] for r in port[name]]


@pytest.mark.parametrize("name", list(BLOCK_MESHES))
def test_ep_block_matches_the_reference(runs, name):
    """The blocking ep combine (``overlap_impl="off"``) against the
    reference's unsharded moe_block and its ep path on the same CPU mesh:
    aux within 1e-6 (the global statistics), y within 1e-5, every
    gradient within 1e-4 (x's against the unsharded block only); every
    rank holds the same assembled figures."""
    port, ref = runs
    ranks = _case(port, name, "off")
    for r in ranks[1:]:
        assert r["aux"] == ranks[0]["aux"]
        for k in ("y", "router", "w1", "w3", "w2", "x"):
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)
    got = ranks[0]
    for want, keys in ((ref["block"], ("router", "w1", "w3", "w2", "x")),
                       (ref[f"block-{name}"], ("router", "w1", "w3", "w2"))):
        assert abs(got["aux"] - want["aux"]) < 1e-6
        np.testing.assert_allclose(got["y"], want["y"].reshape(got["y"].shape), atol=1e-5)
        for k in keys:
            np.testing.assert_allclose(got[k], want[k].reshape(got[k].shape), atol=1e-4,
                                       err_msg=f"{name} {k}")


@pytest.mark.parametrize("name", list(BLOCK_MESHES))
def test_overlap_scan_forward_is_bit_equal_to_the_blocking_combine(runs, name):
    """The scan form's y and aux bit for bit against the blocking combine
    on the same ranks; its gradients (the per-chunk all-gather backward)
    within the ep tolerance of the reference's unsharded ones."""
    port, ref = runs
    for off, ov in zip(_case(port, name, "off"), _case(port, name, "scan")):
        assert ov["aux"] == off["aux"]
        np.testing.assert_array_equal(ov["y"], off["y"])
        for k in ("router", "w1", "w3", "w2", "x"):
            np.testing.assert_allclose(ov[k], ref["block"][k].reshape(ov[k].shape),
                                       atol=1e-4, err_msg=k)


@pytest.mark.parametrize("name", list(BLOCK_MESHES))
def test_overlap_pallas_is_close_to_the_blocking_combine(runs, name):
    """The pallas form (the grouped kernels' plain versions on the CPU)
    within 2e-5 of the blocking combine, its gradients within 1e-4."""
    port, _ = runs
    for off, ov in zip(_case(port, name, "off"), _case(port, name, "pallas")):
        np.testing.assert_allclose(ov["y"], off["y"], atol=2e-5)
        for k in ("router", "w1", "w3", "w2", "x"):
            np.testing.assert_allclose(ov[k], off[k], atol=1e-4, err_msg=k)


def test_chunk_size_is_a_schedule_and_an_odd_one_declines(runs):
    """Chunk sizes 0 (4 chunks), 8 (6) and 16 (3) give bit-equal y; size 7
    does not divide the 48 rows and declines to the blocking combine, bit
    for bit."""
    port, _ = runs
    off = _case(port, "ep2", "off")[0]["y"]
    for chunk in (0, 8, 16, 7):
        np.testing.assert_array_equal(_case(port, "ep2", "scan", chunk)[0]["y"], off)


@pytest.mark.parametrize("impl", ["scan", "pallas"])
def test_poisoned_rows_propagate_like_the_blocking_combine(runs, impl):
    """NaN and inf rows poison exactly the outputs they poison through the
    blocking combine: no chunk launders a nonfinite value or smears it
    across a chunk boundary; the finite values agree within 2e-5."""
    port, _ = runs
    off = _case(port, "ep2", "off", poison=True)[0]["y"]
    ov = _case(port, "ep2", impl, poison=True)[0]["y"]
    fin = np.isfinite(off)
    np.testing.assert_array_equal(np.isfinite(ov), fin)
    assert not fin.reshape(X_SHAPE)[0, 5].any()
    np.testing.assert_allclose(ov[fin], off[fin], atol=2e-5)


# --- training ---------------------------------------------------------------------


@pytest.mark.parametrize("name", list(TRAIN))
def test_moe_steps_match_the_reference_on_the_same_mesh(runs, name):
    """Five steps: loss, aux and grad norm within 1e-4 of the reference's
    step (on the same CPU mesh, or for ep on one device), the same on
    every rank; the final parameters, all-gathered, within atol 1e-4 /
    rtol 1e-3; no route within 1e-4 of a flip."""
    port, ref = runs
    ranks = port[name]
    assert min(r["margin"] for r in ranks) > 1e-4
    for key in ("loss", "grad_norm", "aux"):
        assert all(r[key] == ranks[0][key] for r in ranks), key
        np.testing.assert_allclose(ranks[0][key], ref[name][key], rtol=1e-4, atol=1e-4,
                                   err_msg=f"{name} {key}")
    got = ranks[0]["params"]
    assert set(got) == set(ref[name]["params"])
    for key, want in ref[name]["params"].items():
        assert all(np.array_equal(r["params"][key], got[key]) for r in ranks), key
        np.testing.assert_allclose(got[key], want, atol=1e-4, rtol=1e-3,
                                   err_msg=f"{name} {key}")


def test_expert_weights_never_ride_the_fsdp_ring(runs):
    """At fsdp 2 with ``overlap_impl="scan"`` the dense projections ride
    the ring and the expert weights take the blocking gather: five steps
    match the ring-off run within 1e-4, and the parameters within 1e-4."""
    port, _ = runs
    off, on = port["ring-off"][0], port["ring-scan"][0]
    assert min(r["margin"] for r in port["ring-off"] + port["ring-scan"]) > 1e-4
    for key in ("loss", "grad_norm", "aux"):
        np.testing.assert_allclose(on[key], off[key], rtol=1e-4, atol=1e-4, err_msg=key)
    for key in off["params"]:
        np.testing.assert_allclose(on["params"][key], off["params"][key], atol=1e-4,
                                   err_msg=key)
    assert all(np.isfinite(off["loss"]))


def test_rank_processes_import_no_jax(runs):
    port, _ = runs
    assert not port["jax_loaded"]


def test_moe_ffn_block_passes_the_overlap_knobs(monkeypatch):
    """The model's ``moe_overlap_impl`` and ``moe_overlap_chunk`` reach the
    MoE block's config, as the reference's ``moe_ffn_block`` passes them."""
    from tony_tpu_torch.models import llama as pl
    from tony_tpu_torch.parallel import moe as pm

    seen = []
    monkeypatch.setattr(pm, "moe_block", lambda params, x, cfg: seen.append(cfg) or (x, 0.0))
    cfg = pl.LlamaConfig.tiny_moe(moe_overlap_impl="scan", moe_overlap_chunk=24)
    pl.moe_ffn_block(None, {k: None for k in ("router", "w1", "w3", "w2")}, cfg)
    assert (seen[0].overlap_impl, seen[0].overlap_chunk) == ("scan", 24)


def test_fit_trains_moe_on_every_mesh_alike(runs, monkeypatch):
    """fit() on the MoE config at ep 2 (the pallas overlap: the grouped
    kernels' plain versions here), dp 2 x ep 2 (the scan overlap) and dp 2
    x fsdp 2 from the same seed and batches: rank 0 alone reports, every
    rank returns the same final loss, and the three meshes train the
    one-process fit()'s losses and aux within 1e-4 (the global batch's
    mean and aux, sums reordered); no route within 1e-4 of a flip."""
    import torch

    from tony_tpu_torch.models.llama import LlamaConfig
    from tony_tpu_torch.parallel import moe as pm
    from tony_tpu_torch.train import DataConfig, FitConfig, fit

    margins, select = [], pm._top_k_select

    def recording(probs, cfg):
        top = torch.sort(probs.detach(), dim=-1, descending=True).values
        margins.append(float((top[:, cfg.top_k - 1] - top[:, cfg.top_k]).min()))
        return select(probs, cfg)

    monkeypatch.setattr(pm, "_top_k_select", recording)
    seen: list = []
    fit(FitConfig(model=LlamaConfig.tiny(**MOE), data=DataConfig(**DATA), steps=3,
                  log_every=1, lr=5e-3, warmup_steps=1, on_metrics=seen.append),
        device="cpu")
    assert min(margins) > 1e-4
    port, _ = runs
    for name in FIT:
        ranks = port[f"fit-{name}"]
        metrics = ranks[0]["metrics"]
        assert [m["step"] for m in metrics] == [1, 2, 3], name
        assert all(r["metrics"] == [] for r in ranks[1:]), name
        assert all(r["final"]["final_loss"] == ranks[0]["final"]["final_loss"] for r in ranks)
        for key in ("loss", "aux"):
            np.testing.assert_allclose([m[key] for m in metrics], [m[key] for m in seen],
                                       rtol=1e-4, atol=1e-4, err_msg=f"{name} {key}")
