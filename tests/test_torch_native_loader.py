"""The port's native token loader (tony_tpu_torch/native/tonyloader.cpp
through tony_tpu_torch/train/native_loader.py) against the JAX package's:
byte-equal batches from the same token file and seed, after a seek too;
the fallback rules; ``fit()`` reading a token file, its final report
naming the loader, at fsdp 2 on gloo ranks as in one process. Skips only
where ``g++`` cannot build the loader."""

import numpy as np
import pytest
import torch

from tony_tpu.train import data as jdata
from tony_tpu_torch.train import data as pdata
from tony_tpu_torch.train import native_loader


@pytest.fixture(autouse=True)
def _needs_gxx():
    if not native_loader.available():
        pytest.skip("g++/native build unavailable")


@pytest.fixture
def token_file(tmp_path):
    rng = np.random.default_rng(0)
    path = tmp_path / "tokens.bin"
    rng.integers(0, 256, 40 * 33 + 7).astype(np.int32).tofile(path)
    return str(path)


@pytest.mark.parametrize("start_step", [0, 3, 11])
def test_batches_byte_equal_reference(token_file, start_step):
    """Six batches from ``start_step`` (past an epoch of 10 windows x 4 rows
    at 11) through both packages' native streams: equal bytes."""
    kw = dict(global_batch=4, seq_len=32, vocab_size=256, seed=5, path=token_file,
              prefetch=0)
    want = jdata.native_batches(jdata.DataConfig(**kw), None, start_step)
    got = pdata.native_batches(pdata.DataConfig(**kw), start_step)
    for _ in range(6):
        (ji, jt), (pi, pt) = next(want), next(got)
        assert np.asarray(ji).tobytes() == pi.numpy().tobytes()
        assert np.asarray(jt).tobytes() == pt.numpy().tobytes()
    want.close()
    got.close()


def test_make_batches_routes_token_files_through_the_loader(token_file, monkeypatch):
    """``native=True`` reads the native stream, prefetched or not;
    ``native=False`` the mmap windows; without a build one process falls
    back to mmap and a multi-process run raises, as the reference does."""
    cfg = pdata.DataConfig(global_batch=4, seq_len=32, vocab_size=256, path=token_file)
    assert pdata.loader_kind(cfg) == "native"
    direct = next(pdata.native_batches(cfg, 2))
    for prefetch in (0, 2):
        it = pdata.make_batches(pdata.DataConfig(**{**cfg.__dict__, "prefetch": prefetch}),
                                device="cpu", start_step=2)
        got = next(it)
        assert torch.equal(got[0], direct[0]) and torch.equal(got[1], direct[1])
        if hasattr(it, "close"):
            it.close()
    mm = pdata.DataConfig(**{**cfg.__dict__, "native": False})
    assert pdata.loader_kind(mm) == "mmap"
    monkeypatch.setattr(native_loader, "available", lambda: False)
    assert pdata.loader_kind(cfg) == "mmap"
    with pytest.raises(RuntimeError, match="multi-process"):
        pdata._make_batches_raw(cfg, 0, multi_process=True)
    first = next(pdata._make_batches_raw(cfg, 0))
    assert torch.equal(first[0], next(pdata.mmap_batches(cfg, 0))[0])


def test_fit_reads_the_token_file_alike_on_two_ranks(token_file, tmp_path):
    """``fit()`` over the token file: the final report names the native
    loader, and at fsdp 2 on gloo ranks (every rank reads the global batch
    of windows and keeps its rows) each step's loss is the one-process
    run's within 1e-4 (the final loss on every rank)."""
    from torch_ranks import spawn

    from tony_tpu_torch.models.llama import LlamaConfig
    from tony_tpu_torch.train import FitConfig, fit

    data = dict(global_batch=4, seq_len=32, vocab_size=256, path=token_file, seed=1)
    model = dict(attention_impl="dot", remat=False)
    seen: list = []
    final = fit(FitConfig(model=LlamaConfig.tiny(**model), data=pdata.DataConfig(**data),
                          steps=3, log_every=1, lr=5e-3, warmup_steps=1,
                          on_metrics=seen.append), device="cpu")
    assert final["loader"] == "native"
    ranks = spawn(2, "fit", {"runs": [{"model": model, "data": data, "mesh": {"fsdp": 2},
                                       "steps": 3}]}, tmp_path / "ranks")
    for r in ranks:
        run = r["runs"][0]
        assert run["final"]["loader"] == "native"
        np.testing.assert_allclose(run["final"]["final_loss"], final["final_loss"],
                                   atol=1e-4, rtol=1e-4)
    # rank 0 alone reports each step
    np.testing.assert_allclose([m["loss"] for m in ranks[0]["runs"][0]["metrics"]],
                               [m["loss"] for m in seen], atol=1e-4, rtol=1e-4)
