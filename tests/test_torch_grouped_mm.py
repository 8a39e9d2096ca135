"""The port's grouped matmul (tony_tpu_torch.ops.grouped_mm) against the JAX
package's: the layout, the forward under both impls, and dx/dW through the
port's autograd against ``jax.vjp`` of the reference's Pallas kernels
(interpret mode on the CPU, as tests/test_grouped_moe.py runs them).

Tolerance: atol=1e-5, rtol=1e-4, float32 everywhere. The reference's
kernels and the port's plain versions take the same float32 products and
sum them in another order (the Pallas dx kernel over column blocks, the
dW kernel tile by tile). The same tolerance holds at row tiles of 64 and
128 with contraction widths that end past a multiple of 64 (72, 136): the
shapes at which the card holds its kernels, the bf16 wgmma instances of
all three among them, against these plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.ops import grouped_mm as jg
from tony_tpu_torch.ops.grouped_mm import (
    LAUNCHES, gmm_dw_plain, gmm_fwd, grouped_layout, grouped_matmul, reset_launches,
)

TOL = dict(atol=1e-5, rtol=1e-4)
G, BLOCK = 4, 8


def _layout_case(sizes, D, F, seed, block=BLOCK):
    """A buffer laid out by the reference's grouped_layout: each group's
    rows filled with normals, padding rows zero; w and dy normals."""
    rng = np.random.default_rng(seed)
    sizes = np.asarray(sizes, np.int32)
    n_tiles = -(-int(sizes.sum()) // block) + len(sizes)
    starts, tg = (np.array(a) for a in jg.grouped_layout(jnp.asarray(sizes), block,
                                                           n_tiles))
    x = np.zeros((n_tiles * block, D), np.float32)
    for s, n in zip(starts, sizes):
        x[s:s + n] = rng.standard_normal((n, D))
    w = rng.standard_normal((len(sizes), D, F)).astype(np.float32) / np.sqrt(D)
    dy = rng.standard_normal((n_tiles * block, F)).astype(np.float32)
    return x, w, tg, dy


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("block", [1, 8, 128])
def test_layout_matches_reference(seed, block):
    """Aligned starts and the tile->group map equal the reference's exactly,
    on random sizes with zero-load groups and a slack of trailing tiles."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, 40, 6).astype(np.int32)
    sizes[rng.integers(0, 6, 2)] = 0
    n_tiles = -(-int(sizes.sum()) // block) + len(sizes) + 3
    want_s, want_tg = jg.grouped_layout(jnp.asarray(sizes), block, n_tiles)
    starts, tg = grouped_layout(torch.from_numpy(sizes), block, n_tiles)
    np.testing.assert_array_equal(starts.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(want_tg))
    assert tg.dtype == torch.int32 and starts.dtype == torch.int32


# (sizes, D, F, row tile): 8-row tiles, then row tiles of 128 and 64 with
# contraction widths past a multiple of 64 and an empty expert; last, at
# row tile 128 (the layout the bf16 wgmma instances serve), a group over
# three tiles, an empty expert in the middle and widths past a multiple
# of 64
CASES = [([5, 0, 17, 9], 16, 24, BLOCK), ([8, 8, 0, 0], 24, 40, BLOCK),
         ([0, 30, 3, 1], 40, 72, BLOCK), ([130, 0, 77, 20], 72, 40, 128),
         ([70, 0, 5, 64], 136, 24, 64), ([300, 0, 129, 5], 72, 136, 128)]
IDS = ["empty-1", "empty-tail", "ragged-width", "block128-tail", "block64-tail",
       "block128-multi"]


@pytest.mark.parametrize("sizes,D,F,block", CASES, ids=IDS)
def test_forward_matches_reference_both_impls(sizes, D, F, block):
    """y of the port's 'pallas' (plain version on CPU tensors) and 'scan'
    against the reference's interpreted Pallas kernel and its lax.scan.
    Widths 24, 40 and 72 are not multiples of the TPU's 128-column tile."""
    x, w, tg, _ = _layout_case(sizes, D, F, seed=D, block=block)
    want = np.asarray(jg.grouped_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(tg),
                                        impl="pallas", block_cols=16))
    np.testing.assert_allclose(
        want, np.asarray(jg.grouped_matmul(jnp.asarray(x), jnp.asarray(w),
                                           jnp.asarray(tg), impl="scan")), **TOL)
    for impl in ("pallas", "scan"):
        reset_launches()
        y = grouped_matmul(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(tg), impl=impl)
        np.testing.assert_allclose(y.numpy(), want, **TOL)
        assert LAUNCHES["gmm_fwd_plain"] == 1 and LAUNCHES["gmm_fwd"] == 0


@pytest.mark.parametrize("impl", ["pallas", "scan"])
@pytest.mark.parametrize("sizes,D,F,block", CASES, ids=IDS)
def test_dx_dw_match_jax_vjp(sizes, D, F, block, impl):
    """dx and dW through the port's autograd (the custom op's dx/dW
    routines under 'pallas', autograd of the plain forward under 'scan')
    against ``jax.vjp`` of the reference's Pallas path."""
    x, w, tg, dy = _layout_case(sizes, D, F, seed=F, block=block)
    _, vjp = jax.vjp(lambda a, b: jg.grouped_matmul(a, b, jnp.asarray(tg),
                                                    impl="pallas", block_cols=16),
                     jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(dy))
    xt, wt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    reset_launches()
    y = grouped_matmul(xt, wt, torch.from_numpy(tg), impl=impl)
    dx, dw = torch.autograd.grad(y, (xt, wt), torch.from_numpy(dy))
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), **TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw), **TOL)
    bwd = 1 if impl == "pallas" else 0
    assert LAUNCHES["gmm_dx_plain"] == LAUNCHES["gmm_dw_plain"] == bwd
    assert LAUNCHES["gmm_dx"] == LAUNCHES["gmm_dw"] == 0


def test_empty_expert_dw_is_exactly_zero():
    """A zero-load expert owns one all-zero tile: its dW is exactly 0 under
    both impls, and so is the dW of an expert that owns no tile at all."""
    x, w, tg, dy = _layout_case([5, 0, 17, 0], 16, 24, seed=3)
    for impl in ("pallas", "scan"):
        wt = torch.from_numpy(w).requires_grad_(True)
        y = grouped_matmul(torch.from_numpy(x), wt, torch.from_numpy(tg), impl=impl)
        (dw,) = torch.autograd.grad(y, wt, torch.from_numpy(dy))
        assert torch.count_nonzero(dw[1]) == 0 and torch.count_nonzero(dw[3]) == 0
        assert torch.count_nonzero(dw[0]) > 0
    no_tile = gmm_dw_plain(torch.from_numpy(x), torch.from_numpy(dy),
                           torch.zeros(len(tg), dtype=torch.int32), G)
    assert torch.count_nonzero(no_tile[1:]) == 0


def test_bad_shapes_and_impls_raise():
    x, w, tg = torch.zeros(32, 16), torch.zeros(4, 16, 8), torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="shapes"):
        grouped_matmul(x, torch.zeros(4, 12, 8), tg)
    with pytest.raises(ValueError, match="shapes"):
        grouped_matmul(x[None], w, tg)
    with pytest.raises(ValueError, match="whole number"):
        grouped_matmul(x[:30], w, tg)
    with pytest.raises(ValueError, match="whole number"):
        grouped_matmul(x, w, tg[:0])
    with pytest.raises(ValueError, match="unknown gmm impl"):
        grouped_matmul(x, w, tg, impl="xla")
    with pytest.raises(ValueError, match="device"):
        gmm_fwd(x.to("meta"), w.to("meta"), tg.to("meta"))
