"""The batch-norm backward (B7) on the CPU against the JAX package: the
port's plain version against the JAX Pallas kernel in interpret mode and
against the numpy two-pass math of tests/test_passes.py, from the same
numpy inputs.

Tolerance: rtol 1e-4 (atol 1e-4 for the channel sums, 1e-5 for dx), the
reassociation bound tests/test_passes.py pins: the four sums are taken
in another order (by tile, by torch's tree, by numpy's pairwise sum)."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import bn_grad as jbn
from paddle_tpu_torch.kernels import bn_grad as tbn

EPS = 1e-5


def _inputs(shape, seed=1):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 1.5 + 0.5).astype(np.float32)
    dy = rng.randn(*shape).astype(np.float32)
    scale = rng.randn(shape[-1]).astype(np.float32)
    return x, dy, scale


def _numpy_two_pass(x, dy, scale, dtype=np.float32):
    c = x.shape[-1]
    xf, dyf = x.reshape(-1, c).astype(dtype), dy.reshape(-1, c).astype(dtype)
    n = xf.shape[0]
    mean = xf.mean(0)
    var = np.maximum((xf * xf).mean(0) - mean * mean, 0.0)
    inv = 1.0 / np.sqrt(var + EPS)
    xhat = (xf - mean) * inv
    rb = dyf.sum(0)
    rs = (dyf * xhat).sum(0)
    rdx = (scale * inv) / n * (n * dyf - rb - xhat * rs)
    return rdx.reshape(x.shape), rs, rb


def _port(x, dy, scale, **kw):
    dx, ds, db = tbn.bn_grad(torch.from_numpy(x), torch.from_numpy(dy),
                             torch.from_numpy(scale), EPS, **kw)
    return dx.numpy(), ds.numpy(), db.numpy()


def _assert_close(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4, atol=1e-4)


# the JAX test's shape; rows (105, 77) that no power of two divides
@pytest.mark.parametrize("shape", [(4, 6, 6, 16), (3, 5, 7, 8),
                                   (7, 11, 1, 5)])
def test_plain_matches_the_pallas_kernel_and_numpy(shape):
    x, dy, scale = _inputs(shape)
    got = _port(x, dy, scale)
    jax_out = jbn.bn_grad(jnp.asarray(x), jnp.asarray(dy),
                          jnp.asarray(scale), EPS, interpret=True)
    _assert_close(got, [np.asarray(a) for a in jax_out])
    _assert_close(got, _numpy_two_pass(x, dy, scale))
    _assert_close(got, _numpy_two_pass(x, dy, scale, np.float64))
    assert got[0].dtype == np.float32 and got[0].shape == shape
    assert got[1].shape == got[2].shape == (shape[-1],)


@pytest.mark.parametrize("tile", [1, 7, 35, 105])
def test_explicit_tile_blocks_the_rows(tile):
    """rows = 3*5*7 = 105: every divisor is a legal tile, as in the JAX
    kernel, and the blocked sums agree with the JAX kernel at that
    tile."""
    x, dy, scale = _inputs((3, 5, 7, 8), seed=2)
    assert tbn.valid_tile(105, tile)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = _port(x, dy, scale, tile=tile)
    jax_out = jbn.bn_grad(jnp.asarray(x), jnp.asarray(dy),
                          jnp.asarray(scale), EPS, interpret=True, tile=tile)
    _assert_close(got, [np.asarray(a) for a in jax_out])
    _assert_close(got, _port(x, dy, scale))


@pytest.mark.parametrize("tile", [0, 8, 106, 2.0, True])
def test_illegal_tile_warns_and_falls_back(tile):
    x, dy, scale = _inputs((3, 5, 7, 8), seed=3)
    assert not tbn.valid_tile(105, tile)
    with pytest.warns(RuntimeWarning, match="tile override"):
        got = _port(x, dy, scale, tile=tile)
    for a, b in zip(got, _port(x, dy, scale)):
        np.testing.assert_array_equal(a, b)


def test_bfloat16_in_float32_sums_out():
    x, dy, scale = _inputs((4, 6, 6, 16), seed=4)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    dyb = torch.from_numpy(dy).to(torch.bfloat16)
    dx, ds, db = tbn.bn_grad(xb, dyb, torch.from_numpy(scale), EPS)
    assert dx.dtype == torch.bfloat16 and ds.dtype == db.dtype == torch.float32
    jdx, jds, jdb = jbn.bn_grad(jnp.asarray(x).astype(jnp.bfloat16),
                                jnp.asarray(dy).astype(jnp.bfloat16),
                                jnp.asarray(scale), EPS, interpret=True)
    # one bfloat16 rounding of dx; the sums are float32 on both sides
    np.testing.assert_allclose(dx.float().numpy(),
                               np.asarray(jdx.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(ds.numpy(), np.asarray(jds), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(db.numpy(), np.asarray(jdb), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("attrs,ndim,want", [
    ({"data_layout": "NHWC"}, 4, True),
    ({"data_layout": "NHWC", "is_test": True}, 4, False),
    ({"data_layout": "NCHW"}, 4, False),
    ({}, 4, False),
    ({"data_layout": "NHWC"}, 2, False)])
def test_supported_keeps_the_structural_rules(attrs, ndim, want):
    x = torch.empty((2,) * ndim)
    assert tbn.supported(x, attrs) is want
    # the same verdict as the JAX package's predicate in interpret mode
    jx = jnp.zeros((2,) * ndim)
    assert jbn.supported(jx, attrs, interpret=True) is want


def test_any_row_count_is_taken_where_the_pallas_kernel_needs_a_divisor():
    """A prime row count leaves the Pallas kernel tiles of one row; the
    port's wrapper has no tiling rule."""
    x, dy, scale = _inputs((1, 13, 1, 4), seed=5)
    _assert_close(_port(x, dy, scale), _numpy_two_pass(x, dy, scale))


def test_cpu_runs_the_plain_version_and_counts_no_launch():
    x, dy, scale = _inputs((2, 3, 3, 4), seed=6)
    tbn.reset_launches()
    _port(x, dy, scale)
    assert tbn.launches == {"bn_grad": 0}
    with pytest.raises(ValueError, match=r"\[N, H, W, C\]"):
        tbn.bn_grad(torch.zeros(4, 4), torch.zeros(4, 4), torch.zeros(4),
                    EPS)
