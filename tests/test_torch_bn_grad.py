"""The batch-norm backward (B7) on the CPU against the JAX package: the
port's plain version against the JAX Pallas kernel in interpret mode and
against the numpy two-pass math of tests/test_passes.py, from the same
numpy inputs.

Tolerance: rtol 1e-4 (atol 1e-4 for the channel sums, 1e-5 for dx), the
reassociation bound tests/test_passes.py pins: the four sums are taken
in another order (by tile, by torch's tree, by numpy's pairwise sum)."""

import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import bn_grad as jbn
from paddle_tpu_torch.kernels import bn_grad as tbn

# Under pytest-xdist each worker takes its share of the cores for
# torch's intra-op threads: six workers at torch's default thread count
# oversubscribe the cores, and a test of seconds then takes minutes.
_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, os.cpu_count() // int(_WORKERS)))

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


# ---- the card kernel's launch plan (pure Python, checked here) ----

# ResNet-50's nine batch-norm shapes at batch 64 (the 53 a step), the odd
# shapes the card checks (rows no power of two divides, channels that
# fill no 16-byte word) and shapes with fewer rows than blocks
RESNET_BN = [(64, 112, 112, 64), (64, 56, 56, 64), (64, 56, 56, 256),
             (64, 28, 28, 128), (64, 28, 28, 512), (64, 14, 14, 256),
             (64, 14, 14, 1024), (64, 7, 7, 512), (64, 7, 7, 2048)]
ODD_BN = [(5, 7, 9, 24), (3, 5, 7, 6), (2, 3, 5, 40), (1, 13, 1, 4),
          (7, 11, 1, 5)]
DTYPES = [torch.float32, torch.bfloat16]


def _plan(shape, dtype, aligned=True, **kw):
    n, h, w, c = shape
    return tbn.plan(n * h * w, c, dtype, aligned, **kw)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", RESNET_BN + ODD_BN)
def test_plan_covers_every_row_and_channel_once(shape, dtype):
    """The blocks' tiles cover [M, C] exactly once: the groups' columns
    cut [0, C), and each group's tiles, over all blocks of the group,
    cut [0, M) without gap or overlap; blocks past groups * slabs hold
    none. Small shapes are also counted cell by cell."""
    pl = _plan(shape, dtype)
    m, c = pl.rows, pl.channels
    assert pl.groups * pl.slabs <= pl.grid == tbn.H100_SMS
    rows = {g: [] for g in range(pl.groups)}
    cols = {}
    for b in range(pl.grid):
        g, tiles = tbn.block_tiles(pl, b)
        if b >= pl.groups * pl.slabs:
            assert len(tiles) == 0
        for t in tiles:
            r0, r1, c0, c1 = tbn.tile_box(pl, g, t)
            rows[g].append((r0, r1))
            cols.setdefault(g, (c0, c1))
            assert cols[g] == (c0, c1)
    edges = sorted(cols.values())
    assert edges[0][0] == 0 and edges[-1][1] == c
    assert all(a[1] == b[0] for a, b in zip(edges, edges[1:]))
    for g in range(pl.groups):
        spans = sorted(rows[g])
        assert spans[0][0] == 0 and spans[-1][1] == m
        assert all(a[1] == b[0] and a[0] < a[1]
                   for a, b in zip(spans, spans[1:]))
    if m * c <= 1 << 16:
        hits = np.zeros((m, c), np.int64)
        for b in range(pl.grid):
            g, tiles = tbn.block_tiles(pl, b)
            for t in tiles:
                r0, r1, c0, c1 = tbn.tile_box(pl, g, t)
                hits[r0:r1, c0:c1] += 1
        assert (hits == 1).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", RESNET_BN + ODD_BN)
def test_plan_residency_and_ring_fit_shared_memory(shape, dtype):
    """The slots (resident tiles and ring alike), their mbarriers and the
    scratch fit the 232,448 bytes a block may use; at least two slots,
    no more than a slab has tiles; a tile within a TMA box's 256 rows
    and its group's columns within the 256 threads' vectors."""
    pl = _plan(shape, dtype)
    assert pl.smem <= tbn.H100_MAX_SMEM == 232448
    assert 2 <= pl.slots <= max(2, -(-pl.tiles // pl.slabs))
    assert 1 <= pl.tile_rows <= 256
    assert pl.width % pl.vec == 0 and pl.width // pl.vec <= 256
    assert pl.groups == -(-pl.channels // pl.width)
    if pl.slots < -(-pl.tiles // pl.slabs):   # the budget binds: ~200 KB
        assert 2 * pl.slots * pl.tile_rows * pl.width * pl.itemsize \
            >= 190 * 1024


@pytest.mark.parametrize("c,dtype,aligned,want", [
    (64, torch.float32, True, "tma"),      # 256-byte rows
    (2048, torch.bfloat16, True, "tma"),
    (24, torch.bfloat16, True, "tma"),     # 48-byte rows
    (4, torch.float32, True, "tma"),       # one 16-byte word a row
    (6, torch.float32, True, "scalar"),    # 24-byte rows
    (12, torch.bfloat16, True, "scalar"),  # 24-byte rows
    (64, torch.float32, False, "scalar"),  # a tensor off 16 bytes
    (40000, torch.float32, True, "vec"),   # a group wider than a box
])
def test_plan_loader_follows_row_bytes_and_alignment(c, dtype, aligned,
                                                     want):
    pl = tbn.plan(3136, c, dtype, aligned)
    assert pl.loader == want
    assert pl.vec == (1 if want == "scalar" else 16 // pl.itemsize)
    assert (pl.loader == "tma") == (pl.width <= 256 and want != "scalar")


def test_plan_forces_only_the_loaders_a_shape_allows():
    assert tbn.plan(3136, 64, torch.float32, True, loader="vec").loader \
        == "vec"
    sc = tbn.plan(3136, 64, torch.bfloat16, True, loader="scalar")
    assert (sc.loader, sc.vec) == ("scalar", 1)
    with pytest.raises(ValueError, match="16-byte rows"):
        tbn.plan(3136, 6, torch.float32, True, loader="vec")
    with pytest.raises(ValueError, match="16-byte rows"):
        tbn.plan(3136, 64, torch.float32, False, loader="tma")
    with pytest.raises(ValueError, match="TMA box"):
        tbn.plan(3136, 40000, torch.float32, True, loader="tma")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tbn.plan(3136, 64, torch.float16, True)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", RESNET_BN + ODD_BN)
def test_plan_moves_one_pass_where_x_and_dy_fit(shape, dtype):
    """Where x and dy fit the blocks' slots plus the L2's share, the
    plan's HBM bytes are one pass (x, dy read once, dx written once);
    past it, one pass plus the re-read the L2 does not hold."""
    pl = _plan(shape, dtype)
    elt = pl.itemsize
    assert pl.one_pass_bytes == 3 * pl.rows * pl.channels * elt \
        + 12 * pl.channels
    on_chip = pl.groups * pl.slabs * pl.slots * 2 * pl.tile_rows \
        * pl.width * elt
    if 2 * pl.rows * pl.channels * elt <= on_chip + tbn.L2_REREAD_BYTES:
        assert pl.hbm_bytes == pl.one_pass_bytes
    assert pl.hbm_bytes == pl.one_pass_bytes + max(
        0, pl.reread_bytes - tbn.L2_REREAD_BYTES)


def test_plan_one_pass_at_43_of_53_bf16_layers():
    """bench.py's config C (bf16): all but the stem, the four 56x56x256
    and the five 28x28x512 layers run in one pass."""
    per_step = dict(zip(RESNET_BN, (1, 6, 4, 8, 5, 12, 7, 6, 4)))
    one = sum(k for s, k in per_step.items()
              if _plan(s, torch.bfloat16).hbm_bytes
              == _plan(s, torch.bfloat16).one_pass_bytes)
    assert sum(per_step.values()) == 53 and one == 43


@pytest.mark.parametrize("n,slots", [(1, 2), (2, 2), (5, 2), (8, 3),
                                     (13, 13), (95, 13), (190, 13)])
def test_phase_two_reverses_phase_one_and_waits_on_the_right_phase(n,
                                                                    slots):
    """The slot machine the kernel runs, simulated: phase 1 puts tile t in
    slot t % slots and loads it again (tile t + slots) once read; phase 2
    takes the tiles in reverse, finds the last ``slots`` still resident,
    and re-reads the others, each into its slot once the tile above it
    there has been written out, the newest first. Every wait's parity is
    the one ``reread_parity`` (the kernel's formula) gives."""
    content, parity = {}, {}
    phases = [0] * slots

    def load(t):
        s = t % slots
        phases[s] += 1          # the phase this load completes
        content[s] = t
        return (phases[s] - 1) & 1

    for t in range(min(n, slots)):
        parity[t] = load(t)
    p1 = []
    for t in range(n):
        assert content[t % slots] == t and parity.pop(t) == (t // slots) & 1
        p1.append(t)
        if t + slots < n:
            parity[t + slots] = load(t + slots)
    p2, reloads = [], []
    for t in range(n - 1, -1, -1):
        assert content[t % slots] == t
        if t < n - slots:
            reloads.append(t)
            assert parity.pop(t) == tbn.reread_parity(t, n, slots)
        p2.append(t)
        if t - slots >= 0:
            parity[t - slots] = load(t - slots)
    assert p2 == p1[::-1] and not parity
    assert reloads == list(range(n - slots - 1, -1, -1))
