"""The bfloat16 LSTM's cluster plan and the blocking its plain versions
follow, on the CPU (kernels/lstm_cell.py; the kernels themselves are
csrc/lstm_cluster.cu, held on the card by tests/test_torch_kernels_cuda.py).

* ``cluster_plan`` is a pure function of (B, H, dtype): bfloat16, H a
  multiple of 8, at most 16 blocks of 32 units, the shared memory of
  both kernels within the card's 232448 bytes; 16 rows a cluster.
* Under the plan the plain forward sums h_{t-1} W in k16 steps
  (``_k16_product``) and the plain backward adds one partial per block's
  128 gate columns in rank order (``_cluster_bwd_product``): both are the
  plain products (float64, to rounding), and in bfloat16 both blockings
  lie within one bfloat16 rounding of the float64 witness.
* float32, and the bf16 shapes the plan refuses, keep lstm_cell.cu's
  blocking bit for bit.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import lstm_cell as tcell

BF16 = torch.bfloat16
# one bfloat16 rounding: rtol 1e-2 plus 4e-3 of the largest magnitude, as
# the kernels are held (tests/test_torch_rnn_amp.py, chip_smoke.py)
BF16_RTOL, BF16_AMAX = 1e-2, 4e-3


def _close(got, want):
    want = want.double()
    torch.testing.assert_close(got.double(), want, rtol=BF16_RTOL,
                               atol=BF16_AMAX * float(want.abs().max()))


def _inputs(B, T, H, seed, dtype=BF16):
    rng = np.random.RandomState(seed)
    xg = torch.from_numpy(rng.randn(B, T, 4 * H) * 0.5).float()
    w = torch.from_numpy(rng.randn(H, 4 * H) * H ** -0.5).float()
    h0 = torch.from_numpy(rng.randn(B, H) * 0.1).float()
    c0 = torch.from_numpy(rng.randn(B, H) * 0.1).float()
    lens = rng.randint(0, T + 1, B)
    lens[0], lens[-1] = 0, T
    mask = torch.from_numpy(
        (np.arange(T)[None] < lens[:, None]).astype(np.float32))
    p = torch.from_numpy(rng.randn(3, H) * 0.1).float()
    dhs = torch.from_numpy(rng.randn(B, T, H)).float()
    dcs = torch.from_numpy(rng.randn(B, T, H)).float()
    return (xg.to(dtype), w.to(dtype), h0, c0, mask, p, dhs.to(dtype),
            dcs.to(dtype))


@pytest.mark.parametrize("b, h, take, blocks, groups", [
    (64, 512, True, 16, 4),      # the AMP stacked LSTM's shape
    (8, 32, True, 1, 1),
    (5, 40, True, 2, 1),         # H not a multiple of 32: edge units zero
    (200, 64, True, 2, 13),      # B not a multiple of 16: edge rows zero
    (16, 1024, False, 32, 1),    # W does not fit 16 blocks
    (5, 36, False, 2, 1),        # H not a multiple of 8
])
def test_cluster_plan_choices(b, h, take, blocks, groups):
    plan = tcell.cluster_plan(b, h, BF16)
    assert plan == dict(take=take, blocks=blocks, rows=16, units=32,
                        row_groups=groups)
    assert tcell.cluster_plan(b, h, torch.float32)["take"] is False


def test_cluster_plan_shared_memory():
    # the path's shape fits both kernels; 32 and 64 rows a cluster would not
    for kind in ("lstm_fwd", "lstm_bwd"):
        assert tcell.cluster_smem(kind, 16) <= tcell.SMEM_LIMIT
        for rows in (32, 64):
            assert tcell.cluster_smem(kind, 16, rows) > tcell.SMEM_LIMIT
    assert tcell.cluster_smem("lstm_fwd", 16) == 225280
    assert tcell.cluster_smem("lstm_bwd", 16) == 207872


@pytest.mark.parametrize("k, n", [(512, 2048), (40, 160), (7, 12)])
def test_cluster_products_are_the_plain_products(k, n):
    rng = np.random.RandomState(k)
    x = torch.from_numpy(rng.randn(5, k))
    w = torch.from_numpy(rng.randn(k, n))
    torch.testing.assert_close(tcell._k16_product(x, tcell._k16_slices(w)),
                               x @ w, rtol=1e-12, atol=1e-12)
    h = n // 4
    blocks = -(-h // 32)
    wt = torch.from_numpy(rng.randn(h, 4 * h))
    dg = torch.from_numpy(rng.randn(5, 4 * h))
    torch.testing.assert_close(
        tcell._cluster_bwd_product(dg, tcell._cluster_bwd_slices(wt, blocks)),
        dg @ wt.t(), rtol=1e-12, atol=1e-12)


def test_by_block_orders_each_blocks_columns_by_gate_then_unit():
    h = 40
    cols = torch.arange(4 * h, dtype=torch.float64)[None] + 1
    got = tcell._by_block(cols, 2, 4)[0]
    # block 1 owns units 32..39 (then zeros): column 32 q + j is gate q of
    # unit 32 + j
    for q in range(4):
        assert got[1, 32 * q:32 * q + 8].tolist() == [
            q * h + 32 + j + 1 for j in range(8)]
        assert got[1, 32 * q + 8:32 * q + 32].abs().sum() == 0
        assert got[0, 32 * q:32 * q + 32].tolist() == [
            q * h + j + 1 for j in range(32)]


def _grid_only(monkeypatch):
    """lstm_cell.cu's blocking everywhere: the plan refuses every shape."""
    real = tcell.cluster_plan
    monkeypatch.setattr(tcell, "cluster_plan",
                        lambda *a, **k: dict(real(*a, **k), take=False))


def _run(args):
    xg, w, h0, c0, mask, p, dhs, dcs = args
    hs, cs, st = tcell.lstm_forward_reference(xg, w, h0, c0, mask, p)
    return (hs, cs, st) + tuple(tcell.lstm_backward_reference(
        st, cs, w, p, c0, mask, dhs, dcs))


@pytest.mark.parametrize("dtype, shape", [
    (torch.float32, (5, 7, 40)), (BF16, (5, 7, 36)), (BF16, (3, 4, 1024))])
def test_float32_and_refused_shapes_keep_the_grid_blocking(monkeypatch,
                                                           dtype, shape):
    args = _inputs(*shape, 3, dtype)
    assert not tcell.cluster_plan(shape[0], shape[2], dtype)["take"]
    got = _run(args)
    _grid_only(monkeypatch)
    want = _run(args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_bf16_cluster_blocking_is_used_and_within_a_rounding(monkeypatch):
    """At a shape the plan takes, the bf16 plain versions sum in the
    cluster kernels' blocking (their bits differ from the grid
    blocking's), and both lie within one bfloat16 rounding of the
    float64 witness that rounds where the kernels round."""
    args = _inputs(21, 9, 96, 4)
    assert tcell.cluster_plan(21, 96)["take"]
    cluster = _run(args)
    f64 = [t.double() for t in args]
    whs, wcs, wst = tcell.lstm_forward_reference(*f64[:6], rounding=BF16)
    wb = tcell.lstm_backward_reference(wst, wcs, f64[1], f64[5], f64[3],
                                       f64[4], f64[6], f64[7], rounding=BF16)
    _grid_only(monkeypatch)
    grid = _run(args)
    assert not all(torch.equal(a, b) for a, b in zip(cluster, grid))
    for run in (cluster, grid):
        for a, b in zip(run[:3], (whs, wcs, wst)):
            _close(a, b)
    # the backward on the witness's own stash
    for run_plan in (False, True):
        if run_plan:
            monkeypatch.undo()
        xg, w, h0, c0, mask, p, dhs, dcs = args
        got = tcell.lstm_backward_reference(wst.to(BF16), wcs.float(), w, p,
                                            c0, mask, dhs, dcs)
        for a, b in zip(got, wb):
            _close(a, b)


def test_mask_for_tma_is_transposed_and_padded():
    mask = torch.tensor([[1.0, 1.0, 0.0], [1.0, 0.0, 0.0], [1.0, 1.0, 1.0],
                         [0.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    got = tcell._mask_t(mask)
    assert got.shape == (3, 8)
    assert torch.equal(got[:, :5], mask.t())
    assert got[:, 5:].abs().sum() == 0
