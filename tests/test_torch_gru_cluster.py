"""The bfloat16 GRU's cluster plan and the blocking its plain versions
follow, on the CPU (kernels/gru_cell.py; the kernels themselves are
csrc/gru_cluster.cu, held on the card by tests/test_torch_kernels_cuda.py).

* ``cluster_plan`` is a pure function of (B, H, dtype): bfloat16, H a
  multiple of 8, at most 16 blocks of 32 units, the shared memory of
  both kernels within the card's 232448 bytes; 16 rows a cluster.
* Under the plan the plain forward sums both products as the kernel's
  two warpgroups split K (``_split_k16_product``: each half of 512 units
  in k16 steps, half 0's sum first), and the plain backward adds one
  partial per block's columns in rank order (``_cluster_bwd_product``
  over 1 gate for drh and 2 for the carry, u's columns before r's): all
  are the plain products (float64, to rounding), and in bfloat16 both
  blockings lie within one bfloat16 rounding of the float64 witness.
* float32, and the bf16 shapes the plan refuses, keep gru_cell.cu's
  blocking bit for bit.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import gru_cell as tgru
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
    xg = torch.from_numpy(rng.randn(B, T, 3 * H) * 0.5).float()
    w = torch.from_numpy(rng.randn(H, 3 * H) * H ** -0.5).float()
    h0 = torch.from_numpy(rng.randn(B, H) * 0.1).float()
    lens = rng.randint(0, T + 1, B)
    lens[0], lens[-1] = 0, T
    mask = torch.from_numpy(
        (np.arange(T)[None] < lens[:, None]).astype(np.float32))
    dhs = torch.from_numpy(rng.randn(B, T, H)).float()
    return xg.to(dtype), w.to(dtype), h0, mask, dhs.to(dtype)


@pytest.mark.parametrize("b, h, take, blocks, groups", [
    (64, 512, True, 16, 4),      # the AMP seq2seq's shape
    (8, 32, True, 1, 1),
    (5, 40, True, 2, 1),         # H not a multiple of 32: edge units zero
    (200, 64, True, 2, 13),      # B not a multiple of 16: edge rows zero
    (16, 1024, False, 32, 1),    # W does not fit 16 blocks
    (5, 36, False, 2, 1),        # H not a multiple of 8
])
def test_cluster_plan_choices(b, h, take, blocks, groups):
    plan = tgru.cluster_plan(b, h, BF16)
    assert plan == dict(take=take, blocks=blocks, rows=16, units=32,
                        row_groups=groups)
    assert tgru.cluster_plan(b, h, torch.float32)["take"] is False


def test_cluster_plan_shared_memory():
    # the path's shape fits both kernels (the sizes gru_cluster.cu
    # computes); 32 rows a cluster would not
    assert tgru.cluster_smem("gru_fwd", 16) == 177152
    assert tgru.cluster_smem("gru_bwd", 16) == 162816
    for kind in ("gru_fwd", "gru_bwd"):
        for blocks in (1, 2, 16):
            assert tgru.cluster_smem(kind, blocks) <= tgru.SMEM_LIMIT
        assert tgru.cluster_smem(kind, 16, 32) > tgru.SMEM_LIMIT


@pytest.mark.parametrize("k, n", [(512, 1024), (300, 64), (40, 80), (7, 12)])
def test_split_k16_product_is_the_plain_product(k, n):
    """Both K halves (split at 256 units: for K <= 256 half 1 is zero)."""
    rng = np.random.RandomState(k)
    x = torch.from_numpy(rng.randn(5, k))
    w = torch.from_numpy(rng.randn(k, n))
    torch.testing.assert_close(
        tgru._split_k16_product(x, tcell._k16_slices(w)), x @ w,
        rtol=1e-12, atol=1e-12)


def test_split_k16_product_adds_the_halves_in_order():
    """Half 0's k16 sum plus half 1's, each summed in order: in float32
    the bits are those of that order (not of one sum over K)."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(6, 512)).float()
    w = torch.from_numpy(rng.randn(512, 48)).float()
    ws = tcell._k16_slices(w)
    part = torch.einsum("bsk,skn->sbn", x.reshape(6, 32, 16), ws)
    halves = []
    for lo in (0, 16):
        acc = part[lo]
        for s in range(lo + 1, lo + 16):
            acc = acc + part[s]
        halves.append(acc)
    assert torch.equal(tgru._split_k16_product(x, ws), halves[0] + halves[1])
    assert not torch.equal(tgru._split_k16_product(x, ws),
                           tcell._k16_product(x, ws))


@pytest.mark.parametrize("h", [512, 40, 7])
def test_cluster_bwd_products_are_the_plain_products(h):
    """drh = da_c w_c^T (1 gate) and the carry da_ur w_ur^T (2 gates) as
    the blocks form them."""
    rng = np.random.RandomState(h)
    blocks = -(-h // 32)
    w = torch.from_numpy(rng.randn(h, 3 * h))
    d = torch.from_numpy(rng.randn(5, 3 * h))
    for cols in (slice(2 * h, 3 * h), slice(0, 2 * h)):
        ws = tcell._cluster_bwd_slices(w[:, cols], blocks)
        assert ws.shape[:3] == (blocks, 2 * ((cols.stop - cols.start) // h),
                                16)
        torch.testing.assert_close(
            tcell._cluster_bwd_product(d[:, cols], ws), d[:, cols] @ w[:,
                                                                     cols].t(),
            rtol=1e-12, atol=1e-12)


def test_by_block_orders_each_blocks_columns_by_gate_then_unit():
    """The carry's K: block r's column 32 q + j is gate q (u, r) of unit
    32 r + j, u's 32 columns before r's."""
    h = 40
    cols = torch.arange(2 * h, dtype=torch.float64)[None] + 1
    got = tcell._by_block(cols, 2, 2)[0]
    assert got.shape == (2, 64)
    for q in range(2):
        assert got[1, 32 * q:32 * q + 8].tolist() == [
            q * h + 32 + j + 1 for j in range(8)]
        assert got[1, 32 * q + 8:32 * q + 32].abs().sum() == 0
        assert got[0, 32 * q:32 * q + 32].tolist() == [
            q * h + j + 1 for j in range(32)]


def _grid_only(monkeypatch):
    """gru_cell.cu's blocking everywhere: the plan refuses every shape."""
    real = tgru.cluster_plan
    monkeypatch.setattr(tgru, "cluster_plan",
                        lambda *a, **k: dict(real(*a, **k), take=False))


def _run(args):
    xg, w, h0, mask, dhs = args
    hs, st = tgru.gru_forward_reference(xg, w, h0, mask)
    return (hs, st) + tuple(tgru.gru_backward_reference(st, hs, w, h0, mask,
                                                        dhs))


@pytest.mark.parametrize("dtype, shape", [
    (torch.float32, (5, 7, 40)), (BF16, (5, 7, 36)), (BF16, (3, 4, 1024))])
def test_float32_and_refused_shapes_keep_the_grid_blocking(monkeypatch,
                                                           dtype, shape):
    args = _inputs(*shape, 3, dtype)
    assert not tgru.cluster_plan(shape[0], shape[2], dtype)["take"]
    got = _run(args)
    _grid_only(monkeypatch)
    want = _run(args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [(21, 9, 96), (18, 6, 288)])
def test_bf16_cluster_blocking_is_used_and_within_a_rounding(monkeypatch,
                                                             shape):
    """At a shape the plan takes (H 288: both of the forward's K halves
    hold units), the bf16 plain versions sum in the cluster kernels'
    blocking (their bits differ from the grid blocking's), and both lie
    within one bfloat16 rounding of the float64 witness that rounds where
    the kernels round."""
    args = _inputs(*shape, 4)
    assert tgru.cluster_plan(shape[0], shape[2])["take"]
    cluster = _run(args)
    f64 = [t.double() for t in args]
    whs, wst = tgru.gru_forward_reference(*f64[:4], rounding=BF16)
    wb = tgru.gru_backward_reference(wst, whs, *f64[1:], rounding=BF16)
    _grid_only(monkeypatch)
    grid = _run(args)
    assert not all(torch.equal(a, b) for a, b in zip(cluster, grid))
    for run in (cluster, grid):
        for a, b in zip(run[:2], (whs, wst)):
            _close(a, b)
    # the backward on the witness's own stash, in each blocking
    xg, w, h0, mask, dhs = args
    for run_plan in (False, True):
        if run_plan:
            monkeypatch.undo()
        got = tgru.gru_backward_reference(wst.to(BF16), whs.to(BF16), w, h0,
                                          mask, dhs)
        for a, b in zip(got, wb):
            _close(a, b)


def test_cpu_dispatch_counts_no_launch():
    """On the CPU the wrappers run the plain versions: no launch is
    counted, whatever plan the shape takes."""
    tgru.reset_launches()
    for shape in ((5, 3, 40), (3, 2, 36)):
        xg, w, h0, mask, dhs = _inputs(*shape, 5)
        hs, st = tgru.gru_forward(xg, w, h0, mask)
        tgru.gru_backward(st, hs, w, h0, mask, dhs)
    assert set(tgru.launches.values()) == {0}


@pytest.mark.parametrize("b", [8, 5])
def test_mask_for_tma_is_transposed_and_padded_to_four_rows(b):
    """The mask the cluster kernels read by TMA: [T, B] with B padded to
    a multiple of 4 (16-byte rows), the padding zero (B 8: no padding)."""
    mask = (torch.arange(6)[None] < torch.arange(b)[:, None]).float()
    got = tcell._mask_t(mask)
    assert got.shape == (6, -(-b // 4) * 4) and got.is_contiguous()
    assert torch.equal(got[:, :b], mask.t())
    assert got[:, b:].abs().sum() == 0
