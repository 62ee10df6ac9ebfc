"""The GRU on the CPU against the JAX package: the plain versions of the
forward (B5) and backward (B6) kernels against the JAX Pallas kernel in
interpret mode and its VJP, and the ``gru`` op and its generic grad
against the JAX op lowering, both directions.

Tolerances as tests/test_gru_kernel.py pins them: hs rtol 1e-5 (atol
1e-6), gradients rtol 1e-4 (atol 1e-6): the same fp32 math in another
summation order.

The one intended difference: the JAX lowering writes a reverse GRU's
outputs back with a scatter whose clipped duplicate indices zero
position 0 of every row shorter than the batch's longest; the port
gathers instead. Ragged reverse cases compare everywhere else, and
``test_reverse_short_rows_keep_position_0`` shows the difference."""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import registry as jreg
from paddle_tpu.core.lower import PackedSeq as JSeq
from paddle_tpu.core.lower import TraceContext as JCtx
from paddle_tpu.kernels import gru_cell as jcell
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.lower import PackedSeq as TSeq
from paddle_tpu_torch.core.lower import TraceContext as TCtx
from paddle_tpu_torch.kernels import gru_cell as tcell

import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)
import paddle_tpu_torch.ops  # noqa: F401

# Under pytest-xdist each worker takes its share of the cores for
# torch's intra-op threads: six workers at torch's default thread count
# oversubscribe the cores, and a test of seconds then takes minutes.
_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, os.cpu_count() // int(_WORKERS)))


def _setup(T=6, B=8, H=32, seed=0):
    """tests/test_gru_kernel.py's inputs, as numpy."""
    rng = np.random.RandomState(seed)
    xg = rng.randn(B, T, 3 * H).astype(np.float32) * 0.5
    w = rng.randn(H, 3 * H).astype(np.float32) * 0.2
    h0 = rng.randn(B, H).astype(np.float32) * 0.1
    lens = rng.randint(2, T + 1, B)
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    return xg, w, h0, mask


def _t(a):
    return torch.tensor(a)


def _close(got, want, rtol, atol=1e-6, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


# ---- B5 / B6: plain versions against the JAX kernel ----

@pytest.mark.parametrize("shape", [(6, 8, 32), (5, 4, 32), (7, 3, 8)])
def test_forward_plain_matches_jax_kernel(shape):
    T, B, H = shape
    xg, w, h0, mask = _setup(T=T, B=B, H=H)
    jhs = jcell.gru_sequence(*(jnp.asarray(a) for a in (xg, w, h0, mask)),
                             interpret=True)
    ths = tcell.gru_sequence(_t(xg), _t(w), _t(h0), _t(mask))
    _close(ths, jhs, 1e-5, what="hs")
    rhs, _ = tcell.gru_forward_reference(_t(xg), _t(w), _t(h0), _t(mask))
    assert torch.equal(rhs, ths)


@pytest.mark.parametrize("shape", [(6, 8, 32), (5, 3, 8), (4, 3, 200)])
def test_backward_plain_matches_jax_vjp(shape):
    """H = 200: a partial chunk of 128, a partial stage and an odd pair
    (the second block of the last pair has no unit); _setup's masks are
    ragged."""
    T, B, H = shape
    xg, w, h0, mask = _setup(T=T, B=B, H=H)
    if H > 32:
        w = w * 0.3
    dhs = np.random.RandomState(5).randn(B, T, H).astype(np.float32)

    def jf(xg, w, h0):
        return jcell.gru_sequence(xg, w, h0, jnp.asarray(mask),
                                  interpret=True)

    _, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in (xg, w, h0)))
    want = vjp(jnp.asarray(dhs))

    leaves = [torch.tensor(a, requires_grad=True) for a in (xg, w, h0)]
    hs = tcell.gru_sequence(leaves[0], leaves[1], leaves[2], _t(mask))
    got = torch.autograd.grad(hs, leaves, _t(dhs))
    for name, g, j in zip(("dxg", "dw", "dh0"), got, want):
        _close(g, j, 1e-4, what=name)


def test_backward_plain_is_the_kernels_arithmetic_not_autograd():
    """gru_backward_reference on the forward's stash equals autograd of
    the step loop (float64, so only the formulas can differ); masked
    steps get no gate gradient."""
    xg, w, h0, mask = (torch.tensor(a, dtype=torch.float64)
                       for a in _setup(T=5, B=3, H=8))
    hs, stash = tcell.gru_forward_reference(xg, w, h0, mask)
    dhs = torch.randn(hs.shape, generator=torch.Generator().manual_seed(0),
                      dtype=torch.float64)
    dxg, dh0 = tcell.gru_backward_reference(stash, hs, w, h0, mask, dhs)
    leaves = [t.clone().requires_grad_() for t in (xg, h0)]
    rhs, _ = tcell.gru_forward_reference(leaves[0], w, leaves[1], mask)
    want = torch.autograd.grad(rhs, leaves, dhs)
    for got, ref in zip((dxg, dh0), want):
        torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-12)
    assert not dxg[mask == 0].any()


def test_forward_plain_sums_like_the_kernel_and_like_one_matmul():
    """gru_forward_reference sums both products in the forward kernel's
    blocking (chunks of 128, 32-deep stages, warp order); at H = 200 (a
    partial chunk and a partial stage) it agrees with the step loop of
    plain matmuls to float32 rounding."""
    xg, w, h0, mask = (_t(a) for a in _setup(T=6, B=5, H=200, seed=3))
    w = w * 0.3
    hs, stash = tcell.gru_forward_reference(xg, w, h0, mask)
    h = 200
    h_prev, want = h0, []
    for t in range(6):
        a = xg[:, t, :2 * h] + h_prev @ w[:, :2 * h]
        u, r = torch.sigmoid(a[:, :h]), torch.sigmoid(a[:, h:])
        c = torch.tanh(xg[:, t, 2 * h:] + (r * h_prev) @ w[:, 2 * h:])
        m = mask[:, t, None]
        h_prev = m * (u * h_prev + (1 - u) * c) + (1 - m) * h_prev
        want.append(h_prev)
    _close(hs, torch.stack(want, 1), 1e-5, atol=1e-6, what="hs")
    assert stash.shape == (5, 6, 600)


def test_backward_plain_sums_like_the_kernel_and_like_one_matmul():
    """gru_backward_reference sums drh and the carry in the backward
    kernel's blocking (chunks of 128, 32-deep stages, warp order; the
    carry as two halves of K = 2H, da_u w_u^T first); at H = 200 (a
    partial chunk, a partial stage, an odd pair) it agrees with the step
    loop of plain matmuls to float32 rounding."""
    xg, w, h0, mask = (_t(a) for a in _setup(T=6, B=5, H=200, seed=3))
    w = w * 0.3
    h = 200
    hs, stash = tcell.gru_forward_reference(xg, w, h0, mask)
    dhs = torch.randn(hs.shape, generator=torch.Generator().manual_seed(1))
    dxg, dh0 = tcell.gru_backward_reference(stash, hs, w, h0, mask, dhs)
    dh_c, want = torch.zeros(5, h), torch.zeros(5, 6, 3 * h)
    for t in range(5, -1, -1):
        u, r, c = stash[:, t, :h], stash[:, t, h:2 * h], stash[:, t, 2 * h:]
        h_prev = hs[:, t - 1] if t else h0
        m = mask[:, t, None]
        dh = dhs[:, t] + dh_c
        da_c = m * dh * (1 - u) * (1 - c * c)
        drh = da_c @ w[:, 2 * h:].t()
        da_ur = torch.cat([m * dh * (h_prev - c) * u * (1 - u),
                           m * drh * h_prev * r * (1 - r)], dim=-1)
        want[:, t] = torch.cat([da_ur, da_c], dim=-1)
        dh_c = ((dh * u + drh * r) * m + (1 - m) * dh
                + da_ur @ w[:, :2 * h].t())
    _close(dxg, want, 1e-5, atol=1e-6, what="dxg")
    _close(dh0, dh_c, 1e-5, atol=1e-6, what="dh0")
    assert not dxg[mask == 0].any()


def test_launch_plan_cuts_the_path_shape_into_row_groups():
    """B5 at the seq2seq path's [64, T, 512] on an H100 (132 SMs): 2 row
    groups of 32 rows x 64 blocks of 8 units = 128 blocks, both row
    groups at once, 160 KB of shared memory a block; each block reads
    its row group's h_{t-1} and r h_{t-1} a step. B6 at the same shape:
    2 row groups x 32 pairs of blocks in clusters of two = 128 blocks,
    both at once; each block reads its half of da_ur and all of da_c, as
    many bytes as B5 reads. Past residency (shared memory beyond 227 KB,
    or a row group wider than the SMs) each raises."""
    plan = tcell.launch_plan("gru_fwd", 64, 512, sms=132)
    assert plan == dict(cluster=1, blocks=128, rows_in_flight=2, rounds=1,
                        smem_bytes=163840,
                        exchange_bytes=2 * 64 * 2 * 32 * 512 * 4)
    assert plan["smem_bytes"] <= tcell.H100_MAX_SMEM
    bwd = tcell.launch_plan("gru_bwd", 64, 512, sms=132)
    assert bwd == dict(cluster=2, blocks=128, rows_in_flight=2, rounds=1,
                       smem_bytes=163840 + 2 * 256 * 4 + 8,
                       exchange_bytes=plan["exchange_bytes"])
    assert bwd["exchange_bytes"] == 16777216
    # more rows than fit at once: row groups take turns
    for kind in ("gru_fwd", "gru_bwd"):
        big = tcell.launch_plan(kind, 200, 512, sms=132)
        assert (big["blocks"], big["rows_in_flight"], big["rounds"]) == \
            (128, 2, 4)
    assert tcell.launch_plan("gru_fwd", 3, 20, sms=132)["blocks"] == 3
    # an odd pair: the second block of the last one has no unit
    assert tcell.launch_plan("gru_bwd", 3, 20, sms=132)["blocks"] == 4
    assert tcell.launch_plan("gru_fwd", 64, 864, sms=132)["blocks"] == 108
    assert tcell.launch_plan("gru_bwd", 64, 856, sms=132)["blocks"] == 108
    with pytest.raises(ValueError, match="resident"):
        tcell.launch_plan("gru_fwd", 64, 872, sms=132)   # W past 227 KB
    with pytest.raises(ValueError, match="resident"):
        tcell.launch_plan("gru_bwd", 64, 864, sms=132)   # past 227 KB
    with pytest.raises(ValueError, match="resident"):
        tcell.launch_plan("gru_fwd", 64, 512, sms=63)    # 64 blocks a group
    with pytest.raises(ValueError, match="resident"):
        tcell.launch_plan("gru_bwd", 64, 512, sms=63)


def test_meta_tensors_get_shapes_only():
    m = torch.device("meta")
    hs = tcell.gru_sequence(torch.empty(3, 7, 12, device=m),
                            torch.empty(4, 12, device=m),
                            torch.empty(3, 4, device=m),
                            torch.empty(3, 7, device=m))
    assert hs.shape == (3, 7, 4) and hs.device.type == "meta"


def test_cpu_runs_the_plain_versions_and_counts_no_launch():
    tcell.reset_launches()
    xg, w, h0, mask = (_t(a) for a in _setup(T=3, B=2, H=4))
    leaves = [t.clone().requires_grad_() for t in (xg, w, h0)]
    hs = tcell.gru_sequence(leaves[0], leaves[1], leaves[2], mask)
    torch.autograd.grad(hs.sum(), leaves)
    assert tcell.launches == {"gru_fwd": 0, "gru_bwd": 0, "gru_fwd_bf16": 0,
                              "gru_bwd_bf16": 0}


# ---- the gru op and its generic grad against the JAX op ----

def _op_inputs(B, T, H, lens, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, 3 * H).astype(np.float32) * 0.5
    x *= (np.arange(T)[None, :] < np.asarray(lens)[:, None])[..., None]
    w = rng.randn(H, 3 * H).astype(np.float32) * 0.3
    b = rng.randn(1, 3 * H).astype(np.float32) * 0.2
    dh = rng.randn(B, T, H).astype(np.float32)
    return x, w, b, dh, np.asarray(lens, np.int32)


def _jax_op(x, w, b, lens, attrs, dh):
    spec = jreg.get("gru")

    def f(x, w, b):
        out = spec.lower(JCtx(), {"Input": [JSeq(x, jnp.asarray(lens))],
                                  "Weight": [w], "Bias": [b]}, attrs, None)
        return out["Hidden"].data

    hs, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (x, w, b)))
    return np.asarray(hs), [np.asarray(g) for g in vjp(jnp.asarray(dh))]


def _port_op(x, w, b, lens, attrs, dh):
    spec = treg.get("gru")
    op = types.SimpleNamespace(attrs=attrs, uid=1, type="gru")
    lengths = torch.tensor(lens)
    ins = {"Input": [TSeq(_t(x), lengths)], "Weight": [_t(w)],
           "Bias": [_t(b)]}
    with torch.no_grad():
        out = spec.lower(TCtx(), ins, attrs, op)
    grads = treg.generic_grad(TCtx(), spec, op, ins,
                              {"Hidden": [TSeq(_t(dh), lengths)]})
    gx = grads["Input"][0]
    assert isinstance(gx, TSeq) and gx.lengths is lengths
    return (out["Hidden"].data.numpy(),
            [gx.data.numpy(), grads["Weight"][0].numpy(),
             grads["Bias"][0].numpy()])


def _short_pos0(lens, T):
    """[B, T] True at position 0 of rows shorter than T."""
    keep = np.zeros((len(lens), T), bool)
    keep[np.asarray(lens) < T, 0] = True
    return keep


@pytest.mark.parametrize("acts", ["default", "relu"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("lens", [[5, 5, 5], [5, 2, 4], [5, 1, 0]],
                         ids=["equal", "ragged", "ragged_with_empty"])
def test_gru_op_and_grad_match_jax(reverse, lens, acts):
    """Default activations run the kernels' path; others the step loop."""
    B, T, H = len(lens), 5, 6
    x, w, b, dh, lens = _op_inputs(B, T, H, lens)
    attrs = {"is_reverse": reverse, "activation": "tanh",
             "gate_activation": "sigmoid"}
    if acts != "default":
        attrs["activation"] = "relu"
    skip = _short_pos0(lens, T) if reverse else np.zeros((B, T), bool)
    # no cotangent where the packages differ, so the gradients compare
    dh[skip] = 0.0
    jhs, jg = _jax_op(x, w, b, lens, attrs, dh)
    ths, tg = _port_op(x, w, b, lens, attrs, dh)
    _close(ths[~skip], jhs[~skip], 1e-5, what="hidden")
    for name, g, j in zip(("dInput", "dWeight", "dBias"), tg, jg):
        _close(g, j, 1e-4, what=name)


def _np_gru_rows(x, w, b, lens, reverse):
    """numpy step reference of the gru op, row by row over each row's
    valid prefix."""
    H = w.shape[0]
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))
    out = np.zeros(x.shape[:2] + (H,), np.float64)
    for row, n in enumerate(lens):
        h = np.zeros(H)
        order = range(n - 1, -1, -1) if reverse else range(n)
        for p in order:
            g = x[row, p] + b[0]
            u = sig(g[:H] + h @ w[:, :H])
            r = sig(g[H:2 * H] + h @ w[:, H:2 * H])
            c = np.tanh(g[2 * H:] + (r * h) @ w[:, 2 * H:])
            h = u * h + (1 - u) * c
            out[row, p] = h
    return out


@pytest.mark.parametrize("reverse", [False, True])
def test_ragged_rows_match_a_numpy_step_reference(reverse):
    x, w, b, dh, lens = _op_inputs(4, 6, 5, [6, 2, 0, 4], seed=2)
    attrs = {"is_reverse": reverse}
    want = _np_gru_rows(x.astype(np.float64), w, b, lens, reverse)
    ths, _ = _port_op(x, w, b, lens, attrs, dh)
    np.testing.assert_allclose(ths, want, rtol=1e-5, atol=1e-6)


def test_reverse_short_rows_keep_position_0():
    """lengths [5, 2], T=5, reverse: the port's position 0 of the short
    row is the last step of its reverse walk, as the numpy step
    reference computes it; the JAX lowering's duplicate-index scatter
    leaves 0 there. It is the position seq2seq's decoder starts from
    (sequence_first_step of the reverse encoder)."""
    x, w, b, dh, lens = _op_inputs(2, 5, 4, [5, 2], seed=3)
    attrs = {"is_reverse": True}
    want = _np_gru_rows(x.astype(np.float64), w, b, lens, reverse=True)
    ths, _ = _port_op(x, w, b, lens, attrs, dh)
    jhs, _ = _jax_op(x, w, b, lens, attrs, dh)
    np.testing.assert_allclose(ths, want, rtol=1e-5, atol=1e-6)
    assert np.abs(want[1, 0]).max() > 1e-3
    assert not np.asarray(jhs[1, 0]).any(), "the JAX fault is fixed?"
    ok = np.ones((2, 5), bool)
    ok[1, 0] = False
    np.testing.assert_allclose(jhs[ok], want[ok], rtol=1e-5, atol=1e-6)
