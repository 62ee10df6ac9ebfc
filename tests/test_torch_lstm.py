"""The LSTM on the CPU against the JAX package: the plain versions of the
forward (B3) and backward (B4) kernels against the JAX Pallas kernel in
interpret mode and its VJP, and the ``lstm`` op and its generic grad
against the JAX op lowering, both directions.

Tolerances as tests/test_lstm_kernel.py pins them: hs/cs rtol 1e-5
(atol 1e-6), gradients rtol 1e-4 (atol 1e-6): the same fp32 math in
another summation order.

The one intended difference: the JAX lowering writes a reverse LSTM's
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
from paddle_tpu.kernels import lstm_cell as jcell
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.lower import PackedSeq as TSeq
from paddle_tpu_torch.core.lower import TraceContext as TCtx
from paddle_tpu_torch.kernels import lstm_cell as tcell

import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)
import paddle_tpu_torch.ops  # noqa: F401

# Under pytest-xdist each worker takes its share of the cores for
# torch's intra-op threads: six workers at torch's default thread count
# oversubscribe the cores, and a test of seconds then takes minutes.
_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, os.cpu_count() // int(_WORKERS)))


def _setup(T=6, B=8, H=32, seed=0, peep=True):
    """tests/test_lstm_kernel.py's inputs, as numpy."""
    rng = np.random.RandomState(seed)
    xg = rng.randn(B, T, 4 * H).astype(np.float32) * 0.5
    w = rng.randn(H, 4 * H).astype(np.float32) * 0.2
    h0 = rng.randn(B, H).astype(np.float32) * 0.1
    c0 = rng.randn(B, H).astype(np.float32) * 0.1
    lens = rng.randint(2, T + 1, B)
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    p = rng.randn(3, H).astype(np.float32) * 0.1 if peep else None
    return xg, w, h0, c0, mask, p


def _t(a):
    return None if a is None else torch.tensor(a)


def _close(got, want, rtol, atol=1e-6, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


# ---- B3 / B4: plain versions against the JAX kernel ----

@pytest.mark.parametrize("peep", [True, False])
@pytest.mark.parametrize("shape", [(6, 8, 32), (5, 4, 32), (7, 3, 8)])
def test_forward_plain_matches_jax_kernel(shape, peep):
    T, B, H = shape
    xg, w, h0, c0, mask, p = _setup(T=T, B=B, H=H, peep=peep)
    jhs, jcs = jcell.lstm_sequence(jnp.asarray(xg), jnp.asarray(w),
                                   jnp.asarray(h0), jnp.asarray(c0),
                                   jnp.asarray(mask),
                                   None if p is None else jnp.asarray(p),
                                   interpret=True)
    ths, tcs = tcell.lstm_sequence(_t(xg), _t(w), _t(h0), _t(c0), _t(mask),
                                   _t(p))
    _close(ths, jhs, 1e-5, what="hs")
    _close(tcs, jcs, 1e-5, what="cs")
    rhs, rcs = tcell.lstm_sequence_reference(_t(xg), _t(w), _t(h0), _t(c0),
                                             _t(mask), _t(p))
    assert torch.equal(rhs, ths) and torch.equal(rcs, tcs)


@pytest.mark.parametrize("peep", [True, False])
def test_backward_plain_matches_jax_vjp(peep):
    xg, w, h0, c0, mask, p = _setup(peep=peep)
    if p is None:
        p = np.zeros((3, w.shape[0]), np.float32)
    rng = np.random.RandomState(5)
    dhs = rng.randn(*xg.shape[:2], w.shape[0]).astype(np.float32)
    dcs = rng.randn(*dhs.shape).astype(np.float32)

    def jf(xg, w, p, h0, c0):
        return jcell.lstm_sequence(xg, w, h0, c0, jnp.asarray(mask), p,
                                   interpret=True)

    _, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in (xg, w, p, h0, c0)))
    want = vjp((jnp.asarray(dhs), jnp.asarray(dcs)))

    leaves = [torch.tensor(a, requires_grad=True) for a in (xg, w, p, h0, c0)]
    hs, cs = tcell.lstm_sequence(leaves[0], leaves[1], leaves[3], leaves[4],
                                 _t(mask), leaves[2])
    got = torch.autograd.grad((hs, cs), leaves, (_t(dhs), _t(dcs)))
    for name, g, j in zip(("dxg", "dw", "dpeep", "dh0", "dc0"), got, want):
        _close(g, j, 1e-4, what=name)


def test_backward_plain_is_the_kernels_arithmetic_not_autograd():
    """lstm_backward_reference on the forward's stash equals autograd of
    the step loop (float64, so only the formulas can differ)."""
    xg, w, h0, c0, mask, p = (torch.tensor(a, dtype=torch.float64)
                              for a in _setup(T=5, B=3, H=8))
    hs, cs, stash = tcell.lstm_forward_reference(xg, w, h0, c0, mask, p)
    g = torch.Generator().manual_seed(0)
    dhs = torch.randn(hs.shape, generator=g, dtype=torch.float64)
    dcs = torch.randn(cs.shape, generator=g, dtype=torch.float64)
    dxg, dh0, dc0, dp = tcell.lstm_backward_reference(
        stash, cs, w, p, c0, mask, dhs, dcs)
    leaves = [t.clone().requires_grad_() for t in (xg, h0, c0, p)]
    rhs, rcs, _ = tcell.lstm_forward_reference(
        leaves[0], w, leaves[1], leaves[2], mask, leaves[3])
    want = torch.autograd.grad((rhs, rcs), leaves, (dhs, dcs))
    for got, ref in zip((dxg, dh0, dc0, dp), want):
        torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-12)


def test_meta_tensors_get_shapes_only():
    m = torch.device("meta")
    hs, cs = tcell.lstm_sequence(torch.empty(3, 7, 16, device=m),
                                 torch.empty(4, 16, device=m),
                                 torch.empty(3, 4, device=m),
                                 torch.empty(3, 4, device=m),
                                 torch.empty(3, 7, device=m))
    assert hs.shape == cs.shape == (3, 7, 4) and hs.device.type == "meta"


# ---- the lstm op and its generic grad against the JAX op ----

def _op_inputs(B, T, H, lens, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, 4 * H).astype(np.float32) * 0.5
    x *= (np.arange(T)[None, :] < np.asarray(lens)[:, None])[..., None]
    w = rng.randn(H, 4 * H).astype(np.float32) * 0.3
    b = rng.randn(1, 7 * H).astype(np.float32) * 0.2
    dh = rng.randn(B, T, H).astype(np.float32)
    dc = rng.randn(B, T, H).astype(np.float32)
    return x, w, b, dh, dc, np.asarray(lens, np.int32)


def _jax_op(x, w, b, lens, attrs, dh, dc):
    spec = jreg.get("lstm")

    def f(x, w, b):
        out = spec.lower(JCtx(), {"Input": [JSeq(x, jnp.asarray(lens))],
                                  "Weight": [w], "Bias": [b]}, attrs, None)
        return out["Hidden"].data, out["Cell"].data

    (hs, cs), vjp = jax.vjp(f, *(jnp.asarray(a) for a in (x, w, b)))
    return (np.asarray(hs), np.asarray(cs),
            [np.asarray(g) for g in vjp((jnp.asarray(dh), jnp.asarray(dc)))])


def _port_op(x, w, b, lens, attrs, dh, dc):
    spec = treg.get("lstm")
    op = types.SimpleNamespace(attrs=attrs, uid=1, type="lstm")
    lengths = torch.tensor(lens)
    ins = {"Input": [TSeq(_t(x), lengths)], "Weight": [_t(w)],
           "Bias": [_t(b)]}
    with torch.no_grad():
        out = spec.lower(TCtx(), ins, attrs, op)
    grads = treg.generic_grad(
        TCtx(), spec, op, ins,
        {"Hidden": [TSeq(_t(dh), lengths)], "Cell": [TSeq(_t(dc), lengths)]})
    gx = grads["Input"][0]
    assert isinstance(gx, TSeq) and gx.lengths is lengths
    return (out["Hidden"].data.numpy(), out["Cell"].data.numpy(),
            [gx.data.numpy(), grads["Weight"][0].numpy(),
             grads["Bias"][0].numpy()])


def _short_pos0(lens, T):
    """[B, T] True at position 0 of rows shorter than T."""
    keep = np.zeros((len(lens), T), bool)
    keep[np.asarray(lens) < T, 0] = True
    return keep


@pytest.mark.parametrize("acts", ["default", "relu_identity"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("lens", [[5, 5, 5], [5, 2, 4], [5, 1, 0]],
                         ids=["equal", "ragged", "ragged_with_empty"])
def test_lstm_op_and_grad_match_jax(reverse, lens, acts):
    """Default activations run the kernels' path; others the step loop."""
    B, T, H = len(lens), 5, 6
    x, w, b, dh, dc, lens = _op_inputs(B, T, H, lens)
    attrs = {"use_peepholes": True, "is_reverse": reverse}
    if acts != "default":
        attrs.update(cell_activation="relu", candidate_activation="identity")
    skip = _short_pos0(lens, T) if reverse else np.zeros((B, T), bool)
    # no cotangent where the packages differ, so the gradients compare
    dh[skip] = 0.0
    dc[skip] = 0.0
    jhs, jcs, jg = _jax_op(x, w, b, lens, attrs, dh, dc)
    ths, tcs, tg = _port_op(x, w, b, lens, attrs, dh, dc)
    _close(ths[~skip], jhs[~skip], 1e-5, what="hidden")
    _close(tcs[~skip], jcs[~skip], 1e-5, what="cell")
    for name, g, j in zip(("dInput", "dWeight", "dBias"), tg, jg):
        _close(g, j, 1e-4, what=name)


def _np_lstm_rows(x, w, b, lens, reverse):
    """numpy step reference of the lstm op (peepholes from the bias),
    row by row over each row's valid prefix."""
    H = w.shape[0]
    bias, peep = b[0, :4 * H], b[0, 4 * H:].reshape(3, H)
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))
    out = np.zeros(x.shape[:2] + (H,), np.float64)
    for r, n in enumerate(lens):
        h = np.zeros(H)
        c = np.zeros(H)
        order = range(n - 1, -1, -1) if reverse else range(n)
        for p in order:
            g = x[r, p] + bias + h @ w
            i = sig(g[:H] + c * peep[0])
            f = sig(g[2 * H:3 * H] + c * peep[1])
            c = f * c + i * np.tanh(g[H:2 * H])
            h = sig(g[3 * H:] + c * peep[2]) * np.tanh(c)
            out[r, p] = h
    return out


def test_reverse_short_rows_keep_position_0():
    """lengths [5, 2], T=5, reverse: the port's position 0 of the short
    row is the last step of its reverse walk, as a numpy step reference
    computes it; the JAX lowering's duplicate-index scatter leaves 0
    there."""
    x, w, b, dh, dc, lens = _op_inputs(2, 5, 4, [5, 2], seed=3)
    attrs = {"use_peepholes": True, "is_reverse": True}
    want = _np_lstm_rows(x.astype(np.float64), w, b, lens, reverse=True)
    ths, _, _ = _port_op(x, w, b, lens, attrs, dh, dc)
    jhs, _, _ = _jax_op(x, w, b, lens, attrs, dh, dc)
    np.testing.assert_allclose(ths, want, rtol=1e-5, atol=1e-6)
    assert np.abs(want[1, 0]).max() > 1e-3
    assert not np.asarray(jhs[1, 0]).any(), "the JAX fault is fixed?"
    # everywhere else the JAX package agrees with the reference
    ok = np.ones((2, 5), bool)
    ok[1, 0] = False
    np.testing.assert_allclose(jhs[ok], want[ok], rtol=1e-5, atol=1e-6)


# ---- the kernels' blocking and their arithmetic on the tensor cores ----

@pytest.mark.parametrize("k,n", [(8, 32), (36, 144), (128, 512), (300, 40),
                                 (528, 64)])
def test_blocked_products_are_the_plain_products(k, n):
    """The plain versions' products, summed in the kernels' order (chunks
    of CHUNK, STAGE_K slices, warps by chunk parity), are the plain
    products: in float64 they agree to rounding."""
    rng = np.random.RandomState(k)
    x = torch.from_numpy(rng.randn(5, k))
    w = torch.from_numpy(rng.randn(k, n))
    torch.testing.assert_close(tcell._product(x, tcell._stages(w)), x @ w,
                               rtol=1e-12, atol=1e-12)
    h = n // 4
    wt = torch.from_numpy(rng.randn(h, 4 * h))
    dg = torch.from_numpy(rng.randn(5, 4 * h))
    torch.testing.assert_close(
        tcell._bwd_product(dg, tcell._bwd_stages(wt)), dg @ wt.t(),
        rtol=1e-12, atol=1e-12)


def test_plans_cut_the_path_shape_into_chunks_and_row_groups():
    # [64, 80, 512]: h_{t-1} in 4 chunks of 128 units, dgates_t in two
    # halves of 8 chunks; two row groups of 32 rows
    assert tcell.fwd_plan(64, 512) == (4, 2)
    assert tcell.bwd_plan(64, 512) == (8, 2)
    assert tcell.fwd_plan(1, 40) == (1, 1)
    assert tcell.bwd_plan(70, 40) == (1, 3)


def _tf32(x):
    """float32 cut to TF32's 10 mantissa bits (csrc/tf32x3.cuh's split)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _rz32(v):
    """float64 to float32 rounded toward zero."""
    f = v.float()
    over = f.double().abs() > v.abs()
    return torch.where(over, (f.view(torch.int32) - 1).view(torch.float32),
                       f)


def _tensor_core_product(x, w, stages=True):
    """x [B, K] @ w [K, N] with a model of the kernels' 3xTF32 product on
    the tensor cores: each operand split into big = tf32(v) and small =
    tf32(v - big); each m16n8k8 product (8 deep) added to its accumulator
    with rounding toward zero, as the card's accumulation drifts. With
    ``stages``, as the kernels form it: big*big and the two small cross
    products of each 32-deep stage in fresh accumulators, the stage's sum
    added to the warp's in float32, the warps' sums added in order (the
    order of tcell._product). Without, one chain over all of K."""
    b, k = x.shape
    nc = -(-k // tcell.CHUNK)
    xp = torch.zeros(b, nc * tcell.CHUNK)
    xp[:, :k] = x
    wp = torch.zeros(nc * tcell.CHUNK, w.shape[1])
    wp[:k] = w
    xb, wb = _tf32(xp), _tf32(wp)
    xs, ws = _tf32(xp - xb), _tf32(wp - wb)
    xb, xs, wb, ws = (t.double() for t in (xb, xs, wb, ws))
    zero = torch.zeros(b, w.shape[1])
    tot, chain = None, zero
    for p in range(2):
        for s in range(tcell.CHUNK // tcell.STAGE_K):
            acc = zero
            for c in range(p, nc, 2):
                k0 = c * tcell.CHUNK + s * tcell.STAGE_K
                big, cross = zero, zero
                for j in range(k0, k0 + tcell.STAGE_K, 8):
                    sl = slice(j, j + 8)
                    if stages:
                        cross = _rz32(cross.double() + xs[:, sl] @ wb[sl])
                        cross = _rz32(cross.double() + xb[:, sl] @ ws[sl])
                        big = _rz32(big.double() + xb[:, sl] @ wb[sl])
                    else:
                        for u, v in ((xs, wb), (xb, ws), (xb, wb)):
                            chain = _rz32(chain.double() + u[:, sl] @ v[sl])
                acc = acc + (big + cross)
            tot = acc if tot is None else tot + acc
    return tot if stages else chain


def _lstm_hs(xg, w, h0, c0, product):
    h, c, hs = h0, c0, []
    for t in range(xg.shape[1]):
        i, gc, f, o = (xg[:, t] + product(h, w)).chunk(4, dim=1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gc)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, 1)


def test_tensor_core_lstm_stays_within_the_lstm_tolerance():
    """Why the kernels sum each 32-deep stage apart: an LSTM over 20 steps
    at K = H = 512, its recurrent product modelled as the card forms it
    (3xTF32, the tensor core's accumulation rounding toward zero), keeps
    hs as close to float64 as float32 products do, inside the kernels'
    tolerance (atol 1e-5, rtol 1e-4); one chain over all of K drifts
    several times further, and one TF32 product per term leaves the
    tolerance."""
    rng = np.random.RandomState(0)
    B, T, H = 8, 20, 512
    xg = torch.from_numpy(rng.randn(B, T, 4 * H).astype(np.float32) * 0.5)
    w = torch.from_numpy(rng.randn(H, 4 * H).astype(np.float32) * H ** -0.5)
    h0 = torch.from_numpy(rng.randn(B, H).astype(np.float32) * 0.1)
    c0 = torch.from_numpy(rng.randn(B, H).astype(np.float32) * 0.1)
    truth = _lstm_hs(xg.double(), w.double(), h0.double(), c0.double(),
                     lambda a, b: a @ b)

    def err(hs):
        e = (hs.double() - truth).abs()
        return float(e.max()), bool((e <= 1e-5 + 1e-4 * truth.abs()).all())

    fp32, _ = err(_lstm_hs(xg, w, h0, c0, lambda a, b: a @ b))
    staged, staged_ok = err(_lstm_hs(xg, w, h0, c0, _tensor_core_product))
    chain, _ = err(_lstm_hs(xg, w, h0, c0, lambda a, b: _tensor_core_product(
        a, b, stages=False)))
    _, one_ok = err(_lstm_hs(xg, w, h0, c0,
                             lambda a, b: _tf32(a) @ _tf32(b)))
    assert staged_ok and staged < 4 * fp32
    assert chain > 4 * staged
    assert not one_ok
