"""The training slice's op lowerings and their gradients against the JAX
package's, on identical numpy inputs: each forward, and each generic grad
(autograd of the recomputed lowering in the port, ``jax.vjp`` in the JAX
package) under the same cotangents. Packed sequences go in as (data,
lengths) pairs with ragged lengths, a row of length 0 included.

Tolerance 1e-5 (abs and rel) for forward floats, 1e-4 rel with 1e-6 abs
for gradients (fp32 math in another summation order); integer results
exact by value (JAX records int64 as int32 with x64 off)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu  # noqa: F401  (registers the JAX lowerings)
import paddle_tpu_torch  # noqa: F401  (registers the port's lowerings)
from paddle_tpu.core import registry as jreg
from paddle_tpu.core.lower import PackedSeq as JSeq
from paddle_tpu.core.lower import TraceContext as JCtx
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.lower import PackedSeq as TSeq
from paddle_tpu_torch.core.lower import TraceContext as TCtx

# Under pytest-xdist each worker takes its share of the cores for
# torch's intra-op threads: six workers at torch's default thread count
# oversubscribe the cores, and a test of seconds then takes minutes.
_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, os.cpu_count() // int(_WORKERS)))

LENS = np.array([4, 1, 0, 3], np.int32)   # B=4, T=4


class _Op:
    def __init__(self, type, attrs, uid=1):
        self.type, self.attrs, self.uid = type, attrs, uid
        self.inputs, self.outputs = {}, {}


class Seq:
    """A numpy packed sequence: data [B, T, ...] and lengths [B]."""

    def __init__(self, data, lengths=LENS):
        self.data, self.lengths = data, lengths


def _to_jax(v):
    if isinstance(v, Seq):
        return JSeq(jnp.asarray(v.data), jnp.asarray(v.lengths))
    return jnp.asarray(v)


def _to_port(v):
    if isinstance(v, Seq):
        return TSeq(torch.from_numpy(np.array(v.data)),
                    torch.from_numpy(np.array(v.lengths)))
    return torch.from_numpy(np.array(v))


def _host(v):
    if v is None:
        return None
    if isinstance(v, (JSeq, TSeq)):
        return np.asarray(v.data if isinstance(v, JSeq) else v.data.numpy())
    return np.asarray(v) if not isinstance(v, torch.Tensor) else v.numpy()


def _grad_fn(reg, type):
    spec = reg.get(type)
    if spec.grad_lower is not None:
        return lambda ctx, ins, g, op: spec.grad_lower(ctx, ins, g,
                                                       op.attrs, op)
    return lambda ctx, ins, g, op: reg.generic_grad(ctx, spec, op, ins, g)


def _check(type, ins, attrs=None, grad=True, seed=0):
    attrs = attrs or {}
    op = _Op(type, attrs)
    jctx = JCtx(key=jax.random.PRNGKey(0))
    tctx = TCtx(key=0)
    jins = {s: [_to_jax(a) for a in v] for s, v in ins.items()}
    tins = {s: [_to_port(a) for a in v] for s, v in ins.items()}
    jout = jreg.normalize_outputs(
        jreg.get(type).lower(jctx.for_op(op), jins, attrs, op))
    with torch.no_grad():
        tout = treg.normalize_outputs(
            treg.get(type).lower(tctx.for_op(op), tins, attrs, op))
    for slot, vals in jout.items():
        for a, b in zip(vals, tout[slot]):
            assert isinstance(a, JSeq) == isinstance(b, TSeq), slot
            a, b = _host(a), _host(b)
            if a is None:
                assert b is None, slot
                continue
            assert a.shape == b.shape, (slot, a.shape, b.shape)
            if np.issubdtype(a.dtype, np.floating):
                np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5,
                                           err_msg=slot)
            else:
                np.testing.assert_array_equal(b, a, err_msg=slot)
    if not grad:
        return
    rng = np.random.RandomState(seed)
    jcot, tcot = {}, {}
    for slot, vals in jout.items():
        jcot[slot], tcot[slot] = [], []
        for v in vals:
            h = _host(v)
            if h is None or not np.issubdtype(h.dtype, np.floating):
                jcot[slot].append(None)
                tcot[slot].append(None)
                continue
            c = np.asarray(rng.randn(*h.shape), np.float32)
            c = Seq(c, np.asarray(v.lengths)) if isinstance(v, JSeq) else c
            jcot[slot].append(_to_jax(c))
            tcot[slot].append(_to_port(c))
    jg = _grad_fn(jreg, type)(jctx.for_op(op), jins, jcot, op)
    tg = _grad_fn(treg, type)(tctx, tins, tcot, op)
    spec = jreg.get(type)
    for slot in ins:
        if slot in spec.nondiff_inputs:
            continue
        for a, b in zip(jg.get(slot, []), tg.get(slot, [])):
            a, b = _host(a), _host(b)
            if a is None or b is None:
                # "no gradient" may be None on one side and zeros on the
                # other: the executor materializes zeros for both
                assert not np.any(a if a is not None else 0.0)
                assert not np.any(b if b is not None else 0.0)
                continue
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-6,
                                       err_msg="grad " + slot)


RNG = np.random.RandomState(0)


def _f(*shape):
    return RNG.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("pool", ["SUM", "AVERAGE", "SQRT", "MAX", "LAST",
                                  "FIRST"])
def test_sequence_pool(pool):
    x = _f(4, 4, 5)
    x[0, 2] = x[0, 1]   # a tie inside a row: MAX splits its gradient
    _check("sequence_pool", {"X": [Seq(x)]}, {"pooltype": pool})


@pytest.mark.parametrize("axis", [-1, 1, 0])
def test_concat_packed(axis):
    a, b = _f(4, 4, 3), _f(4, 4, 2 if axis else 3)
    _check("concat", {"X": [Seq(a), Seq(b)]}, {"axis": axis})


def test_concat_dense():
    _check("concat", {"X": [_f(3, 2), _f(3, 5)]}, {"axis": 1})


def test_mul_packed_per_token():
    _check("mul", {"X": [Seq(_f(4, 4, 6))], "Y": [_f(6, 8)]},
           {"x_num_col_dims": 2, "y_num_col_dims": 1})


def test_elementwise_add_packed_bias():
    _check("elementwise_add", {"X": [Seq(_f(4, 4, 8))], "Y": [_f(8)]},
           {"axis": 2})


def test_lookup_table_packed_ids_dense_grad():
    ids = RNG.randint(0, 7, (4, 4, 1)).astype(np.int64)
    _check("lookup_table", {"W": [_f(7, 5)], "Ids": [Seq(ids)]},
           {"padding_idx": -1, "is_sparse": False})


def test_lookup_table_padding_idx():
    ids = RNG.randint(0, 7, (6, 1)).astype(np.int64)
    ids[2] = 3
    _check("lookup_table", {"W": [_f(7, 5)], "Ids": [ids]},
           {"padding_idx": 3, "is_sparse": False})


def test_softmax_and_tanh():
    _check("softmax", {"X": [_f(5, 3)]}, {"axis": -1})
    _check("tanh", {"X": [Seq(_f(4, 4, 3))]})


def test_cross_entropy_hard_label():
    p = np.abs(_f(6, 4)) + 0.1
    p /= p.sum(-1, keepdims=True)
    lab = RNG.randint(0, 4, (6, 1)).astype(np.int64)
    _check("cross_entropy", {"X": [p], "Label": [lab]}, {"soft_label": False})


@pytest.mark.parametrize("packed", [False, True])
def test_mean(packed):
    x = _f(4, 4, 3)
    _check("mean", {"X": [Seq(x) if packed else x]})


def test_sum_of_packed_and_dense():
    _check("sum", {"X": [Seq(_f(4, 4, 3)), Seq(_f(4, 4, 3))]})
    _check("sum", {"X": [_f(2, 3), _f(2, 3), _f(2, 3)]})


def test_top_k_and_accuracy():
    x = _f(8, 5)
    _check("top_k", {"X": [x]}, {"k": 2}, grad=False)
    idx = np.argsort(-x, -1)[:, :1].astype(np.int64)
    lab = RNG.randint(0, 5, (8, 1)).astype(np.int64)
    lab[:3, 0] = idx[:3, 0]
    _check("accuracy", {"Out": [np.take_along_axis(x, idx, -1)],
                        "Indices": [idx], "Label": [lab]}, grad=False)


def test_assign():
    _check("assign", {"X": [_f(3, 4)]})


def test_adam_dense_update():
    p, g = _f(6, 3), _f(6, 3)
    m1, m2 = _f(6, 3), np.abs(_f(6, 3))
    _check("adam", {"Param": [p], "Grad": [g], "Moment1": [m1],
                    "Moment2": [m2],
                    "Beta1Pow": [np.array([0.9 ** 3], np.float32)],
                    "Beta2Pow": [np.array([0.999 ** 3], np.float32)],
                    "LearningRate": [np.array([1e-3], np.float32)]},
           {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}, grad=False)


# ---- the seq2seq slice's ops ----

@pytest.mark.parametrize("type,x,y,axis", [
    ("elementwise_sub", (4, 4), (4, 4), -1),
    ("elementwise_mul", (4, 5, 6), (4, 5, 1), -1),
    ("elementwise_mul", (4, 5, 6), (5,), 1),
    ("elementwise_sub", (4, 5, 3), (4, 1, 3), 0),
], ids=["same", "trailing_1", "axis_1", "axis_0_bcast"])
def test_elementwise_sub_mul_axis(type, x, y, axis):
    _check(type, {"X": [_f(*x)], "Y": [_f(*y)]}, {"axis": axis})


@pytest.mark.parametrize("attrs", [
    {"scale": 0.0, "bias": 1.0},
    {"scale": 1e9, "bias": 0.0, "bias_after_scale": True},
    {"scale": -2.5, "bias": 0.5, "bias_after_scale": False}],
    ids=["ones_like", "after", "before"])
def test_scale(attrs):
    _check("scale", {"X": [_f(3, 4)]}, attrs)


@pytest.mark.parametrize("attrs", [
    {"dim": [1], "keep_dim": False, "reduce_all": False},
    {"dim": [0, 2], "keep_dim": True, "reduce_all": False},
    {"reduce_all": True, "keep_dim": False}],
    ids=["dim1", "dims_keep", "all"])
def test_reduce_sum(attrs):
    _check("reduce_sum", {"X": [_f(3, 4, 5)]}, attrs)


@pytest.mark.parametrize("axes", [[2], [], [0, 2]])
def test_squeeze(axes):
    """Only axes of size 1 go; no axes squeezes every size-1 dim."""
    _check("squeeze", {"X": [_f(3, 1, 1)]}, {"axes": axes})


def test_cast():
    ids = RNG.randint(0, 3, (4, 4, 1)).astype(np.int64)
    _check("cast", {"X": [Seq(ids)]}, {"out_dtype": "float32"}, grad=False)
    _check("cast", {"X": [_f(3, 2)]}, {"out_dtype": "float32"})


@pytest.mark.parametrize("attrs", [{}, {"pad_value": -1e9}])
def test_sequence_pad(attrs):
    _check("sequence_pad", {"X": [Seq(_f(4, 4, 3))]}, attrs)


@pytest.mark.parametrize("maxlen", [-1, 6])
def test_sequence_mask(maxlen):
    _check("sequence_mask", {"X": [Seq(_f(4, 4, 2))]},
           {"maxlen": maxlen, "out_dtype": "int64"}, grad=False)


@pytest.mark.parametrize("act", ["tanh", 2, "relu", 0])
def test_gru_unit(act):
    """``activation`` as a name or the reference's integer code."""
    h = 5
    _check("gru_unit", {"Input": [_f(4, 3 * h)], "HiddenPrev": [_f(4, h)],
                        "Weight": [_f(h, 3 * h) * 0.5],
                        "Bias": [_f(1, 3 * h)]},
           {"activation": act, "gate_activation": "sigmoid"})


@pytest.mark.parametrize("flag", ["no_grad", "nondiff_inputs"])
def test_gradient_flags_match_jax(flag):
    """append_backward reads these flags: both packages must agree on
    every op the port registers."""
    for type, spec in treg.REGISTRY.items():
        jspec = jreg.get(type)
        assert getattr(spec, flag) == getattr(jspec, flag), (type, flag)
