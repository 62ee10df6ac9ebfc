"""The activation family in the port against the JAX package, op by op
on the CPU: every unary type of the JAX ``_ACTIVATIONS`` table and the
attr-taking activations after it (``paddle_tpu/ops/math_ops.py``), the
forward lowering and its gradient through each package's generic grad
(``registry.generic_grad``: autograd of the recomputed forward here,
``jax.vjp`` there) on the same numpy inputs and cotangent.

Tolerances: rtol 1e-6 (atol 1e-7) for the ops that are exact or one
correctly rounded operation in float32 (abs, ceil, floor, round, sign,
relu, square, sqrt, reciprocal, the clamps, the selects, maxout);
rtol 1e-5 (atol 1e-6) for the transcendental ones, whose libm and
XLA's approximations differ in the last bits (``TRANSCENDENTAL``; the
atol covers results that cancel toward 0, as tanh_shrink's). ``round``
rounds half to even in both packages (``jnp.round``, ``torch.round``),
held exactly on halves."""

import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import registry as jreg
from paddle_tpu.core.lower import PackedSeq as JPackedSeq
from paddle_tpu.core.lower import TraceContext as JCtx
from paddle_tpu.ops.math_ops import _ACTIVATIONS as JAX_TABLE
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.lower import PackedSeq
from paddle_tpu_torch.core.lower import TraceContext as TCtx

_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, os.cpu_count() // int(_WORKERS)))

TRANSCENDENTAL = {
    "sigmoid", "logsigmoid", "exp", "tanh", "tanh_shrink", "rsqrt", "cos",
    "sin", "log", "softplus", "softsign", "gelu", "silu", "erf", "elu",
    "soft_relu", "swish", "stanh", "pow"}
# inputs must be positive
POSITIVE = {"sqrt", "rsqrt", "log", "reciprocal"}

# the attr-taking block after the table: (type, attrs) cases
ATTR_CASES = [
    ("leaky_relu", {}), ("leaky_relu", {"alpha": 0.3}),
    ("elu", {}), ("elu", {"alpha": 0.5}),
    ("relu6", {}), ("relu6", {"threshold": 1.5}),
    ("pow", {"factor": 3.0}),
    ("hard_sigmoid", {}), ("hard_sigmoid", {"slope": 0.3, "offset": 0.4}),
    ("soft_relu", {}), ("soft_relu", {"threshold": 1.0}),
    ("swish", {}), ("swish", {"beta": 1.7}),
    ("brelu", {}), ("brelu", {"t_min": -1.0, "t_max": 1.0}),
    ("hard_shrink", {}), ("hard_shrink", {"threshold": 1.2}),
    ("soft_shrink", {}), ("soft_shrink", {"lambda": 0.8}),
    ("thresholded_relu", {}), ("thresholded_relu", {"threshold": -0.3}),
    ("stanh", {}), ("stanh", {"scale_a": 0.5, "scale_b": 2.0}),
]
SEQ_MAPPED = set(JAX_TABLE) | {"leaky_relu", "elu"}


def _op(type_, attrs):
    return types.SimpleNamespace(type=type_, attrs=attrs, uid=1, inputs={},
                                 outputs={}, block=None)


def _inputs(type_, shape=(4, 6), seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 2.0).astype(np.float32)
    if type_ in POSITIVE:
        x = np.abs(x) + 0.25
    # keep clear of the kinks (|x| of 0, 0.5, 1, 6, ...) where a
    # one-sided derivative is a convention
    x = np.where(np.abs(x - np.round(x)) < 0.02, x + 0.05, x)
    return {"X": x}


def _run(type_, ins, attrs):
    """(forward, gradient of every input slot) in both packages."""
    rng = np.random.RandomState(1)
    cot = None
    out = {}
    for pkg in ("jax", "port"):
        if pkg == "jax":
            reg, ctx = jreg, JCtx()
            conv = {k: jnp.asarray(v) for k, v in ins.items()}
        else:
            reg, ctx = treg, TCtx()
            conv = {k: torch.tensor(v) for k, v in ins.items()}
        spec = reg.get(type_)
        o = _op(type_, attrs)
        y = reg.normalize_outputs(spec.lower(ctx.for_op(o), {
            k: [v] for k, v in conv.items()}, attrs, o))["Out"][0]
        y = np.asarray(y)
        if cot is None:
            cot = rng.randn(*y.shape).astype(np.float32)
        g = reg.generic_grad(
            ctx, spec, o, {k: [v] for k, v in conv.items()},
            {"Out": [jnp.asarray(cot) if pkg == "jax"
                     else torch.tensor(cot)]})
        out[pkg] = (y, {k: np.asarray(v[0]) for k, v in g.items()
                        if v and v[0] is not None})
    return out


def _check(type_, out):
    rtol, atol = (1e-5, 1e-6) if type_ in TRANSCENDENTAL else (1e-6, 1e-7)
    (jy, jg), (ty, tg) = out["jax"], out["port"]
    assert ty.dtype == jy.dtype == np.float32
    np.testing.assert_allclose(ty, jy, rtol=rtol, atol=atol)
    assert set(tg) == set(jg)
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("type_", sorted(JAX_TABLE))
def test_table_activation_matches_jax(type_):
    out = _run(type_, _inputs(type_), {})
    _check(type_, out)


@pytest.mark.parametrize("type_,attrs", ATTR_CASES,
                         ids=["%s-%d" % (t, i) for i, (t, _) in
                              enumerate(ATTR_CASES)])
def test_attr_activation_matches_jax(type_, attrs):
    _check(type_, _run(type_, _inputs(type_), attrs))


@pytest.mark.parametrize("mode,alpha_shape", [
    ("all", (1,)), ("channel", (3,)), ("element", (3, 4, 5))])
def test_prelu_matches_jax_and_differentiates_alpha(mode, alpha_shape):
    rng = np.random.RandomState(3)
    ins = {"X": rng.randn(2, 3, 4, 5).astype(np.float32),
           "Alpha": (rng.rand(*alpha_shape) * 0.5).astype(np.float32)}
    out = _run("prelu", ins, {"mode": mode})
    _check("prelu", out)
    assert "Alpha" in out["port"][1]


def test_maxout_matches_jax():
    ins = _inputs("maxout", shape=(2, 6, 3, 4), seed=4)
    _check("maxout", _run("maxout", ins, {"groups": 3}))


def test_round_rounds_half_to_even_as_jnp_round():
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5, 0.49999997],
                 np.float32)
    out = _run("round", {"X": x}, {})
    np.testing.assert_array_equal(out["port"][0], out["jax"][0])
    np.testing.assert_array_equal(out["port"][0],
                                  [-2, -2, -0, 0, 2, 2, 4, 0])
    np.testing.assert_array_equal(out["port"][1]["X"], np.zeros_like(x))


def test_gelu_is_the_erf_form():
    x = np.linspace(-4, 4, 17).astype(np.float32)
    out = _run("gelu", {"X": x}, {})
    from scipy.special import erf
    want = 0.5 * x * (1 + erf(x / np.sqrt(2.0)))
    np.testing.assert_allclose(out["port"][0], want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("type_", sorted(SEQ_MAPPED))
def test_seq_mapped_activations_keep_the_lengths(type_):
    """The types the JAX package registers with ``seq_map`` map a
    PackedSeq to a PackedSeq with the same lengths."""
    x = np.abs(np.random.RandomState(5).randn(3, 4, 2).astype(np.float32)) \
        + 0.25
    lens = np.array([4, 1, 2], np.int32)
    jy = jreg.get(type_).lower(JCtx(), {"X": [JPackedSeq(jnp.asarray(x),
                                                         jnp.asarray(lens))]},
                               {}, _op(type_, {}))
    ty = treg.get(type_).lower(TCtx(), {"X": [PackedSeq(torch.tensor(x),
                                                        torch.tensor(lens))]},
                               {}, _op(type_, {}))
    jy = jreg.normalize_outputs(jy)["Out"][0]
    ty = treg.normalize_outputs(ty)["Out"][0]
    assert isinstance(jy, JPackedSeq) and isinstance(ty, PackedSeq)
    np.testing.assert_array_equal(ty.lengths.numpy(), lens)
    rtol = 1e-5 if type_ in TRANSCENDENTAL else 1e-6
    np.testing.assert_allclose(ty.data.numpy(), np.asarray(jy.data),
                               rtol=rtol, atol=1e-6)


def test_every_activation_of_the_jax_package_is_registered():
    names = set(JAX_TABLE) | {t for t, _ in ATTR_CASES} | {"prelu",
                                                           "maxout"}
    assert not [n for n in names if not treg.has(n)]
