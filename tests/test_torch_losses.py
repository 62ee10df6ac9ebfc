"""The loss family in the port against the JAX package, on the CPU, from
the same numpy inputs (``tests/torch_dense_harness.py``): each of the 13
types' outputs and autograd's gradients against ``jax.vjp`` of the JAX
lowering, floats within rtol 1e-5 plus 1e-6 of the largest magnitude,
with the JAX package's gradient flags.

Each edge case the JAX formulas decide has a case of its own: huber at
|r| = delta (``<=``), smooth_l1 at |d| = 1/sigma^2, modified_huber at
z = +-1, the hinge and the margin at their kinks (where the maximum
splits the gradient), kldiv's four reductions over targets with zeros,
hsigmoid at 7 and at the word model's 2073 classes (12 rounds), with and
without a bias, and conv_shift at the NTM's [4, 17] against [4, 3]. The
overflows keep the JAX formulas: rank_loss's log1p(exp(d)) is inf past
d = 88 and bpr_loss's log(sigmoid(diff)) is -inf past diff = -88, where
softplus and log-sigmoid would stay finite; the infinities and NaNs lie
where the JAX package's do, and every finite value is held at the bound.

``nce`` draws its negatives from the op's stream, which the two
packages fill with other numbers: the port's arithmetic on the ids is
held against the JAX ``Cost`` and ``SampleLogits`` on the ids the JAX
op drew, and against ``jax.vjp``; the port's draw is held by its
properties (the label columns first, negatives in [0, total), uniform
within 0.03 over 10^5 draws, a function of the op's stream)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.core import registry as jreg
from paddle_tpu.core.lower import TraceContext as JCtx
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.ops import nn_ops as tnn
from torch_dense_harness import Op, check, close, grads, run_jax, run_port

R = np.random.RandomState(41)
TYPES = ["sigmoid_cross_entropy_with_logits", "huber_loss", "smooth_l1_loss",
         "hinge_loss", "modified_huber_loss", "rank_loss", "margin_rank_loss",
         "log_loss", "kldiv_loss", "bpr_loss", "nce", "hierarchical_sigmoid",
         "conv_shift"]


def _f(*shape, scale=1.0):
    return (R.randn(*shape) * scale).astype(np.float32)


def _bits(*shape):
    return (R.rand(*shape) > 0.5).astype(np.float32)


def _hsig(batch, dim, classes, bias):
    ins = {"X": [_f(batch, dim)], "W": [_f(classes - 1, dim, scale=0.5)],
           "Label": [R.randint(0, classes, (batch, 1)).astype(np.int64)]}
    if bias:
        ins["Bias"] = [_f(1, classes - 1)]
    return ins


_X43 = _f(4, 3)
_SL = np.array([[0.25, -0.25, 0.1, 0.6]], np.float32)

CASES = [
    ("sigmoid_ce", "sigmoid_cross_entropy_with_logits",
     {"X": [np.concatenate([_f(4, 3, scale=3.0),
                            np.zeros((1, 3), np.float32)])],
      "Label": [_bits(5, 3)]}, {}),
    ("sigmoid_ce_soft", "sigmoid_cross_entropy_with_logits",
     {"X": [_f(3, 5, scale=2.0)], "Label": [R.rand(3, 5).astype(np.float32)]},
     {}),
    ("huber", "huber_loss", {"X": [_f(4, 3)], "Y": [_f(4, 3)]},
     {"delta": 0.3}),
    ("huber_at_delta", "huber_loss",
     {"X": [np.array([[0.25], [0.75], [0.0], [1.0]], np.float32)],
      "Y": [np.array([[0.75], [0.25], [0.5], [0.0]], np.float32)]},
     {"delta": 0.5}),
    ("smooth_l1", "smooth_l1_loss", {"X": [_X43], "Y": [_f(4, 3)]},
     {"sigma": 2.0}),
    ("smooth_l1_at_inverse_sigma2", "smooth_l1_loss",
     {"X": [_SL], "Y": [np.zeros_like(_SL)]}, {"sigma": 2.0}),
    ("smooth_l1_weights", "smooth_l1_loss",
     {"X": [_f(3, 2, 4)], "Y": [_f(3, 2, 4)],
      "InsideWeight": [R.rand(3, 2, 4).astype(np.float32)],
      "OutsideWeight": [R.rand(3, 2, 4).astype(np.float32)]},
     {"sigma": 1.5}),
    ("hinge", "hinge_loss",
     {"Logits": [_f(6, 1, scale=1.5)], "Labels": [_bits(6, 1)]}, {}),
    ("hinge_at_margin", "hinge_loss",
     {"Logits": [np.array([[1.0], [-1.0], [0.5]], np.float32)],
      "Labels": [np.array([[1.0], [0.0], [1.0]], np.float32)]}, {}),
    ("modified_huber", "modified_huber_loss",
     {"X": [_f(6, 1, scale=2.0)], "Y": [_bits(6, 1)]}, {}),
    ("modified_huber_at_z_pm1", "modified_huber_loss",
     {"X": [np.array([[1.0], [-1.0], [1.0], [-1.0]], np.float32)],
      "Y": [np.array([[1.0], [1.0], [0.0], [0.0]], np.float32)]}, {}),
    ("rank", "rank_loss",
     {"Label": [_bits(5, 1)], "Left": [_f(5, 1)], "Right": [_f(5, 1)]}, {}),
    ("margin_rank", "margin_rank_loss",
     {"Label": [np.sign(_f(6, 1))], "X1": [_f(6, 1)], "X2": [_f(6, 1)]},
     {"margin": 0.1}),
    ("margin_rank_at_kink", "margin_rank_loss",
     {"Label": [np.array([[1.0], [-1.0]], np.float32)],
      "X1": [np.array([[0.75], [0.25]], np.float32)],
      "X2": [np.array([[0.25], [0.75]], np.float32)]}, {"margin": 0.5}),
    ("log", "log_loss",
     {"Predicted": [R.uniform(0.05, 0.95, (5, 1)).astype(np.float32)],
      "Labels": [_bits(5, 1)]}, {"epsilon": 1e-4}),
] + [
    ("kldiv_%s" % red, "kldiv_loss",
     {"X": [np.log(R.uniform(0.1, 0.9, (4, 5))).astype(np.float32)],
      "Target": [np.where(R.rand(4, 5) > 0.3, R.uniform(0.1, 0.9, (4, 5)),
                          0.0).astype(np.float32)]}, {"reduction": red})
    for red in ("mean", "sum", "batchmean", "none")
] + [
    ("bpr", "bpr_loss",
     {"X": [_f(4, 6)], "Label": [R.randint(0, 6, (4, 1)).astype(np.int64)]},
     {}),
    ("hsigmoid_7", "hierarchical_sigmoid", _hsig(6, 5, 7, False),
     {"num_classes": 7}),
    ("hsigmoid_7_bias", "hierarchical_sigmoid", _hsig(6, 5, 7, True),
     {"num_classes": 7}),
    ("hsigmoid_8_bias", "hierarchical_sigmoid", _hsig(5, 4, 8, True),
     {"num_classes": 8}),
    ("hsigmoid_2073", "hierarchical_sigmoid", _hsig(16, 8, 2073, False),
     {"num_classes": 2073}),
    ("hsigmoid_2073_bias", "hierarchical_sigmoid", _hsig(16, 8, 2073, True),
     {"num_classes": 2073}),
    ("conv_shift_ntm", "conv_shift", {"X": [_f(4, 17)], "Y": [_f(4, 3)]}, {}),
    ("conv_shift_5", "conv_shift", {"X": [_f(3, 8)], "Y": [_f(3, 5)]}, {}),
]


@pytest.mark.parametrize("name,type,ins,attrs", CASES,
                         ids=[c[0] for c in CASES])
def test_loss_type_matches_the_jax_lowering(name, type, ins, attrs):
    check(type, ins, attrs)


def test_the_cases_cover_the_13_types_with_the_jax_flags():
    assert sorted({c[1] for c in CASES} | {"nce"}) == sorted(TYPES)
    for t in TYPES:
        j, p = jreg.get(t), treg.get(t)
        assert (j.no_grad, tuple(j.nondiff_inputs)) == \
            (p.no_grad, tuple(p.nondiff_inputs)), t


def test_hsigmoid_at_2073_classes_takes_12_rounds():
    # a label's leaf sits at 2073 + label: 12 halvings reach the root
    # from every leaf, the 12th past it for the leaves below 2^11
    ins = _hsig(4, 3, 2073, False)
    ins["Label"] = [np.array([[0], [974], [975], [2072]], np.int64)]
    out = run_port("hierarchical_sigmoid", ins, {"num_classes": 2073})
    want = run_jax("hierarchical_sigmoid", ins, {"num_classes": 2073})
    close(out["Out"][0], want["Out"][0], "Out")
    np.testing.assert_array_equal(out["PreOut"][0], out["Out"][0])


def _held_where_finite(got, want, what):
    """Infinities and NaNs where the JAX package has them, the finite
    values at the bound of the largest finite magnitude."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), what)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want), what)
    np.testing.assert_array_equal(got[np.isinf(got)], want[np.isinf(want)],
                                  what)
    fin = np.isfinite(want)
    close(got[fin], want[fin], what)


OVERFLOW = [
    # d = left - right past 88: exp overflows, the loss is inf
    ("rank_overflow", "rank_loss",
     {"Label": [np.array([[1.0], [0.0], [1.0]], np.float32)],
      "Left": [np.array([[100.0], [90.0], [0.5]], np.float32)],
      "Right": [np.array([[0.0], [0.0], [0.25]], np.float32)]}),
    # x_label - x_j below -88: the sigmoid underflows, log gives -inf
    ("bpr_overflow", "bpr_loss",
     {"X": [np.array([[-50.0, 50.0, 0.0], [0.0, 1.0, 2.0],
                      [0.0, 100.0, 0.0]], np.float32)],
      "Label": [np.array([[0], [1], [2]], np.int64)]}),
]


@pytest.mark.parametrize("name,type,ins", OVERFLOW,
                         ids=[c[0] for c in OVERFLOW])
def test_overflow_keeps_the_jax_formula(name, type, ins):
    j, t = run_jax(type, ins, {}), run_port(type, ins, {})
    slot = "Out" if type == "rank_loss" else "Y"
    assert np.isinf(j[slot][0]).any()
    _held_where_finite(t[slot][0], j[slot][0], slot)
    jg, tg = grads(type, ins, {})
    for k in jg:
        _held_where_finite(tg[k], jg[k], "d%s[%d]" % k)


# ---- nce ----

NCE_ATTRS = {"num_neg_samples": 5, "num_total_classes": 30}


def _nce_ins(bias=True, num_true=1):
    ins = {"Input": [_f(6, 4)], "Weight": [_f(30, 4, scale=0.5)],
           "Label": [R.randint(0, 30, (6, num_true)).astype(np.int64)]}
    if bias:
        ins["Bias"] = [_f(30, 1)]
    return ins


def _jax_nce(ins, attrs):
    """The JAX op's outputs, and jax.vjp of its (Cost, SampleLogits)
    with respect to Input, Weight and Bias, on one key."""
    op = Op("nce", attrs)
    keys = [k for k in ("Input", "Weight", "Bias") if k in ins]

    def fn(*xs):
        full = {s: [jnp.asarray(v[0])] for s, v in ins.items()}
        for k, x in zip(keys, xs):
            full[k] = [x]
        out = jreg.get("nce").lower(
            JCtx(key=jax.random.PRNGKey(0)).for_op(op), full, attrs, op)
        return out["Cost"], out["SampleLogits"], out["SampleLabels"]

    cost, logits, ids, = fn(*[jnp.asarray(ins[k][0]) for k in keys])
    _, vjp = jax.vjp(lambda *xs: fn(*xs)[:2],
                     *[jnp.asarray(ins[k][0]) for k in keys])
    return np.asarray(cost), np.asarray(logits), np.asarray(ids), keys, vjp


@pytest.mark.parametrize("bias,num_true", [(True, 1), (False, 1), (True, 2)])
def test_nce_arithmetic_on_the_jax_ids(bias, num_true):
    ins = _nce_ins(bias, num_true)
    cost, logits, ids, keys, vjp = _jax_nce(ins, NCE_ATTRS)
    assert ids.dtype == np.int32
    np.testing.assert_array_equal(ids[:, :num_true], ins["Label"][0])
    leaves = [torch.from_numpy(ins[k][0]).requires_grad_() for k in keys]
    by = dict(zip(keys, leaves))
    tcost, tlogits = tnn.nce_logits(
        by["Input"], by["Weight"], by.get("Bias"),
        torch.from_numpy(ids.astype(np.int64)), num_true,
        NCE_ATTRS["num_neg_samples"], NCE_ATTRS["num_total_classes"])
    close(tcost.detach().numpy(), cost, "Cost")
    close(tlogits.detach().numpy(), logits, "SampleLogits")
    rng = np.random.RandomState(5)
    cots = [rng.randn(*cost.shape).astype(np.float32),
            rng.randn(*logits.shape).astype(np.float32)]
    jg = vjp(tuple(jnp.asarray(c) for c in cots))
    tg = torch.autograd.grad([tcost, tlogits], leaves,
                             [torch.from_numpy(c) for c in cots])
    for k, a, b in zip(keys, jg, tg):
        close(b.numpy(), np.asarray(a), "d" + k)


def test_nce_repeated_ids_add_their_gradients_in_index_order():
    ins = _nce_ins()
    ids = torch.from_numpy(np.tile(np.array([[3, 3, 7, 3, 0, 7]]), (6, 1)))
    w = torch.from_numpy(ins["Weight"][0]).requires_grad_()
    x = torch.from_numpy(ins["Input"][0])
    cost, _ = tnn.nce_logits(x, w, None, ids, 1, 5, 30)
    (g1,) = torch.autograd.grad(cost.sum(), w)
    cost, _ = tnn.nce_logits(x, w, None, ids, 1, 5, 30)
    (g2,) = torch.autograd.grad(cost.sum(), w)
    assert torch.equal(g1, g2)
    untouched = [r for r in range(30) if r not in (0, 3, 7)]
    assert not g1[untouched].any()


def test_nce_draw_properties():
    b, neg, total = 10000, 10, 20
    ins = {"Input": [np.zeros((b, 2), np.float32)],
           "Weight": [np.zeros((total, 2), np.float32)],
           "Label": [np.arange(b, dtype=np.int64)[:, None] % total]}
    attrs = {"num_neg_samples": neg, "num_total_classes": total}
    out = run_port("nce", ins, attrs)["SampleLabels"][0]
    assert out.shape == (b, 1 + neg) and out.dtype == np.int32
    np.testing.assert_array_equal(out[:, 0], ins["Label"][0][:, 0])
    draws = out[:, 1:]
    assert draws.min() >= 0 and draws.max() < total
    freq = np.bincount(draws.ravel(), minlength=total) / draws.size
    assert np.abs(freq - 1.0 / total).max() < 0.03, freq
    np.testing.assert_array_equal(
        run_port("nce", ins, attrs)["SampleLabels"][0], out)
    other = run_port("nce", ins, attrs, uid=2)["SampleLabels"][0]
    assert not np.array_equal(other, out)


def test_nce_cost_from_the_op_equals_its_arithmetic():
    ins = _nce_ins()
    out = run_port("nce", ins, NCE_ATTRS)
    cost, logits = tnn.nce_logits(
        torch.from_numpy(ins["Input"][0]), torch.from_numpy(ins["Weight"][0]),
        torch.from_numpy(ins["Bias"][0]),
        torch.from_numpy(out["SampleLabels"][0].astype(np.int64)), 1,
        NCE_ATTRS["num_neg_samples"], NCE_ATTRS["num_total_classes"])
    np.testing.assert_array_equal(out["Cost"][0], cost.numpy())
    np.testing.assert_array_equal(out["SampleLogits"][0], logits.numpy())
