"""Three faults of the port against the JAX package, repaired, each held
here on the CPU against the JAX lowering on the same numpy inputs, at
the bounds of ``tests/torch_dense_harness.py``:

* ``top_k`` breaks ties as ``lax.top_k`` does, the lower index first:
  on ``[2, 2, 2, 2]`` with k 3 the indices are ``[0, 1, 2]``, and
  ``layers.accuracy`` over a uniform softmax counts the same hits in
  both packages;
* ``scatter(overwrite=True)`` with duplicate ids writes the last update
  and sends the gradient to it alone, as ``jax.vjp`` does;
* a hard label out of [-C, C) in ``cross_entropy`` and
  ``softmax_with_cross_entropy``, and an id out of range in
  ``lookup_table`` (dense and ``is_sparse``), read NaN as jnp's fill
  does, a negative one wrapped once, with ``jax.vjp``'s gradient; the
  sparse optimizer updates drop such a row as the JAX package's
  scatters do."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import registry as jreg
from paddle_tpu.core.lower import TraceContext as JCtx
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.lower import TraceContext as TCtx
from torch_dense_harness import Op, check, close, run_jax, run_port

R = np.random.RandomState(3)


def test_top_k_puts_the_lower_index_first_among_ties():
    x = np.array([[2, 2, 2, 2], [1, 3, 3, 2], [0, -1, 0, -1]], np.float32)
    for k in (1, 3, 4):
        j = run_jax("top_k", {"X": [x]}, {"k": k})
        t = run_port("top_k", {"X": [x]}, {"k": k})
        np.testing.assert_array_equal(t["Indices"][0], j["Indices"][0])
        np.testing.assert_array_equal(t["Out"][0], j["Out"][0])
    np.testing.assert_array_equal(
        run_port("top_k", {"X": [x]}, {"k": 3})["Indices"][0][0], [0, 1, 2])
    check("top_k", {"X": [x]}, {"k": 3})
    check("top_k", {"X": [np.array([[3, 1, 3, 1, 2]], np.int32)]}, {"k": 4},
          grad=False)


def test_accuracy_over_a_uniform_softmax_counts_the_jax_packages_hits():
    """Every class ties under a zero-initialised classifier: label 1 is in
    the top 3 of ``[.25] * 4`` for ``lax.top_k`` ([0, 1, 2])."""
    got = {}
    for fluid in (jfluid, tfluid):
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            p = fluid.layers.data("p", [4])
            label = fluid.layers.data("label", [1], dtype="int64")
            acc = fluid.layers.accuracy(p, label, k=3)
        exe = fluid.Executor(fluid.CPUPlace()) if fluid is tfluid \
            else fluid.Executor()
        exe.run(startup)
        got[fluid] = float(np.asarray(exe.run(
            prog, feed={"p": np.full((6, 4), 0.25, np.float32),
                        "label": np.ones((6, 1), np.int64)},
            fetch_list=[acc])[0]))
    assert got[tfluid] == got[jfluid] == 1.0


def test_scatter_overwrite_duplicates_last_wins_and_takes_the_gradient():
    ins = {"X": [np.zeros((3, 2), np.float32)],
           "Ids": [np.array([1, 1, 1], np.int64)],
           "Updates": [np.arange(6, dtype=np.float32).reshape(3, 2)]}
    out = run_port("scatter", ins, {"overwrite": True})["Out"][0]
    np.testing.assert_array_equal(out, [[0, 0], [4, 5], [0, 0]])
    check("scatter", ins, {"overwrite": True})
    # duplicates, a wrapped id and one out of range together
    ins = {"X": [R.randn(5, 3).astype(np.float32)],
           "Ids": [np.array([[3], [0], [-2], [3], [7], [0]], np.int64)],
           "Updates": [R.randn(6, 3).astype(np.float32)]}
    check("scatter", ins, {"overwrite": True})


LABELS = np.array([[4], [-100], [-1], [2], [-4]], np.int64)


def test_hard_labels_out_of_range_read_nan():
    probs = np.tile(np.array([[.1, .2, .3, .4]], np.float32), (5, 1))
    j = run_jax("cross_entropy", {"X": [probs], "Label": [LABELS]}, {})
    t = run_port("cross_entropy", {"X": [probs], "Label": [LABELS]}, {})
    assert np.isnan(t["Y"][0][:2]).all() and np.isfinite(t["Y"][0][2:]).all()
    np.testing.assert_allclose(t["Y"][0], j["Y"][0], rtol=1e-6)
    check("cross_entropy", {"X": [probs], "Label": [LABELS]}, {})
    logits = R.randn(5, 4).astype(np.float32)
    check("softmax_with_cross_entropy", {"Logits": [logits],
                                         "Label": [LABELS]}, {})
    # a [B, T, 1] label over [B, T, C] logits
    check("softmax_with_cross_entropy", {
        "Logits": [R.randn(2, 3, 4).astype(np.float32)],
        "Label": [np.array([[[0], [4]], [[-5], [3]]], np.int64)
                  .repeat(2, 1)[:, :3]]}, {})


@pytest.mark.parametrize("pad", [-1, 1])
def test_lookup_table_id_out_of_range_reads_a_nan_row(pad):
    w = R.randn(4, 3).astype(np.float32)
    ids = np.array([[4], [1], [-1], [-5], [3]], np.int64)
    t = run_port("lookup_table", {"W": [w], "Ids": [ids]},
                 {"padding_idx": pad})["Out"][0]
    assert np.isnan(t[0]).all() and np.isnan(t[3]).all()
    np.testing.assert_array_equal(t[2], w[3])
    check("lookup_table", {"W": [w], "Ids": [ids]}, {"padding_idx": pad})


def _sparse_grad(pkg, w, ids, dy):
    reg, ctx = (jreg, JCtx(key=jax.random.PRNGKey(0))) if pkg == "jax" \
        else (treg, TCtx())
    arr = jnp.asarray if pkg == "jax" else torch.from_numpy
    op = Op("lookup_table", {"is_sparse": True})
    g = reg.get("lookup_table").grad_lower(
        ctx.for_op(op), {"W": [arr(w)], "Ids": [arr(ids)]},
        {"Out": [arr(dy)]}, {"is_sparse": True}, op)["W"][0]
    return g


# SGD and Momentum add the raw rows; Adagrad and Adam merge duplicate
# rows first, and the JAX package's merge maps a negative row to row 0
# (the segment maximum starts from 0: ROADMAP.md Queue 3, a mismatch
# that stays), so they are held on rows in range and past the end
SPARSE_IDS = {"sgd": [[4], [1], [-1], [1], [-7]],
              "momentum": [[4], [1], [-1], [1], [-7]],
              "adagrad": [[4], [1], [3], [1], [9]],
              "adam": [[4], [1], [3], [1], [9]]}


@pytest.mark.parametrize("type", sorted(SPARSE_IDS))
def test_is_sparse_gradient_of_an_id_out_of_range_and_its_update(type):
    """The row-sparse gradient keeps the raw ids, as the JAX package's
    does; the sparse SGD, Momentum, Adagrad and Adam updates then drop a
    row out of range and wrap a negative one, as jnp's scatters do (an
    index out of range would fault on the card)."""
    w = R.randn(4, 3).astype(np.float32)
    ids = np.array(SPARSE_IDS[type], np.int64)
    dy = R.randn(5, 3).astype(np.float32)
    jg, tg = _sparse_grad("jax", w, ids, dy), _sparse_grad("port", w, ids, dy)
    np.testing.assert_array_equal(tg.rows.numpy(), np.asarray(jg.rows))
    np.testing.assert_array_equal(tg.values.numpy(), np.asarray(jg.values))
    lr = np.array([0.1], np.float32)
    cases = [
        ("sgd", {}, {}),
        ("momentum", {"Velocity": R.randn(4, 3)}, {"mu": 0.9}),
        ("adagrad", {"Moment": np.abs(R.randn(4, 3))}, {"epsilon": 1e-6}),
        ("adam", {"Moment1": R.randn(4, 3), "Moment2": np.abs(R.randn(4, 3)),
                  "Beta1Pow": np.array([0.9 ** 3]),
                  "Beta2Pow": np.array([0.999 ** 3])},
         {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8})]
    for type_, extra, attrs in cases:
        if type_ != type:
            continue
        extra = {k: v.astype(np.float32) for k, v in extra.items()}
        jins = {"Param": [jnp.asarray(w)], "Grad": [jg],
                "LearningRate": [jnp.asarray(lr)]}
        jins.update({k: [jnp.asarray(v)] for k, v in extra.items()})
        tins = {"Param": [torch.from_numpy(w)], "Grad": [tg],
                "LearningRate": [torch.from_numpy(lr)]}
        tins.update({k: [torch.from_numpy(v)] for k, v in extra.items()})
        op = Op(type, attrs)
        j = jreg.normalize_outputs(jreg.get(type).lower(
            JCtx(key=jax.random.PRNGKey(0)).for_op(op), jins, attrs, op))
        t = treg.normalize_outputs(treg.get(type).lower(
            TCtx().for_op(op), tins, attrs, op))
        for slot, vals in j.items():
            close(t[slot][0].numpy(), np.asarray(vals[0]),
                  "%s %s" % (type, slot))
            assert np.isfinite(t[slot][0].numpy()).all(), (type, slot)
