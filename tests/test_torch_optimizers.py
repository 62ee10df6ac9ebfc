"""The loss, optimizer and metric families' layers and optimizer classes
in the port against the JAX package, on the CPU:

* each of the 14 layer names, each of the 7 optimizer configurations of
  ``chip_smoke.py``'s phase 6i (the stacked-LSTM classifier with
  cross entropy, ``evaluator.Accuracy``, ``layers.auc`` and the for_test
  clone, ``ModelAverage`` on one) and word2vec with the ``hsigmoid`` and
  the ``nce`` head build programs (main and startup) whose JSON is
  byte-identical to the JAX package's: the same accumulators, names,
  initializers and op order (Adamax's beta1 power by a ``scale`` op,
  LAMB's inside its op, ModelAverage's ``sum`` + ``increment``);
* the stacked LSTM (dict 1000, emb and hid 64) under each of the 7,
  trained 3 steps in both packages from the JAX startup's weights
  (``interop.load_reference_state``) on one batch of equal lengths
  (the JAX reverse LSTM zeroes position 0 of short rows, ROADMAP.md
  Queue 3): losses within rtol 1e-5; after the first step and after
  the third, every parameter and optimizer accumulator within 1e-5 of
  its largest magnitude plus 4 times the most that 4 draws of a 1e-6
  relative change of every weight move it in the JAX package over the
  same steps, that allowance capped at 1e-2 of the largest magnitude
  (``chip_smoke.check_state``). These updates normalise each gradient
  element, so an element whose gradient is rounding noise takes a step
  of the full rate in a rounding-noise direction: such a change moves
  LAMB's, FTRL's and DecayedAdagrad's state by up to 1.1e-2 of the
  largest magnitude after one step here, RMSProp's by 2e-5.
  The AUC histograms' totals exact; ModelAverage's sums equal the
  parameters summed after each step;
* the hsigmoid word model (word2vec at its 2073 words) over 5 SGD steps:
  losses within rtol 1e-5, every parameter within rtol 1e-5 plus 1e-6
  of its largest magnitude."""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import unique_name as jnames
from paddle_tpu_torch import interop
from paddle_tpu_torch import unique_name as tnames

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402

_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, os.cpu_count() // int(_WORKERS)))

CPU = tfluid.CPUPlace()
SMALL = dict(dict_dim=1000, emb_dim=64, hid_dim=64)
LAYERS = ["conv_shift", "smooth_l1", "sigmoid_cross_entropy_with_logits",
          "log_loss", "huber_loss", "kldiv_loss", "rank_loss",
          "margin_rank_loss", "bpr_loss", "hinge_loss", "nce", "hsigmoid",
          "auc", "mean_iou"]
TAGS = [o[0] for o in chip_smoke.OPTIMIZERS]


def _dump(prog):
    return json.dumps(prog.to_dict(), sort_keys=True, indent=1)


def _layer_body(fluid, name):
    layers = fluid.layers
    x = layers.data("x", [6])
    y = layers.data("y", [6])
    p = layers.data("p", [1])
    lab = layers.data("lab", [1], dtype="int64")
    calls = {
        "conv_shift": lambda: layers.conv_shift(x, layers.data("s", [3])),
        "smooth_l1": lambda: layers.smooth_l1(x, y, inside_weight=y,
                                              outside_weight=x, sigma=2.0),
        "sigmoid_cross_entropy_with_logits":
            lambda: layers.sigmoid_cross_entropy_with_logits(x, y),
        "log_loss": lambda: layers.log_loss(p, p, epsilon=1e-3),
        "huber_loss": lambda: layers.huber_loss(x, y, 0.5),
        "kldiv_loss": lambda: layers.kldiv_loss(x, y, reduction="batchmean"),
        "rank_loss": lambda: layers.rank_loss(p, p, p),
        "margin_rank_loss": lambda: layers.margin_rank_loss(p, p, p, 0.2),
        "bpr_loss": lambda: layers.bpr_loss(x, lab),
        "hinge_loss": lambda: layers.hinge_loss(p, p),
        "nce": lambda: (layers.nce(x, lab, 20),
                        layers.nce(x, lab, 20, num_neg_samples=4,
                                   bias_attr=False,
                                   param_attr=fluid.ParamAttr(name="nw"))),
        "hsigmoid": lambda: (layers.hsigmoid(x, lab, 7),
                             layers.hsigmoid(x, lab, 2073, bias_attr=False)),
        "auc": lambda: layers.auc(layers.softmax(layers.fc(x, 2)), lab,
                                  num_thresholds=200),
        "mean_iou": lambda: layers.mean_iou(lab, lab, 4),
    }
    return calls[name]()


def _program(fluid, names, body):
    with names.guard():
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            out = body(fluid)
    return prog, startup, out


def test_the_slice_names_its_14_layers():
    assert len(set(LAYERS)) == 14
    assert set(LAYERS) <= set(tfluid.layers.nn.__all__)
    assert [n for n in jfluid.layers.nn.__all__
            if not hasattr(tfluid.layers, n)] == ["moe"]
    assert not set(jfluid.optimizer.__all__) - set(tfluid.optimizer.__all__)


@pytest.mark.parametrize("name", LAYERS)
def test_layer_builds_the_jax_packages_json(name):
    j = _program(jfluid, jnames, lambda f: _layer_body(f, name))
    t = _program(tfluid, tnames, lambda f: _layer_body(f, name))
    assert _dump(t[0]) == _dump(j[0])
    assert _dump(t[1]) == _dump(j[1])


def _optim(fluid, names, tag, **sizes):
    _, kind, kw = next(o for o in chip_smoke.OPTIMIZERS if o[0] == tag)
    with names.guard():
        with fluid.scope_guard(fluid.Scope()):
            return chip_smoke.optim_build(
                fluid, kind, kw, average=tag == chip_smoke.OPTIM_AVERAGE,
                **(sizes or SMALL))


@pytest.mark.parametrize("tag", TAGS)
def test_optimizer_program_builds_the_jax_packages_json(tag):
    j, t = _optim(jfluid, jnames, tag), _optim(tfluid, tnames, tag)
    for k in ("prog", "startup", "test"):
        assert _dump(t[k]) == _dump(j[k]), k
    types = [op.type for op in t["prog"].global_block().ops]
    if tag == "adamax":
        i = types.index("adamax")
        assert types[i + 1] == "scale"
        last = len(types) - 1 - types[::-1].index("scale")
        n = len(t["average"].params)
        assert n > 0 and types[last + 1:] == ["sum", "increment"] * n
        assert "average_accumulates" not in types


def _w2v(fluid, names, head):
    with names.guard():
        return chip_smoke.w2v_build(fluid, head=head)


@pytest.mark.parametrize("head", chip_smoke.W2V_HEADS)
def test_word2vec_head_builds_the_jax_packages_json(head):
    j, t = _w2v(jfluid, jnames, head), _w2v(tfluid, tnames, head)
    assert _dump(t[0]) == _dump(j[0])
    assert _dump(t[1]) == _dump(j[1])


def _pair(jm, tm):
    """The JAX startup's scope and a port scope holding the same state."""
    jscope = jfluid.Scope()
    jexe = jfluid.Executor()
    jexe.run(jm["startup"], scope=jscope)
    arrays = {v.name: np.asarray(jscope.find_var(v.name))
              for v in jm["prog"].list_vars() if v.persistable}
    tscope = tfluid.Scope()
    interop.load_reference_state(arrays, tscope, CPU,
                                 [tm["prog"], tm["startup"]])
    return jexe, jscope, tfluid.Executor(CPU), tscope, arrays


def _reference_moves(jm, arrays, feed, steps, names, ran):
    """{name: the most that any of chip_smoke.NOISE_PROBES draws of a
    1e-6 relative change of every weight moves that state tensor over
    ``steps`` steps of the JAX package from ``arrays``}, against
    ``ran(name)``, the same steps without one: how far rounding alone
    moves each tensor in the reference."""
    exe = jfluid.Executor()
    params = {p.name for p in jm["prog"].global_block().all_parameters()}
    moved = {}
    for seed in range(chip_smoke.NOISE_PROBES):
        rng = np.random.RandomState(seed)
        scope = jfluid.Scope()
        for n, a in arrays.items():
            if n in params and np.issubdtype(a.dtype, np.floating):
                a = (a * (1 + 1e-6 * rng.standard_normal(a.shape))).astype(
                    a.dtype)
            scope.set_var(n, jnp.asarray(a))
        _train(exe, jm["prog"], jm["loss"].name, feed, scope, steps)
        for n, d in chip_smoke.state_diffs(
                names, lambda v: np.asarray(scope.find_var(v)), ran).items():
            moved[n] = max(moved.get(n, 0.0), d)
    return moved


def _held(got, want, what):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got).reshape(want.shape), want,
                               rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()),
                               err_msg=what)


def _train(exe, prog, loss, feed, scope, steps=3):
    return [float(np.asarray(exe.run(prog, feed=feed, fetch_list=[loss],
                                     scope=scope)[0])) for _ in range(steps)]


@pytest.mark.parametrize("tag", TAGS)
def test_stacked_lstm_trains_as_the_jax_package_under(tag):
    jm, tm = _optim(jfluid, jnames, tag), _optim(tfluid, tnames, tag)
    jexe, jscope, texe, tscope, arrays = _pair(jm, tm)
    rng = np.random.RandomState(3)
    words = [rng.randint(1, SMALL["dict_dim"], (6, 1)).astype(np.int64)
             for _ in range(4)]
    feed = {"words": words,
            "label": rng.randint(0, 2, (4, 1)).astype(np.int64)}
    ma = tm["average"]
    sums = {n: 0 for n in (ma.params if ma else ())}
    names = chip_smoke.state_names(tm["prog"])

    def jax_state(n):
        return np.asarray(jscope.find_var(n))
    jl, tl = [], []
    for step in range(1, 4):
        jl += _train(jexe, jm["prog"], jm["loss"].name, feed, jscope, 1)
        tl += _train(texe, tm["prog"], tm["loss"], feed, tscope, 1)
        for n in sums:
            sums[n] = sums[n] + tscope.find_var(n).numpy()
        if step in (1, 3):
            chip_smoke.check_state(
                "%s after step %d" % (tag, step),
                chip_smoke.state_diffs(names, tscope.find_var, jax_state),
                _reference_moves(jm, arrays, feed, step, names, jax_state),
                1e-5)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for v in tm["stats"]:
        assert float(tscope.find_var(v.name).sum()) == \
            float(np.asarray(jscope.find_var(v.name)).sum())
    for n, (s, c) in (ma.params.items() if ma else ()):
        np.testing.assert_array_equal(tscope.find_var(s.name).numpy(),
                                      sums[n])
        assert float(tscope.find_var(c.name)[0]) == 3.0


def test_hsigmoid_word_model_trains_as_the_jax_package():
    jp, js, _, (jloss,) = _w2v(jfluid, jnames, "hsigmoid")
    tp, ts, _, (tloss,) = _w2v(tfluid, tnames, "hsigmoid")
    jexe, jscope, texe, tscope, _ = _pair(dict(prog=jp, startup=js),
                                          dict(prog=tp, startup=ts))
    feed = chip_smoke.w2v_feed(np.random.RandomState(7), 16,
                               chip_smoke.BOOK_W2V["dict_size"])
    np.testing.assert_allclose(_train(texe, tp, tloss, feed, tscope, 5),
                               _train(jexe, jp, jloss.name, feed, jscope, 5),
                               rtol=1e-5)
    for n in chip_smoke.state_names(tp):
        _held(tscope.find_var(n).numpy(), np.asarray(jscope.find_var(n)), n)
