"""The metric family in the port against the JAX package, on the CPU:

* the 4 metric op types (``auc``, ``precision_recall``,
  ``positive_negative_pair``, ``mean_iou``) on the same numpy inputs
  (``tests/torch_dense_harness.py``): every count exact (the histograms,
  the per-class states, the pair counts, the wrong and correct counts)
  and the ratios within rtol 1e-5 plus 1e-6 of the largest magnitude,
  streaming state included, scores on the bins' edges, ties, a class
  out of the batch;
* ``metrics`` (the numpy accumulators) and ``average.WeightedAverage``
  against the JAX package's on the same values;
* ``evaluator`` on ``tests/test_evaluator.py``'s cases through the
  port's executor (counters that accumulate, reset, and exist in a
  fresh scope after startup), its programs' JSON byte-identical;
* ``layers.auc`` streamed over batches in a program against
  ``metrics.Auc`` on the same predictions, and ``layers.mean_iou``."""

import json

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import unique_name as jnames
from paddle_tpu.core import registry as jreg
from paddle_tpu_torch import unique_name as tnames
from paddle_tpu_torch.core import registry as treg
from torch_dense_harness import close, run_jax, run_port

R = np.random.RandomState(53)
CPU = tfluid.CPUPlace()
TYPES = ["auc", "precision_recall", "positive_negative_pair", "mean_iou"]
COUNTS = {"StatPosOut", "StatNegOut", "AccumStatesInfo", "PositivePair",
          "NegativePair", "NeutralPair", "OutWrong", "OutCorrect"}


def _probs(n):
    s = R.rand(n).astype(np.float32)
    return np.stack([1 - s, s], 1)


def _edges():
    s = np.array([0.0, 1.0, 0.5, 1.0 / 4095, 0.99999994, 0.25, 0.25, 0.7],
                 np.float32)
    return np.stack([1 - s, s], 1)


def _hist(n, total):
    h = np.zeros(n, np.float32)
    np.add.at(h, R.randint(0, n, total), 1.0)
    return h


CASES = [
    ("auc", "auc", {"Predict": [_probs(64)],
                    "Label": [R.randint(0, 2, (64, 1)).astype(np.int64)]},
     {}),
    ("auc_bin_edges_and_ties", "auc",
     {"Predict": [_edges()],
      "Label": [np.array([[1], [0], [1], [0], [1], [1], [0], [0]],
                         np.int64)]}, {"num_thresholds": 4095}),
    ("auc_streaming", "auc",
     {"Predict": [_probs(32)],
      "Label": [R.randint(0, 2, (32, 1)).astype(np.int64)],
      "StatPos": [_hist(201, 50)], "StatNeg": [_hist(201, 70)]},
     {"num_thresholds": 200}),
    ("auc_scores", "auc",
     {"Predict": [R.rand(40, 1).astype(np.float32)],
      "Label": [R.randint(0, 2, (40, 1)).astype(np.int64)]},
     {"num_thresholds": 99}),
    ("auc_one_class", "auc",
     {"Predict": [_probs(8)], "Label": [np.ones((8, 1), np.int64)]}, {}),
    ("precision_recall", "precision_recall",
     {"Indices": [R.randint(0, 5, (30, 1)).astype(np.int64)],
      "Labels": [R.randint(0, 5, (30, 1)).astype(np.int64)]},
     {"class_number": 5}),
    ("precision_recall_states", "precision_recall",
     {"MaxProbs": [R.rand(20, 1).astype(np.float32)],
      "Indices": [R.randint(0, 4, (20, 1)).astype(np.int32)],
      "Labels": [R.randint(0, 3, (20, 1)).astype(np.int64)],
      "StatesInfo": [R.randint(0, 9, (4, 4)).astype(np.float32)]},
     {"class_number": 4}),
    ("positive_negative_pair", "positive_negative_pair",
     {"Score": [np.round(R.rand(24, 1), 1).astype(np.float32)],
      "Label": [R.randint(0, 3, (24, 1)).astype(np.float32)],
      "QueryID": [R.randint(0, 3, (24, 1)).astype(np.int64)]}, {}),
    ("mean_iou", "mean_iou",
     {"Predictions": [R.randint(0, 4, (5, 6)).astype(np.int32)],
      "Labels": [R.randint(0, 4, (5, 6)).astype(np.int32)]},
     {"num_classes": 5}),
]


@pytest.mark.parametrize("name,type,ins,attrs", CASES,
                         ids=[c[0] for c in CASES])
def test_metric_type_matches_the_jax_lowering(name, type, ins, attrs):
    j, t = run_jax(type, ins, attrs), run_port(type, ins, attrs)
    assert sorted(j) == sorted(t)
    for slot in j:
        a, b = j[slot][0], t[slot][0]
        assert b.dtype == a.dtype and b.shape == a.shape, slot
        if slot in COUNTS:
            np.testing.assert_array_equal(b, a, err_msg=slot)
            assert (b == np.round(b)).all(), slot
        else:
            close(b, a, slot)


def test_the_cases_cover_the_4_types_with_the_jax_flags():
    assert sorted({c[1] for c in CASES}) == sorted(TYPES)
    for t in TYPES:
        assert jreg.get(t).no_grad and treg.get(t).no_grad, t


def test_precision_recall_keeps_column_2_zero_and_ignores_max_probs():
    ins = dict(CASES[6][2])
    out = run_port("precision_recall", ins, {"class_number": 4})
    assert not out["AccumStatesInfo"][0][:, 2].any()
    ins["MaxProbs"] = [np.zeros((20, 1), np.float32)]
    again = run_port("precision_recall", ins, {"class_number": 4})
    for slot in out:
        np.testing.assert_array_equal(again[slot][0], out[slot][0])


# ---- metrics and average ----

def _both(name, *args, **kw):
    return (getattr(jfluid.metrics, name)(*args, **kw),
            getattr(tfluid.metrics, name)(*args, **kw))


def test_metrics_accumulators_match_the_jax_package():
    ja, ta = _both("Accuracy")
    for m in (ja, ta):
        for v, w in ((0.5, 4), (0.75, 8), (np.float32(1.0), 2), (0.25, 3)):
            m.update(v, w)
    assert ja.eval() == ta.eval()
    jc, tc = _both("ChunkEvaluator")
    je, te = _both("EditDistance")
    jauc, tauc = _both("Auc", num_thresholds=99)
    preds, labels = _probs(50), R.randint(0, 2, 50)
    for j, t in ((jc, tc), (je, te), (jauc, tauc)):
        if j is jc:
            args = [(3, 4, 2), (np.array(5), np.array(2), np.array(1))]
        elif j is je:
            args = [(np.array([0.0, 2.0, 1.0]), 3), (np.array([0.0]), 1)]
        else:
            args = [(preds[:20], labels[:20]), (preds[20:], labels[20:])]
        for a in args:
            j.update(*a)
            t.update(*a)
        assert j.eval() == t.eval()
    np.testing.assert_array_equal(tauc.stat_pos, jauc.stat_pos)
    for m in (tc, te):
        m.reset()
    assert tc.eval() == (0.0, 0.0, 0.0) and te.eval() == (0.0, 0.0)
    jcomp, tcomp = _both("CompositeMetric")
    jcomp.add_metric(jfluid.metrics.Auc())
    tcomp.add_metric(tfluid.metrics.Auc())
    jcomp.update(preds, labels)
    tcomp.update(preds, labels)
    assert jcomp.eval() == tcomp.eval()


def test_weighted_average_matches_the_jax_package():
    j, t = jfluid.average.WeightedAverage(), tfluid.average.WeightedAverage()
    for m in (j, t):
        with pytest.raises(ValueError):
            m.eval()
        m.add(np.float32(0.5), 64)
        m.add(np.array([0.25, 1.0]), np.array([2, 6]))
        m.add(1, 1.5)
        with pytest.raises(ValueError):
            m.add("x", 1)
    assert j.eval() == t.eval()
    t.reset()
    with pytest.raises(ValueError):
        t.eval()


# ---- evaluator ----

def _chunk_program(fluid, names):
    layers = fluid.layers
    with names.guard():
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            inf = layers.data("inf", [1], dtype="int64", lod_level=1)
            lab = layers.data("lab", [1], dtype="int64", lod_level=1)
            ev = fluid.evaluator.ChunkEvaluator(
                input=inf, label=lab, chunk_scheme="IOB",
                num_chunk_types=2)
    return prog, startup, ev


def _accuracy_program(fluid, names):
    layers = fluid.layers
    with names.guard():
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            img = layers.data("img", [8])
            label = layers.data("label", [1], dtype="int64")
            pred = layers.fc(img, 3, act="softmax")
            ev = fluid.evaluator.Accuracy(input=pred, label=label)
    return prog, startup, ev


def _dump(prog):
    return json.dumps(prog.to_dict(), sort_keys=True, indent=1)


@pytest.mark.parametrize("build", [_chunk_program, _accuracy_program])
def test_evaluator_programs_build_the_jax_packages_json(build):
    with jfluid.scope_guard(jfluid.Scope()):
        jp, js, _ = build(jfluid, jnames)
    with tfluid.scope_guard(tfluid.Scope()):
        tp, ts, _ = build(tfluid, tnames)
    assert _dump(tp) == _dump(jp)
    assert _dump(ts) == _dump(js)


def test_chunk_evaluator_accumulates_across_batches_and_resets():
    pred = [np.array([[0], [1], [2], [3]], np.int64),
            np.array([[2], [3]], np.int64)]
    gold = [np.array([[0], [1], [2], [3]], np.int64),
            np.array([[0], [1]], np.int64)]
    with tfluid.scope_guard(tfluid.Scope()):
        prog, startup, ev = _chunk_program(tfluid, tnames)
        exe = tfluid.Executor(CPU)
        exe.run(startup)
        for _ in range(3):
            batch = exe.run(prog, feed={"inf": pred, "lab": gold},
                            fetch_list=[v.name for v in ev.metrics])
        p, r, f1 = ev.eval(exe)
        assert abs(float(p[0]) - float(np.asarray(batch[0]))) < 1e-6
        assert 0.0 < float(f1[0]) <= 1.0
        scope = tfluid.global_scope()

        def counters():
            return tuple(float(scope.find_var(s.name).sum())
                         for s in (ev.num_infer_chunks, ev.num_label_chunks,
                                   ev.num_correct_chunks))

        after3 = counters()
        assert all(c > 0 for c in after3), after3
        ev.reset(exe)
        assert scope.find_var(ev.num_infer_chunks.name).device.type == "cpu"
        exe.run(prog, feed={"inf": pred, "lab": gold},
                fetch_list=[v.name for v in ev.metrics])
        after1 = counters()
        assert after3 == tuple(3 * c for c in after1), (after1, after3)
        ev.reset(exe)
        p2, _, f12 = ev.eval(exe)
        assert float(p2[0]) == 0.0 and float(f12[0]) == 0.0


def test_accuracy_evaluator_state_from_startup_in_fresh_scopes():
    rng = np.random.RandomState(0)
    feed = {"img": rng.rand(8, 8).astype(np.float32),
            "label": rng.randint(0, 3, (8, 1)).astype(np.int64)}
    with jfluid.scope_guard(jfluid.Scope()):
        jprog, jstart, jev = _accuracy_program(jfluid, jnames)
    with tfluid.scope_guard(tfluid.Scope()):
        tprog, tstart, tev = _accuracy_program(tfluid, tnames)
    for _ in range(2):  # two fresh scopes in sequence
        with jfluid.scope_guard(jfluid.Scope()):
            jexe = jfluid.Executor()
            jexe.run(jstart)
            weights = {n: np.asarray(jfluid.global_scope().find_var(n))
                       for n in ("fc_0.w_0", "fc_0.b_0")}
            for _ in range(2):
                jexe.run(jprog, feed=feed, fetch_list=[jev.metrics[0].name])
            want = jev.eval(jexe)
        with tfluid.scope_guard(tfluid.Scope()):
            exe = tfluid.Executor(CPU)
            exe.run(tstart)
            for n, v in weights.items():
                tfluid.global_scope().set_var(n, torch.tensor(v))
            accs = [float(exe.run(tprog, feed=feed,
                                  fetch_list=[tev.metrics[0].name])[0])
                    for _ in range(2)]
            got = tev.eval(exe)
        assert 0.0 <= float(got[0]) <= 1.0
        np.testing.assert_array_equal(got, want)
        assert float(got[0]) == np.float32(np.mean(accs))


# ---- the metric layers in a program ----

def _auc_program(fluid, names, classes=2):
    layers = fluid.layers
    with names.guard():
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            pred = layers.data("pred", [classes])
            label = layers.data("label", [1], dtype="int64")
            auc, batch_auc, stats = layers.auc(pred, label,
                                               num_thresholds=255)
            miou = layers.mean_iou(layers.cast(label, "int32"),
                                   layers.cast(label, "int32"), classes)
    return prog, startup, auc, stats, miou


def test_auc_and_mean_iou_layers_build_the_jax_packages_json():
    jp, js, *_ = _auc_program(jfluid, jnames)
    tp, ts, *_ = _auc_program(tfluid, tnames)
    assert _dump(tp) == _dump(jp)
    assert _dump(ts) == _dump(js)


def test_streamed_auc_layer_equals_metrics_auc():
    prog, startup, auc, stats, miou = _auc_program(tfluid, tnames)
    scope, exe = tfluid.Scope(), tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    ref = tfluid.metrics.Auc(num_thresholds=255)
    jprog, jstart, jauc, *_ = _auc_program(jfluid, jnames)
    jscope, jexe = jfluid.Scope(), jfluid.Executor()
    jexe.run(jstart, scope=jscope)
    for _ in range(4):
        feed = {"pred": _probs(16),
                "label": R.randint(0, 2, (16, 1)).astype(np.int64)}
        got, pos, neg, m = exe.run(prog, feed=feed,
                                   fetch_list=[auc] + stats + [miou[0]],
                                   scope=scope)
        want = jexe.run(jprog, feed=feed, fetch_list=[jauc], scope=jscope)[0]
        ref.update(feed["pred"], feed["label"])
        np.testing.assert_array_equal(pos, ref.stat_pos)
        np.testing.assert_array_equal(neg, ref.stat_neg)
        np.testing.assert_allclose(float(got), ref.eval(), rtol=1e-6)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
        assert float(m) == 1.0
