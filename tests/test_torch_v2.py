"""The v2 frontend (``paddle_tpu_torch.v2``) against paddle_tpu's, on the
CPU, as ``tests/test_v2_api.py`` and ``tests/test_v2_evaluator.py``
drive it:

* the xor MLP, the sequence model, the v2 book's stacked-LSTM net (tanh,
  which runs the LSTM kernels' plain versions, and Relu, the step loop)
  and the GRU net build byte-identical program JSON in both packages,
  before and after ``trainer.SGD`` appends Adam;
* the weights cross between the packages by the tar format: a
  paddle_tpu ``to_tar`` loads through ``from_tar`` and ``init_from_tar``
  to equal arrays, a port ``to_tar`` is byte-identical to paddle_tpu's
  for the same values and loads there;
* from those weights, the ``EndIteration`` costs of 5 Adam batches of
  equal-length rows agree at rtol 1e-5, so do ``test()`` and ``infer``,
  and the parameters after training agree at the LSTM tests' gradient
  tolerance (rtol 1e-4, atol 1e-6);
* the evaluators' metrics reach ``EndIteration.metrics`` as in
  paddle_tpu, ``detection_map_evaluator`` raises ``AttributeError`` in
  both (ROADMAP.md Queue 3), ``trainer_count=4`` raises
  ``NotImplementedError``, and with no card v2's default place makes the
  entry points raise.

Rows are of equal length: paddle_tpu's reverse LSTM loses position 0 of
short reverse rows (ROADMAP.md Queue 3), and the stacked net's second
LSTM runs reversed."""

import io
import json
import os
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.v2 as jv2
import paddle_tpu_torch as tfluid
import paddle_tpu_torch.v2 as tv2

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, os.cpu_count() // int(_WORKERS)))

# the sizes: vocabulary 64, embedding 16, hidden 8, 3 stacked LSTMs,
# batches of 8 rows of LEN ids
VOCAB, EMB, HID, STACKED, BATCH, LEN, BATCHES = 64, 16, 8, 3, 8, 6, 5
# each session's startup seed (chip_smoke.v2_session): Program's default
SEED = 0


def mlp(v2):
    """tests/test_v2_api.py's xor MLP."""
    x = v2.layer.data("x", v2.data_type.dense_vector(2))
    label = v2.layer.data("label", v2.data_type.integer_value(2))
    hidden = v2.layer.fc(input=x, size=16, act=v2.activation.Tanh())
    pred = v2.layer.fc(input=hidden, size=2, act=v2.activation.Softmax())
    return v2.layer.classification_cost(input=pred, label=label), pred


def sequence(v2):
    """tests/test_v2_api.py's sequence model (vocabulary 20)."""
    words = v2.layer.data("words",
                          v2.data_type.integer_value_sequence(20))
    label = v2.layer.data("label", v2.data_type.integer_value(2))
    emb = v2.layer.embedding(input=words, size=8)
    pooled = v2.layer.pooling(input=emb, pooling_type=v2.pooling.Avg)
    pred = v2.layer.fc(input=pooled, size=2,
                       act=v2.activation.Softmax())
    return v2.layer.classification_cost(input=pred, label=label), pred


def stacked(v2):
    return chip_smoke.v2_stacked_build(v2, VOCAB, EMB, HID, STACKED)


def stacked_relu(v2):
    return chip_smoke.v2_stacked_build(v2, VOCAB, EMB, HID, STACKED,
                                       act=v2.activation.Relu())


def gru(v2):
    return chip_smoke.v2_gru_build(v2, VOCAB, EMB, HID)


def xor_rows(n, seed):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        x = rng.randint(0, 2, size=(2,)).astype("float32")
        yield x, np.int64(int(x[0]) ^ int(x[1]))


def id_rows(vocab):
    def rows(n, seed):
        rng = np.random.RandomState(seed)
        for _ in range(n):
            yield rng.randint(0, vocab, LEN).tolist(), int(rng.randint(2))
    return rows


# name -> (builder, rows(n, seed), Adam's rate)
MODELS = {
    "mlp": (mlp, xor_rows, 0.05),
    "sequence": (sequence, id_rows(20), 0.1),
    "stacked": (stacked, id_rows(VOCAB), 1e-2),
    "stacked_relu": (stacked_relu, id_rows(VOCAB), 1e-2),
    "gru": (gru, id_rows(VOCAB), 1e-2),
}


def reader(v2, rows, n, seed):
    return v2.batch(lambda: rows(n, seed), BATCH)


def dump(prog):
    return json.dumps(prog.to_dict(), sort_keys=True, indent=1)


def build(fluid, v2, which, trainer=True):
    """Builds ``which`` in the current session: (cost, pred, parameters,
    trainer or None)."""
    fn, _, lr = MODELS[which]
    cost, pred = fn(v2)
    params = v2.parameters.create(cost)
    sgd = v2.trainer.SGD(cost=cost, parameters=params,
                         update_equation=v2.optimizer.Adam(
                             learning_rate=lr)) if trainer else None
    return cost, pred, params, sgd


def run(fluid, v2, which, weights=None):
    """Builds and trains ``which`` in a fresh session of one package (from
    ``weights``, a tar, when given) over BATCHES batches; returns the
    programs' JSON, the tar of the weights trained from, the costs, the
    test cost, the inference of 8 rows and the parameters after."""
    _, rows, _ = MODELS[which]
    with chip_smoke.v2_session(fluid, v2, False, SEED):
        cost, pred, params, sgd = build(fluid, v2, which)
        if weights is not None:
            weights.seek(0)
            params.init_from_tar(weights)
        start = io.BytesIO()
        params.to_tar(start)
        costs = []
        sgd.train(reader(v2, rows, BATCH * BATCHES, 3), event_handler=lambda e:
                  costs.append(e.cost)
                  if isinstance(e, v2.event.EndIteration) else None)
        tested = sgd.test(reader(v2, rows, BATCH * 2, 5)).cost
        inferred = v2.infer(output_layer=pred, parameters=params,
                            input=[r[:1] for r in rows(8, 7)])
        after = {n: params[n] for n in params.names()}
        return (dump(cost.block.program), start, costs, tested, inferred,
                after)


@pytest.mark.parametrize("which", sorted(MODELS))
def test_v2_program_json_is_the_jax_packages(which):
    progs = []
    for fluid, v2 in ((jfluid, jv2), (tfluid, tv2)):
        with chip_smoke.v2_session(fluid, v2, False, SEED):
            cost, _ = MODELS[which][0](v2)
            prog = cost.block.program
            built = [dump(prog), dump(fluid.default_startup_program())]
            params = v2.parameters.create(cost)
            v2.trainer.SGD(cost=cost, parameters=params,
                           update_equation=v2.optimizer.Adam(1e-3))
            built += [dump(prog), dump(fluid.default_startup_program())]
            progs.append(built)
    for j, t in zip(*progs):
        assert t == j


@pytest.mark.parametrize("which", ["mlp", "stacked", "gru"])
def test_v2_tar_carries_the_weights_both_ways(which):
    with chip_smoke.v2_session(jfluid, jv2, False, SEED):
        _, _, jparams, _ = build(jfluid, jv2, which, trainer=False)
        jtar = io.BytesIO()
        jparams.to_tar(jtar)
        jvals = {n: jparams[n] for n in jparams.names()}
    with chip_smoke.v2_session(tfluid, tv2, False, SEED):
        _, _, tparams, _ = build(tfluid, tv2, which, trainer=False)
        assert tparams.names() == list(jvals)
        jtar.seek(0)
        detached = tv2.parameters.Parameters.from_tar(jtar)
        jtar.seek(0)
        tparams.init_from_tar(jtar)
        for n, want in jvals.items():
            for got in (detached[n], tparams[n]):
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
            assert isinstance(tfluid.global_scope().find_var(n),
                              torch.Tensor)
        ttar = io.BytesIO()
        tparams.to_tar(ttar)
    assert ttar.getvalue() == jtar.getvalue()
    ttar.seek(0)
    back = jv2.parameters.Parameters.from_tar(ttar)
    for n, want in jvals.items():
        np.testing.assert_array_equal(back[n], want)


@pytest.mark.parametrize("which", sorted(MODELS))
def test_v2_training_test_and_infer_match_the_jax_package(which):
    jprog, jtar, jcosts, jtest, jinfer, jafter = run(jfluid, jv2, which)
    tprog, ttar, tcosts, ttest, tinfer, tafter = run(tfluid, tv2, which,
                                                     weights=jtar)
    assert tprog == jprog
    assert ttar.getvalue() == jtar.getvalue()
    assert len(tcosts) == BATCHES
    np.testing.assert_allclose(tcosts, jcosts, rtol=1e-5)
    assert np.isfinite(tcosts).all()
    np.testing.assert_allclose(ttest, jtest, rtol=1e-5)
    np.testing.assert_allclose(tinfer, jinfer, rtol=1e-5, atol=1e-7)
    assert sorted(tafter) == sorted(jafter)
    for n, want in jafter.items():
        np.testing.assert_allclose(tafter[n], want, rtol=1e-4, atol=1e-6,
                                   err_msg=n)


def test_v2_test_does_not_mutate_params():
    with chip_smoke.v2_session(tfluid, tv2, False, SEED):
        _, _, params, sgd = build(tfluid, tv2, "mlp")
        before = {n: params[n].copy() for n in params.names()}
        sgd.test(reader(tv2, xor_rows, 16, 0))
        for n in params.names():
            np.testing.assert_array_equal(params[n], before[n])


def test_v2_from_tar_is_detached():
    """tests/test_v2_api.py's case: reading a checkpoint leaves the live
    weights alone, and inference from it uses its own weights."""
    with chip_smoke.v2_session(tfluid, tv2, False, SEED):
        _, pred, params, _ = build(tfluid, tv2, "mlp", trainer=False)
        w = params.names()[0]
        live = params[w].copy()
        buf = io.BytesIO()
        params.to_tar(buf)
        params[w] = live + 5.0
        buf.seek(0)
        old = tv2.parameters.Parameters.from_tar(buf)
        np.testing.assert_allclose(params[w], live + 5.0)
        np.testing.assert_array_equal(old[w], live)
        row = [(np.array([1, 0], "float32"),)]
        probs_old = tv2.infer(output_layer=pred, parameters=old, input=row)
        params[w] = live
        probs_live = tv2.infer(output_layer=pred, parameters=params,
                               input=row)
        np.testing.assert_array_equal(probs_old, probs_live)
        assert params.get_shape(w) == live.shape
        params[w] = live.astype(np.float64)      # written in float32
        assert tfluid.global_scope().find_var(w).dtype == torch.float32
        with pytest.raises(ValueError, match="shape mismatch"):
            params[w] = np.zeros((3, 3), np.float32)
        with pytest.raises(KeyError):
            params["no_such_parameter"]


def test_v2_trainer_count_above_one_is_not_ported():
    with chip_smoke.v2_session(tfluid, tv2, False, SEED):
        tv2.init(use_gpu=False, trainer_count=4)
        try:
            cost, _ = mlp(tv2)
            params = tv2.parameters.create(cost)
            with pytest.raises(NotImplementedError,
                               match="Queue 1 item 4"):
                tv2.trainer.SGD(cost=cost, parameters=params,
                                update_equation=tv2.optimizer.Adam(0.05))
        finally:
            tv2.init(use_gpu=False, trainer_count=1)


def test_v2_default_place_is_the_card():
    """init() with no use_gpu, and no init at all, mean CUDAPlace(0): with
    no card the entry points raise rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: v2 runs on it")
    saved = dict(tv2._settings)
    try:
        with chip_smoke.v2_session(tfluid, tv2, False, SEED):
            tv2._settings.update(use_gpu=True, initialized=False)
            assert tv2._place() == tfluid.CUDAPlace(0)
            cost, pred = mlp(tv2)
            with pytest.raises(RuntimeError, match="no CUDA device"):
                tv2.parameters.create(cost)
            tv2.init()
            assert tv2._place() == tfluid.CUDAPlace(0)
            with pytest.raises(RuntimeError, match="no CUDA device"):
                tv2.parameters.create(cost)
            with pytest.raises(RuntimeError, match="no CUDA device"):
                tv2.infer(output_layer=pred,
                          parameters=tv2.parameters.Parameters([]),
                          input=[(np.zeros(2, "float32"),)])
            buf = io.BytesIO()
            tv2.init(use_gpu=False)
            params = tv2.parameters.create(cost)
            params.to_tar(buf)
            tv2.init()
            buf.seek(0)
            with pytest.raises(RuntimeError, match="no CUDA device"):
                tv2.parameters.Parameters.from_tar(buf)
    finally:
        tv2._settings.clear()
        tv2._settings.update(saved)


REF_EVALUATOR_ALL = [
    "evaluator_base", "classification_error_evaluator", "auc_evaluator",
    "pnpair_evaluator", "precision_recall_evaluator", "ctc_error_evaluator",
    "chunk_evaluator", "sum_evaluator", "column_sum_evaluator",
    "value_printer_evaluator", "gradient_printer_evaluator",
    "maxid_printer_evaluator", "maxframe_printer_evaluator",
    "seqtext_printer_evaluator", "classification_error_printer_evaluator",
    "detection_map_evaluator",
]


def test_v2_namespaces_cover_the_jax_packages():
    for name in REF_EVALUATOR_ALL:
        assert hasattr(tv2.evaluator, name), name
    for mod in ("layer", "networks", "evaluator", "optimizer", "activation",
                "pooling", "data_type", "event", "parameters", "trainer",
                "inference"):
        assert getattr(tv2, mod).__all__ == getattr(jv2, mod).__all__, mod
    for name in ("batch", "infer", "dataset", "reader", "init"):
        assert hasattr(tv2, name), name


def evaluated(fluid, v2, weights=None):
    """tests/test_v2_evaluator.py's topology: a softmax fc with
    classification_error and value_printer evaluators and a second head
    under auc; 3 Adam batches. Returns (the tar trained from, the
    metrics of each batch, the JSON)."""
    with chip_smoke.v2_session(fluid, v2, False, SEED):
        images = v2.layer.data("pixel", v2.data_type.dense_vector(16))
        label = v2.layer.data("label", v2.data_type.integer_value(4))
        fc = v2.layer.fc(images, size=4, act=v2.activation.Softmax())
        cost = v2.layer.classification_cost(fc, label)
        v2.evaluator.classification_error_evaluator(fc, label,
                                                    name="clserr")
        v2.evaluator.value_printer_evaluator(cost, name="costval")
        fc2 = v2.layer.fc(images, size=2, act=v2.activation.Softmax())
        lab2 = v2.layer.data("lab2", v2.data_type.integer_value(2))
        v2.evaluator.auc_evaluator(fc2, lab2, name="auc")
        params = v2.parameters.create(cost)
        trainer = v2.trainer.SGD(cost, params,
                                 v2.optimizer.Adam(learning_rate=1e-2))
        if weights is not None:
            weights.seek(0)
            params.init_from_tar(weights)
        start = io.BytesIO()
        params.to_tar(start)

        def rows():
            rng = np.random.RandomState(0)
            for _ in range(24):
                yield (rng.rand(16).astype(np.float32),
                       int(rng.randint(4)), int(rng.randint(2)))

        seen = []
        trainer.train(v2.batch(rows, batch_size=8), num_passes=1,
                      event_handler=lambda e: seen.append(e.metrics)
                      if isinstance(e, v2.event.EndIteration) else None)
        return start, seen, dump(cost.block.program)


def test_v2_evaluator_metrics_match_the_jax_package(capsys):
    jtar, jseen, jprog = evaluated(jfluid, jv2)
    jout = capsys.readouterr().out
    _, tseen, tprog = evaluated(tfluid, tv2, weights=jtar)
    tout = capsys.readouterr().out
    assert tprog == jprog
    assert len(tseen) == len(jseen) == 3
    for t, j in zip(tseen, jseen):
        assert sorted(t) == sorted(j) == ["auc", "clserr", "costval"]
        for k in j:
            np.testing.assert_allclose(np.asarray(t[k], np.float64),
                                       np.asarray(j[k], np.float64),
                                       rtol=1e-5, err_msg=k)
    assert tout.count("costval") == jout.count("costval") == 3


def test_detection_map_evaluator_raises_in_both_packages():
    """Shared fault (ROADMAP.md Queue 3): the evaluator calls
    ``layers.detection_map``, which neither package's ``layers`` exports
    at the top level (it lives in ``layers.detection``)."""
    for fluid, v2 in ((jfluid, jv2), (tfluid, tv2)):
        with chip_smoke.v2_session(fluid, v2, False, SEED):
            det = fluid.layers.data("det", [6])
            gt = fluid.layers.data("gt", [6])
            assert not hasattr(fluid.layers, "detection_map")
            assert hasattr(fluid.layers.detection, "detection_map")
            with pytest.raises(AttributeError, match="detection_map"):
                v2.evaluator.detection_map_evaluator(det, gt)


def evaluators(fluid, v2):
    """Every v2 evaluator but detection_map's, over one small topology;
    returns the registered variables."""
    L, ev = fluid.layers, v2.evaluator
    x = v2.layer.data("x", v2.data_type.dense_vector(4))
    label = v2.layer.data("label", v2.data_type.integer_value(4))
    qid = v2.layer.data("qid", v2.data_type.integer_value(3))
    prob = v2.layer.fc(x, size=4, act=v2.activation.Softmax())
    prob2 = v2.layer.fc(x, size=2, act=v2.activation.Softmax())
    score = v2.layer.fc(x, size=1)
    hyp = L.data("hyp", [1], dtype="int64", lod_level=1)
    ref = L.data("ref", [1], dtype="int64", lod_level=1)
    tags = L.data("tags", [1], dtype="int64", lod_level=1)
    gold = L.data("gold", [1], dtype="int64", lod_level=1)
    ev.evaluator_base(prob)
    ev.classification_error_evaluator(prob, label, top_k=2)
    ev.auc_evaluator(prob2, L.data("bin", [1], dtype="int64"))
    ev.pnpair_evaluator(score, label, qid)
    ev.precision_recall_evaluator(prob, label)
    ev.ctc_error_evaluator(hyp, ref)
    ev.chunk_evaluator(tags, gold, chunk_scheme="IOB", num_chunk_types=2)
    ev.sum_evaluator(prob)
    ev.column_sum_evaluator(prob)
    ev.value_printer_evaluator(score)
    ev.gradient_printer_evaluator(score)
    ev.maxid_printer_evaluator(prob)
    ev.maxframe_printer_evaluator(prob)
    ev.seqtext_printer_evaluator(prob)
    ev.classification_error_printer_evaluator(prob, label)
    return [var for var, _, _ in ev.registered_for(
        fluid.default_main_program())]


def test_every_v2_evaluator_builds_and_computes_as_the_jax_package():
    rng = np.random.RandomState(4)
    feed = {"x": rng.rand(6, 4).astype(np.float32),
            "label": rng.randint(0, 4, (6, 1)).astype(np.int64),
            "qid": np.array([[0], [0], [1], [1], [2], [2]], np.int64),
            "bin": rng.randint(0, 2, (6, 1)).astype(np.int64),
            "hyp": [rng.randint(0, 5, (n, 1)).astype(np.int64)
                    for n in (3, 4)],
            "ref": [rng.randint(0, 5, (n, 1)).astype(np.int64)
                    for n in (4, 2)],
            "tags": [rng.randint(0, 5, (n, 1)).astype(np.int64)
                     for n in (5, 3)],
            "gold": [rng.randint(0, 5, (n, 1)).astype(np.int64)
                     for n in (5, 3)]}
    got, arrays = [], None
    for fluid, v2 in ((jfluid, jv2), (tfluid, tv2)):
        with chip_smoke.v2_session(fluid, v2, False, SEED):
            names = [v.name for v in evaluators(fluid, v2)]
            prog = fluid.default_main_program()
            startup = fluid.default_startup_program()
            scope = fluid.global_scope()
            if arrays is None:
                exe = fluid.Executor()
                exe.run(startup)
                arrays = {v.name: np.asarray(scope.find_var(v.name))
                          for v in prog.list_vars() if v.persistable}
            else:
                from paddle_tpu_torch import interop
                exe = fluid.Executor(fluid.CPUPlace())
                interop.load_reference_state(arrays, scope,
                                             fluid.CPUPlace(),
                                             [prog, startup])
            outs = exe.run(prog, feed=feed, fetch_list=names)
            got.append((dump(prog), dump(startup), names,
                        [np.asarray(o) for o in outs]))
    (jp, js, jn, jo), (tp, ts, tn, to) = got
    assert (tp, ts, tn) == (jp, js, jn)
    assert len(tn) == 15
    for n, t, j in zip(tn, to, jo):
        np.testing.assert_allclose(t.astype(np.float64),
                                   j.astype(np.float64), rtol=1e-5,
                                   atol=1e-6, err_msg=n)
