"""The program tooling of the port against the JAX package, on the CPU:
``calc_gradient``, ``LoDTensor``, ``InferenceTranspiler``,
``LayoutTranspiler``, the ``memory_optimize`` stubs and
``Executor.cost_analysis``.

Tolerances: gradients within rtol 1e-5 plus 1e-6 of the largest
magnitude (``tests/torch_dense_harness.py``'s bound); folded weights at
rtol 1e-6 against the JAX package's fold; a folded program's
probabilities against the unfolded one's at rtol 1e-4, atol 1e-5 (the
JAX test's bound, ``tests/test_concurrency_membership.py``);
``cost_analysis`` flops of the MNIST MLP's training step within 5 % of
XLA's count, where three products make the work. XLA also counts the
softmax, the normalisations and the Adam updates, which the port's
count leaves out (``analysis/cost.py``): the MLP's step measures 0.962
of XLA's flops, LeNet's 0.978, and the small transformer's (d_model 32,
where the elementwise work is a quarter of the step and XLA counts the
attention's masked half too) 0.763.
"""

import json
import os
import sys
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import layers as jlayers
from paddle_tpu import unique_name as jnames
from paddle_tpu.core.lod_tensor import LoDTensor as JLoDTensor
from paddle_tpu_torch import interop
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import unique_name as tnames

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402

_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, os.cpu_count() // int(_WORKERS)))

CPU = tfluid.CPUPlace()
RTOL, AMAX = 1e-5, 1e-6


def _pkg(fluid):
    return (jlayers, jnames) if fluid is jfluid else (tlayers, tnames)


def _dump(prog):
    return json.dumps(prog.to_dict(), sort_keys=True, indent=1)


def _close(got, want, rtol=RTOL, amax=AMAX):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(
        np.asarray(got, np.float64), want, rtol=rtol,
        atol=amax * max(1.0, float(np.abs(want).max(initial=0.0))))


def _pair(build):
    """``build(fluid, layers)`` in both packages; the port's scope holds
    the JAX startup's state. Returns ({pkg: (prog, startup, out)},
    jax scope, port scope)."""
    out = {}
    for fluid in (jfluid, tfluid):
        layers, names = _pkg(fluid)
        with names.guard():
            prog, startup = fluid.Program(), fluid.Program()
            with fluid.program_guard(prog, startup):
                res = build(fluid, layers)
        out[fluid] = (prog, startup, res)
    jscope = jfluid.Scope()
    jfluid.Executor().run(out[jfluid][1], scope=jscope)
    arrays = {v.name: np.asarray(jscope.find_var(v.name))
              for v in out[jfluid][0].list_vars() if v.persistable}
    tscope = tfluid.Scope()
    interop.load_reference_state(arrays, tscope, CPU,
                                 [out[tfluid][0], out[tfluid][1]])
    return out, jscope, tscope


# ---------------------------------------------------------------------------
# calc_gradient
# ---------------------------------------------------------------------------


def _accumulation(fluid, layers):
    """tests/test_framework.py's case: y = x + x, dy/dx = 2."""
    x = layers.data("x", [3], stop_gradient=False)
    y = layers.elementwise_add(x, x)
    loss = layers.reduce_sum(y)
    return [loss, fluid.calc_gradient(loss, [x])[0]]


def _lstm_head(fluid, layers, x):
    """A sequence classifier's head over ``x`` (B3/B4 on the card, their
    plain versions here)."""
    label = layers.data("label", [1], dtype="int64")
    proj = layers.fc(x, 16)
    h, _c = layers.dynamic_lstm(proj, size=16)
    pooled = layers.sequence_pool(h, "max")
    pred = layers.fc(pooled, 3, act="softmax")
    return layers.mean(layers.cross_entropy(pred, label))


def _lstm_net(fluid, layers):
    """The gradient with respect to the LSTM classifier's sequence
    input (and a weight)."""
    x = layers.data("x", [8], lod_level=1, stop_gradient=False)
    loss = _lstm_head(fluid, layers, x)
    return [loss] + fluid.calc_gradient(loss, [x, "fc_0.w_0"])


def _lstm_feed(rng, lengths=(5, 5, 5)):
    # equal lengths, as bench.py feeds: the JAX package's reverse rows
    # differ at position 0 (ROADMAP Queue 3); this LSTM runs forward
    return {"x": [rng.randn(n, 8).astype(np.float32) for n in lengths],
            "label": rng.randint(0, 3, (len(lengths), 1)).astype(np.int64)}


def _data(v):
    return v.data if hasattr(v, "lengths") else v


@pytest.mark.parametrize("build", [_accumulation, _lstm_net],
                         ids=["accumulation", "lstm_input"])
def test_calc_gradient_matches_the_jax_package(build):
    """Same program JSON, same grad variable names, and the same
    gradients from the same weights and feeds."""
    progs, jscope, tscope = _pair(build)
    (jp, _js, jout), (tp, _ts, tout) = progs[jfluid], progs[tfluid]
    assert _dump(tp) == _dump(jp)
    assert [v.name for v in tout[1:]] == [v.name for v in jout[1:]]
    rng = np.random.RandomState(3)
    feed = {"x": rng.rand(2, 3).astype(np.float32)} \
        if build is _accumulation else _lstm_feed(rng)
    names = [v.name for v in jout]
    j = jfluid.Executor().run(jp, feed=feed, fetch_list=names, scope=jscope)
    t = tfluid.Executor(CPU).run(tp, feed=feed, fetch_list=names,
                                 scope=tscope)
    for a, b in zip(j, t):
        _close(_data(b), _data(a))
    if build is _accumulation:
        np.testing.assert_allclose(t[1], 2 * np.ones((2, 3)), rtol=1e-6)


def test_calc_gradient_of_an_activation():
    """The gradient with respect to an embedding's OUTPUT (an op makes
    it). The JAX package's ``append_backward`` raises for it (the
    producer's grad op consumes the gradient; ROADMAP Queue 3); the
    port returns it, and it equals the JAX package's gradient with
    respect to the same rows fed as the sequence input."""
    def with_embedding(fluid, layers):
        words = layers.data("words", [1], dtype="int64", lod_level=1)
        emb = layers.embedding(words, size=[40, 8])
        loss = _lstm_head(fluid, layers, emb)
        return loss, emb

    with jnames.guard():
        jprog, jstart = jfluid.Program(), jfluid.Program()
        with jfluid.program_guard(jprog, jstart):
            loss, emb = with_embedding(jfluid, jlayers)
            with pytest.raises(RuntimeError, match="received no gradient"):
                jfluid.calc_gradient(loss, [emb])
    progs, jscope, tscope = _pair(_lstm_net)
    with tnames.guard():
        tprog, tstart = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(tprog, tstart):
            loss, emb = with_embedding(tfluid, tlayers)
            (g_emb,) = tfluid.calc_gradient(loss, [emb])
    assert g_emb.name == emb.name + "@GRAD"
    rng = np.random.RandomState(4)
    table = rng.randn(40, 8).astype(np.float32)
    tscope.set_var("embedding_0.w_0", torch.from_numpy(table))
    ids = [rng.randint(0, 40, (5, 1)).astype(np.int64) for _ in range(3)]
    label = rng.randint(0, 3, (3, 1)).astype(np.int64)
    t = tfluid.Executor(CPU).run(
        tprog, feed={"words": ids, "label": label},
        fetch_list=[loss, g_emb], scope=tscope)
    jp, _js, jout = progs[jfluid]
    j = jfluid.Executor().run(
        jp, feed={"x": [table[i[:, 0]] for i in ids], "label": label},
        fetch_list=[v.name for v in jout[:2]], scope=jscope)
    _close(t[0], j[0])
    _close(_data(t[1]), _data(j[1]))


def test_calc_gradient_takes_one_target():
    with tnames.guard():
        prog, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(prog, startup):
            x = tlayers.data("x", [3], stop_gradient=False)
            a, b = tlayers.reduce_sum(x), tlayers.reduce_mean(x)
            with pytest.raises(AssertionError, match="one target"):
                tfluid.calc_gradient([a, b], [x])


# ---------------------------------------------------------------------------
# LoDTensor
# ---------------------------------------------------------------------------


def _to_lodtensor(LoDTensor, rows):
    """benchmark/fluid/machine_translation.py's ``to_lodtensor``."""
    seq_lens = [len(seq) for seq in rows]
    cur_len = 0
    lod = [cur_len]
    for n in seq_lens:
        cur_len += n
        lod.append(cur_len)
    flattened = np.concatenate(rows, axis=0).astype("int64")
    flattened = flattened.reshape([len(flattened), 1])
    res = LoDTensor()
    res.set(flattened, None)
    res.set_lod([lod])
    return res


def test_lodtensor_pybind_surface_matches_the_jax_package():
    rows = [np.array([3, 1, 4]), np.array([1, 5]), np.array([9])]
    j, t = _to_lodtensor(JLoDTensor, rows), _to_lodtensor(tfluid.LoDTensor,
                                                         rows)
    assert t.lod() == j.lod() == [[0, 3, 5, 6]]
    assert t.get_dims() == j.get_dims() == [6, 1]
    assert t.get_float_element(3) == j.get_float_element(3) == 1.0
    assert np.array_equal(np.asarray(t), np.asarray(j))
    assert [r.tolist() for r in t.to_ragged()] == \
        [r.tolist() for r in j.to_ragged()]
    assert repr(t) == repr(j)
    packed = tfluid.PackedSeq(torch.tensor([[[1.], [2.]], [[3.], [0.]]]),
                              torch.tensor([2, 1], dtype=torch.int32))
    back = tfluid.LoDTensor.from_packed(packed)
    assert back.lod() == [[0, 2, 3]]
    assert back.numpy().ravel().tolist() == [1.0, 2.0, 3.0]
    scalar = tfluid.LoDTensor.from_value(torch.tensor(2.5))
    assert scalar.get_dims() == [1]
    assert tfluid.LoDTensor(np.zeros((2, 2))).lod() == []


def _seq_sum(fluid, layers):
    words = layers.data("words", [1], dtype="int64", lod_level=1)
    ids = layers.data("ids", [1], dtype="int64")
    emb = layers.embedding(words, size=[20, 4])
    pooled = layers.sequence_pool(emb, "sum")
    flat = layers.embedding(ids, size=[20, 4])
    return [pooled, flat]


def test_lodtensor_feeds_equal_packed_and_list_feeds():
    """A LoDTensor fed to a ``lod_level=1`` var packs into the same
    PackedSeq as the ragged list (bitwise the same results); one fed to
    a ``lod_level=0`` var is its dense array, as in the JAX package."""
    progs, jscope, tscope = _pair(_seq_sum)
    tp, _ts, tout = progs[tfluid]
    jp, _js, jout = progs[jfluid]
    rows = [np.array([3, 1, 4]), np.array([1, 5]), np.array([9])]
    ids = _to_lodtensor(tfluid.LoDTensor, [np.array([2]), np.array([7])])
    exe = tfluid.Executor(CPU)
    by_lod = exe.run(tp, feed={"words": _to_lodtensor(tfluid.LoDTensor,
                                                      rows), "ids": ids},
                     fetch_list=tout, scope=tscope)
    by_list = exe.run(tp, feed={"words": [r.reshape(-1, 1) for r in rows],
                                "ids": np.array([[2], [7]], np.int64)},
                      fetch_list=tout, scope=tscope)
    packed = tfluid.PackedSeq(
        torch.tensor([[3, 1, 4], [1, 5, 0], [9, 0, 0]]).reshape(3, 3, 1),
        torch.tensor([3, 2, 1], dtype=torch.int32))
    by_packed = exe.run(tp, feed={"words": packed,
                                  "ids": np.array([[2], [7]], np.int64)},
                        fetch_list=tout, scope=tscope)
    for a, b, c in zip(by_lod, by_list, by_packed):
        assert np.array_equal(a, b) and np.array_equal(a, c)
    j = jfluid.Executor().run(jp, feed={"words": _to_lodtensor(
        JLoDTensor, rows), "ids": _to_lodtensor(
        JLoDTensor, [np.array([2]), np.array([7])])},
        fetch_list=[v.name for v in jout], scope=jscope)
    for a, b in zip(j, by_lod):
        _close(b, a)


# ---------------------------------------------------------------------------
# InferenceTranspiler
# ---------------------------------------------------------------------------


def _conv_bn(fluid, layers):
    """The JAX test's conv -> batch_norm(is_test) -> fc net."""
    img = layers.data("img", [3, 8, 8])
    c = layers.conv2d(img, 8, 3, padding=1, bias_attr=False)
    c = layers.batch_norm(c, is_test=True)
    return layers.fc(c, 5, act="softmax")


def _lenet(fluid, layers):
    from importlib import import_module
    lenet = import_module(fluid.__name__ + ".models.lenet")
    img = layers.data("img", [1, 28, 28])
    return lenet.lenet(img)


def _resnet_is_test(fluid):
    """A small ResNet's training program cloned for test and pruned to
    its logits (phase 6k's ResNet-50 at depth 18, 32x32). Returns the
    is_test program, the training program, its startup and the logits'
    name."""
    from importlib import import_module
    resnet = import_module(fluid.__name__ + ".models.resnet")
    io = import_module(fluid.__name__ + ".io")
    _layers, names = _pkg(fluid)
    with names.guard():
        train, startup, _feeds, _fetches = resnet.build_resnet50_train(
            image_shape=(3, 32, 32), class_dim=10, depth=18)
    logits = chip_smoke.resnet_logits(train)
    return io.get_inference_program(
        [logits], main_program=train.clone(for_test=True)), train, \
        startup, logits


def _stats(prog, scope, rng, put):
    """Non-trivial running statistics for every batch norm."""
    for op in prog.global_block().ops:
        if op.type == "batch_norm":
            c = np.asarray(scope.find_var(op.inputs["Mean"][0])).shape[0]
            put(op.inputs["Mean"][0], rng.rand(c).astype(np.float32) * 0.5)
            put(op.inputs["Variance"][0],
                rng.rand(c).astype(np.float32) + 0.5)


@pytest.mark.parametrize("case", ["conv_bn", "lenet", "resnet18"])
def test_inference_transpiler_folds_as_the_jax_package(case):
    """The folded program's JSON is the JAX fold's byte for byte, its
    weights and folded biases agree at rtol 1e-6, and its probabilities
    agree with the unfolded program's."""
    x_rng = np.random.RandomState(1)
    if case == "resnet18":
        (jp, _jt, js, jname), (tp, tt, ts, tname) = (
            _resnet_is_test(jfluid), _resnet_is_test(tfluid))
        jscope = jfluid.Scope()
        jfluid.Executor().run(js, scope=jscope)
        arrays = {v.name: np.asarray(jscope.find_var(v.name))
                  for v in js.list_vars() if v.persistable}
        tscope = tfluid.Scope()
        interop.load_reference_state(arrays, tscope, CPU, [ts])
        shape = (4, 3, 32, 32)
        # the running statistics of the batch (random ones silence the
        # net: its logits come out 0), the same in both scopes
        n = chip_smoke.calibrate_bn(
            tfluid, tfluid.Executor(CPU), tt, tname,
            {"data": x_rng.rand(*shape).astype(np.float32)}, tscope)
        assert n == 20
        for op in tp.global_block().ops:
            if op.type == "batch_norm":
                for slot in ("Mean", "Variance"):
                    name = op.inputs[slot][0]
                    jscope.set_var(name, tscope.find_var(name).numpy())
    else:
        progs, jscope, tscope = _pair(_conv_bn if case == "conv_bn"
                                      else _lenet)
        (jp, _js, jout), (tp, _ts, tout) = progs[jfluid], progs[tfluid]
        jname, tname = jout.name, tout.name
        shape = (2, 3, 8, 8) if case == "conv_bn" else (2, 1, 28, 28)
    assert _dump(tp) == _dump(jp)
    if case != "resnet18":
        rng = np.random.RandomState(0)
        _stats(jp, jscope, rng, jscope.set_var)
        rng = np.random.RandomState(0)
        _stats(tp, tscope, rng,
               lambda n, a: tscope.set_var(n, torch.tensor(a)))
    x = x_rng.rand(*shape).astype(np.float32)
    feed_name = jp.global_block().ops[0].inputs[
        "Input" if jp.global_block().ops[0].type == "conv2d" else "X"][0]
    exe = tfluid.Executor(CPU)
    ref = exe.run(tp, feed={feed_name: x}, fetch_list=[tname],
                  scope=tscope)[0]
    n_bn = sum(op.type == "batch_norm" for op in tp.global_block().ops)
    version = tp.fingerprint
    with jnames.guard():
        jfluid.InferenceTranspiler().transpile(jp, scope=jscope)
    with tnames.guard():
        tfluid.InferenceTranspiler().transpile(tp, scope=tscope)
    assert tp.fingerprint != version
    assert _dump(tp) == _dump(jp)
    assert not any(op.type == "batch_norm" for op in tp.global_block().ops)
    assert n_bn == {"conv_bn": 1, "lenet": 0, "resnet18": 20}[case]
    for v in tp.list_vars():
        if v.persistable:
            np.testing.assert_allclose(
                tscope.find_var(v.name).numpy(),
                np.asarray(jscope.find_var(v.name)), rtol=1e-6, atol=0)
    out = exe.run(tp, feed={feed_name: x}, fetch_list=[tname],
                  scope=tscope)[0]
    assert np.abs(ref).max() > 1e-3
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# LayoutTranspiler (tests/test_layout.py's TestLayoutTranspiler)
# ---------------------------------------------------------------------------


def _fetch_only_transpose(fluid, layers):
    img = layers.data("img", [3, 8, 8])
    t = layers.transpose(img, [0, 1, 3, 2])
    layers.mean(img)
    fluid.LayoutTranspiler().transpile(fluid.default_main_program())
    return t


def _conv_bias(fluid, layers):
    img = layers.data("img", [3, 16, 16])
    c = layers.conv2d(img, 8, 3, padding=1, act="relu", bias_attr=True)
    pool = layers.pool2d(c, pool_size=2, pool_stride=2)
    loss = layers.mean(pool)
    fluid.LayoutTranspiler().transpile(fluid.default_main_program())
    return loss


@pytest.mark.parametrize("build", [_fetch_only_transpose, _conv_bias],
                         ids=["fetch_only_transpose", "conv_bias_axis"])
def test_layout_transpiler_matches_the_jax_package(build):
    """The build-time NHWC rewrite gives the JAX package's program; a
    fetch-only user transpose survives; the results equal the JAX
    package's on the same NHWC feed."""
    progs, jscope, tscope = _pair(build)
    (jp, _js, jout), (tp, _ts, tout) = progs[jfluid], progs[tfluid]
    assert _dump(tp) == _dump(jp)
    assert tp.global_block().var("img").shape[1:] == (
        (8, 8, 3) if build is _fetch_only_transpose else (16, 16, 3))
    assert any(tout.name in op.output_arg_names
               for op in tp.global_block().ops)
    shape = (2, 3, 8, 8) if build is _fetch_only_transpose \
        else (4, 3, 16, 16)
    x = np.random.RandomState(2).rand(*shape).astype(np.float32)
    feed = {"img": x.transpose(0, 2, 3, 1)}
    t = tfluid.Executor(CPU).run(tp, feed=feed, fetch_list=[tout],
                                 scope=tscope)[0]
    j = jfluid.Executor().run(jp, feed=feed, fetch_list=[jout.name],
                              scope=jscope)[0]
    _close(t, j)
    if build is _fetch_only_transpose:
        assert np.array_equal(t, x.transpose(0, 1, 3, 2))


# ---------------------------------------------------------------------------
# memory_optimize
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn", ["memory_optimize", "release_memory"])
def test_memory_optimize_stubs_warn_and_touch_nothing(fn):
    with tnames.guard():
        prog, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(prog, startup):
            x = tlayers.data("x", [4])
            tlayers.mean(tlayers.fc(x, 3))
    before, version = _dump(prog), prog.fingerprint
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = getattr(tfluid, fn)(prog)
    assert out is prog
    assert any(issubclass(w.category, DeprecationWarning)
               and "paddle_tpu_torch/passes/" in str(w.message)
               or "allocator" in str(w.message) for w in caught)
    assert _dump(prog) == before and prog.fingerprint == version


# ---------------------------------------------------------------------------
# cost_analysis
# ---------------------------------------------------------------------------


def _cost_pair(model, feed):
    from paddle_tpu.models import lenet as jlenet
    from paddle_tpu.models import transformer as jtr
    from paddle_tpu_torch.models import lenet as tlenet
    from paddle_tpu_torch.models import transformer as ttr

    costs = []
    for fluid, names, mod in ((jfluid, jnames, jlenet if model != "tr"
                               else jtr),
                              (tfluid, tnames, tlenet if model != "tr"
                               else ttr)):
        with names.guard():
            if model == "tr":
                prog, startup, _f, fetches = mod.build_transformer_lm(
                    vocab_size=64, seq_len=16, d_model=32, num_layers=2,
                    num_heads=4)
            else:
                prog, startup, _f, fetches = mod.build_mnist_train(model)
        if fluid is jfluid:
            with fluid.scope_guard(fluid.Scope()):
                exe = fluid.Executor()
                exe.run(startup)
                costs.append(exe.cost_analysis(prog, feed=feed,
                                               fetch_list=fetches))
        else:
            scope = tfluid.Scope()
            exe = tfluid.Executor(CPU)
            exe.run(startup, scope=scope)
            state = {n: v.clone() for n, v in scope.vars.items()
                     if v is not None}
            costs.append(exe.cost_analysis(prog, feed=feed,
                                           fetch_list=fetches, scope=scope))
            # nothing in the scope moved or was added
            assert set(n for n, v in scope.vars.items()
                       if v is not None) == set(state)
            for n, v in state.items():
                assert torch.equal(scope.find_var(n), v), n
    return costs


def test_cost_analysis_of_the_mlp_is_within_5_percent_of_xla():
    rng = np.random.RandomState(0)
    feed = {"img": rng.rand(64, 784).astype(np.float32),
            "label": rng.randint(0, 10, (64, 1)).astype(np.int64)}
    jc, tc = _cost_pair("mlp", feed)
    assert abs(tc["flops"] / jc["flops"] - 1.0) < 0.05, (tc, jc["flops"])
    # the three products and their grads: 2·64·(784·200 + 200·200 +
    # 200·10) forward; the first layer's grad makes its weight's only
    fwd = 2 * 64 * (784 * 200 + 200 * 200 + 200 * 10)
    assert tc["flops by op"]["mul"] == fwd
    assert tc["flops by op"]["mul_grad"] == 2 * fwd - 2 * 64 * 784 * 200
    assert tc["bytes accessed"] > 0


@pytest.mark.parametrize("model", ["cnn", "tr"], ids=["lenet",
                                                      "transformer"])
def test_cost_analysis_ratio_to_xla(model):
    """The ratios the module docstring states, and the products apart:
    LeNet's convolutions; the transformer's attention (B1) causal pairs,
    its grad at 2.5 forward products."""
    rng = np.random.RandomState(0)
    if model == "cnn":
        feed = {"img": rng.rand(16, 1, 28, 28).astype(np.float32),
                "label": rng.randint(0, 10, (16, 1)).astype(np.int64)}
        band = (0.95, 1.0)
    else:
        feed = {"tokens": rng.randint(0, 64, (4, 16)).astype(np.int64),
                "targets": rng.randint(0, 64, (4, 16)).astype(np.int64)}
        band = (0.7, 0.8)
    jc, tc = _cost_pair(model, feed)
    assert band[0] < tc["flops"] / jc["flops"] < band[1]
    by = tc["flops by op"]
    if model == "tr":
        pairs = 16 * 17 // 2
        assert by["fused_attention"] == 2 * 4 * 4 * 4 * pairs * 8
        assert by["fused_attention_grad"] == 2.5 * by["fused_attention"]
    else:
        assert by["conv2d"] > 0 and by["conv2d_grad"] > by["conv2d"]


def test_cost_analysis_counts_the_recurrent_products():
    """B3's and B4's work: the ``lstm`` op's recurrent product
    2·B·T·4H·H over the padded batch, its grad three times that."""
    from paddle_tpu_torch.models import stacked_lstm

    with tnames.guard():
        prog, startup, _f, fetches = stacked_lstm.build_stacked_lstm_train(
            dict_dim=100, emb_dim=16, hid_dim=16)
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    lens = [7, 5, 9]
    feed = {"words": [rng.randint(0, 100, (n, 1)).astype(np.int64)
                      for n in lens],
            "label": rng.randint(0, 2, (3, 1)).astype(np.int64)}
    c = exe.cost_analysis(prog, feed=feed, fetch_list=fetches, scope=scope)
    n_lstm = sum(op.type == "lstm" for op in prog.global_block().ops)
    one = 2 * 3 * max(lens) * 4 * 16 * 16
    assert c["flops by op"]["lstm"] == n_lstm * one
    assert c["flops by op"]["lstm_grad"] == 3 * n_lstm * one


def test_memory_analysis_and_hlo_text_name_their_roadmap_items():
    exe = tfluid.Executor(CPU)
    with pytest.raises(NotImplementedError, match="item 1"):
        exe.memory_analysis()
    with pytest.raises(NotImplementedError, match="item 4"):
        exe.hlo_text()
