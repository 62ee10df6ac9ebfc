"""The port's ``io`` against the JAX package's: the same pruned program
JSON (byte for byte) and the same on-disk format, so a model either
package saves loads and serves in the other (a two-layer MLP, and the
stacked-LSTM classifier at dict 40, width 8, three layers, on sequences
of full length: see ``_feeds``).

Tolerances: outputs within rtol 1e-5 (the same float32 math in another
summation order, through two fc layers or a small stacked LSTM)."""

import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import layers as jlayers
from paddle_tpu import unique_name as jnames
from paddle_tpu.models.stacked_lstm import stacked_lstm_net as jlstm_net
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu_torch import interop
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import unique_name as tnames
from paddle_tpu_torch.models.stacked_lstm import (
    stacked_lstm_net as tlstm_net)
from paddle_tpu_torch.serving import ServingEngine

# Under pytest-xdist each worker takes its share of the cores for
# torch's intra-op threads: six workers at torch's default thread count
# oversubscribe the cores, and a test of seconds then takes minutes.
_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, os.cpu_count() // int(_WORKERS)))

CPU = tfluid.CPUPlace()
RTOL = 1e-5
DICT, HID = 40, 8


def _mlp(fluid, layers, names):
    with names.guard():
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            img = layers.data("img", [16])
            label = layers.data("label", [1], dtype="int64")
            hidden = layers.fc(img, 32, act="relu")
            pred = layers.fc(hidden, 10, act="softmax")
            loss = layers.mean(layers.cross_entropy(pred, label))
            fluid.optimizer.Adam(1e-3).minimize(loss)
    return prog, startup, pred


def _lstm(fluid, layers, names, net):
    with names.guard():
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            words = layers.data("words", [1], dtype="int64", lod_level=1)
            pred = net(words, DICT, class_dim=2, emb_dim=HID, hid_dim=HID,
                       stacked_num=3)
    return prog, startup, pred


MODELS = {
    "mlp": (lambda: _mlp(jfluid, jlayers, jnames),
            lambda: _mlp(tfluid, tlayers, tnames), ["img"]),
    "stacked_lstm": (lambda: _lstm(jfluid, jlayers, jnames, jlstm_net),
                     lambda: _lstm(tfluid, tlayers, tnames, tlstm_net),
                     ["words"]),
}


def _jax_scope(startup):
    scope = jfluid.Scope()
    jfluid.Executor().run(startup, scope=scope)
    return scope


def _arrays(scope, prog):
    return {v.name: np.asarray(scope.find_var(v.name))
            for v in prog.list_vars()
            if v.persistable and scope.find_var(v.name) is not None}


def _feeds(kind, n, seed=0):
    """Full-length sequences: the JAX package's reverse LSTM zeroes
    position 0 of rows shorter than the batch's padded length (ROADMAP
    Queue 3), so the packages are compared on rows of full length, as
    every other port test does; ragged rows are held against the port's
    own executor in tests/test_torch_serving.py."""
    rng = np.random.RandomState(seed)
    if kind == "mlp":
        return {"img": rng.rand(n, 16).astype(np.float32)}
    ids = rng.randint(0, DICT, (n, 8, 1)).astype(np.int64)
    return {"words": (ids, np.full(n, 8, np.int32))}


def _jfeed(kind, feed):
    if kind == "mlp":
        return feed
    ids, lens = feed["words"]
    return {"words": jfluid.PackedSeq(ids.astype(np.int32), lens)}


def _tfeed(kind, feed):
    if kind == "mlp":
        return feed
    ids, lens = feed["words"]
    return {"words": tfluid.PackedSeq(torch.from_numpy(ids),
                                      torch.from_numpy(lens))}


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_inference_program_json_is_byte_identical(kind, tmp_path):
    jbuild, tbuild, feeds = MODELS[kind]
    jprog, jstart, jpred = jbuild()
    tprog, tstart, tpred = tbuild()
    jinf = jfluid.io.get_inference_program([jpred], jprog)
    tinf = tfluid.io.get_inference_program([tpred], tprog)
    assert json.dumps(tinf.to_dict(), sort_keys=True) == \
        json.dumps(jinf.to_dict(), sort_keys=True)
    # save_inference_model's __model__.json, byte for byte
    jscope = _jax_scope(jstart)
    with jfluid.scope_guard(jscope):
        jfluid.io.save_inference_model(str(tmp_path / "j"), feeds, [jpred],
                                       jfluid.Executor(), main_program=jprog)
    tscope = tfluid.Scope()
    interop.load_reference_state(_arrays(jscope, tstart), tscope, CPU,
                                 tstart)
    with tfluid.scope_guard(tscope):
        tfluid.io.save_inference_model(str(tmp_path / "t"), feeds, [tpred],
                                       tfluid.Executor(CPU),
                                       main_program=tprog)
    with open(tmp_path / "j" / "__model__.json", "rb") as f:
        want = f.read()
    with open(tmp_path / "t" / "__model__.json", "rb") as f:
        assert f.read() == want
    # the same arrays under the same names
    with np.load(tmp_path / "j" / "__params__.npz") as j, \
            np.load(tmp_path / "t" / "__params__.npz") as t:
        assert sorted(j.files) == sorted(t.files)
        for n in j.files:
            assert np.array_equal(j[n], t[n]), n


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_a_jax_saved_model_serves_in_the_port(kind, tmp_path):
    jbuild, _, feeds = MODELS[kind]
    jprog, jstart, jpred = jbuild()
    jscope = _jax_scope(jstart)
    jexe = jfluid.Executor()
    with jfluid.scope_guard(jscope):
        jfluid.io.save_inference_model(str(tmp_path), feeds, [jpred], jexe,
                                       main_program=jprog)
    feed = _feeds(kind, 5)
    jinf = jfluid.io.get_inference_program([jpred], jprog)
    want = np.asarray(jexe.run(jinf, feed=_jfeed(kind, feed),
                               fetch_list=[jpred.name], scope=jscope)[0])

    tscope = tfluid.Scope()
    texe = tfluid.Executor(CPU)
    with tfluid.scope_guard(tscope):
        prog, feed_names, fetch_vars = tfluid.io.load_inference_model(
            str(tmp_path), texe)
    assert feed_names == feeds and [v.name for v in fetch_vars] == \
        [jpred.name]
    assert all(t.device.type == "cpu" for t in tscope.vars.values())
    got = texe.run(prog, feed=_tfeed(kind, feed),
                   fetch_list=[fetch_vars[0].name], scope=tscope)[0]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)
    eng = ServingEngine(prog, feed_names, fetch_vars, scope=tscope,
                        max_batch=8, place=CPU,
                        seq_lens={"words": 8} if kind != "mlp" else None)
    eng.warmup()
    served = eng.infer(_tfeed(kind, feed))[0]
    np.testing.assert_allclose(served, want, rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_a_port_saved_model_loads_in_the_jax_package(kind, tmp_path):
    jbuild, tbuild, feeds = MODELS[kind]
    jprog, jstart, jpred = jbuild()
    tprog, tstart, tpred = tbuild()
    tscope = tfluid.Scope()
    interop.load_reference_state(_arrays(_jax_scope(jstart), tstart),
                                 tscope, CPU, tstart)
    texe = tfluid.Executor(CPU)
    with tfluid.scope_guard(tscope):
        tfluid.io.save_inference_model(str(tmp_path), feeds, tpred, texe,
                                       main_program=tprog)
    feed = _feeds(kind, 3, seed=1)
    tinf = tfluid.io.get_inference_program(tpred, tprog)
    want = texe.run(tinf, feed=_tfeed(kind, feed), fetch_list=[tpred.name],
                    scope=tscope)[0]

    jscope = jfluid.Scope()
    jexe = jfluid.Executor()
    with jfluid.scope_guard(jscope):
        prog, feed_names, fetch_vars = jfluid.io.load_inference_model(
            str(tmp_path), jexe)
    got = np.asarray(jexe.run(prog, feed=_jfeed(kind, feed),
                              fetch_list=[fetch_vars[0].name],
                              scope=jscope)[0])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)
    eng = JEngine(prog, feed_names, fetch_vars, scope=jscope, max_batch=4,
                  seq_lens={"words": 8} if kind != "mlp" else None)
    served = np.asarray(eng.infer(_jfeed(kind, feed))[0])
    np.testing.assert_allclose(served, want, rtol=RTOL, atol=1e-7)


def test_packed_seq_persistables_and_a_verbatim_params_filename(tmp_path):
    """A PackedSeq persistable goes to disk as name@DATA / name@LEN in
    both packages, a params_filename without an extension is written as
    given, and each package reads the other's file."""
    prog = tfluid.Program()
    block = prog.global_block()
    block.create_var(name="seq_state", shape=[-1, -1, 3], dtype="float32",
                     persistable=True, lod_level=1)
    block.create_var(name="w", shape=[2, 3], dtype="float32",
                     persistable=True)
    rng = np.random.RandomState(0)
    data = rng.rand(2, 4, 3).astype(np.float32)
    lens = np.array([4, 2], np.int32)
    w = rng.rand(2, 3).astype(np.float32)
    scope = tfluid.Scope()
    scope.set_var("seq_state", tfluid.PackedSeq(torch.from_numpy(data),
                                                torch.from_numpy(lens)))
    scope.set_var("w", torch.from_numpy(w))
    exe = tfluid.Executor(CPU)
    with tfluid.scope_guard(scope):
        path = tfluid.io.save_persistables(exe, str(tmp_path), prog,
                                           filename="__params_combined__")
    assert os.path.basename(path) == "__params_combined__"
    assert sorted(os.listdir(tmp_path)) == ["__params_combined__"]
    with np.load(path) as blob:
        assert sorted(blob.files) == ["seq_state@DATA", "seq_state@LEN",
                                      "w"]
    back = tfluid.Scope()
    with tfluid.scope_guard(back):
        tfluid.io.load_persistables(exe, str(tmp_path), prog,
                                    filename="__params_combined__")
    got = back.find_var("seq_state")
    assert isinstance(got, tfluid.PackedSeq)
    assert np.array_equal(got.data.numpy(), data)
    assert np.array_equal(got.lengths.numpy(), lens)
    assert np.array_equal(back.find_var("w").numpy(), w)
    # the JAX package reads the port's file
    jprog = jfluid.Program()
    jb = jprog.global_block()
    jb.create_var(name="seq_state", shape=[-1, -1, 3], dtype="float32",
                  persistable=True, lod_level=1)
    jb.create_var(name="w", shape=[2, 3], dtype="float32",
                  persistable=True)
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jfluid.io.load_persistables(jfluid.Executor(), str(tmp_path), jprog,
                                    filename="__params_combined__")
        jfluid.io.save_persistables(jfluid.Executor(),
                                    str(tmp_path / "j"), jprog,
                                    filename="params")
    js = jscope.find_var("seq_state")
    assert np.array_equal(np.asarray(js.data), data)
    assert np.array_equal(np.asarray(js.lengths), lens)
    # and the port reads the JAX package's
    again = tfluid.Scope()
    with tfluid.scope_guard(again):
        tfluid.io.load_persistables(exe, str(tmp_path / "j"), prog,
                                    filename="params")
    assert np.array_equal(again.find_var("seq_state").data.numpy(), data)
    assert np.array_equal(again.find_var("w").numpy(), w)


def test_a_narrowed_int64_loads_as_int64_and_parameter_values(tmp_path):
    """The JAX package holds a declared int64 as int32 (64-bit types
    off) and saves it so; the port loads it as the declared int64."""
    prog = tfluid.Program()
    prog.global_block().create_var(name="step", shape=[1], dtype="int64",
                                   persistable=True)
    with open(tmp_path / "__params__.npz", "wb") as f:
        np.savez(f, step=np.array([7], np.int32))
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        tfluid.io.load_persistables(tfluid.Executor(CPU), str(tmp_path),
                                    prog)
        t = scope.find_var("step")
        assert t.dtype == torch.int64 and t.tolist() == [7]
        assert tfluid.io.get_parameter_value_by_name("step").dtype == \
            np.int64
        var = prog.global_block().var("step")
        assert tfluid.io.get_parameter_value(var).tolist() == [7]


def test_load_places_tensors_on_the_executors_device(tmp_path):
    _, tbuild, feeds = MODELS["mlp"]
    tprog, tstart, tpred = tbuild()
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    exe.run(tstart, scope=scope)
    with tfluid.scope_guard(scope):
        tfluid.io.save_params(exe, str(tmp_path), tprog)
    back = tfluid.Scope()
    with tfluid.scope_guard(back):
        tfluid.io.load_params(exe, str(tmp_path), tprog)
    params = [p.name for p in tprog.global_block().all_parameters()]
    assert params and sorted(back.vars) == sorted(params)
    for n in params:
        v = back.find_var(n)
        assert v.device == exe.device
        assert torch.equal(v, scope.find_var(n))
