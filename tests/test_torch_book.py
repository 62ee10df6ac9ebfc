"""The book's linear regression (fit_a_line), movielens recommender and
word2vec n-gram model (dense and row-sparse table gradients) in the
port against the JAX package, at ``tests/test_book.py``'s sizes, on the
CPU:

* both packages build byte-identical program JSON;
* from the JAX startup's weights (``interop.load_reference_state``), 5
  SGD steps give the same losses within rtol 1e-5, the same first-step
  gradients within rtol 1e-5 plus 1e-6 of their largest magnitude, and
  the same parameters after the 5 steps within rtol 1e-5 plus 1e-5 of
  each parameter's largest magnitude (an entry near zero moves by
  lr x its gradient at every step, and each package sums in its own
  order);
* ``save_inference_model`` and ``load_inference_model`` give back the
  predictor, in the training scope and in a clean one, as
  ``tests/test_book.py`` checks it;
* ``Executor.run_chunk`` over K steps equals K ``run()`` calls bit for
  bit (losses and every scope tensor)."""

import json
import os
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import layers as jlayers
from paddle_tpu import nets as jnets
from paddle_tpu import unique_name as jnames
from paddle_tpu_torch import interop
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import nets as tnets
from paddle_tpu_torch import unique_name as tnames
from paddle_tpu_torch.core.executor import _pack_ragged
from paddle_tpu_torch.data_feeder import stack_feeds

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, os.cpu_count() // int(_WORKERS)))

CPU = tfluid.CPUPlace()
STEPS = 5


def fit_a_line(fluid, layers, nets):
    """tests/test_book.py:166-174: fc over uci_housing's 13 features,
    square error, SGD 0.01."""
    x = layers.data("x", [13])
    y = layers.data("y", [1])
    pred = layers.fc(x, 1)
    loss = layers.mean(layers.square_error_cost(pred, y))
    fluid.optimizer.SGD(0.01).minimize(loss)
    return loss, pred, ["x"]


def recommender(fluid, layers, nets):
    """tests/test_book.py:236-262: user tower (id, gender, age
    embeddings), movie tower (id embedding and the title's
    sequence_conv_pool), cos_sim scaled to the rating range, square
    error, SGD 0.1."""
    uid = layers.data("uid", [1], dtype="int64")
    gender = layers.data("gender", [1], dtype="int64")
    age = layers.data("age", [1], dtype="int64")
    u = layers.concat([
        layers.embedding(uid, size=[50, 8]),
        layers.embedding(gender, size=[2, 4]),
        layers.embedding(age, size=[7, 4])], axis=1)
    usr = layers.fc(u, 16, act="tanh")
    mid = layers.data("mid", [1], dtype="int64")
    title = layers.data("title", [1], dtype="int64", lod_level=1)
    temb = layers.embedding(title, size=[80, 8])
    tfeat = nets.sequence_conv_pool(temb, num_filters=16, filter_size=3,
                                    act="tanh", pool_type="sum")
    m = layers.concat([layers.embedding(mid, size=[60, 8]), tfeat], axis=1)
    mov = layers.fc(m, 16, act="tanh")
    sim = layers.scale(layers.cos_sim(usr, mov), scale=5.0)
    rating = layers.data("rating", [1])
    loss = layers.mean(layers.square_error_cost(sim, rating))
    fluid.optimizer.SGD(0.1).minimize(loss)
    return loss, sim, ["uid", "gender", "age", "mid", "title"]


def _feed(which, seed):
    rng = np.random.RandomState(seed)
    if which.startswith("word2vec"):
        return chip_smoke.w2v_feed(rng, 8, 100)
    if which == "fit_a_line":
        xv = rng.rand(16, 13).astype(np.float32)
        return {"x": xv, "y": (xv @ rng.rand(13, 1)).astype(np.float32)}
    b = 6
    return {
        "uid": rng.randint(0, 50, (b, 1)).astype(np.int64),
        "gender": rng.randint(0, 2, (b, 1)).astype(np.int64),
        "age": rng.randint(0, 7, (b, 1)).astype(np.int64),
        "mid": rng.randint(0, 60, (b, 1)).astype(np.int64),
        "title": [rng.randint(0, 80, (int(n),)).astype(np.int64)
                  for n in rng.randint(2, 6, (b,))],
        "rating": rng.randint(1, 6, (b, 1)).astype(np.float32),
    }


def word2vec(fluid, layers, nets, is_sparse=False):
    """tests/test_book.py:198-233: four context words through ONE shared
    embedding table, concat, a sigmoid hidden layer, a softmax over the
    dictionary, cross entropy, SGD 0.05; dense or row-sparse table
    gradients. ``chip_smoke.w2v_body``, which the card runs at the book's
    width, at the JAX test's (dictionary 100, embedding 16, hidden 32)."""
    predict, loss = chip_smoke.w2v_body(fluid, 100, 16, 32, is_sparse)
    return loss, predict, ["w%d" % i for i in range(4)]


def word2vec_sparse(fluid, layers, nets):
    return word2vec(fluid, layers, nets, is_sparse=True)


BOOKS = {"fit_a_line": fit_a_line, "recommender": recommender,
         "word2vec": word2vec, "word2vec_sparse": word2vec_sparse}


def _build(fluid, which):
    layers, names, nets = ((jlayers, jnames, jnets) if fluid is jfluid
                           else (tlayers, tnames, tnets))
    with names.guard():
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            loss, pred, feeds = BOOKS[which](fluid, layers, nets)
    return prog, startup, loss, pred, feeds


def _dump(prog):
    return json.dumps(prog.to_dict(), sort_keys=True, indent=1)


def _close(got, want, what, amax=1e-6):
    got, want = (v.item() if isinstance(v, np.ndarray) and v.dtype == object
                 else v for v in (got, want))
    if hasattr(want, "rows"):       # a row-sparse gradient: same rows
        np.testing.assert_array_equal(np.asarray(got.rows),
                                      np.asarray(want.rows), err_msg=what)
        got, want = got.values, want.values
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=amax * float(np.abs(want).max()),
                               err_msg=what)


def _state(scope):
    return {n: t.clone() for n, t in scope.vars.items()
            if isinstance(t, torch.Tensor)}


@pytest.mark.parametrize("which", sorted(BOOKS))
def test_book_program_json_is_the_jax_packages(which):
    j, t = _build(jfluid, which), _build(tfluid, which)
    assert _dump(t[0]) == _dump(j[0])
    assert _dump(t[1]) == _dump(j[1])
    assert _dump(t[0].clone(for_test=True)) == \
        _dump(j[0].clone(for_test=True))


@pytest.mark.parametrize("which", sorted(BOOKS))
def test_book_sgd_steps_match_the_jax_package(which):
    jp, js, jloss, _, _ = _build(jfluid, which)
    tp, ts, tloss, _, _ = _build(tfluid, which)
    jscope = jfluid.Scope()
    jexe = jfluid.Executor()
    jexe.run(js, scope=jscope)
    params = [p.name for p in jp.global_block().all_parameters()]
    arrays = {v.name: np.asarray(jscope.find_var(v.name))
              for v in jp.list_vars() if v.persistable}
    tscope = tfluid.Scope()
    interop.load_reference_state(arrays, tscope, CPU, [tp, ts])
    texe = tfluid.Executor(CPU)
    feed = _feed(which, 7)
    jl, tl = [], []
    for step in range(STEPS):
        grads = [p + "@GRAD" for p in params] if step == 0 else []
        j = jexe.run(jp, feed=feed, fetch_list=[jloss.name] + grads,
                     scope=jscope)
        t = texe.run(tp, feed=feed, fetch_list=[tloss.name] + grads,
                     scope=tscope)
        jl.append(float(np.asarray(j[0])))
        tl.append(float(np.asarray(t[0])))
        for g, a, b in zip(grads, j[1:], t[1:]):
            _close(b, a, g)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert np.isfinite(tl).all() and tl[-1] < tl[0], tl
    for p in params:
        _close(tscope.find_var(p).numpy(), np.asarray(jscope.find_var(p)), p,
               amax=1e-5)


@pytest.mark.parametrize("which", sorted(BOOKS))
def test_book_inference_model_round_trip(which, tmp_path):
    prog, startup, loss, pred, feeds = _build(tfluid, which)
    feed = _feed(which, 8)
    with tfluid.scope_guard(tfluid.Scope()):
        exe = tfluid.Executor(CPU)
        exe.run(startup)
        for _ in range(3):
            exe.run(prog, feed=feed, fetch_list=[loss])
        d = str(tmp_path / "model")
        tfluid.io.save_inference_model(d, feeds, [pred], exe,
                                       main_program=prog)
        ref = np.asarray(exe.run(prog, feed=feed, fetch_list=[pred.name])[0])
        p1, names, fetch_vars = tfluid.io.load_inference_model(d, exe)
        again = np.asarray(exe.run(p1, feed={n: feed[n] for n in names},
                                   fetch_list=fetch_vars)[0])
        with tfluid.scope_guard(tfluid.Scope()):
            p2, names, fetch_vars = tfluid.io.load_inference_model(d, exe)
            out = np.asarray(exe.run(p2, feed={n: feed[n] for n in names},
                                     fetch_list=fetch_vars)[0])
    assert sorted(names) == sorted(feeds)
    np.testing.assert_array_equal(again, ref)
    np.testing.assert_array_equal(out, ref)


def _packed(feed):
    return {n: _pack_ragged(v, "int64") if isinstance(v, list) else v
            for n, v in feed.items()}


@pytest.mark.parametrize("which", sorted(BOOKS))
def test_book_run_chunk_equals_run_bitwise(which):
    prog, startup, loss, _, _ = _build(tfluid, which)
    s0 = tfluid.Scope()
    tfluid.Executor(CPU).run(startup, scope=s0)
    feeds = [_packed(_feed(which, 20 + i)) for i in range(4)]
    scopes = []
    for _ in range(2):
        s = tfluid.Scope()
        for n, v in _state(s0).items():
            s.set_var(n, v)
        scopes.append(s)
    a = tfluid.Executor(CPU)
    one = [a.run(prog, feed=f, fetch_list=[loss], scope=scopes[0])[0]
           for f in feeds]
    chunk = tfluid.Executor(CPU).run_chunk(
        prog, feed_chunk=stack_feeds(feeds), fetch_list=[loss],
        scope=scopes[1])[0]
    np.testing.assert_array_equal(chunk, np.stack(one))
    for n in scopes[0].vars:
        assert torch.equal(scopes[0].find_var(n), scopes[1].find_var(n)), n
