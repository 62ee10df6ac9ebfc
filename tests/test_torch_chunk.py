"""K steps a call on the CPU: the port's ``DataFeeder.feed_chunk`` /
``stack_feeds`` against the JAX package's, and ``Executor.run_chunk``
against K of its own ``run()`` calls and against the JAX package's
``run_chunk``.

The contract, as ``tests/test_chunked_exec.py`` holds the JAX package
to it: a K-step chunk is exactly K sequential ``run()`` calls — the same
losses and parameters, bitwise, and the same random draws across chunk
boundaries (step ``base + i`` draws from ``step_key(seed, base + i)``).
On the CPU the port runs the K steps eagerly; on the card they are
replays of a CUDA graph (``tests/test_torch_graphs_cuda.py``).

Against the JAX package (a program without randomness, from the JAX
startup's weights carried over by ``interop.load_reference_state``):
losses within rtol 1e-5 and the Adam moments (sums of gradients and
their squares) within rtol 1e-4, atol 1e-6, the tolerances of the
matching ``run()`` parity test (``tests/test_torch_train.py``: losses
and gradients; fp32 math in another summation order). The parameters
are held within rtol 1e-4 and atol 1e-4, a tenth of one Adam step at lr
1e-3: where a gradient is near zero in both packages its sign is
rounding noise, and Adam's normalised step follows the sign."""

import os

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import unique_name as jnames
from paddle_tpu.data_feeder import DataFeeder as JFeeder
from paddle_tpu.data_feeder import stack_feeds as jstack
from paddle_tpu.models import lenet as jlenet
from paddle_tpu_torch import interop, layers
from paddle_tpu_torch import unique_name as tnames
from paddle_tpu_torch.data_feeder import DataFeeder as TFeeder
from paddle_tpu_torch.data_feeder import stack_feeds as tstack
from paddle_tpu_torch.models import lenet as tlenet
from paddle_tpu_torch.models import stacked_lstm as tlstm

# Under pytest-xdist each worker takes its share of the cores for
# torch's intra-op threads: six workers at torch's default thread count
# oversubscribe the cores, and a test of seconds then takes minutes.
_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, os.cpu_count() // int(_WORKERS)))

CPU = tfluid.CPUPlace()


# ---- DataFeeder / stack_feeds against the JAX package ----

def _same_feed(a, b):
    assert sorted(a) == sorted(b)
    for n in a:
        x, y = a[n], b[n]
        if isinstance(x, jfluid.PackedSeq):
            assert isinstance(y, tfluid.PackedSeq), n
            for p, q in ((x.data, y.data), (x.lengths, y.lengths)):
                p, q = np.asarray(p), np.asarray(q)
                assert p.dtype == q.dtype and p.shape == q.shape, n
                np.testing.assert_array_equal(q, p)
        else:
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape, n
            np.testing.assert_array_equal(y, x)


def _feed_vars(fluid, names):
    """A program declaring a dense image, a label and an id sequence."""
    prog, startup = fluid.Program(), fluid.Program()
    with names.guard(), fluid.program_guard(prog, startup):
        fluid.layers.data("img", [1, 4, 4])
        fluid.layers.data("label", [1], dtype="int64")
        fluid.layers.data("words", [1], dtype="int64", lod_level=1)
    return prog


def _rows(rng, batch, lens):
    return [(rng.rand(16).astype(np.float32), int(rng.randint(0, 5)),
             rng.randint(0, 50, (int(n), 1)).tolist())
            for n in lens[:batch]]


@pytest.mark.parametrize("pad_multiple", [1, 8])
def test_feed_chunk_equals_jax(pad_multiple):
    """Flat rows reshaped to the declared [1, 4, 4], scalar labels to
    [1], ragged sequences padded to the chunk's common longest (rounded
    up to ``pad_multiple``) with their lengths kept."""
    rng = np.random.RandomState(0)
    batches = [_rows(rng, 3, lens) for lens in ([2, 5, 1], [9, 3, 4],
                                                 [1, 1, 1])]
    feeders = [F(["img", "label", "words"], program=_feed_vars(fl, nm),
                 pad_multiple=pad_multiple)
               for F, fl, nm in ((JFeeder, jfluid, jnames),
                                 (TFeeder, tfluid, tnames))]
    j, t = (f.feed_chunk(batches) for f in feeders)
    _same_feed(j, t)
    assert t["img"].shape == (3, 3, 1, 4, 4)
    assert t["words"].data.shape[:2] == (3, 3)
    np.testing.assert_array_equal(t["words"].lengths,
                                  [[2, 5, 1], [9, 3, 4], [1, 1, 1]])
    for b, rows in enumerate(batches):
        _same_feed(feeders[0].feed(rows), feeders[1].feed(rows))


def test_stack_feeds_pads_packed_to_the_common_longest():
    rng = np.random.RandomState(1)
    feeds = []
    for t in (4, 7, 2):
        data = rng.randn(3, t, 5).astype(np.float32)
        lengths = rng.randint(1, t + 1, (3,)).astype(np.int32)
        dense = rng.randint(0, 9, (3, 1)).astype(np.int64)
        feeds.append(({"x": jfluid.PackedSeq(data, lengths), "y": dense},
                      {"x": tfluid.PackedSeq(data, lengths), "y": dense}))
    j = jstack([f[0] for f in feeds])
    t = tstack([f[1] for f in feeds])
    _same_feed(j, t)
    assert t["x"].data.shape == (3, 3, 7, 5)
    assert not t["x"].data[2, :, 2:].any()      # the pad is zeros


def test_stack_feeds_rejects_disagreeing_keys():
    for stack in (jstack, tstack):
        with pytest.raises(ValueError, match="disagree on keys"):
            stack([{"a": np.zeros(2)}, {"b": np.zeros(2)}])
        with pytest.raises(ValueError, match="at least one"):
            stack([])


def test_feed_chunk_rejects_ragged_batch_sizes():
    rng = np.random.RandomState(2)
    batches = [_rows(rng, 3, [2, 2, 2]), _rows(rng, 2, [2, 2])]
    for F, fl, nm in ((JFeeder, jfluid, jnames), (TFeeder, tfluid, tnames)):
        feeder = F(["img", "label", "words"], program=_feed_vars(fl, nm))
        with pytest.raises(ValueError, match="one batch size"):
            feeder.feed_chunk(batches)


# ---- run_chunk against K run() calls (bitwise) ----

def _snapshot(scope):
    return {n: v.clone() for n, v in scope.vars.items()
            if isinstance(v, torch.Tensor)}


def _restore(scope, snap):
    for n, v in snap.items():
        scope.set_var(n, v.clone())


def _conv_model():
    """The JAX test's small conv net: dropout (a random draw each step)
    and Adam (several state tensors a parameter)."""
    prog, startup = tfluid.Program(), tfluid.Program()
    with tnames.guard(), tfluid.program_guard(prog, startup):
        img = layers.data("img", [1, 8, 8])
        label = layers.data("label", [1], dtype="int64")
        c = layers.conv2d(img, 4, 3, padding=1, act="relu")
        p = layers.pool2d(c, pool_size=2, pool_stride=2)
        h = layers.dropout(layers.fc(p, 16, act="relu"), dropout_prob=0.3)
        predict = layers.fc(h, 4, act="softmax")
        loss = layers.mean(layers.cross_entropy(predict, label))
        tfluid.optimizer.Adam(1e-2).minimize(loss)
    return prog, startup, loss


def _conv_feeds(n, batch=4):
    rng = np.random.RandomState(0)
    return [{"img": rng.rand(batch, 1, 8, 8).astype(np.float32),
             "label": rng.randint(0, 4, (batch, 1)).astype(np.int64)}
            for _ in range(n)]


def _mlp_model():
    with tnames.guard():
        prog, startup, _, (loss, _) = tlenet.build_mnist_train(
            model="mlp", lr=1e-3)
    return prog, startup, loss


def _mlp_feeds(n, batch=8):
    rng = np.random.RandomState(3)
    return [{"img": rng.rand(batch, 784).astype(np.float32),
             "label": rng.randint(0, 10, (batch, 1)).astype(np.int64)}
            for _ in range(n)]


def _lstm_model():
    with tnames.guard():
        prog, startup, _, (loss, _) = tlstm.build_stacked_lstm_train(
            dict_dim=100, emb_dim=16, hid_dim=16, stacked_num=2)
    return prog, startup, loss


def _lstm_feeds(n, batch=4, maxt=6):
    """Ragged id sequences, already packed (a chunk pads every step to
    its common longest; K run() calls are fed the same padded steps)."""
    rng = np.random.RandomState(5)
    feeds = []
    for _ in range(n):
        lengths = rng.randint(1, maxt + 1, (batch,)).astype(np.int32)
        data = np.zeros((batch, maxt, 1), np.int64)
        for b, m in enumerate(lengths):
            data[b, :m] = rng.randint(1, 100, (m, 1))
        feeds.append({"words": tfluid.PackedSeq(data, lengths),
                      "label": rng.randint(0, 2, (batch, 1)).astype(
                          np.int64)})
    return feeds


MODELS = {"conv_dropout": (_conv_model, _conv_feeds),
          "mnist_mlp": (_mlp_model, _mlp_feeds),
          "stacked_lstm": (_lstm_model, _lstm_feeds)}


def _sequential(prog, startup, loss, feeds):
    exe = tfluid.Executor(CPU)
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    init = _snapshot(scope)
    losses = [exe.run(prog, feed=f, fetch_list=[loss], scope=scope)[0]
              for f in feeds]
    return scope, init, losses, _snapshot(scope)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_run_chunk_equals_k_run_calls_bitwise(model):
    """Two chunks of 3 steps against 6 run() calls: per-step losses and
    every final state tensor bitwise equal. The sequential executor ran
    startup first (step 0), so its train steps were 1..6: the chunk
    pins step0=1 and its counter carries across the chunk boundary."""
    build, make_feeds = MODELS[model]
    prog, startup, loss = build()
    k, chunks = 3, 2
    feeds = make_feeds(k * chunks)
    scope, init, seq_losses, seq_state = _sequential(prog, startup, loss,
                                                     feeds)
    _restore(scope, init)
    exe = tfluid.Executor(CPU)
    got = list(exe.run_chunk(prog, feed_chunk=tstack(feeds[:k]), k=k,
                             fetch_list=[loss], scope=scope, step0=1)[0])
    assert exe._step == 1 + k
    got += list(exe.run_chunk(prog, feed_chunk=tstack(feeds[k:]),
                              fetch_list=[loss], scope=scope)[0])
    assert exe._step == 1 + k * chunks
    assert len(got) == len(seq_losses)
    for i, (a, b) in enumerate(zip(seq_losses, got)):
        assert np.array_equal(a, b), "loss diverged at step %d" % i
    state = _snapshot(scope)
    assert set(state) == set(seq_state)
    for n in seq_state:
        assert torch.equal(state[n], seq_state[n]), n


def test_rng_keys_identical_across_chunk_boundary():
    """Two k=2 chunks draw the same dropout masks as one k=4 chunk: the
    key is a function of the logical step only."""
    prog, startup, loss = _conv_model()
    feeds = _conv_feeds(4)
    exe = tfluid.Executor(CPU)
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    init = _snapshot(scope)
    a = list(exe.run_chunk(prog, feed_chunk=tstack(feeds), fetch_list=[loss],
                           scope=scope, step0=1)[0])
    _restore(scope, init)
    exe2 = tfluid.Executor(CPU)
    b = list(exe2.run_chunk(prog, feed_chunk=tstack(feeds[:2]),
                            fetch_list=[loss], scope=scope, step0=1)[0])
    b += list(exe2.run_chunk(prog, feed_chunk=tstack(feeds[2:]),
                             fetch_list=[loss], scope=scope)[0])
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    # another step0 draws other masks
    _restore(scope, init)
    c = list(tfluid.Executor(CPU).run_chunk(
        prog, feed_chunk=tstack(feeds), fetch_list=[loss], scope=scope,
        step0=7)[0])
    assert not np.array_equal(a[0], c[0])


def test_step0_pins_the_base_and_steps_advance_by_k():
    """run_chunk(step0=s) runs steps s..s+k-1, as run() calls at those
    steps do (the dropout masks show it); the counter then continues."""
    prog, startup, loss = _conv_model()
    feeds = _conv_feeds(3)
    exe = tfluid.Executor(CPU)
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    init = _snapshot(scope)
    exe._step = 5
    want = [exe.run(prog, feed=f, fetch_list=[loss], scope=scope)[0]
            for f in feeds]
    assert exe._step == 8
    _restore(scope, init)
    exe2 = tfluid.Executor(CPU)
    got = exe2.run_chunk(prog, feed_chunk=tstack(feeds), fetch_list=[loss],
                         scope=scope, step0=5)[0]
    assert exe2._step == 8
    np.testing.assert_array_equal(got, np.stack(want))


def test_fetches_stack_over_k_and_stay_tensors_on_request():
    prog, startup, loss = _mlp_model()
    feeds = _mlp_feeds(4)
    exe = tfluid.Executor(CPU)
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    out = exe.run_chunk(prog, feed_chunk=tstack(feeds), fetch_list=[loss],
                        scope=scope, return_numpy=False)
    assert isinstance(out[0], torch.Tensor) and out[0].shape == (4,)
    out = exe.run_chunk(prog, feed_chunk=tstack(feeds), fetch_list=[loss],
                        scope=scope)
    assert isinstance(out[0], np.ndarray) and out[0].shape == (4,)


def test_chunk_k_errors():
    """The errors of the JAX package's ``_chunk_k``."""
    prog, startup, loss = _mlp_model()
    exe = tfluid.Executor(CPU)
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    chunk = tstack(_mlp_feeds(2))
    bad = dict(chunk, label=chunk["label"][:1])
    with pytest.raises(ValueError, match="leading dim"):
        exe.run_chunk(prog, feed_chunk=bad, k=2, fetch_list=[loss],
                      scope=scope)
    with pytest.raises(ValueError, match="leading dim"):
        exe.run_chunk(prog, feed_chunk=chunk, k=3, fetch_list=[loss],
                      scope=scope)
    with pytest.raises(ValueError, match="scalar"):
        exe.run_chunk(prog, feed_chunk=dict(chunk, img=np.float32(1.0)),
                      fetch_list=[loss], scope=scope)
    with pytest.raises(ValueError, match="needs k="):
        exe.run_chunk(startup, feed_chunk={}, scope=scope)
    with pytest.raises(ValueError, match="k must be >= 1"):
        exe.run_chunk(startup, feed_chunk={}, k=0, scope=scope)


# ---- run_chunk against the JAX package's ----

def test_run_chunk_matches_jax_run_chunk():
    """The MNIST MLP (no randomness), 2 chunks of 3 Adam steps from the
    JAX startup's weights: losses rtol 1e-5, Adam moments rtol 1e-4 atol
    1e-6, parameters rtol 1e-4 atol 1e-4 (module docstring)."""
    with jnames.guard():
        jprog, jstart, _, (jloss, _) = jlenet.build_mnist_train(
            model="mlp", lr=1e-3)
    tprog, _, tloss = _mlp_model()
    jscope = jfluid.Scope()
    jexe = jfluid.Executor()
    jexe.run(jstart, scope=jscope)
    arrays = {v.name: np.asarray(jscope.find_var(v.name))
              for v in jprog.list_vars() if v.persistable}
    tscope = tfluid.Scope()
    interop.load_reference_state(arrays, tscope, CPU, [tprog])
    texe = tfluid.Executor(CPU)
    feeds = _mlp_feeds(6)
    jl, tl = [], []
    for c in range(2):
        chunk = feeds[3 * c:3 * c + 3]
        jl += list(np.asarray(jexe.run_chunk(
            jprog, feed_chunk=jstack(chunk), fetch_list=[jloss.name],
            scope=jscope)[0]))
        tl += list(texe.run_chunk(tprog, feed_chunk=tstack(chunk),
                                  fetch_list=[tloss], scope=tscope)[0])
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    params = {p.name for p in tprog.global_block().all_parameters()}
    for n in arrays:
        np.testing.assert_allclose(
            tscope.find_var(n).numpy(), np.asarray(jscope.find_var(n)),
            rtol=1e-4, atol=1e-4 if n in params else 1e-6, err_msg=n)
