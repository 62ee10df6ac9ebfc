"""The one-shot ``ServingEngine`` on the card: one captured CUDA graph per
batch bucket, held BITWISE against the same engine run eagerly on the
card (``engine._capture = False``), under concurrent callers, across a
``swap_state``, in int8, and captured while a ``DecodeLoop`` steps on
another thread.

Marked ``cuda``: each test skips inside itself where torch finds no
card. This file imports torch and the port only (the machine with the
card has no jax), so run it there without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_serving_cuda.py
"""

import threading

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers, unique_name
from paddle_tpu_torch.kernels import lstm_cell
from paddle_tpu_torch.models.lenet import lenet
from paddle_tpu_torch.models.stacked_lstm import stacked_lstm_net
from paddle_tpu_torch.models.transformer import (build_transformer_decode,
                                                 transformer_lm)
from paddle_tpu_torch.serving import (DecodeEngine, DecodeLoop,
                                      DynamicBatcher, ServingEngine)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _lenet(dev, tmp_path):
    """LeNet from startup weights, saved and loaded back."""
    scope = fluid.Scope()
    with unique_name.guard():
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            img = layers.data("img", [1, 28, 28])
            pred = lenet(img)
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(str(tmp_path), ["img"], [pred], exe,
                                      main_program=prog)
    loaded = fluid.Scope()
    with fluid.scope_guard(loaded):
        prog, feeds, fetches = fluid.io.load_inference_model(str(tmp_path),
                                                             exe)
    return prog, feeds, [f.name for f in fetches], loaded


def _engines(prog, feeds, fetches, scope, **kw):
    eager = ServingEngine(prog, feeds, fetches, scope=scope, **kw)
    eager._capture = False
    eager.warmup()
    graphs = ServingEngine(prog, feeds, fetches, scope=scope, **kw)
    graphs.warmup()
    return eager, graphs


def _images(n, seed=0):
    return np.random.RandomState(seed).rand(n, 1, 28, 28).astype(np.float32)


@pytest.mark.cuda
def test_cuda_each_bucket_replay_bitwise_equals_eager(cuda, tmp_path):
    prog, feeds, fetches, scope = _lenet(cuda, tmp_path)
    eager, graphs = _engines(prog, feeds, fetches, scope, max_batch=16)
    assert graphs.compile_count() == len(graphs.buckets) == 5
    assert all(e.run is not None
               for e in graphs._compiled_cache._cache.values())
    assert all(e.run is None for e in eager._compiled_cache._cache.values())
    x = _images(16)
    for n in (1, 2, 3, 4, 7, 8, 13, 16):
        got = graphs.infer({"img": x[:n]})[0]
        assert np.array_equal(got, eager.infer({"img": x[:n]})[0]), n
        assert got.shape == (n, 10) and np.isfinite(got).all()
    assert graphs.compile_count() == 5
    # tensors out: clones, which a later replay of the bucket leaves alone
    a = graphs.infer({"img": x[:4]}, return_numpy=False)[0]
    keep = a.clone()
    graphs.infer({"img": x[4:8]})
    assert a.device.type == "cuda" and torch.equal(a, keep)


@pytest.mark.cuda
def test_cuda_eight_threads_on_one_bucket(cuda, tmp_path):
    prog, feeds, fetches, scope = _lenet(cuda, tmp_path)
    eager, graphs = _engines(prog, feeds, fetches, scope, buckets=(4,))
    x = _images(8 * 20, seed=1)
    want = [eager.infer({"img": x[4 * i:4 * i + 4]})[0] for i in range(40)]
    got = [None] * 40

    def worker(k):
        for i in range(k, 40, 8):
            got[i] = graphs.infer({"img": x[4 * i:4 * i + 4]})[0]

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    for i in range(40):
        assert np.array_equal(got[i], want[i]), i


@pytest.mark.cuda
def test_cuda_swap_state_reaches_the_graphs(cuda, tmp_path):
    prog, feeds, fetches, scope = _lenet(cuda, tmp_path)
    eager, graphs = _engines(prog, feeds, fetches, scope, max_batch=4)
    x = _images(3, seed=2)
    before = graphs.infer({"img": x})[0]
    new = {n: scope.find_var(n) * 0.5 for n in graphs._state_names}
    old = graphs.swap_state(new)
    after = graphs.infer({"img": x})[0]
    # the eager engine reads the same scope tensors, swapped in place
    assert np.array_equal(after, eager.infer({"img": x})[0])
    assert not np.array_equal(after, before)
    graphs.swap_state(old)
    assert np.array_equal(graphs.infer({"img": x})[0], before)


@pytest.mark.cuda
def test_cuda_int8_replays_match_eager(cuda, tmp_path):
    prog, feeds, fetches, scope = _lenet(cuda, tmp_path)
    eager, graphs = _engines(prog, feeds, fetches, scope, max_batch=8,
                             quantize="int8")
    assert sorted(graphs._qstate) == sorted(eager._qstate)
    for n, (q, s) in graphs._qstate.items():
        eq, es = eager._qstate[n]
        assert q.dtype == torch.int8 and torch.equal(q, eq)
        assert torch.equal(s, es)
    x = _images(8, seed=3)
    for n in (1, 5, 8):
        assert np.array_equal(graphs.infer({"img": x[:n]})[0],
                              eager.infer({"img": x[:n]})[0])


def _lstm(dev, dict_dim=200, hid=32):
    scope = fluid.Scope()
    with unique_name.guard():
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            words = layers.data("words", [1], dtype="int64", lod_level=1)
            pred = stacked_lstm_net(words, dict_dim, class_dim=2,
                                    emb_dim=hid, hid_dim=hid, stacked_num=3)
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    infer = fluid.io.get_inference_program([pred], prog)
    return infer, pred.name, scope, exe


def _packed(rng, rows, t, dict_dim):
    lens = rng.randint(2, t + 1, rows).astype(np.int32)
    ids = np.zeros((rows, int(lens.max()), 1), np.int64)
    for i, l in enumerate(lens):
        ids[i, :l, 0] = rng.randint(1, dict_dim, l)
    return fluid.PackedSeq(ids, lens)


@pytest.mark.cuda
def test_cuda_ragged_sequences_through_bucket_graphs(cuda):
    """The stacked LSTM's buckets as graphs: B3 credited once a
    ``dynamic_lstm`` a replay, answers bitwise equal to the eager engine
    and within 1e-5 of the executor on the request's rows."""
    prog, pred, scope, exe = _lstm(cuda)
    n_lstm = sum(op.type == "lstm" for op in prog.global_block().ops)
    assert n_lstm == 3
    eager, graphs = _engines(prog, ["words"], [pred], scope,
                             seq_lens={"words": 20}, max_batch=8)
    rng = np.random.RandomState(0)
    reqs = [_packed(rng, 1 + i % 4, 20, 200) for i in range(12)]
    lstm_cell.reset_launches()
    got = []
    with DynamicBatcher(graphs, max_delay_ms=2) as b:
        for r in reqs:
            got.append(b.submit({"words": r}).result(60)[0])
        batches = b.batches_dispatched()
    assert lstm_cell.launches["lstm_fwd"] == n_lstm * batches
    for r, g in zip(reqs, got):
        assert np.array_equal(g, eager.infer({"words": r})[0])
        want = exe.run(prog, feed={"words": r}, fetch_list=[pred],
                       scope=scope)[0]
        np.testing.assert_allclose(g, want, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_cuda_capture_while_a_decode_loop_steps(cuda, tmp_path):
    """A one-shot engine warms (captures every bucket) on this thread
    while a DecodeLoop replays its graphs on its own: both answer as they
    do alone."""
    vocab, size = 61, dict(d_model=32, num_layers=2, num_heads=4,
                           max_len=64)
    dscope = fluid.Scope()
    with unique_name.guard():
        p, s = fluid.Program(), fluid.Program()
        with fluid.program_guard(p, s):
            transformer_lm(layers.data("tokens", [-1], dtype="int64"),
                           vocab, **size)
    fluid.Executor().run(s, scope=dscope)
    pre, dec, meta = build_transformer_decode(vocab_size=vocab, **size)
    deng = DecodeEngine(pre, dec, meta, num_slots=4, prompt_buckets=(8, 16),
                        scope=dscope)
    deng.warmup()
    prompts = [np.arange(1, 6), np.arange(3, 15) % vocab, np.array([9, 4])]
    with DecodeLoop(deng) as loop:
        alone = [loop.submit(q, max_new_tokens=40).result(120)[0]
                 for q in prompts]
    prog, feeds, fetches, scope = _lenet(cuda, tmp_path)
    eager = ServingEngine(prog, feeds, fetches, scope=scope, max_batch=16)
    eager._capture = False
    eager.warmup()
    with DecodeLoop(deng) as loop:
        gens = [loop.submit(q, max_new_tokens=40) for q in prompts * 4]
        graphs = ServingEngine(prog, feeds, fetches, scope=scope,
                               max_batch=16)
        graphs.warmup()
        outs = [g.result(120)[0] for g in gens]
    assert outs == alone * 4
    x = _images(16, seed=4)
    for n in (1, 3, 16):
        assert np.array_equal(graphs.infer({"img": x[:n]})[0],
                              eager.infer({"img": x[:n]})[0])


@pytest.mark.cuda
def test_cuda_eager_launches_on_another_thread_stay_out_of_a_capture(cuda):
    """A thread launches B3 eagerly, again and again, while this thread
    warms the stacked LSTM's engine (an eager run, then a capture, per
    bucket): each bucket's graph holds only its own 3 B3 launches, and
    the counter holds the warm-up's eager runs and the other thread's
    launches, no more."""
    prog, pred, scope, exe = _lstm(cuda)
    g = torch.Generator().manual_seed(5)
    b, t, h = 4, 10, 32
    xg = torch.randn(b, t, 4 * h, generator=g).to(cuda)
    w = (torch.randn(h, 4 * h, generator=g) * 0.1).to(cuda)
    h0 = torch.zeros(b, h, device=cuda)
    mask = torch.ones(b, t, device=cuda)
    lstm_cell.lstm_sequence(xg, w, h0, h0, mask)     # built before
    stop, calls = threading.Event(), [0]
    side = torch.cuda.Stream()

    def eager():
        with torch.cuda.stream(side):
            while not stop.is_set():
                lstm_cell.lstm_sequence(xg, w, h0, h0, mask)
                calls[0] += 1
        side.synchronize()

    lstm_cell.reset_launches()
    worker = threading.Thread(target=eager)
    worker.start()
    try:
        graphs = ServingEngine(prog, ["words"], [pred], scope=scope,
                               seq_lens={"words": 20}, max_batch=8)
        graphs.warmup()
    finally:
        stop.set()
        worker.join(120)
    entries = list(graphs._compiled_cache._cache.values())
    assert len(entries) == 4 and calls[0] > 0
    for e in entries:
        assert e.run.delta == [(lstm_cell.launches, {"lstm_fwd": 3})]
    assert lstm_cell.launches["lstm_fwd"] == 3 * len(entries) + calls[0]
    rng = np.random.RandomState(1)
    for rows in (1, 3, 8):
        r = _packed(rng, rows, 20, 200)
        want = exe.run(prog, feed={"words": r}, fetch_list=[pred],
                       scope=scope)[0]
        np.testing.assert_allclose(graphs.infer({"words": r})[0], want,
                                   rtol=1e-5, atol=1e-6)
