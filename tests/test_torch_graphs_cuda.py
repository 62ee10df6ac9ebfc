"""``Executor.run_chunk`` and the decode engine as CUDA graphs on the
card (``core/graphs.py``), held BITWISE against the eager steps they
replace: a replay launches the same kernels on the same shapes as the
eager step it was captured from.

Marked ``cuda``: each test skips inside itself where torch finds no
card. This file imports torch and the port only (the machine with the
card has no jax), so run it there without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_graphs_cuda.py
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers, unique_name
from paddle_tpu_torch.data_feeder import stack_feeds
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import lstm_cell
from paddle_tpu_torch.models.stacked_lstm import build_stacked_lstm_train
from paddle_tpu_torch.models.transformer import (build_transformer_decode,
                                                 transformer_lm)
from paddle_tpu_torch.serving import DecodeEngine, DecodeLoop


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _snapshot(scope):
    return {n: v.clone() for n, v in scope.vars.items()
            if isinstance(v, torch.Tensor)}


def _restore(scope, snap):
    for n, v in snap.items():
        scope.set_var(n, v.clone())


def _conv(dropout=0.0, schedule=False):
    """A small conv net: dropout draws a mask each step, a schedule
    changes the learning rate each step (a step counter in the state)."""
    prog, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(prog, startup):
        img = layers.data("img", [1, 8, 8])
        label = layers.data("label", [1], dtype="int64")
        c = layers.conv2d(img, 4, 3, padding=1, act="relu")
        p = layers.pool2d(c, pool_size=2, pool_stride=2)
        h = layers.fc(p, 16, act="relu")
        if dropout:
            h = layers.dropout(h, dropout_prob=dropout)
        predict = layers.fc(h, 4, act="softmax")
        loss = layers.mean(layers.cross_entropy(predict, label))
        lr = layers.cosine_decay(0.05, 2, 4) if schedule else 1e-2
        fluid.optimizer.Adam(lr).minimize(loss)
    return prog, startup, loss


def _conv_feeds(n, batch=4, seed=0):
    rng = np.random.RandomState(seed)
    return [{"img": rng.rand(batch, 1, 8, 8).astype(np.float32),
             "label": rng.randint(0, 4, (batch, 1)).astype(np.int64)}
            for _ in range(n)]


def _both(cuda, build, feeds, k, step0=1):
    """K run() calls in one scope, run_chunk(k) from the same state in
    another: (losses, state) of each."""
    prog, startup, loss = build
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    init = _snapshot(scope)
    exe._step = step0
    seq = [exe.run(prog, feed=f, fetch_list=[loss], scope=scope)[0]
           for f in feeds]
    seq_state = _snapshot(scope)
    scope2 = fluid.Scope()
    _restore(scope2, init)
    exe2 = fluid.Executor()
    got = []
    for c in range(0, len(feeds), k):
        got += list(exe2.run_chunk(prog, feed_chunk=stack_feeds(
            feeds[c:c + k]), fetch_list=[loss], scope=scope2,
            step0=step0 if c == 0 else None)[0])
    return (seq, seq_state), (got, _snapshot(scope2)), exe2


def _assert_bitwise(a, b):
    (la, sa), (lb, sb) = a, b
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert np.array_equal(x, y), "loss of step %d: %r vs %r" % (i, x, y)
    assert set(sa) == set(sb)
    for n in sa:
        assert torch.equal(sa[n], sb[n]), n


@pytest.mark.cuda
def test_cuda_chunk_bitwise_with_a_schedule_changing_the_rate(cuda):
    """Two chunks of 4 replays against 8 run() calls: the schedule's
    counter and rate advance in the graph, every loss and state tensor
    bitwise equal."""
    seq, chunk, exe = _both(cuda, _conv(schedule=True), _conv_feeds(8), 4)
    _assert_bitwise(seq, chunk)
    plan, = [p for p in exe._plans.values() if p.graphs]
    assert len(plan.graphs) == 1


@pytest.mark.cuda
def test_cuda_chunk_bitwise_with_dropout(cuda):
    """Each replay draws the mask run() draws at that step; two k=2
    chunks draw the masks of one k=4 chunk."""
    build = _conv(dropout=0.3)
    feeds = _conv_feeds(6)
    seq, chunk, _ = _both(cuda, build, feeds, 3)
    _assert_bitwise(seq, chunk)
    seq2, chunk2, _ = _both(cuda, build, feeds[:4], 2)
    _, chunk4, _ = _both(cuda, build, feeds[:4], 4)
    _assert_bitwise(chunk2, chunk4)
    _assert_bitwise(seq2, chunk4)


@pytest.mark.cuda
def test_cuda_guarded_chunk_with_a_poisoned_step_bitwise(cuda):
    """A guarded program (dynamic loss scaling) with guard.nonfinite
    armed at step 3: two chunks of 4 graph replays against 8 run()
    calls, from the same weights with the same rule: every loss, state
    tensor (the guard's scale and counters too) and health row bitwise
    equal; the poisoned step skipped (its state unchanged), the scale
    halved there and grown after every 2 clean steps; the step index reaches
    the graph as a device tensor, so the replay at step 3 is the one
    that skips."""
    from paddle_tpu_torch import fault, guard

    prog, startup, loss = _conv()
    guard.enable(prog, loss, dynamic_loss_scale=True, init_loss_scale=64.0,
                 growth_interval=2, divergence=False)
    feeds = _conv_feeds(8)
    scope = fluid.Scope()
    fluid.Executor().run(startup, scope=scope)
    init = _snapshot(scope)
    runs = []
    for chunked in (False, True):
        fault.clear()
        fault.inject("guard.nonfinite", crash_on_nth=3, times=1)
        sc = fluid.Scope()
        _restore(sc, init)
        exe = fluid.Executor()
        states, rows = [], []
        if chunked:
            losses = []
            for c in (0, 4):
                losses += list(exe.run_chunk(
                    prog, feed_chunk=stack_feeds(feeds[c:c + 4]),
                    fetch_list=[loss], scope=sc,
                    step0=0 if c == 0 else None)[0])
                rows.append(exe.last_health)
        else:
            losses = []
            for f in feeds:
                losses.append(exe.run(prog, feed=f, fetch_list=[loss],
                                      scope=sc)[0])
                states.append(_snapshot(sc))
                rows.append(exe.last_health)
        exe.poll_health()
        runs.append((losses, _snapshot(sc), np.concatenate(rows), states))
    fault.clear()
    (seq, seq_state, seq_rows, states), (got, got_state, got_rows, _) = runs
    _assert_bitwise((seq, seq_state), (got, got_state))
    assert np.array_equal(seq_rows, got_rows, equal_nan=True)
    assert list(got_rows[:, 2]) == [0, 0, 1, 0, 0, 0, 0, 0]
    assert list(got_rows[:, 5]) == [64, 128, 64, 64, 128, 128, 256, 256]
    assert int(got_state["guard@skipped_steps"]) == 1
    for n in states[1]:
        if not n.startswith("guard@"):
            assert torch.equal(states[1][n], states[2][n]), n


@pytest.mark.cuda
def test_cuda_chunk_credits_launches_per_replay(cuda):
    """The stacked LSTM (B3, B4): the capture counts nothing, each
    replay counts the step's launches once, so K steps count K times
    one eager step's."""
    with unique_name.guard():
        prog, startup, _, (loss, _) = build_stacked_lstm_train(
            dict_dim=50, emb_dim=16, hid_dim=32, stacked_num=2)
    rng = np.random.RandomState(1)
    lens = np.array([5, 2, 7, 4], np.int32)
    data = np.zeros((4, 8, 1), np.int64)
    for b, m in enumerate(lens):
        data[b, :m] = rng.randint(1, 50, (m, 1))
    feed = {"words": fluid.PackedSeq(data, lens),
            "label": rng.randint(0, 2, (4, 1)).astype(np.int64)}
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    lstm_cell.reset_launches()
    exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
    one = dict(lstm_cell.launches)
    assert one["lstm_fwd"] > 0 and one["lstm_bwd"] > 0
    for k in (3, 5):                   # capture + 2 replays, then 5
        lstm_cell.reset_launches()
        exe.run_chunk(prog, feed_chunk=stack_feeds([feed] * k),
                      fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
        assert lstm_cell.launches == {n: k * v for n, v in one.items()}


@pytest.mark.cuda
def test_cuda_run_and_run_chunk_interleave(cuda):
    """run_chunk(3), run(), run(), run_chunk(3) against 8 run() calls:
    the run() in between replaces scope tensors, which the next replay
    copies back into the graph's."""
    prog, startup, loss = build = _conv(dropout=0.2, schedule=True)
    feeds = _conv_feeds(8, seed=3)
    (seq, seq_state), _, _ = _both(cuda, build, feeds, 8)
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)     # seeded: the state _both started from
    got = list(exe.run_chunk(prog, feed_chunk=stack_feeds(feeds[:3]),
                             fetch_list=[loss], scope=scope)[0])
    got += [exe.run(prog, feed=f, fetch_list=[loss], scope=scope)[0]
            for f in feeds[3:5]]
    got += list(exe.run_chunk(prog, feed_chunk=stack_feeds(feeds[5:]),
                              fetch_list=[loss], scope=scope)[0])
    _assert_bitwise((seq, seq_state), (got, _snapshot(scope)))


@pytest.mark.cuda
def test_cuda_chunk_updates_the_scope_tensors_in_place(cuda):
    """Unlike the JAX package, which donates the pre-chunk buffers (they
    are dead after the call, tests/test_chunked_exec.py), a tensor taken
    from the scope before a chunk holds the post-chunk value: the graph
    updates the tensors it reads in place."""
    prog, startup, loss = _conv()
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feeds = _conv_feeds(4)
    exe.run_chunk(prog, feed_chunk=stack_feeds(feeds[:2]),
                  fetch_list=[loss], scope=scope)
    pre = scope.find_var("fc_0.w_0")
    before = pre.clone()
    exe.run_chunk(prog, feed_chunk=stack_feeds(feeds[2:]),
                  fetch_list=[loss], scope=scope)
    assert scope.find_var("fc_0.w_0") is pre
    assert not torch.equal(pre, before)


@pytest.mark.cuda
def test_cuda_new_feed_shape_makes_one_new_capture(cuda):
    prog, startup, loss = _conv()
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    graphs = lambda: sum(len(p.graphs) for p in exe._plans.values())
    for batch, want in ((4, 1), (4, 1), (6, 2), (4, 2), (6, 2)):
        exe.run_chunk(prog, feed_chunk=stack_feeds(_conv_feeds(2, batch)),
                      fetch_list=[loss], scope=scope)
        assert graphs() == want, batch
    exe.run_chunk(prog, feed_chunk=stack_feeds(_conv_feeds(2)),
                  fetch_list=[loss, "fc_0.w_0"], scope=scope)
    assert graphs() == 3


# ---- the decode engine ----

VOCAB, D_MODEL, N_LAYERS, N_HEADS, MAX_LEN = 53, 32, 2, 4, 64


def _decode_setup(cuda):
    scope = fluid.Scope()
    with unique_name.guard():
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            tokens = layers.data("tokens", [-1], dtype="int64")
            transformer_lm(tokens, VOCAB, d_model=D_MODEL,
                           num_layers=N_LAYERS, num_heads=N_HEADS,
                           max_len=MAX_LEN)
    fluid.Executor().run(startup, scope=scope)
    pre, dec, meta = build_transformer_decode(
        vocab_size=VOCAB, d_model=D_MODEL, num_layers=N_LAYERS,
        num_heads=N_HEADS, max_len=MAX_LEN)
    return scope, pre, dec, meta


def _engine(setup, graphs=True):
    scope, pre, dec, meta = setup
    eng = DecodeEngine(pre, dec, meta, num_slots=4, prompt_buckets=(8, 16),
                       scope=scope)
    if not graphs:
        eng._graphs = None          # every entry eager, on the card
    eng.warmup()
    return eng


def _serve(eng, prompts, n=12, steps=None):
    """Greedy tokens of ``prompts``; ``steps`` (a list) gets the decode
    steps the loop ran."""
    loop = DecodeLoop(eng, name="graphs-test")
    try:
        gens = [loop.submit(p, max_new_tokens=n) for p in prompts]
        out = [g.result(timeout=120)[0] for g in gens]
    finally:
        assert loop.close(timeout=60)
    if steps is not None:
        steps.append(loop.steps_dispatched())
    return out


PROMPTS = [np.arange(1, 6), np.arange(7, 19) % VOCAB, np.array([3, 9]),
           np.arange(20, 29)]


@pytest.mark.cuda
def test_cuda_decode_graphs_token_identical_and_frozen(cuda):
    setup = _decode_setup(cuda)
    eager = _serve(_engine(setup, graphs=False), PROMPTS)
    eng = _engine(setup)
    assert eng.compile_count() == 3 and len(eng._graphs) == 3
    fa.reset_launches()
    steps = []
    got = _serve(eng, PROMPTS, steps=steps)
    assert got == eager
    assert eng.compile_count() == 3
    # 2 layers: 2 B1 a prefill, 2 B2 a decode step, credited per replay
    assert fa.launches == {"flash_attention": 2 * len(PROMPTS),
                           "flash_attention_bf16": 0,
                           "flash_decode": 2 * steps[0],
                           "flash_decode_bf16": 0}


@pytest.mark.cuda
def test_cuda_decode_cache_binding_and_reset(cuda):
    """Two caches take turns on one engine: each keeps its own values
    (the one that gives the graphs' buffers up gets copies), and a reset
    zeroes in place, so the loop's cache keeps the graphs' buffers."""
    eng = _engine(_decode_setup(cuda))
    a, b = eng.new_cache(), eng.new_cache()
    la = eng.prefill(np.arange(1, 6), 0, a)
    lb = eng.prefill(np.arange(9, 12), 1, b)
    assert all(b.buffers[n] is t for n, t in eng._cache_buffers.items())
    la2 = eng.prefill(np.arange(1, 6), 0, a)
    np.testing.assert_array_equal(la, la2)
    assert all(bool(t[1].any()) for t in b.buffers.values())
    held = dict(a.buffers)
    a.reset()
    assert all(a.buffers[n] is held[n] for n in held)
    assert not any(t.any() for t in a.buffers.values())
    eng._graphs, graphs = None, eng._graphs
    try:
        ref = eng.prefill(np.arange(9, 12), 1, eng.new_cache())
    finally:
        eng._graphs = graphs
    np.testing.assert_array_equal(lb, ref)


@pytest.mark.cuda
def test_cuda_decode_swap_state_under_graphs(cuda):
    """swap_state copies the new weights into the tensors the graphs
    read and returns copies of the old: tokens follow the new weights
    (as an eager engine on them), and swapping back restores them."""
    setup = _decode_setup(cuda)
    scope = setup[0]
    eng = _engine(setup)
    before = _serve(eng, PROMPTS[:2])
    names = eng._state_names
    new = {n: scope.find_var(n) * 1.5 for n in names}
    held = {n: scope.find_var(n) for n in names}
    old = eng.swap_state(new)
    assert all(scope.find_var(n) is held[n] for n in names)
    swapped = _serve(eng, PROMPTS[:2])
    eager = _engine(setup, graphs=False)
    assert swapped == _serve(eager, PROMPTS[:2])
    assert swapped != before
    eng.swap_state(old)
    assert _serve(eng, PROMPTS[:2]) == before


@pytest.mark.cuda
def test_cuda_a_backward_on_autograds_thread_counts_in_the_graph(cuda):
    """Autograd runs a backward on a thread of its own, on its forward's
    stream: B8's launch inside a captured backward goes to the graph's
    tally and is credited once a replay, never counted at the capture."""
    from paddle_tpu_torch.core.graphs import CapturedRun
    from paddle_tpu_torch.kernels import conv1x1_bwd as k1

    g = torch.Generator().manual_seed(3)
    x = torch.randn(8, 64, 14, 14, generator=g).to(cuda).requires_grad_()
    w = (torch.randn(128, 64, 1, 1, generator=g) * 0.125).to(cuda) \
        .requires_grad_()

    def step(rngs=None):
        y = k1.conv1x1(x, w)
        return torch.autograd.grad((y * y).sum(), [x, w])

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        want = step()                          # built, and eager once
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    k1.reset_launches()
    run = CapturedRun(cuda)
    got = run.capture(step, stream)
    torch.cuda.synchronize()
    assert k1.launches["conv1x1_bwd"] == 0
    assert run.delta == [(k1.launches, {"conv1x1_bwd": 1})]
    for i in range(3):
        run.replay()
    torch.cuda.synchronize()
    assert k1.launches["conv1x1_bwd"] == 3
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    run.close()
