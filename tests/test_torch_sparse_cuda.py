"""Row-sparse updates and the beam-search decode on the card.

The sparse ``sgd``, lazy ``adam`` and ``adagrad`` updates give the same
bits from run to run however many duplicate rows a gradient carries
(their scatters sort the rows: ``index_put(..., accumulate=True)``), and
agree with the CPU at rtol 1e-5; a sparse training step replayed from a
CUDA graph is bitwise the eager step; the seq2seq beam decode launches
the GRU forward kernel (B5) twice a call, once for each encoder
direction, and decodes what the CPU decodes (ids and lengths equal,
scores at rtol 1e-4: float32 products in another order over the steps);
the tie order of the top-K is the CPU's.

Marked ``cuda``: each test skips inside itself where torch finds no
card. This file imports torch and the port only (the machine with the
card has no jax), so run it there without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_sparse_cuda.py
"""

import types

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers, unique_name
from paddle_tpu_torch.core import registry
from paddle_tpu_torch.core.lower import RowSparse, TraceContext
from paddle_tpu_torch.data_feeder import stack_feeds
from paddle_tpu_torch.kernels import gru_cell
from paddle_tpu_torch.models.seq2seq import build_seq2seq
from paddle_tpu_torch.ops.beam_search_ops import top_k_lower_index_first


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _update(op_type, dev, seed=0):
    """One sparse update of a [1000, 64] table by 4096 rows drawn from
    32 ids (every row duplicated ~128 times)."""
    g = torch.Generator().manual_seed(seed)
    V, D, K = 1000, 64, 4096
    p = torch.randn(V, D, generator=g)
    ins = {"Param": [p], "LearningRate": [torch.full((1,), 0.1)],
           "Grad": [RowSparse(torch.randint(0, 32, (K,), generator=g,
                                            dtype=torch.int32),
                              torch.randn(K, D, generator=g), V)]}
    if op_type == "adam":
        ins.update(Moment1=[torch.zeros(V, D)], Moment2=[torch.zeros(V, D)],
                   Beta1Pow=[torch.full((1,), 0.9)],
                   Beta2Pow=[torch.full((1,), 0.999)])
    elif op_type == "adagrad":
        ins.update(Moment=[torch.rand(V, D, generator=g)])
    ins = {k: [RowSparse(v.rows.to(dev), v.values.to(dev), v.height)
               if isinstance(v, RowSparse) else v.to(dev) for v in vs]
           for k, vs in ins.items()}
    op = types.SimpleNamespace(type=op_type, uid=1, attrs={})
    out = registry.get(op_type).lower(TraceContext(device=dev), ins, {}, op)
    return {k: v.cpu() for k, v in out.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("op_type", ["sgd", "adam", "adagrad"])
def test_cuda_sparse_update_is_deterministic_and_matches_cpu(cuda, op_type):
    a, b = _update(op_type, cuda), _update(op_type, cuda)
    cpu = _update(op_type, torch.device("cpu"))
    for k in a:
        assert torch.equal(a[k], b[k]), k
        torch.testing.assert_close(a[k], cpu[k], rtol=1e-5, atol=1e-6)


def _w2v(opt):
    with unique_name.guard():
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            words = [layers.data("w%d" % i, [1], dtype="int64")
                     for i in range(4)]
            embs = [layers.embedding(w, size=[500, 32], is_sparse=True,
                                     param_attr=fluid.ParamAttr(
                                         name="shared"))
                    for w in words]
            hidden = layers.fc(layers.concat(embs, axis=1), 32,
                               act="sigmoid")
            predict = layers.fc(hidden, 500, act="softmax")
            label = layers.data("next", [1], dtype="int64")
            loss = layers.mean(layers.cross_entropy(predict, label))
            opt().minimize(loss)
    return prog, startup, loss


def _feeds(n, seed=0):
    rng = np.random.RandomState(seed)
    return [{**{"w%d" % i: rng.randint(0, 40, (64, 1)).astype(np.int64)
                for i in range(4)},
             "next": rng.randint(0, 500, (64, 1)).astype(np.int64)}
            for _ in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("opt", [lambda: fluid.optimizer.SGD(0.1),
                                 lambda: fluid.optimizer.Adam(1e-3)],
                         ids=["sgd", "adam"])
def test_cuda_sparse_graph_replays_bitwise_against_eager(cuda, opt):
    prog, startup, loss = _w2v(opt)
    feeds = _feeds(8)
    runs = []
    for chunked in (False, True):
        scope = fluid.Scope()
        exe = fluid.Executor()
        startup.random_seed = 3
        exe.run(startup, scope=scope)
        if chunked:
            losses = np.concatenate([exe.run_chunk(
                prog, feed_chunk=stack_feeds(feeds[i:i + 4]),
                fetch_list=[loss], scope=scope)[0].reshape(-1)
                for i in (0, 4)])
        else:
            losses = np.array([exe.run(prog, feed=f, fetch_list=[loss],
                                       scope=scope)[0].reshape(-1)[0]
                               for f in feeds])
        runs.append((losses, {n: v.cpu().clone()
                              for n, v in scope.vars.items()}))
    np.testing.assert_array_equal(runs[1][0], runs[0][0])
    for n, v in runs[0][1].items():
        assert torch.equal(runs[1][1][n], v), n
    assert runs[0][0][-1] < runs[0][0][0]


@pytest.mark.cuda
def test_cuda_beam_decode_launches_b5_twice_and_matches_cpu(cuda):
    kw = dict(src_vocab=60, tgt_vocab=50, emb_dim=16, hidden_dim=32)
    with unique_name.guard():
        _, startup, _, _ = build_seq2seq(**kw)
        dec, _, _, outs = build_seq2seq(mode="decode", beam_size=4,
                                        max_len=8, **kw)
    startup.random_seed = 1
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    feed = {"src_ids": [rng.randint(2, 60, (7, 1)).astype(np.int64)
                        for _ in range(5)]}
    gru_cell.reset_launches()
    got = exe.run(dec, feed=feed, fetch_list=list(outs), scope=scope)
    assert gru_cell.launches == {"gru_fwd": 2, "gru_bwd": 0,
                                 "gru_fwd_bf16": 0, "gru_bwd_bf16": 0}
    cpu_scope = fluid.Scope()
    for n, v in scope.vars.items():
        cpu_scope.set_var(n, v.cpu())
    want = fluid.Executor(fluid.CPUPlace()).run(
        dec, feed=feed, fetch_list=list(outs), scope=cpu_scope)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4)


@pytest.mark.cuda
def test_cuda_top_k_takes_ties_lower_index_first(cuda):
    g = torch.Generator().manual_seed(0)
    x = torch.randint(-2, 2, (64, 4 * 3000), generator=g).float()
    x[:, ::5] = -1e9
    for k in (1, 4):
        cv, ci = top_k_lower_index_first(x.to(cuda), k)
        v, i = top_k_lower_index_first(x, k)
        assert torch.equal(ci.cpu(), i) and torch.equal(cv.cpu(), v)
        # lower index first: the first k maxima of each row in order
        assert torch.equal(i, torch.argsort(-x, dim=1, stable=True)[:, :k])


@pytest.mark.cuda
def test_cuda_beam_decode_reads_nothing_on_the_host(cuda):
    """A decode call over a feed already on the card, its results kept
    there, makes no synchronising call (no ``.item()``, no shape that
    depends on the data): ``torch.cuda.set_sync_debug_mode("error")``
    raises at the first one. So one CUDA graph could hold the call."""
    kw = dict(src_vocab=60, tgt_vocab=50, emb_dim=16, hidden_dim=32)
    with unique_name.guard():
        _, startup, _, _ = build_seq2seq(**kw)
        dec, _, _, outs = build_seq2seq(mode="decode", beam_size=4,
                                        max_len=8, **kw)
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    src = torch.randint(2, 60, (5, 7, 1), device=cuda)
    feed = {"src_ids": fluid.PackedSeq(src, torch.full(
        (5,), 7, dtype=torch.int32, device=cuda))}
    exe.run(dec, feed=feed, fetch_list=list(outs), scope=scope,
            return_numpy=False)                  # the plan, warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ids, scores, lengths = exe.run(dec, feed=feed,
                                       fetch_list=list(outs), scope=scope,
                                       return_numpy=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ids.is_cuda and tuple(ids.shape) == (5, 4, 8)
