"""Row-sparse gradients in the port (``RowSparse``, the SelectedRows
redesign) against the JAX package's, on the CPU.

``lookup_table(is_sparse=True)``'s gradient (rows, values, a PackedSeq's
padded steps and ``padding_idx`` masked), ``sum`` and
``global_norm_clip`` over row-sparse inputs, the sparse ``sgd``,
``momentum``, lazy ``adam`` and ``adagrad`` updates, and the guard's
health reduction over a row-sparse gradient, each run in both packages
from the same weights (the JAX startup's scope carried over by
``interop.load_reference_state``) on the same seeded ids.

Tolerances: rtol 1e-5 on losses, gradients and tables (float32 in
another summation order), atol 1e-6 where a table entry can pass near 0
(Adagrad's first steps move every touched entry by ~lr). Row indices
and the guard's skip flags are held exactly; the untouched rows of lazy
Adam and of a skipped step bitwise."""

import json
import os
import types

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import fault as jfault
from paddle_tpu import guard as jguard
from paddle_tpu import layers as jlayers
from paddle_tpu import unique_name as jnames
from paddle_tpu.core import registry as jreg
from paddle_tpu.core.lower import RowSparse as JRowSparse
from paddle_tpu.core.lower import TraceContext as JCtx
from paddle_tpu_torch import fault as tfault
from paddle_tpu_torch import guard as tguard
from paddle_tpu_torch import interop
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import unique_name as tnames
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.lower import RowSparse
from paddle_tpu_torch.core.lower import TraceContext as TCtx
from paddle_tpu_torch.data_feeder import stack_feeds

# Under pytest-xdist each worker takes its share of the cores for
# torch's intra-op threads: six workers at torch's default thread count
# oversubscribe the cores, and a test of seconds then takes minutes.
_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, os.cpu_count() // int(_WORKERS)))

CPU = tfluid.CPUPlace()
V, D = 50, 8
RTOL, ATOL = 1e-5, 1e-6

J = types.SimpleNamespace(name="jax", fluid=jfluid, layers=jlayers,
                          names=jnames, guard=jguard, fault=jfault,
                          exe=lambda: jfluid.Executor())
T = types.SimpleNamespace(name="port", fluid=tfluid, layers=tlayers,
                          names=tnames, guard=tguard, fault=tfault,
                          exe=lambda: tfluid.Executor(CPU))

OPTIMIZERS = {
    "sgd": lambda f: f.optimizer.SGD(0.5),
    "momentum": lambda f: f.optimizer.Momentum(0.5, 0.9),
    "adam": lambda f: f.optimizer.Adam(0.1),
    "adagrad": lambda f: f.optimizer.Adagrad(0.5),
}


@pytest.fixture(autouse=True)
def _clean_faults():
    for P in (J, T):
        P.fault.clear()
    yield
    for P in (J, T):
        P.fault.clear()


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _dump(prog):
    return json.dumps(prog.to_dict(), sort_keys=True, indent=1)


def _w2v(P, is_sparse, opt, only_emb=False):
    """tests/test_sparse.py's model: two lookups of one table, concat,
    fc softmax, cross-entropy. ``only_emb`` trains the table alone."""
    fluid, layers = P.fluid, P.layers
    with P.names.guard():
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            a = layers.data("a", [1], dtype="int64")
            b = layers.data("b", [1], dtype="int64")
            label = layers.data("label", [1], dtype="int64")
            attr = fluid.ParamAttr(name="shared_emb")
            ea = layers.embedding(a, [V, D], is_sparse=is_sparse,
                                  param_attr=attr)
            eb = layers.embedding(b, [V, D], is_sparse=is_sparse,
                                  param_attr=attr)
            h = layers.concat([ea, eb], axis=1)
            pred = layers.fc(h, V, act="softmax",
                             param_attr=fluid.ParamAttr(name="w2v_fc"))
            loss = layers.mean(layers.cross_entropy(pred, label))
            OPTIMIZERS[opt](fluid).minimize(
                loss, parameter_list=["shared_emb"] if only_emb else None)
    return prog, startup, loss


def _pair(build):
    """``build(P)`` in both packages, the port's scope loaded with the
    JAX startup's state: {P.name: (prog, loss, scope)}."""
    out = {}
    jprog, jstart, jloss = build(J)
    tprog, tstart, tloss = build(T)
    assert _dump(tprog) == _dump(jprog)
    jscope = jfluid.Scope()
    J.exe().run(jstart, scope=jscope)
    arrays = {v.name: np.asarray(jscope.find_var(v.name))
              for v in jprog.list_vars() if v.persistable}
    tscope = tfluid.Scope()
    interop.load_reference_state(arrays, tscope, CPU, [tprog, tstart])
    out["jax"] = (jprog, jloss, jscope)
    out["port"] = (tprog, tloss, tscope)
    return out


def _feed(rng, batch=16):
    return {"a": rng.randint(0, V, (batch, 1)).astype(np.int64),
            "b": rng.randint(0, V, (batch, 1)).astype(np.int64),
            "label": rng.randint(0, V, (batch, 1)).astype(np.int64)}


def _state(scope):
    return {n: _np(v).copy() for n, v in scope.vars.items()
            if v is not None and not n.startswith("guard@")}


# ---- RowSparse and the op lowerings ----

def test_row_sparse_basics_match_jax():
    """Duplicate rows sum in ``to_dense``; shape, dtype and ``astype``
    as the JAX package's."""
    rng = np.random.RandomState(0)
    rows = np.array([3, 1, 3, 0, 3], np.int32)
    vals = rng.randn(5, 4).astype(np.float32)
    t = RowSparse(torch.tensor(rows), torch.tensor(vals), 6)
    j = JRowSparse(rows, vals, 6)
    assert t.shape == j.shape == (6, 4)
    assert t.dtype == torch.float32 and t.height == 6
    want = np.zeros((6, 4), np.float32)
    np.add.at(want, rows, vals)
    np.testing.assert_array_equal(t.to_dense().numpy(), want)
    np.testing.assert_allclose(t.to_dense().numpy(), np.asarray(j.to_dense()),
                               rtol=1e-7)
    h = t.astype(torch.bfloat16)
    assert h.dtype == torch.bfloat16 and h.rows is t.rows
    assert "height=6" in repr(t)
    assert tfluid.RowSparse is RowSparse


def _lookup_model(P, lod, pad):
    fluid, layers = P.fluid, P.layers
    with P.names.guard():
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            ids = layers.data("ids", [1], dtype="int64",
                              lod_level=1 if lod else 0)
            label = layers.data("label", [1], dtype="int64")
            emb = layers.embedding(ids, [V, D], is_sparse=True,
                                   padding_idx=pad,
                                   param_attr=fluid.ParamAttr(name="emb"))
            if lod:
                emb = layers.sequence_pool(emb, "sum")
            pred = layers.fc(emb, 3, act="softmax")
            loss = layers.mean(layers.cross_entropy(pred, label))
            fluid.optimizer.SGD(0.1).minimize(loss)
    return prog, startup, loss


@pytest.mark.parametrize("lod,pad", [(False, None), (False, 4), (True, None),
                                     (True, 4)],
                         ids=["dense", "dense-padding_idx", "packed",
                              "packed-padding_idx"])
def test_lookup_table_sparse_grad_matches_jax(lod, pad):
    """rows = the ids in order (a PackedSeq's padded steps included,
    their values 0), values = the output cotangents, the rows of
    ``padding_idx`` 0."""
    pair = _pair(lambda P: _lookup_model(P, lod, pad))
    rng = np.random.RandomState(1)
    if lod:
        ids = [rng.randint(0, 8, (n, 1)).astype(np.int64)
               for n in (3, 1, 5, 2)]
    else:
        ids = rng.randint(0, 8, (6, 1)).astype(np.int64)
    feed = {"ids": ids, "label": rng.randint(0, 3, (4 if lod else 6, 1))
            .astype(np.int64)}
    got = {}
    for P in (J, T):
        prog, loss, scope = pair[P.name]
        exe = P.exe()
        out = exe.run(prog, feed=feed, fetch_list=["emb@GRAD"], scope=scope,
                      return_numpy=False)[0]
        assert type(out).__name__ == "RowSparse"
        got[P.name] = (_np(out.rows), _np(out.values), out.height)
    (jr, jv, jh), (tr, tv, th) = got["jax"], got["port"]
    assert th == jh == V
    assert tr.dtype == np.int32
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=1e-8)
    if pad is not None:
        assert np.all(tv[tr == pad] == 0) and (tr == pad).any()
    if lod:
        assert tr.shape == (4 * 5,)
        mask = np.zeros((4, 5), bool)
        for i, n in enumerate((3, 1, 5, 2)):
            mask[i, :n] = True
        assert np.all(tv[~mask.reshape(-1)] == 0)


def _rs_inputs():
    rng = np.random.RandomState(2)
    a = (np.array([1, 4, 1], np.int32), rng.randn(3, 5).astype(np.float32))
    b = (np.array([4, 0], np.int32), rng.randn(2, 5).astype(np.float32))
    dense = rng.randn(6, 5).astype(np.float32)
    return a, b, dense


def _lower(reg, ctx, op_type, xs, attrs):
    return reg.normalize_outputs(
        reg.get(op_type).lower(ctx, {"X": xs}, attrs, None))["Out"]


def test_sum_over_row_sparse_matches_jax():
    """All row-sparse: the concatenation; mixed: dense."""
    (ra, va), (rb, vb), dense = _rs_inputs()
    for mixed in (False, True):
        jx = [JRowSparse(ra, va, 6), JRowSparse(rb, vb, 6)]
        tx = [RowSparse(torch.tensor(ra), torch.tensor(va), 6),
              RowSparse(torch.tensor(rb), torch.tensor(vb), 6)]
        if mixed:
            jx.append(dense)
            tx.append(torch.tensor(dense))
        j = _lower(jreg, JCtx(), "sum", jx, {})[0]
        t = _lower(treg, TCtx(), "sum", tx, {})[0]
        if mixed:
            assert isinstance(t, torch.Tensor)
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL)
        else:
            assert isinstance(t, RowSparse) and t.height == 6
            np.testing.assert_array_equal(t.rows.numpy(), np.asarray(j.rows))
            np.testing.assert_array_equal(t.values.numpy(),
                                          np.asarray(j.values))


@pytest.mark.parametrize("clip_norm", [0.5, 100.0], ids=["clips", "passes"])
def test_global_norm_clip_over_row_sparse_matches_jax(clip_norm):
    (ra, va), _, dense = _rs_inputs()
    j = _lower(jreg, JCtx(), "global_norm_clip",
               [JRowSparse(ra, va, 6), dense], {"clip_norm": clip_norm})
    t = _lower(treg, TCtx(), "global_norm_clip",
               [RowSparse(torch.tensor(ra), torch.tensor(va), 6),
                torch.tensor(dense)], {"clip_norm": clip_norm})
    assert isinstance(t[0], RowSparse)
    np.testing.assert_array_equal(t[0].rows.numpy(), ra)
    np.testing.assert_allclose(t[0].values.numpy(), np.asarray(j[0].values),
                               rtol=RTOL)
    np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), rtol=RTOL)
    norm = np.sqrt(np.sum(va.astype(np.float64) ** 2)
                   + np.sum(dense.astype(np.float64) ** 2))
    scale = clip_norm / max(norm, clip_norm)
    np.testing.assert_allclose(t[1].numpy(), dense * scale, rtol=1e-5)


# ---- training ----

def _train_both(pair, feeds, fetch=()):
    out = {}
    for P in (J, T):
        prog, loss, scope = pair[P.name]
        exe = P.exe()
        losses = [float(_np(exe.run(prog, feed=f, fetch_list=[loss.name],
                                    scope=scope)[0]).reshape(-1)[0])
                  for f in feeds]
        out[P.name] = (losses, _state(scope))
    return out


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_sparse_optimizers_train_as_jax(opt):
    """tests/test_sparse.py's model, 4 steps of sparse sgd, momentum,
    lazy adam or adagrad: every loss and every state tensor (the table,
    the fc weight, the accumulators) at rtol 1e-5."""
    pair = _pair(lambda P: _w2v(P, True, opt))
    feed = _feed(np.random.RandomState(0))
    res = _train_both(pair, [feed] * 4)
    (jl, js), (tl, ts) = res["jax"], res["port"]
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    assert tl[-1] < tl[0]
    assert set(js) == set(ts)
    for n in js:
        np.testing.assert_allclose(ts[n], js[n], rtol=RTOL, atol=ATOL,
                                   err_msg=n)


@pytest.mark.parametrize("opt", ["sgd", "adagrad"])
def test_sparse_and_dense_updates_agree_in_the_port(opt):
    """SGD and Adagrad touch only the looked-up rows either way: from the
    same weights, sparse and dense training give the same table."""
    res = {}
    for sparse in (False, True):
        pair = _pair(lambda P: _w2v(P, sparse, opt))
        res[sparse] = _train_both(pair, [_feed(np.random.RandomState(0))]
                                  * 3)["port"]
    np.testing.assert_allclose(res[True][0], res[False][0], rtol=RTOL)
    np.testing.assert_allclose(res[True][1]["shared_emb"],
                               res[False][1]["shared_emb"], rtol=RTOL,
                               atol=ATOL)


def test_lazy_adam_leaves_untouched_rows_bitwise():
    """A row no id of the step looks up keeps its parameter and both
    moments bit for bit (the JAX package's lazy mode)."""
    pair = _pair(lambda P: _w2v(P, True, "adam"))
    prog, loss, scope = pair["port"]
    exe = T.exe()
    rng = np.random.RandomState(5)
    for _ in range(3):
        feed = _feed(rng)
        before = _state(scope)
        exe.run(prog, feed=feed, fetch_list=[loss.name], scope=scope)
        after = _state(scope)
        touched = np.unique(np.concatenate([feed["a"].ravel(),
                                            feed["b"].ravel()]))
        untouched = np.setdiff1d(np.arange(V), touched)
        assert untouched.size > 0
        for n in before:
            if before[n].shape[:1] == (V,) and before[n].ndim == 2:
                assert np.array_equal(before[n][untouched],
                                      after[n][untouched]), n
                assert not np.array_equal(before[n][touched],
                                          after[n][touched]), n


@pytest.mark.parametrize("opt", ["adagrad", "adam", "sgd"])
def test_duplicate_ids_accumulate(opt):
    """Every id of the batch is 7: its four occurrences in each lookup
    all contribute (the merged row for adagrad and adam), as in the JAX
    package and as the dense update; row 8 stays as it was."""
    feed = {"a": np.full((4, 1), 7, np.int64), "b": np.full((4, 1), 7,
                                                           np.int64),
            "label": np.zeros((4, 1), np.int64)}
    pair = _pair(lambda P: _w2v(P, True, opt))
    res = _train_both(pair, [feed] * 2)
    np.testing.assert_allclose(res["port"][1]["shared_emb"],
                               res["jax"][1]["shared_emb"], rtol=RTOL,
                               atol=ATOL)
    dense = _pair(lambda P: _w2v(P, False, opt))
    start = _np(dense["port"][2].find_var("shared_emb")).copy()
    dres = _train_both(dense, [feed] * 2)["port"]
    got = res["port"][1]["shared_emb"]
    np.testing.assert_array_equal(got[8], start[8])
    if opt != "adam":       # lazy adam: rows differ from dense adam's
        np.testing.assert_allclose(got[7], dres[1]["shared_emb"][7],
                                   rtol=1e-4, atol=1e-6)
    assert not np.array_equal(got[7], start[7])


def test_run_chunk_bitwise_against_run_and_fetches_stacked_rows():
    """K=4 steps a call equal 4 ``run()`` calls bitwise (losses and every
    scope tensor); a fetched RowSparse comes back stacked [K, ...] as
    the JAX package's scan stacks it, and as a 0-d object array."""
    rng = np.random.RandomState(3)
    feeds = [_feed(rng) for _ in range(4)]
    runs = {}
    for chunk in (False, True):
        pair = _pair(lambda P: _w2v(P, True, "adam"))
        prog, loss, scope = pair["port"]
        exe = T.exe()
        if chunk:
            out = exe.run_chunk(prog, feed_chunk=stack_feeds(feeds),
                                fetch_list=[loss.name, "shared_emb@GRAD"],
                                scope=scope)
            losses = out[0].reshape(-1)
            g = out[1].item()
            assert g.rows.shape == (4, 32) and g.values.shape == (4, 32, D)
            jprog, jloss, jscope = pair["jax"]
            jout = J.exe().run_chunk(jprog, feed_chunk=stack_feeds(feeds),
                                     fetch_list=[jloss.name,
                                                 "shared_emb@GRAD"],
                                     scope=jscope)
            assert jout[1].shape == out[1].shape == ()
            jg = jout[1].item()
            np.testing.assert_array_equal(g.rows, np.asarray(jg.rows))
            np.testing.assert_allclose(g.values, np.asarray(jg.values),
                                       rtol=RTOL, atol=1e-8)
        else:
            losses = np.array([exe.run(prog, feed=f,
                                       fetch_list=[loss.name],
                                       scope=scope)[0].reshape(-1)[0]
                               for f in feeds])
        runs[chunk] = (losses, _state(scope))
    np.testing.assert_array_equal(runs[True][0], runs[False][0])
    for n, v in runs[False][1].items():
        assert np.array_equal(runs[True][1][n], v), n


@pytest.mark.parametrize("scaling", [False, True], ids=["guard",
                                                        "guard+scale"])
def test_guard_skips_a_step_whose_sparse_gradient_is_nan(scaling):
    """Only the table trains, so its row-sparse gradient is the one
    gradient the guard reads: ``guard.nonfinite`` at step 2 poisons it,
    and the step is skipped exactly where the JAX guard skips it, with
    every state tensor bitwise unchanged across it. (Before the repair
    the port's health reduction left a RowSparse out and the NaN reached
    the table.)"""
    def build(P):
        prog, startup, loss = _w2v(P, True, "adam", only_emb=True)
        P.guard.enable(prog, loss, dynamic_loss_scale=scaling,
                       divergence=False)
        return prog, startup, loss

    pair = _pair(build)
    rng = np.random.RandomState(4)
    feeds = [_feed(rng) for _ in range(4)]
    rows = {}
    for P in (J, T):
        prog, loss, scope = pair[P.name]
        exe = P.exe()
        P.fault.inject("guard.nonfinite", crash_on_nth=2, times=1)
        got = []
        for i, f in enumerate(feeds):
            before = _state(scope)
            exe.run(prog, feed=f, fetch_list=[loss.name], scope=scope)
            got.append(exe.poll_health())
            after = _state(scope)
            if i == 1:
                for n in before:
                    assert np.array_equal(before[n], after[n]), (P.name, n)
            assert np.isfinite(after["shared_emb"]).all()
        rows[P.name] = np.concatenate(got)
    np.testing.assert_array_equal(rows["port"][:, 2], [0, 1, 0, 0])
    np.testing.assert_array_equal(rows["port"][:, 2:], rows["jax"][:, 2:])
    ok = rows["jax"][:, 2] == 0
    np.testing.assert_allclose(rows["port"][ok, :2], rows["jax"][ok, :2],
                               rtol=RTOL, atol=RTOL)


def test_add_rows_adds_duplicates_in_index_order():
    """The scatter-add under every sparse update adds a row's duplicates
    one after another in index order (numpy's ``add.at``, and the JAX
    package's scatter on the CPU), the same bits on every run."""
    from paddle_tpu_torch.core.lower import add_rows

    g = torch.Generator().manual_seed(0)
    t = torch.randn(300, 16, generator=g)
    rows = torch.randint(0, 20, (5000,), generator=g, dtype=torch.int32)
    vals = torch.randn(5000, 16, generator=g)
    want = t.numpy().copy()
    np.add.at(want, rows.numpy(), vals.numpy())
    for _ in range(3):
        np.testing.assert_array_equal(add_rows(t, rows, vals).numpy(), want)


def test_row_sparse_gradient_under_amp_matches_jax():
    """Under bf16 AMP the table's row-sparse gradient is bfloat16 in
    both packages (the cotangent's dtype), cast to the float32 table by
    ``astype`` at the optimizer; 3 sparse Adam steps' losses at the AMP
    bound (rtol 1e-2, PERF.md section 2) and the table touched only on
    its rows. A fetched RowSparse comes back as a 0-d object array, as
    from the JAX executor."""
    def build(P):
        prog, startup, loss = _w2v(P, True, "adam")
        P.fluid.amp.enable(prog)
        return prog, startup, loss

    pair = _pair(build)
    feed = _feed(np.random.RandomState(6))
    got = {}
    for P in (J, T):
        prog, loss, scope = pair[P.name]
        exe = P.exe()
        start = _np(scope.find_var("shared_emb")).copy()
        losses, grads = [], []
        for _ in range(3):
            out = exe.run(prog, feed=feed, fetch_list=[
                loss.name, "shared_emb@GRAD"], scope=scope,
                return_numpy=False)
            losses.append(float(np.asarray(_np(out[0]), np.float32)
                                .reshape(-1)[0]))
            grads.append(out[1])
        got[P.name] = (losses, grads[0], start,
                       _np(scope.find_var("shared_emb")))
    (jl, jg, _, _), (tl, tg, start, table) = got["jax"], got["port"]
    assert str(jg.dtype) == "bfloat16" and tg.dtype == torch.bfloat16
    np.testing.assert_array_equal(tg.rows.numpy(), np.asarray(jg.rows))
    np.testing.assert_allclose(tl, jl, rtol=1e-2)
    rows = np.unique(np.concatenate([feed["a"].ravel(), feed["b"].ravel()]))
    other = np.setdiff1d(np.arange(V), rows)
    assert np.array_equal(table[other], start[other])
    assert not np.array_equal(table[rows], start[rows])
    prog, loss, scope = pair["port"]
    g = T.exe().run(prog, feed=feed, fetch_list=["shared_emb@GRAD"],
                    scope=scope)[0]
    assert g.shape == () and g.dtype == object
    assert g.item().values.dtype == np.float32    # widened for numpy


def test_global_norm_clip_of_a_row_sparse_table_trains_as_jax():
    """``GradientClipByGlobalNorm`` over the row-sparse table gradient and
    the dense fc weight (one fused ``global_norm_clip``), 3 sparse SGD
    steps at a clip norm every step exceeds: losses and state at rtol
    1e-5."""
    def build(P):
        P.fluid.clip.set_gradient_clip(
            P.fluid.clip.GradientClipByGlobalNorm(clip_norm=0.05))
        try:
            return _w2v(P, True, "sgd")
        finally:
            P.fluid.clip.set_gradient_clip(None)

    pair = _pair(build)
    prog = pair["port"][0]
    assert [op.type for op in prog.global_block().ops].count(
        "global_norm_clip") == 1
    res = _train_both(pair, [_feed(np.random.RandomState(8))] * 3)
    (jl, js), (tl, ts) = res["jax"], res["port"]
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    for n in js:
        np.testing.assert_allclose(ts[n], js[n], rtol=RTOL, atol=ATOL,
                                   err_msg=n)
