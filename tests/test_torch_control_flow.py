"""Fluid control flow in the port against the JAX package, on the CPU:
``While`` (``while``), ``Switch`` (``conditional_block``), the tensor
arrays, the comparisons and logicals, ``DynamicRNN`` and the Variable
operators. Every case of ``tests/test_control_flow.py`` runs in both
packages from the same weights (the JAX startup's scope carried over by
``interop.load_reference_state``) and the port's numbers are held
against the JAX package's, not only re-run.

Tolerances: losses and gradients within rtol 1e-5 (atol 1e-7 for
gradient entries near zero); the finite-difference checks keep
``tests/test_control_flow.py``'s 5e-3.

The bounded device forms a CUDA graph captures (a ``while`` of
``max_iters`` masked steps, a ``conditional_block`` that selects on the
device, and their refusals) are driven here by making
``control_flow_ops.capturing`` answer True: the same code runs on the
card under ``torch.cuda.graph`` (``tests/test_torch_control_flow_cuda.py``)."""

import os

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import layers as jlayers
from paddle_tpu import unique_name as jnames
from paddle_tpu.core import registry as jregistry
from paddle_tpu.core.lower import PackedSeq as JPackedSeq
from paddle_tpu.ops import control_flow_ops as jcf
from paddle_tpu_torch import interop
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import unique_name as tnames
from paddle_tpu_torch.core import registry as tregistry
from paddle_tpu_torch.core.lower import TraceContext
from paddle_tpu_torch.data_feeder import stack_feeds
from paddle_tpu_torch.ops import control_flow_ops as tcf

# Under pytest-xdist each worker takes its share of the cores for
# torch's intra-op threads: six workers at torch's default thread count
# oversubscribe the cores, and a test of seconds then takes minutes.
_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, os.cpu_count() // int(_WORKERS)))

CPU = tfluid.CPUPlace()
H = 4
T = 3


def _pkg(fluid):
    return (jlayers, jnames) if fluid is jfluid else (tlayers, tnames)


def _pair(build, **kw):
    """Both packages' programs, the JAX weights and a port scope holding
    the same state."""
    out = {}
    for fluid in (jfluid, tfluid):
        layers, names = _pkg(fluid)
        with names.guard():
            out[fluid] = build(fluid, layers, **kw)
    jprog, jstart, jfetch = out[jfluid]
    tprog, tstart, tfetch = out[tfluid]
    jscope = jfluid.Scope()
    jexe = jfluid.Executor()
    jexe.run(jstart, scope=jscope)
    arrays = {v.name: np.asarray(jscope.find_var(v.name))
              for v in jprog.list_vars() if v.persistable}
    tscope = tfluid.Scope()
    interop.load_reference_state(arrays, tscope, CPU, [tprog, tstart])
    return dict(jprog=jprog, jexe=jexe, jscope=jscope, jfetch=jfetch,
                tprog=tprog, texe=tfluid.Executor(CPU), tscope=tscope,
                tfetch=tfetch)


def _run_both(m, feed, fetch):
    j = m["jexe"].run(m["jprog"], feed=feed, fetch_list=fetch,
                      scope=m["jscope"])
    t = m["texe"].run(m["tprog"], feed=feed, fetch_list=fetch,
                      scope=m["tscope"])
    return [np.asarray(v) for v in j], t


# ---- the programs of tests/test_control_flow.py ----

def _while_rnn(fluid, layers, max_iters=8, backward=True, opt=False):
    """h <- tanh(fc(h)) T times inside a While (tests/test_control_flow.py
    _build_while_rnn); loss = mean(h), or with ``opt`` the classifier of
    TestWhileTraining trained by SGD."""
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        x = layers.data("x", [H])
        i = layers.fill_constant([1], "int32", 0)
        n = layers.fill_constant([1], "int32", T)
        h = layers.fc(x, H, act="tanh",
                      param_attr=fluid.ParamAttr(name="pre_w"),
                      bias_attr=False)
        cond = layers.less_than(i, n)
        w = layers.While(cond, max_iters=max_iters)
        with w.block():
            h2 = layers.fc(h, H, act="tanh",
                           param_attr=fluid.ParamAttr(name="loop_w"),
                           bias_attr=False)
            layers.assign(h2, output=h)
            layers.increment(i, value=1.0, in_place=True)
            layers.less_than(i, n, cond=cond)
        if opt:
            label = layers.data("label", [1], dtype="int64")
            pred = layers.fc(h, 3, act="softmax")
            loss = layers.mean(layers.cross_entropy(pred, label))
            fluid.optimizer.SGD(0.5).minimize(loss)
        else:
            loss = layers.mean(h)
            if backward:
                fluid.append_backward(loss)
    return prog, startup, [loss, h, i]


def _switch(fluid, layers, taken=True, nan=False):
    """TestConditionalBlockGrad's program; with ``nan`` the branch also
    adds 0 times log(0 * y): -inf in its forward, and 0 / 0 in its
    gradient even where the cotangent is 0."""
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        x = layers.data("x", [H])
        a = layers.fill_constant([1], "int32", 0 if taken else 5)
        b = layers.fill_constant([1], "int32", 3)
        cond = layers.less_than(a, b)
        y = layers.fc(x, H, param_attr=fluid.ParamAttr(name="cb_w"),
                      bias_attr=False)
        sw = layers.Switch()
        with sw.case(cond):
            y2 = layers.scale(y, scale=3.0)
            if nan:
                bad = layers.log(layers.scale(y, scale=0.0))
                y2 = layers.elementwise_add(
                    y2, layers.scale(bad, scale=0.0))
            layers.assign(y2, output=y)
        loss = layers.mean(y)
        fluid.append_backward(loss)
    return prog, startup, [loss, y]


def _switch_in_while(fluid, layers, taken=True):
    """_while_rnn's loop with _switch's NaN branch inside its body: each
    iteration's h2 is tripled, plus 0 times log(0 * h2), when the Switch
    is taken; loss = mean(h) and the loop is differentiable."""
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        x = layers.data("x", [H])
        i = layers.fill_constant([1], "int32", 0)
        n = layers.fill_constant([1], "int32", T)
        a = layers.fill_constant([1], "int32", 0 if taken else 5)
        b = layers.fill_constant([1], "int32", 3)
        h = layers.fc(x, H, act="tanh",
                      param_attr=fluid.ParamAttr(name="pre_w"),
                      bias_attr=False)
        cond = layers.less_than(i, n)
        w = layers.While(cond, max_iters=T)
        with w.block():
            h2 = layers.fc(h, H, act="tanh",
                           param_attr=fluid.ParamAttr(name="loop_w"),
                           bias_attr=False)
            sw = layers.Switch()
            with sw.case(layers.less_than(a, b)):
                bad = layers.log(layers.scale(h2, scale=0.0))
                layers.assign(layers.elementwise_add(
                    layers.scale(h2, scale=3.0), layers.scale(bad, scale=0.0)),
                    output=h2)
            layers.assign(h2, output=h)
            layers.increment(i, value=1.0, in_place=True)
            layers.less_than(i, n, cond=cond)
        loss = layers.mean(h)
        fluid.append_backward(loss)
    return prog, startup, [loss, h]


def _dynamic_rnn(fluid, layers, hid=8, emb=6, vocab=20):
    """The LSTM cell of benchmark/fluid/stacked_dynamic_lstm.py, written
    with Variable operators inside a DynamicRNN: fc gates, sigmoid/tanh
    and ``*``/``+``, ``memory(value=0.0, shape=[H])``, then
    sequence_pool("last") and a softmax classifier trained by Adam."""
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        words = layers.data("words", [1], dtype="int64", lod_level=1)
        label = layers.data("label", [1], dtype="int64")
        sentence = layers.embedding(words, size=[vocab, emb])
        sentence = layers.fc(sentence, hid, act="tanh", num_flatten_dims=2)
        rnn = layers.DynamicRNN()
        with rnn.block():
            word = rnn.step_input(sentence)
            prev_hidden = rnn.memory(value=0.0, shape=[hid])
            prev_cell = rnn.memory(value=0.0, shape=[hid])

            def gate_common(ipt, hidden, size):
                gate0 = layers.fc(ipt, size, bias_attr=True)
                gate1 = layers.fc(hidden, size, bias_attr=False)
                return gate0 + gate1

            forget_gate = layers.sigmoid(gate_common(word, prev_hidden, hid))
            input_gate = layers.sigmoid(gate_common(word, prev_hidden, hid))
            output_gate = layers.sigmoid(gate_common(word, prev_hidden, hid))
            cell_gate = layers.tanh(gate_common(word, prev_hidden, hid))
            cell = forget_gate * prev_cell + input_gate * cell_gate
            hidden = output_gate * layers.tanh(cell)
            rnn.update_memory(prev_cell, cell)
            rnn.update_memory(prev_hidden, hidden)
            rnn.output(hidden)
        last = layers.sequence_pool(rnn(), "last")
        logit = layers.fc(last, 2, act="softmax")
        loss = layers.mean(layers.cross_entropy(logit, label))
        fluid.optimizer.Adam(1e-2).minimize(loss)
    return prog, startup, [loss, last]


def _x(seed, b=2):
    return np.random.RandomState(seed).rand(b, H).astype(np.float32)


def _grad_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


# ---- the three path-B programs serialize identically ----

@pytest.mark.parametrize("build", [
    lambda f, l: _while_rnn(f, l, max_iters=T, opt=True),
    lambda f, l: _switch(f, l, True),
    lambda f, l: _switch(f, l, False),
    _dynamic_rnn,
], ids=["while_sgd", "switch_taken", "switch_not_taken", "dynamic_rnn"])
def test_program_json_is_byte_identical(build):
    dumps = []
    for fluid in (jfluid, tfluid):
        layers, names = _pkg(fluid)
        with names.guard():
            dumps.append(build(fluid, layers)[0].to_json())
    assert dumps[0] == dumps[1]


def test_training_while_is_stamped_differentiable_in_both_packages():
    for fluid in (jfluid, tfluid):
        layers, names = _pkg(fluid)
        with names.guard():
            prog = _while_rnn(fluid, layers)[0]
            infer = _while_rnn(fluid, layers, backward=False)[0]
        w, = [op for op in prog.global_block().ops if op.type == "while"]
        assert w.attrs["differentiable"] is True
        g, = [op for op in prog.global_block().ops
              if op.type == "while_grad"]
        assert g.attrs["differentiable"] is True
        w, = [op for op in infer.global_block().ops if op.type == "while"]
        assert "differentiable" not in w.attrs


# ---- While ----

def test_while_trains_and_matches_jax_and_finite_differences():
    """TestWhileGrad.test_while_trains_and_matches_finite_differences:
    the loss and loop_w's gradient equal the JAX package's, and the
    gradient matches central differences of the port's own loss."""
    m = _pair(_while_rnn)
    xv = _x(0)
    (jl, jg), (tl, tg) = _run_both(m, {"x": xv},
                                   [m["tfetch"][0].name, "loop_w@GRAD"])
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _grad_close(tg, jg)
    scope, exe, prog = m["tscope"], m["texe"], m["tprog"]
    w0 = scope.find_var("loop_w").clone()

    def loss_at(wv):
        scope.set_var("loop_w", torch.from_numpy(wv))
        return float(exe.run(prog, feed={"x": xv},
                             fetch_list=[m["tfetch"][0]], scope=scope)[0])

    eps = 1e-3
    for idx in [(0, 0), (1, 2), (3, 3)]:
        wp, wm = w0.numpy().copy(), w0.numpy().copy()
        wp[idx] += eps
        wm[idx] -= eps
        numeric = (loss_at(wp) - loss_at(wm)) / (2 * eps)
        assert abs(numeric - tg[idx]) < 5e-3, (idx, numeric, tg[idx])


@pytest.mark.parametrize("max_iters", [8, 2, 0])
def test_while_loop_count_semantics(max_iters):
    """TestWhileGrad.test_while_loop_count_semantics in both lowerings:
    the eager loop (host predicate, inference program) runs exactly T
    times (min(T, max_iters) with a bound), as the unrolled numpy
    computation and the JAX package's lax.while_loop do; with a bound the
    masked form (what a CUDA graph captures, and what the training
    program runs) gives the same bits as the eager loop."""
    m = _pair(_while_rnn, max_iters=max_iters, backward=False)
    xv = _x(1)
    fetch = [v.name for v in m["tfetch"]]
    (jl, jh, ji), (tl, th, ti) = _run_both(m, {"x": xv}, fetch)
    n = min(T, max_iters) if max_iters else T
    pre_w = m["tscope"].find_var("pre_w").numpy().astype(np.float64)
    loop_w = m["tscope"].find_var("loop_w").numpy().astype(np.float64)
    h = np.tanh(xv @ pre_w)
    for _ in range(n):
        h = np.tanh(h @ loop_w)
    assert int(ti[0]) == int(ji[0]) == n
    np.testing.assert_allclose(th, h, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(th, jh, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    if max_iters:
        masked = _captured(m["texe"], m["tprog"], {"x": xv}, fetch,
                           m["tscope"])
        for a, b in zip(masked, (tl, th, ti)):
            assert np.array_equal(a, b)


def _captured(exe, prog, feed, fetch, scope):
    """One run with the capture forms on (as under torch.cuda.graph)."""
    old = tcf.capturing
    tcf.capturing = lambda ctx: True
    try:
        return exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)
    finally:
        tcf.capturing = old


def test_while_without_max_iters_errors_loudly():
    """TestWhileGrad.test_while_without_max_iters_errors_loudly: a
    training program's While without a bound raises in both packages;
    an inference While without a bound refuses the capture form (it
    reads its predicate on the host) and runs eagerly."""
    m = _pair(_while_rnn, max_iters=0)
    feed = {"x": np.zeros((2, H), np.float32)}
    loss = m["tfetch"][0].name
    with pytest.raises(Exception, match="max_iters"):
        m["jexe"].run(m["jprog"], feed=feed, fetch_list=[loss],
                      scope=m["jscope"])
    with pytest.raises(ValueError, match="max_iters"):
        m["texe"].run(m["tprog"], feed=feed, fetch_list=[loss],
                      scope=m["tscope"])
    with tnames.guard():
        prog, startup, fetch = _while_rnn(tfluid, tlayers, max_iters=0,
                                          backward=False)
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    assert int(exe.run(prog, feed=feed, fetch_list=[fetch[2]],
                       scope=scope)[0][0]) == T
    with pytest.raises(RuntimeError, match="max_iters=N"):
        _captured(exe, prog, feed, [fetch[0]], scope)


def test_while_rnn_sgd_descends_as_jax_does():
    """TestWhileTraining.test_while_rnn_sgd_descends: 6 SGD steps through
    a While of max_iters = T, the same losses as the JAX package."""
    m = _pair(_while_rnn, max_iters=T, opt=True)
    rng = np.random.RandomState(3)
    feed = {"x": rng.rand(8, H).astype(np.float32),
            "label": rng.randint(0, 3, (8, 1)).astype(np.int64)}
    jl, tl = [], []
    for _ in range(6):
        j, t = _run_both(m, feed, [m["tfetch"][0].name])
        jl.append(float(j[0]))
        tl.append(float(t[0]))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert np.isfinite(tl).all() and tl[-1] < tl[0], tl


def test_run_chunk_with_a_bounded_while_equals_k_runs_bitwise():
    """run_chunk over K=3 steps of the While classifier equals 3 run()
    calls bit for bit: the losses and every scope tensor."""
    with tnames.guard():
        prog, startup, fetch = _while_rnn(tfluid, tlayers, max_iters=T,
                                          opt=True)
    rng = np.random.RandomState(4)
    feeds = [{"x": rng.rand(8, H).astype(np.float32),
              "label": rng.randint(0, 3, (8, 1)).astype(np.int64)}
             for _ in range(3)]
    exe0 = tfluid.Executor(CPU)
    s0 = tfluid.Scope()
    exe0.run(startup, scope=s0)
    scopes = []
    for _ in range(2):
        s = tfluid.Scope()
        for n, v in s0.vars.items():
            s.set_var(n, v.clone())
        scopes.append(s)
    a = tfluid.Executor(CPU)
    one = [a.run(prog, feed=f, fetch_list=[fetch[0]], scope=scopes[0])[0]
           for f in feeds]
    b = tfluid.Executor(CPU)
    chunk = b.run_chunk(prog, feed_chunk=stack_feeds(feeds),
                        fetch_list=[fetch[0]], scope=scopes[1])[0]
    assert np.array_equal(np.stack(one), chunk)
    for n in scopes[0].vars:
        assert torch.equal(scopes[0].find_var(n), scopes[1].find_var(n)), n


# ---- conditional_block ----

@pytest.mark.parametrize("taken", [True, False])
def test_conditional_grad_matches_jax_and_finite_differences(taken):
    """TestConditionalBlockGrad in both branches: the loss and cb_w's
    gradient equal the JAX package's (lax.cond), the gradient matches
    central differences, and the capture form (branch run, results and
    gradients selected on the device) gives the same bits."""
    m = _pair(_switch, taken=taken)
    xv = _x(2)
    fetch = [m["tfetch"][0].name, "cb_w@GRAD"]
    (jl, jg), (tl, tg) = _run_both(m, {"x": xv}, fetch)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _grad_close(tg, jg)
    scope, exe, prog = m["tscope"], m["texe"], m["tprog"]
    w0 = scope.find_var("cb_w").numpy().copy()

    def loss_at(wv):
        scope.set_var("cb_w", torch.from_numpy(wv))
        return float(exe.run(prog, feed={"x": xv}, fetch_list=fetch[:1],
                             scope=scope)[0])

    eps = 1e-3
    for idx in [(0, 0), (2, 1)]:
        wp, wm = w0.copy(), w0.copy()
        wp[idx] += eps
        wm[idx] -= eps
        numeric = (loss_at(wp) - loss_at(wm)) / (2 * eps)
        assert abs(numeric - tg[idx]) < 5e-3, (taken, idx, numeric, tg[idx])
    scope.set_var("cb_w", torch.from_numpy(w0))
    sel = _captured(exe, prog, {"x": xv}, fetch, scope)
    assert np.array_equal(sel[0], tl) and np.array_equal(sel[1], tg)


@pytest.mark.parametrize("taken", [True, False])
def test_conditional_select_keeps_the_branch_not_taken_out_of_gradients(
        taken):
    """The branch adds 0 * log(0 * y). Taken, the NaN is real in both
    packages (loss and gradient); not taken, lax.cond leaves the branch
    out, and so must the port: eagerly (the branch is not run) and in
    the capture form, where the branch runs and its results are
    selected: the branch's cotangent is then 0, and 0 / 0 in log's
    gradient would make every gradient NaN through a plain select."""
    m = _pair(_switch, taken=taken, nan=True)
    xv = _x(5)
    fetch = [m["tfetch"][0].name, "cb_w@GRAD"]
    (jl, jg), (tl, tg) = _run_both(m, {"x": xv}, fetch)
    sel = _captured(m["texe"], m["tprog"], {"x": xv}, fetch, m["tscope"])
    if taken:
        assert np.isnan(jl) and np.isnan(tl) and np.isnan(sel[0])
        assert np.isnan(jg).all() and np.isnan(tg).all()
        assert np.isnan(sel[1]).all()
        return
    assert np.isfinite(tg).all() and np.isfinite(sel[1]).all()
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _grad_close(tg, jg)
    assert np.array_equal(sel[0], tl) and np.array_equal(sel[1], tg)


@pytest.mark.parametrize("taken", [True, False])
def test_conditional_nested_in_a_while_keeps_the_branch_not_taken_out(taken):
    """The NaN branch as a Switch inside a bounded, differentiable While:
    the loop's gradient is autograd through its masked steps, so the
    conditional's own backward (not a grad op) must keep the branch not
    taken out, in the capture form too, as lax.cond inside lax.scan
    does; taken, the NaN is real in both packages."""
    m = _pair(_switch_in_while, taken=taken)
    xv = _x(7)
    fetch = [m["tfetch"][0].name, "loop_w@GRAD", "pre_w@GRAD"]
    j, t = _run_both(m, {"x": xv}, fetch)
    sel = _captured(m["texe"], m["tprog"], {"x": xv}, fetch, m["tscope"])
    if taken:
        for vals in (j, t, sel):
            assert all(np.isnan(v).all() for v in vals)
        return
    assert all(np.isfinite(v).all() for v in t + sel)
    np.testing.assert_allclose(t[0], j[0], rtol=1e-5)
    for got, want in zip(t[1:], j[1:]):
        _grad_close(got, want)
    for a, b in zip(sel, t):
        assert np.array_equal(a, b)


# ---- comparisons and logicals ----

_CMP = ["less_than", "less_equal", "greater_than", "greater_equal", "equal",
        "not_equal", "logical_and", "logical_or", "logical_xor"]


def _lower_both(op_type, ins, attrs=None):
    """One op's lowering in both packages on the same numpy inputs."""
    import jax.numpy as jnp

    def conv(v, mod):
        if isinstance(v, np.ndarray):
            return jnp.asarray(v) if mod is jregistry else torch.from_numpy(v)
        return v

    out = []
    for mod in (jregistry, tregistry):
        spec = mod.get(op_type)
        args = {s: [conv(v, mod) for v in vs] for s, vs in ins.items()}
        ctx = TraceContext() if mod is tregistry else None
        out.append(mod.normalize_outputs(
            spec.lower(ctx, args, dict(attrs or {}), None)))
    return out


@pytest.mark.parametrize("op_type", _CMP + ["logical_not"])
def test_comparisons_and_logicals_match_the_jax_ops(op_type):
    rng = np.random.RandomState(6)
    if op_type.startswith("logical"):
        x = rng.rand(3, 5) < 0.5
        y = rng.rand(3, 5) < 0.5
    else:
        x = rng.randint(0, 3, (3, 5)).astype(np.float32)
        y = rng.randint(0, 3, (1, 5)).astype(np.float32)
    ins = {"X": [x]} if op_type == "logical_not" else {"X": [x], "Y": [y]}
    j, t = _lower_both(op_type, ins)
    assert t["Out"][0].dtype == torch.bool
    assert np.array_equal(t["Out"][0].numpy(), np.asarray(j["Out"][0]))
    assert tregistry.get(op_type).no_grad


def test_comparison_and_logical_layers_match_jax():
    """less_than / equal / greater_than and the logical layers in one
    program: the JSON and every result equal the JAX package's, and
    cond=/out= write into the given variable."""
    def build(fluid, layers):
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            a = layers.data("a", [4])
            b = layers.data("b", [4])
            lt = layers.less_than(a, b)
            eq = layers.equal(a, b)
            gt = layers.greater_than(a, b)
            given = layers.fill_constant([2, 4], "bool", 0)
            layers.greater_than(a, b, cond=given)
            both = layers.logical_and(lt, eq)
            either = layers.logical_or(lt, gt)
            not_lt = layers.logical_not(lt)
            le = a <= b
            ge = a >= b
        return prog, startup, [lt, eq, gt, given, both, either, not_lt,
                               le, ge]

    m = _pair(build)
    assert m["jprog"].to_json() == m["tprog"].to_json()
    rng = np.random.RandomState(7)
    feed = {"a": rng.randint(0, 3, (2, 4)).astype(np.float32),
            "b": rng.randint(0, 3, (2, 4)).astype(np.float32)}
    j, t = _run_both(m, feed, [v.name for v in m["tfetch"]])
    for a, b in zip(t, j):
        assert np.array_equal(a, b)
    assert np.array_equal(t[3], t[2])


# ---- tensor arrays ----

def test_array_ops_match_the_jax_ops():
    """write_to_array (a new array, then a write past the size and one at
    a lower index), read_from_array, array_length, array_to_lod_tensor,
    lod_tensor_to_array, max_sequence_len and is_empty: the port's
    lowerings against the JAX package's on the same inputs."""
    import jax.numpy as jnp

    rng = np.random.RandomState(8)
    xs = [rng.randn(2, 3).astype(np.float32) for _ in range(3)]
    jarr = tarr = None
    for x, i in zip(xs, (0, 4, 2)):
        idx = np.array([i], np.int64)
        j, t = _lower_both("write_to_array",
                           {"X": [x], "I": [idx], "Array": [None]},
                           {"capacity": 8})
        if jarr is not None:
            j = jregistry.normalize_outputs(jregistry.get(
                "write_to_array").lower(None, {
                    "X": [jnp.asarray(x)], "I": [jnp.asarray(idx)],
                    "Array": [jarr]}, {}, None))
            t = tregistry.normalize_outputs(tregistry.get(
                "write_to_array").lower(TraceContext(), {
                    "X": [torch.from_numpy(x)], "I": [torch.from_numpy(idx)],
                    "Array": [tarr]}, {}, None))
        jarr, tarr = j["Out"][0], t["Out"][0]
        assert isinstance(tarr, tcf.TensorArray)
        assert np.array_equal(tarr.data.numpy(), np.asarray(jarr.data))
        assert int(tarr.size) == int(jarr.size)
    assert tarr.data.shape == (8, 2, 3) and int(tarr.size) == 5

    def both(op_type, jins, tins):
        jo = jregistry.normalize_outputs(jregistry.get(op_type).lower(
            None, jins, {}, None))["Out"][0]
        to = tregistry.normalize_outputs(tregistry.get(op_type).lower(
            TraceContext(), tins, {}, None))["Out"][0]
        return jo, to

    for i in (2, 4, 1, 20):
        jo, to = both("read_from_array",
                      {"X": [jarr], "I": [jnp.asarray([i])]},
                      {"X": [tarr], "I": [torch.tensor([i])]})
        assert np.array_equal(to.numpy(), np.asarray(jo))
    jo, to = both("array_length", {"X": [jarr]}, {"X": [tarr]})
    assert int(to) == int(jo) == 5
    jo, to = both("array_to_lod_tensor", {"X": [jarr]}, {"X": [tarr]})
    assert np.array_equal(to.data.numpy(), np.asarray(jo.data))
    assert np.array_equal(to.lengths.numpy(), np.asarray(jo.lengths))
    data = rng.randn(3, 5, 2).astype(np.float32)
    lens = np.array([5, 2, 4], np.int32)
    jseq = JPackedSeq(jnp.asarray(data), jnp.asarray(lens))
    tseq = tfluid.PackedSeq(torch.from_numpy(data), torch.from_numpy(lens))
    jo, to = both("lod_tensor_to_array", {"X": [jseq]}, {"X": [tseq]})
    assert np.array_equal(to.data.numpy(), np.asarray(jo.data))
    assert int(to.size) == int(jo.size) == 5
    jo, to = both("max_sequence_len", {"RankTable": [jseq]},
                  {"RankTable": [tseq]})
    assert int(to) == int(jo) == 5
    for v in (data, np.zeros((0, 3), np.float32)):
        jo, to = both("is_empty", {"X": [jnp.asarray(v)]},
                      {"X": [torch.from_numpy(v)]})
        assert bool(to) == bool(jo) == (v.size == 0)
    assert isinstance(jcf.TensorArray, type)


def _array_program(fluid, layers):
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        x = layers.data("x", [3])
        seq = layers.data("seq", [2], lod_level=1)
        i = layers.fill_constant([1], "int64", 0)
        arr = layers.array_write(x, i)
        j = layers.increment(i, in_place=False)
        layers.array_write(x * 2.0, j, array=arr)
        n = layers.array_length(arr)
        r = layers.array_read(arr, j)
        longest = layers.max_sequence_len(seq)
        empty = layers.is_empty(x)
    return prog, startup, [arr, n, r, longest, empty]


def test_array_layers_build_the_jax_program_and_run():
    """The array layers build the JAX package's program byte for byte;
    the port runs it (the first array_write allocates the array: the JAX
    package's verifier refuses that program before it runs, ROADMAP.md
    Queue 3), and the executor fetches the TensorArray."""
    dumps = []
    for fluid in (jfluid, tfluid):
        layers, names = _pkg(fluid)
        with names.guard():
            dumps.append(_array_program(fluid, layers))
    assert dumps[0][0].to_json() == dumps[1][0].to_json()
    prog, startup, fetch = dumps[1]
    exe = tfluid.Executor(CPU)
    rng = np.random.RandomState(9)
    xv = rng.randn(2, 3).astype(np.float32)
    seq = [rng.randn(n, 2).astype(np.float32) for n in (3, 1)]
    arr, n, r, longest, empty = exe.run(
        prog, feed={"x": xv, "seq": seq}, fetch_list=fetch,
        scope=tfluid.Scope())
    assert isinstance(arr, tfluid.TensorArray)
    assert arr.data.shape == (128, 2, 3) and int(arr.size) == 2
    assert np.array_equal(arr.data[0], xv)
    assert np.array_equal(arr.data[1], xv * 2.0)
    assert not arr.data[2:].any()
    assert int(n) == 2 and int(longest) == 3 and not bool(empty)
    assert np.array_equal(r, xv * 2.0)


def test_tensor_array_rides_feeds_scopes_and_chunks():
    """A TensorArray goes in as a feed, through run_chunk's [K, ...]
    chunks (sliced per step, fetched stacked) and out of a scope."""
    def build(fluid, layers):
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            blk = prog.global_block()
            arr = blk.create_var(name="arr", shape=None, dtype="float32",
                                 type="tensor_array", is_data=True)
            i = layers.fill_constant([1], "int64", 1)
            layers.array_write(layers.array_read(arr, i) * 3.0, i,
                               array=arr)
            n = layers.array_length(arr)
        return prog, startup, [arr, n]

    with tnames.guard():
        prog, _, fetch = build(tfluid, tlayers)
    rng = np.random.RandomState(10)
    data = rng.randn(4, 2).astype(np.float32)
    fed = tfluid.TensorArray(data, np.int32(3))
    exe = tfluid.Executor(CPU)
    scope = tfluid.Scope()
    out, n = exe.run(prog, feed={"arr": fed}, fetch_list=fetch, scope=scope)
    want = data.copy()
    want[1] *= 3.0
    assert np.array_equal(out.data, want) and int(out.size) == 3
    assert int(n) == 3
    k = 3
    chunk = tfluid.TensorArray(np.stack([data * (s + 1) for s in range(k)]),
                               np.array([3, 1, 2], np.int32))
    outs, ns = exe.run_chunk(prog, feed_chunk={"arr": chunk},
                             fetch_list=fetch, scope=scope)
    assert outs.data.shape == (k, 4, 2)
    assert ns.tolist() == [3, 2, 2]
    for s in range(k):
        w = data * (s + 1)
        w[1] *= 3.0
        assert np.array_equal(outs.data[s], w)
    scope.set_var("kept", tfluid.TensorArray(torch.zeros(2), torch.tensor(
        1, dtype=torch.int32)))
    assert int(scope.find_var("kept").size) == 1


def test_guard_keeps_a_tensor_array_state_through_a_skipped_step():
    """A persistable TensorArray in the scope, written each step (the
    step's loss at index 0), under the step guard: a clean step writes
    it, the step that guard.nonfinite poisons keeps the old array bit
    for bit, as it keeps every other state tensor."""
    from paddle_tpu_torch import fault, guard

    with tnames.guard():
        prog, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(prog, startup):
            x = tlayers.data("x", [H])
            loss = tlayers.mean(tlayers.fc(x, 1))
            hist = prog.global_block().create_var(
                name="hist", dtype="float32", type="tensor_array",
                persistable=True)
            zero = tlayers.fill_constant([1], "int64", 0)
            tlayers.array_write(tlayers.reshape(loss, [1]), zero,
                                array=hist)
            tfluid.optimizer.SGD(0.1).minimize(loss)
    guard.enable(prog, loss)
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    scope.set_var("hist", tfluid.TensorArray(
        torch.zeros(4, 1), torch.tensor(0, dtype=torch.int32)))
    feeds = [{"x": _x(s, 3)} for s in range(3)]
    fault.clear()
    try:
        fault.inject("guard.nonfinite", crash_on_nth=3, times=1)
        l0 = exe.run(prog, feed=feeds[0], fetch_list=[loss], scope=scope)[0]
        h1 = scope.find_var("hist")
        assert isinstance(h1, tfluid.TensorArray) and int(h1.size) == 1
        assert float(h1.data[0, 0]) == float(l0)
        exe.run(prog, feed=feeds[1], fetch_list=[loss], scope=scope)
        rows = exe.poll_health()
        assert rows[-1][2] == 1.0               # skipped
        h2 = scope.find_var("hist")
        assert torch.equal(h2.data, h1.data) and int(h2.size) == 1
        l2 = exe.run(prog, feed=feeds[2], fetch_list=[loss],
                     scope=scope)[0]
        assert float(scope.find_var("hist").data[0, 0]) == float(l2)
    finally:
        fault.clear()


def test_print_prints_eagerly_and_refuses_capture(capsys):
    with tnames.guard():
        prog, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(prog, startup):
            x = tlayers.data("x", [2])
            out = prog.global_block().create_var(name="printed",
                                                 dtype="float32")
            prog.global_block().append_op(
                "print", {"In": ["x"]}, {"Out": ["printed"]},
                {"message": "x = "})
    exe = tfluid.Executor(CPU)
    got, = exe.run(prog, feed={"x": np.ones((1, 2), np.float32)},
                   fetch_list=[out], scope=tfluid.Scope())
    assert "x = [[1. 1.]]" in capsys.readouterr().out
    assert np.array_equal(got, np.ones((1, 2), np.float32))
    with pytest.raises(RuntimeError, match="print op cannot be captured"):
        _captured(exe, prog, {"x": np.ones((1, 2), np.float32)}, [out],
                  tfluid.Scope())


# ---- DynamicRNN and the Variable operators ----

def test_dynamic_rnn_operator_cell_matches_jax():
    """The stacked_dynamic_lstm.py cell in a DynamicRNN over a ragged
    batch (a row of one token): 3 Adam steps' losses and the first
    step's gradients of all parameters at rtol 1e-5, the pooled last
    states too."""
    m = _pair(_dynamic_rnn)
    assert m["jprog"].to_json() == m["tprog"].to_json()
    rng = np.random.RandomState(11)
    lens = [5, 1, 3, 4]
    feed = {"words": [rng.randint(0, 20, (n, 1)).astype(np.int64)
                      for n in lens],
            "label": rng.randint(0, 2, (len(lens), 1)).astype(np.int64)}
    params = sorted(p.name for p in m["tprog"].global_block().all_parameters())
    assert len(params) == 17
    grads = [p + "@GRAD" for p in params]
    jl, tl = [], []
    for step in range(3):
        j, t = _run_both(m, feed, [v.name for v in m["tfetch"]] + grads)
        jl.append(float(j[0]))
        tl.append(float(t[0]))
        np.testing.assert_allclose(t[1], j[1], rtol=1e-5, atol=1e-7)
        if step == 0:
            for name, a, b in zip(grads, t[2:], j[2:]):
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7,
                                           err_msg=name)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]


def test_dynamic_rnn_memory_needs_a_step_input_and_static_input_is_the_var():
    with tnames.guard():
        with tfluid.program_guard(tfluid.Program(), tfluid.Program()):
            rnn = tlayers.DynamicRNN()
            with pytest.raises(ValueError, match="after step_input"):
                with rnn.block():
                    rnn.memory(value=0.0, shape=[3])
        prog, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(prog, startup):
            seq = tlayers.data("seq", [3], lod_level=1)
            ctx = tlayers.data("ctx", [3])
            rnn = tlayers.DynamicRNN()
            with rnn.block():
                x = rnn.step_input(seq)
                assert rnn.static_input(ctx) is ctx
                h = rnn.memory(value=1.0, shape=[3], need_reorder=True)
                new = x + h
                rnn.update_memory(h, new)
                rnn.output(new)
            out = rnn()
    exe = tfluid.Executor(CPU)
    rng = np.random.RandomState(12)
    seqs = [rng.randn(n, 3).astype(np.float32) for n in (2, 4)]
    got, = exe.run(prog, feed={"seq": seqs, "ctx": np.zeros((2, 3),
                                                           np.float32)},
                   fetch_list=[out], scope=tfluid.Scope())
    for row, s in enumerate(seqs):
        np.testing.assert_allclose(got.data[row, :len(s)],
                                   1.0 + np.cumsum(s, 0), rtol=1e-6)


def test_variable_operators_build_the_jax_program_and_compute_its_values():
    """Every Variable operator (with Python scalars on either side),
    unary minus and astype: the same program JSON as the JAX package's
    and the same values."""
    def build(fluid, layers):
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            a = layers.data("a", [3])
            b = layers.data("b", [3])
            outs = [a + b, a - b, a * b, a / b, a ** b, 2.0 + a, 1.0 - a,
                    3.0 * a, 1.0 / b, a < b, a <= b, a > b, a >= b, -a,
                    (a * 4.0).astype("int32")]
        return prog, startup, outs

    m = _pair(build)
    assert m["jprog"].to_json() == m["tprog"].to_json()
    rng = np.random.RandomState(13)
    feed = {"a": rng.rand(2, 3).astype(np.float32) + 0.5,
            "b": rng.rand(2, 3).astype(np.float32) + 0.5}
    j, t = _run_both(m, feed, [v.name for v in m["tfetch"]])
    for k, (a, b) in enumerate(zip(t, j)):
        assert a.dtype == b.dtype, k
        np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=str(k))


def test_assign_layer_copies_variables_and_values():
    dumps = []
    for fluid in (jfluid, tfluid):
        layers, names = _pkg(fluid)
        with names.guard():
            prog, startup = fluid.Program(), fluid.Program()
            with fluid.program_guard(prog, startup):
                x = layers.data("x", [2])
                y = layers.assign(x)
                z = layers.assign(np.array([[1.5, -2.0]], np.float32))
            dumps.append((prog, [y, z]))
    assert dumps[0][0].to_json() == dumps[1][0].to_json()
    xv = np.array([[3.0, 4.0]], np.float32)
    y, z = tfluid.Executor(CPU).run(dumps[1][0], feed={"x": xv},
                                    fetch_list=dumps[1][1],
                                    scope=tfluid.Scope())
    assert np.array_equal(y, xv)
    assert np.array_equal(z, np.array([[1.5, -2.0]], np.float32))
