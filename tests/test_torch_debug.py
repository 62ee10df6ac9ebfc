"""The NaN/Inf debug guard (``paddle_tpu_torch/core/debug.py``,
``FLAGS_check_nan_inf``) against the JAX package's ``checkify`` guard, on
the CPU.

The port's versions of ``tests/test_long_tail.py``'s ``TestCheckNanInf``
and ``TestFlags`` and of ``tests/test_guard.py``'s
``TestHealthPipeline::test_checkify_throw_does_not_orphan_queued_rows``:
the raise names the JAX package's op, uid and output on the same
program (the message is the JAX text); with the flag off nothing raises;
the env bootstrap sets it; a clean run is bitwise the run without the
flag; a NaN made inside a ``While`` body names the body op; a
``run_chunk`` names its failing step; the flag is one named plan miss;
and the guard's queued health rows survive the raise.
"""

import os
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import fault as jfault
from paddle_tpu import guard as jguard
from paddle_tpu import layers as jlayers
from paddle_tpu import telemetry as jtel
from paddle_tpu import unique_name as jnames
from paddle_tpu.core import debug as jdebug
from paddle_tpu_torch import fault as tfault
from paddle_tpu_torch import guard as tguard
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import telemetry as ttel
from paddle_tpu_torch import unique_name as tnames
from paddle_tpu_torch.core import debug as tdebug
from paddle_tpu_torch.data_feeder import stack_feeds

_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, os.cpu_count() // int(_WORKERS)))

CPU = tfluid.CPUPlace()
J = types.SimpleNamespace(fluid=jfluid, layers=jlayers, names=jnames,
                          debug=jdebug, guard=jguard, fault=jfault,
                          tel=jtel, exe=lambda: jfluid.Executor())
T = types.SimpleNamespace(fluid=tfluid, layers=tlayers, names=tnames,
                          debug=tdebug, guard=tguard, fault=tfault,
                          tel=ttel, exe=lambda: tfluid.Executor(CPU))
# the JAX text, which both packages' errors carry
MSG = re.compile(r"NaN/Inf in output '([^']*)' of op '([^']*)' \(uid (\d+)\)")


@pytest.fixture(autouse=True)
def _flags_off():
    for P in (J, T):
        P.fault.clear()
        P.tel.reset()
        P.tel.disable()
    yield
    for P in (J, T):
        P.fluid.set_check_nan_inf(False)
        P.debug.set_check_nan_inf(False)
        P.fault.clear()
        P.tel.reset()
        P.tel.disable()


def _named(err):
    """(output, op type, uid) named by a guard error's text."""
    m = MSG.search(str(err))
    assert m, str(err)
    return m.group(1), m.group(2), int(m.group(3))


def _log_net(P):
    with P.names.guard():
        prog, startup = P.fluid.Program(), P.fluid.Program()
        with P.fluid.program_guard(prog, startup):
            x = P.layers.data("x", [4])
            y = P.layers.log(x)          # log of a negative -> NaN
            z = P.layers.scale(y, 2.0)
    return prog, startup, z


def _raise_named(P, build, feed):
    prog, startup, fetch = build(P)
    with P.fluid.scope_guard(P.fluid.Scope()):
        exe = P.exe()
        exe.run(startup)
        P.fluid.set_check_nan_inf(True)
        with pytest.raises(Exception, match="NaN/Inf") as ei:
            exe.run(prog, feed=feed, fetch_list=[fetch.name])
    return prog, ei.value


def test_nan_raises_with_the_jax_packages_op_attribution():
    bad = np.array([[1.0, -1.0, 2.0, 3.0]], np.float32)
    named = []
    for P in (J, T):
        _prog, err = _raise_named(P, _log_net, {"x": bad})
        named.append(_named(err))
    assert named[1] == named[0]
    assert named[1][1] == "log"
    err = _raise_named(T, _log_net, {"x": bad})[1]
    assert isinstance(err, tdebug.NanInfError) and err.step is None
    assert (err.var, err.op_type, err.op_uid) == named[0]
    # healthy inputs pass with the guard on
    prog, startup, z = _log_net(T)
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    tfluid.set_check_nan_inf(True)
    good = np.array([[1.0, 1.5, 2.0, 3.0]], np.float32)
    out = exe.run(prog, feed={"x": good}, fetch_list=[z], scope=scope)[0]
    assert np.isfinite(out).all()


def test_guard_off_is_silent():
    prog, startup, z = _log_net(T)
    exe = tfluid.Executor(CPU)
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    bad = np.array([[1.0, -1.0, 2.0, 3.0]], np.float32)
    out = exe.run(prog, feed={"x": bad}, fetch_list=[z], scope=scope)[0]
    assert np.isnan(out).any()


def test_set_get_and_nan_guard_routing():
    assert tfluid.get_flags("FLAGS_check_nan_inf")[
        "FLAGS_check_nan_inf"] is False
    tfluid.set_flags({"FLAGS_check_nan_inf": True})
    try:
        assert tdebug.check_nan_inf_enabled()
    finally:
        tfluid.set_flags({"FLAGS_check_nan_inf": False})
    assert not tdebug.check_nan_inf_enabled()
    assert tfluid.flags.set_check_nan_inf is tfluid.set_check_nan_inf
    with pytest.raises(KeyError):
        tfluid.set_flags({"FLAGS_not_a_flag": 1})


def test_env_bootstrap():
    r = subprocess.run(
        [sys.executable, "-c",
         "import paddle_tpu_torch as f; "
         "from paddle_tpu_torch.core import debug; "
         "print(f.get_flags('FLAGS_check_nan_inf'), "
         "debug.check_nan_inf_enabled(), "
         "f.get_flags('FLAGS_verify_ir'))"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "FLAGS_check_nan_inf": "1",
             "FLAGS_verify_ir": "0"})
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["{'FLAGS_check_nan_inf':", "True}",
                                "True", "{'FLAGS_verify_ir':", "False}"]


def _mlp(P):
    with P.names.guard():
        prog, startup = P.fluid.Program(), P.fluid.Program()
        with P.fluid.program_guard(prog, startup):
            x = P.layers.data("x", [8])
            label = P.layers.data("label", [1], dtype="int64")
            h = P.layers.fc(x, 16, act="relu")
            h = P.layers.dropout(h, 0.25)
            pred = P.layers.fc(h, 4, act="softmax")
            loss = P.layers.mean(P.layers.cross_entropy(pred, label))
            P.fluid.optimizer.Adam(1e-2).minimize(loss)
    return prog, startup, loss


def _feeds(n, seed=0):
    rng = np.random.RandomState(seed)
    return [{"x": rng.rand(6, 8).astype(np.float32),
             "label": rng.randint(0, 4, (6, 1)).astype(np.int64)}
            for _ in range(n)]


def _train(flag, chunk):
    prog, startup, loss = _mlp(T)
    tfluid.set_check_nan_inf(flag)
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    feeds = _feeds(4)
    if chunk:
        out = exe.run_chunk(prog, feed_chunk=stack_feeds(feeds),
                            fetch_list=[loss], scope=scope)
        losses = [out[0]]
    else:
        losses = [exe.run(prog, feed=f, fetch_list=[loss], scope=scope)[0]
                  for f in feeds]
    state = {n: v.numpy().copy() for n, v in scope.vars.items()
             if v is not None}
    return losses, state


@pytest.mark.parametrize("chunk", [False, True], ids=["run", "run_chunk"])
def test_a_clean_run_is_bitwise_the_run_without_the_guard(chunk):
    """The guard only reads: four Adam steps with dropout give the same
    bits with the flag on and off, as ``run`` calls and as one
    ``run_chunk``."""
    off = _train(False, chunk)
    on = _train(True, chunk)
    for a, b in zip(off[0], on[0]):
        assert np.array_equal(a, b)
    assert set(off[1]) == set(on[1])
    for n in off[1]:
        assert np.array_equal(off[1][n], on[1][n]), n


def test_the_flag_is_one_named_plan_miss():
    """A flip builds one plan, named ``nan_guard`` in the miss
    signature; flipping back finds the old plan."""
    T.tel.enable()
    prog, startup, loss = _mlp(T)
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    feed = _feeds(1)[0]
    exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
    assert exe._last_plan_hit is False
    n = len(exe._plans)
    tfluid.set_check_nan_inf(True)
    exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
    assert exe._last_plan_hit is False and len(exe._plans) == n + 1
    tfluid.set_check_nan_inf(False)
    exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
    assert exe._last_plan_hit is True and len(exe._plans) == n + 1
    # the flip's miss names the field that changed
    diffs = [d for e in ttel.recompile_detector.events for d in e["diff"]]
    assert any(d.startswith("nan_guard") for d in diffs), diffs


def test_chunk_names_its_failing_step():
    """A chunk whose third step makes the NaN raises after the chunk,
    naming the op and that step (all K steps ran)."""
    prog, startup, z = _log_net(T)
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    xs = np.ones((4, 2, 4), np.float32)
    xs[2, 1, 3] = -1.0
    tfluid.set_check_nan_inf(True)
    with pytest.raises(tdebug.NanInfError) as ei:
        exe.run_chunk(prog, feed_chunk={"x": xs}, fetch_list=[z],
                      scope=scope, step0=10)
    assert ei.value.op_type == "log" and ei.value.step == 12
    assert "at step 12 (step 2 of the chunk)" in str(ei.value)
    assert exe._step == 14


def _while_net(P):
    """A While loop whose body takes the log of a counter that goes
    negative on its second iteration."""
    fluid, layers = P.fluid, P.layers
    with P.names.guard():
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            x = layers.data("x", [1], append_batch_size=False)
            i = layers.fill_constant([1], "int64", 0)
            n = layers.fill_constant([1], "int64", 3)
            acc = layers.fill_constant([1], "float32", 0.0)
            cur = layers.scale(x, 1.0)
            cond = layers.less_than(i, n)
            loop = layers.While(cond, max_iters=3)
            with loop.block():
                v = layers.log(cur)
                layers.assign(layers.elementwise_add(acc, v), acc)
                layers.assign(layers.scale(cur, 1.0, bias=-2.0), cur)
                layers.increment(i, in_place=True)
                layers.less_than(i, n, cond=cond)
    return prog, startup, acc


def test_nan_inside_a_while_body_names_the_body_op():
    """The log inside the body makes the NaN on the second iteration:
    the raise names the body's log op (its uid, in block 1), as the
    JAX package's checkify names it."""
    feed = {"x": np.array([1.5], np.float32)}
    prog, err = _raise_named(T, _while_net, feed)
    name, op_type, uid = _named(err)
    body = prog.block(1)
    log_op = next(op for op in body.ops if op.type == "log")
    assert (op_type, uid, name) == ("log", log_op.uid,
                                    log_op.outputs["Out"][0])
    _jprog, jerr = _raise_named(J, _while_net, feed)
    assert _named(jerr) == (name, op_type, uid)


def test_checkify_throw_does_not_orphan_queued_rows():
    """With FLAGS_check_nan_inf and the training guard both on, a
    dispatch whose check raises keeps the PREVIOUS dispatch's queued
    health rows: the next poll processes both (1 skip counted, the armed
    rule credited its fire), as in the JAX package."""
    T.tel.enable()
    with tnames.guard():
        prog, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(prog, startup):
            x = tlayers.data("x", [8])
            label = tlayers.data("label", [1], dtype="int64")
            h = tlayers.fc(x, 8, act="relu")
            pred = tlayers.fc(h, 4, act="softmax")
            loss = tlayers.mean(tlayers.cross_entropy(pred, label))
            tfluid.optimizer.SGD(0.1).minimize(loss)
    tguard.enable(prog, loss, dynamic_loss_scale=True,
                  init_loss_scale=8.0, divergence=False)
    scope = tfluid.Scope()
    tfluid.Executor(CPU).run(startup, scope=scope)
    tdebug.set_check_nan_inf(True)
    exe = tfluid.Executor(CPU)
    feeds = [{"x": np.full((4, 8), 0.5, np.float32),
              "label": np.zeros((4, 1), np.int64)}] * 2
    tfault.inject("guard.nonfinite", crash_on_nth=2, times=1)
    exe.run(prog, feed=feeds[0], fetch_list=[loss.name], scope=scope)
    assert len(exe._pending_health) == 1
    with pytest.raises(Exception, match="NaN/Inf"):
        exe.run(prog, feed=feeds[1], fetch_list=[loss.name], scope=scope)
    assert len(exe._pending_health) == 2
    exe.poll_health()
    assert exe._pending_health == []
    roll = ttel.summary()
    assert roll["paddle_tpu_guard_skipped_steps_total"] == 1
    assert roll["paddle_tpu_fault_injected_total"] == 1
    # the scope is whole after the raise: every tensor alive and finite
    # where the guard kept its old value
    for n, v in scope.vars.items():
        if v is not None:
            v.numpy()


def test_under_amp_the_first_reader_of_a_poisoned_weight_is_named():
    """bf16 AMP: one NaN in a weight. The raise names the first op in
    program order that reads the weight, derived from the program."""
    from paddle_tpu_torch.models import transformer

    with tnames.guard():
        prog, startup, _feeds, fetches = transformer.build_transformer_lm(
            vocab_size=50, seq_len=8, d_model=16, num_layers=1, num_heads=2)
    tfluid.amp.enable(prog)
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    feed = {"tokens": rng.randint(0, 50, (2, 8)).astype(np.int64),
            "targets": rng.randint(0, 50, (2, 8)).astype(np.int64)}
    block = prog.global_block()
    w = next(p.name for p in block.all_parameters()
             if p.name.startswith("fc_") and len(p.shape) == 2)
    first = next(op for op in block.ops if w in op.input_arg_names)
    scope.find_var(w)[0, 0] = float("nan")
    tfluid.set_check_nan_inf(True)
    with pytest.raises(tdebug.NanInfError) as ei:
        exe.run(prog, feed=feed, fetch_list=fetches[:1], scope=scope)
    assert (ei.value.op_type, ei.value.op_uid) == (first.type, first.uid)
