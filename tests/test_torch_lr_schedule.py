"""The learning-rate schedulers, the regularizers, the gradient clips and
per-parameter learning rates of the port against the JAX package's, on
the CPU.

* Each op they emit (``increment``, ``pow``, ``floor``, ``exp``,
  ``cos``, ``sign``, ``clip``, ``clip_by_norm``, ``global_norm_clip``,
  ``where``, ``less_than``, ``elementwise_div``, ``elementwise_min``)
  against the JAX lowering on the same numpy inputs: float results
  within 1e-6 (elementwise fp32 math; ``clip_by_norm`` and
  ``global_norm_clip`` sum in another order, 1e-5), integer and boolean
  results exact, dtypes equal.
* Each scheduler's program (main and startup) serializes byte-identical
  to the JAX package's, and its learning rate over 10 steps equals the
  JAX package's at rtol 1e-6 (the port's last 5 steps as one
  ``run_chunk``).
* An MLP with ``L2Decay`` (the optimizer's), ``L1Decay``,
  ``GradientClipByValue``, ``GradientClipByNorm``,
  ``GradientClipByGlobalNorm`` over a group of two and a per-parameter
  learning rate of 0.5 builds byte-identical JSON, and its 3 Momentum
  steps' losses and parameters match the JAX package's within 1e-5 from
  the same weights (``interop.load_reference_state``).
* ``global_norm_clip`` under bf16 AMP sums the squares in float32, as
  the JAX op does.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import clip as jclip
from paddle_tpu import regularizer as jreg_lib
from paddle_tpu import unique_name as jnames
from paddle_tpu.core import registry as jreg
from paddle_tpu.core.lower import TraceContext as JCtx
from paddle_tpu_torch import clip as tclip
from paddle_tpu_torch import interop
from paddle_tpu_torch import regularizer as treg_lib
from paddle_tpu_torch import unique_name as tnames
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.lower import TraceContext as TCtx

# Under pytest-xdist each worker takes its share of the cores for
# torch's intra-op threads: six workers at torch's default thread count
# oversubscribe the cores, and a test of seconds then takes minutes.
_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, os.cpu_count() // int(_WORKERS)))

CPU = tfluid.CPUPlace()


def _dump(prog):
    return json.dumps(prog.to_dict(), sort_keys=True, indent=1)


# ---- the ops against the JAX lowerings ----

class _Op:
    """The slice of an Operator a lowering reads."""

    def __init__(self, type, attrs, uid=1):
        self.type, self.attrs, self.uid = type, attrs, uid
        self.inputs, self.outputs = {}, {}


def _run_both(type, ins, attrs):
    op = _Op(type, attrs)
    jout = jreg.normalize_outputs(jreg.get(type).lower(
        JCtx(key=jax.random.PRNGKey(0)).for_op(op),
        {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}, attrs, op))
    tout = treg.normalize_outputs(treg.get(type).lower(
        TCtx(key=0).for_op(op),
        {s: [torch.from_numpy(np.array(a)) for a in v]
         for s, v in ins.items()}, attrs, op))
    return ({s: [np.asarray(x) for x in v] for s, v in jout.items()},
            {s: [x.numpy() for x in v] for s, v in tout.items()})


RNG = np.random.RandomState(0)
X = RNG.randn(5, 7).astype(np.float32)
POS = (RNG.rand(5, 7) * 3 + 0.1).astype(np.float32)
Y = RNG.randn(5, 7).astype(np.float32)

OPS = {
    "increment_int": ("increment", {"X": [np.array([-1], np.int32)]},
                      {"step": 1.0}),
    "increment_float": ("increment", {"X": [X]}, {"step": 0.25}),
    "pow": ("pow", {"X": [POS]}, {"factor": -0.5}),
    "pow_int_factor": ("pow", {"X": [X]}, {"factor": 2.0}),
    "floor": ("floor", {"X": [X * 3]}, {}),
    "exp": ("exp", {"X": [X]}, {}),
    "cos": ("cos", {"X": [X * 3]}, {}),
    "sign": ("sign", {"X": [np.concatenate([X, np.zeros((1, 7),
                                                        np.float32)])]}, {}),
    "clip": ("clip", {"X": [X]}, {"min": -0.3, "max": 0.5}),
    "clip_by_norm_clips": ("clip_by_norm", {"X": [X]}, {"max_norm": 1.0}),
    "clip_by_norm_keeps": ("clip_by_norm", {"X": [X]}, {"max_norm": 100.0}),
    "global_norm_clip_clips": ("global_norm_clip", {"X": [X, Y[:2]]},
                               {"clip_norm": 1.0}),
    "global_norm_clip_keeps": ("global_norm_clip", {"X": [X, Y[:2]]},
                               {"clip_norm": 100.0}),
    "where": ("where", {"Condition": [X > 0], "X": [X], "Y": [Y]}, {}),
    "less_than": ("less_than", {"X": [X], "Y": [np.array([0.1],
                                                         np.float32)]}, {}),
    "elementwise_div": ("elementwise_div", {"X": [X], "Y": [POS]},
                        {"axis": -1}),
    "elementwise_div_bcast": ("elementwise_div",
                              {"X": [X], "Y": [POS[0]]}, {"axis": -1}),
    "elementwise_min": ("elementwise_min", {"X": [X], "Y": [Y]},
                        {"axis": -1}),
}


@pytest.mark.parametrize("case", sorted(OPS))
def test_op_matches_jax(case):
    type, ins, attrs = OPS[case]
    j, t = _run_both(type, ins, attrs)
    tol = 1e-5 if "norm" in type else 1e-6
    assert sorted(j) == sorted(t)
    for slot in j:
        for a, b in zip(j[slot], t[slot]):
            assert a.shape == b.shape and a.dtype == b.dtype, (slot, a.dtype,
                                                               b.dtype)
            if np.issubdtype(a.dtype, np.floating):
                np.testing.assert_allclose(b, a, rtol=tol, atol=tol)
            else:
                np.testing.assert_array_equal(b, a)


def test_global_norm_clip_sums_in_float32_under_bf16():
    """A bf16 gradient of 4096 ones beside a float32 one: in bfloat16 the
    running sum of squares stalls at 256 (256 + 1 rounds back to 256), in
    float32 it reaches 4096 + 9. Both packages scale by clip_norm /
    sqrt(4105) from the float32 sum; the bf16 output holds one rounding
    of g times that factor (rtol 2**-8)."""
    g16 = np.ones((64, 64), np.float32)
    g32 = np.array([3.0], np.float32)
    clip_norm = 8.0
    op = _Op("global_norm_clip", {"clip_norm": clip_norm})
    jout = jreg.get("global_norm_clip").lower(
        JCtx(key=jax.random.PRNGKey(0)).for_op(op),
        {"X": [jnp.asarray(g16, jnp.bfloat16), jnp.asarray(g32)]},
        op.attrs, op)["Out"]
    tout = treg.get("global_norm_clip").lower(
        TCtx(key=0).for_op(op),
        {"X": [torch.from_numpy(g16).to(torch.bfloat16),
               torch.from_numpy(g32)]}, op.attrs, op)["Out"]
    factor = np.float32(clip_norm) / np.sqrt(np.float32(4096 + 9))
    assert tout[0].dtype == torch.bfloat16 and tout[1].dtype == torch.float32
    np.testing.assert_allclose(tout[0].float().numpy(), factor,
                               rtol=2 ** -8)
    np.testing.assert_allclose(tout[1].numpy(), 3.0 * factor, rtol=1e-6)
    np.testing.assert_array_equal(tout[0].float().numpy(),
                                  np.asarray(jout[0]).astype(np.float32))
    np.testing.assert_allclose(tout[1].numpy(), np.asarray(jout[1]),
                               rtol=1e-6)
    # a bf16 sum would have given about clip_norm / sqrt(256 + 9)
    assert abs(float(tout[0][0, 0]) - clip_norm / np.sqrt(265.0)) > 0.1


# ---- the schedulers ----

SCHEDULES = {
    "noam": ("noam_decay", dict(d_model=64, warmup_steps=4)),
    "exponential": ("exponential_decay", dict(learning_rate=0.1,
                                              decay_steps=3, decay_rate=0.5)),
    "exponential_staircase": ("exponential_decay", dict(
        learning_rate=0.1, decay_steps=3, decay_rate=0.5, staircase=True)),
    "natural_exp": ("natural_exp_decay", dict(
        learning_rate=0.1, decay_steps=3, decay_rate=0.5, staircase=True)),
    "inverse_time": ("inverse_time_decay", dict(
        learning_rate=0.1, decay_steps=3, decay_rate=0.5)),
    "polynomial": ("polynomial_decay", dict(
        learning_rate=0.1, decay_steps=8, end_learning_rate=0.01,
        power=2.0)),
    "piecewise": ("piecewise_decay", dict(boundaries=[3, 6],
                                          values=[0.1, 0.05, 0.01])),
    "cosine": ("cosine_decay", dict(learning_rate=0.1, step_each_epoch=2,
                                    epochs=4)),
    "linear_warmup": ("linear_lr_warmup", dict(
        learning_rate=0.1, warmup_steps=4, start_lr=0.0, end_lr=0.1)),
}


def _sched_program(fluid, names, case):
    sched, kw = SCHEDULES[case]
    prog, startup = fluid.Program(), fluid.Program()
    with names.guard(), fluid.program_guard(prog, startup):
        x = fluid.layers.data("x", [4])
        loss = fluid.layers.mean(fluid.layers.fc(x, 1))
        lr = getattr(fluid.layers, sched)(**kw)
        fluid.optimizer.SGD(learning_rate=lr).minimize(loss)
    return prog, startup, lr, loss


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_schedule_json_identical_and_rates_match_jax(case):
    jprog, jstart, jlr, _ = _sched_program(jfluid, jnames, case)
    tprog, tstart, tlr, _ = _sched_program(tfluid, tnames, case)
    assert _dump(tprog) == _dump(jprog)
    assert _dump(tstart) == _dump(jstart)
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    jexe, texe = jfluid.Executor(), tfluid.Executor(CPU)
    jexe.run(jstart, scope=jscope)
    texe.run(tstart, scope=tscope)
    feed = {"x": np.ones((2, 4), np.float32)}
    want = [float(np.asarray(jexe.run(jprog, feed=feed, fetch_list=[jlr],
                                      scope=jscope)[0]).reshape(()))
            for _ in range(10)]
    got = [float(texe.run(tprog, feed=feed, fetch_list=[tlr],
                          scope=tscope)[0].reshape(())) for _ in range(5)]
    got += [float(v) for v in texe.run_chunk(
        tprog, feed_chunk={"x": np.ones((5, 2, 4), np.float32)},
        fetch_list=[tlr], scope=tscope)[0].reshape(-1)]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert len(set(want)) > 1          # the rate moves over the 10 steps
    counter, = [v.name for v in tprog.list_vars()
                if v.name.startswith("@LR_DECAY_COUNTER@")]
    assert int(tscope.find_var(counter)[0]) == 9
    assert int(np.asarray(jscope.find_var(counter))[0]) == 9


def test_step_counter_is_an_int64_persistable_advanced_in_program():
    """Declared int64 (its startup initializer fills int64); the
    ``increment`` op's inferred output records it as int32, as the JAX
    package records it with 64-bit types off. The port keeps the
    startup's int64 tensor and ``increment`` keeps its dtype."""
    with tnames.guard(), tfluid.program_guard(tfluid.Program(),
                                              tfluid.Program()):
        c = tfluid.layers.autoincreased_step_counter(begin=5, step=2)
        prog = tfluid.default_main_program()
        startup = tfluid.default_startup_program()
    assert c.name.startswith("@STEP_COUNTER@") and c.dtype == "int32"
    assert startup.global_block().var(c.name).dtype == "int64"
    assert c.persistable and c.stop_gradient
    assert [op.type for op in prog.global_block().ops] == ["increment"]
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    seen = [int(exe.run(prog, fetch_list=[c], scope=scope)[0][0])
            for _ in range(3)]
    assert seen == [5, 7, 9]
    assert scope.find_var(c.name).dtype == torch.int64


# ---- regularizers, clips and per-parameter learning rates ----

def _reg_program(fluid, names, clip_mod, reg_mod):
    prog, startup = fluid.Program(), fluid.Program()
    layers, PA = fluid.layers, fluid.ParamAttr
    group = clip_mod.GradientClipByGlobalNorm(0.5)
    with names.guard(), fluid.program_guard(prog, startup):
        img = layers.data("img", [16])
        label = layers.data("label", [1], dtype="int64")
        h = layers.fc(img, 8, act="relu", param_attr=PA(
            name="w1", regularizer=reg_mod.L1Decay(1e-3),
            gradient_clip=clip_mod.GradientClipByValue(0.05)))
        h = layers.fc(h, 8, act="relu", param_attr=PA(
            name="w2", learning_rate=0.5,
            gradient_clip=clip_mod.GradientClipByNorm(0.2)))
        pred = layers.fc(h, 4, act="softmax",
                         param_attr=PA(name="w3", gradient_clip=group),
                         bias_attr=PA(name="b3", gradient_clip=group))
        loss = layers.mean(layers.cross_entropy(pred, label))
        fluid.optimizer.Momentum(
            0.1, 0.9, regularization=reg_mod.L2Decay(1e-2)).minimize(loss)
    return prog, startup, loss


def test_regularized_clipped_mlp_json_identical_and_trains_as_jax():
    jprog, jstart, jloss = _reg_program(jfluid, jnames, jclip, jreg_lib)
    tprog, tstart, tloss = _reg_program(tfluid, tnames, tclip, treg_lib)
    assert _dump(tprog) == _dump(jprog)
    assert _dump(tstart) == _dump(jstart)
    types = [op.type for op in tprog.global_block().ops]
    for t in ("clip", "clip_by_norm", "global_norm_clip", "sign", "scale"):
        assert t in types, t
    jscope = jfluid.Scope()
    jexe = jfluid.Executor()
    jexe.run(jstart, scope=jscope)
    arrays = {v.name: np.asarray(jscope.find_var(v.name))
              for v in jprog.list_vars() if v.persistable}
    tscope = tfluid.Scope()
    interop.load_reference_state(arrays, tscope, CPU, [tprog, tstart])
    texe = tfluid.Executor(CPU)
    rng = np.random.RandomState(4)
    feed = {"img": rng.randn(8, 16).astype(np.float32),
            "label": rng.randint(0, 4, (8, 1)).astype(np.int64)}
    jl = [float(np.asarray(jexe.run(jprog, feed=feed, fetch_list=[jloss],
                                    scope=jscope)[0])) for _ in range(3)]
    tl = [float(texe.run(tprog, feed=feed, fetch_list=[tloss],
                         scope=tscope)[0]) for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
    assert tl[-1] < tl[0]
    for n in arrays:
        np.testing.assert_allclose(tscope.find_var(n).numpy(),
                                   np.asarray(jscope.find_var(n)),
                                   rtol=1e-5, atol=1e-5, err_msg=n)


def test_per_parameter_learning_rate_scales_the_update():
    """SGD with lr 0.1 and a ParamAttr learning rate of 0.5: the
    parameter moves by 0.05 x its gradient (a ``scale`` of the shared
    rate, as the JAX package emits it)."""
    prog, startup = tfluid.Program(), tfluid.Program()
    with tnames.guard(), tfluid.program_guard(prog, startup):
        x = tfluid.layers.data("x", [3])
        y = tfluid.layers.fc(x, 1, bias_attr=False, param_attr=tfluid.
                             ParamAttr(name="w", learning_rate=0.5))
        loss = tfluid.layers.mean(y)
        tfluid.optimizer.SGD(0.1).minimize(loss)
    scales = [op for op in prog.global_block().ops if op.type == "scale"
              and op.attrs.get("scale") == 0.5]
    assert len(scales) == 1
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    w0 = scope.find_var("w").clone()
    xs = np.arange(6, dtype=np.float32).reshape(2, 3)
    exe.run(prog, feed={"x": xs}, scope=scope)
    grad = torch.from_numpy(xs.mean(0)).reshape(3, 1)
    torch.testing.assert_close(scope.find_var("w"), w0 - 0.05 * grad,
                               rtol=1e-6, atol=1e-7)


def test_set_gradient_clip_json_identical_to_jax():
    """``set_gradient_clip`` sets the default clip of every parameter
    (module-global in both packages: reset after)."""
    progs = []
    for fluid, names, clip_mod in ((jfluid, jnames, jclip),
                                   (tfluid, tnames, tclip)):
        prog, startup = fluid.Program(), fluid.Program()
        try:
            with names.guard(), fluid.program_guard(prog, startup):
                clip_mod.set_gradient_clip(
                    clip_mod.GradientClipByGlobalNorm(1.0))
                x = fluid.layers.data("x", [4])
                loss = fluid.layers.mean(fluid.layers.fc(
                    fluid.layers.fc(x, 3), 2))
                fluid.optimizer.SGD(0.1).minimize(loss)
        finally:
            clip_mod._global_clip = None
        progs.append(prog)
    assert _dump(progs[1]) == _dump(progs[0])
    clips = [op for op in progs[1].global_block().ops
             if op.type == "global_norm_clip"]
    assert len(clips) == 1 and len(clips[0].input("X")) == 4
