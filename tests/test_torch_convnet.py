"""The convnet slice on the CPU against the JAX package: the LeNet and
ResNet builders give the JAX package's JSON (main and startup); conv2d,
pool2d, batch_norm (forward and the hand-written grad, both layouts),
relu, momentum and sgd agree op by op on the same numpy inputs; and the
``mnist_cnn`` and ``resnet_cifar`` programs train step for step from the
JAX startup's weights.

Tolerances. Op by op: forward 1e-5, gradients rtol 1e-4 with an atol of
1e-5 of the gradient's largest magnitude (fp32 in another summation
order). ResNet at 32x32 and batch 8 normalises 8 values a channel in
stage 4, and at its initial weights a rounding difference flips relu
gates: ``test_a_1e6_input_change_moves_first_step_gradients`` measures
that a 1e-6 change of the input moves single gradients by 0.2-0.4 of
their largest value and all together by 2-3e-2, at depth 18 as at depth
50. ResNet-50 is therefore compared with the scale of the last batch
norm of every residual branch multiplied by 0.03 in BOTH packages (the
blocks then start close to the identity, as a zero-initialised residual
does; the same input change then moves all gradients together by 2e-4):
losses of 3 Momentum steps rtol 1e-3, every first-step gradient within
5e-2 of its largest magnitude (a batch_norm bias whose gradient nearly
cancels sets it: 3.3e-2), all gradients together within 2e-3 in relative
L2 norm, running means and variances atol 1e-3. The JAX package's CPU
reductions lie further from float64 than torch's
(``test_batch_statistics_against_float64``), which the running
statistics' tolerance covers. The velocities are carried over and
updated but not compared: after the first update the two runs'
gradients drift apart at the rate above.

With no weight edited the comparison is made at depth 18, where both
packages run the same NCHW sums and happen to flip no gate: every
first-step gradient within 5e-4 of its largest magnitude, and the losses
of 4 Momentum steps at lr 0.1, which rise in both packages before they
fall (lr 0.1 with momentum overshoots on one repeated batch; at lr 0.01
both fall at every step). At depth 50 the first step at lr 0.1 sends
the loss to the cross entropy's clip in both packages."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import unique_name as jnames
from paddle_tpu.core import registry as jreg
from paddle_tpu.core.lower import TraceContext as JCtx
from paddle_tpu.models import lenet as jlenet
from paddle_tpu.models import resnet as jresnet
from paddle_tpu_torch import interop
from paddle_tpu_torch import unique_name as tnames
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.lower import TraceContext as TCtx
from paddle_tpu_torch.kernels import bn_grad as tbn
from paddle_tpu_torch.kernels import conv1x1_bwd as tk1
from paddle_tpu_torch.models import lenet as tlenet
from paddle_tpu_torch.models import resnet as tresnet

# Under pytest-xdist each worker takes its share of the cores for
# torch's intra-op threads: six workers at torch's default thread count
# oversubscribe the cores, and a test of seconds then takes minutes.
_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, os.cpu_count() // int(_WORKERS)))

CPU = tfluid.CPUPlace()
CIFAR = dict(image_shape=(3, 32, 32), class_dim=10)
BUILDERS = {
    "mnist_cnn": (lambda: jlenet.build_mnist_train(model="cnn"),
                  lambda: tlenet.build_mnist_train(model="cnn")),
    "resnet_cifar": (lambda: jresnet.build_resnet50_train(**CIFAR),
                     lambda: tresnet.build_resnet50_train(**CIFAR)),
    "resnet18": (
        lambda: jresnet.build_resnet50_train(depth=18, **CIFAR),
        lambda: tresnet.build_resnet50_train(depth=18, **CIFAR)),
    "resnet18_low_lr": (
        lambda: jresnet.build_resnet50_train(depth=18, lr=0.01, **CIFAR),
        lambda: tresnet.build_resnet50_train(depth=18, lr=0.01, **CIFAR)),
    "resnet18_nhwc": (
        lambda: jresnet.build_resnet50_train(depth=18, layout="NHWC",
                                             **CIFAR),
        lambda: tresnet.build_resnet50_train(depth=18, layout="NHWC",
                                             **CIFAR)),
}


def _dump(prog):
    return json.dumps(prog.to_dict(), sort_keys=True, indent=1)


@pytest.mark.parametrize("which", ["main", "startup"])
@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_program_json_identical_to_jax(name, which):
    jbuild, tbuild = BUILDERS[name]
    with jnames.guard():
        j = jbuild()
    with tnames.guard():
        t = tbuild()
    i = 0 if which == "main" else 1
    assert _dump(t[i]) == _dump(j[i])
    assert [v.name for v in t[3]] == [v.name for v in j[3]]


def test_resnet_program_has_the_counted_ops():
    with tnames.guard():
        prog = tresnet.build_resnet50_train(**CIFAR)[0]
    ops = prog.global_block().ops
    types = [op.type for op in ops]
    assert types.count("conv2d") == types.count("conv2d_grad") == 53
    assert types.count("batch_norm") == types.count("batch_norm_grad") == 53
    assert types.count("momentum") == 53 + 2 * 53 + 2
    one_by_one = [op for op in ops if op.type == "conv2d"
                  and prog.global_block().var(op.input("Filter")[0])
                  .shape[2:] == (1, 1)]
    # 16 conv3 + 16 conv1 + 4 shortcuts; stride 2 on 3 conv1 and 3
    # shortcuts
    assert len(one_by_one) == 36
    assert sum(op.attrs["strides"] == [1, 1] for op in one_by_one) == 30
    vel = [v.name for v in prog.list_vars()
           if getattr(v, "optimizer_state_for", None)]
    assert "conv2d_0.w_0_velocity_0" in vel and len(vel) == 161
    # recompute=True wraps each of the 16 bottlenecks in a region
    # (tests/test_torch_remat.py trains it against the JAX package)
    with tnames.guard():
        rprog = tresnet.build_resnet50_train(recompute=True, **CIFAR)[0]
    rtypes = [op.type for op in rprog.global_block().ops]
    assert rtypes.count("recompute") == rtypes.count("recompute_grad") == 16


# ---- op by op ----

class _Op:
    def __init__(self, type, attrs, uid=1):
        self.type, self.attrs, self.uid = type, attrs, uid
        self.inputs, self.outputs = {}, {}


def _grad_fn(reg, type):
    spec = reg.get(type)
    if spec.grad_lower is not None:
        return lambda ctx, ins, g, op: spec.grad_lower(ctx, ins, g,
                                                       op.attrs, op)
    return lambda ctx, ins, g, op: reg.generic_grad(ctx, spec, op, ins, g)


def _check(type, ins, attrs, grad_slots=(), cot_slots=("Out",), seed=0):
    """Forward of both lowerings on ``ins`` ({slot: [numpy]}), then both
    grads under the same random cotangents for ``cot_slots``."""
    op = _Op(type, attrs)
    jctx, tctx = JCtx(key=jax.random.PRNGKey(0)), TCtx(key=0)
    jins = {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}
    tins = {s: [torch.from_numpy(np.array(a)) for a in v]
            for s, v in ins.items()}
    jout = jreg.normalize_outputs(
        jreg.get(type).lower(jctx.for_op(op), jins, attrs, op))
    with torch.no_grad():
        tout = treg.normalize_outputs(
            treg.get(type).lower(tctx.for_op(op), tins, attrs, op))
    assert set(jout) == set(tout)
    for slot, vals in jout.items():
        for a, b in zip(vals, tout[slot]):
            a, b = np.asarray(a), b.numpy()
            assert a.shape == b.shape and a.dtype == b.dtype, slot
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5,
                                       err_msg=slot)
    if not grad_slots:
        return
    rng = np.random.RandomState(seed)
    jcot, tcot = {}, {}
    for slot in cot_slots:
        c = rng.randn(*np.asarray(jout[slot][0]).shape).astype(np.float32)
        jcot[slot], tcot[slot] = [jnp.asarray(c)], [torch.from_numpy(c)]
    jg = _grad_fn(jreg, type)(jctx.for_op(op), jins, jcot, op)
    tg = _grad_fn(treg, type)(tctx, tins, tcot, op)
    for slot in grad_slots:
        a, b = np.asarray(jg[slot][0]), tg[slot][0].numpy()
        assert a.shape == b.shape, slot
        np.testing.assert_allclose(b, a, rtol=1e-4,
                                   atol=1e-5 * max(np.abs(a).max(), 1e-30),
                                   err_msg="grad " + slot)


RNG = np.random.RandomState(0)


def _f(*shape):
    return RNG.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("kw", [
    dict(k=3, strides=[1, 1], paddings=[1, 1]),
    dict(k=7, strides=[2, 2], paddings=[3, 3]),         # the stem
    dict(k=1, strides=[1, 1], paddings=[0, 0]),
    dict(k=1, strides=[2, 2], paddings=[0, 0]),         # a shortcut
    dict(k=3, strides=[1, 1], paddings=[2, 2], dilations=[2, 2]),
    dict(k=3, strides=[1, 1], paddings=[1, 1], groups=2),
], ids=["3x3", "7x7s2", "1x1", "1x1s2", "dilated", "groups"])
def test_conv2d(kw, layout):
    kw = dict(kw)
    k, groups = kw.pop("k"), kw.get("groups", 1)
    x = _f(2, 4, 9, 9)
    if layout == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    attrs = {"dilations": [1, 1], "groups": 1, **kw}
    if layout == "NHWC":
        attrs["data_layout"] = "NHWC"
    _check("conv2d", {"Input": [x], "Filter": [_f(6, 4 // groups, k, k)]},
           attrs, grad_slots=("Input", "Filter"), cot_slots=("Output",))


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("attrs", [
    dict(pooling_type="max", ksize=[2, 2], strides=[2, 2], paddings=[0, 0]),
    dict(pooling_type="max", ksize=[3, 3], strides=[2, 2], paddings=[1, 1]),
    dict(pooling_type="max", ksize=[3, 3], strides=[2, 2], paddings=[0, 0],
         ceil_mode=True),
    dict(pooling_type="max", ksize=[2, 2], strides=[2, 2], paddings=[1, 1],
         ceil_mode=True),
    dict(pooling_type="avg", ksize=[2, 2], strides=[2, 2], paddings=[0, 0]),
    dict(pooling_type="avg", ksize=[3, 3], strides=[2, 2], paddings=[1, 1],
         exclusive=True),
    dict(pooling_type="avg", ksize=[3, 3], strides=[2, 2], paddings=[1, 1],
         exclusive=False),
    dict(pooling_type="avg", ksize=[3, 3], strides=[2, 2], paddings=[1, 1],
         exclusive=False, ceil_mode=True),
    dict(pooling_type="avg", ksize=[3, 3], strides=[3, 3], paddings=[0, 0],
         ceil_mode=True),
    dict(pooling_type="avg", ksize=[1, 1], global_pooling=True),
    dict(pooling_type="max", ksize=[1, 1], global_pooling=True),
], ids=["max2", "max3p1", "max_ceil", "max_p1_ceil", "avg2", "avg_excl",
        "avg_incl", "avg_incl_ceil", "avg_ceil", "global_avg", "global_max"])
def test_pool2d(attrs, layout):
    x = _f(2, 3, 8, 7)
    attrs = dict(attrs)
    if layout == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
        attrs["data_layout"] = "NHWC"
    _check("pool2d", {"X": [x]}, attrs, grad_slots=("X",))


def _bn_ins(layout, c=6):
    x = _f(4, c, 5, 3) * 2.0 + 0.5
    if layout == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    return {"X": [x], "Scale": [_f(c)], "Bias": [_f(c)],
            "Mean": [_f(c)], "Variance": [np.abs(_f(c)) + 0.5]}


@pytest.mark.parametrize("is_test", [False, True])
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_batch_norm_forward_and_handwritten_grad(layout, is_test):
    attrs = {"momentum": 0.9, "epsilon": 1e-5, "is_test": is_test,
             "data_layout": layout}
    _check("batch_norm", _bn_ins(layout), attrs,
           grad_slots=("X", "Scale", "Bias"), cot_slots=("Y",))


@pytest.mark.parametrize("tile", [None, 10, 7])
def test_batch_norm_grad_tagged_goes_through_bn_grad(tile, monkeypatch):
    """A tagged NHWC batch_norm_grad calls ``kernels.bn_grad.bn_grad``
    (its plain version here) and agrees with the JAX package's tagged
    lowering, which runs the Pallas kernel in interpret mode. tile 10
    divides the 60 rows; tile 7 warns in both packages."""
    calls = []
    real = tbn.bn_grad
    monkeypatch.setattr(tbn, "bn_grad",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    attrs = {"momentum": 0.9, "epsilon": 1e-5, "is_test": False,
             "data_layout": "NHWC", "use_pallas_reduction": True,
             "pallas_interpret": True}
    if tile is not None:
        attrs["pallas_tile"] = tile
    if tile == 7:
        with pytest.warns(RuntimeWarning, match="tile override"):
            _check("batch_norm", _bn_ins("NHWC"), attrs,
                   grad_slots=("X", "Scale", "Bias"), cot_slots=("Y",))
    else:
        _check("batch_norm", _bn_ins("NHWC"), attrs,
               grad_slots=("X", "Scale", "Bias"), cot_slots=("Y",))
    assert calls == [{"tile": tile}]
    # an NCHW op carrying the tag keeps the plain two-pass lowering
    calls.clear()
    _check("batch_norm", _bn_ins("NCHW"), dict(attrs, data_layout="NCHW"),
           grad_slots=("X",), cot_slots=("Y",))
    assert calls == []


def test_batch_norm_grad_equals_autograd_of_the_forward():
    """The hand-written grad against torch.autograd of the port's own
    forward lowering (float64, so the comparison is tight)."""
    ins = {s: [torch.from_numpy(v[0]).double()]
           for s, v in _bn_ins("NHWC").items()}
    attrs = {"epsilon": 1e-5, "data_layout": "NHWC"}
    op, ctx, spec = _Op("batch_norm", attrs), TCtx(key=0), \
        treg.get("batch_norm")
    dy = torch.from_numpy(_f(4, 5, 3, 6)).double()
    want = treg.generic_grad(ctx, spec, op, ins, {"Y": [dy]})
    got = spec.grad_lower(ctx, ins, {"Y": [dy]}, attrs, op)
    for slot in ("X", "Scale", "Bias"):
        torch.testing.assert_close(got[slot][0], want[slot][0].to(
            got[slot][0].dtype), rtol=1e-6, atol=1e-6)


def test_relu():
    _check("relu", {"X": [_f(3, 4, 5)]}, {}, grad_slots=("X",))


@pytest.mark.parametrize("nesterov", [False, True])
def test_momentum(nesterov):
    _check("momentum", {"Param": [_f(5, 3)], "Grad": [_f(5, 3)],
                        "Velocity": [_f(5, 3)],
                        "LearningRate": [np.array([0.1], np.float32)]},
           {"mu": 0.9, "use_nesterov": nesterov})


def test_sgd():
    _check("sgd", {"Param": [_f(5, 3)], "Grad": [_f(5, 3)],
                   "LearningRate": [np.array([0.1], np.float32)]}, {})


def test_gaussian_random_draws_the_asked_distribution():
    op = _Op("gaussian_random", {"shape": [200, 100], "dtype": "float32",
                                 "mean": 0.5, "std": 2.0, "seed": 0}, uid=3)
    ctx = TCtx(key=11)
    a = treg.get("gaussian_random").lower(ctx.for_op(op), {}, op.attrs, op)
    b = treg.get("gaussian_random").lower(ctx.for_op(op), {}, op.attrs, op)
    assert torch.equal(a, b)                  # one stream per (key, uid)
    assert abs(float(a.mean()) - 0.5) < 0.05
    assert abs(float(a.std()) - 2.0) < 0.05


# ---- whole programs ----

def _pair(name, damp=None):
    """Both packages' programs, and a port scope that holds the JAX
    startup's state. ``damp`` multiplies the scale of the last batch
    norm of every residual branch, in both scopes."""
    jbuild, tbuild = BUILDERS[name]
    with jnames.guard():
        jprog, jstart, _, jfetch = jbuild()
    with tnames.guard():
        tprog, tstart, _, tfetch = tbuild()
    jscope = jfluid.Scope()
    jexe = jfluid.Executor()
    jexe.run(jstart, scope=jscope)
    arrays = {v.name: np.asarray(jscope.find_var(v.name))
              for v in jprog.list_vars() if v.persistable}
    if damp is not None:
        ops = jprog.global_block().ops
        branch = {op.input("Y")[0] for op in ops
                  if op.type == "elementwise_add"}
        for op in ops:
            if op.type == "batch_norm" and op.output("Y")[0] in branch:
                n = op.input("Scale")[0]
                arrays[n] = arrays[n] * np.float32(damp)
                jscope.set_var(n, jnp.asarray(arrays[n]))
    tscope = tfluid.Scope()
    loaded = interop.load_reference_state(arrays, tscope, CPU,
                                          [tprog, tstart])
    return dict(jprog=jprog, jexe=jexe, jscope=jscope, jfetch=jfetch,
                tprog=tprog, texe=tfluid.Executor(CPU), tscope=tscope,
                tfetch=tfetch, loaded=loaded)


def _train_and_compare(m, feed, steps, loss_rtol, gtol, l2tol, stat_atol,
                       stat_of_max=False):
    """``stat_of_max``: ``stat_atol`` is a share of each running
    statistic's largest magnitude (for runs whose statistics grow);
    None compares no statistics."""
    params = sorted(p.name for p in m["jprog"].global_block().all_parameters())
    grads = [p + "@GRAD" for p in params]
    jl, tl = [], []
    for step in range(steps):
        extra = grads if step == 0 else []
        jout = m["jexe"].run(m["jprog"], feed=feed,
                             fetch_list=[m["jfetch"][0].name] + extra,
                             scope=m["jscope"])
        tout = m["texe"].run(m["tprog"], feed=feed,
                             fetch_list=[m["tfetch"][0].name] + extra,
                             scope=m["tscope"])
        jl.append(float(np.asarray(jout[0])))
        tl.append(float(tout[0]))
        num = den = 0.0
        for name, jg, tg in zip(extra, jout[1:], tout[1:]):
            jg = np.asarray(jg)
            np.testing.assert_allclose(
                tg, jg, rtol=0, atol=gtol * np.abs(jg).max(), err_msg=name)
            num += float(((tg - jg) ** 2).sum())
            den += float((jg ** 2).sum())
        if extra:
            assert (num / den) ** 0.5 < l2tol
    # loss_rtol: one bound, or one for each step
    assert (np.abs(np.subtract(tl, jl))
            <= np.asarray(loss_rtol) * np.abs(jl)).all(), (tl, jl)
    assert np.isfinite(tl).all()
    m["jax_losses"] = jl
    stats = [n for n in m["loaded"] if n.endswith((".mean", ".variance"))]
    for n in stats if stat_atol is not None else []:
        want = np.asarray(m["jscope"].find_var(n))
        np.testing.assert_allclose(
            m["tscope"].find_var(n).numpy(), want, rtol=0,
            atol=stat_atol * (np.abs(want).max() if stat_of_max else 1.0),
            err_msg=n)
    return tl, stats


def test_mnist_cnn_steps_match_jax():
    rng = np.random.RandomState(3)
    m = _pair("mnist_cnn")
    feed = {"img": rng.rand(8, 1, 28, 28).astype(np.float32),
            "label": rng.randint(0, 10, (8, 1)).astype(np.int64)}
    losses, _ = _train_and_compare(m, feed, 3, loss_rtol=1e-5, gtol=1e-4,
                                   l2tol=1e-4, stat_atol=1e-5)
    assert losses[-1] < losses[0]


def test_resnet_cifar_momentum_steps_match_jax():
    """3 Momentum steps of the ``resnet_cifar`` program (ResNet-50 at
    32x32, 10 classes; batch 8) in its plain NCHW form; the tolerances
    are the module docstring's."""
    rng = np.random.RandomState(0)
    m = _pair("resnet_cifar", damp=0.03)
    assert len([n for n in m["loaded"] if n.endswith("_velocity_0")]) == 161
    feed = {"data": rng.randn(8, 3, 32, 32).astype(np.float32),
            "label": rng.randint(0, 10, (8, 1)).astype(np.int64)}
    tk1.reset_launches()
    losses, stats = _train_and_compare(m, feed, 3, loss_rtol=1e-3,
                                       gtol=5e-2, l2tol=2e-3,
                                       stat_atol=1e-3)
    assert len(stats) == 2 * 53
    assert tk1.launches == {"conv1x1_bwd": 0}
    lr = [n for n in m["loaded"] if n.startswith("learning_rate")]
    assert float(m["tscope"].find_var(lr[0])[0]) == pytest.approx(0.1)


def _cifar_feed(seed=0):
    rng = np.random.RandomState(seed)
    return {"data": rng.randn(8, 3, 32, 32).astype(np.float32),
            "label": rng.randint(0, 10, (8, 1)).astype(np.int64)}


def test_resnet18_momentum_steps_match_jax_and_overshoot_in_both():
    """No weight edited: 4 Momentum steps at lr 0.1 from the JAX
    startup's weights. The loss rises at the second and fourth step in
    BOTH packages: the overshoot is the model's, not the port's. The
    two runs part ways as it does (the fourth losses differ by 4e-3), so
    the running statistics are compared in the lr 0.01 run below."""
    m = _pair("resnet18")
    tl, _ = _train_and_compare(
        m, _cifar_feed(), 4, loss_rtol=[1e-4, 1e-4, 2e-3, 2e-2], gtol=5e-4,
        l2tol=2e-4, stat_atol=None)
    for losses in (tl, m["jax_losses"]):
        assert losses[1] > losses[0] and losses[3] > losses[0]
        assert losses[2] < losses[0]


def test_resnet18_low_lr_loss_falls_at_every_step_in_both():
    m = _pair("resnet18_low_lr")
    tl, stats = _train_and_compare(
        m, _cifar_feed(), 3, loss_rtol=[1e-4, 1e-3, 1e-1], gtol=5e-4,
        l2tol=2e-4, stat_atol=5e-3, stat_of_max=True)
    assert len(stats) == 2 * 20
    for losses in (tl, m["jax_losses"]):
        assert (np.diff(losses) < 0).all()


def test_resnet50_first_step_at_lr_01_saturates_the_loss_in_both():
    """No weight edited: one Momentum step at lr 0.1 sends ResNet-50's
    loss on the repeated batch to the cross entropy's clip, in the JAX
    package as in the port."""
    m = _pair("resnet_cifar")
    feed = _cifar_feed()
    jl = [float(np.asarray(m["jexe"].run(
        m["jprog"], feed=feed, fetch_list=[m["jfetch"][0].name],
        scope=m["jscope"])[0])) for _ in range(2)]
    tl = [float(m["texe"].run(
        m["tprog"], feed=feed, fetch_list=[m["tfetch"][0].name],
        scope=m["tscope"])[0]) for _ in range(2)]
    np.testing.assert_allclose(tl[0], jl[0], rtol=1e-3)
    assert jl[0] < 5 and tl[0] < 5
    assert jl[1] > 20 and tl[1] > 20
    np.testing.assert_allclose(tl[1], jl[1], rtol=1e-3)


def _grad_distance(got, want):
    """(worst entry as a share of its gradient's largest magnitude, all
    gradients together in relative L2 norm)."""
    worst = num = den = 0.0
    for g, w in zip(got, want):
        worst = max(worst, float(np.abs(g - w).max())
                    / float(np.abs(w).max()))
        num += float(((g - w) ** 2).sum())
        den += float((w ** 2).sum())
    return worst, (num / den) ** 0.5


@pytest.mark.parametrize("name,damp,worst_band,l2_band", [
    ("resnet18", None, (5e-2, 1.0), (5e-3, 1e-1)),
    ("resnet_cifar", None, (5e-2, 1.0), (5e-3, 1e-1)),
    ("resnet_cifar", 0.03, (0.0, 5e-2), (0.0, 1e-3)),
], ids=["depth18", "depth50", "depth50_damped"])
def test_a_1e6_input_change_moves_first_step_gradients(name, damp,
                                                       worst_band, l2_band):
    """Why ResNet-50's gradients are compared damped: the port against
    itself on the CPU, the input moved by 1e-6 in every element.
    Measured (worst entry, all together): depth 18 0.39, 2.7e-2; depth
    50 0.19, 2.2e-2; depth 50 damped 3.3e-2, 2.4e-4."""
    m = _pair(name, damp=damp)
    feed = _cifar_feed()
    grads = sorted(p.name + "@GRAD"
                   for p in m["tprog"].global_block().all_parameters())
    state = {n: t.clone() for n, t in m["tscope"].vars.items()}
    base = m["texe"].run(m["tprog"], feed=feed, fetch_list=grads,
                         scope=m["tscope"])
    for n, t in state.items():
        m["tscope"].set_var(n, t)
    sign = np.sign(np.random.RandomState(1).randn(*feed["data"].shape))
    moved = dict(feed, data=feed["data"] + np.float32(1e-6)
                 * sign.astype(np.float32))
    got = m["texe"].run(m["tprog"], feed=moved, fetch_list=grads,
                        scope=m["tscope"])
    worst, l2 = _grad_distance(got, base)
    assert worst_band[0] <= worst <= worst_band[1], (worst, l2)
    assert l2_band[0] <= l2 <= l2_band[1], (worst, l2)


@pytest.mark.parametrize("shape", [(8, 512, 1, 1), (8, 64, 16, 16)])
def test_batch_statistics_against_float64(shape):
    """Both packages' one-pass batch statistics against numpy float64:
    the port's mean within 5e-7 and variance within 2e-6 relative, the
    JAX package's CPU sums within 1e-5 (measured at [8,64,16,16]: mean
    1.1e-7 against 1.9e-6, variance 3.9e-7 against 4.5e-6)."""
    c = shape[1]
    x = (np.random.RandomState(0).randn(*shape) + 1.0).astype(np.float32)
    ins = {"X": [x], "Scale": [np.ones(c, np.float32)],
           "Bias": [np.zeros(c, np.float32)],
           "Mean": [np.zeros(c, np.float32)],
           "Variance": [np.ones(c, np.float32)]}
    attrs = {"momentum": 0.9, "epsilon": 1e-5, "is_test": False,
             "data_layout": "NCHW"}
    op = _Op("batch_norm", attrs)
    j = jreg.normalize_outputs(jreg.get("batch_norm").lower(
        JCtx(key=jax.random.PRNGKey(0)).for_op(op),
        {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}, attrs, op))
    with torch.no_grad():
        t = treg.normalize_outputs(treg.get("batch_norm").lower(
            TCtx(key=0).for_op(op),
            {s: [torch.from_numpy(a) for a in v] for s, v in ins.items()},
            attrs, op))
    x64 = x.astype(np.float64)
    mean, var = x64.mean((0, 2, 3)), x64.var((0, 2, 3))
    for out, mean_tol, var_tol in ((t, 5e-7, 2e-6), (j, 1e-5, 1e-5)):
        got_mean = np.asarray(out["SavedMean"][0], np.float64)
        got_var = np.asarray(out["SavedVariance"][0], np.float64)
        assert np.abs(got_mean - mean).max() <= mean_tol
        assert (np.abs(got_var - var) / var).max() <= var_tol
