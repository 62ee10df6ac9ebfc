"""The rest of the convnet family on the CPU against the JAX package:
the ``lrn``, ``dropout`` and ``depthwise_conv2d`` ops, and VGG-16,
AlexNet, GoogLeNet and SmallNet trained from the JAX startup's weights.

Tolerances. Op by op as tests/test_torch_convnet.py holds conv2d:
forward 1e-5, gradients rtol 1e-4 with an atol of 1e-5 of the
gradient's largest magnitude (float32 in another summation order).
Whole models: the losses of 3 steps within rtol 1e-5 (``loss_rtol``
gives each step its own where the runs part), every first-step
parameter gradient within ``gtol`` of its largest magnitude and all of
them together within ``l2tol`` in relative L2 norm. ``gtol`` is 1e-4
for SmallNet and AlexNet. VGG-16 and GoogLeNet at their initial weights
turn a rounding difference into flipped relu gates and max-pool
choices: a 1e-6 change of the input moves the port's own gradients by
up to 4.3e-3 (VGG-16) and 1.8e-2 (GoogLeNet) of their largest magnitude,
and by 1.4e-3 and 1.6e-3 all together
(``test_a_1e6_input_change_moves_the_gradients`` pins it), so they are
held to gtol 1e-3 and 5e-2, l2tol 1e-3 and 5e-3; their later losses
part as the first step's gradients do, and more as the loss climbs
(GoogLeNet's rises from 7.9 to 24 in both packages, VGG-16's under Adam
at lr 0.01 from 2.1 to 14.5-14.9): measured 8.7e-5 at GoogLeNet's third
step, 1.2e-3 and 2.4e-2 at VGG-16's second and third. A conv or fc bias that
a batch norm follows has a gradient that vanishes in exact arithmetic
(VGG-16: 14 of them, measured at 2e-8 to 2e-6): it is held below 1e-5 of
the program's largest gradient in both packages instead.

The port cannot reproduce the JAX package's random stream (different
generators from one seed), so the models with dropout (VGG-16, AlexNet)
are held against the JAX package with every ``dropout`` op set to
``is_test`` in both programs, and ``dropout`` itself by its own tests:
the realised keep share, ``Mask`` where ``Out`` is nonzero, the
1/256-quantised keep threshold and its edges, and a grad that redraws
the forward's mask.
"""

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
from paddle_tpu.models import alexnet as jalexnet
from paddle_tpu.models import googlenet as jgooglenet
from paddle_tpu.models import smallnet as jsmallnet
from paddle_tpu.models import vgg as jvgg
from paddle_tpu_torch import interop
from paddle_tpu_torch import unique_name as tnames
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.infer import infer_op_shapes
from paddle_tpu_torch.core.lower import TraceContext as TCtx
from paddle_tpu_torch.models import alexnet as talexnet
from paddle_tpu_torch.models import googlenet as tgooglenet
from paddle_tpu_torch.models import smallnet as tsmallnet
from paddle_tpu_torch.models import vgg as tvgg

# Under pytest-xdist each worker takes its share of the cores for
# torch's intra-op threads: six workers at torch's default thread count
# oversubscribe the cores, and a test of seconds then takes minutes.
_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, os.cpu_count() // int(_WORKERS)))

CPU = tfluid.CPUPlace()


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


# ---- ops ----

@pytest.mark.parametrize("attrs", [
    dict(n=5, k=1.0, alpha=1e-4, beta=0.75),      # AlexNet's
    dict(n=3, k=2.0, alpha=0.5, beta=0.5),
    dict(n=5, k=1.0, alpha=1e-1, beta=0.75)], ids=["alexnet", "n3", "wide"])
def test_lrn(attrs):
    _check("lrn", {"X": [_f(2, 7, 5, 4) * 3.0]}, attrs, grad_slots=("X",))


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("stride", [1, 2])
def test_depthwise_conv2d(layout, stride):
    x = _f(2, 6, 9, 7)
    if layout == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    attrs = {"strides": [stride, stride], "paddings": [1, 1],
             "dilations": [1, 1], "groups": 6, "data_layout": layout}
    _check("depthwise_conv2d", {"Input": [x], "Filter": [_f(6, 1, 3, 3)]},
           attrs, grad_slots=("Input", "Filter"), cot_slots=("Output",))


@pytest.mark.parametrize("impl", ["downgrade_in_infer", "upscale_in_train"])
@pytest.mark.parametrize("p", [0.0, 0.3, 0.5])
def test_dropout_at_test_time_matches_jax(p, impl):
    """No draw at test time: downgrade scales by 1 - p, upscale is the
    identity; Mask is all ones. Forward and grad against the JAX
    lowering."""
    attrs = {"dropout_prob": p, "is_test": True, "seed": 0,
             "dropout_implementation": impl}
    _check("dropout", {"X": [_f(4, 5, 6)]}, attrs, grad_slots=("X",))


def _dropout(x, p, impl, uid=7, key=11, training=True):
    op = _Op("dropout", {"dropout_prob": p, "is_test": False, "seed": 0,
                         "dropout_implementation": impl}, uid=uid)
    ctx = TCtx(key=key, training=training).for_op(op)
    return treg.get("dropout").lower(ctx, {"X": [x]}, op.attrs, op), op


@pytest.mark.parametrize("impl", ["downgrade_in_infer", "upscale_in_train"])
@pytest.mark.parametrize("p", [0.3, 0.5, 0.9])
def test_dropout_keeps_its_quantised_share_and_masks_out(p, impl):
    """Over 2^18 elements the kept share is round((1-p) 256) / 256
    within 4 standard deviations; Mask is 1 exactly where Out is
    nonzero (x has no zeros); upscale divides by the realised keep."""
    x = torch.rand(512, 512, generator=torch.Generator().manual_seed(0)) \
        + 0.5
    out, _ = _dropout(x, p, impl)
    mask, y = out["Mask"], out["Out"]
    keep = round((1.0 - p) * 256) / 256.0
    share = float(mask.mean())
    assert abs(share - keep) < 4 * (keep * (1 - keep) / x.numel()) ** 0.5
    assert torch.equal(mask, (y != 0).to(mask.dtype))
    assert mask.dtype == x.dtype
    want = x * mask / keep if impl == "upscale_in_train" else x * mask
    assert torch.equal(y, want)


def test_dropout_threshold_clamps_at_both_edges():
    """keep < 1/512 still keeps 1/256 (threshold 1, upscale divides by
    1/256, not by the nominal keep); keep > 511/512 rounds to keeping
    everything."""
    x = torch.rand(256, 256, generator=torch.Generator().manual_seed(1)) \
        + 0.5
    out, _ = _dropout(x, 0.999, "upscale_in_train")
    share = float(out["Mask"].mean())
    assert 0 < share < 4.0 / 256
    kept = out["Mask"] != 0
    torch.testing.assert_close(out["Out"][kept], x[kept] * 256.0)
    out, _ = _dropout(x, 0.001, "upscale_in_train")
    assert torch.equal(out["Mask"], torch.ones_like(x))
    assert torch.equal(out["Out"], x)


def test_dropout_stream_is_per_step_and_op_and_the_grad_redraws_it():
    """The same (step key, uid) draws the same mask, another uid or step
    another; the generic grad recomputes the forward under the forward
    op's uid, so its gradient is dy * mask (downgrade) from the same
    draw."""
    x = torch.rand(64, 64, generator=torch.Generator().manual_seed(2)) + 0.5
    a, op = _dropout(x, 0.5, "downgrade_in_infer")
    b, _ = _dropout(x, 0.5, "downgrade_in_infer")
    c, _ = _dropout(x, 0.5, "downgrade_in_infer", uid=8)
    d, _ = _dropout(x, 0.5, "downgrade_in_infer", key=12)
    assert torch.equal(a["Mask"], b["Mask"])
    assert not torch.equal(a["Mask"], c["Mask"])
    assert not torch.equal(a["Mask"], d["Mask"])
    dy = torch.randn(64, 64, generator=torch.Generator().manual_seed(3))
    g = treg.generic_grad(TCtx(key=11), treg.get("dropout"), op,
                          {"X": [x]}, {"Out": [dy]})
    assert torch.equal(g["X"][0], dy * a["Mask"])
    # in an eval run (training=False) nothing is drawn
    e, _ = _dropout(x, 0.5, "downgrade_in_infer", training=False)
    assert torch.equal(e["Out"], x * 0.5)


@pytest.mark.parametrize("type,attrs,outs", [
    ("lrn", {"n": 5, "k": 1.0, "alpha": 1e-4, "beta": 0.75},
     ("Out", "MidOut")),
    ("dropout", {"dropout_prob": 0.5, "is_test": False, "seed": 0,
                 "dropout_implementation": "downgrade_in_infer"},
     ("Out", "Mask"))])
def test_shapes_and_dtypes_infer_as_in_jax(type, attrs, outs):
    """The layers record what the JAX package's build records (shapes
    with -1 for the batch, float32)."""
    import paddle_tpu.layers as jl
    import paddle_tpu_torch.layers as tl

    decl = []
    for fluid, layers, names in ((jfluid, jl, jnames),
                                 (tfluid, tl, tnames)):
        with names.guard():
            prog = fluid.Program()
            with fluid.program_guard(prog, fluid.Program()):
                x = layers.data("x", [6, 5, 4])
                if type == "lrn":
                    layers.lrn(x, n=5)
                else:
                    layers.dropout(x, 0.5)
        op = prog.global_block().ops[-1]
        decl.append([(prog.global_block().var(op.output(s)[0]).shape,
                      prog.global_block().var(op.output(s)[0]).dtype)
                     for s in outs])
        if fluid is tfluid:
            b0 = prog.global_block()
            for s in outs:
                b0.var(op.output(s)[0]).shape = None
            infer_op_shapes(b0, op)
            assert [(b0.var(op.output(s)[0]).shape,
                     b0.var(op.output(s)[0]).dtype)
                    for s in outs] == decl[-1]
    assert decl[0] == decl[1] == [((-1, 6, 5, 4), "float32")] * 2


# ---- whole models ----

# name: (image shape, JAX builder, port builder, gtol, l2tol, loss_rtol)
MODELS = {
    "smallnet": ((3, 32, 32), lambda: jsmallnet.build_smallnet_train(),
                 lambda: tsmallnet.build_smallnet_train(), 1e-4, 1e-4, 1e-5),
    "smallnet_64": (
        (3, 64, 64),
        lambda: jsmallnet.build_smallnet_train(image_shape=(3, 64, 64)),
        lambda: tsmallnet.build_smallnet_train(image_shape=(3, 64, 64)),
        1e-4, 1e-4, 1e-5),
    "googlenet": (
        (3, 64, 64),
        lambda: jgooglenet.build_googlenet_train(image_shape=(3, 64, 64),
                                                 class_dim=10),
        lambda: tgooglenet.build_googlenet_train(image_shape=(3, 64, 64),
                                                 class_dim=10), 5e-2, 5e-3,
        [1e-5, 2e-4, 2e-4]),
    "vgg16": (
        (3, 32, 32),
        lambda: jvgg.build_vgg16_train(image_shape=(3, 32, 32),
                                       class_dim=10),
        lambda: tvgg.build_vgg16_train(image_shape=(3, 32, 32),
                                       class_dim=10), 1e-3, 1e-3,
        [1e-5, 5e-3, 5e-2]),
    "alexnet": (
        (3, 67, 67),
        lambda: jalexnet.build_alexnet_train(image_shape=(3, 67, 67),
                                             class_dim=10),
        lambda: talexnet.build_alexnet_train(image_shape=(3, 67, 67),
                                             class_dim=10), 1e-4, 1e-4, 1e-5),
}


def _dropout_to_test_mode(prog):
    n = 0
    for op in prog.global_block().ops:
        if op.type in ("dropout", "dropout_grad"):
            op.attrs["is_test"] = True
            n += op.type == "dropout"
    return n


def _pair(name):
    shape, jbuild, tbuild = MODELS[name][:3]
    with jnames.guard():
        jprog, jstart, _, (jloss, _) = jbuild()
    with tnames.guard():
        tprog, tstart, _, (tloss, _) = tbuild()
    dropouts = (_dropout_to_test_mode(jprog), _dropout_to_test_mode(tprog))
    assert dropouts == {"vgg16": (10, 10), "alexnet": (2, 2)}.get(
        name, (0, 0))
    jscope = jfluid.Scope()
    jexe = jfluid.Executor()
    jexe.run(jstart, scope=jscope)
    arrays = {v.name: np.asarray(jscope.find_var(v.name))
              for v in jprog.list_vars() if v.persistable}
    rng = np.random.RandomState(0)
    feed = {"data": rng.randn(4, *shape).astype(np.float32),
            "label": rng.randint(0, 10, (4, 1)).astype(np.int64)}
    grads = sorted(p.name + "@GRAD"
                   for p in jprog.global_block().all_parameters())
    return dict(jprog=jprog, jexe=jexe, jscope=jscope, jloss=jloss,
                tprog=tprog, tstart=tstart, tloss=tloss, arrays=arrays,
                feed=feed, grads=grads)


def _port_run(m, feed, steps):
    tscope = tfluid.Scope()
    interop.load_reference_state(m["arrays"], tscope, CPU,
                                 [m["tprog"], m["tstart"]])
    texe = tfluid.Executor(CPU)
    return [texe.run(m["tprog"], feed=feed, fetch_list=[m["tloss"].name]
                     + (m["grads"] if step == 0 else []), scope=tscope)
            for step in range(steps)]


def _distance(got, want):
    """Worst entry as a share of its gradient's largest magnitude, and
    all together in relative L2 norm."""
    worst = num = den = 0.0
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        worst = max(worst, float(np.abs(g - w).max() / np.abs(w).max()))
        num += float(((g - w) ** 2).sum())
        den += float((w ** 2).sum())
    return worst, (num / den) ** 0.5


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_steps_match_jax(name):
    gtol, l2tol, loss_rtol = MODELS[name][3:]
    m = _pair(name)
    jout = [m["jexe"].run(m["jprog"], feed=m["feed"],
                          fetch_list=[m["jloss"].name]
                          + (m["grads"] if step == 0 else []),
                          scope=m["jscope"]) for step in range(3)]
    tout = _port_run(m, m["feed"], 3)
    jg = [np.asarray(g) for g in jout[0][1:]]
    tg = tout[0][1:]
    assert all(g.dtype == np.float32 for g in tg)
    top = max(float(np.abs(g).max()) for g in jg)
    vanishing = [i for i, g in enumerate(jg) if np.abs(g).max() < 1e-5 * top]
    assert len(vanishing) == (14 if name == "vgg16" else 0)
    for i in vanishing:
        assert np.abs(tg[i]).max() < 1e-5 * top, m["grads"][i]
    keep = [i for i in range(len(jg)) if i not in vanishing]
    for i in keep:
        np.testing.assert_allclose(tg[i], jg[i], rtol=0,
                                   atol=gtol * np.abs(jg[i]).max(),
                                   err_msg=m["grads"][i])
    assert _distance([tg[i] for i in keep], [jg[i] for i in keep])[1] \
        < l2tol
    tl = np.array([float(t[0]) for t in tout])
    jl = np.array([float(np.asarray(j[0])) for j in jout])
    assert (np.abs(tl - jl) <= np.asarray(loss_rtol) * np.abs(jl)).all(), \
        (tl, jl)
    assert np.isfinite(tl).all()


@pytest.mark.parametrize("name,worst_band,l2_band", [
    ("googlenet", (5e-3, 5e-2), (5e-4, 5e-3)),
    ("vgg16", (1e-3, 5e-2), (5e-4, 5e-3))])
def test_a_1e6_input_change_moves_the_gradients(name, worst_band, l2_band):
    """Why GoogLeNet and VGG-16 are held looser: the port against
    itself, the input moved by 1e-6 in every element, moves the
    first-step gradients (those that do not vanish) by as much as the
    tolerances allow. Measured (worst entry, all together): GoogLeNet
    1.8e-2, 1.6e-3; VGG-16 4.3e-3, 1.4e-3."""
    m = _pair(name)
    sign = np.sign(np.random.RandomState(1).randn(*m["feed"]["data"].shape))
    moved = dict(m["feed"], data=m["feed"]["data"]
                 + np.float32(1e-6) * sign.astype(np.float32))
    base = _port_run(m, m["feed"], 1)[0][1:]
    got = _port_run(m, moved, 1)[0][1:]
    top = max(float(np.abs(g).max()) for g in base)
    keep = [i for i, g in enumerate(base) if np.abs(g).max() >= 1e-5 * top]
    worst, l2 = _distance([got[i] for i in keep], [base[i] for i in keep])
    assert worst_band[0] < worst < worst_band[1], worst
    assert l2_band[0] < l2 < l2_band[1], l2
