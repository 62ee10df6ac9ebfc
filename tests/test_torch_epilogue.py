"""The conv-epilogue fusion (``passes/epilogue.py``, the fused
``conv2d_bn_act`` op) on the CPU.

* ``passes.apply`` gives the JAX package's transformed program as JSON
  (ResNet-18 and ResNet-50 under layout + epilogue + reductions, the
  epilogue alone, and with a tile knob), with the same rewrite counts
  and the same tagged ops.
* The fused program is BITWISE the unfused one over 3 steps, as
  tests/test_passes.py holds it in the JAX package: NHWC, NCHW,
  depthwise, under mixed precision, and with the fused 1x1 backward's
  flag on; a fetched intermediate blocks the fusion.
* A tagged ``conv2d_bn_act_grad`` goes through ``kernels.bn_grad``
  (its plain version here), and a fused 1x1 stride-1 NCHW conv through
  ``kernels.conv1x1_bwd`` (its plain version here) with the flag on.
* The fused op, forward and hand-chained grad, against the JAX
  package's lowering on the same numpy inputs: forward 1e-5, gradients
  rtol 1e-4 with an atol of 1e-5 of the gradient's largest magnitude
  (float32 in another summation order), as tests/test_torch_convnet.py
  holds conv2d and batch_norm; the fused block net's 3 SGD steps
  against the JAX package's fused run within rtol 1e-5.
"""

import collections
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import layers as jlayers
from paddle_tpu import passes as jpasses
from paddle_tpu import unique_name as jnames
from paddle_tpu.core import registry as jreg
from paddle_tpu.core.lower import TraceContext as JCtx
from paddle_tpu.models import resnet as jresnet
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import interop
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import passes as tpasses
from paddle_tpu_torch import unique_name as tnames
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.infer import infer_op_shapes
from paddle_tpu_torch.core.lower import TraceContext as TCtx
from paddle_tpu_torch.kernels import bn_grad as tbn
from paddle_tpu_torch.kernels import conv1x1_bwd as tk1
from paddle_tpu_torch.models import resnet as tresnet

# Under pytest-xdist each worker takes its share of the cores for
# torch's intra-op threads: six workers at torch's default thread count
# oversubscribe the cores, and a test of seconds then takes minutes.
_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, os.cpu_count() // int(_WORKERS)))

CPU = tfluid.CPUPlace()


def _dump(prog):
    return json.dumps(prog.to_dict(), sort_keys=True, indent=1)


def _census(prog):
    return collections.Counter(op.type for op in prog.global_block().ops)


def _conv_block_net(fluid, layers, spatial=8, pointwise=False):
    """tests/test_passes.py's conv + bn + residual + relu block with a
    global-pool head; ``pointwise`` makes the fused conv 1x1."""
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        img = layers.data("img", [3, spatial, spatial])
        label = layers.data("label", [1], dtype="int64")
        short = layers.conv2d(img, 8, 1, act=None, bias_attr=False)
        c = layers.conv2d(img, 8, 1 if pointwise else 3,
                          padding=0 if pointwise else 1, act=None,
                          bias_attr=False)
        bn = layers.batch_norm(c, act=None)
        bn = layers.elementwise_add(short, bn, act="relu")
        pool = layers.pool2d(bn, pool_size=spatial, pool_type="avg",
                             global_pooling=True)
        fc = layers.fc(pool, size=10, act="softmax")
        loss = layers.mean(layers.cross_entropy(fc, label))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return prog, startup, loss


def _depthwise_block_net(fluid, layers, spatial=8, channels=8):
    """depthwise_conv2d + bn + residual + relu, the conv op appended raw
    (the layers API has no depthwise helper)."""
    if fluid is tfluid:
        from paddle_tpu_torch.initializer import Normal
        from paddle_tpu_torch.layer_helper import LayerHelper
    else:
        from paddle_tpu.initializer import Normal
        from paddle_tpu.layer_helper import LayerHelper
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        img = layers.data("img", [channels, spatial, spatial])
        label = layers.data("label", [1], dtype="int64")
        helper = LayerHelper("depthwise_conv2d")
        w = helper.create_parameter(
            helper.param_attr, [channels, 1, 3, 3], img.dtype,
            default_initializer=Normal(0.0, 0.1))
        cout = helper.create_variable_for_type_inference(img.dtype)
        helper.append_op(
            "depthwise_conv2d", {"Input": [img], "Filter": [w]},
            {"Output": [cout]},
            {"strides": [1, 1], "paddings": [1, 1],
             "dilations": [1, 1], "groups": channels})
        bn = layers.batch_norm(cout, act=None)
        bn = layers.elementwise_add(img, bn, act="relu")
        pool = layers.pool2d(bn, pool_size=spatial, pool_type="avg",
                             global_pooling=True)
        fc = layers.fc(pool, size=10, act="softmax")
        loss = layers.mean(layers.cross_entropy(fc, label))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return prog, startup, loss


def _feed(channels=3, spatial=8, batch=4, nhwc=False):
    rng = np.random.RandomState(0)
    x = rng.rand(batch, channels, spatial, spatial).astype(np.float32)
    y = rng.randint(0, 10, (batch, 1)).astype(np.int64)
    if nhwc:
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    return {"img": x, "label": y}


def _run_steps(prog, startup, loss, feed, n=3, fetch=()):
    """Losses of ``n`` steps from the startup's weights (the same program
    uids draw the same weights), and the last step's ``fetch``."""
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    losses, extra = [], []
    for _ in range(n):
        out = exe.run(prog, feed=feed, fetch_list=[loss.name] + list(fetch),
                      scope=scope)
        losses.append(float(out[0]))
        extra = out[1:]
    return losses, extra


def _pair(net, cfg_ref, cfg_fused, amp=False):
    progs = []
    for cfg in (cfg_ref, cfg_fused):
        with tnames.guard():
            prog, startup, loss = net(tfluid, tlayers)
        if cfg is not None:
            tpasses.enable(prog, **cfg)
        if amp:
            tfluid.amp.enable(prog)
        progs.append((prog, startup, loss))
    return progs


# ---- the transformed program ----

CONFIGS = {
    "layout_epilogue_reductions": (
        dict(layout="NHWC"),
        dict(layout="NHWC", epilogue_fusion=True, pallas_reductions=True,
             interpret=True)),
    "epilogue_nchw": ({}, dict(epilogue_fusion=True)),
    "epilogue_tile": (
        dict(layout="NHWC"),
        dict(layout="NHWC", epilogue_fusion=True, pallas_reductions=True,
             interpret=True,
             kernel_params=[("conv2d_bn_act_grad", "tile", 4),
                            ("batch_norm_grad", "tile", 2)])),
}


@pytest.mark.parametrize("depth,spatial,want", [
    (18, 16, (17, 3)), (50, 32, (49, 4))])
@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_apply_gives_the_jax_packages_program(cfg, depth, spatial, want):
    build_kw, kw = CONFIGS[cfg]
    size = dict(image_shape=(3, spatial, spatial), class_dim=10,
                depth=depth, **build_kw)
    with jnames.guard():
        jprog, _, _, jfetch = jresnet.build_resnet50_train(**size)
    with tnames.guard():
        tprog, _, _, tfetch = tresnet.build_resnet50_train(**size)
    jpasses.enable(jprog, **kw)
    tpasses.enable(tprog, **kw)
    assert tpasses.plan_for(tprog).key == jpasses.plan_for(jprog).key
    jout, jreport = jpasses.apply(jprog, protected=[jfetch[0].name])
    tout, treport = tpasses.apply(tprog, protected=[tfetch[0].name])
    assert treport == jreport
    assert treport["epilogue"] == want[0]
    assert _dump(tout) == _dump(jout)
    cnt = _census(tout)
    assert cnt["conv2d_bn_act"] == cnt["conv2d_bn_act_grad"] == want[0]
    # in each block with a projection shortcut the matcher meets the
    # shortcut first and fuses it with the main branch's last bn output
    # as its residual, so that last conv + bn stays unfused
    assert cnt["conv2d"] == cnt["batch_norm"] == want[1]
    tagged = [op.type for op in tout.global_block().ops
              if op.attrs.get("use_pallas_reduction")]
    assert tagged == [op.type for op in jout.global_block().ops
                      if op.attrs.get("use_pallas_reduction")]
    if kw.get("pallas_reductions"):
        assert collections.Counter(tagged) == {
            "conv2d_bn_act_grad": want[0], "batch_norm_grad": want[1]}
    else:
        assert tagged == []


def test_resnet18_fused_epilogues_census():
    with tnames.guard():
        prog, _, _, fet = tresnet.build_resnet50_train(
            image_shape=(3, 16, 16), class_dim=10, depth=18, layout="NHWC")
    tpasses.enable(prog, layout="NHWC", epilogue_fusion=True)
    out, report = tpasses.apply(prog, protected=[fet[0].name])
    cnt = _census(out)
    assert cnt["conv2d_bn_act"] >= 16, dict(cnt)
    assert cnt["conv2d_bn_act_grad"] == cnt["conv2d_bn_act"]
    assert report["epilogue"] == cnt["conv2d_bn_act"]
    fused = [op for op in out.global_block().ops
             if op.type == "conv2d_bn_act"]
    assert {op.attrs["act"] for op in fused} == {"relu"}
    assert sum(op.attrs["with_residual"] for op in fused) == 8


# ---- bitwise against the unfused program ----

@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
def test_bitwise_parity_and_census(layout):
    """3 SGD steps of the fused program BITWISE equal to the unfused
    one, with the conv+bn+add+relu block and its grad group each
    collapsed to one op."""
    nhwc = layout == "NHWC"
    base = dict(layout="NHWC") if nhwc else None
    fused_cfg = dict(base or {}, epilogue_fusion=True)
    (p0, s0, l0), (p1, s1, l1) = _pair(_conv_block_net, base, fused_cfg)
    out, report = tpasses.apply(p1, protected=[l1.name])
    cnt = _census(out)
    assert report["epilogue"] == 1
    assert cnt["conv2d_bn_act"] == 1 and cnt["conv2d_bn_act_grad"] == 1
    assert cnt.get("relu", 0) == 0 and cnt.get("batch_norm", 0) == 0
    ref, _ = _run_steps(p0, s0, l0, _feed(nhwc=nhwc))
    got, _ = _run_steps(p1, s1, l1, _feed(nhwc=nhwc))
    assert got == ref, (got, ref)
    assert got[-1] < got[0]


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_depthwise_conv_fuses_bitwise(layout):
    nhwc = layout == "NHWC"
    base = dict(layout="NHWC") if nhwc else None
    (p0, s0, l0), (p1, s1, l1) = _pair(
        _depthwise_block_net, base, dict(base or {}, epilogue_fusion=True))
    out, report = tpasses.apply(p1, protected=[l1.name])
    cnt = _census(out)
    assert report["epilogue"] == 1
    assert cnt["conv2d_bn_act"] == 1 and cnt["conv2d_bn_act_grad"] == 1
    assert cnt.get("depthwise_conv2d", 0) == 0 \
        and cnt.get("batch_norm", 0) == 0
    fused = next(op for op in out.global_block().ops
                 if op.type == "conv2d_bn_act")
    assert fused.attrs["conv_type"] == "depthwise_conv2d"
    feed = _feed(channels=8, nhwc=nhwc)
    ref, _ = _run_steps(p0, s0, l0, feed)
    got, _ = _run_steps(p1, s1, l1, feed)
    assert got == ref, (got, ref)


def test_fetched_intermediate_blocks_fusion():
    """A fetched (protected) intermediate survives: the pattern holding
    it is left unfused and the fetch still works."""
    with tnames.guard():
        prog, startup, loss = _conv_block_net(tfluid, tlayers)
    tpasses.enable(prog, layout="NHWC", epilogue_fusion=True)
    bn_y = next(op.outputs["Y"][0] for op in prog.global_block().ops
                if op.type == "batch_norm")
    out, report = tpasses.apply(prog, protected=[loss.name, bn_y])
    assert report["epilogue"] == 0
    assert "conv2d_bn_act" not in _census(out)
    _, (y,) = _run_steps(prog, startup, loss, _feed(nhwc=True), n=1,
                         fetch=[bn_y])
    assert y.shape == (4, 8, 8, 8)


def test_amp_fused_is_bitwise_the_amp_unfused_and_grads_stay_fp32():
    """Under mixed precision the fused op casts its inputs as the
    unfused ops do (Scale and Bias stay float32): bitwise over 3 steps,
    and the filter's gradient is float32, the master's dtype."""
    base = dict(layout="NHWC")
    (p0, s0, l0), (p1, s1, l1) = _pair(
        _conv_block_net, base,
        dict(base, epilogue_fusion=True, pallas_reductions=True), amp=True)
    w = [op for op in p1.global_block().ops
         if op.type == "conv2d"][1].input("Filter")[0]
    ref, rg = _run_steps(p0, s0, l0, _feed(nhwc=True), fetch=[w + "@GRAD"])
    got, gg = _run_steps(p1, s1, l1, _feed(nhwc=True), fetch=[w + "@GRAD"])
    assert got == ref, (got, ref)
    assert gg[0].dtype == np.float32 and np.array_equal(gg[0], rg[0])


def test_fused_1x1_conv_goes_through_conv1x1_with_the_flag(monkeypatch):
    """NCHW, ``FLAGS_fused_conv1x1_bwd`` on: the fused op's 1x1 conv
    and the unfused shortcut conv each call ``conv1x1_bwd`` once a step
    (its plain version here); fused and unfused agree bitwise, and
    within 1e-6 of the flag-off run (einsum against the library's
    convolution backward)."""
    (p0, s0, l0), (p1, s1, l1) = _pair(
        lambda f, l: _conv_block_net(f, l, pointwise=True), None,
        dict(epilogue_fusion=True))
    calls = []
    real = tk1.conv1x1_bwd
    monkeypatch.setattr(tk1, "conv1x1_bwd",
                        lambda x, w, dy: calls.append(tuple(x.shape))
                        or real(x, w, dy))
    plain, _ = _run_steps(p0, s0, l0, _feed())
    assert calls == []
    tflags.set_flags({"FLAGS_fused_conv1x1_bwd": True})
    try:
        ref, _ = _run_steps(p0, s0, l0, _feed())
        assert calls == [(4, 3, 8, 8)] * 6
        calls.clear()
        got, _ = _run_steps(p1, s1, l1, _feed())
    finally:
        tflags.set_flags({"FLAGS_fused_conv1x1_bwd": False})
    assert calls == [(4, 3, 8, 8)] * 6
    assert "conv2d_bn_act_grad" in _census(tpasses.apply(p1)[0])
    assert got == ref, (got, ref)
    np.testing.assert_allclose(got, plain, rtol=1e-6)
    assert tk1.launches == {"conv1x1_bwd": 0}


# ---- against the JAX package ----

def test_fused_steps_match_the_jax_fused_run(monkeypatch):
    """The block net under layout + epilogue + reductions, from the JAX
    startup's weights: the port's tagged ``conv2d_bn_act_grad`` calls
    ``bn_grad`` (plain version), the JAX package's runs its Pallas
    kernel in interpret mode; 3 SGD losses within rtol 1e-5 and the
    state within 1e-4."""
    kw = dict(layout="NHWC", epilogue_fusion=True, pallas_reductions=True,
              interpret=True)
    with jnames.guard():
        jprog, jstart, jloss = _conv_block_net(jfluid, jlayers)
    with tnames.guard():
        tprog, tstart, tloss = _conv_block_net(tfluid, tlayers)
    jpasses.enable(jprog, **kw)
    tpasses.enable(tprog, **kw)
    jscope = jfluid.Scope()
    jexe = jfluid.Executor()
    jexe.run(jstart, scope=jscope)
    arrays = {v.name: np.asarray(jscope.find_var(v.name))
              for v in jprog.list_vars() if v.persistable}
    tscope = tfluid.Scope()
    interop.load_reference_state(arrays, tscope, CPU, [tprog, tstart])
    texe = tfluid.Executor(CPU)
    calls = []
    real = tbn.bn_grad
    monkeypatch.setattr(tbn, "bn_grad",
                        lambda *a, **k: calls.append(a[0].shape)
                        or real(*a, **k))
    feed = _feed(nhwc=True)
    want = [float(np.asarray(jexe.run(jprog, feed=feed,
                                      fetch_list=[jloss.name],
                                      scope=jscope)[0])) for _ in range(3)]
    got = [float(texe.run(tprog, feed=feed, fetch_list=[tloss.name],
                          scope=tscope)[0]) for _ in range(3)]
    assert calls == [(4, 8, 8, 8)] * 3
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for n in arrays:
        np.testing.assert_allclose(tscope.find_var(n).numpy(),
                                   np.asarray(jscope.find_var(n)),
                                   rtol=1e-4, atol=1e-6, err_msg=n)


class _Op:
    def __init__(self, type, attrs, uid=1):
        self.type, self.attrs, self.uid = type, attrs, uid
        self.inputs, self.outputs = {}, {}


RNG = np.random.RandomState(0)


def _f(*shape):
    return RNG.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("conv_type,residual,act", [
    ("conv2d", True, "relu"), ("conv2d", False, "relu"),
    ("conv2d", True, None), ("depthwise_conv2d", True, "relu")])
def test_conv2d_bn_act_op_against_jax(conv_type, residual, act, layout):
    """The fused op's forward (all five outputs) and its hand-chained
    grad (Input, Filter, Scale, Bias, Residual) against the JAX
    lowering, on the same inputs and cotangent."""
    c = 6
    x = _f(3, c, 7, 5)
    w = _f(c, 1, 3, 3) if conv_type == "depthwise_conv2d" \
        else _f(c, c, 3, 3)
    res = _f(3, c, 7, 5)
    if layout == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
        res = np.ascontiguousarray(res.transpose(0, 2, 3, 1))
    ins = {"Input": [x], "Filter": [w], "Scale": [_f(c)], "Bias": [_f(c)],
           "Mean": [_f(c)], "Variance": [np.abs(_f(c)) + 0.5]}
    if residual:
        ins["Residual"] = [res]
    attrs = {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1],
             "groups": 1, "conv_type": conv_type, "data_layout": layout,
             "epsilon": 1e-5, "momentum": 0.9, "is_test": False,
             "act": act, "with_residual": residual}
    op = _Op("conv2d_bn_act", attrs)
    jctx, tctx = JCtx(key=jax.random.PRNGKey(0)), TCtx(key=0)
    jins = {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}
    tins = {s: [torch.from_numpy(np.array(a)) for a in v]
            for s, v in ins.items()}
    jout = jreg.normalize_outputs(jreg.get("conv2d_bn_act").lower(
        jctx.for_op(op), jins, attrs, op))
    with torch.no_grad():
        tout = treg.normalize_outputs(treg.get("conv2d_bn_act").lower(
            tctx.for_op(op), tins, attrs, op))
    assert set(jout) == set(tout)
    for slot, vals in jout.items():
        a, b = np.asarray(vals[0]), tout[slot][0].numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, slot
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5, err_msg=slot)
    dy = _f(*np.asarray(jout["Out"][0]).shape)
    jg = jreg.get("conv2d_bn_act").grad_lower(
        jctx.for_op(op), jins, {"Out": [jnp.asarray(dy)]}, attrs, op)
    with torch.no_grad():
        tg = treg.get("conv2d_bn_act").grad_lower(
            tctx.for_op(op), tins, {"Out": [torch.from_numpy(dy)]}, attrs,
            op)
    slots = ["Input", "Filter", "Scale", "Bias"] + (
        ["Residual"] if residual else [])
    assert sorted(tg) == sorted(slots)
    for slot in slots:
        a, b = np.asarray(jg[slot][0]), tg[slot][0].numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, slot
        np.testing.assert_allclose(b, a, rtol=1e-4,
                                   atol=1e-5 * np.abs(a).max(),
                                   err_msg="grad " + slot)


def test_fused_op_shapes_and_dtypes_infer_as_in_jax():
    """Shape inference on meta tensors records the fused op's outputs
    with the shapes and dtypes the JAX package's build records."""
    with tnames.guard():
        prog, _, loss = _conv_block_net(tfluid, tlayers)
    tpasses.enable(prog, layout="NHWC", epilogue_fusion=True)
    out, _ = tpasses.apply(prog, protected=[loss.name])
    b0 = out.global_block()
    op = next(o for o in b0.ops if o.type == "conv2d_bn_act")
    # MeanOut and VarianceOut alias their inputs: keep those declared
    names = [n for n in op.output_arg_names if n not in op.input_arg_names]
    declared = [(b0.var(n).shape, b0.var(n).dtype) for n in names]
    for n in names:
        b0.var(n).shape = None
    infer_op_shapes(b0, op)
    assert [(b0.var(n).shape, b0.var(n).dtype) for n in names] == declared
    assert b0.var(op.output("Out")[0]).shape == (-1, 8, 8, 8)
