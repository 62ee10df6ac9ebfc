"""The pass pipeline on the CPU against the JAX package: ``passes.apply``
gives the JAX package's transformed program as JSON; the layout pass
leaves no 4-D transpose in ResNet and one per direction at LeNet's
flatten; the reduction pass tags only NHWC programs; the tagged NHWC
program trains like the plain NCHW one and like the JAX package's tagged
run; and the executor applies the pipeline once per (program version,
config), and again only for a fetch its clone does not protect yet, not
once per step.

``interpret=True`` goes to both packages: with None the JAX package asks
its own backend. Tolerances: NHWC + reductions against plain NCHW rtol
2e-3, the bound tests/test_passes.py pins; ResNet-50 against the JAX
package as tests/test_torch_convnet.py states them (the same damped
residual branches, for the same reason)."""

import collections
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import layers as jlayers
from paddle_tpu import passes as jpasses
from paddle_tpu import unique_name as jnames
from paddle_tpu.models import lenet as jlenet
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu_torch import interop
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import passes as tpasses
from paddle_tpu_torch import unique_name as tnames
from paddle_tpu_torch.core import executor as texecutor
from paddle_tpu_torch.kernels import bn_grad as tbn
from paddle_tpu_torch.models import lenet as tlenet
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.models import transformer as ttransformer

# Under pytest-xdist each worker takes its share of the cores for
# torch's intra-op threads: six workers at torch's default thread count
# oversubscribe the cores, and a test of seconds then takes minutes.
_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, os.cpu_count() // int(_WORKERS)))

CPU = tfluid.CPUPlace()
CIFAR = dict(image_shape=(3, 32, 32), class_dim=10)
CONFIGS = {
    "nhwc": dict(layout="NHWC"),
    "nhwc_reductions": dict(layout="NHWC", pallas_reductions=True,
                            interpret=True),
    "nhwc_reductions_tile": dict(
        layout="NHWC", pallas_reductions=True, interpret=True,
        kernel_params=[("batch_norm_grad", "tile", 8),
                       ("batch_norm_grad", "no_such_knob", 2),
                       ("no_such_op", "knob", 1)]),
    "nchw_feed": dict(layout="NHWC", feed_layout="NCHW"),
    "reductions_only": dict(pallas_reductions=True, interpret=True),
    "nhwc_epilogue_reductions": dict(layout="NHWC", epilogue_fusion=True,
                                     pallas_reductions=True, interpret=True),
    "epilogue_only": dict(epilogue_fusion=True),
}
MODELS = {
    "resnet_cifar": (lambda: jresnet.build_resnet50_train(**CIFAR),
                     lambda: tresnet.build_resnet50_train(**CIFAR)),
    "mnist_cnn": (lambda: jlenet.build_mnist_train(model="cnn"),
                  lambda: tlenet.build_mnist_train(model="cnn")),
}


def _dump(prog):
    return json.dumps(prog.to_dict(), sort_keys=True, indent=1)


def _census(prog):
    return collections.Counter(op.type for op in prog.global_block().ops)


def _transposes_4d(prog):
    return [op for op in prog.global_block().ops
            if op.type == "transpose" and len(op.attrs["axis"]) == 4]


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
@pytest.mark.parametrize("model", sorted(MODELS))
def test_apply_gives_the_jax_packages_program(model, cfg):
    jbuild, tbuild = MODELS[model]
    with jnames.guard():
        jprog, _, _, jfetch = jbuild()
    with tnames.guard():
        tprog, _, _, tfetch = tbuild()
    before = _dump(tprog)
    jpasses.enable(jprog, **CONFIGS[cfg])
    tpasses.enable(tprog, **CONFIGS[cfg])
    assert tpasses.plan_for(tprog).key == jpasses.plan_for(jprog).key
    jout, jreport = jpasses.apply(jprog, protected=[jfetch[0].name])
    tout, treport = tpasses.apply(tprog, protected=[tfetch[0].name])
    assert treport == jreport
    assert _dump(tout) == _dump(jout)
    # the user's program is untouched but for the feed declaration
    assert tout is not tprog
    if CONFIGS[cfg].get("feed_layout", "NHWC") == "NCHW" \
            or "layout" not in CONFIGS[cfg]:
        assert _dump(tprog) == before
    assert _dump(tpasses.disable(tprog)) == _dump(jpasses.disable(jprog))


ATTENTION_KNOBS = [("fused_attention", "block_k", 64),
                   ("fused_attention", "block_q", 32),
                   ("fused_attention", "decode_block_k", 128),
                   ("fused_attention", "no_such_knob", 2),
                   ("batch_norm_grad", "tile", 8)]


def test_attention_knobs_land_as_in_the_jax_package():
    """``fused_attention``'s block knobs land on every attention op,
    tagged or not, as the JAX package's pass lands them: the same report
    and the same JSON; the batch-norm tile finds no tagged op."""
    lm = dict(vocab_size=50, seq_len=16, d_model=32, num_layers=2,
              num_heads=2)
    with jnames.guard():
        jprog, _, _, jfetch = jtransformer.build_transformer_lm(**lm)
    with tnames.guard():
        tprog, _, _, tfetch = ttransformer.build_transformer_lm(**lm)
    jpasses.enable(jprog, kernel_params=ATTENTION_KNOBS)
    tpasses.enable(tprog, kernel_params=ATTENTION_KNOBS)
    jout, jreport = jpasses.apply(jprog, protected=[jfetch[0].name])
    tout, treport = tpasses.apply(tprog, protected=[tfetch[0].name])
    assert treport == jreport
    assert treport["kernels"] == 3 * lm["num_layers"]
    assert _dump(tout) == _dump(jout)
    attn = [op for op in tout.global_block().ops
            if op.type == "fused_attention"]
    assert len(attn) == lm["num_layers"]
    assert all((op.attrs["block_k"], op.attrs["block_q"],
                op.attrs["decode_block_k"]) == (64, 32, 128) for op in attn)


def test_resnet_carries_no_transpose_and_lenet_one_per_direction():
    with tnames.guard():
        prog = tresnet.build_resnet50_train(layout="NHWC", **CIFAR)[0]
    assert prog.global_block().var("data").shape == (-1, 32, 32, 3)
    out, report = tpasses.apply(prog)
    assert report == {"layout": 216}
    assert _transposes_4d(out) == [] and _census(out)["transpose"] == 0
    nhwc = [op for op in out.global_block().ops
            if op.type.split("_grad")[0] in ("conv2d", "batch_norm",
                                             "pool2d")]
    assert len(nhwc) == 2 * (53 + 53 + 2)
    assert all(op.attrs["data_layout"] == "NHWC" for op in nhwc)
    with tnames.guard():
        lenet = tlenet.build_mnist_train(model="cnn", layout="NHWC")[0]
    out, _ = tpasses.apply(lenet)
    # the 4x4 flatten into the fc is a genuine boundary
    assert len(_transposes_4d(out)) == 2


def test_reductions_tag_every_nhwc_batch_norm_grad_and_no_nchw_one():
    with tnames.guard():
        prog = tresnet.build_resnet50_train(**CIFAR)[0]
    tpasses.enable(prog, pallas_reductions=True)          # layout off
    out, report = tpasses.apply(prog)
    assert report == {"reductions": 0}
    assert not any(op.attrs.get("use_pallas_reduction")
                   for op in out.global_block().ops)
    tpasses.enable(prog, layout="NHWC", pallas_reductions=True,
                   kernel_params=[("batch_norm_grad", "tile", 4)])
    out, report = tpasses.apply(prog)
    assert report == {"layout": 216, "reductions": 53, "kernels": 53}
    tagged = [op for op in out.global_block().ops
              if op.attrs.get("use_pallas_reduction")]
    assert [op.type for op in tagged] == ["batch_norm_grad"] * 53
    # interpret=None records False here: the device picks the kernel
    assert not any(op.attrs["pallas_interpret"] for op in tagged)
    assert all(op.attrs["pallas_tile"] == 4 for op in tagged)


@pytest.mark.parametrize("kw,name", [
    (dict(layout="NHWC", remat="blocks"), "remat"),
    (dict(remat=2), "remat")])
def test_unported_passes_raise_in_apply_not_in_the_constructor(kw, name):
    """Every pass of the JAX pipeline is ported now (remat last): a
    config that asks for one builds with the JAX key and ``apply`` runs
    it with the JAX package's rewrite counts, where it once raised."""
    with tnames.guard():
        prog, _, _, (loss, _) = tlenet.build_mnist_train(model="cnn")
    with jnames.guard():
        jprog, _, _, (jloss, _) = jlenet.build_mnist_train(model="cnn")
    cfg = tpasses.PassConfig(**kw)
    assert cfg.key == jpasses.PassConfig(**kw).key
    prog.passes = cfg
    jprog.passes = jpasses.PassConfig(**kw)
    assert all(mod is not None for _, _, mod in tpasses.PIPELINE)
    out, report = tpasses.apply(prog, protected=(loss.name,))
    assert name in report
    assert report == jpasses.apply(jprog, protected=(jloss.name,))[1]


@pytest.mark.parametrize("kw", [
    dict(layout="NCHW"), dict(feed_layout="CHWN"), dict(remat="never"),
    dict(remat=0), dict(kernel_params=[("a", "b")]),
    dict(kernel_params=[("a", "b", 1.5)]),
    dict(kernel_params=[("a", "b", True)])])
def test_pass_config_refuses_what_the_jax_package_refuses(kw):
    with pytest.raises(ValueError):
        jpasses.PassConfig(**kw)
    with pytest.raises(ValueError):
        tpasses.PassConfig(**kw)
    prog = tfluid.Program()
    prog.passes = "NHWC"
    with pytest.raises(TypeError, match="PassConfig"):
        tpasses.plan_for(prog)


# ---- training through the executor ----

def _block_net(fluid, layers, spatial=8):
    """tests/test_passes.py's conv + bn + residual + relu block with a
    global-pool head, and a max pool and a 1x1 conv besides."""
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        img = layers.data("img", [3, spatial, spatial])
        label = layers.data("label", [1], dtype="int64")
        short = layers.conv2d(img, 8, 1, act=None, bias_attr=False)
        c = layers.conv2d(img, 8, 3, padding=1, act=None, bias_attr=False)
        bn = layers.batch_norm(c, act=None)
        bn = layers.elementwise_add(short, bn, act="relu")
        bn = layers.pool2d(bn, pool_size=3, pool_stride=2, pool_padding=1)
        bn = layers.batch_norm(layers.conv2d(bn, 12, 1, bias_attr=False),
                               act="relu")
        pool = layers.pool2d(bn, pool_type="avg", global_pooling=True)
        fc = layers.fc(pool, size=10, act="softmax")
        loss = layers.mean(layers.cross_entropy(fc, label))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return prog, startup, loss


def _img_feed(spatial=8, batch=4, seed=0, nhwc=False):
    rng = np.random.RandomState(seed)
    x = rng.rand(batch, 3, spatial, spatial).astype(np.float32)
    y = rng.randint(0, 10, (batch, 1)).astype(np.int64)
    if nhwc:
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    return {"img": x, "label": y}


def _jax_state(jprog, jstart):
    jscope = jfluid.Scope()
    jexe = jfluid.Executor()
    jexe.run(jstart, scope=jscope)
    arrays = {v.name: np.asarray(jscope.find_var(v.name))
              for v in jprog.list_vars() if v.persistable}
    return jexe, jscope, arrays


def _port_steps(prog, startup, loss, arrays, feed, n=3):
    scope = tfluid.Scope()
    interop.load_reference_state(arrays, scope, CPU, [prog, startup])
    exe = tfluid.Executor(CPU)
    return [float(exe.run(prog, feed=feed, fetch_list=[loss.name],
                          scope=scope)[0]) for _ in range(n)], scope


def test_nhwc_reductions_trains_like_nchw_and_like_the_jax_tagged_run():
    with jnames.guard():
        jprog, jstart, jloss = _block_net(jfluid, jlayers)
    jpasses.enable(jprog, layout="NHWC", pallas_reductions=True,
                   interpret=True)
    jexe, jscope, arrays = _jax_state(jprog, jstart)
    want = [float(np.asarray(jexe.run(
        jprog, feed=_img_feed(nhwc=True), fetch_list=[jloss.name],
        scope=jscope)[0])) for _ in range(3)]

    with tnames.guard():
        p0, s0, l0 = _block_net(tfluid, tlayers)
    plain, _ = _port_steps(p0, s0, l0, arrays, _img_feed())
    with tnames.guard():
        p1, s1, l1 = _block_net(tfluid, tlayers)
    tpasses.enable(p1, layout="NHWC", pallas_reductions=True,
                   interpret=True)
    calls = []
    real = tbn.bn_grad
    tbn.bn_grad = lambda *a, **k: calls.append(a[0].shape) or real(*a, **k)
    try:
        got, scope = _port_steps(p1, s1, l1, arrays, _img_feed(nhwc=True))
    finally:
        tbn.bn_grad = real
    assert calls == [(4, 4, 4, 12), (4, 8, 8, 8)] * 3     # NHWC, backward order
    np.testing.assert_allclose(got, plain, rtol=2e-3)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]
    # the transformed clone wrote the state under the user's names
    for n in arrays:
        np.testing.assert_allclose(scope.find_var(n).numpy(),
                                   np.asarray(jscope.find_var(n)),
                                   rtol=1e-4, atol=1e-6, err_msg=n)
    # an NCHW batch is refused by shape, not silently mis-read
    with pytest.raises(Exception):
        tfluid.Executor(CPU).run(p1, feed=_img_feed(), fetch_list=[l1.name],
                                 scope=scope)


def test_executor_applies_the_pipeline_once_per_version_and_config(
        monkeypatch):
    with tnames.guard():
        prog, startup, loss = _block_net(tfluid, tlayers)
    applied = []
    real = tpasses.apply
    monkeypatch.setattr(
        texecutor.passes_lib, "apply",
        lambda p, protected=(): applied.append(tpasses.plan_for(p).key)
        or real(p, protected=protected))
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    assert applied == []                       # no config: no clone

    def steps(n, nhwc, fetch=(loss.name,)):
        return [exe.run(prog, feed=_img_feed(nhwc=nhwc),
                        fetch_list=list(fetch), scope=scope)
                for _ in range(n)]

    steps(2, False)
    assert applied == []
    cfg_a = tpasses.PassConfig(layout="NHWC")
    cfg_b = tpasses.PassConfig(layout="NHWC", pallas_reductions=True)
    prog.passes = cfg_a
    steps(3, True)
    assert applied == [cfg_a.key]
    prog.passes = cfg_b
    steps(3, True)
    assert applied == [cfg_a.key, cfg_b.key]
    prog.passes = cfg_a                        # flipping back: kept clone
    steps(2, True)
    prog.passes = None
    steps(1, False)
    assert applied == [cfg_a.key, cfg_b.key]
    prog.passes = cfg_b
    steps(1, True, fetch=(loss.name, "fc_0.w_0@GRAD"))    # other fetches
    assert applied == [cfg_a.key, cfg_b.key, cfg_b.key]
    steps(1, True)                 # the new clone protects the loss too
    steps(1, True, fetch=("fc_0.w_0@GRAD",))
    assert applied == [cfg_a.key, cfg_b.key, cfg_b.key]
    assert len(exe._plans) == 4    # startup, plain, cfg_a, cfg_b
    prog.global_block().append_op("scale", {"X": [loss.name]},
                                  {"Out": [loss.name + "@x2"]},
                                  {"scale": 2.0})
    prog.global_block().create_var(name=loss.name + "@x2", shape=(),
                                   dtype="float32")
    out = steps(2, True, fetch=(loss.name, loss.name + "@x2"))
    assert applied == [cfg_a.key, cfg_b.key, cfg_b.key, cfg_b.key]
    np.testing.assert_allclose(out[0][1], 2 * out[0][0], rtol=1e-6)


def test_resnet_cifar_nhwc_reductions_steps_match_jax():
    """3 Momentum steps of ``resnet_cifar`` under layout="NHWC" and
    pallas_reductions: the port's 53 tagged grads run ``bn_grad``'s
    plain version, the JAX package's its Pallas kernel in interpret
    mode. Tolerances and damping: tests/test_torch_convnet.py."""
    with jnames.guard():
        jprog, jstart, _, (jloss, _) = jresnet.build_resnet50_train(
            layout="NHWC", **CIFAR)
    with tnames.guard():
        tprog, tstart, _, (tloss, _) = tresnet.build_resnet50_train(
            layout="NHWC", **CIFAR)
    kw = dict(layout="NHWC", pallas_reductions=True, interpret=True)
    jpasses.enable(jprog, **kw)
    tpasses.enable(tprog, **kw)
    jexe, jscope, arrays = _jax_state(jprog, jstart)
    ops = jprog.global_block().ops
    branch = {op.input("Y")[0] for op in ops if op.type == "elementwise_add"}
    for op in ops:
        if op.type == "batch_norm" and op.output("Y")[0] in branch:
            n = op.input("Scale")[0]
            arrays[n] = arrays[n] * np.float32(0.03)
            jscope.set_var(n, jnp.asarray(arrays[n]))
    tscope = tfluid.Scope()
    interop.load_reference_state(arrays, tscope, CPU, [tprog, tstart])
    texe = tfluid.Executor(CPU)
    rng = np.random.RandomState(0)
    feed = {"data": rng.randn(8, 32, 32, 3).astype(np.float32),
            "label": rng.randint(0, 10, (8, 1)).astype(np.int64)}
    grads = sorted(p.name + "@GRAD"
                   for p in jprog.global_block().all_parameters())
    calls = []
    real = tbn.bn_grad
    tbn.bn_grad = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        jl, tl = [], []
        for step in range(3):
            extra = grads if step == 0 else []
            jout = jexe.run(jprog, feed=feed,
                            fetch_list=[jloss.name] + extra, scope=jscope)
            tout = texe.run(tprog, feed=feed,
                            fetch_list=[tloss.name] + extra, scope=tscope)
            jl.append(float(np.asarray(jout[0])))
            tl.append(float(tout[0]))
            num = den = 0.0
            for name, jg, tg in zip(extra, jout[1:], tout[1:]):
                jg = np.asarray(jg)
                np.testing.assert_allclose(
                    tg, jg, rtol=0, atol=5e-2 * np.abs(jg).max(),
                    err_msg=name)
                num += float(((tg - jg) ** 2).sum())
                den += float((jg ** 2).sum())
            if extra:
                assert (num / den) ** 0.5 < 2e-3
    finally:
        tbn.bn_grad = real
    assert len(calls) == 53 * 3 and tbn.launches == {"bn_grad": 0}
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    for n in arrays:
        if n.endswith((".mean", ".variance")):
            np.testing.assert_allclose(
                tscope.find_var(n).numpy(), np.asarray(jscope.find_var(n)),
                rtol=0, atol=1e-3, err_msg=n)
