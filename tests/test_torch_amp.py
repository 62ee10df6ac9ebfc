"""Mixed precision (``paddle_tpu_torch/amp.py``) on the CPU against the
JAX package.

* The ``mnist_cnn_amp`` golden builds byte-identical, and a program read
  back from it runs in bfloat16 (its conv outputs are bfloat16 tensors):
  the port once carried ``amp_dtype`` in its IR without applying it.
* ``cast_ins`` gives the JAX function's slot dtypes for each class of
  op: float32-only ops, skipped ops, float32 slots, nondiff inputs and
  optimizer ops.
* Master parameters stay float32 in the scope and their gradients are
  float32, where the activations are bfloat16.

Tolerances. The JAX package's own tests pin no AMP tolerance beyond
"finite, falling, masters float32"; these are stated here and in PERF.md
section 2. Both packages round to nearest even, but their bfloat16
convolutions, matmuls and reductions accumulate differently, so at
LeNet's size the gradients lie 2.8e-2 from their float32 values in
relative L2 norm in BOTH packages and 1.9e-3 from each other; at the
``resnet_cifar`` size (32x32, batch 8, the residual branches damped as
tests/test_torch_convnet.py damps them) 0.136 (JAX) and 0.142 (port)
from float32, and 0.125 from each other (single bias gradients, which
nearly cancel, up to 0.29). So:

* LeNet: 3 steps' losses rtol 1e-2 (measured 2.1e-3 at the third);
  each first-step gradient within 5e-2 of its own L2 norm of the JAX
  package's, all together 5e-3;
* ``resnet_cifar``: the first step's loss rtol 1e-2 (measured 4.5e-3);
  at lr 0.1 the next two steps take the loss from 2.87 to 0.15-0.18 and
  0.40-0.41, where the gradients' bfloat16 spread shows as 16 % at the
  second step, so those are held to fall below the first in both
  packages; all first-step gradients together within 0.2 of the JAX
  package's, each within 0.5 of its own L2 norm;
* both: the port's bf16 gradients lie no farther from its own float32
  gradients than 1.25 times the JAX package's do from its own, all
  together (measured 1.00 and 1.04).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import amp as jamp
from paddle_tpu import unique_name as jnames
from paddle_tpu.core import registry as jreg
from paddle_tpu.models import lenet as jlenet
from paddle_tpu.models import resnet as jresnet
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import interop
from paddle_tpu_torch import unique_name as tnames
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.ir import Program
from paddle_tpu_torch.models import lenet as tlenet
from paddle_tpu_torch.models import resnet as tresnet

# Under pytest-xdist each worker takes its share of the cores for
# torch's intra-op threads: six workers at torch's default thread count
# oversubscribe the cores, and a test of seconds then takes minutes.
_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, os.cpu_count() // int(_WORKERS)))

CPU = tfluid.CPUPlace()
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens",
                      "mnist_cnn_amp.program.json")
CIFAR = dict(image_shape=(3, 32, 32), class_dim=10)


def _dump(prog):
    return json.dumps(prog.to_dict(), sort_keys=True, indent=1)


# ---- the program ----

@pytest.mark.parametrize("which", ["main", "startup"])
def test_mnist_cnn_amp_builds_the_golden_and_the_jax_json(which):
    with jnames.guard():
        j = jlenet.build_mnist_train(model="cnn")
        jamp.enable(j[0])
    with tnames.guard():
        t = tlenet.build_mnist_train(model="cnn")
        assert tamp.enable(t[0]) is t[0]
    i = 0 if which == "main" else 1
    assert _dump(t[i]) == _dump(j[i])
    if which == "main":
        with open(GOLDEN) as f:
            assert _dump(t[0]) == f.read()
        assert t[0].amp_dtype == "bfloat16" and t[1].amp_dtype is None


def _lenet_feed(batch=8, seed=3):
    rng = np.random.RandomState(seed)
    return {"img": rng.rand(batch, 1, 28, 28).astype(np.float32),
            "label": rng.randint(0, 10, (batch, 1)).astype(np.int64)}


def test_the_golden_amp_program_runs_in_bfloat16():
    """``Program.from_json`` of the golden keeps ``amp_dtype`` and the
    executor applies it: the conv outputs come back bfloat16 (float32
    with AMP off), a numpy fetch of one comes back widened to float32,
    and the loss stays float32."""
    with open(GOLDEN) as f:
        prog = Program.from_json(f.read())
    assert prog.amp_dtype == "bfloat16"
    with tnames.guard():
        _, startup, _, (loss, _) = tlenet.build_mnist_train(model="cnn")
    convs = [op.output("Output")[0] for op in prog.global_block().ops
             if op.type == "conv2d"]
    assert len(convs) == 2
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    out = exe.run(prog, feed=_lenet_feed(), fetch_list=convs + [loss.name],
                  scope=scope, return_numpy=False)
    assert [t.dtype for t in out] == [torch.bfloat16] * 2 + [torch.float32]
    as_np = exe.run(prog, feed=_lenet_feed(), fetch_list=convs[:1],
                    scope=scope)
    assert as_np[0].dtype == np.float32
    tamp.disable(prog)
    out = exe.run(prog, feed=_lenet_feed(), fetch_list=convs, scope=scope,
                  return_numpy=False)
    assert [t.dtype for t in out] == [torch.float32] * 2


def test_enable_refuses_what_the_jax_package_refuses():
    for fluid, amp in ((jfluid, jamp), (tfluid, tamp)):
        with pytest.raises(ValueError, match="dynamic_loss_scale"):
            amp.enable(fluid.Program(), loss=object())
        with pytest.raises(ValueError, match="dynamic_loss_scale"):
            amp.enable(fluid.Program(), init_loss_scale=2.0 ** 15)
        with pytest.raises(ValueError, match="needs loss="):
            amp.enable(fluid.Program(), dynamic_loss_scale=True)
    # what both take: dynamic loss scaling arms the guard the same way
    armed = []
    for fluid, amp in ((jfluid, jamp), (tfluid, tamp)):
        prog = fluid.Program()
        amp.enable(prog, loss="loss", dynamic_loss_scale=True,
                   growth_interval=4, divergence=False)
        cfg = prog.guard
        armed.append((prog.amp_dtype, cfg.loss_name, cfg.dynamic_loss_scale,
                      cfg.init_loss_scale, cfg.growth_interval,
                      cfg.detector is None))
    assert armed[0] == armed[1] == ("bfloat16", "loss", True, 2.0 ** 15, 4,
                                    True)
    assert tamp.FP32_OPS == jamp.FP32_OPS
    assert tamp._SKIP == jamp._SKIP and tamp._FP32_SLOTS == jamp._FP32_SLOTS


# ---- the policy, op by op ----

def _arr(dtype, shape=(2, 3)):
    return np.full(shape, 0.5, dtype=np.float32).astype(dtype)


CAST_CASES = {
    "fp32_op": ("softmax", {"X": ["bfloat16"]}),
    "fp32_op_label": ("cross_entropy",
                      {"X": ["bfloat16"], "Label": ["int64"]}),
    "skip": ("sum", {"X": ["bfloat16", "float32"]}),
    "fp32_slots": ("batch_norm", {"X": ["float32"], "Scale": ["float32"],
                                  "Bias": ["float32"], "Mean": ["float32"],
                                  "Variance": ["float32"]}),
    "fused_fp32_slots": (
        "conv2d_bn_act", {"Input": ["float32"], "Filter": ["float32"],
                          "Scale": ["float32"], "Bias": ["float32"],
                          "Mean": ["float32"], "Variance": ["float32"],
                          "Residual": ["float32"]}),
    "nondiff": ("lookup_table", {"W": ["float32"], "Ids": ["int64"]}),
    "compute": ("mul", {"X": ["float32"], "Y": ["float32"]}),
    "already_half": ("elementwise_add", {"X": ["bfloat16"],
                                         "Y": ["float32"]}),
    "optimizer": ("momentum", {"Param": ["float32"], "Grad": ["bfloat16"],
                               "Velocity": ["float32"],
                               "LearningRate": ["float32"]}),
    "optimizer_fp32_grad": ("sgd", {"Param": ["float32"],
                                    "Grad": ["float32"],
                                    "LearningRate": ["float32"]}),
}


@pytest.mark.parametrize("case", sorted(CAST_CASES))
def test_cast_ins_gives_the_jax_slot_dtypes(case):
    type, slots = CAST_CASES[case]
    jins, tins = {}, {}
    for slot, dtypes in slots.items():
        arrs = [_arr(np.float32 if d == "bfloat16" else d) for d in dtypes]
        jins[slot] = [jnp.asarray(a, dtype=d) for a, d in zip(arrs, dtypes)]
        tins[slot] = [torch.from_numpy(a).to(getattr(torch, d))
                      for a, d in zip(arrs, dtypes)]
    jout = jamp.cast_ins(jreg.get(type), jins, "bfloat16")
    tout = tamp.cast_ins(treg.get(type), tins, "bfloat16")
    # the JAX package runs with 64-bit types off: an int64 index is int32
    got = {s: [str(v.dtype).replace("torch.", "").replace("int64", "int32")
               for v in vs] for s, vs in tout.items()}
    want = {s: [str(v.dtype) for v in vs] for s, vs in jout.items()}
    assert got == want
    assert tamp.cast_ins(treg.get(type), tins, None) is tins


# ---- training ----

def test_masters_and_their_gradients_stay_float32():
    with tnames.guard():
        prog, startup, _, (loss, _) = tlenet.build_mnist_train(model="cnn",
                                                              lr=1e-3)
    tamp.enable(prog)
    params = [p.name for p in prog.global_block().all_parameters()]
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    before = {n: scope.find_var(n).clone() for n in params}
    losses = []
    for _ in range(3):
        out = exe.run(prog, feed=_lenet_feed(),
                      fetch_list=[loss.name] + [n + "@GRAD" for n in params],
                      scope=scope, return_numpy=False)
        losses.append(float(out[0]))
        assert all(g.dtype == torch.float32 for g in out[1:])
    assert all(scope.find_var(n).dtype == torch.float32 for n in params)
    assert all(not torch.equal(scope.find_var(n), before[n]) for n in params)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def _first_grads(jbuild, tbuild, feed, amp, steps, damp=None):
    """Both packages from the JAX startup's weights: losses of ``steps``
    steps and the first step's gradients, by parameter name."""
    with jnames.guard():
        jprog, jstart, _, (jloss, _) = jbuild()
    with tnames.guard():
        tprog, tstart, _, (tloss, _) = tbuild()
    if amp:
        jamp.enable(jprog)
        tamp.enable(tprog)
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
    interop.load_reference_state(arrays, tscope, CPU, [tprog, tstart])
    texe = tfluid.Executor(CPU)
    grads = sorted(p.name + "@GRAD"
                   for p in jprog.global_block().all_parameters())
    res = {"jax": ([], None), "port": ([], None)}
    for step in range(steps):
        extra = grads if step == 0 else []
        jout = jexe.run(jprog, feed=feed, fetch_list=[jloss.name] + extra,
                        scope=jscope)
        tout = texe.run(tprog, feed=feed, fetch_list=[tloss.name] + extra,
                        scope=tscope)
        res["jax"][0].append(float(np.asarray(jout[0])))
        res["port"][0].append(float(tout[0]))
        if step == 0:
            assert all(g.dtype == np.float32 for g in tout[1:])
            res = {"jax": (res["jax"][0], [np.asarray(g, np.float64)
                                           for g in jout[1:]]),
                   "port": (res["port"][0], [np.asarray(g, np.float64)
                                             for g in tout[1:]])}
    return grads, res


def _l2(got, want):
    num = sum(float(((g - w) ** 2).sum()) for g, w in zip(got, want))
    return (num / sum(float((w ** 2).sum()) for w in want)) ** 0.5


def _each_l2(got, want):
    return [float(np.linalg.norm(g - w) / np.linalg.norm(w))
            for g, w in zip(got, want)]


@pytest.mark.parametrize("name", ["lenet", "resnet_cifar"])
def test_amp_steps_match_jax(name):
    if name == "lenet":
        build = (lambda: jlenet.build_mnist_train(model="cnn"),
                 lambda: tlenet.build_mnist_train(model="cnn"))
        feed, damp, each_tol, all_tol = _lenet_feed(), None, 5e-2, 5e-3
    else:
        build = (lambda: jresnet.build_resnet50_train(**CIFAR),
                 lambda: tresnet.build_resnet50_train(**CIFAR))
        rng = np.random.RandomState(0)
        feed = {"data": rng.randn(8, 3, 32, 32).astype(np.float32),
                "label": rng.randint(0, 10, (8, 1)).astype(np.int64)}
        damp, each_tol, all_tol = 0.03, 0.5, 0.2
    names, half = _first_grads(*build, feed, True, 3, damp)
    _, full = _first_grads(*build, feed, False, 1, damp)
    (jl, jg), (tl, tg) = half["jax"], half["port"]
    if name == "lenet":
        np.testing.assert_allclose(tl, jl, rtol=1e-2)
    else:
        np.testing.assert_allclose(tl[0], jl[0], rtol=1e-2)
        for losses in (tl, jl):
            assert max(losses[1:]) < losses[0], losses
    assert np.isfinite(tl).all()
    each = _each_l2(tg, jg)
    assert max(each) < each_tol, names[int(np.argmax(each))]
    assert _l2(tg, jg) < all_tol
    # each package's distance from its own float32 gradients
    jdist = _l2(jg, full["jax"][1])
    tdist = _l2(tg, full["port"][1])
    assert tdist < 1.25 * jdist, (tdist, jdist)
    assert _l2(full["port"][1], full["jax"][1]) < 1e-3
