"""The transformer LM's training slice on the CPU against the JAX
package: ``build_transformer_lm`` (next-token ``softmax_with_cross_entropy``
and Adam, as bench.py trains it), trained by both packages from the same
weights (the JAX startup's scope carried over by
``interop.load_reference_state``) on the same seeded batch, at the size
of the JAX package's ``test_transformer_lm_trains`` (vocab 50, seq 16,
d_model 32, one layer, two heads, batch 4).

Tolerances:

* float32: 5 Adam steps' losses within rtol 1e-5, every first-step
  gradient within 1e-4 of its largest magnitude (measured 5.5e-8 and
  8.9e-7: the same float32 math in another summation order);
* bf16 AMP, the AMP bounds of PERF.md section 2: the first step's loss
  rtol 1e-2, each first-step gradient within 0.5 of its own L2 norm of
  the JAX package's, all together 0.2, and the port's bf16 gradients no
  farther from its own float32 ones than 1.25 times the JAX package's
  (measured: losses 5e-4, each 1.3e-2, all 1.1e-2, 1.005 times).

The loss op is held against the JAX lowering and ``jax.vjp`` at 1e-6;
under AMP the test checks that ``amp.cast_ins`` hands ``fused_attention``
bfloat16 Q/K/V and that the float32 masters of the q/k/v projections
get float32 gradients.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import amp as jamp
from paddle_tpu import unique_name as jnames
from paddle_tpu.core import registry as jreg
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import interop
from paddle_tpu_torch import unique_name as tnames
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.lower import TraceContext
from paddle_tpu_torch.models import transformer as ttransformer

# Under pytest-xdist each worker takes its share of the cores for
# torch's intra-op threads: six workers at torch's default thread count
# oversubscribe the cores, and a test of seconds then takes minutes.
_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, os.cpu_count() // int(_WORKERS)))

CPU = tfluid.CPUPlace()
SIZE = dict(vocab_size=50, seq_len=16, d_model=32, num_layers=1,
            num_heads=2)
B, STEPS = 4, 5


def _feed():
    rng = np.random.RandomState(0)
    return {"tokens": rng.randint(0, 50, (B, 16)).astype(np.int64),
            "targets": rng.randint(0, 50, (B, 16)).astype(np.int64)}


def _train(amp, steps):
    """Both packages from the JAX startup's weights: ``steps`` losses
    each and the first step's gradients, by parameter name."""
    with jnames.guard():
        jprog, jstart, _, (jloss,) = jtransformer.build_transformer_lm(
            **SIZE)
    with tnames.guard():
        tprog, tstart, _, (tloss,) = ttransformer.build_transformer_lm(
            **SIZE)
    if amp:
        jamp.enable(jprog)
        tamp.enable(tprog)
    jscope = jfluid.Scope()
    jexe = jfluid.Executor()
    jexe.run(jstart, scope=jscope)
    arrays = {v.name: np.asarray(jscope.find_var(v.name))
              for v in jprog.list_vars() if v.persistable}
    tscope = tfluid.Scope()
    interop.load_reference_state(arrays, tscope, CPU, [tprog, tstart])
    texe = tfluid.Executor(CPU)
    grads = sorted(p.name + "@GRAD"
                   for p in jprog.global_block().all_parameters())
    out = dict(names=grads, jl=[], tl=[])
    feed = _feed()
    for step in range(steps):
        extra = grads if step == 0 else []
        j = jexe.run(jprog, feed=feed, fetch_list=[jloss.name] + extra,
                     scope=jscope)
        t = texe.run(tprog, feed=feed, fetch_list=[tloss.name] + extra,
                     scope=tscope, return_numpy=False)
        out["jl"].append(float(np.asarray(j[0])))
        out["tl"].append(float(t[0]))
        if step == 0:
            out["tdtypes"] = [str(g.dtype).replace("torch.", "")
                              for g in t[1:]]
            out["jdtypes"] = [str(np.asarray(g).dtype) for g in j[1:]]
            out["jg"] = [np.asarray(g, np.float64) for g in j[1:]]
            out["tg"] = [g.double().numpy() for g in t[1:]]
    return out


@pytest.fixture(scope="module")
def runs():
    return {"fp32": _train(False, STEPS), "amp": _train(True, STEPS)}


def _l2(got, want):
    num = sum(float(((g - w) ** 2).sum()) for g, w in zip(got, want))
    return (num / sum(float((w ** 2).sum()) for w in want)) ** 0.5


def test_float32_steps_match_jax(runs):
    r = runs["fp32"]
    assert r["tdtypes"] == ["float32"] * 18
    np.testing.assert_allclose(r["tl"], r["jl"], rtol=1e-5)
    assert np.isfinite(r["tl"]).all() and r["tl"][-1] < r["tl"][0]
    assert len(r["names"]) == 18
    for name, t, j in zip(r["names"], r["tg"], r["jg"]):
        np.testing.assert_allclose(t, j, rtol=0,
                                   atol=1e-4 * np.abs(j).max(),
                                   err_msg=name)


def test_amp_steps_match_jax(runs):
    r, full = runs["amp"], runs["fp32"]
    # float32 masters get float32 gradients, but the embeddings' hand-
    # written grad is bfloat16 in both packages (Adam widens it)
    assert r["tdtypes"] == r["jdtypes"]
    assert r["tdtypes"].count("bfloat16") == 2
    np.testing.assert_allclose(r["tl"][0], r["jl"][0], rtol=1e-2)
    assert np.isfinite(r["tl"]).all() and r["tl"][-1] < r["tl"][0]
    each = [float(np.linalg.norm(t - j) / np.linalg.norm(j))
            for t, j in zip(r["tg"], r["jg"])]
    assert max(each) < 0.5, r["names"][int(np.argmax(each))]
    assert _l2(r["tg"], r["jg"]) < 0.2
    # each package's distance from its own float32 gradients
    assert _l2(r["tg"], full["tg"]) < 1.25 * _l2(r["jg"], full["jg"])


def test_amp_casts_reach_qkv_and_the_masters_get_float32_gradients():
    """Under AMP ``fused_attention`` sees bfloat16 Q/K/V (forward and the
    forward its generic grad differentiates), its grad hands bfloat16
    cotangents back, and the float32 masters of the q/k/v projection
    weights get float32 gradients."""
    spec = treg.get("fused_attention")
    seen = []
    real = spec.lower

    def spy(ctx, ins, attrs, o):
        seen.append(tuple(ins[s][0].dtype for s in "QKV"))
        return real(ctx, ins, attrs, o)

    with tnames.guard():
        prog, startup, _, (loss,) = ttransformer.build_transformer_lm(
            **SIZE)
    tamp.enable(prog)
    block = prog.global_block()
    att = [op for op in block.ops if op.type == "fused_attention"]
    # the block's first three fc ops (bias-free) are the q, k and v
    # projections
    qkv_w = [op.input("Y")[0] for op in block.ops if op.type == "mul"][:3]
    assert len(att) == 1
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    spec.lower = spy
    try:
        out = exe.run(prog, feed=_feed(),
                      fetch_list=[loss] + [w + "@GRAD" for w in qkv_w]
                      + [att[0].input("Q")[0] + "@GRAD"], scope=scope,
                      return_numpy=False)
    finally:
        spec.lower = real
    assert seen == [(torch.bfloat16,) * 3] * 2     # forward + grad
    assert all(g.dtype == torch.float32 for g in out[1:4])
    assert all(float(g.abs().max()) > 0 for g in out[1:4])
    assert out[4].dtype == torch.bfloat16


@pytest.mark.parametrize("case", ["hard", "hard_squeezed", "soft"])
def test_softmax_with_cross_entropy_matches_jax(case):
    """Loss and Softmax outputs against the JAX lowering, and the
    logits' gradient (the generic grad) against ``jax.vjp``, at 1e-6."""
    rng = np.random.RandomState(len(case))
    logits = rng.randn(3, 5, 7).astype(np.float32) * 2
    soft = case == "soft"
    if soft:
        label = rng.rand(3, 5, 7).astype(np.float32)
        label /= label.sum(-1, keepdims=True)
    else:
        label = rng.randint(0, 7, (3, 5, 1) if case == "hard" else (3, 5))
        label = label.astype(np.int64)
    dloss = rng.randn(3, 5, 1).astype(np.float32)
    attrs = {"soft_label": soft}
    jspec = jreg.get("softmax_with_cross_entropy")
    tspec = treg.get("softmax_with_cross_entropy")

    class Op:
        type, uid = "softmax_with_cross_entropy", 1

    Op.attrs = attrs

    def jloss(x):
        return jspec.lower(None, {"Logits": [x], "Label": [
            jnp.asarray(label)]}, attrs, Op)
    jout, vjp = jax.vjp(lambda x: jloss(x)["Loss"], jnp.asarray(logits))
    jsm = jloss(jnp.asarray(logits))["Softmax"]
    jgrad, = vjp(jnp.asarray(dloss))
    ins = {"Logits": [torch.from_numpy(logits)],
           "Label": [torch.from_numpy(label)]}
    tout = tspec.lower(TraceContext(), ins, attrs, Op)
    np.testing.assert_allclose(tout["Loss"].numpy(), np.asarray(jout),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tout["Softmax"].numpy(), np.asarray(jsm),
                               rtol=1e-6, atol=1e-6)
    grads = treg.generic_grad(TraceContext(), tspec, Op, ins,
                              {"Loss": [torch.from_numpy(dloss)]})
    assert "Label" not in grads
    np.testing.assert_allclose(grads["Logits"][0].numpy(), np.asarray(jgrad),
                               rtol=1e-6, atol=1e-6)
