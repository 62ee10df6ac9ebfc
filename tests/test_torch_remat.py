"""Rematerialization on the CPU: the remat pass (``passes/remat.py``)
and ``layers.RecomputeRegion`` against the JAX package.

* The pass plans the JAX package's segments for the same program
  (``"blocks"``, ``"sqrt"`` and segment counts: cut counts, bounds,
  internal and boundary names, trigger ops) and its activation ledger
  gives the same bytes, with remat on and off.
* Remat on and off train the transformer LM (attention dropout 0.1, as
  bench.py's memory row runs it) to BITWISE equal losses and gradients:
  the replay re-runs the same ops on the same inputs, dropout redraws
  the same masks. The eager run drops each segment-internal activation
  after its last forward reader and again after its last grad reader.
* A ``recompute`` region and ResNet-50 with ``recompute=True`` at 32x32
  train as the JAX package does from the same weights: the small region
  at 1e-6 (fp32, another summation order), ResNet-50 at the tolerances
  of ``tests/test_torch_convnet.py`` (the last batch-norm scale of every
  residual branch damped by 0.03 in both packages; every first-step
  gradient within 5e-2 of its largest magnitude, all within 2e-3 in
  relative L2 norm, the loss rtol 1e-3, running statistics atol 1e-3).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.passes.remat as jremat
import paddle_tpu_torch as tfluid
import paddle_tpu_torch.passes.remat as tremat
from paddle_tpu import layers as jlayers
from paddle_tpu import passes as jpasses
from paddle_tpu import unique_name as jnames
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.models.transformer import transformer_lm as jlm
from paddle_tpu_torch import interop
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import passes as tpasses
from paddle_tpu_torch import unique_name as tnames
from paddle_tpu_torch.core import lower
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.models.transformer import transformer_lm as tlm

# Under pytest-xdist each worker takes its share of the cores for
# torch's intra-op threads: six workers at torch's default thread count
# oversubscribe the cores, and a test of seconds then takes minutes.
_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, os.cpu_count() // int(_WORKERS)))

CPU = tfluid.CPUPlace()
V, S, D, L, H, B = 64, 16, 32, 4, 4, 4
POLICIES = ["blocks", "sqrt", 1, 2, 3]


def _build(fluid, layers, lm, names, v=V, s=S, d=D, n=L, h=H):
    """bench.py's memory-row program (``_bench_memory``), at a small
    width unless given bench.py's."""
    with names.guard():
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            tokens = layers.data("tokens", [s], dtype="int64")
            targets = layers.data("targets", [s], dtype="int64")
            logits = lm(tokens, v, d_model=d, num_layers=n, num_heads=h,
                        max_len=2048, dropout_rate=0.1)
            loss = layers.mean(layers.softmax_with_cross_entropy(
                logits, layers.unsqueeze(targets, [2])))
            fluid.optimizer.Adam(1e-3).minimize(loss)
    return prog, startup, loss


def _port():
    return _build(tfluid, tlayers, tlm, tnames)


def _jax():
    return _build(jfluid, jlayers, jlm, jnames)


def _feed():
    rng = np.random.RandomState(0)
    return {"tokens": rng.randint(0, V, (B, S)).astype(np.int64),
            "targets": rng.randint(0, V, (B, S)).astype(np.int64)}


@pytest.mark.parametrize("policy", POLICIES)
def test_plan_and_ledger_equal_the_jax_packages(policy):
    jprog, _, jloss = _jax()
    tprog, _, tloss = _port()
    jpasses.enable(jprog, remat=policy)
    tpasses.enable(tprog, remat=policy)
    jout, jrep = jpasses.apply(jprog, protected=(jloss.name,))
    tout, trep = tpasses.apply(tprog, protected=(tloss.name,))
    assert trep == jrep
    jplan, tplan = jout._remat_plan, tout._remat_plan
    if jplan is None:
        assert tplan is None and trep == {"remat": 0}
    else:
        assert tplan.describe() == jplan.describe()
        for js, ts in zip(jplan.segments, tplan.segments, strict=True):
            for f in ("start", "end", "internal", "boundary_in",
                      "trigger_uid", "internal_bytes"):
                assert getattr(ts, f) == getattr(js, f), f
    assert tremat.activation_ledger(tout) == jremat.activation_ledger(jout)


def test_ledger_off_counts_everything_stored_as_the_jax_package():
    jprog, _, _ = _jax()
    tprog, _, _ = _port()
    off = tremat.activation_ledger(tprog)
    assert off == jremat.activation_ledger(jprog)
    assert off[0] > 0 and off[1] == 0
    tpasses.enable(tprog, remat="blocks")
    stored, saved = tremat.activation_ledger(tpasses.apply(tprog)[0])
    assert stored + saved == off[0] and saved > 0.9 * off[0]


def test_ledger_at_the_memory_rows_width_equals_the_jax_packages():
    """bench.py's memory row at its TPU width (vocab 32000, seq 512,
    d_model 512, 8 layers, 8 heads): the ledger chip_smoke.py prints for
    the port is the JAX package's, off and "blocks" (18 segments;
    PERF.md quotes the bytes)."""
    full = dict(v=32000, s=512, d=512, n=8, h=8)
    jprog, _, jloss = _build(jfluid, jlayers, jlm, jnames, **full)
    tprog, _, tloss = _build(tfluid, tlayers, tlm, tnames, **full)
    off = tremat.activation_ledger(tprog)
    assert off == jremat.activation_ledger(jprog)
    jpasses.enable(jprog, remat="blocks")
    tpasses.enable(tprog, remat="blocks")
    jout, jrep = jpasses.apply(jprog, protected=(jloss.name,))
    tout, trep = tpasses.apply(tprog, protected=(tloss.name,))
    assert trep == jrep == {"remat": 18}
    on = tremat.activation_ledger(tout)
    assert on == jremat.activation_ledger(jout)
    assert on[0] + on[1] == off[0] and on[0] < 0.05 * off[0]


def test_blocks_cut_one_segment_per_decoder_block_and_more():
    tprog, _, loss = _port()
    report = {}
    for policy in ("blocks", "sqrt", 2):
        tpasses.enable(tprog, remat=policy)
        report[policy] = tpasses.apply(tprog, protected=(loss.name,))[1]
    assert report == {"blocks": {"remat": 11}, "sqrt": {"remat": 4},
                      2: {"remat": 2}}


def _train(policy, steps=3):
    prog, startup, loss = _port()
    if policy is not None:
        tpasses.enable(prog, remat=policy)
    startup.random_seed = 1
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    grads = sorted(p.name + "@GRAD"
                   for p in prog.global_block().all_parameters())
    return [exe.run(prog, feed=_feed(), fetch_list=[loss] + grads,
                    scope=scope) for _ in range(steps)]


@pytest.mark.parametrize("policy", ["blocks", "sqrt", 2])
def test_remat_on_and_off_train_bitwise_equal(policy):
    off, on = _train(None), _train(policy)
    for step, (a, b) in enumerate(zip(off, on)):
        assert float(a[0]) == float(b[0]), step
        for i, (x, y) in enumerate(zip(a, b)):
            assert np.array_equal(x, y), (step, i)
    assert float(on[-1][0]) < float(on[0][0])


def test_replay_finds_internals_dropped_and_rebinds_them(monkeypatch):
    """When a segment's replay starts, none of any segment's internal
    activations is in the environment (each was dropped after its last
    forward reader, or after the last grad reader of an earlier replay);
    the replay rebinds exactly its segment's internals."""
    real = lower._replay_segment
    seen = []

    def spy(ctx, block, seg, env):
        plan = ctx.program._remat_plan
        held = {n for s in plan.segments for n in s.internal if n in env}
        real(ctx, block, seg, env)
        seen.append((seg.idx, held, set(seg.internal) <= set(env)))

    monkeypatch.setattr(lower, "_replay_segment", spy)
    _train("blocks", steps=1)
    assert [s for s, _, _ in seen] == list(range(10, -1, -1))
    assert all(not held and rebound for _, held, rebound in seen)


def test_a_fetched_internal_activation_is_kept_and_equal():
    """A fetch protects its name: the executor re-plans with it kept
    (not internal, never dropped) and the value equals the run without
    remat."""
    prog, startup, loss = _port()
    tpasses.enable(prog, remat="blocks")
    plan = tpasses.apply(prog, protected=(loss.name,))[0]._remat_plan
    name = plan.segments[3].internal[0]
    fetched = {}
    for policy in (None, "blocks"):
        if policy is None:
            tpasses.disable(prog)
        else:
            tpasses.enable(prog, remat=policy)
        scope = tfluid.Scope()
        exe = tfluid.Executor(CPU)
        startup.random_seed = 1
        exe.run(startup, scope=scope)
        fetched[policy] = exe.run(prog, feed=_feed(),
                                  fetch_list=[loss, name], scope=scope)
        if policy is not None:
            (_, run), = [(k, v.program) for k, v in exe._plans.items()
                         if k[1] is not None]
            assert all(name not in s.internal
                       for s in run._remat_plan.segments)
    for a, b in zip(fetched[None], fetched["blocks"]):
        assert np.array_equal(a, b)


# ---- RecomputeRegion ----

def _region_program(fluid, layers, names, region):
    with names.guard():
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            x = layers.data("x", [12])
            y = layers.data("y", [1])
            h = layers.fc(x, 16, act="relu")

            def body(h):
                g = layers.fc(h, 24, act="tanh")
                return layers.fc(g, 16)

            if region:
                rr = layers.RecomputeRegion()
                with rr.scope():
                    rr.output(body(rr.input(h)))
                h = rr()
            else:
                h = body(h)
            loss = layers.mean(layers.elementwise_mul(
                layers.fc(h, 1), y))
            fluid.optimizer.Adam(1e-2).minimize(loss)
    return prog, startup, loss


def test_recompute_region_trains_as_the_jax_package_and_as_no_region():
    rng = np.random.RandomState(4)
    feed = {"x": rng.randn(6, 12).astype(np.float32),
            "y": rng.randn(6, 1).astype(np.float32)}
    jprog, jstart, jloss = _region_program(jfluid, jlayers, jnames, True)
    types = [op.type for op in jprog.global_block().ops]
    assert types.count("recompute") == types.count("recompute_grad") == 1
    jscope = jfluid.Scope()
    jexe = jfluid.Executor()
    jexe.run(jstart, scope=jscope)
    arrays = {v.name: np.asarray(jscope.find_var(v.name))
              for v in jprog.list_vars() if v.persistable}
    grads = sorted(p.name + "@GRAD"
                   for p in jprog.global_block().all_parameters())
    runs = {}
    for region in (True, False):
        tprog, tstart, tloss = _region_program(tfluid, tlayers, tnames,
                                               region)
        tscope = tfluid.Scope()
        interop.load_reference_state(arrays, tscope, CPU, [tprog, tstart])
        texe = tfluid.Executor(CPU)
        runs[region] = [texe.run(tprog, feed=feed,
                                 fetch_list=[tloss] + grads, scope=tscope)
                        for _ in range(3)]
    jruns = [jexe.run(jprog, feed=feed, fetch_list=[jloss.name] + grads,
                      scope=jscope) for _ in range(3)]
    for j, t, plain in zip(jruns, runs[True], runs[False]):
        for a, b, c in zip(j, t, plain):
            np.testing.assert_allclose(b, np.asarray(a), rtol=1e-6,
                                       atol=1e-6)
            np.testing.assert_allclose(b, c, rtol=1e-6, atol=1e-6)


def test_recompute_refuses_a_stateful_name_its_body_does_not_bind():
    """The op's StatefulOut names are collected from the body's outputs
    at build time (a batch norm's running statistics); one the body
    does not bind would misalign values with names, so it raises, as
    the JAX op asserts."""
    with tnames.guard():
        prog, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(prog, startup):
            x = tlayers.data("x", [3, 4, 4])
            rr = tlayers.RecomputeRegion()
            with rr.scope():
                rr.output(tlayers.batch_norm(rr.input(x)))
            loss = tlayers.mean(rr())
    op, = [o for o in prog.global_block().ops if o.type == "recompute"]
    assert len(op.attrs["stateful_names"]) == 2
    assert op.output("StatefulOut") == op.attrs["stateful_names"]
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    feed = {"x": np.random.RandomState(1).randn(2, 3, 4, 4).astype(
        np.float32)}
    mean = op.attrs["stateful_names"][0]
    before = scope.find_var(mean).clone()
    exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
    assert not torch.equal(scope.find_var(mean), before)
    op.attrs["stateful_names"] = op.attrs["stateful_names"] + ["nowhere"]
    with pytest.raises(RuntimeError, match="not bound by the sub-block"):
        exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)


def _damp_branches(prog, arrays, jscope, damp=0.03):
    """The last batch-norm scale of every residual branch times
    ``damp`` (tests/test_torch_convnet.py), found in every block: the
    regions put each residual block in a sub-block."""
    ops = [op for b in prog.blocks for op in b.ops]
    branch = {op.input("Y")[0] for op in ops
              if op.type == "elementwise_add"}
    n_damped = 0
    for op in ops:
        if op.type == "batch_norm" and op.output("Y")[0] in branch:
            n = op.input("Scale")[0]
            arrays[n] = arrays[n] * np.float32(damp)
            jscope.set_var(n, jnp.asarray(arrays[n]))
            n_damped += 1
    return n_damped


def test_resnet50_recompute_at_32_matches_jax():
    kw = dict(image_shape=(3, 32, 32), class_dim=10, recompute=True)
    with jnames.guard():
        jprog, jstart, _, (jloss, _) = jresnet.build_resnet50_train(**kw)
    with tnames.guard():
        tprog, tstart, _, (tloss, _) = tresnet.build_resnet50_train(**kw)
    types = [op.type for op in tprog.global_block().ops]
    assert types.count("recompute") == types.count("recompute_grad") == 16
    jscope = jfluid.Scope()
    jexe = jfluid.Executor()
    jexe.run(jstart, scope=jscope)
    arrays = {v.name: np.asarray(jscope.find_var(v.name))
              for v in jprog.list_vars() if v.persistable}
    assert _damp_branches(jprog, arrays, jscope) == 16
    tscope = tfluid.Scope()
    loaded = interop.load_reference_state(arrays, tscope, CPU,
                                          [tprog, tstart])
    texe = tfluid.Executor(CPU)
    rng = np.random.RandomState(0)
    feed = {"data": rng.randn(8, 3, 32, 32).astype(np.float32),
            "label": rng.randint(0, 10, (8, 1)).astype(np.int64)}
    grads = sorted(p.name + "@GRAD"
                   for p in jprog.global_block().all_parameters())
    jout = jexe.run(jprog, feed=feed, fetch_list=[jloss.name] + grads,
                    scope=jscope)
    tout = texe.run(tprog, feed=feed, fetch_list=[tloss.name] + grads,
                    scope=tscope)
    np.testing.assert_allclose(tout[0], np.asarray(jout[0]), rtol=1e-3)
    num = den = 0.0
    for name, j, t in zip(grads, jout[1:], tout[1:]):
        j = np.asarray(j)
        np.testing.assert_allclose(t, j, rtol=0, atol=5e-2 * np.abs(j).max(),
                                   err_msg=name)
        num += float(((t - j) ** 2).sum())
        den += float((j ** 2).sum())
    assert (num / den) ** 0.5 < 2e-3
    # the regions' batch norms write their running statistics back
    stats = [n for n in loaded if n.endswith((".mean", ".variance"))]
    assert len(stats) == 2 * 53
    for n in stats:
        want = np.asarray(jscope.find_var(n))
        got = tscope.find_var(n).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3, err_msg=n)
        assert not np.array_equal(got, arrays[n]), n
