"""Tensor parallelism ('mp') of the port against the JAX package's, at
gloo worlds on the CPU.

For each world (4 ranks as a ``(dp, mp) = (2, 2)`` mesh, 2 ranks as
``(1, 2)``) one spawn of this file as a script runs the port's side
through ``paddle_tpu_torch.parallel.ParallelExecutor(use_cuda=False,
comm_config=CommConfig())`` (tests/torch_gloo_harness.py), while the
test process runs the JAX package's:

* **mp, exactly**: tests/test_placement.py's two-layer column -> row
  Megatron MLP (``_build_mlp``) on its dyadic grid (weights k * 2^-8,
  0/1 inputs, a linear loss): 3 SGD steps of the port's mp run are
  BITWISE the JAX package's single-device ``Executor`` (its first two
  losses and every parameter; the third loss leaves the grid in both);
* **mp on the transformer** (world 4): ``build_transformer_lm(mp=True)``
  at V 64, L 16, d 32, 2 layers, 4 heads, batch 8, Adam 1e-2, 2 steps
  from the JAX startup's weights against the JAX package's mp run on a
  (2, 2) mesh of its CPU devices: losses within 1e-4 and every state
  tensor within rtol 2e-4, atol 2e-5 (tests/test_placement.py:184-206's
  bounds). Adam's step is lr times m / sqrt(v): an element whose
  gradient nearly cancels carries that sum's rounding into its step
  relative to the gradient, so after two steps at lr 1e-2 the JAX
  package's OWN mp run lies up to 1.7e-4 from its serial run (fc_0.w_0,
  ROADMAP.md Queue 3), past those bounds. Each Adam-trained parameter
  is therefore held at the bounds plus twice the reference's own spread
  on it: the JAX mp run's distance from the JAX serial run, plus the
  two packages' serial runs' distance (the summation order alone); the
  moments and every other state tensor at the bounds alone. The step's
  census attributes every collective to its axis:
  2 forward ``fwd_row`` all-reduces a block and 4 backward ``bwd_col``
  ones (q, k, v and the FFN's up-projection), labelled 'mp', and the
  per-axis counts sum to the flat census;
* **plans and legality** (no spawn): the mp ``CommPlan`` equals the JAX
  plan (buckets of shard-sized gradients, ``mp_params``, ``mp_state``,
  ``mp_specs``), and every case of tests/test_placement.py's
  ``TestPlacementLegalityVerifier`` raises the same error type and
  message in both packages;
* **programs**: the mp and ``seq_axis`` transformer programs build
  byte-identical JSON in both packages.
"""

import json
import os
import shutil
import sys
import tempfile

import numpy as np
import pytest

import torch_gloo_harness as gh

TIMEOUT = 150
MLP_STEPS, TFM_STEPS = 3, 2
D, H = 4, 8
V, L, DM, NL, NH, B = 64, 16, 32, 2, 4, 8
#: world -> the (dp, mp) mesh its ranks form
MESHES = {4: (2, 2), 2: (1, 2)}
WEIGHTS = ("w_col", "b_col", "w_row", "b_row")


# ---- the programs, built alike by both packages ----

def build_mlp(fl, mp):
    """tests/test_placement.py's ``_build_mlp``: column -> row MLP, a
    linear loss, SGD 1.0."""
    from_pa = __import__(fl.__name__ + ".param_attr",
                         fromlist=["ParamAttr"]).ParamAttr
    layers = fl.layers
    prog, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(prog, startup):
        x = layers.data("x", [D])
        y = layers.data("y", [D])
        col = dict(param_attr=from_pa(name="w_col",
                                      sharding=(None, "mp") if mp else None),
                   bias_attr=from_pa(name="b_col",
                                     sharding=("mp",) if mp else None))
        row = dict(param_attr=from_pa(name="w_row",
                                      sharding=("mp", None) if mp else None),
                   bias_attr=from_pa(name="b_row"))
        h = layers.fc(x, H, act="relu", **col)
        out = layers.fc(h, D, **row)
        loss = layers.mean(layers.elementwise_mul(out, y))
        fl.optimizer.SGD(1.0).minimize(loss)
    return prog, startup, loss


def mlp_feed(step, batch=8):
    rng = np.random.RandomState(step)
    return {"x": rng.randint(0, 2, (batch, D)).astype(np.float32),
            "y": (rng.randint(0, 2, (batch, D))
                  * float(batch * D)).astype(np.float32)}


def dyadic(shapes):
    """tests/test_placement.py's ``_seed_dyadic`` grid: {name: k * 2^-8,
    k in {-1, 0, 1}} in name order (both packages get these arrays)."""
    rng = np.random.RandomState(7)
    return {n: rng.randint(-1, 2, shapes[n]).astype(np.float32) * 2.0 ** -8
            for n in sorted(shapes)}


def build_tfm(fl, **kw):
    mod = __import__(fl.__name__ + ".models.transformer",
                     fromlist=["build_transformer_lm"])
    with fl.unique_name.guard():
        prog, startup, _, (loss,) = mod.build_transformer_lm(
            vocab_size=V, seq_len=L, d_model=DM, num_layers=NL,
            num_heads=NH, lr=1e-2, **kw)
    return prog, startup, loss


def tfm_feed(step):
    rng = np.random.RandomState(step)
    return {"tokens": rng.randint(0, V, (B, L)).astype(np.int64),
            "targets": rng.randint(0, V, (B, L)).astype(np.int64)}


# ---- the port's side: one process a rank ----

def _worker(rank, world, d):
    gh.join(rank, world, d, TIMEOUT)
    import torch

    import paddle_tpu_torch as fl
    from paddle_tpu_torch import interop
    from paddle_tpu_torch.parallel import (CommConfig, ParallelExecutor,
                                           comm_audit, make_mesh)

    mesh = make_mesh(MESHES[world], ("dp", "mp"))
    prog, startup, loss = build_mlp(fl, True)
    scope = fl.Scope()
    fl.Executor(fl.CPUPlace()).run(startup, scope=scope)
    with np.load(os.path.join(d, "mlp_init.npz")) as z:
        for n in z.files:
            scope.set_var(n, torch.from_numpy(z[n]))
    pe = ParallelExecutor(use_cuda=False, loss_name=loss.name,
                          main_program=prog, mesh=mesh, zero_stage=0,
                          comm_config=CommConfig())
    losses = [pe.run(feed=mlp_feed(s), fetch_list=[loss.name],
                     scope=scope)[0] for s in range(MLP_STEPS)]
    state = gh.snapshot(scope)
    if rank == 0:
        np.savez(os.path.join(d, "out_mlp.npz"), losses=np.stack(losses),
                 **{"s:" + n: v for n, v in state.items()})
    if world == 4:
        prog, startup, loss = build_tfm(fl, mp=True)
        scope = fl.Scope()
        with np.load(os.path.join(d, "tfm_init.npz")) as z:
            interop.load_reference_state({n: z[n] for n in z.files}, scope,
                                         fl.CPUPlace(), [prog, startup])
        pe = ParallelExecutor(use_cuda=False, loss_name=loss.name,
                              main_program=prog, mesh=mesh, zero_stage=0,
                              comm_config=CommConfig())
        losses = [pe.run(feed=tfm_feed(s), fetch_list=[loss.name],
                         scope=scope)[0] for s in range(TFM_STEPS)]
        state = gh.snapshot(scope)
        census = pe.last_census
        if rank == 0:
            np.savez(os.path.join(d, "out_tfm.npz"),
                     losses=np.stack(losses),
                     **{"s:" + n: v for n, v in state.items()})
            with open(os.path.join(d, "census.json"), "w") as f:
                json.dump({"records": census.records,
                           "axes": comm_audit.axis_stats(census),
                           "flat": comm_audit.collective_stats(census)}, f)
    gh.leave()


# ---- the JAX side, in the test process ----

def _jax_mlp_single(init):
    import paddle_tpu as fl

    prog, startup, loss = build_mlp(fl, False)
    scope = fl.Scope()
    with fl.scope_guard(scope):
        exe = fl.Executor()
        exe.run(startup)
        for n, v in init.items():
            scope.set_var(n, v)
        losses = [np.asarray(exe.run(prog, feed=mlp_feed(s),
                                     fetch_list=[loss.name])[0])
                  for s in range(MLP_STEPS)]
        state = {n: np.asarray(scope.find_var(n)) for n in WEIGHTS}
    return losses, state


def spread(jax_mp, jax_serial, port_serial):
    """{parameter: the reference's own spread on it} (the docstring)."""
    return {n: float(np.abs(jax_mp[n] - jax_serial[n]).max()
                     + np.abs(port_serial[n] - jax_serial[n]).max())
            for n in jax_serial}


def serial_runs(d, steps=TFM_STEPS):
    """Both packages' serial transformer runs from ``d``/tfm_init.npz:
    (JAX state, port state)."""
    import paddle_tpu as jfl
    import paddle_tpu_torch as tfl
    from paddle_tpu_torch import interop

    with np.load(os.path.join(d, "tfm_init.npz")) as z:
        init = {n: z[n] for n in z.files}
    prog, startup, loss = build_tfm(jfl)
    scope = jfl.Scope()
    with jfl.scope_guard(scope):
        exe = jfl.Executor()
        exe.run(startup)
        for n, v in init.items():
            scope.set_var(n, v)
        for s in range(steps):
            exe.run(prog, feed=tfm_feed(s), fetch_list=[loss.name])
        js = {n: np.asarray(scope.find_var(n)) for n in init}
    prog, startup, loss = build_tfm(tfl)
    scope = tfl.Scope()
    interop.load_reference_state(init, scope, tfl.CPUPlace(),
                                 [prog, startup])
    exe = tfl.Executor(tfl.CPUPlace())
    for s in range(steps):
        exe.run(prog, feed=tfm_feed(s), fetch_list=[loss.name], scope=scope)
    return js, {n: np.asarray(scope.find_var(n)) for n in init}


def adam_param(name):
    return "_moment" not in name and "_pow_" not in name \
        and not name.startswith("learning_rate")


def _jax_tfm_mp(d):
    """The JAX package's mp run on a (2, 2) mesh; writes its startup's
    weights for the port first."""
    import paddle_tpu as fl
    from paddle_tpu.parallel import make_mesh
    from paddle_tpu.parallel.collectives import CommConfig
    from paddle_tpu.parallel.parallel_executor import ParallelExecutor

    prog, startup, loss = build_tfm(fl, mp=True)
    scope = fl.Scope()
    with fl.scope_guard(scope):
        fl.Executor().run(startup)
        np.savez(os.path.join(d, "tfm_init.npz"),
                 **{n: np.asarray(scope.find_var(n))
                    for n in scope.local_var_names()
                    if hasattr(scope.find_var(n), "shape")})
        pe = ParallelExecutor(loss_name=loss.name, main_program=prog,
                              mesh=make_mesh((2, 2), ("dp", "mp")),
                              zero_stage=0, comm_config=CommConfig())
        losses = [float(np.asarray(pe.run(feed=tfm_feed(s),
                                          fetch_list=[loss.name])[0]))
                  for s in range(TFM_STEPS)]
        state = {n: np.asarray(scope.find_var(n))
                 for n in scope.local_var_names()
                 if hasattr(scope.find_var(n), "shape")
                 and not n.startswith("__")}
    return losses, state


@pytest.fixture(scope="module", params=sorted(MESHES, reverse=True),
                ids=lambda w: "world%d" % w)
def world_run(request):
    """One spawn of a world's ranks while the JAX runs go on here:
    (world, port MLP (losses, state), JAX single-device MLP, port
    transformer, JAX transformer, census) — the transformer's at world
    4 only."""
    import paddle_tpu as jfl

    world = request.param
    d = tempfile.mkdtemp(prefix="ptp_mp_")
    yard = None
    try:
        prog, startup, _ = build_mlp(jfl, False)
        scope = jfl.Scope()
        with jfl.scope_guard(scope):
            jfl.Executor().run(startup)
            init = dyadic({n: np.shape(scope.find_var(n))
                           for n in WEIGHTS})
        np.savez(os.path.join(d, "mlp_init.npz"), **init)
        jtfm = _jax_tfm_mp(d) if world == 4 else None
        started = gh.start(__file__, world, d, TIMEOUT)
        try:
            jmlp = _jax_mlp_single(init)
            if world == 4:
                yard = spread(jtfm[1], *serial_runs(d))
        finally:
            gh.finish(started, d)
        with np.load(os.path.join(d, "out_mlp.npz")) as z:
            pmlp = (list(z["losses"]), {k[2:]: z[k] for k in z.files
                                        if k.startswith("s:")})
        ptfm = census = None
        if world == 4:
            with np.load(os.path.join(d, "out_tfm.npz")) as z:
                ptfm = (list(z["losses"]), {k[2:]: z[k] for k in z.files
                                            if k.startswith("s:")})
            with open(os.path.join(d, "census.json")) as f:
                census = json.load(f)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return world, pmlp, jmlp, ptfm, jtfm, census, yard


def test_mlp_is_bitwise_the_jax_single_device_run(world_run):
    world, (pl, ps), (jl, js) = world_run[:3]
    for a, b in zip(pl[:2], jl[:2]):
        assert np.float32(a).tobytes() == np.float32(b).tobytes(), (a, b)
    for n in WEIGHTS:
        assert ps[n].shape == js[n].shape, n
        assert ps[n].astype(np.float32).tobytes() == js[n].tobytes(), (
            n, np.abs(ps[n] - js[n]).max())


#: the transformer's tests: the world of 4 only
WORLD4 = pytest.mark.parametrize("world_run", [4], indirect=True,
                                 ids=["world4"])


@WORLD4
def test_transformer_mp_matches_the_jax_mp_run(world_run):
    (pl, ps), (jl, js), _, yard = world_run[3:]
    for a, b in zip(pl, jl):
        assert abs(float(a) - b) < 1e-4 * max(1.0, abs(b)), (pl, jl)
    assert set(js) <= set(ps), set(js) - set(ps)
    for n in sorted(js):
        assert ps[n].shape == js[n].shape, n
        extra = 2.0 * yard[n] if adam_param(n) else 0.0
        assert np.allclose(ps[n], js[n], rtol=2e-4, atol=2e-5 + extra), (
            n, np.max(np.abs(ps[n] - js[n])), extra)


@WORLD4
def test_census_attributes_each_collective_to_its_axis(world_run):
    census = world_run[5]
    tags = [r["tag"] for r in census["records"] if r["axis"] == "mp"]
    # the two Megatron pairs of each block: one forward all-reduce after
    # each row-split projection, one backward after each column-split
    # one's input gradient (q, k, v and the FFN's up-projection)
    assert tags.count("mp.fwd_row") == 2 * NL, tags
    assert tags.count("mp.bwd_col") == 4 * NL, tags
    axes = census["axes"]
    assert axes["mp"]["all_reduce"]["count"] >= 2 * NL
    assert "dp" in axes and "all_to_all" in axes["dp"]
    assert sum(k["count"] for kinds in axes.values()
               for k in kinds.values()) == \
        sum(v["count"] for v in census["flat"].values()) == \
        len(census["records"])


# ---- no spawn: the plans, the programs and the refusals ----

@pytest.mark.parametrize("kw", [dict(mp=True), dict(seq_axis="sp")],
                         ids=["mp", "seq_axis"])
def test_programs_build_byte_identical(kw):
    import paddle_tpu as jfl
    import paddle_tpu_torch as tfl

    a = json.dumps(build_tfm(jfl, **kw)[0].to_dict(), sort_keys=True,
                   indent=1)
    b = json.dumps(build_tfm(tfl, **kw)[0].to_dict(), sort_keys=True,
                   indent=1)
    assert a == b


def test_mp_plan_equals_the_jax_plan():
    import paddle_tpu as jfl
    import paddle_tpu_torch as tfl
    from paddle_tpu.parallel import collectives as jcol
    from paddle_tpu.parallel import make_mesh as jmesh
    from paddle_tpu_torch import interop
    from paddle_tpu_torch.parallel import collectives as tcol
    from paddle_tpu_torch.parallel.mesh import Mesh

    jprog, jstart, _ = build_tfm(jfl, mp=True)
    jscope = jfl.Scope()
    with jfl.scope_guard(jscope):
        jfl.Executor().run(jstart)
    tprog, tstart, _ = build_tfm(tfl, mp=True)
    tscope = tfl.Scope()
    interop.load_reference_state(
        {n: np.asarray(jscope.find_var(n))
         for n in jscope.local_var_names()}, tscope, tfl.CPUPlace(),
        [tprog, tstart])
    jp = jcol.plan_for(jcol.CommConfig(bucket_mb=0.05), jprog, jscope,
                       jmesh((2, 2), ("dp", "mp")))
    tp = tcol.plan_for(tcol.CommConfig(bucket_mb=0.05), tprog, tscope,
                       Mesh(("dp", "mp"), (2, 2), range(4)))
    assert tp.describe() == jp.describe()
    assert tp.key == jp.key
    assert tp.mp_params == jp.mp_params and tp.mp_state == jp.mp_state
    assert [(b.grads, b.sizes, b.padded) for b in tp.buckets] == \
        [(b.grads, b.sizes, b.padded) for b in jp.buckets]
    assert tcol.mp_specs(tp, tprog) == {
        n: tuple(s) for n, s in jcol.mp_specs(jp, jprog).items()}


def _refusal(fn):
    """(exception type name, message, check, var) of ``fn``'s refusal."""
    with pytest.raises(Exception) as e:
        fn()
    v = e.value
    return (type(v).__name__, str(v), getattr(v, "check", None),
            getattr(v, "var", None))


def _legality_case(fl, case):
    """The refusal of one TestPlacementLegalityVerifier case, in package
    ``fl`` (``paddle_tpu`` or ``paddle_tpu_torch``)."""
    import types

    eff = __import__(fl.__name__ + ".analysis.effects",
                     fromlist=["check_mp_placement"])
    pa = __import__(fl.__name__ + ".param_attr",
                    fromlist=["ParamAttr"]).ParamAttr
    layers = fl.layers
    if case in ("mp-collective", "mp-consumer"):
        prog, startup = fl.Program(), fl.Program()
        with fl.unique_name.guard(), fl.program_guard(prog, startup):
            x = layers.data("x", [D])
            if case == "mp-collective":
                # the 'mp'-sharded bias reaches only an elementwise_add
                layers.fc(x, H, param_attr=pa(name="w0"),
                          bias_attr=pa(name="b_col"))
                plan = {"b_col": "col"}
            else:
                # mean() over a col-split (mp-local) activation
                h = layers.fc(x, H, param_attr=pa(name="w_col"),
                              bias_attr=False)
                layers.mean(h)
                plan = {"w_col": "col"}
        ns = types.SimpleNamespace(mp_params=plan, mp_state={})
        return lambda: eff.check_mp_placement(ns, prog)
    if case.startswith("pp-stage-gap"):
        bounds, fwd_end = {"pp-stage-gap-start": ([1, 5], 5),
                           "pp-stage-gap-orphan": ([0, 3], 5),
                           "pp-stage-gap-empty": ([0, 3, 3, 5], 5)}[case]
        return lambda: eff.check_stage_plan(bounds, fwd_end)
    col = __import__(fl.__name__ + ".parallel.collectives",
                     fromlist=["CommConfig"])
    prog, startup, _ = build_mlp(fl, case != "no-sharded-params")
    if fl.__name__ == "paddle_tpu":
        from paddle_tpu.parallel import make_mesh

        scope = fl.Scope()
        with fl.scope_guard(scope):
            fl.Executor().run(startup)
        axes = ("dp", "pp") if case == "non-mp-multi-axis" \
            else ("dp", "mp")
        mesh = make_mesh((4, 2), axes)
    else:
        from paddle_tpu_torch.parallel.mesh import Mesh

        scope = fl.Scope()
        fl.Executor(fl.CPUPlace()).run(startup, scope=scope)
        axes = ("dp", "pp") if case == "non-mp-multi-axis" \
            else ("dp", "mp")
        mesh = Mesh(axes, (4, 2), range(8))
    cfg = {"zero-stage-under-mp": dict(zero_stage=1),
           "error-feedback-under-mp": dict(quantize="int8")}.get(case, {})
    return lambda: col.plan_for(col.CommConfig(**cfg), prog, scope, mesh)


@pytest.mark.parametrize("case", [
    "mp-collective", "mp-consumer", "pp-stage-gap-start",
    "pp-stage-gap-orphan", "pp-stage-gap-empty", "non-mp-multi-axis",
    "no-sharded-params", "zero-stage-under-mp", "error-feedback-under-mp"])
def test_legality_refusals_read_as_jax(case):
    import paddle_tpu as jfl
    import paddle_tpu_torch as tfl

    got = _refusal(_legality_case(tfl, case))
    want = _refusal(_legality_case(jfl, case))
    assert got == want


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
