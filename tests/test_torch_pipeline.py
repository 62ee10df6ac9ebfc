"""Pipeline parallelism ('pp') of the port against the JAX package's, at
gloo worlds on the CPU.

For each world (2, 4 and 8 ranks) one spawn of this file as a script
runs the port's side, one process a rank (tests/torch_gloo_harness.py),
while the test process runs the JAX package's:

* **the functions** (``parallel.pipeline``) on tests/test_placement.py's
  and tests/test_pipeline.py's stage (``tanh(x @ w + b (+ c))``, their
  seeds) at (S, M) = (2, 2) on a ('pp',) mesh of 2, (4, 8) on one of 4
  and (2, 4) on a (dp 2, pp 2) mesh: ``pipeline_parallel_stacked``
  (GPipe), ``pipeline_1f1b`` and ``pipeline_parallel`` (heterogeneous
  stages) against the JAX package's own functions on its virtual mesh,
  outputs at rtol 1e-5, atol 1e-6 and gradients (of ``mean(y**2)``) at
  rtol 1e-4, atol 1e-6 (those tests' bounds). GPipe's and 1F1B's
  gradients are bitwise equal on every rank, and 1F1B's stage ``st``
  held at most ``2(S-1-st)+1`` inputs.
* **the DSL** (``layers.Pipeline``): tests/test_placement.py's
  trajectories (3 SGD steps of the pipelined fc, batch 16) under the
  serial ``Executor``, GPipe and 1F1B at pp 4 and 1F1B at dp 2 x pp 2
  (a 2-stage program), each against the JAX package's serial run within
  1e-4 (the bound its parity test holds the JAX pp runs to), and every
  rank holding exactly 1/S of every stacked parameter (and of its
  accumulators: the port's layout, ``ParallelExecutor``'s docstring).
* **the transformer**: ``build_transformer_lm(pp_stages=2, pp_micro=4)``
  (V 100, L 32, d 64, 4 layers, 4 heads, batch 16, Adam 1e-3) at dp 2 x
  pp 2 for 3 steps against the JAX package's serial run within 2e-3
  (tests/test_pipeline.py:219-263's band), 1/2 of the stacked bytes a
  rank.
* **three axes**: tests/test_pipeline.py:267-305's program (a 2-stage
  pipelined fc, an 'mp'-split head, here closed by a row-split
  projection: ``build_three``) on a (dp, mp, pp) = (2, 2, 2) mesh
  at gloo world 8, zero_stage 0 (the port's global view over 'mp' needs
  it): losses finite and falling, within 1e-4 of the JAX package's
  serial run, each rank holding 1/2 of the stacked weight.

The ``ParallelExecutor`` runs take ``zero_stage=0`` where the mesh's dp
axis has two ranks (ZeRO-1 over 'dp' does not compose with the held
axes yet: ROADMAP.md Queue 3).
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
D = 8
#: (tag, world, stages, microbatches, axes, mesh shape)
FN_CASES = [("pp2", 2, 2, 2, ("pp",), (2,)),
            ("pp4", 4, 4, 8, ("pp",), (4,)),
            ("dp2pp2", 4, 2, 4, ("dp", "pp"), (2, 2))]
#: the DSL's runs: (tag, schedule, stages, microbatches, axes, shape)
DSL_RUNS = [("gpipe-pp4", "gpipe", 4, 8, ("pp",), (4,)),
            ("1f1b-pp4", "1f1b", 4, 8, ("pp",), (4,)),
            ("1f1b-dp2pp2", "1f1b", 2, 4, ("dp", "pp"), (2, 2))]
#: the global norm the clip case's gradients exceed
CLIP = 0.01
TFM = dict(vocab_size=100, seq_len=32, d_model=64, num_layers=4,
           num_heads=4, pp_stages=2, pp_micro=4)
STEPS = 3


# ---- the inputs and programs, made alike for both packages ----

def fn_inputs(s):
    """tests/test_placement.py's 1F1B setup (seed 1), and the
    heterogeneous stages' list of per-stage params."""
    rng = np.random.RandomState(1)
    w = (rng.rand(s, D, D).astype(np.float32) - .5)
    b = (rng.rand(s, D).astype(np.float32) - .5)
    x = rng.rand(4 * s, D).astype(np.float32)
    c = rng.rand(D).astype(np.float32) * 0.1
    return w, b, x, c


def build_dsl(fl, schedule, stages, micro, clip=None):
    """tests/test_placement.py's pipelined fc; ``clip``: every gradient
    under one ``GradientClipByGlobalNorm(clip)``."""
    layers = fl.layers
    with fl.unique_name.guard():
        prog, startup = fl.Program(), fl.Program()
        with fl.program_guard(prog, startup):
            x = layers.data("x", [64])
            pipe = layers.Pipeline(num_stages=stages, num_micro=micro,
                                   schedule=schedule)
            kw = {}
            if clip is not None:
                g = fl.clip.GradientClipByGlobalNorm(clip)
                kw = dict(param_attr=fl.ParamAttr(gradient_clip=g),
                          bias_attr=fl.ParamAttr(gradient_clip=g))
            with pipe.stage():
                h = pipe.input(x)
                h = layers.fc(h, 64, act="relu", **kw)
                pipe.output(h)
            loss = layers.mean(pipe())
            fl.optimizer.SGD(0.1).minimize(loss)
    return prog, startup, loss


def build_three(fl):
    """tests/test_pipeline.py's three-axis program, its 'mp' head closed
    by a row-split projection: the port's weight-locality analysis
    refuses an open column split reaching the loss, where the JAX
    package's partitioner gathers it (ROADMAP.md Queue 3)."""
    layers = fl.layers
    pa = __import__(fl.__name__ + ".param_attr",
                    fromlist=["ParamAttr"]).ParamAttr
    with fl.unique_name.guard():
        prog, startup = fl.Program(), fl.Program()
        with fl.program_guard(prog, startup):
            x = layers.data("x", [64])
            pipe = layers.Pipeline(num_stages=2, num_micro=2)
            with pipe.stage():
                h = pipe.input(x)
                h = layers.fc(h, 64, act="relu")
                pipe.output(h)
            logits = layers.fc(pipe(), 16,
                               param_attr=pa(sharding=(None, "mp")),
                               bias_attr=False)
            logits = layers.fc(logits, 16,
                               param_attr=pa(sharding=("mp", None)),
                               bias_attr=False)
            loss = layers.mean(layers.square(logits))
            fl.optimizer.SGD(0.1).minimize(loss)
    return prog, startup, loss


def build_tfm(fl, **kw):
    mod = __import__(fl.__name__ + ".models.transformer",
                     fromlist=["build_transformer_lm"])
    with fl.unique_name.guard():
        prog, startup, _, (loss,) = mod.build_transformer_lm(**dict(TFM,
                                                                    **kw))
    return prog, startup, loss


def dsl_x():
    return np.random.RandomState(0).rand(16, 64).astype(np.float32)


def three_x():
    return np.random.RandomState(0).rand(8, 64).astype(np.float32)


def tfm_feed():
    rng = np.random.RandomState(0)
    return {"tokens": rng.randint(0, 100, (16, 32)).astype(np.int64),
            "targets": rng.randint(0, 100, (16, 32)).astype(np.int64)}


# ---- the port's side: one process a rank ----

def _port_functions(tag, s, m, axes, shape):
    import torch

    from paddle_tpu_torch.parallel import make_mesh
    from paddle_tpu_torch.parallel import pipeline as pl

    mesh = make_mesh(shape, axes)
    ba = "dp" if "dp" in axes else None
    w, b, x, c = (torch.from_numpy(a) for a in fn_inputs(s))

    def stage(p, a):
        return torch.tanh(a @ p["w"] + p["b"])

    def stage_c(p, cs, a):
        return torch.tanh(a @ p["w"] + p["b"] + cs[0])

    out = {}
    wl, bl, xl = (t.clone().requires_grad_() for t in (w, b, x))
    y = pl.pipeline_parallel_stacked(stage, mesh, num_micro=m,
                                     batch_axis=ba)({"w": wl, "b": bl}, xl)
    torch.mean(y ** 2).backward()
    out.update({"g.y": y, "g.dw": wl.grad, "g.db": bl.grad,
                "g.dx": xl.grad})
    wl, bl, xl, cl = (t.clone().requires_grad_() for t in (w, b, x, c))
    fn = pl.pipeline_1f1b(stage_c, mesh, num_micro=m, batch_axis=ba)
    y = fn({"w": wl, "b": bl}, [cl], xl)
    torch.mean(y ** 2).backward()
    out.update({"f.y": y, "f.dw": wl.grad, "f.db": bl.grad,
                "f.dc": cl.grad, "f.dx": xl.grad})
    # GPipe's stage through the 1F1B schedule: bitwise GPipe's gradients
    wl, bl, xl = (t.clone().requires_grad_() for t in (w, b, x))
    ffn = pl.pipeline_1f1b(lambda p, cs, a: stage(p, a), mesh, num_micro=m,
                           batch_axis=ba)
    torch.mean(ffn({"w": wl, "b": bl}, [], xl) ** 2).backward()
    out.update({"f0.dw": wl.grad, "f0.db": bl.grad,
                "f0.dx": xl.grad})
    peak = fn.peak
    st = mesh.axis_rank("pp")
    assert peak[st] <= 2 * (s - 1 - st) + 1, (peak, st)
    # heterogeneous stages: every stage's params a list entry
    ps = [{"w": w[i].clone().requires_grad_(),
           "b": b[i].clone().requires_grad_()} for i in range(s)]
    xl = x.clone().requires_grad_()
    y = pl.pipeline_parallel([stage] * s, mesh, num_micro=m)(ps, xl)
    torch.mean(y ** 2).backward()
    out.update({"h.y": y, "h.dx": xl.grad,
                "h.dw": torch.stack([p["w"].grad for p in ps]),
                "h.db": torch.stack([p["b"].grad for p in ps])})
    return {k: v.detach().numpy() for k, v in out.items()}, \
        {"peak": peak[st], "stage": st}


def _held_share(scope):
    """{name: local elements / whole elements} of every value the scope
    holds a slice of (1/S each for a stacked parameter and its
    accumulators)."""
    from paddle_tpu_torch.parallel.collectives import ShardedState

    out = {}
    for n in sorted(scope.local_var_names()):
        t = scope.find_var(n)
        if isinstance(t, ShardedState):
            out[n] = t.numel() / float(np.prod(t.full_shape))
    return out


def stacked_names(prog):
    """The stacked parameters and their same-shaped accumulators."""
    b0 = prog.global_block()
    names = {n for n, v in b0.vars.items()
             if tuple(getattr(v, "sharding", None) or ())[:1] == ("pp",)}
    for n, v in b0.vars.items():
        o = getattr(v, "optimizer_state_for", None)
        if o in names and tuple(v.shape) == tuple(b0.vars[o].shape):
            names.add(n)
    return names


def _port_executor(fl, build, feed, init, axes, shape, steps=STEPS):
    from paddle_tpu_torch import interop
    from paddle_tpu_torch.parallel import ParallelExecutor, make_mesh

    prog, startup, loss = build()
    scope = fl.Scope()
    interop.load_reference_state(init, scope, fl.CPUPlace(),
                                 [prog, startup])
    pe = ParallelExecutor(use_cuda=False, loss_name=loss.name,
                          main_program=prog, mesh=make_mesh(shape, axes),
                          zero_stage=0)
    losses = [float(pe.run(feed=feed, fetch_list=[loss.name],
                           scope=scope)[0]) for _ in range(steps)]
    return losses, _held_share(scope)


def _guarded(fl, init, axes=None, shape=None):
    """[(loss, grad norm)] of 2 steps of the 2-stage DSL program under
    the training-health guard: serial (``axes`` None) or pipelined."""
    from paddle_tpu_torch import guard, interop
    from paddle_tpu_torch.parallel import ParallelExecutor, make_mesh

    prog, startup, loss = build_dsl(fl, "1f1b", 2, 2)
    guard.enable(prog, loss)
    scope = fl.Scope()
    interop.load_reference_state(init, scope, fl.CPUPlace(),
                                 [prog, startup])
    exe = fl.Executor(fl.CPUPlace()) if axes is None else ParallelExecutor(
        use_cuda=False, loss_name=loss.name, main_program=prog,
        mesh=make_mesh(shape, axes), zero_stage=0)
    rows = []
    for _ in range(2):
        exe.run(program=prog, feed={"x": dsl_x()}, fetch_list=[loss.name],
                scope=scope)
        h = exe.poll_health()
        rows.append([float(h[0, 0]), float(h[0, 1])])
    return rows


def _worker(rank, world, d):
    gh.join(rank, world, d, TIMEOUT)
    import paddle_tpu_torch as fl

    res = {"fn": {}, "dsl": {}, "share": {}}
    arrays = {}
    for tag, w, s, m, axes, shape in FN_CASES:
        if w != world:
            continue
        out, info = _port_functions(tag, s, m, axes, shape)
        arrays.update({tag + ":" + k: v for k, v in out.items()})
        res["fn"][tag] = info
    if world == 2:
        # a global norm across the stages: each stage's squares summed
        # over the pp line
        with np.load(os.path.join(d, "clip_init.npz")) as z:
            init = {n: z[n] for n in z.files}
        losses, _ = _port_executor(
            fl, lambda: build_dsl(fl, "1f1b", 2, 2, clip=CLIP),
            {"x": dsl_x()}, init, ("pp",), (2,))
        res["dsl"]["clip"] = losses
        with np.load(os.path.join(d, "plain_init.npz")) as z:
            init = {n: z[n] for n in z.files}
        res["guard"] = _guarded(fl, init, ("pp",), (2,))
    if world == 4:
        with np.load(os.path.join(d, "dsl_init.npz")) as z:
            inits = {k: {n[len(k) + 1:]: z[n] for n in z.files
                         if n.startswith(k + ":")} for k in ("s4", "s2")}
        for tag, sched, s, m, axes, shape in DSL_RUNS:
            losses, share = _port_executor(
                fl, lambda: build_dsl(fl, sched, s, m), {"x": dsl_x()},
                inits["s%d" % s], axes, shape)
            res["dsl"][tag] = losses
            res["share"][tag] = share
        with np.load(os.path.join(d, "tfm_init.npz")) as z:
            init = {n: z[n] for n in z.files}
        losses, share = _port_executor(fl, lambda: build_tfm(fl),
                                       tfm_feed(), init, ("dp", "pp"),
                                       (2, 2))
        res["dsl"]["tfm"] = losses
        res["share"]["tfm"] = share
    if world == 8:
        with np.load(os.path.join(d, "three_init.npz")) as z:
            init = {n: z[n] for n in z.files}
        losses, share = _port_executor(fl, lambda: build_three(fl),
                                       {"x": three_x()}, init,
                                       ("dp", "mp", "pp"), (2, 2, 2))
        res["dsl"]["three"] = losses
        res["share"]["three"] = share
    with open(os.path.join(d, "res%d.json" % rank), "w") as f:
        json.dump(res, f)
    np.savez(os.path.join(d, "arr%d.npz" % rank), **arrays)
    gh.leave()


# ---- the JAX side, in the test process ----

def _jax_functions(s, m, axes, shape):
    import jax
    import jax.numpy as jnp

    from paddle_tpu.parallel import make_mesh
    from paddle_tpu.parallel import pipeline as jpl

    mesh = make_mesh(shape, axes)
    ba = "dp" if "dp" in axes else None
    w, b, x, c = (jnp.asarray(a) for a in fn_inputs(s))
    stacked = {"w": w, "b": b}

    def stage(p, a):
        return jnp.tanh(a @ p["w"] + p["b"])

    def stage_c(p, cs, a):
        return jnp.tanh(a @ p["w"] + p["b"] + cs[0])

    out = {}
    g = jpl.pipeline_parallel_stacked(stage, mesh, num_micro=m,
                                      batch_axis=ba)
    out["g.y"] = g(stacked, x)
    gp, gx = jax.grad(lambda p, xx: jnp.mean(g(p, xx) ** 2),
                      argnums=(0, 1))(stacked, x)
    out.update({"g.dw": gp["w"], "g.db": gp["b"], "g.dx": gx})
    f = jpl.pipeline_1f1b(stage_c, mesh, num_micro=m, batch_axis=ba)
    out["f.y"] = f(stacked, [c], x)
    fp, fc, fx = jax.grad(lambda p, cc, xx: jnp.mean(f(p, cc, xx) ** 2),
                          argnums=(0, 1, 2))(stacked, [c], x)
    out.update({"f.dw": fp["w"], "f.db": fp["b"], "f.dc": fc[0],
                "f.dx": fx})
    ps = [{"w": w[i], "b": b[i]} for i in range(s)]
    h = jpl.pipeline_parallel([stage] * s, mesh, num_micro=m)
    out["h.y"] = h(ps, x)
    hp, hx = jax.grad(lambda p, xx: jnp.mean(h(p, xx) ** 2),
                      argnums=(0, 1))(ps, x)
    out.update({"h.dx": hx, "h.dw": jnp.stack([p["w"] for p in hp]),
                "h.db": jnp.stack([p["b"] for p in hp])})
    return {k: np.asarray(v) for k, v in out.items()}


def _jax_serial(build, feed, steps=STEPS):
    """(startup weights, losses) of the JAX package's serial run."""
    import paddle_tpu as jfl

    prog, startup, loss = build(jfl)
    scope = jfl.Scope()
    with jfl.scope_guard(scope):
        exe = jfl.Executor()
        exe.run(startup)
        init = {n: np.asarray(scope.find_var(n))
                for n in scope.local_var_names()
                if hasattr(scope.find_var(n), "shape")}
        losses = [float(np.asarray(exe.run(prog, feed=feed,
                                           fetch_list=[loss.name])[0]))
                  for _ in range(steps)]
    return init, losses


def _port_serial(build, feed, init, steps=STEPS):
    import paddle_tpu_torch as tfl
    from paddle_tpu_torch import interop

    prog, startup, loss = build(tfl)
    scope = tfl.Scope()
    interop.load_reference_state(init, scope, tfl.CPUPlace(),
                                 [prog, startup])
    exe = tfl.Executor(tfl.CPUPlace())
    return [float(exe.run(prog, feed=feed, fetch_list=[loss],
                          scope=scope)[0]) for _ in range(steps)]


@pytest.fixture(scope="module")
def worlds():
    """``worlds(n)``: the results of the world of ``n`` ranks, spawned
    once for the module (whatever order its tests run in)."""
    done = {}

    def get(world):
        if world not in done:
            done[world] = _spawn(world)
        return done[world]

    return get


def _spawn(world):
    """One spawn of a world's ranks while the JAX side runs here."""
    d = tempfile.mkdtemp(prefix="ptp_pp_")
    ref = {"fn": {}, "serial": {}, "port_serial": {}}
    try:
        if world == 4:
            inits = {}
            for s, m in ((4, 8), (2, 4)):
                inits["s%d" % s], ref["serial"]["s%d" % s] = _jax_serial(
                    lambda fl: build_dsl(fl, "gpipe", s, m), {"x": dsl_x()})
            np.savez(os.path.join(d, "dsl_init.npz"),
                     **{k + ":" + n: v for k, i in inits.items()
                        for n, v in i.items()})
            tinit, ref["serial"]["tfm"] = _jax_serial(build_tfm, tfm_feed())
            np.savez(os.path.join(d, "tfm_init.npz"), **tinit)
        if world == 2:
            cinit, ref["serial"]["clip"] = _jax_serial(
                lambda fl: build_dsl(fl, "1f1b", 2, 2, clip=CLIP),
                {"x": dsl_x()})
            np.savez(os.path.join(d, "clip_init.npz"), **cinit)
            pinit, ref["serial"]["noclip"] = _jax_serial(
                lambda fl: build_dsl(fl, "1f1b", 2, 2), {"x": dsl_x()})
            np.savez(os.path.join(d, "plain_init.npz"), **pinit)
        if world == 8:
            tinit, ref["serial"]["three"] = _jax_serial(
                lambda fl: build_three(fl), {"x": three_x()})
            np.savez(os.path.join(d, "three_init.npz"), **tinit)
        started = gh.start(__file__, world, d, TIMEOUT)
        try:
            for tag, w, s, m, axes, shape in FN_CASES:
                if w == world:
                    ref["fn"][tag] = _jax_functions(s, m, axes, shape)
            if world == 2:
                import paddle_tpu_torch as tfl

                ref["guard"] = _guarded(tfl, pinit)
            if world == 4:
                ref["port_serial"]["s4"] = _port_serial(
                    lambda fl: build_dsl(fl, "gpipe", 4, 8),
                    {"x": dsl_x()}, inits["s4"])
        finally:
            gh.finish(started, d)
        res, arrs = [], []
        for r in range(world):
            with open(os.path.join(d, "res%d.json" % r)) as f:
                res.append(json.load(f))
            with np.load(os.path.join(d, "arr%d.npz" % r)) as z:
                arrs.append({k: z[k] for k in z.files})
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return world, res, arrs, ref


def _fn_case(world_run, tag):
    world, res, arrs, ref = world_run
    if tag not in ref["fn"]:
        pytest.skip("case %s runs at another world" % tag)
    return res, arrs, ref["fn"][tag]


#: each function case at its world
FN_PARAMS = pytest.mark.parametrize(
    "world,tag", [(c[1], c[0]) for c in FN_CASES],
    ids=[c[0] for c in FN_CASES])


@FN_PARAMS
def test_functions_match_the_jax_functions(worlds, world, tag):
    """Every rank's outputs and gradients (the whole ones: the port's
    plain functions give the global view's) against the JAX package's
    functions on the same inputs."""
    res, arrs, want = _fn_case(worlds(world), tag)
    for r, a in enumerate(arrs):
        for k, v in want.items():
            got = a[tag + ":" + k]
            tol = dict(rtol=1e-5, atol=1e-6) if k.endswith(".y") \
                else dict(rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(got, v, err_msg="rank %d %s %s"
                                       % (r, tag, k), **tol)


@FN_PARAMS
def test_gpipe_and_1f1b_gradients_are_bitwise_equal(worlds, world, tag):
    res, arrs, _ = _fn_case(worlds(world), tag)
    s = next(c[2] for c in FN_CASES if c[0] == tag)
    for r, a in enumerate(arrs):
        for k in ("dw", "db", "dx"):
            assert a[tag + ":f0." + k].tobytes() == \
                a[tag + ":g." + k].tobytes(), (r, tag, k)
        st, peak = res[r]["fn"][tag]["stage"], res[r]["fn"][tag]["peak"]
        # the 1F1B activation bound (or M, where M is smaller)
        m = next(c[3] for c in FN_CASES if c[0] == tag)
        assert peak == min(2 * (s - 1 - st) + 1, m), (r, st, peak)


def test_global_norm_clip_sums_over_the_stages(worlds):
    """``GradientClipByGlobalNorm`` at a norm the gradients exceed: the
    clipped trajectory at pp 2 is the JAX package's serial one (a norm
    over one stage's gradients alone would scale by another factor)."""
    world, res, _, ref = worlds(2)
    want, free = ref["serial"]["clip"], ref["serial"]["noclip"]
    assert abs(want[1] - free[1]) > 1e-4, (want, free)
    for r in range(world):
        got = res[r]["dsl"]["clip"]
        assert all(abs(a - b) < 1e-5 for a, b in zip(got, want)), (
            r, got, want)


def test_the_guards_norm_sums_over_the_stages(worlds):
    """The training-health guard's gradient norm at pp 2 is the serial
    run's (each stage's squares summed over the pp line)."""
    world, res, _, ref = worlds(2)
    want = ref["guard"]
    for r in range(world):
        got = res[r]["guard"]
        assert np.allclose(got, want, rtol=1e-5, atol=0), (r, got, want)


def test_dsl_trajectories_match_the_jax_serial_run(worlds):
    """tests/test_placement.py's schedule parity: serial, GPipe pp4,
    1F1B pp4 and 1F1B dp2 x pp2 (its 2-stage program against its own
    serial run), within 1e-4 of the JAX package's serial losses."""
    world, res, arrs, ref = worlds(4)
    want = ref["serial"]
    assert all(abs(a - b) < 1e-4 for a, b in zip(
        ref["port_serial"]["s4"], want["s4"])), ref
    for r in range(world):
        got = res[r]["dsl"]
        for tag, _, s, _, _, _ in DSL_RUNS:
            assert all(abs(a - b) < 1e-4 for a, b in zip(
                got[tag], want["s%d" % s])), (r, tag, got[tag], want)
        # every rank of a step reads the same global loss
        assert got == res[0]["dsl"]
        # the two schedules' gradients are the same bits, so are their
        # trajectories
        assert got["gpipe-pp4"] == got["1f1b-pp4"], got


def test_each_rank_holds_one_stage_of_the_stacked_state(worlds):
    import paddle_tpu_torch as tfl

    world, res, _, _ = worlds(4)
    for r in range(world):
        for tag, _, s, _, _, _ in DSL_RUNS:
            share = res[r]["share"][tag]
            # fc_0.w_0, fc_0.b_0 (SGD keeps no accumulators)
            assert len(share) == 2 and all(
                v == 1.0 / s for v in share.values()), (r, tag, share)
        tshare = res[r]["share"]["tfm"]
        # every stacked parameter and both of Adam's moments of each
        assert set(tshare) == stacked_names(build_tfm(tfl)[0]) and all(
            v == 0.5 for v in tshare.values()), (r, tshare)


def test_transformer_pp_matches_the_jax_serial_run(worlds):
    world, res, _, ref = worlds(4)
    want = ref["serial"]["tfm"]
    for r in range(world):
        got = res[r]["dsl"]["tfm"]
        assert all(abs(a - b) < 2e-3 for a, b in zip(got, want)), (
            r, got, want)


def test_three_axes_compose(worlds):
    world, res, _, ref = worlds(8)
    want = ref["serial"]["three"]
    for r in range(world):
        got = res[r]["dsl"]["three"]
        assert np.isfinite(got).all() and got[-1] < got[0], got
        assert all(abs(a - b) < 1e-4 for a, b in zip(got, want)), (
            r, got, want)
        share = res[r]["share"]["three"]
        assert share == {"fc_0.w_0": 0.5, "fc_0.b_0": 0.5}, share


# ---- no spawn: the programs and the refusals ----

@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_dsl_programs_build_byte_identical(schedule):
    import paddle_tpu as jfl
    import paddle_tpu_torch as tfl

    for i in range(2):
        a = build_dsl(jfl, schedule, 4, 8)[i].to_dict()
        b = build_dsl(tfl, schedule, 4, 8)[i].to_dict()
        assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def test_pipeline_refusals_match():
    import paddle_tpu as jfl
    import paddle_tpu_torch as tfl

    for fl in (jfl, tfl):
        with pytest.raises(ValueError, match="'gpipe' or '1f1b'"):
            fl.layers.Pipeline(num_stages=2, schedule="zb")
        with pytest.raises(AssertionError):
            fl.layers.Pipeline(num_stages=4, num_micro=6)
    with pytest.raises(ValueError, match="ring attention"):
        build_tfm(tfl, seq_axis="sp")


def test_the_transformer_refuses_mp_inside_a_stage():
    """A stage runs with no 'mp' collectives: the port refuses a
    tensor-parallel block inside a pipeline stage."""
    import paddle_tpu_torch as tfl

    with pytest.raises(ValueError, match="pp_stages=2, mp=True"):
        build_tfm(tfl, mp=True)


def test_a_stage_refuses_an_mp_parameter():
    """An 'mp'-sharded parameter declared inside a stage raises at its
    declaration, and the stage rolls back."""
    import paddle_tpu_torch as tfl

    layers = tfl.layers
    prog, startup = tfl.Program(), tfl.Program()
    with tfl.unique_name.guard(), tfl.program_guard(prog, startup):
        x = layers.data("x", [8])
        pipe = layers.Pipeline(num_stages=2)
        with pytest.raises(ValueError, match="inside a Pipeline stage"):
            with pipe.stage():
                h = pipe.input(x)
                pipe.output(layers.fc(h, 8, param_attr=tfl.ParamAttr(
                    sharding=(None, "mp"))))
        assert not [op for op in prog.global_block().ops
                    if op.type == "pipeline"]


def test_the_global_view_refuses_an_mp_value_read_in_a_stage():
    """An 'mp'-sharded value a stage reads from outside (a Const) passes
    the build and is refused by the (dp, mp, pp) global view's plan."""
    import paddle_tpu_torch as tfl
    from paddle_tpu_torch.parallel import collectives
    from paddle_tpu_torch.parallel.mesh import Mesh

    layers = tfl.layers
    prog, startup = tfl.Program(), tfl.Program()
    with tfl.unique_name.guard(), tfl.program_guard(prog, startup):
        x = layers.data("x", [8])
        w = layers.create_parameter([8, 8], "float32", attr=tfl.ParamAttr(
            name="outer_w", sharding=(None, "mp")))
        pipe = layers.Pipeline(num_stages=2)
        with pipe.stage():
            h = pipe.input(x)
            pipe.output(layers.matmul(h, w))
        loss = layers.mean(pipe())
        tfl.optimizer.SGD(0.1).minimize(loss)
    op = next(o for o in prog.global_block().ops if o.type == "pipeline")
    assert op.inputs["Consts"] == ["outer_w"]
    mesh = Mesh(("dp", "mp", "pp"), (1, 2, 2), range(4))
    with pytest.raises(ValueError, match="'outer_w', sharded"):
        collectives.CommPlan(collectives.CommConfig(bucket_mb=0.0,
                                                    zero_stage=0),
                             prog, tfl.Scope(), mesh, "dp",
                             require_grads=False)


def test_a_failed_stage_body_rolls_back():
    """An error inside the stage body surfaces as itself and leaves no
    pipeline op behind (the JAX package's rollback)."""
    import paddle_tpu_torch as tfl

    layers = tfl.layers
    prog, startup = tfl.Program(), tfl.Program()
    with tfl.unique_name.guard(), tfl.program_guard(prog, startup):
        x = layers.data("x", [8])
        pipe = layers.Pipeline(num_stages=2)
        with pytest.raises(RuntimeError, match="boom"):
            with pipe.stage():
                pipe.input(x)
                raise RuntimeError("boom")
        assert prog.current_block().idx == 0
        assert not [op for op in prog.global_block().ops
                    if op.type == "pipeline"]


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
