"""Expert parallelism ('ep', ``parallel.expert_parallel`` and the ``moe``
op) of the port against the JAX package's, on the CPU.

* **the functions** (no spawn): ``switch_moe`` and ``topk_moe`` on the
  JAX package's parameters (``init_moe_params``) and tokens: outputs,
  aux losses and the gradients of ``mean((y - t)**2) + 0.01 aux``
  against the JAX functions' at tests/test_expert_parallel.py's bounds
  (outputs rtol 1e-4, atol 1e-5; aux rtol 1e-5; gradients rtol 1e-4,
  atol 1e-6); its capacity case (every token forced to expert 0 keeps
  exactly the first 4) and its GShard priority case (first choices claim
  slots before any second choice) token for token.
* **layers.moe** in a gloo world of 4 (tests/torch_gloo_harness.py):
  tests/test_expert_parallel.py's ``TestMoEDSL`` program (x [4, 16, 8],
  E 4, d_ff 16, the mean square plus 0.01 aux, SGD 0.1) for 3 steps on an
  ('ep',) mesh of 4 and on a (dp 2, ep 2) mesh, top-1 and top-2, at the
  JAX test's capacity factor 8 (no drops) and at 1.0 and 0.5 (drops:
  the global capacity and slot order of the JAX package's global view),
  against the JAX package's serial run (losses within 2e-4, its bound;
  every parameter at rtol 2e-4, atol 2e-5) and, on the ('ep',) mesh,
  against the JAX package's own ep run; the port's serial ``Executor``
  too. Each rank holds E/ep experts of WIn and WOut.
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
WORLD = 4
STEPS = 3
#: (tag, top_k, capacity factor, axes, mesh shape)
RUNS = [("ep4-top1", 1, 8.0, ("ep",), (4,)),
        ("ep4-top2", 2, 8.0, ("ep",), (4,)),
        ("dp2ep2-top1", 1, 8.0, ("dp", "ep"), (2, 2)),
        ("dp2ep2-top2", 2, 8.0, ("dp", "ep"), (2, 2)),
        ("dp2ep2-top2-cf1", 2, 1.0, ("dp", "ep"), (2, 2)),
        ("dp2ep2-top1-cf05", 1, 0.5, ("dp", "ep"), (2, 2))]


def build(fl, top_k, cf):
    layers = fl.layers
    with fl.unique_name.guard():
        prog, startup = fl.Program(), fl.Program()
        with fl.program_guard(prog, startup):
            x = layers.data("x", [16, 8])
            out, aux = layers.moe(x, num_experts=4, d_ff=16, top_k=top_k,
                                  capacity_factor=cf)
            loss = layers.elementwise_add(
                layers.mean(layers.square(out)),
                layers.scale(aux, scale=0.01))
            fl.optimizer.SGD(0.1).minimize(loss)
    return prog, startup, loss


def feed():
    return {"x": np.random.RandomState(0).rand(4, 16, 8).astype(np.float32)
            - 0.5}


# ---- the port's side: one process a rank ----

def _worker(rank, world, d):
    gh.join(rank, world, d, TIMEOUT)
    import paddle_tpu_torch as fl
    from paddle_tpu_torch import interop
    from paddle_tpu_torch.parallel import ParallelExecutor, make_mesh
    from paddle_tpu_torch.parallel.collectives import ShardedState

    with np.load(os.path.join(d, "init.npz")) as z:
        init = {n: z[n] for n in z.files}
    res, arrays = {}, {}
    for tag, k, cf, axes, shape in RUNS:
        prog, startup, loss = build(fl, k, cf)
        scope = fl.Scope()
        interop.load_reference_state(init, scope, fl.CPUPlace(),
                                     [prog, startup])
        pe = ParallelExecutor(use_cuda=False, loss_name=loss.name,
                              main_program=prog,
                              mesh=make_mesh(shape, axes), zero_stage=0)
        losses = [float(pe.run(feed=feed(), fetch_list=[loss.name],
                               scope=scope)[0]) for _ in range(STEPS)]
        share = {n: scope.find_var(n).numel()
                 / float(np.prod(scope.find_var(n).full_shape))
                 for n in sorted(scope.local_var_names())
                 if isinstance(scope.find_var(n), ShardedState)}
        res[tag] = {"losses": losses, "share": share,
                    "census": [r["tag"] for r in pe.last_census.records]}
        arrays.update({tag + ":" + n: v
                       for n, v in gh.snapshot(scope).items()})
    with open(os.path.join(d, "res%d.json" % rank), "w") as f:
        json.dump(res, f)
    if rank == 0:
        np.savez(os.path.join(d, "arr.npz"), **arrays)
    gh.leave()


# ---- the JAX side, in the test process ----

def _jax_run(top_k, cf, init, mesh_spec=None):
    import paddle_tpu as jfl
    from paddle_tpu.parallel import make_mesh
    from paddle_tpu.parallel.parallel_executor import ParallelExecutor

    prog, startup, loss = build(jfl, top_k, cf)
    scope = jfl.Scope()
    with jfl.scope_guard(scope):
        exe = jfl.Executor()
        exe.run(startup)
        for n, v in init.items():
            scope.set_var(n, v)
        if mesh_spec is None:
            losses = [float(np.asarray(exe.run(
                prog, feed=feed(), fetch_list=[loss.name])[0]))
                for _ in range(STEPS)]
        else:
            pe = ParallelExecutor(loss_name=loss.name, main_program=prog,
                                  mesh=make_mesh(*mesh_spec))
            losses = [float(np.asarray(pe.run(
                fetch_list=[loss.name], feed=feed())[0]))
                for _ in range(STEPS)]
        state = {n: np.asarray(scope.find_var(n)) for n in init}
    return losses, state


def _port_serial(top_k, cf, init):
    import paddle_tpu_torch as tfl
    from paddle_tpu_torch import interop

    prog, startup, loss = build(tfl, top_k, cf)
    scope = tfl.Scope()
    interop.load_reference_state(init, scope, tfl.CPUPlace(),
                                 [prog, startup])
    exe = tfl.Executor(tfl.CPUPlace())
    return [float(exe.run(prog, feed=feed(), fetch_list=[loss],
                          scope=scope)[0]) for _ in range(STEPS)]


@pytest.fixture(scope="module")
def world_run():
    import paddle_tpu as jfl

    d = tempfile.mkdtemp(prefix="ptp_moe_")
    try:
        prog, startup, _ = build(jfl, 1, 8.0)
        scope = jfl.Scope()
        with jfl.scope_guard(scope):
            jfl.Executor().run(startup)
            init = {n: np.asarray(scope.find_var(n))
                    for n in scope.local_var_names()
                    if hasattr(scope.find_var(n), "shape")}
        np.savez(os.path.join(d, "init.npz"), **init)
        started = gh.start(__file__, WORLD, d, TIMEOUT)
        ref = {"serial": {}, "ep": {}, "port_serial": {}}
        try:
            for tag, k, cf, axes, shape in RUNS:
                key = (k, cf)
                if key not in ref["serial"]:
                    ref["serial"][key] = _jax_run(k, cf, init)
                    ref["port_serial"][key] = _port_serial(k, cf, init)
                if axes == ("ep",):
                    ref["ep"][tag] = _jax_run(k, cf, init, (shape, axes))
        finally:
            gh.finish(started, d)
        res = []
        for r in range(WORLD):
            with open(os.path.join(d, "res%d.json" % r)) as f:
                res.append(json.load(f))
        with np.load(os.path.join(d, "arr.npz")) as z:
            arrs = {k: z[k] for k in z.files}
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return res, arrs, ref


@pytest.mark.parametrize("run", RUNS, ids=[r[0] for r in RUNS])
def test_moe_matches_the_jax_serial_run(world_run, run):
    res, arrs, ref = world_run
    tag, k, cf = run[:3]
    jl, js = ref["serial"][(k, cf)]
    assert all(abs(a - b) < 2e-4 for a, b in zip(
        ref["port_serial"][(k, cf)], jl)), (ref["port_serial"], jl)
    for r in range(WORLD):
        got = res[r][tag]["losses"]
        assert all(abs(a - b) < 2e-4 for a, b in zip(got, jl)), (
            r, got, jl)
        assert got == res[0][tag]["losses"]
    for n, v in js.items():
        np.testing.assert_allclose(arrs[tag + ":" + n], v, rtol=2e-4,
                                   atol=2e-5, err_msg=n)
    if tag in ref["ep"]:
        el, es = ref["ep"][tag]
        assert all(abs(a - b) < 2e-4 for a, b in zip(res[0][tag]["losses"],
                                                    el)), (el, jl)


@pytest.mark.parametrize("run", RUNS, ids=[r[0] for r in RUNS])
def test_each_rank_holds_its_experts(world_run, run):
    res, _, _ = world_run
    tag, axes, shape = run[0], run[3], run[4]
    ep = shape[axes.index("ep")]
    for r in range(WORLD):
        share = res[r][tag]["share"]
        # WIn and WOut (SGD keeps no accumulators)
        assert sorted(share) == ["moe_0.w_1", "moe_0.w_2"], share
        assert all(v == 1.0 / ep for v in share.values()), share
        census = res[r][tag]["census"]
        # the experts' entry and exit sums over the ep line, each in
        # the forward op and in the grad op's recompute; over dp the
        # routing counts and the aux loss's probabilities too
        assert census.count("moe.combine") == 2, census
        if "dp" in axes:
            assert census.count("moe.aux") == 2, census
            assert census.count("moe.counts") == 2 * run[1], census


# ---- no spawn: the functions ----

def _params(key, d, f, e):
    import jax

    from paddle_tpu.parallel.expert_parallel import init_moe_params

    return {k: np.asarray(v) for k, v in init_moe_params(
        jax.random.PRNGKey(key), d, f, num_experts=e).items()}


def _both(fn_name, params, x, tgt, **kw):
    """(port, JAX): (y, aux, {name: grad}) of one function."""
    import jax
    import jax.numpy as jnp
    import torch

    from paddle_tpu.parallel import expert_parallel as jep
    from paddle_tpu_torch.parallel import expert_parallel as tep

    def jloss(p):
        y, aux = getattr(jep, fn_name)(p, jnp.asarray(x), **kw)
        return jnp.mean((y - tgt) ** 2) + 0.01 * aux, (y, aux)

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    (_, (jy, jaux)), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    tp = {k: torch.tensor(v).requires_grad_() for k, v in
          params.items()}
    ty, taux = getattr(tep, fn_name)(tp, torch.from_numpy(x), **kw)
    (torch.mean((ty - torch.from_numpy(tgt)) ** 2) + 0.01 * taux).backward()
    return ((ty.detach().numpy(), float(taux.detach()),
             {k: v.grad.numpy() for k, v in tp.items()}),
            (np.asarray(jy), float(jaux),
             {k: np.asarray(v) for k, v in jg.items()}))


@pytest.mark.parametrize("fn_name,kw", [
    ("switch_moe", dict(capacity_factor=4.0)),
    ("switch_moe", dict(capacity_factor=1.0)),
    ("topk_moe", dict(k=2, capacity_factor=4.0)),
    ("topk_moe", dict(k=2, capacity_factor=1.0))],
    ids=["top1", "top1-drops", "top2", "top2-drops"])
def test_functions_match_the_jax_functions(fn_name, kw):
    rng = np.random.RandomState(4)
    params = _params(3, 8, 16, 4)
    x = rng.randn(64, 8).astype(np.float32)
    tgt = rng.randn(64, 8).astype(np.float32)
    (ty, taux, tg), (jy, jaux, jg) = _both(fn_name, params, x, tgt, **kw)
    np.testing.assert_allclose(ty, jy, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(taux, jaux, rtol=1e-5)
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_capacity_drops_the_overflow_tokens():
    """tests/test_expert_parallel.py's case: zero gates tie, every token
    goes to expert 0, capacity 4 keeps exactly tokens 0-3."""
    import torch

    from paddle_tpu_torch.parallel.expert_parallel import switch_moe

    params = {k: torch.from_numpy(v)
              for k, v in _params(0, 8, 16, 2).items()}
    params["gate"] = torch.zeros_like(params["gate"])
    x = torch.from_numpy(np.random.RandomState(2).randn(16, 8)
                         .astype(np.float32))
    y, _ = switch_moe(params, x, capacity_factor=0.5)
    rows = torch.any(torch.abs(y) > 1e-12, dim=1).numpy()
    assert rows.tolist() == [True] * 4 + [False] * 12


def test_first_choices_have_priority_at_capacity():
    """tests/test_expert_parallel.py's GShard case, against the JAX
    function token for token."""
    import jax.numpy as jnp
    import torch

    from paddle_tpu.parallel.expert_parallel import topk_moe as jtopk
    from paddle_tpu_torch.parallel.expert_parallel import topk_moe

    params = _params(7, 4, 8, 2)
    gate_m = np.zeros((4, 2), np.float32)
    gate_m[0, 0] = 1.0
    gate_m[1, 1] = 1.0
    params["gate"] = gate_m
    x = np.random.RandomState(3).rand(8, 4).astype(np.float32) * 0.01
    x[:2, 0] += 3.0
    x[2:, 1] += 3.0
    y, _ = topk_moe({k: torch.from_numpy(v) for k, v in params.items()},
                    torch.from_numpy(x), k=2, capacity_factor=1.0)
    jy, _ = jtopk({k: jnp.asarray(v) for k, v in params.items()},
                  jnp.asarray(x), k=2, capacity_factor=1.0)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=2e-4,
                               atol=1e-5)
    # token 7 overflowed both experts: fully dropped
    assert float(torch.abs(y[7]).max()) == 0.0


def test_init_and_shardings():
    import torch

    from paddle_tpu_torch.parallel.expert_parallel import (
        init_moe_params, moe_param_shardings)
    from paddle_tpu_torch.parallel.mesh import Mesh

    from paddle_tpu_torch import CPUPlace

    p = init_moe_params(torch.Generator().manual_seed(0), 8, 16, 4,
                        place=CPUPlace())
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "gate": (8, 4), "w_in": (4, 8, 16), "w_out": (4, 16, 8)}
    # the same draws from a CPU generator, whatever the place
    q = init_moe_params(torch.Generator().manual_seed(0), 8, 16, 4,
                        place=CPUPlace())
    assert all(torch.equal(p[k], q[k]) for k in p)
    # an entry point: on the card unless the caller asks for the CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CPUPlace"):
            init_moe_params(torch.Generator().manual_seed(0), 8, 16, 4)
    sh = moe_param_shardings(Mesh(("ep",), (4,), range(4)))
    assert {k: v.spec for k, v in sh.items()} == {
        "gate": (), "w_in": ("ep", None, None), "w_out": ("ep", None, None)}


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_programs_build_byte_identical(top_k):
    import paddle_tpu as jfl
    import paddle_tpu_torch as tfl

    for i in range(2):
        a = build(jfl, top_k, 8.0)[i].to_dict()
        b = build(tfl, top_k, 8.0)[i].to_dict()
        assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def test_moe_refusals_match():
    import paddle_tpu as jfl
    import paddle_tpu_torch as tfl

    for fl in (jfl, tfl):
        with fl.unique_name.guard(), fl.program_guard(fl.Program(),
                                                      fl.Program()):
            x = fl.layers.data("x", [16, 8])
            with pytest.raises(ValueError, match="top_k=5"):
                fl.layers.moe(x, num_experts=4, d_ff=16, top_k=5)
            with pytest.raises(ValueError, match="capacity_factor"):
                fl.layers.moe(x, num_experts=4, d_ff=16, capacity_factor=0)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
