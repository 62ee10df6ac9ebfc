"""Fluid control flow under CUDA graph capture on the card
(``ops/control_flow_ops.py``): a ``while`` with ``max_iters`` captures as
its masked form and replays to the eager loop's bits, a ``while``
without a bound and a ``print`` refuse the capture, and a
``conditional_block`` captures as a device select whose gradient keeps
the branch not taken (NaN inside it included) out, in both branches,
at the top level and inside a While.

Marked ``cuda``: each test skips inside itself where torch finds no
card. This file imports torch and the port only (the machine with the
card has no jax), so run it there without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_control_flow_cuda.py
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers, unique_name
from paddle_tpu_torch.data_feeder import stack_feeds

H = 4
T = 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _while_program(max_iters, train):
    """h <- tanh(fc(h)) T times in a While (tests/test_control_flow.py),
    then a softmax classifier; with ``train`` SGD (the while is stamped
    differentiable), else inference (the eager loop reads its predicate
    on the host)."""
    prog, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(prog, startup):
        x = layers.data("x", [H])
        label = layers.data("label", [1], dtype="int64")
        i = layers.fill_constant([1], "int32", 0)
        n = layers.fill_constant([1], "int32", T)
        h = layers.fc(x, H, act="tanh", bias_attr=False)
        cond = layers.less_than(i, n)
        w = layers.While(cond, max_iters=max_iters)
        with w.block():
            h2 = layers.fc(h, H, act="tanh", bias_attr=False)
            layers.assign(h2, output=h)
            layers.increment(i, value=1.0, in_place=True)
            layers.less_than(i, n, cond=cond)
        pred = layers.fc(h, 3, act="softmax")
        loss = layers.mean(layers.cross_entropy(pred, label))
        if train:
            fluid.optimizer.SGD(0.5).minimize(loss)
    return prog, startup, [loss, h, i]


def _feeds(k, seed=0):
    rng = np.random.RandomState(seed)
    return [{"x": rng.rand(8, H).astype(np.float32),
             "label": rng.randint(0, 3, (8, 1)).astype(np.int64)}
            for _ in range(k)]


def _fresh(startup, seed=0):
    startup.random_seed = seed
    scope = fluid.Scope()
    fluid.Executor().run(startup, scope=scope)
    return scope


def _copy(scope):
    s = fluid.Scope()
    for n, v in scope.vars.items():
        s.set_var(n, fluid.TensorArray(v.data.clone(), v.size.clone())
                  if isinstance(v, fluid.TensorArray) else v.clone())
    return s


@pytest.mark.cuda
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("max_iters", [T, 8])
def test_bounded_while_replays_bitwise_equal_to_eager_steps(cuda, train,
                                                            max_iters):
    """run_chunk captures the plan's step with the while in its masked
    form; every replay equals the eager run() step bit for bit (the
    loop's outputs, the loss and, when training, every parameter)."""
    prog, startup, fetch = _while_program(max_iters, train)
    s0 = _fresh(startup)
    feeds = _feeds(4)
    a, b = _copy(s0), _copy(s0)
    exe = fluid.Executor()
    eager = [exe.run(prog, feed=f, fetch_list=fetch, scope=a,
                     return_numpy=False) for f in feeds]
    exe2 = fluid.Executor()
    chunk = exe2.run_chunk(prog, feed_chunk=stack_feeds(feeds),
                           fetch_list=fetch, scope=b, return_numpy=False)
    assert exe2._plans and any(p.graphs for p in exe2._plans.values())
    for j, f in enumerate(fetch):
        got = chunk[j]
        want = torch.stack([e[j] for e in eager])
        assert torch.equal(got, want), f.name
    assert (chunk[2].reshape(-1) == T).all()
    for n in a.vars:
        assert torch.equal(a.find_var(n), b.find_var(n)), n


@pytest.mark.cuda
def test_unbounded_while_refuses_the_capture(cuda):
    """An inference while without max_iters runs eagerly (its predicate
    read on the host each iteration) and refuses a CUDA graph with a
    clear error; it never runs eagerly in its place."""
    prog, startup, fetch = _while_program(0, False)
    scope = _fresh(startup)
    feeds = _feeds(2)
    exe = fluid.Executor()
    out = exe.run(prog, feed=feeds[0], fetch_list=fetch, scope=scope)
    assert int(out[2][0]) == T
    with pytest.raises(RuntimeError, match="max_iters=N"):
        exe.run_chunk(prog, feed_chunk=stack_feeds(feeds), fetch_list=fetch,
                      scope=scope)


@pytest.mark.cuda
def test_print_refuses_the_capture(cuda):
    prog, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(prog, startup):
        layers.data("x", [2])
        out = prog.global_block().create_var(name="printed",
                                             dtype="float32")
        prog.global_block().append_op("print", {"In": ["x"]},
                                      {"Out": ["printed"]}, {"message": ""})
    feed = {"x": np.ones((2, 1, 2), np.float32)}
    with pytest.raises(RuntimeError, match="print op cannot be captured"):
        fluid.Executor().run_chunk(prog, feed_chunk=feed, fetch_list=[out],
                                   scope=fluid.Scope())


def _switch_program(taken, nan):
    """tests/test_control_flow.py's conditional program; with ``nan``
    the branch also adds 0 * log(0 * y), -inf in its forward and 0 / 0
    in its gradient."""
    prog, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(prog, startup):
        x = layers.data("x", [H])
        a = layers.fill_constant([1], "int32", 0 if taken else 5)
        b = layers.fill_constant([1], "int32", 3)
        cond = layers.less_than(a, b)
        y = layers.fc(x, H, param_attr=fluid.ParamAttr(name="cb_w"),
                      bias_attr=False)
        sw = layers.Switch()
        with sw.case(cond):
            y2 = layers.scale(y, scale=3.0)
            if nan:
                bad = layers.log(layers.scale(y, scale=0.0))
                y2 = layers.elementwise_add(y2, layers.scale(bad, scale=0.0))
            layers.assign(y2, output=y)
        loss = layers.mean(y)
        fluid.append_backward(loss)
    return prog, startup, [loss, "cb_w@GRAD"]


@pytest.mark.cuda
@pytest.mark.parametrize("taken", [True, False])
@pytest.mark.parametrize("nan", [False, True])
def test_conditional_select_gradient_in_both_branches(cuda, taken, nan):
    """The captured conditional_block computes its branch and selects on
    the device. Each replay equals the eager step (which runs only the
    branch taken) bit for bit, NaN for NaN: with the NaN branch taken the
    loss and gradient are NaN in both; not taken, the gradient is the
    finite one of the identity branch, never 0 / 0 through the select."""
    prog, startup, fetch = _switch_program(taken, nan)
    scope = _fresh(startup)
    feeds = [{"x": np.random.RandomState(s).rand(2, H).astype(np.float32)}
             for s in range(3)]
    exe = fluid.Executor()
    eager = [exe.run(prog, feed=f, fetch_list=fetch, scope=scope,
                     return_numpy=False) for f in feeds]
    chunk = fluid.Executor().run_chunk(prog, feed_chunk=stack_feeds(feeds),
                                       fetch_list=fetch, scope=scope,
                                       return_numpy=False)
    for j in range(2):
        want = torch.stack([e[j] for e in eager])
        assert torch.equal(torch.nan_to_num(chunk[j], nan=7.0),
                           torch.nan_to_num(want, nan=7.0)), fetch[j]
        assert torch.isnan(chunk[j]).any() == (nan and taken)


def _switch_in_while_program(taken):
    """_switch_program's NaN branch as a Switch inside a bounded,
    differentiable While (loss = mean(h)): the loop's gradient is
    autograd through its masked steps, so the conditional's own backward
    must select its gradients."""
    prog, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(prog, startup):
        x = layers.data("x", [H])
        i = layers.fill_constant([1], "int32", 0)
        n = layers.fill_constant([1], "int32", T)
        a = layers.fill_constant([1], "int32", 0 if taken else 5)
        b = layers.fill_constant([1], "int32", 3)
        h = layers.fc(x, H, act="tanh", bias_attr=False)
        cond = layers.less_than(i, n)
        w = layers.While(cond, max_iters=T)
        with w.block():
            h2 = layers.fc(h, H, act="tanh",
                           param_attr=fluid.ParamAttr(name="loop_w"),
                           bias_attr=False)
            sw = layers.Switch()
            with sw.case(layers.less_than(a, b)):
                bad = layers.log(layers.scale(h2, scale=0.0))
                layers.assign(layers.elementwise_add(
                    layers.scale(h2, scale=3.0), layers.scale(bad, scale=0.0)),
                    output=h2)
            layers.assign(h2, output=h)
            layers.increment(i, value=1.0, in_place=True)
            layers.less_than(i, n, cond=cond)
        loss = layers.mean(h)
        fluid.append_backward(loss)
    return prog, startup, [loss, "loop_w@GRAD"]


@pytest.mark.cuda
@pytest.mark.parametrize("taken", [True, False])
def test_conditional_nested_in_a_while_replays_with_the_branch_not_taken_out(
        cuda, taken):
    """The NaN branch as a Switch inside a bounded While: each replay
    equals the eager step bit for bit, NaN for NaN; not taken, the loop's
    gradient stays finite through the captured select."""
    prog, startup, fetch = _switch_in_while_program(taken)
    scope = _fresh(startup)
    feeds = [{"x": np.random.RandomState(s).rand(2, H).astype(np.float32)}
             for s in range(3)]
    exe = fluid.Executor()
    eager = [exe.run(prog, feed=f, fetch_list=fetch, scope=scope,
                     return_numpy=False) for f in feeds]
    chunk = fluid.Executor().run_chunk(prog, feed_chunk=stack_feeds(feeds),
                                       fetch_list=fetch, scope=scope,
                                       return_numpy=False)
    for j in range(2):
        want = torch.stack([e[j] for e in eager])
        assert torch.equal(torch.nan_to_num(chunk[j], nan=7.0),
                           torch.nan_to_num(want, nan=7.0)), fetch[j]
        assert bool(torch.isnan(chunk[j]).any()) == taken


@pytest.mark.cuda
def test_tensor_array_state_replays_in_place(cuda):
    """A persistable TensorArray in the scope, written every step at the
    step's counter: the graph keeps its two tensors as state and updates
    them in place; every replay equals the eager run() step bit for
    bit, the array and its size included."""
    prog, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(prog, startup):
        x = layers.data("x", [H])
        label = layers.data("label", [1], dtype="int64")
        pred = layers.fc(x, 3, act="softmax")
        loss = layers.mean(layers.cross_entropy(pred, label))
        hist = prog.global_block().create_var(
            name="hist", dtype="float32", type="tensor_array",
            persistable=True)
        step = layers.create_global_var([1], 0.0, "int64",
                                        persistable=True)
        layers.array_write(layers.reshape(loss, [1]), step, array=hist)
        layers.increment(step, in_place=True)
        fluid.optimizer.SGD(0.1).minimize(loss)
    s0 = _fresh(startup)
    s0.set_var("hist", fluid.TensorArray(
        torch.zeros(8, 1, device=cuda),
        torch.zeros((), dtype=torch.int32, device=cuda)))
    feeds = _feeds(4)
    a, b = _copy(s0), _copy(s0)
    exe = fluid.Executor()
    eager = [exe.run(prog, feed=f, fetch_list=[loss], scope=a,
                     return_numpy=False)[0] for f in feeds]
    chunk = fluid.Executor().run_chunk(prog, feed_chunk=stack_feeds(feeds),
                                       fetch_list=[loss], scope=b,
                                       return_numpy=False)[0]
    assert torch.equal(chunk, torch.stack(eager))
    ha, hb = a.find_var("hist"), b.find_var("hist")
    assert torch.equal(ha.data, hb.data) and int(hb.size) == 4
    assert torch.equal(hb.data[:4, 0], torch.stack(eager).reshape(-1))
