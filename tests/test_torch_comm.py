"""The port's data-parallel pieces that need no second process, against
the JAX package's:

* the ``CommPlan`` of tests/test_comm.py's MLP, the resnet_cifar net
  and a stacked LSTM, at worlds 2, 3 and 8 under four configs: buckets,
  their gradients, sizes, padding, ZeRO rows and state, ``describe()``
  and ``wire_bytes`` equal the JAX plan's;
* ``fold_ef_state`` and ``fold_zero_state`` equal the JAX functions;
* every rejection the plan raises has the JAX package's wording;
* the ``DistributeTranspiler``'s trainer and pserver programs are
  byte-identical JSON, and a pserver program applies the update numbers
  of tests/test_distributed.py:219,265;
* the ParallelDo book MLP (``get_places``, ``pd.do()``,
  ``read_input``/``write_output``) builds the JAX package's program and
  trains to its losses;
* in a gloo world of ONE process (this one): the executor's
  rejections, the census of a step's collectives, ``set_mesh`` and the
  audit stand-ins.
"""

import os
import shutil
import tempfile
import warnings

import numpy as np
import pytest

import paddle_tpu as jfl
import paddle_tpu_torch as tfl
from paddle_tpu.parallel import collectives as jcol
from paddle_tpu.parallel import make_mesh as jmesh
from paddle_tpu_torch import interop
from paddle_tpu_torch.parallel import collectives as tcol
from paddle_tpu_torch.parallel.mesh import Mesh

import test_torch_parallel as tp

CPU = tfl.CPUPlace()


def _pair(kind):
    """(JAX program, JAX scope, port program, port scope) of a builder
    from tests/test_torch_parallel.py, the port's weights the JAX
    startup's."""
    jprog, jstart, _ = tp.build(jfl, kind)
    jscope = jfl.Scope()
    with jfl.scope_guard(jscope):
        jfl.Executor().run(jstart)
    arrays = {n: np.asarray(jscope.find_var(n))
              for n in jscope.local_var_names()}
    tprog, tstart, _ = tp.build(tfl, kind)
    tscope = tfl.Scope()
    interop.load_reference_state(arrays, tscope, CPU, [tprog, tstart])
    return jprog, jscope, tprog, tscope


CONFIGS = {
    "fp32": dict(bucket_mb=0.05),
    "int8": dict(bucket_mb=4.0, quantize="int8"),
    "fp8_z1": dict(bucket_mb=0.05, quantize="fp8", zero_stage=1),
    "z1": dict(bucket_mb=0.05, zero_stage=1),
}


@pytest.fixture(scope="module")
def pairs():
    return {k: _pair(k) for k in ("mlp", "resnet", "lstm")}


@pytest.mark.parametrize("world", [2, 3, 8])
@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("kind", ["mlp", "resnet", "lstm"])
def test_comm_plan_equals_the_jax_plan(pairs, kind, config, world):
    jprog, jscope, tprog, tscope = pairs[kind]
    jp = jcol.plan_for(jcol.CommConfig(**CONFIGS[config]), jprog, jscope,
                       jmesh((world,), ("dp",)))
    tplan = tcol.plan_for(tcol.CommConfig(**CONFIGS[config]), tprog,
                          tscope, Mesh(("dp",), (world,), range(world)))
    assert tplan.describe() == jp.describe()
    assert tplan.wire_bytes() == jp.wire_bytes()
    assert tplan.pre_quant_bytes == jp.pre_quant_bytes
    assert tplan.state_names == jp.state_names
    assert tplan.key == jp.key
    for a, b in zip(tplan.buckets, jp.buckets):
        assert (a.grads, a.sizes, a.nelem, a.padded, a.close_uid, a.rows,
                a.shard_len, a.dtype) == (b.grads, b.sizes, b.nelem,
                                          b.padded, b.close_uid, b.rows,
                                          b.shard_len, b.dtype)
    assert tplan.zero_state == jp.zero_state
    assert tplan.zero_state_bytes == jp.zero_state_bytes
    assert sorted(tplan.zero_updates) == sorted(jp.zero_updates)
    for uid, zu in tplan.zero_updates.items():
        ju = jp.zero_updates[uid]
        assert (zu.param, zu.grad, zu.bucket, zu.off, zu.rows, zu.nelem,
                zu.shard_ins, zu.shard_outs, zu.gather_outs) == (
            ju.param, ju.grad, ju.bucket, ju.off, ju.rows, ju.nelem,
            ju.shard_ins, ju.shard_outs, ju.gather_outs)


@pytest.mark.parametrize("phase", ["p1", "p2"])
def test_fold_ef_state_equals_jax(phase):
    rng = np.random.RandomState(0)
    nelem = 37
    old = rng.rand(4, 40).astype(np.float32) if phase == "p1" \
        else rng.rand(40).astype(np.float32)
    new = (3, 39) if phase == "p1" else (39,)
    got = tcol.fold_ef_state(old, phase, nelem, new)
    want = jcol.fold_ef_state(old, phase, nelem, new)
    assert got.tobytes() == np.asarray(want).tobytes()


@pytest.mark.parametrize("old_shape", [(4, 10), (37,), (3, 13)])
def test_fold_zero_state_equals_jax(old_shape):
    rng = np.random.RandomState(1)
    old = rng.rand(*old_shape).astype(np.float32)
    got = tcol.fold_zero_state(old, 37, (3, 13))
    want = jcol.fold_zero_state(old, 37, (3, 13))
    assert got.tobytes() == np.asarray(want).tobytes()


def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("kw", [dict(quantize="int4"),
                                dict(zero_stage=2)])
def test_comm_config_rejections_read_as_jax(kw):
    assert _message(lambda: tcol.CommConfig(**kw)) == \
        _message(lambda: jcol.CommConfig(**kw))


def _clip_or_lamb(fl, what):
    prog, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(prog, startup):
        x = fl.layers.data("x", [8])
        loss = fl.layers.mean(fl.layers.fc(x, 4))
        if what == "clip":
            fl.clip.set_gradient_clip(fl.clip.GradientClipByValue(1.0))
            try:
                fl.optimizer.SGD(0.1).minimize(loss)
            finally:
                fl.clip.set_gradient_clip(None)
        elif what == "lamb":
            fl.optimizer.Lamb(0.1).minimize(loss)
    return prog, startup


@pytest.mark.parametrize("what", ["clip", "lamb", "no_minimize", "sp"])
def test_plan_rejections_read_as_jax(what):
    def jax_side():
        prog, startup = _clip_or_lamb(jfl, what)
        scope = jfl.Scope()
        with jfl.scope_guard(scope):
            jfl.Executor().run(startup)
        mesh = jmesh((4, 2), ("dp", "sp")) if what == "sp" \
            else jmesh((2,), ("dp",))
        jcol.plan_for(jcol.CommConfig(zero_stage=1), prog, scope, mesh)

    def port_side():
        prog, startup = _clip_or_lamb(tfl, what)
        scope = tfl.Scope()
        tfl.Executor(CPU).run(startup, scope=scope)
        mesh = Mesh(("dp", "sp"), (4, 2), range(8)) if what == "sp" \
            else Mesh(("dp",), (2,), range(2))
        tcol.plan_for(tcol.CommConfig(zero_stage=1), prog, scope, mesh)

    assert _message(port_side) == _message(jax_side)


# ---- the distribute transpiler ----

def _pserver_prog(fl, scheduled):
    prog, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(prog, startup):
        x = fl.layers.data("x", [4])
        if scheduled:
            loss = fl.layers.mean(fl.layers.fc(x, 3, bias_attr=False))
            lr = fl.layers.exponential_decay(learning_rate=0.5,
                                             decay_steps=1, decay_rate=0.5,
                                             staircase=True)
        else:
            loss = fl.layers.mean(fl.layers.fc(x, 3, bias_attr=True))
            lr = 0.5
        fl.optimizer.SGD(learning_rate=lr).minimize(loss)
    return prog, startup


@pytest.mark.parametrize("scheduled", [False, True],
                         ids=["plain", "lr_scheduler"])
def test_transpiler_programs_are_the_jax_packages(scheduled):
    from paddle_tpu.parallel.distribute import DistributeTranspiler as JT
    from paddle_tpu_torch.parallel.distribute import \
        DistributeTranspiler as TT

    eps = "127.0.0.1:6174" if scheduled else \
        "127.0.0.1:6174,127.0.0.1:6175"
    jprog, _ = _pserver_prog(jfl, scheduled)
    tprog, tstart = _pserver_prog(tfl, scheduled)
    jt, tt = JT(), TT()
    jt.transpile(trainer_id=0, program=jprog, pservers=eps, trainers=2)
    tt.transpile(trainer_id=0, program=tprog, pservers=eps, trainers=2)
    assert tt.param_shards == jt.param_shards
    assert tt.state_shard_of == jt.state_shard_of
    assert tt.get_trainer_program().to_json() == \
        jt.get_trainer_program().to_json()
    for ep in eps.split(","):
        a, b = tt.get_pserver_program(ep), jt.get_pserver_program(ep)
        assert a.to_json() == b.to_json()
        assert a.pserver_meta == b.pserver_meta

    # the update numbers: w' = w - 0.5 g (the decayed lr at step 0 is
    # 0.5 too)
    p0 = tt.get_pserver_program(eps.split(",")[0])
    owned = p0.pserver_meta["params"]
    scope = tfl.Scope()
    exe = tfl.Executor(CPU)
    exe.run(tstart, scope=scope)
    feed = {}
    for i, n in enumerate(owned):
        w = np.asarray(scope.find_var(n))
        feed[n + "@GRAD"] = np.full_like(w, 0.1 if i == 0 else 0.0)
    w0 = np.asarray(scope.find_var(owned[0])).copy()
    exe.run(p0, feed=feed, fetch_list=[], scope=scope)
    np.testing.assert_allclose(np.asarray(scope.find_var(owned[0])),
                               w0 - 0.5 * 0.1, rtol=1e-5, atol=1e-6)


# ---- ParallelDo ----

def _book_mlp(fl):
    prog, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(prog, startup):
        img = fl.layers.data("img", [784])
        label = fl.layers.data("label", [1], dtype="int64")
        places = fl.layers.get_places()
        pd = fl.layers.ParallelDo(places)
        with pd.do():
            img_ = pd.read_input(img)
            label_ = pd.read_input(label)
            hidden = fl.layers.fc(img_, 200, act="tanh")
            pred = fl.layers.fc(hidden, 10, act="softmax")
            loss = fl.layers.cross_entropy(pred, label_)
            pd.write_output(fl.layers.mean(loss))
        avg = fl.layers.mean(pd())
        fl.optimizer.Adam(1e-3).minimize(avg)
    return prog, startup, avg


def test_parallel_do_book_mlp_is_the_jax_program():
    jprog, jstart, jloss = _book_mlp(jfl)
    tprog, tstart, tloss = _book_mlp(tfl)
    assert tprog.to_json() == jprog.to_json()
    assert tstart.to_json() == jstart.to_json()
    assert len(tfl.layers.get_places()) == 1
    rng = np.random.RandomState(0)
    fs = [{"img": rng.rand(16, 784).astype(np.float32),
           "label": rng.randint(0, 10, (16, 1)).astype(np.int64)}
          for _ in range(3)]
    jscope = jfl.Scope()
    with jfl.scope_guard(jscope):
        exe = jfl.Executor()
        exe.run(jstart)
        init = {n: np.asarray(jscope.find_var(n))
                for n in jscope.local_var_names()}
        want = [float(np.asarray(exe.run(jprog, feed=f,
                                         fetch_list=[jloss])[0]))
                for f in fs]
    tscope = tfl.Scope()
    interop.load_reference_state(init, tscope, CPU, [tprog, tstart])
    texe = tfl.Executor(CPU)
    got = [float(texe.run(tprog, feed=f, fetch_list=[tloss],
                          scope=tscope)[0]) for f in fs]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_parallel_executor_without_place_needs_a_card():
    """Its entry point runs on the card unless the caller asks for the
    CPU (``use_cuda=False`` or ``place=CPUPlace()``)."""
    import torch

    from paddle_tpu_torch.parallel import ParallelExecutor

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: ParallelExecutor runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ParallelExecutor()


# ---- a gloo world of one process ----

@pytest.fixture(scope="module")
def world1():
    import torch.distributed as dist

    from paddle_tpu_torch.parallel.distribute import init_multihost

    d = tempfile.mkdtemp(prefix="ptp_world1_")
    init_multihost("file://" + os.path.join(d, "store"), 1, 0,
                   device="cpu", timeout_s=60)
    try:
        yield
    finally:
        dist.destroy_process_group()
        shutil.rmtree(d, ignore_errors=True)


def _pe(fl_prog, loss, **kw):
    from paddle_tpu_torch.parallel import ParallelExecutor

    return ParallelExecutor(use_cuda=False, loss_name=loss.name,
                            main_program=fl_prog, **kw)


def _mlp_run(kind="mlp", **kw):
    prog, startup, loss = tp.build(tfl, kind)
    scope = tfl.Scope()
    tfl.Executor(CPU).run(startup, scope=scope)
    pe = _pe(prog, loss, **kw)
    return pe, prog, loss, scope


def test_one_rank_census_and_plain_executor_bitwise(world1):
    """At one rank the global view is the plain Executor bitwise, and a
    step's census holds one exchange (all-to-all + all-gather) a
    gradient plus the loss mean's gather, each bucket launched before
    the last backward op but the one the last backward op closes."""
    from paddle_tpu_torch.parallel import CommConfig, comm_audit

    fs = tp.feeds("dense")
    prog, startup, loss = tp.build(tfl, "mlp")
    s0 = tfl.Scope()
    exe = tfl.Executor(CPU)
    exe.run(startup, scope=s0)
    init = {n: np.asarray(s0.find_var(n)) for n in s0.local_var_names()}
    want = [exe.run(prog, feed=f, fetch_list=[loss], scope=s0)[0]
            for f in fs]
    for comm, zero in [(None, 0), (None, 1), (CommConfig(bucket_mb=0.05), 0),
                       (CommConfig(bucket_mb=0.05, zero_stage=1), 0)]:
        scope = tfl.Scope()
        interop.load_reference_state(init, scope, CPU, [prog, startup])
        pe = _pe(prog, loss, comm_config=comm, zero_stage=zero)
        got = [pe.run(feed=f, fetch_list=[loss], scope=scope)[0]
               for f in fs]
        assert all(a.tobytes() == b.tobytes() for a, b in zip(got, want))
        for n in init:
            assert np.asarray(scope.find_var(n)).tobytes() == \
                np.asarray(s0.find_var(n)).tobytes(), (comm, zero, n)
        plan = pe._comm_plans[prog.fingerprint]
        census = pe.last_census
        stats = comm_audit.collective_stats(census)
        per_bucket = 1 if plan.config.zero_stage else 2
        assert census.count("bucket") == per_bucket * len(plan.buckets)
        assert census.count("mean") == 1
        if plan.config.zero_stage:
            assert census.count("param") == len(plan.zero_updates)
        assert stats["all_to_all"]["count"] == len(plan.buckets)
        overlap = comm_audit.bucket_overlap(census, prog)
        assert sorted(overlap) == list(range(len(plan.buckets)))
        assert sum(overlap.values()) >= len(plan.buckets) - 1


@pytest.mark.parametrize("case", ["zero_stage", "nhwc", "zero_guard",
                                  "non_mean_loss"])
def test_executor_rejections(world1, case):
    from paddle_tpu_torch import guard, passes
    from paddle_tpu_torch.parallel import CommConfig

    prog, startup, loss = tp.build(tfl, "mlp")
    feed = tp.feeds("dense")[0]
    scope = tfl.Scope()
    tfl.Executor(CPU).run(startup, scope=scope)
    if case == "zero_stage":
        pe, match = _pe(prog, loss, zero_stage=1,
                        comm_config=CommConfig()), "zero_stage=0"
    elif case == "nhwc":
        passes.enable(prog, layout="NHWC", feed_layout="NCHW")
        pe, match = _pe(prog, loss, zero_stage=0,
                        comm_config=CommConfig()), "NHWC layout pass"
    elif case == "zero_guard":
        guard.enable(prog, loss, divergence=False)
        pe, match = _pe(prog, loss, zero_stage=0,
                        comm_config=CommConfig(zero_stage=1)), "guard"
    else:
        prog, startup = tfl.Program(), tfl.Program()
        with tfl.unique_name.guard(), tfl.program_guard(prog, startup):
            x = tfl.layers.data("x", [64])
            loss = tfl.layers.reduce_sum(tfl.layers.fc(x, 4))
            tfl.optimizer.SGD(0.1).minimize(loss)
        tfl.Executor(CPU).run(startup, scope=scope)
        pe, match = _pe(prog, loss, zero_stage=0,
                        comm_config=CommConfig()), "mean"
        feed = {"x": feed["x"]}
    with pytest.raises(ValueError, match=match):
        pe.run(fetch_list=[loss.name], feed=feed, scope=scope)


def test_global_view_gaps_raise(world1):
    """The global view over the NHWC pass needs B7 to take a cross-rank
    sum (ROADMAP); a world change needs the elastic rebuild; the audit
    stand-ins name the census."""
    from paddle_tpu_torch import passes
    from paddle_tpu_torch.parallel.mesh import Mesh as M

    pe, prog, loss, scope = _mlp_run(zero_stage=0)
    passes.enable(prog, layout="NHWC", feed_layout="NCHW")
    with pytest.raises(NotImplementedError, match="B7"):
        pe.run(fetch_list=[loss.name], feed=tp.feeds("dense")[0],
               scope=scope)
    with pytest.raises(NotImplementedError, match="item 5"):
        pe.set_mesh(M(("dp",), (2,), (0, 1)))
    assert pe.set_mesh(pe.mesh) is pe
    with pytest.raises(NotImplementedError, match="census"):
        pe.compiled_hlo()
    with pytest.raises(NotImplementedError, match="census"):
        tfl.Executor(CPU).hlo_text()


def test_nan_guard_warns_and_takes_the_global_view(world1):
    from paddle_tpu_torch.parallel import CommConfig

    pe, prog, loss, scope = _mlp_run(zero_stage=0,
                                     comm_config=CommConfig())
    tfl.set_flags({"FLAGS_check_nan_inf": True})
    try:
        with pytest.warns(RuntimeWarning, match="check_nan_inf"):
            pe.run(fetch_list=[loss.name], feed=tp.feeds("dense")[0],
                   scope=scope)
    finally:
        tfl.set_flags({"FLAGS_check_nan_inf": False})
    assert pe._comm_plans[prog.fingerprint].config.bucket_mb == 0.0


def test_make_mesh(world1):
    from paddle_tpu_torch.parallel import make_mesh

    m = make_mesh()
    assert m.axis_names == ("dp",) and m.shape == {"dp": 1}
    with pytest.raises(ValueError, match=r"mesh \(2,\) needs 2 devices, "
                                         r"have 1"):
        make_mesh((2,), ("dp",))
    # the tensor, sequence, pipeline and expert axes are all ported; an
    # axis outside them is refused
    for axes in (("dp", "mp"), ("dp", "sp"), ("dp", "pp"), ("dp", "ep")):
        m = make_mesh((1, 1), axes)
        assert m.axis_names == axes and m.coords() == {a: 0 for a in axes}
        assert m.line(axes[1]) == [0]
    with pytest.raises(ValueError, match="axes must be distinct names"):
        make_mesh((1, 1), ("dp", "xp"))


def test_sharded_state_reads_the_whole_array(world1):
    """Under the global view's ZeRO the scope keeps this rank's rows of
    each accumulator, and np.asarray reads the whole declared array."""
    pe, prog, loss, scope = _mlp_run(zero_stage=1)
    pe.run(fetch_list=[loss.name], feed=tp.feeds("dense")[0], scope=scope)
    v = scope.find_var("fc_0.w_0_moment1_0")
    assert isinstance(v, tcol.ShardedState)
    assert np.asarray(v).shape == (64, 128)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pe2 = _pe(prog, loss, zero_stage=0)
        pe2.run(fetch_list=[loss.name], feed=tp.feeds("dense")[0],
                scope=scope)
    assert not isinstance(scope.find_var("fc_0.w_0_moment1_0"),
                          tcol.ShardedState)
