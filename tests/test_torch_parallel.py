"""The port's ParallelExecutor against the JAX package's, at gloo worlds of
2, 3 and 4 ranks on the CPU.

For each world one spawn of that many processes (this file run as a
script, one process a rank, a gloo world over a file store, its own time
limit) runs every scenario below through ``paddle_tpu_torch.parallel.
ParallelExecutor(use_cuda=False)``; the test process runs the same
programs through ``paddle_tpu.parallel.ParallelExecutor`` on a
``make_mesh((n,), ("dp",))`` of the conftest's virtual CPU devices,
from the same numpy feeds and the JAX startup's weights (carried over by
``paddle_tpu_torch.interop``). Losses and every state tensor after 3
steps agree at ``rtol 1e-5`` plus ``1e-6 * max|JAX value|``:

* ``mlp_*``: tests/test_comm.py's MLP (Adam) in every mode: the global
  view (``comm_config=None``) at zero_stage 0 and 1,
  ``CommConfig(bucket_mb=0.05)`` bucketed, with ZeRO-1, and the int8
  and fp8 exchanges (its SGD and Momentum twins hold the ZeRO contract
  below, against the port's own zero_stage 0);
* ``resnet_*``: tests/test_parallel_executor.py's resnet_cifar (batch
  norm, Momentum): under ``None`` batch norm takes GLOBAL statistics (it
  also matches the serial run), under a CommConfig per-rank statistics,
  as the JAX package's comm path does;
* ``lstm_*``: a small stacked LSTM over ragged PackedSeq rows, and
  ``packed_*``: tests/test_comm.py:158's loss, a mean over a PackedSeq
  (the global token count divides every rank's sum);
* ``guard``: tests/test_guard.py:842 with the poisoned gradient on ONE
  rank: the step is skipped on every rank;
* ``chunk``: ``run_chunk`` against sequential runs
  (tests/test_chunked_exec.py:416);
* ``global_feed``: each rank feeds its own rows through
  ``distribute.global_batch_feed``; fetches come back global.

The port's own contracts hold bitwise: the comm fp32 path and the global
view at zero_stage 1 are the global view at zero_stage 0 on the MLP (and
the comm path the global view on the LSTM and the PackedSeq mean, nets
without batch norm, which the JAX package's comm path is as well: those
two are held against its global view), and
ZeRO-1 is zero_stage 0 for SGD, Momentum and Adam (an element's sum over
the ranks is taken in rank order wherever it sits,
``parallel/collectives.py``). The int8 and fp8 exchanges round to their
grid: a gradient whose scaled value sits within the two packages'
float32 difference of a rounding boundary may round the other way, so
they agree with the JAX package within one quantization step of the
gradient (its bucket's max over 127 or, for fp8, 2**-3 of the value)
times the learning rate, and their losses at 1e-4.

Adam divides each moment by the root of the second: an element whose
gradient is a near-cancelling sum (a ReLU unit dead on most rows) has
the relative error of that sum in its step, whatever the two packages'
float32 rounding was. Parameters trained by Adam are therefore held
within ``1e-4`` of a step (``1e-4 * lr * steps``) beyond the tolerance
above; their moments, and every other value, at the tolerance itself.

v2 ``trainer_count=2`` trains in the world of 2 and its costs match the
JAX package's v2 trainer at the same count.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest

STEPS = 3
BATCH = 12
WORLDS = (2, 3, 4)
SPAWN_TIMEOUT = 150

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name -> (builder, mode, feeds)
SCENARIOS = {
    "mlp_none": ("mlp", "none", "dense"),
    "mlp_none_z1": ("mlp", "none_z1", "dense"),
    "mlp_comm": ("mlp", "comm", "dense"),
    "mlp_comm_z1": ("mlp", "comm_z1", "dense"),
    "mlp_int8": ("mlp", "int8", "dense"),
    "mlp_fp8": ("mlp", "fp8", "dense"),
    "mlp_sgd_comm": ("mlp_sgd", "comm", "dense"),
    "mlp_sgd_comm_z1": ("mlp_sgd", "comm_z1", "dense"),
    "mlp_momentum_comm": ("mlp_momentum", "comm", "dense"),
    "mlp_momentum_comm_z1": ("mlp_momentum", "comm_z1", "dense"),
    "resnet_none": ("resnet", "none", "image"),
    "resnet_comm": ("resnet", "comm", "image"),
    "lstm_none": ("lstm", "none", "words"),
    "lstm_comm": ("lstm", "comm", "words"),
    "packed_none": ("packed", "none", "packed"),
    "packed_comm": ("packed", "comm", "packed"),
    "guard": ("small_guarded", "none_z1", "small"),
    "chunk": ("small", "none_z1", "small"),
    "global_feed": ("mlp", "none", "dense"),
}

# the scenarios held against a JAX run of their own; the others are
# the port's contracts only (BITWISE), or equal to a listed run
JAX_RUNS = [n for n in SCENARIOS if not n.startswith(("mlp_sgd",
                                                      "mlp_momentum"))
            and n not in ("global_feed", "lstm_comm", "packed_comm")]
JAX_OF = {"global_feed": "mlp_none", "lstm_comm": "lstm_none",
          "packed_comm": "packed_none"}

# the Adam-trained builders and their learning rate (the docstring)
ADAM_LR = {"mlp": 1e-3, "lstm": 1e-2}

# pairs the port holds bitwise: (scenario, the scenario it equals)
BITWISE = [("mlp_none_z1", "mlp_none"), ("mlp_comm", "mlp_none"),
           ("mlp_comm_z1", "mlp_comm"), ("mlp_sgd_comm_z1", "mlp_sgd_comm"),
           ("mlp_momentum_comm_z1", "mlp_momentum_comm"),
           ("global_feed", "mlp_none"), ("packed_comm", "packed_none"),
           ("lstm_comm", "lstm_none")]


# ---- the programs, built alike by both packages ----

def build(fl, kind):
    from_layers = fl.layers
    prog, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(prog, startup):
        if kind.startswith("mlp"):
            x = from_layers.data("x", [64])
            label = from_layers.data("label", [1], dtype="int64")
            h = from_layers.fc(x, 128, act="relu")
            h2 = from_layers.fc(h, 256, act="relu")
            p = from_layers.fc(h2, 10, act="softmax")
            loss = from_layers.mean(from_layers.cross_entropy(p, label))
            opt = {"mlp": fl.optimizer.Adam(1e-3),
                   "mlp_sgd": fl.optimizer.SGD(0.1),
                   "mlp_momentum": fl.optimizer.Momentum(0.05, 0.9)}[kind]
            opt.minimize(loss)
        elif kind == "resnet":
            from_res = __import__(fl.__name__ + ".models.resnet",
                                  fromlist=["conv_bn_layer"])
            img = from_layers.data("data", [3, 16, 16])
            label = from_layers.data("label", [1], dtype="int64")
            h = from_res.conv_bn_layer(img, 16, 3, 1, 1)
            h = from_res.basicblock(h, 16, 1)
            h = from_res.basicblock(h, 32, 2)
            pool = from_layers.pool2d(h, pool_type="avg",
                                      global_pooling=True)
            hidden = from_layers.fc(pool, 64, act="relu")
            predict = from_layers.fc(hidden, 10, act="softmax")
            loss = from_layers.mean(
                from_layers.cross_entropy(predict, label))
            fl.optimizer.Momentum(0.05, 0.9).minimize(loss)
        elif kind == "lstm":
            words = from_layers.data("words", [1], dtype="int64",
                                     lod_level=1)
            label = from_layers.data("label", [1], dtype="int64")
            # three forward LSTMs: the JAX package's reverse LSTM loses
            # position 0 of short rows (ROADMAP.md Queue 3), and the
            # rows here are ragged
            h = from_layers.embedding(words, size=[100, 16])
            for _ in range(3):
                fc = from_layers.fc(h, size=64, num_flatten_dims=2)
                h, _ = from_layers.dynamic_lstm(fc, size=64)
            pooled = from_layers.sequence_pool(h, pool_type="max")
            predict = from_layers.fc(pooled, 2, act="softmax")
            loss = from_layers.mean(
                from_layers.cross_entropy(predict, label))
            fl.optimizer.Adam(1e-2).minimize(loss)
        elif kind == "packed":
            # tests/test_comm.py:158: the loss a mean over a PackedSeq,
            # whose local view divides by the GLOBAL token count
            xv = from_layers.data("xv", [12], lod_level=1)
            h = from_layers.fc(xv, 32, act="tanh")
            loss = from_layers.mean(from_layers.fc(h, 1))
            fl.optimizer.SGD(0.1).minimize(loss)
        else:   # small, small_guarded
            x = from_layers.data("x", [8])
            label = from_layers.data("label", [1], dtype="int64")
            predict = from_layers.fc(x, 4, act="softmax")
            loss = from_layers.mean(
                from_layers.cross_entropy(predict, label))
            fl.optimizer.Momentum(0.01, 0.9).minimize(loss)
            if kind == "small_guarded":
                fl.guard.enable(prog, loss, dynamic_loss_scale=True,
                                init_loss_scale=32.0, divergence=False)
    return prog, startup, loss


def feeds(kind, steps=STEPS, batch=BATCH):
    """[{name: numpy}] one a step; a sequence feed as (data, lengths)."""
    out = []
    for s in range(steps):
        rng = np.random.RandomState(100 + s)
        if kind == "dense":
            out.append({"x": rng.rand(batch, 64).astype(np.float32),
                        "label": rng.randint(0, 10, (batch, 1))
                        .astype(np.int64)})
        elif kind == "image":
            out.append({"data": rng.rand(batch, 3, 16, 16)
                        .astype(np.float32),
                        "label": rng.randint(0, 10, (batch, 1))
                        .astype(np.int64)})
        elif kind == "packed":
            lengths = rng.randint(1, 7, batch).astype(np.int32)
            out.append({"xv": (rng.rand(batch, 6, 12).astype(np.float32),
                               lengths)})
        elif kind == "words":
            lengths = rng.randint(1, 9, batch).astype(np.int32)
            data = np.zeros((batch, 8, 1), np.int64)
            for i, n in enumerate(lengths):
                data[i, :n, 0] = rng.randint(0, 100, n)
            out.append({"words": (data, lengths),
                        "label": rng.randint(0, 2, (batch, 1))
                        .astype(np.int64)})
        else:
            out.append({"x": rng.rand(batch, 8).astype(np.float32),
                        "label": rng.randint(0, 4, (batch, 1))
                        .astype(np.int64)})
    return out


def as_feed(fl, feed):
    return {n: fl.PackedSeq(*v) if isinstance(v, tuple) else v
            for n, v in feed.items()}


def mode_args(fl_parallel, mode):
    """(comm_config, executor zero_stage) of a mode."""
    C = fl_parallel.CommConfig
    return {"none": (None, 0), "none_z1": (None, 1),
            "comm": (C(bucket_mb=0.05), 0),
            "comm_z1": (C(bucket_mb=0.05, zero_stage=1), 0),
            "int8": (C(bucket_mb=0.05, quantize="int8"), 0),
            "fp8": (C(bucket_mb=0.05, quantize="fp8"), 0)}[mode]


def snapshot(scope):
    out = {}
    for n in sorted(scope.local_var_names()):
        v = scope.find_var(n)
        if hasattr(v, "shape"):
            a = np.asarray(v)
            out[n] = a.astype(np.float64) if a.dtype.kind in "fiub" \
                else a
    return out


def _save(path, losses, state, extra=None):
    arrays = {"loss%d" % i: np.asarray(l) for i, l in enumerate(losses)}
    arrays.update({"s:" + n: v for n, v in state.items()})
    for k, v in (extra or {}).items():
        arrays["x:" + k] = np.asarray(v)
    np.savez(path, **arrays)


def _load(path):
    with np.load(path) as z:
        losses = [z["loss%d" % i] for i in range(
            sum(1 for k in z.files if k.startswith("loss")))]
        state = {k[2:]: z[k] for k in z.files if k.startswith("s:")}
        extra = {k[2:]: z[k] for k in z.files if k.startswith("x:")}
    return losses, state, extra


# ---- the port's side: one process a rank ----

def _port_scenario(name, rank, world, d):
    import paddle_tpu_torch as fl
    from paddle_tpu_torch import fault, interop, parallel
    from paddle_tpu_torch.parallel.distribute import global_batch_feed

    kind, mode, fkind = SCENARIOS[name]
    prog, startup, loss = build(fl, kind)
    scope = fl.Scope()
    with np.load(os.path.join(d, "init_%s.npz" % kind)) as z:
        interop.load_reference_state({k: z[k] for k in z.files}, scope,
                                     fl.CPUPlace(), [prog, startup])
    comm, zero = mode_args(parallel, mode)
    pe = parallel.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                   main_program=prog, zero_stage=zero,
                                   comm_config=comm)
    fs = [as_feed(fl, f) for f in feeds(fkind)]
    extra = {}
    if name == "guard":
        if rank == 1:
            fault.inject("guard.nonfinite", crash_on_nth=2, times=1)
        try:
            out = pe.run_chunk(prog, feed_chunk=fl.stack_feeds(fs[:2]),
                               fetch_list=[loss.name], step0=0,
                               scope=scope)
            extra["health"] = pe.poll_health()
        finally:
            fault.clear()
        losses = list(out[0])
    elif name == "chunk":
        pe._step = 1
        seq = [pe.run(feed=f, fetch_list=[loss.name], scope=scope)[0]
               for f in fs]
        seq_state = snapshot(scope)
        scope2 = fl.Scope()
        with np.load(os.path.join(d, "init_%s.npz" % kind)) as z:
            interop.load_reference_state({k: z[k] for k in z.files},
                                         scope2, fl.CPUPlace(),
                                         [prog, startup])
        pe2 = parallel.ParallelExecutor(
            use_cuda=False, loss_name=loss.name, main_program=prog,
            zero_stage=zero, comm_config=comm)
        out = pe2.run_chunk(prog, feed_chunk=fl.stack_feeds(fs),
                            fetch_list=[loss.name], step0=1, scope=scope2)
        losses = list(out[0])
        state = snapshot(scope2)
        extra["seq_bitwise"] = int(
            all(a.tobytes() == b.tobytes() for a, b in
                zip(np.asarray(seq).ravel(), np.asarray(losses).ravel()))
            and all(seq_state[n].tobytes() == state[n].tobytes()
                    for n in seq_state))
        if rank == 0:
            _save(os.path.join(d, "out_%s.npz" % name), losses, state,
                  extra)
        return
    elif name == "global_feed":
        m = BATCH // world
        losses = []
        for f in fs:
            mine = {n: v[rank * m:(rank + 1) * m] for n, v in f.items()}
            got = pe.run(feed=global_batch_feed(pe.mesh, mine),
                         fetch_list=[loss.name, "fc_2.tmp_2"], scope=scope)
            losses.append(got[0])
            extra.setdefault("rows", got[1].shape[0])
    else:
        losses = [pe.run(feed=f, fetch_list=[loss.name], scope=scope)[0]
                  for f in fs]
    state = snapshot(scope)
    census = pe.last_census
    extra["collectives"] = len(census) if census is not None else -1
    if rank == 0:
        _save(os.path.join(d, "out_%s.npz" % name), losses, state, extra)


def _port_v2(rank, world, d):
    import paddle_tpu_torch as fl
    import paddle_tpu_torch.v2 as v2

    sys.path.insert(0, _ROOT)
    import chip_smoke

    with chip_smoke.v2_session(fl, v2, False, 0):
        v2.init(use_gpu=False, trainer_count=2)
        cost, params = _v2_model(v2)
        with np.load(os.path.join(d, "init_v2.npz")) as z:
            for k in z.files:
                params[k] = z[k]
        costs = []
        trainer = v2.trainer.SGD(cost=cost, parameters=params,
                                 update_equation=v2.optimizer.Adam(0.05))
        trainer.train(v2.batch(_xor_rows, 8), num_passes=2,
                      event_handler=lambda e: costs.append(e.cost)
                      if isinstance(e, v2.event.EndIteration) else None)
        v2.init(use_gpu=False, trainer_count=1)
    if rank == 0:
        np.save(os.path.join(d, "out_v2.npy"), np.asarray(costs))


def _v2_model(v2):
    x = v2.layer.data("x", v2.data_type.dense_vector(2))
    label = v2.layer.data("label", v2.data_type.integer_value(2))
    hidden = v2.layer.fc(input=x, size=16, act=v2.activation.Tanh())
    pred = v2.layer.fc(input=hidden, size=2, act=v2.activation.Softmax())
    cost = v2.layer.classification_cost(input=pred, label=label)
    return cost, v2.parameters.create(cost)


def _xor_rows():
    rng = np.random.RandomState(3)
    for _ in range(32):
        x = rng.randint(0, 2, size=(2,)).astype("float32")
        yield x, np.int64(int(x[0]) ^ int(x[1]))


def _worker(rank, world, d):
    import torch

    torch.set_num_threads(1)
    from paddle_tpu_torch.parallel.distribute import init_multihost

    init_multihost("file://" + os.path.join(d, "store"), world, rank,
                   device="cpu", timeout_s=SPAWN_TIMEOUT)
    with open(os.path.join(d, "scenarios.json")) as f:
        names = json.load(f)
    for name in names:
        _port_scenario(name, rank, world, d)
    if world == 2:
        _port_v2(rank, world, d)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


def _start(world, d):
    """Start ``world`` ranks of this file (stopped by ``_finish``); each
    writes its output to a file of ``d`` (a pipe left unread would
    block a rank, and with it every collective of its world)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    procs = []
    for r in range(world):
        with open(os.path.join(d, "rank%d.log" % r), "wb") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), str(r),
                 str(world), d], env=env, stdout=log,
                stderr=subprocess.STDOUT))
    return procs, time.monotonic() + SPAWN_TIMEOUT


def _finish(started, d):
    """Every rank must exit 0 by the world's deadline; none outlives
    it."""
    procs, deadline = started
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        logs = []
        for r, _ in bad:
            with open(os.path.join(d, "rank%d.log" % r), "rb") as f:
                logs.append(f.read()[-3000:].decode(errors="replace"))
        raise AssertionError("ranks failed %s:\n%s" % (bad,
                                                        "\n".join(logs)))


# ---- the JAX side, in the test process ----

def _jax_init(kind, d):
    """The JAX startup's state of a builder, for the port's ranks."""
    import paddle_tpu as fl

    prog, startup, loss = build(fl, kind)
    scope = fl.Scope()
    with fl.scope_guard(scope):
        fl.Executor().run(startup)
        np.savez(os.path.join(d, "init_%s.npz" % kind),
                 **{n: np.asarray(scope.find_var(n))
                    for n in scope.local_var_names()
                    if hasattr(scope.find_var(n), "shape")})


def _jax_scenario(name, world, d):
    import paddle_tpu as fl
    from paddle_tpu import fault, parallel
    from paddle_tpu.parallel import make_mesh

    kind, mode, fkind = SCENARIOS[name]
    prog, startup, loss = build(fl, kind)
    fs = [as_feed(fl, f) for f in feeds(fkind)]
    scope = fl.Scope()
    with fl.scope_guard(scope):
        fl.Executor().run(startup)
        comm, zero = mode_args(parallel, mode)
        pe = parallel.ParallelExecutor(
            loss_name=loss.name, main_program=prog,
            mesh=make_mesh((world,), ("dp",)), zero_stage=zero,
            comm_config=comm)
        extra = {}
        if name == "guard":
            fault.inject("guard.nonfinite", crash_on_nth=2, times=1)
            try:
                out = pe.run_chunk(prog, feed_chunk=fl.stack_feeds(fs[:2]),
                                   fetch_list=[loss.name], step0=0)
                extra["health"] = pe.poll_health()
            finally:
                fault.clear()
            losses = list(np.asarray(out[0]))
        elif name == "chunk":
            out = pe.run_chunk(prog, feed_chunk=fl.stack_feeds(fs),
                               fetch_list=[loss.name], step0=1)
            losses = list(np.asarray(out[0]))
        else:
            losses = [np.asarray(pe.run(feed=f, fetch_list=[loss.name])[0])
                      for f in fs]
        state = snapshot(scope)
    return losses, state, extra


@pytest.fixture(scope="module")
def resnet_serial():
    """The resnet's 3 serial steps in both packages from the JAX
    startup's weights: (JAX losses, JAX state, the port's state)."""
    import paddle_tpu as jfl
    import paddle_tpu_torch as tfl
    from paddle_tpu_torch import interop

    fs = feeds("image")
    prog, startup, loss = build(jfl, "resnet")
    scope = jfl.Scope()
    with jfl.scope_guard(scope):
        exe = jfl.Executor()
        exe.run(startup)
        init = {n: np.asarray(scope.find_var(n))
                for n in scope.local_var_names()
                if hasattr(scope.find_var(n), "shape")}
        losses = [np.asarray(exe.run(prog, feed=as_feed(jfl, f),
                                     fetch_list=[loss.name])[0])
                  for f in fs]
        jstate = snapshot(scope)
    tprog, tstartup, tloss = build(tfl, "resnet")
    tscope = tfl.Scope()
    interop.load_reference_state(init, tscope, tfl.CPUPlace(),
                                 [tprog, tstartup])
    texe = tfl.Executor(tfl.CPUPlace())
    for f in fs:
        texe.run(tprog, feed=as_feed(tfl, f), fetch_list=[tloss.name],
                 scope=tscope)
    return losses, jstate, snapshot(tscope)


def _jax_v2(d):
    import paddle_tpu.v2 as v2

    v2.init(trainer_count=2)
    try:
        import paddle_tpu as fl

        with fl.unique_name.guard(), \
                fl.program_guard(fl.Program(), fl.Program()), \
                fl.scope_guard(fl.Scope()):
            cost, params = _v2_model(v2)
            np.savez(os.path.join(d, "init_v2.npz"),
                     **{n: params[n] for n in params.names()})
            costs = []
            trainer = v2.trainer.SGD(
                cost=cost, parameters=params,
                update_equation=v2.optimizer.Adam(0.05))
            trainer.train(v2.batch(_xor_rows, 8), num_passes=2,
                          event_handler=lambda e: costs.append(e.cost)
                          if isinstance(e, v2.event.EndIteration)
                          else None)
    finally:
        v2.init(trainer_count=1)
    return costs


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: "world%d" % w)
def world_run(request):
    """{scenario: (port, jax)} of one world: one spawn of the port's
    ranks runs every scenario while the JAX runs go on here."""
    world = request.param
    d = tempfile.mkdtemp(prefix="ptp_parallel_")
    try:
        for kind in sorted({k for k, _, _ in SCENARIOS.values()}):
            _jax_init(kind, d)
        jax_v2 = _jax_v2(d) if world == 2 else None
        with open(os.path.join(d, "scenarios.json"), "w") as f:
            json.dump(list(SCENARIOS), f)
        started = _start(world, d)
        try:
            jax_out = {name: _jax_scenario(name, world, d)
                       for name in JAX_RUNS}
        finally:
            _finish(started, d)
        port = {name: _load(os.path.join(d, "out_%s.npz" % name))
                for name in SCENARIOS}
        port_v2 = np.load(os.path.join(d, "out_v2.npy")) if world == 2 \
            else None
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return world, port, jax_out, (port_v2, jax_v2)


def _close(got, want, rtol=1e-5, what="", atol=0.0):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = rtol * np.abs(want) + 1e-6 * (np.abs(want).max() if want.size
                                        else 0.0) + atol
    err = np.abs(got - want)
    assert np.all(err <= tol), "%s: max err %g (at %s)" % (
        what, err.max(), np.unravel_index(err.argmax(), err.shape))


@pytest.mark.parametrize("name", [
    n for n in list(JAX_RUNS) + list(JAX_OF)
    if not n.startswith(("mlp_int8", "mlp_fp8", "resnet"))])
def test_matches_the_jax_parallel_executor(world_run, name):
    world, port, jax_out, _ = world_run
    (pl, ps, px), (jl, js, jx) = port[name], jax_out[JAX_OF.get(name,
                                                                name)]
    assert len(pl) == len(jl)
    for i, (a, b) in enumerate(zip(pl, jl)):
        _close(a, b, what="%s loss %d" % (name, i))
    assert set(ps) == set(js), set(ps) ^ set(js)
    lr = ADAM_LR.get(SCENARIOS[name][0])
    for n in js:
        adam_param = lr is not None and "_moment" not in n \
            and "_pow_" not in n and n != "learning_rate_0"
        _close(ps[n], js[n], what="%s %s" % (name, n),
               atol=1e-4 * lr * STEPS if adam_param else 0.0)
    if name == "guard":
        assert list(px["health"][:, 2]) == [0.0, 1.0]
        assert list(jx["health"][:, 2]) == [0.0, 1.0]
        assert float(ps["guard@loss_scale"]) == 16.0
    if name == "chunk":
        assert int(px["seq_bitwise"]) == 1
    if name == "global_feed":
        assert int(px["rows"]) == BATCH


@pytest.mark.parametrize("name", ["resnet_none", "resnet_comm"])
def test_resnet_matches_the_jax_parallel_executor(world_run, resnet_serial,
                                                  name):
    """The resnet at its initial weights is ill-conditioned (the verify
    notes: a 1e-6 input change moves ResNet gradients by a fifth of
    their size): the two packages' SERIAL runs from the same weights
    already differ by up to 3e4 times the tolerance after 3 Momentum
    steps. The first loss (global batch-norm statistics under None,
    per-rank under comm, one forward from equal weights) is held at the
    tolerance, the later losses at 1e-4, and each state tensor within
    the tolerance plus twice the serial runs' difference on it. Under
    None the losses are also the serial run's."""
    world, port, jax_out, _ = world_run
    (pl, ps, _), (jl, js, _) = port[name], jax_out[name]
    s_loss, s_jax, s_port = resnet_serial
    _close(pl[0], jl[0], what="%s loss 0" % name)
    for i, (a, b) in enumerate(zip(pl[1:], jl[1:])):
        _close(a, b, rtol=1e-4, what="%s loss %d" % (name, i + 1))
    if name == "resnet_none":
        _close(pl[0], s_loss[0], what="serial loss 0")
        for a, b in zip(pl[1:], s_loss[1:]):
            _close(a, b, rtol=1e-4, what="serial loss")
    assert set(ps) == set(js), set(ps) ^ set(js)
    for n in js:
        yardstick = np.abs(s_port[n] - s_jax[n]).max() \
            if n in s_jax and s_jax[n].size else 0.0
        _close(ps[n], js[n], what="%s %s" % (name, n),
               atol=2.0 * yardstick)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantized_exchange_matches_within_one_step(world_run, mode):
    """Losses at 1e-4. A rounding that flips (the docstring) moves an
    error-feedback residual by one quantization step, and the residual
    carries the flip into the next step's bucket, where it can move the
    bucket's scale and with it more roundings: at world 3 about 5 % of a
    bucket's residuals differ after 3 steps. So each state tensor is held
    at the tolerance (a residual, the gradient's rounding remainder,
    also within 3e-3 of its max: the gradient it was rounded from,
    whose bucket max is 254 residual maxima under int8, held at 1e-5 of
    that max) on all but a share of its
    elements (5 % of a parameter's or moment's, 10 % of a residual's),
    and every element within one quantization step (twice the
    residuals' max) or two Adam steps of a parameter."""
    world, port, jax_out, _ = world_run
    name = "mlp_" + mode
    (pl, ps, _), (jl, js, _) = port[name], jax_out[name]
    for a, b in zip(pl, jl):
        _close(a, b, rtol=1e-4, what="%s loss" % name)
    assert set(ps) == set(js)
    lr = ADAM_LR["mlp"]
    for n in js:
        a, b = ps[n], js[n]
        if not b.size:
            continue
        top = max(np.abs(b).max(), np.abs(a).max())
        tol = 1e-5 * np.abs(b) + 1e-6 * np.abs(b).max()
        if n.startswith("comm@"):
            tol = tol + 3e-3 * top
            share, bound = 0.10, 2.0 * top
        else:
            if "_moment" not in n and "_pow_" not in n \
                    and n != "learning_rate_0":
                tol = tol + 1e-4 * lr * STEPS
                bound = 2.0 * lr * STEPS
            else:
                bound = top
            share = 0.05
        off = np.abs(a - b) > tol
        assert off.mean() <= share, (name, n, off.mean())
        assert np.abs(a - b).max() <= bound, (name, n)


@pytest.mark.parametrize("pair", BITWISE, ids=lambda p: "%s=%s" % p)
def test_the_ports_own_contracts_hold_bitwise(world_run, pair):
    world, port, _, _ = world_run
    (al, as_, _), (bl, bs, _) = port[pair[0]], port[pair[1]]
    for a, b in zip(al, bl):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), pair
    for n in bs:
        if n.startswith("comm@"):
            continue
        # a CommConfig ZeRO accumulator reads [world, rows]: its padded
        # flat value, the other's elements first
        a = as_[n].reshape(-1)[:bs[n].size].reshape(bs[n].shape)
        assert a.tobytes() == bs[n].tobytes(), (pair, n)


@pytest.mark.parametrize("world_run", [2], indirect=True,
                         ids=["world2"])
def test_v2_trainer_count_2_trains_through_parallel_executor(world_run):
    world, _, _, (port_v2, jax_v2) = world_run
    assert len(port_v2) == len(jax_v2) == 8
    _close(port_v2, jax_v2, what="v2 costs")


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
