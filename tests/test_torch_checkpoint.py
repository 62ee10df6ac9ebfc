"""The port's checkpoints against the JAX package's, on the CPU.

* **Plain** (``distributed/checkpoint.py``): for the same state the
  port's record file is byte for byte the JAX package's, bfloat16
  included, and the meta is equal but for its timestamp; each package
  loads the other's checkpoint. The JAX package cannot load a bfloat16
  checkpoint, its own or the port's (``jnp.asarray`` of a ``'<V2'``
  record, and ``_assemble``'s cast of one, raise: ROADMAP.md Queue 3),
  so bfloat16 crosses one way, JAX package -> port, bitwise.
* **Sharded** (``distributed/sharded_checkpoint.py``): each package
  restores the other's generations in one process; the port writes
  sharded at gloo worlds 2 and 3 (ZeRO-1 accumulators, whose rows are
  flat stretches written as boxes of the global shape, and a 'pp'
  ``ShardedState``: each rank's stage) and the JAX package restores them
  onto its own mesh, bitwise the port's values, and trains on at its
  uninterrupted trajectory (rtol 1e-4, tests/test_checkpoint_reshard.py's
  bound); at world 2 an int8 ``CommConfig`` run saved and restored at the
  same world is bitwise the uninterrupted one (each rank keeps its own
  error-feedback residual, as the JAX package keeps a value of the same
  shape), and the JAX package restores it and trains on at the port's
  trajectory; at world 3 ``set_mesh`` onto a mesh of the same two ranks
  keeps the ZeRO-1 rows (the old groups destroyed), and a step and a
  sharded save go on bitwise the run without it; the JAX package's dp x mp save
  (tests/test_checkpoint_reshard.py:53-96) restores into the port at gloo
  worlds 2 and 4, which trains on at the same bound.
* The corruption, quarantine, nonce, stale-partial and torn-write cases
  of tests/test_checkpoint_reshard.py:184-346 and
  tests/test_distributed.py:157-213, in the port.
"""

import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_gloo_harness as harness  # noqa: E402

BATCH = 12
SPAWN_TIMEOUT = 150
_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS and __name__ != "__main__":
    torch.set_num_threads(max(1, os.cpu_count() // int(_WORKERS)))


def build(fl):
    """tests/test_checkpoint_reshard.py's net: an 'mp'-column fc 64 ->
    128 (no bias), fc 10 softmax, Adam 1e-2."""
    with fl.unique_name.guard():
        prog, startup = fl.Program(), fl.Program()
        with fl.program_guard(prog, startup):
            img = fl.layers.data("img", [64])
            label = fl.layers.data("label", [1], dtype="int64")
            attr = fl.ParamAttr(sharding=(None, "mp"))
            h = fl.layers.fc(img, 128, act="relu", param_attr=attr,
                             bias_attr=False)
            pred = fl.layers.fc(h, 10, act="softmax")
            loss = fl.layers.mean(fl.layers.cross_entropy(pred, label))
            fl.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    return prog, startup, loss


def build_pp(fl, stages):
    """A pipelined fc (tests/test_torch_pipeline.py's ``build_dsl``):
    one stacked [stages, 64, 64] weight, SGD."""
    layers = fl.layers
    with fl.unique_name.guard():
        prog, startup = fl.Program(), fl.Program()
        with fl.program_guard(prog, startup):
            x = layers.data("x", [64])
            pipe = layers.Pipeline(num_stages=stages, num_micro=stages)
            with pipe.stage():
                h = pipe.input(x)
                h = layers.fc(h, 64, act="relu")
                pipe.output(h)
            loss = layers.mean(pipe())
            fl.optimizer.SGD(0.1).minimize(loss)
    return prog, startup, loss


def feed(step, batch=BATCH):
    rng = np.random.RandomState(100 + step)
    return {"img": rng.rand(batch, 64).astype(np.float32),
            "label": rng.randint(0, 10, (batch, 1)).astype(np.int64)}


def pp_feed(step, batch=BATCH):
    rng = np.random.RandomState(200 + step)
    return {"x": rng.rand(batch, 64).astype(np.float32)}


def _np(v):
    return v.float().numpy() if isinstance(v, torch.Tensor) and \
        v.dtype == torch.bfloat16 else (
            v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))


def _jax_state(prog, startup):
    import paddle_tpu as jf

    with jf.scope_guard(jf.Scope()):
        jf.Executor().run(startup)
        s = jf.global_scope()
        return {v.name: np.asarray(s.find_var(v.name))
                for v in prog.list_vars() if v.persistable}


def _pair_state():
    """The JAX startup's state and the same state in a port scope."""
    import paddle_tpu as jf
    import paddle_tpu_torch as tf
    from paddle_tpu_torch import interop

    jprog, jstart, _ = build(jf)
    tprog, tstart, _ = build(tf)
    state = _jax_state(jprog, jstart)
    scope = tf.Scope()
    interop.load_reference_state(state, scope, tf.CPUPlace(),
                                 [tprog, tstart])
    return state, jprog, tprog, scope


# ---- one process ----

def test_plain_record_file_is_the_jax_packages(tmp_path):
    """The same state: the same record file bytes; the meta equal but
    for its timestamp; each package loads the other's checkpoint."""
    import paddle_tpu as jf
    import paddle_tpu_torch as tf
    from paddle_tpu.distributed import checkpoint as jck
    from paddle_tpu_torch.distributed import checkpoint as tck

    state, jprog, tprog, scope = _pair_state()
    with jf.scope_guard(jf.Scope()):
        js = jf.global_scope()
        import jax.numpy as jnp
        for n, v in state.items():
            js.set_var(n, jnp.asarray(v))
        jck.save_checkpoint(str(tmp_path / "j"), 3, scope=js, program=jprog,
                            extra_meta={"tag": 1})
    tck.save_checkpoint(str(tmp_path / "t"), 3, scope=scope, program=tprog,
                        extra_meta={"tag": 1})
    name = "ckpt-%012d.rio" % 3
    with open(tmp_path / "j" / name, "rb") as a, \
            open(tmp_path / "t" / name, "rb") as b:
        assert a.read() == b.read()
    metas = []
    for d in ("j", "t"):
        with open(tmp_path / d / (name + ".meta.json")) as f:
            m = json.load(f)
        m.pop("timestamp")
        metas.append(m)
    assert metas[0] == metas[1]
    s2 = tf.Scope()
    assert tck.load_checkpoint(str(tmp_path / "j"), scope=s2,
                               place=tf.CPUPlace())["step"] == 3
    for n, v in state.items():
        assert _np(s2.find_var(n)).tobytes() == v.tobytes(), n
    with jf.scope_guard(jf.Scope()):
        js = jf.global_scope()
        jck.load_checkpoint(str(tmp_path / "t"), scope=js)
        for n, v in state.items():
            assert np.asarray(js.find_var(n)).tobytes() == v.tobytes(), n


def test_bfloat16_same_bytes_and_jax_to_port(tmp_path):
    """A bfloat16 value: the port's plain record file is the JAX
    package's, and the port restores the JAX package's plain and
    sharded bfloat16 generations bitwise (float32 beside it)."""
    import jax.numpy as jnp
    import ml_dtypes

    import paddle_tpu as jf
    import paddle_tpu_torch as tf
    from paddle_tpu.distributed import checkpoint as jck
    from paddle_tpu.distributed import sharded_checkpoint as jsc
    from paddle_tpu_torch.distributed import checkpoint as tck
    from paddle_tpu_torch.distributed import sharded_checkpoint as tsc

    x = np.random.RandomState(0).randn(3, 5).astype(np.float32)
    with jf.scope_guard(jf.Scope()):
        js = jf.global_scope()
        js.set_var("w", jnp.asarray(x.astype(ml_dtypes.bfloat16)))
        js.set_var("f", jnp.asarray(x))
        jck.save_checkpoint(str(tmp_path / "j"), 1, scope=js,
                            names=["w", "f"])
        jsc.save_sharded_checkpoint(str(tmp_path / "js"), 1, scope=js,
                                    names=["w", "f"])
    ts = tf.Scope()
    ts.set_var("w", torch.from_numpy(x).bfloat16())
    ts.set_var("f", torch.from_numpy(x))
    tck.save_checkpoint(str(tmp_path / "t"), 1, scope=ts, names=["w", "f"])
    name = "ckpt-%012d.rio" % 1
    with open(tmp_path / "j" / name, "rb") as a, \
            open(tmp_path / "t" / name, "rb") as b:
        assert a.read() == b.read()
    want = torch.from_numpy(x).bfloat16().view(torch.int16)
    for load in (lambda s: tck.load_checkpoint(str(tmp_path / "j"), s,
                                               place=tf.CPUPlace()),
                 lambda s: tsc.load_sharded_checkpoint(
                     str(tmp_path / "js"), s, {}, place=tf.CPUPlace())):
        s = tf.Scope()
        load(s)
        assert s.find_var("w").dtype == torch.bfloat16
        assert torch.equal(s.find_var("w").view(torch.int16), want)
        assert s.find_var("f").numpy().tobytes() == x.tobytes()


def test_uncompressed_generations_load_in_the_jax_package(tmp_path):
    """``compressor="none"`` (plain and sharded, through both managers)
    writes uncompressed chunks, which the JAX package restores bitwise."""
    import paddle_tpu as jf
    from paddle_tpu.distributed import checkpoint as jck
    from paddle_tpu.distributed import sharded_checkpoint as jsc
    from paddle_tpu_torch.distributed import checkpoint as tck
    from paddle_tpu_torch.distributed import sharded_checkpoint as tsc

    state, jprog, tprog, scope = _pair_state()
    tck.CheckpointManager(str(tmp_path / "t"), program=tprog, scope=scope,
                          compressor="none").save(4)
    m = tsc.ShardedCheckpointManager(str(tmp_path / "ts"),
                                     compressor="none")
    m.save(4, scope, tprog)
    m.wait()
    for d in ("t", "ts"):
        for path in glob.glob(str(tmp_path / d / "*.rio")):
            with open(path, "rb") as f:
                assert np.frombuffer(f.read(20), "<u4")[2] == 0, path
    with jf.scope_guard(jf.Scope()):
        js = jf.global_scope()
        assert jck.load_checkpoint(str(tmp_path / "t"),
                                   scope=js)["step"] == 4
        j2 = jf.Scope()
        assert jsc.load_sharded_checkpoint(str(tmp_path / "ts"), j2,
                                           {})["step"] == 4
        for n, v in state.items():
            assert np.asarray(js.find_var(n)).tobytes() == v.tobytes(), n
            assert np.asarray(j2.find_var(n)).tobytes() == v.tobytes(), n


def test_sharded_cross_load_one_process(tmp_path):
    """One process: either package restores the other's sharded
    generation ({} targets), bitwise."""
    import jax.numpy as jnp

    import paddle_tpu as jf
    import paddle_tpu_torch as tf
    from paddle_tpu.distributed import sharded_checkpoint as jsc
    from paddle_tpu_torch.distributed import sharded_checkpoint as tsc

    state, jprog, tprog, scope = _pair_state()
    tsc.save_sharded_checkpoint(str(tmp_path / "t"), 2, scope, tprog)
    with jf.scope_guard(jf.Scope()):
        js = jf.global_scope()
        for n, v in state.items():
            js.set_var(n, jnp.asarray(v))
        jsc.save_sharded_checkpoint(str(tmp_path / "j"), 2, js, jprog)
        j2 = jf.Scope()
        assert jsc.load_sharded_checkpoint(str(tmp_path / "t"), j2,
                                           {})["step"] == 2
        for n, v in state.items():
            assert np.asarray(j2.find_var(n)).tobytes() == v.tobytes(), n
    t2 = tf.Scope()
    assert tsc.load_sharded_checkpoint(str(tmp_path / "j"), t2, {},
                                       place=tf.CPUPlace())["step"] == 2
    for n, v in state.items():
        assert _np(t2.find_var(n)).tobytes() == v.tobytes(), n


def _mlp():
    import paddle_tpu_torch as tf

    prog, startup = tf.Program(), tf.Program()
    with tf.unique_name.guard(), tf.program_guard(prog, startup):
        x = tf.layers.data("x", [4])
        y = tf.layers.data("y", [1])
        pred = tf.layers.fc(x, 1)
        loss = tf.layers.mean(tf.layers.square_error_cost(pred, y))
        tf.optimizer.SGD(0.1).minimize(loss)
    exe = tf.Executor(tf.CPUPlace())
    scope = tf.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    xv = rng.rand(8, 4).astype("float32")
    f = {"x": xv, "y": (xv.sum(1, keepdims=True) * 0.5).astype("float32")}
    return prog, loss, exe, scope, f


def test_plain_save_resume_corruption_and_async_retention(tmp_path):
    """tests/test_distributed.py:157-213: train, save step 3, train on,
    restore step 3; a corrupt newest data file falls back to the
    verified one; the async manager keeps the last 2 and restores 7."""
    from paddle_tpu_torch.distributed.checkpoint import (
        CheckpointManager, latest_checkpoint, load_checkpoint,
        save_checkpoint)

    prog, loss, exe, scope, f = _mlp()
    d = str(tmp_path / "a")
    for _ in range(3):
        exe.run(prog, feed=f, fetch_list=[loss], scope=scope)
    save_checkpoint(d, step=3, scope=scope, program=prog)
    ref = {n: _np(scope.find_var(n)).copy()
           for n in scope.local_var_names()
           if isinstance(scope.find_var(n), torch.Tensor)}
    exe.run(prog, feed=f, fetch_list=[loss], scope=scope)
    assert load_checkpoint(d, scope=scope)["step"] == 3
    for n in (v.name for v in prog.list_vars() if v.persistable):
        assert _np(scope.find_var(n)).tobytes() == ref[n].tobytes(), n
    save_checkpoint(d, step=4, scope=scope, program=prog)
    path = os.path.join(d, "ckpt-%012d.rio" % 4)
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(path, "wb").write(bytes(blob))
    assert latest_checkpoint(d)["step"] == 3
    assert load_checkpoint(d, scope=scope)["step"] == 3
    with pytest.raises(IOError, match="CRC"):
        load_checkpoint(d, scope=scope, step=4)
    d2 = str(tmp_path / "b")
    mgr = CheckpointManager(d2, keep_max=2, save_interval_steps=2,
                            async_save=True, program=prog, scope=scope)
    for step in range(1, 8):
        exe.run(prog, feed=f, fetch_list=[loss], scope=scope)
        mgr.save(step)
    mgr.wait()
    assert len(glob.glob(os.path.join(d2, "*.meta.json"))) <= 2
    assert mgr.restore()["step"] == 7


def test_a_restored_run_pins_its_step_and_replays_dropout(tmp_path):
    """A fresh ``Executor`` resumed from a checkpoint of step 1 passes
    ``run(step0=2)``: its dropout masks are the uninterrupted run's, so
    its losses and state are bitwise; at the fresh counter (0) they are
    not."""
    import paddle_tpu_torch as tf
    from paddle_tpu_torch.distributed.checkpoint import (load_checkpoint,
                                                         save_checkpoint)

    prog, startup = tf.Program(), tf.Program()
    with tf.unique_name.guard(), tf.program_guard(prog, startup):
        x = tf.layers.data("x", [16])
        h = tf.layers.dropout(tf.layers.fc(x, 32, act="relu"), 0.5)
        loss = tf.layers.mean(tf.layers.fc(h, 1))
        tf.optimizer.SGD(0.1).minimize(loss)
    f = {"x": np.random.RandomState(0).rand(8, 16).astype("float32")}
    cpu = tf.CPUPlace()
    scope = tf.Scope()
    tf.Executor(cpu).run(startup, scope=scope)
    exe = tf.Executor(cpu)

    def run(exe, scope, s=None):
        return float(exe.run(prog, feed=f, fetch_list=[loss], scope=scope,
                             step0=s)[0])

    whole = [run(exe, scope, s) for s in range(2)]
    d = str(tmp_path / "ck")
    save_checkpoint(d, step=1, scope=scope, program=prog)
    whole += [run(exe, scope) for _ in range(2)]
    want = {v.name: _np(scope.find_var(v.name)).tobytes()
            for v in prog.list_vars() if v.persistable}
    for pin in (True, False):
        s2 = tf.Scope()
        meta = load_checkpoint(d, scope=s2, place=cpu)
        exe2 = tf.Executor(cpu)
        got = [run(exe2, s2, meta["step"] + 1 if pin else None),
               run(exe2, s2)]
        same = got == whole[2:] and all(
            _np(s2.find_var(n)).tobytes() == b for n, b in want.items())
        assert same == pin, (pin, got, whole)


def test_torn_writes_never_commit(tmp_path):
    """A torn data write (``checkpoint.data_write``) or shard write
    (``checkpoint.shard_write``) raises and commits nothing: the
    previous generation stays the newest."""
    from paddle_tpu_torch import fault
    from paddle_tpu_torch.distributed.checkpoint import (
        latest_checkpoint, save_checkpoint)
    from paddle_tpu_torch.distributed.sharded_checkpoint import (
        latest_sharded_checkpoint, save_sharded_checkpoint)

    prog, loss, exe, scope, f = _mlp()
    save_checkpoint(str(tmp_path / "p"), 1, scope=scope, program=prog)
    save_sharded_checkpoint(str(tmp_path / "s"), 1, scope, prog)
    try:
        with fault.scope("checkpoint.data_write", torn_bytes=20):
            with pytest.raises(fault.FaultInjected):
                save_checkpoint(str(tmp_path / "p"), 2, scope=scope,
                                program=prog)
        with fault.scope("checkpoint.shard_write", torn_bytes=20):
            with pytest.raises(fault.FaultInjected):
                save_sharded_checkpoint(str(tmp_path / "s"), 2, scope,
                                        prog)
    finally:
        fault.clear()
    assert latest_checkpoint(str(tmp_path / "p"))["step"] == 1
    assert latest_sharded_checkpoint(str(tmp_path / "s"))["step"] == 1


def test_corrupt_shard_quarantined_and_skipped(tmp_path):
    """The newest generation's shard corrupted: the scan quarantines it
    (a warning; its files under quarantine/) and restores the previous
    one; an explicit step raises IOError."""
    import paddle_tpu_torch as tf
    from paddle_tpu_torch.distributed.sharded_checkpoint import (
        latest_sharded_checkpoint, load_sharded_checkpoint,
        save_sharded_checkpoint)

    prog, loss, exe, scope, f = _mlp()
    ckpt = str(tmp_path / "c")
    save_sharded_checkpoint(ckpt, 1, scope, prog)
    exe.run(prog, feed=f, fetch_list=[loss], scope=scope)
    save_sharded_checkpoint(ckpt, 2, scope, prog)
    (rio,) = glob.glob(os.path.join(ckpt, "sharded-*2.p000.rio"))
    with open(rio, "r+b") as fh:
        fh.seek(30)
        fh.write(b"\xde\xad\xbe\xef")
    with pytest.warns(RuntimeWarning, match="crc_mismatch"):
        best = latest_sharded_checkpoint(ckpt)
    assert best["step"] == 1
    assert glob.glob(os.path.join(ckpt, "quarantine", "sharded-*2.*"))
    save_sharded_checkpoint(ckpt, 3, scope, prog)
    (rio,) = glob.glob(os.path.join(ckpt, "sharded-*3.p000.rio"))
    with open(rio, "r+b") as fh:
        fh.seek(30)
        fh.write(b"\xde\xad\xbe\xef")
    with pytest.warns(RuntimeWarning):
        with pytest.raises(IOError, match="crc_mismatch"):
            load_sharded_checkpoint(ckpt, tf.Scope(), {}, step=3,
                                    place=tf.CPUPlace())


def test_manager_merge_stale_partial_and_nonce(tmp_path):
    """tests/test_checkpoint_reshard.py's TestSaveAttemptIntegrity: the
    manager's num_processes passthrough merges both files; a partial
    naming a torn shard times out as stale; a prior attempt's partial is
    refused under a shared nonce, and the merged manifest records the
    peers' nonces."""
    from paddle_tpu_torch.distributed.sharded_checkpoint import (
        ShardedCheckpointManager, _persistable_names,
        latest_sharded_checkpoint, save_sharded_checkpoint)

    prog, loss, exe, scope, f = _mlp()
    ckpt = str(tmp_path / "m")
    m1 = ShardedCheckpointManager(ckpt, process_index=1, num_processes=2)
    m0 = ShardedCheckpointManager(ckpt, process_index=0, num_processes=2)
    m1.save(1, scope, prog, force=True)
    m1.wait()
    m0.save(1, scope, prog, force=True)
    m0.wait()
    manifest = latest_sharded_checkpoint(ckpt)
    assert len(manifest["files"]) == 2 and manifest["peer_nonces"]

    names = _persistable_names(scope, prog)
    half = max(1, len(names) // 2)
    ckpt = str(tmp_path / "stale")
    save_sharded_checkpoint(ckpt, 1, scope, prog, process_index=1,
                            num_processes=2, names=names[half:])
    (rio,) = glob.glob(os.path.join(ckpt, "sharded-*1.p001.rio"))
    with open(rio, "r+b") as fh:
        fh.seek(10)
        fh.write(b"\xde\xad\xbe\xef")
    with pytest.raises(TimeoutError, match="stale"):
        save_sharded_checkpoint(ckpt, 1, scope, prog, process_index=0,
                                num_processes=2, names=names[:half],
                                barrier_timeout=0.5)

    ckpt = str(tmp_path / "nonce")
    save_sharded_checkpoint(ckpt, 1, scope, prog, process_index=1,
                            num_processes=2, names=names[half:],
                            nonce="attempt-0")
    with pytest.raises(TimeoutError, match="stale"):
        save_sharded_checkpoint(ckpt, 1, scope, prog, process_index=0,
                                num_processes=2, names=names[:half],
                                nonce="attempt-1", barrier_timeout=0.5)
    save_sharded_checkpoint(ckpt, 1, scope, prog, process_index=1,
                            num_processes=2, names=names[half:],
                            nonce="attempt-1")
    mpath = save_sharded_checkpoint(ckpt, 1, scope, prog, process_index=0,
                                    num_processes=2, names=names[:half],
                                    nonce="attempt-1")
    with open(mpath) as fh:
        merged = json.load(fh)
    assert merged["nonce"] == "attempt-1"
    assert set(merged["peer_nonces"].values()) == {"attempt-1"}


def test_flat_stretches_are_boxes():
    """A rank's flat stretch of a value is written as boxes of the
    global shape that cover it exactly, each one contiguous."""
    from paddle_tpu_torch.distributed.sharded_checkpoint import _flat_boxes

    rng = np.random.RandomState(0)
    for shape in [(7,), (5, 3), (4, 3, 5), (2, 1, 3, 4), ()]:
        n = int(np.prod(shape))
        for _ in range(20):
            lo = int(rng.randint(0, n + 1))
            hi = int(rng.randint(lo, n + 1))
            full = np.arange(n).reshape(shape)
            got = []
            for box, a, b in _flat_boxes(shape, lo, hi):
                part = full[tuple(slice(s, e) for s, e in box)]
                assert part.ravel().tolist() == list(range(a, b))
                got += part.ravel().tolist()
            assert got == list(range(lo, hi)), (shape, lo, hi)


# ---- gloo worlds ----

def _jax_dpmp_save(d):
    """tests/test_checkpoint_reshard.py:53-96's interrupted run: 3 steps
    on a (2, 4) dp x mp mesh, ZeRO-1, saved; and the uninterrupted 6
    steps' losses."""
    import paddle_tpu as jf
    from paddle_tpu.distributed.sharded_checkpoint import \
        save_sharded_checkpoint
    from paddle_tpu.parallel import make_mesh
    from paddle_tpu.parallel.parallel_executor import ParallelExecutor

    prog, startup, loss = build(jf)
    init = _jax_state(prog, startup)
    np.savez(os.path.join(d, "init.npz"), **init)
    losses = []
    with jf.scope_guard(jf.Scope()):
        jf.Executor().run(startup)
        pe = ParallelExecutor(loss_name=loss.name, main_program=prog,
                              mesh=make_mesh((2, 4), ("dp", "mp")),
                              zero_stage=1, donate_params=False)
        for s in range(6):
            losses.append(float(np.asarray(pe.run(
                fetch_list=[loss.name], feed=feed(s), program=prog)[0])))
            if s == 2:
                save_sharded_checkpoint(os.path.join(d, "jax_dpmp"), 3,
                                        jf.global_scope(), prog)
    return init, losses


def _pieces_once(manifest):
    """The merged manifest lists every piece once, and each value's
    pieces cover it exactly (their elements add up to its size)."""
    seen = [(p["var"], json.dumps(p["index"])) for p in manifest["pieces"]]
    assert len(seen) == len(set(seen))
    for name, meta in manifest["vars"].items():
        n = sum(int(np.prod([b - a for a, b in p["index"]]))
                for p in manifest["pieces"] if p["var"] == name)
        assert n == int(np.prod(meta["shape"])), name


def _jax_continue(d, world, init, ref):
    """The JAX package restores the port's world-``world`` generations
    onto its own meshes: the ZeRO-1 one bitwise the port's values, and
    trains on at the uninterrupted trajectory; the 'pp' one bitwise."""
    import paddle_tpu as jf
    from paddle_tpu.distributed.sharded_checkpoint import \
        load_sharded_checkpoint
    from paddle_tpu.parallel import make_mesh
    from paddle_tpu.parallel.parallel_executor import ParallelExecutor

    prog, startup, loss = build(jf)
    with np.load(os.path.join(d, "zero_w%d.npz" % world)) as z:
        port = {k: z[k] for k in z.files}
    with jf.scope_guard(jf.Scope()):
        pe = ParallelExecutor(loss_name=loss.name, main_program=prog,
                              mesh=make_mesh((world,), ("dp",)),
                              zero_stage=1, donate_params=False)
        m = load_sharded_checkpoint(os.path.join(d, "zero_w%d" % world),
                                    jf.global_scope(),
                                    pe.state_shardings(prog))
        assert m["step"] == 3 and len(m["files"]) == world
        _pieces_once(m)
        for n, v in port.items():
            got = np.asarray(jf.global_scope().find_var(n))
            assert got.tobytes() == v.astype(got.dtype).tobytes(), n
        cont = [float(np.asarray(pe.run(fetch_list=[loss.name],
                                        feed=feed(s), program=prog)[0]))
                for s in range(3, 6)]
    np.testing.assert_allclose(cont, ref[3:], rtol=1e-4)
    pprog, _, _ = build_pp(jf, world)
    with np.load(os.path.join(d, "pp_w%d.npz" % world)) as z:
        port = {k: z[k] for k in z.files}
    with jf.scope_guard(jf.Scope()):
        pe = ParallelExecutor(main_program=pprog,
                              mesh=make_mesh((world,), ("pp",)),
                              zero_stage=0)
        m = load_sharded_checkpoint(os.path.join(d, "pp_w%d" % world),
                                    jf.global_scope(),
                                    pe.state_shardings(pprog))
        assert m["step"] == 2
        _pieces_once(m)
        stacked = [n for n in port if port[n].ndim == 3]
        assert stacked and port[stacked[0]].shape[0] == world
        for n, v in port.items():
            assert np.asarray(jf.global_scope().find_var(n)).tobytes() \
                == v.tobytes(), n


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Gloo worlds of 2, 3 and 4 (one spawn each, this file as a
    script) with the JAX side's dp x mp save and trajectory."""
    d = str(tmp_path_factory.mktemp("worlds"))
    init, ref = _jax_dpmp_save(d)
    with open(os.path.join(d, "ref.json"), "w") as f:
        json.dump(ref, f)
    for world in (2, 3, 4):
        os.makedirs(os.path.join(d, "w%d" % world))
    started = [harness.start(__file__, w, os.path.join(d, "w%d" % w),
                             SPAWN_TIMEOUT) for w in (2, 3, 4)]
    for w, st in zip((2, 3, 4), started):
        harness.finish(st, os.path.join(d, "w%d" % w))
    return d, init, ref


@pytest.mark.parametrize("world", [2, 3])
def test_port_sharded_restores_onto_the_jax_mesh(worlds, world):
    d, init, ref = worlds
    _jax_continue(os.path.join(d, "w%d" % world), world, init, ref)


def test_int8_error_feedback_survives_a_same_world_restore(worlds):
    """World 2, ``CommConfig(quantize="int8")``: 3 steps, a sharded save,
    a restore into a fresh scope and executor, 3 more steps: the port's
    losses and every value, the error-feedback residuals included, are
    bitwise the uninterrupted run's (checked on the ranks). The JAX
    package restores the same generation at world 2, keeps its residuals
    as saved, and trains on at the port's trajectory."""
    import paddle_tpu as jf
    from paddle_tpu.distributed.sharded_checkpoint import \
        load_sharded_checkpoint
    from paddle_tpu.parallel import CommConfig, make_mesh
    from paddle_tpu.parallel.collectives import EF_PREFIX
    from paddle_tpu.parallel.parallel_executor import ParallelExecutor

    d = os.path.join(worlds[0], "w2")
    with open(os.path.join(d, "int8.json")) as f:
        got = json.load(f)
    assert got["restored"] == got["uninterrupted"][3:]
    with np.load(os.path.join(d, "int8_saved.npz")) as z:
        saved = {k: z[k] for k in z.files}
    ef = sorted(n for n in saved if n.startswith(EF_PREFIX))
    assert ef and all(saved[n].any() for n in ef), ef
    prog, startup, loss = build(jf)
    with jf.scope_guard(jf.Scope()):
        pe = ParallelExecutor(loss_name=loss.name, main_program=prog,
                              mesh=make_mesh((2,), ("dp",)),
                              zero_stage=0,
                              comm_config=CommConfig(quantize="int8"),
                              donate_params=False)
        m = load_sharded_checkpoint(os.path.join(d, "int8"),
                                    jf.global_scope(),
                                    pe.state_shardings(prog))
        assert m["step"] == 2
        _pieces_once(m)
        for n, v in saved.items():
            assert np.asarray(jf.global_scope().find_var(n)).tobytes() \
                == v.tobytes(), n
        cont = [float(np.asarray(pe.run(fetch_list=[loss.name],
                                        feed=feed(s), program=prog)[0]))
                for s in range(3, 6)]
        for n in ef:
            assert np.asarray(jf.global_scope().find_var(n)).shape \
                == saved[n].shape, n
    np.testing.assert_allclose(cont, got["restored"], rtol=1e-4)


def test_set_mesh_onto_the_same_ranks_keeps_the_zero_rows(worlds):
    """World 3, ZeRO-1 over a mesh of ranks 0 and 1 (rank 2 outside it):
    ``set_mesh`` onto a new mesh of the same ranks destroys the old
    mesh's group; the next step re-wraps the held rows onto the new
    group, and the run, a sharded save of it and its restore are bitwise
    the run without ``set_mesh``."""
    with open(os.path.join(worlds[0], "w3", "remesh.json")) as f:
        got = json.load(f)
    assert got["remeshed"] == got["fixed"]
    assert got["state_equal"] and got["restored_equal"]
    assert got["held_rows"] > 0 and got["on_live_group"]


@pytest.mark.parametrize("world", [2, 4])
def test_jax_dp_mp_save_restores_into_the_port(worlds, world):
    """The JAX package's (2, 4) dp x mp ZeRO-1 generation restores into
    the port's ``ParallelExecutor`` at world ``world``; the port trains
    on at the JAX uninterrupted trajectory."""
    d, init, ref = worlds
    with open(os.path.join(d, "w%d" % world, "jax_dpmp.json")) as f:
        got = json.load(f)
    assert got["step"] == 3
    np.testing.assert_allclose(got["losses"], ref[3:], rtol=1e-4)


# ---- the port's side: one process a rank ----

def _state_of(scope, prog):
    """Every persistable's whole value (a collective for ZeRO rows)."""
    return {n: np.asarray(scope.find_var(n))
            for n in sorted(v.name for v in prog.list_vars()
                            if v.persistable)
            if scope.find_var(n) is not None}


def _same(a, b):
    return set(a) == set(b) and all(
        a[n].dtype == b[n].dtype and a[n].tobytes() == b[n].tobytes()
        for n in a)


def _int8_same_world(rank, d, init):
    """The port's side of
    ``test_int8_error_feedback_survives_a_same_world_restore``."""
    import paddle_tpu_torch as tf
    from paddle_tpu_torch import interop
    from paddle_tpu_torch.distributed.sharded_checkpoint import (
        load_sharded_checkpoint, save_sharded_checkpoint)
    from paddle_tpu_torch.parallel import (CommConfig, ParallelExecutor,
                                           collectives, make_mesh)

    cpu = tf.CPUPlace()
    prog, startup, loss = build(tf)

    def new_pe():
        return ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                main_program=prog,
                                mesh=make_mesh((2,), ("dp",)),
                                zero_stage=0,
                                comm_config=CommConfig(quantize="int8"))

    def step(pe, scope, s):
        return float(pe.run(fetch_list=[loss.name], feed=feed(s),
                            scope=scope, step0=s)[0])

    def state(scope):
        names = [v.name for v in prog.list_vars() if v.persistable]
        names += collectives.state_names(scope)
        return {n: np.asarray(scope.find_var(n)) for n in sorted(names)}

    scope = tf.Scope()
    interop.load_reference_state(init, scope, cpu, [prog, startup])
    pe = new_pe()
    whole = [step(pe, scope, s) for s in range(6)]
    final = state(scope)
    scope = tf.Scope()
    interop.load_reference_state(init, scope, cpu, [prog, startup])
    pe = new_pe()
    for s in range(3):
        step(pe, scope, s)
    gen = os.path.join(d, "int8")
    save_sharded_checkpoint(gen, 2, scope, prog, process_index=rank,
                            num_processes=2)
    saved = state(scope)
    scope, pe = tf.Scope(), new_pe()
    m = load_sharded_checkpoint(gen, scope, pe.state_shardings(prog),
                                place=cpu)
    restored = [step(pe, scope, m["step"] + 1 + i) for i in range(3)]
    assert _same(state(scope), final)
    if rank == 0:
        np.savez(os.path.join(d, "int8_saved.npz"), **saved)
        with open(os.path.join(d, "int8.json"), "w") as f:
            json.dump({"uninterrupted": whole, "restored": restored}, f)


def _remesh_same_ranks(rank, d, init):
    """The port's side of
    ``test_set_mesh_onto_the_same_ranks_keeps_the_zero_rows``: every rank
    makes each mesh (its group is made by all); ranks 0 and 1 train."""
    import paddle_tpu_torch as tf
    from paddle_tpu_torch import interop
    from paddle_tpu_torch.distributed.sharded_checkpoint import (
        load_sharded_checkpoint, save_sharded_checkpoint)
    from paddle_tpu_torch.parallel import (ParallelExecutor, collectives,
                                           make_mesh)

    cpu = tf.CPUPlace()
    prog, startup, loss = build(tf)

    def run(remesh, gen):
        mesh = make_mesh((2,), ("dp",))
        scope, pe = tf.Scope(), None
        if rank < 2:
            interop.load_reference_state(init, scope, cpu, [prog, startup])
            pe = ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                  main_program=prog, mesh=mesh)
        losses = []
        for s in range(4):
            if s == 2 and remesh:
                new = make_mesh((2,), ("dp",))
                if pe is not None:
                    pe.set_mesh(new)
            if pe is not None:
                losses.append(float(pe.run(fetch_list=[loss.name],
                                           feed=feed(s), scope=scope)[0]))
        save_sharded_checkpoint(gen, 3, scope, prog, process_index=rank,
                                num_processes=3)
        held = [scope.find_var(v.name) for v in prog.list_vars()
                if isinstance(scope.find_var(v.name),
                              collectives.ShardedState)]
        # gloo still runs a collective on a destroyed group (NCCL does
        # not), so hold the rows' group itself to the mesh's
        live = pe is None or all(
            v.group is pe.mesh.axis_group("dp") for v in held)
        return losses, (_state_of(scope, prog) if pe is not None
                        else {}), (len(held), live), pe

    fixed, want, _, _ = run(False, os.path.join(d, "fixed"))
    remeshed, got, held, pe = run(True, os.path.join(d, "remeshed"))
    out = {"fixed": fixed, "remeshed": remeshed, "held_rows": held[0],
           "on_live_group": held[1]}
    if pe is not None:
        out["state_equal"] = _same(got, want)
        scope = tf.Scope()
        load_sharded_checkpoint(os.path.join(d, "remeshed"), scope,
                                pe.state_shardings(prog), place=cpu)
        out["restored_equal"] = _same(_state_of(scope, prog), want)
    if rank == 0:
        with open(os.path.join(d, "remesh.json"), "w") as f:
            json.dump(out, f)


def _worker(rank, world, d):
    harness.join(rank, world, d, SPAWN_TIMEOUT)
    import paddle_tpu_torch as tf
    from paddle_tpu_torch import interop
    from paddle_tpu_torch.distributed.sharded_checkpoint import (
        load_sharded_checkpoint, save_sharded_checkpoint)
    from paddle_tpu_torch.parallel import ParallelExecutor, make_mesh

    top = os.path.dirname(d)
    with np.load(os.path.join(top, "init.npz")) as z:
        init = {k: z[k] for k in z.files}
    cpu = tf.CPUPlace()
    if world in (2, 3):
        prog, startup, loss = build(tf)
        scope = tf.Scope()
        interop.load_reference_state(init, scope, cpu, [prog, startup])
        pe = ParallelExecutor(use_cuda=False, loss_name=loss.name,
                              main_program=prog,
                              mesh=make_mesh((world,), ("dp",)))
        for s in range(3):
            pe.run(fetch_list=[loss.name], feed=feed(s), scope=scope)
        save_sharded_checkpoint(os.path.join(d, "zero_w%d" % world), 3,
                                scope, prog, process_index=rank,
                                num_processes=world)
        state = _state_of(scope, prog)
        if rank == 0:
            np.savez(os.path.join(d, "zero_w%d.npz" % world), **state)
        pprog, pstart, ploss = build_pp(tf, world)
        pscope = tf.Scope()
        tf.Executor(cpu).run(pstart, scope=pscope)
        pe = ParallelExecutor(use_cuda=False, main_program=pprog,
                              mesh=make_mesh((world,), ("pp",)),
                              zero_stage=0)
        for s in range(2):
            pe.run(fetch_list=[ploss.name], feed=pp_feed(s), scope=pscope)
        save_sharded_checkpoint(os.path.join(d, "pp_w%d" % world), 2,
                                pscope, pprog, process_index=rank,
                                num_processes=world)
        state = _state_of(pscope, pprog)
        if rank == 0:
            np.savez(os.path.join(d, "pp_w%d.npz" % world), **state)
    if world == 2:
        _int8_same_world(rank, d, init)
    if world == 3:
        _remesh_same_ranks(rank, d, init)
    if world in (2, 4):
        prog, startup, loss = build(tf)
        scope = tf.Scope()
        pe = ParallelExecutor(use_cuda=False, loss_name=loss.name,
                              main_program=prog,
                              mesh=make_mesh((world,), ("dp",)))
        m = load_sharded_checkpoint(os.path.join(top, "jax_dpmp"), scope,
                                    pe.state_shardings(prog), place=cpu)
        losses = [float(pe.run(fetch_list=[loss.name], feed=feed(s),
                               scope=scope)[0]) for s in range(3, 6)]
        if rank == 0:
            with open(os.path.join(d, "jax_dpmp.json"), "w") as f:
                json.dump({"step": m["step"], "losses": losses}, f)
    harness.leave()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
