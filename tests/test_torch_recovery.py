"""Recovery against the JAX package: the guard's rollback, the elastic
world change and preemption, on the CPU.

* **Rollback** (``tests/test_guard.py``'s ``TestHealthManifests`` and
  ``TestDivergenceRollbackChaos``): each case runs in both packages on
  the same model (the JAX startup's weights carried over by
  ``interop.load_reference_state``), the same feeds and the same
  ``guard.nonfinite`` rule. The port holds the JAX test's contract and
  the JAX package's numbers: rollbacks, restarts, the chunks run, the
  rule's fires, the telemetry counters, the restored loss scale, the
  forensics record and the surviving generations exactly; every loss
  the step function fetched at rtol 1e-5.
* **Elastic** (``tests/test_elastic_reshard.py``'s ``TestLiveReshardChaos``
  and ``TestReshardStateUnit``) in a gloo world of 4 processes, the mesh
  going 4 -> 2 -> 4: every rank runs ``ElasticRecoveryLoop`` (a rank the
  2-mesh leaves out joins each rebuild and runs no step). The final
  weights hold the port's own fixed-world run at that test's bounds
  (rtol 1e-4, atol 1e-6: what the reshard may cost) and the JAX
  package's fixed-world trajectory (its ``ParallelExecutor`` on 4 of the
  conftest's virtual devices) at the same bounds, except where the JAX
  package's own trajectory moves beyond them with the world size (its
  runs on 1, 2 and 3 devices against 4: Adam's step of a gradient that
  is a near-cancelling sum follows its rounding): there within the
  bounds plus three times that spread (one element of fc_0.w_0 in 8192:
  the JAX package moves it 6.0e-6 across its worlds, the port 1.5e-5
  from its 4-device run; ROADMAP.md Queue 3). A worker swap (4 -> 4) is
  bitwise the port's own fixed-world run. The port's plans are rebuilt
  once an epoch (``set_mesh`` drops them: their graphs captured the old
  groups), so a 4 -> 2 -> 4 run builds 3 plans where the JAX package's
  compile cache builds 2.
* **Spill path**: a world-3 job trains 6 steps under ``RecoveryLoop`` and
  ends; a world-2 job restores its sharded generation onto its own mesh
  and trains the other 6: the JAX fixed-world trajectory at the same
  bounds.
* **Preemption**: ``raise_on_sigterm`` turns a SIGTERM into
  ``Preemption``; the loop restores and replays, bitwise the
  uninterrupted run.
"""

import glob
import json
import os
import signal
import sys
import types
import warnings

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_gloo_harness as harness  # noqa: E402

CPU = None
TOL = 1e-5
K, MAX_STEPS, BATCH = 2, 12, 12
SPAWN_TIMEOUT = 150

_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS and __name__ != "__main__":
    torch.set_num_threads(max(1, os.cpu_count() // int(_WORKERS)))


# ---- the models, built alike by both packages ----

def build_mlp(fl):
    """tests/test_elastic_reshard.py's net: fc 64 -> 128 relu -> 10
    softmax, Adam 1e-2."""
    with fl.unique_name.guard():
        prog, startup = fl.Program(), fl.Program()
        with fl.program_guard(prog, startup):
            img = fl.layers.data("img", [64])
            label = fl.layers.data("label", [1], dtype="int64")
            h = fl.layers.fc(img, 128, act="relu")
            pred = fl.layers.fc(h, 10, act="softmax")
            loss = fl.layers.mean(fl.layers.cross_entropy(pred, label))
            fl.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    return prog, startup, loss


def build_guarded(fl):
    """tests/test_guard.py's tiny fc net (SGD 0.1)."""
    with fl.unique_name.guard():
        prog, startup = fl.Program(), fl.Program()
        with fl.program_guard(prog, startup):
            x = fl.layers.data("x", [8])
            label = fl.layers.data("label", [1], dtype="int64")
            h = fl.layers.fc(x, 8, act="relu")
            predict = fl.layers.fc(h, 4, act="softmax")
            loss = fl.layers.mean(fl.layers.cross_entropy(predict, label))
            fl.optimizer.SGD(0.1).minimize(loss)
    return prog, startup, loss


def guard_feeds(n, batch=4, seed=0):
    rng = np.random.RandomState(seed)
    return [{"x": rng.rand(batch, 8).astype(np.float32),
             "label": rng.randint(0, 4, (batch, 1)).astype(np.int64)}
            for _ in range(n)]


def feed_chunk(step, k=K, batch=BATCH):
    """The super-batch of steps [step, step+k), the same on every mesh."""
    xs, ys = [], []
    for s in range(step, step + k):
        rng = np.random.RandomState(100 + s)
        xs.append(rng.rand(batch, 64).astype(np.float32))
        ys.append(rng.randint(0, 10, (batch, 1)).astype(np.int64))
    return {"img": np.stack(xs), "label": np.stack(ys)}


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


# ---- the JAX side ----

def _jax():
    import paddle_tpu as jf
    from paddle_tpu import fault, guard, telemetry
    from paddle_tpu.data_feeder import stack_feeds
    from paddle_tpu.distributed import recovery, sharded_checkpoint

    return types.SimpleNamespace(
        name="jax", fl=jf, fault=fault, guard=guard, tel=telemetry,
        stack=stack_feeds, recovery=recovery, sc=sharded_checkpoint,
        exe=lambda: jf.Executor())


def _port():
    import paddle_tpu_torch as tf
    from paddle_tpu_torch import fault, guard, telemetry
    from paddle_tpu_torch.data_feeder import stack_feeds
    from paddle_tpu_torch.distributed import recovery, sharded_checkpoint

    return types.SimpleNamespace(
        name="port", fl=tf, fault=fault, guard=guard, tel=telemetry,
        stack=stack_feeds, recovery=recovery, sc=sharded_checkpoint,
        exe=lambda: tf.Executor(tf.CPUPlace()))


@pytest.fixture(autouse=True)
def _clean():
    for P in (_jax(), _port()):
        P.fault.clear()
        P.tel.reset()
        P.tel.disable()
    yield
    for P in (_jax(), _port()):
        P.fault.clear()
        P.tel.reset()
        P.tel.disable()


def _pair(guard_kw):
    """The guarded net in both packages on the JAX startup's weights:
    {P.name: (P, program, loss, scope)}."""
    from paddle_tpu_torch import interop

    out, arrays = {}, None
    for P in (_jax(), _port()):
        prog, startup, loss = build_guarded(P.fl)
        P.guard.enable(prog, loss, **guard_kw)
        scope = P.fl.Scope()
        if P.name == "jax":
            P.exe().run(startup, scope=scope)
            arrays = {v.name: np.asarray(scope.find_var(v.name))
                      for v in prog.list_vars() if v.persistable}
        else:
            interop.load_reference_state(arrays, scope,
                                         P.fl.CPUPlace(), prog)
        out[P.name] = (P, prog, loss, scope)
    return out


def _summary(P, keys):
    s = P.tel.summary()
    return {k: s.get(k) for k in keys}


# ---- rollback: tests/test_guard.py's cases in both packages ----

_ROLLBACK = {
    # name: (guard kw, rule kw, max_steps, max_rollbacks, expect raise)
    "sustained": (dict(dynamic_loss_scale=True, init_loss_scale=256.0,
                       max_consecutive_skips=6),
                  dict(crash_on_nth=9, times=6), 24, 2, None),
    "stale_rows": (dict(max_consecutive_skips=4),
                   dict(crash_on_nth=9, times=8), 24, 2, None),
    "budget": (dict(max_consecutive_skips=2), dict(crash_on_nth=5), 12, 1,
               "divergence"),
    "no_clean": (dict(max_consecutive_skips=2), dict(crash_on_nth=1), 8, 3,
                 "no generation with clean"),
}

_COUNTERS = ("paddle_tpu_guard_skipped_steps_total",
             "paddle_tpu_fault_injected_total",
             "paddle_tpu_guard_rollbacks_total",
             "paddle_tpu_guard_divergence_total",
             "paddle_tpu_checkpoint_quarantined_total",
             "paddle_tpu_guard_loss_scale_ratio")


def _rollback_run(P, prog, loss, scope, case, ckpt):
    guard_kw, rule_kw, max_steps, max_rollbacks, raises = _ROLLBACK[case]
    P.tel.enable()
    exe = P.exe()
    feeds = guard_feeds(max_steps)
    rule = P.fault.inject("guard.nonfinite", **rule_kw)
    calls, losses = [], []

    def step_fn(step):
        calls.append(step)
        out = exe.run_chunk(prog, feed_chunk=P.stack(feeds[step:step + 4]),
                            k=4, fetch_list=[loss.name], step0=step,
                            scope=scope)
        losses.append(np.asarray(out[0], np.float64))

    kw = {} if P.name == "jax" else {"place": P.fl.CPUPlace()}
    loop = P.recovery.RecoveryLoop(ckpt, scope, prog, target_shardings={},
                                   save_interval_steps=1,
                                   max_rollbacks=max_rollbacks, **kw)
    err = None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            loop.run(step_fn, max_steps=max_steps, steps_per_call=4)
            exe.poll_health()
        except (P.guard.Divergence, RuntimeError) as e:
            err = e
    assert any("diverged" in str(w.message) for w in caught)
    if raises == "divergence":
        assert isinstance(err, P.guard.Divergence), err
    elif raises:
        assert err is not None and raises in str(err), err
    else:
        assert err is None, err
    out = {"rollbacks": loop.rollbacks, "restarts": loop.restarts,
           "calls": calls, "fires": rule.fires,
           "counters": _summary(P, _COUNTERS), "losses": losses,
           "scale": float(_np(scope.find_var("guard@loss_scale"))),
           "quarantined": sorted(os.listdir(os.path.join(ckpt,
                                                         "quarantine")))}
    recs = sorted(f for f in os.listdir(ckpt)
                  if f.startswith("divergence-"))
    out["forensics"] = []
    for f in recs:
        with open(os.path.join(ckpt, f)) as fh:
            rec = json.load(fh)
        out["forensics"].append({k: rec[k] for k in
                                 ("step", "chunk", "caught_at", "reason",
                                  "rollback")})
    best = P.sc.latest_sharded_checkpoint(ckpt, quarantine=False)
    out["best"] = None if best is None else (best["step"], best["health"])
    return out


@pytest.mark.parametrize("case", sorted(_ROLLBACK))
def test_rollback_matches_the_jax_package(case, tmp_path):
    """tests/test_guard.py's rollback cases (the sustained divergence,
    the stale pending rows, the budget, no clean generation): counters
    exactly, losses at 1e-5."""
    runs = _pair(_ROLLBACK[case][0])
    got = {}
    for name, (P, prog, loss, scope) in runs.items():
        got[name] = _rollback_run(P, prog, loss, scope, case,
                                  str(tmp_path / name))
    j, t = got["jax"], got["port"]
    for key in ("rollbacks", "restarts", "calls", "fires", "counters",
                "scale", "quarantined", "forensics", "best"):
        assert t[key] == j[key], (key, t[key], j[key])
    assert len(t["losses"]) == len(j["losses"])
    for a, b in zip(t["losses"], j["losses"]):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    if case == "sustained":
        # the JAX test's own numbers
        assert t["rollbacks"] == 1 and t["calls"].count(8) == 2
        assert t["fires"] == 6 and t["scale"] == 256.0
        assert t["forensics"][0]["chunk"] == [12, 16]
        assert t["best"][0] == 23 and t["best"][1]["clean"] is True
    if case == "stale_rows":
        assert t["rollbacks"] == 2 and t["fires"] == 8


def test_spike_divergence_rolls_back_before_onset(tmp_path):
    """A synthesized loss spike (onset 6) at step 8: generation 7 reads
    clean but is at/after the onset, so it is quarantined and the run
    resumes from generation 3, in both packages alike."""
    runs = _pair({})
    got = {}
    for name, (P, prog, loss, scope) in runs.items():
        exe = P.exe()
        feeds = guard_feeds(12)
        fired, losses = [], []

        def step_fn(step):
            out = exe.run_chunk(
                prog, feed_chunk=P.stack(feeds[step:step + 4]), k=4,
                fetch_list=[loss.name], step0=step, scope=scope)
            losses.append(np.asarray(out[0], np.float64))
            if step == 8 and not fired:
                fired.append(step)
                raise P.guard.Divergence("loss_spike", step=8,
                                         onset_step=6)

        ckpt = str(tmp_path / name)
        loop = P.recovery.RecoveryLoop(ckpt, scope, prog,
                                       target_shardings={},
                                       save_interval_steps=1,
                                       max_rollbacks=1)
        with pytest.warns(RuntimeWarning, match="diverged"):
            loop.run(step_fn, max_steps=12, steps_per_call=4)
        exe.poll_health()
        best = P.sc.latest_sharded_checkpoint(ckpt)
        qsteps = {int(f.split("-")[1].split(".")[0])
                  for f in os.listdir(os.path.join(ckpt, "quarantine"))}
        got[name] = (loop.rollbacks, fired, best["step"],
                     best["health"]["clean"], qsteps, losses)
    j, t = got["jax"], got["port"]
    assert t[:5] == j[:5] == (1, [8], 11, True, {7})
    for a, b in zip(t[5], j[5]):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


def test_guard_state_rides_checkpoints(tmp_path):
    """The loss scale and counters are saved and restored with the
    params (a restart must not reset a backed-off scale), in both
    packages: 64 halves to 32 after one poisoned step and comes back
    from the generation after ``reset_state``; each package restores
    the other's generation too (the counters: the JAX package's uint32,
    int64 in the port)."""
    runs = _pair(dict(dynamic_loss_scale=True, init_loss_scale=64.0,
                      divergence=False))
    for name, (P, prog, loss, scope) in runs.items():
        exe = P.exe()
        P.fault.inject("guard.nonfinite", crash_on_nth=1, times=1)
        exe.run(prog, feed=guard_feeds(1)[0], fetch_list=[loss.name],
                scope=scope)
        exe.poll_health()
        P.fault.clear()
        assert float(_np(scope.find_var("guard@loss_scale"))) == 32.0
        P.sc.save_sharded_checkpoint(str(tmp_path / name), 0, scope, prog)
    for name, (P, prog, loss, scope) in runs.items():
        for src in ("jax", "port"):
            P.guard.reset_state(scope)   # fresh-process amnesia
            # the port puts a value its scope lacks on ``place`` (the
            # card by default)
            kw = {"place": P.fl.CPUPlace()} if name == "port" else {}
            P.sc.load_sharded_checkpoint(str(tmp_path / src), scope, {},
                                         **kw)
            assert float(_np(scope.find_var("guard@loss_scale"))) == 32.0
            assert int(_np(scope.find_var("guard@skipped_steps"))) == 1
    t = runs["port"][3]
    assert t.find_var("guard@skipped_steps").dtype == torch.int64


def test_skip_in_unsaved_interval_marks_next_generation_unclean(tmp_path):
    """save_interval_steps=2: a skip on an uncommitted step dirties the
    next committed generation, in both packages alike."""
    runs = _pair(dict(divergence=False))
    got = {}
    for name, (P, prog, loss, scope) in runs.items():
        exe = P.exe()
        feeds = guard_feeds(4)
        P.fault.inject("guard.nonfinite", crash_on_nth=2, times=1)

        def step_fn(step):
            exe.run(prog, feed=feeds[step], fetch_list=[loss.name],
                    scope=scope)

        ckpt = str(tmp_path / name)
        loop = P.recovery.RecoveryLoop(ckpt, scope, prog,
                                       target_shardings={},
                                       save_interval_steps=2)
        loop.run(step_fn, max_steps=4)
        exe.poll_health()
        P.fault.clear()
        newest = P.sc.latest_sharded_checkpoint(ckpt, quarantine=False)
        clean = P.sc.latest_sharded_checkpoint(
            ckpt, quarantine=False, require_clean_health=True)
        got[name] = (newest["step"], newest["health"]["clean"],
                     newest["health"]["skipped_steps_total"],
                     clean["step"], clean["health"]["clean"])
    assert got["port"] == got["jax"] == (2, False, 1, 0, True)


def test_preemption_replays_bitwise(tmp_path):
    """A SIGTERM at step 3 (``raise_on_sigterm`` -> ``Preemption``): the
    loop restores generation 2 and replays, bitwise the uninterrupted
    run and at 1e-5 of the JAX package's, whose step function raises
    ``Preemption`` itself."""
    from paddle_tpu_torch import interop

    P, J = _port(), _jax()
    feeds = guard_feeds(6)
    finals = {}
    for name, Q in (("jax", J), ("port", P), ("port_plain", P)):
        prog, startup, loss = build_guarded(Q.fl)
        scope = Q.fl.Scope()
        if Q is J:
            Q.exe().run(startup, scope=scope)
            arrays = {v.name: np.asarray(scope.find_var(v.name))
                      for v in prog.list_vars() if v.persistable}
        else:
            interop.load_reference_state(arrays, scope, Q.fl.CPUPlace(),
                                         prog)
        exe = Q.exe()
        hit = []

        def step_fn(step):
            if step == 3 and not hit and name != "port_plain":
                hit.append(step)
                if Q is J:
                    raise Q.recovery.Preemption("preempted")
                os.kill(os.getpid(), signal.SIGTERM)
            exe.run(prog, feed=feeds[step], fetch_list=[loss.name],
                    scope=scope)

        ckpt = str(tmp_path / name)
        if Q is P and name == "port":
            with Q.recovery.raise_on_sigterm():
                loop = Q.recovery.RecoveryLoop(ckpt, scope, prog)
                assert loop.run(step_fn, 6) == 1
        else:
            loop = Q.recovery.train_with_recovery(step_fn, ckpt, scope,
                                                  prog, 6)
            assert loop.restarts == (0 if name == "port_plain" else 1)
        finals[name] = {v.name: _np(scope.find_var(v.name)).copy()
                        for v in prog.list_vars() if v.persistable}
    for n, v in finals["port_plain"].items():
        assert v.tobytes() == finals["port"][n].tobytes(), n
        np.testing.assert_allclose(v, finals["jax"][n], rtol=TOL,
                                   atol=TOL, err_msg=n)


# ---- the elastic world change and the spill path: gloo worlds ----

def _jax_fixed(init, n_dev=4, steps=MAX_STEPS):
    """The JAX package's fixed-world trajectory: MAX_STEPS on a
    never-changing ``n_dev``-device mesh, from ``init``."""
    import jax.numpy as jnp

    import paddle_tpu as jf
    from paddle_tpu.parallel import make_mesh
    from paddle_tpu.parallel.parallel_executor import ParallelExecutor

    prog, startup, loss = build_mlp(jf)
    with jf.scope_guard(jf.Scope()):
        scope = jf.global_scope()
        for n, v in init.items():
            scope.set_var(n, jnp.asarray(v))
        pe = ParallelExecutor(loss_name=loss.name, main_program=prog,
                              mesh=make_mesh((n_dev,), ("dp",)))
        for s in range(0, steps, K):
            f = feed_chunk(s)
            pe.run_chunk(prog, {k: jnp.asarray(v) for k, v in f.items()},
                         fetch_list=[loss.name], step0=s)
        return {n: np.asarray(scope.find_var(n))
                for n in ("fc_0.w_0", "fc_1.w_0", "fc_0.b_0")}


def _jax_spread(init, ref):
    """{name: |JAX run on n devices - ``ref``|, the largest over n = 1, 2,
    3}: how far the JAX package's own trajectory moves with the world
    size."""
    out = {}
    for n in (1, 2, 3):
        for k, v in _jax_fixed(init, n_dev=n).items():
            out[k] = np.maximum(out.get(k, 0.0), np.abs(v - ref[k]))
    return out


def _jax_init():
    import paddle_tpu as jf

    prog, startup, loss = build_mlp(jf)
    with jf.scope_guard(jf.Scope()):
        jf.Executor().run(startup)
        s = jf.global_scope()
        return {v.name: np.asarray(s.find_var(v.name))
                for v in prog.list_vars() if v.persistable}


@pytest.fixture(scope="module")
def elastic_world(tmp_path_factory):
    """One gloo world of 4 running every elastic scenario (this file as
    a script), and the JAX fixed-world trajectory from the same
    weights."""
    d = str(tmp_path_factory.mktemp("elastic"))
    init = _jax_init()
    np.savez(os.path.join(d, "init.npz"), **init)
    with open(os.path.join(d, "job.json"), "w") as f:
        json.dump({"job": "elastic"}, f)
    started = harness.start(__file__, 4, d, SPAWN_TIMEOUT)
    ref = _jax_fixed(init)
    spread = _jax_spread(init, ref)
    harness.finish(started, d)
    yield d, (ref, spread)


def _result(d, name):
    with open(os.path.join(d, name + ".json")) as f:
        out = json.load(f)
    with np.load(os.path.join(d, name + ".npz")) as z:
        out["params"] = {k: z[k] for k in z.files}
    return out


def _close(params, ref_spread, fixed=None):
    """The JAX fixed-world weights at the elastic test's bounds, plus
    three times the JAX package's own world-size spread where that
    spread exceeds them; the port's fixed-world run (``fixed``) at the
    bounds alone."""
    ref, spread = ref_spread
    for n, v in ref.items():
        bound = 1e-6 + 1e-4 * np.abs(v)
        allow = np.where(spread[n] > bound, bound + 3 * spread[n], bound)
        err = np.abs(params[n] - v)
        assert (err <= allow).all(), (n, float(err.max()),
                                      int((err > bound).sum()))
        assert int((spread[n] > bound).sum()) <= 2, n
        if fixed is not None:
            np.testing.assert_allclose(params[n], fixed[n], rtol=1e-4,
                                       atol=1e-6, err_msg=n)


class TestLiveReshardChaos:
    def test_remove_then_add_worker_mid_run(self, elastic_world):
        """Injected lease expiry removes w1 (4 -> 2 ranks at the next
        boundary), a re-register adds it back (2 -> 4): two in-memory
        reshards, no restore, telemetry matching the two events, the
        plan rebuilt once an epoch with the epoch named in the miss
        signature, the JAX fixed-world weights at 1e-4."""
        d, ref = elastic_world
        r = _result(d, "remove_then_add")
        assert r["restarts"] == 0 and r["reshards"] == 2
        assert r["path"] == "memory" and r["devices"] == 4
        assert r["plans_built"] == 3
        assert r["epoch_diffs"] > 0
        assert r["telemetry"] == {
            "paddle_tpu_elastic_reshards_total": 2,
            "paddle_tpu_elastic_downtime_seconds:count": 2,
            "paddle_tpu_elastic_world_devices_count": 4}
        assert r["moved"] > 0 and r["faults"] > 0
        assert r["outside_steps"] == [6, 8]   # ranks 2, 3 ran none
        _close(r["params"], ref, _result(d, "fixed")["params"])

    def test_worker_swap_same_count_is_bitwise(self, elastic_world):
        d, ref = elastic_world
        r, fixed = _result(d, "worker_swap"), _result(d, "fixed")
        assert r["reshards"] == 1 and r["path"] == "memory"
        for n, v in fixed["params"].items():
            assert v.tobytes() == r["params"][n].tobytes(), n
        _close(fixed["params"], ref)

    def test_midchunk_reshard_restores_at_boundary(self, elastic_world):
        d, ref = elastic_world
        r = _result(d, "midchunk")
        assert r["reshards"] == 1 and r["path"] == "restore"
        assert r["step"] == 6 and r["devices"] == 2
        assert r["resume_step"] == 6
        _close(r["params"], ref, _result(d, "fixed")["params"])

    def test_inmemory_failure_spills_through_checkpoint_dir(
            self, elastic_world):
        """A crash rule on ``elastic.reshard`` (every rank's) kills the
        in-memory hand-off at 4 -> 2: the ranks agree to spill the same
        cut through the checkpoint directory; the way back to 4 ranks
        is in memory."""
        d, ref = elastic_world
        r = _result(d, "spill")
        assert r["reshards"] == 2 and r["path"] == "spill"
        assert r["moved"] > 0 and r["spilled"] and r["warned"]
        assert r["uncompressed"]
        _close(r["params"], ref, _result(d, "fixed")["params"])

    @pytest.mark.parametrize("name,match", [
        ("no_generation", "no checkpoint generation"),
        ("plain_rejects", "Reshard"),
        ("flapping", "max_reshards"),
        ("settle_flap", "max_reshards")])
    def test_the_loop_raises(self, elastic_world, name, match):
        """The mid-chunk reshard without a generation, a plain loop
        given a Reshard, a flapping membership and a flap that never
        settles raise on every rank, as in the JAX package."""
        d, _ref = elastic_world
        with open(os.path.join(d, name + ".json")) as f:
            r = json.load(f)
        assert match in r["raised"], r


class TestReshardStateUnit:
    def test_in_memory_reshard_matches_disk_round_trip(self, elastic_world):
        """reshard_state onto the 2-mesh places what a disk restore onto
        it places: the ranks of the mesh hold every value bitwise, the
        two it leaves out hold none."""
        d, _ref = elastic_world
        with open(os.path.join(d, "unit.json")) as f:
            r = json.load(f)
        assert r["moved"] > 0 and r["equal"] and r["disk_equal"]
        assert r["outside_empty"] == [False, False, True, True]

    def test_coverage_check_rejects_missing_pieces(self, elastic_world):
        d, _ref = elastic_world
        with open(os.path.join(d, "unit.json")) as f:
            assert "missing data" in json.load(f)["coverage"]


def test_spill_path_new_world_restores_and_finishes(tmp_path):
    """A world-3 job trains steps 0..5 under RecoveryLoop and ends; a
    new world-2 job restores the sharded generation onto its mesh
    (ZeRO-1 rows written by 3 ranks, read by 2) and trains 6..11: the
    JAX fixed-world weights at 1e-4."""
    d = str(tmp_path)
    init = _jax_init()
    np.savez(os.path.join(d, "init.npz"), **init)
    for world, steps in ((3, (0, 6)), (2, (6, MAX_STEPS))):
        with open(os.path.join(d, "job.json"), "w") as f:
            json.dump({"job": "spill", "steps": steps}, f)
        harness.finish(harness.start(__file__, world, d, SPAWN_TIMEOUT), d)
    r = _result(d, "spill_job")
    assert r["resumed_at"] == 6 and r["world"] == 2
    ref = _jax_fixed(init)
    _close(r["params"], (ref, _jax_spread(init, ref)))


def test_a_lost_rank_ends_the_job_without_a_hang(tmp_path):
    """Rank 1 of a world-2 job dies after its step-1 save: rank 0's
    loop does not hang at its next collective (the step's gradient
    exchange) but raises the backend's error well inside the process
    group's timeout; a new job then restores the last generation at
    another world (``test_spill_path_new_world_restores_and_finishes``)."""
    d = str(tmp_path)
    np.savez(os.path.join(d, "init.npz"), **_jax_init())
    with open(os.path.join(d, "job.json"), "w") as f:
        json.dump({"job": "lost"}, f)
    harness.finish(harness.start(__file__, 2, d, SPAWN_TIMEOUT), d)
    with open(os.path.join(d, "lost.json")) as f:
        r = json.load(f)
    assert r["raised"] and r["seconds"] < SPAWN_TIMEOUT / 3, r
    assert r["last_generation"] == 1, r


# ---- the port's side: one process a rank ----

def _save(d, name, out, params=None):
    with open(os.path.join(d, name + ".json"), "w") as f:
        json.dump(out, f)
    if params is not None:
        np.savez(os.path.join(d, name + ".npz"), **params)


class _StubWatcher:
    def __init__(self, epoch=0, members=("w0", "w1")):
        self.epoch = epoch
        self.members = tuple(members)

    def snapshot(self):
        return self.epoch, self.members


def _session(d, world=4):
    """A fresh run on a ``world``-rank mesh on the JAX startup's weights:
    (program, loss, scope, executor)."""
    import paddle_tpu_torch as tf
    from paddle_tpu_torch import interop
    from paddle_tpu_torch.parallel import ParallelExecutor, make_mesh

    prog, startup, loss = build_mlp(tf)
    scope = tf.Scope()
    with np.load(os.path.join(d, "init.npz")) as z:
        interop.load_reference_state({k: z[k] for k in z.files}, scope,
                                     tf.CPUPlace(), [prog, startup])
    pe = ParallelExecutor(use_cuda=False, loss_name=loss.name,
                          main_program=prog,
                          mesh=make_mesh((world,), ("dp",)))
    return prog, loss, scope, pe


def _rebuild_fn(pe, prog, per_worker=2, cap=4):
    from paddle_tpu_torch.parallel import make_mesh

    def rebuild(members, epoch):
        n = max(1, min(cap, per_worker * len(members)))
        pe.set_mesh(make_mesh((n,), ("dp",)), epoch=epoch)
        return pe.state_shardings(prog)
    return rebuild


def _in_mesh(pe):
    import torch.distributed as dist

    return dist.get_rank() in pe.mesh.ranks


def _runner(pe, prog, loss, scope, ran=None):
    def run(step):
        if not _in_mesh(pe):
            return   # a rank the mesh leaves out runs no step
        if ran is not None:
            ran.append(step)
        pe.run_chunk(prog, feed_chunk(step), fetch_list=[loss.name],
                     step0=step, scope=scope)
    return run


def _params(scope):
    return {n: np.asarray(scope.find_var(n))
            for n in ("fc_0.w_0", "fc_1.w_0", "fc_0.b_0")}


def _chunk_compressors(paths):
    """The compressor field of every chunk header of record files
    ``paths`` (magic, records, compressor, bytes, crc: five u32)."""
    import struct

    out = set()
    for p in paths:
        with open(p, "rb") as f:
            while True:
                hdr = f.read(20)
                if len(hdr) < 20:
                    break
                _magic, _n, comp, size, _crc = struct.unpack("<5I", hdr)
                out.add(comp)
                f.seek(size, 1)
    return out


def _loop(d, name, scope, prog, pe, watcher, **kw):
    from paddle_tpu_torch.distributed.recovery import ElasticRecoveryLoop
    from paddle_tpu_torch.core.place import CPUPlace

    return ElasticRecoveryLoop(
        os.path.join(d, "ckpt_" + name), scope, prog, watcher=watcher,
        rebuild=_rebuild_fn(pe, prog),
        target_shardings=pe.state_shardings(prog), place=CPUPlace(), **kw)


def _elastic(rank, d):
    import time

    import torch.distributed as dist

    from paddle_tpu_torch import fault, telemetry
    from paddle_tpu_torch.core.place import CPUPlace
    from paddle_tpu_torch.distributed.membership import (
        EpochWatcher, MembershipClient, MembershipServer)
    from paddle_tpu_torch.distributed.recovery import (
        RecoveryLoop, Reshard)
    from paddle_tpu_torch.distributed.sharded_checkpoint import (
        ShardedCheckpointManager, load_sharded_checkpoint, reshard_state,
        save_sharded_checkpoint, snapshot_state)
    from paddle_tpu_torch.parallel import make_mesh, mesh as mesh_lib

    # the port's own fixed world
    prog, loss, scope, pe = _session(d)
    for s in range(0, MAX_STEPS, K):
        pe.run_chunk(prog, feed_chunk(s), fetch_list=[loss.name], step0=s,
                     scope=scope)
    p = _params(scope)
    if rank == 0:
        _save(d, "fixed", {}, p)

    # remove then add, through the membership service rank 0 hosts
    addr_file = os.path.join(d, "membership.json")
    srv = cl = None
    if rank == 0:
        srv = MembershipServer(default_ttl=0.5, sweep_interval=0.05)
        srv.start()
        cl = MembershipClient(srv.address, heartbeat_interval=0.1)
        cl.register("trainer", "w0", "w0:0", ttl=0.5)
        cl.register("trainer", "w1", "w1:0", ttl=0.5)
        with open(addr_file + ".tmp", "w") as f:
            json.dump(list(srv.address), f)
        os.replace(addr_file + ".tmp", addr_file)
    while not os.path.exists(addr_file):
        time.sleep(0.02)
    with open(addr_file) as f:
        addr = tuple(json.load(f))
    watcher = EpochWatcher(addr, kind="trainer", wait=2.0)
    telemetry.reset()
    telemetry.enable()
    prog, loss, scope, pe = _session(d)
    loop = _loop(d, "remove_then_add", scope, prog, pe, watcher)
    phase = {"lost": False, "back": False}
    ran = []
    run = _runner(pe, prog, loss, scope, ran)

    def await_bump():
        deadline = time.time() + 20.0
        while watcher.snapshot()[0] == loop.cluster_epoch:
            assert time.time() < deadline, "no epoch bump"
            time.sleep(0.02)

    def step_fn(step):
        if step == 4 and not phase["lost"]:
            if rank == 0:
                fault.inject("membership.lease.trainer.w1", drop=1.0)
            await_bump()
            phase["lost"] = True
        if step == 8 and not phase["back"]:
            if rank == 0:
                fault.clear()
                cl.register("trainer", "w1", "w1:0", ttl=0.5)
            await_bump()
            phase["back"] = True
        run(step)

    restarts = loop.run(step_fn, MAX_STEPS, steps_per_call=K)
    s = telemetry.summary()
    fp = prog.fingerprint
    out = {"restarts": restarts, "reshards": loop.reshards,
           "path": loop.last_reshard["path"],
           "devices": loop.last_reshard["devices"],
           "plans_built": telemetry.recompile_detector.compile_count(fp),
           "epoch_diffs": len([e for e in telemetry.recompile_detector.events
                               if any(x.startswith("epoch:")
                                      for x in e["diff"])]),
           "telemetry": {k: s.get(k) for k in (
               "paddle_tpu_elastic_reshards_total",
               "paddle_tpu_elastic_downtime_seconds:count",
               "paddle_tpu_elastic_world_devices_count")},
           "moved": s.get("paddle_tpu_elastic_state_moved_bytes_total", 0),
           "faults": s.get("paddle_tpu_fault_injected_total", 0)}
    outside = [None] * 4
    dist.all_gather_object(outside, [x for x in range(0, MAX_STEPS, K)
                                     if x not in ran])
    out["outside_steps"] = outside[2]
    assert outside[0] == [] and outside[2] == outside[3], outside
    p = _params(scope)
    fault.clear()
    telemetry.disable()
    watcher.stop()
    dist.barrier()
    if rank == 0:
        cl.close()
        srv.shutdown()
        _save(d, "remove_then_add", out, p)

    # worker swap: the same count, a new epoch
    w = _StubWatcher()
    prog, loss, scope, pe = _session(d)
    loop = _loop(d, "worker_swap", scope, prog, pe, w)
    run = _runner(pe, prog, loss, scope)

    def swap(step):
        if step == 6:
            w.members, w.epoch = ("w0", "w2"), 1
        run(step)

    loop.run(swap, MAX_STEPS, steps_per_call=K)
    p = _params(scope)
    if rank == 0:
        _save(d, "worker_swap", {"reshards": loop.reshards,
                                 "path": loop.last_reshard["path"]}, p)

    # a Reshard raised mid-chunk: restore at the boundary on 2 ranks
    telemetry.reset()
    telemetry.enable()
    prog, loss, scope, pe = _session(d)
    loop = _loop(d, "midchunk", scope, prog, pe, None)
    run = _runner(pe, prog, loss, scope)
    raised = []

    def mid(step):
        if step == 6 and not raised:
            raised.append(step)
            raise Reshard("collective lost a peer", epoch=1,
                          members=("w0",))
        run(step)

    loop.run(mid, MAX_STEPS, steps_per_call=K)
    # back to 4 ranks for the read (ranks 2, 3 hold nothing on the
    # 2-mesh): the cut first, while its pieces' groups exist
    cut = snapshot_state(scope, prog)
    pe.set_mesh(make_mesh((4,), ("dp",)), epoch=2)
    reshard_state(scope, prog, pe.state_shardings(prog), state=cut,
                  place=CPUPlace())
    p = _params(scope)
    resume = telemetry.summary()["paddle_tpu_recovery_resume_step_count"]
    telemetry.disable()
    if rank == 0:
        _save(d, "midchunk", {"reshards": loop.reshards,
                              "path": loop.last_reshard["path"],
                              "step": loop.last_reshard["step"],
                              "devices": loop.last_reshard["devices"],
                              "resume_step": resume}, p)

    # the in-memory hand-off fails: spill through the directory, whose
    # generations take the manager's compressor
    w = _StubWatcher()
    prog, loss, scope, pe = _session(d)
    loop = _loop(d, "spill", scope, prog, pe, w,
                 manager=ShardedCheckpointManager(
                     os.path.join(d, "ckpt_spill"), process_index=rank,
                     num_processes=dist.get_world_size(), place=CPUPlace(),
                     compressor="none"))
    run = _runner(pe, prog, loss, scope)

    def spill(step):
        if step == 4:
            fault.inject("elastic.reshard", crash_on_nth=1, times=1)
            w.members, w.epoch = ("w0",), 1
        if step == 8:
            w.members, w.epoch = ("w0", "w1"), 2
        run(step)

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        loop.run(spill, MAX_STEPS, steps_per_call=K)
    fault.clear()
    p = _params(scope)
    if rank == 0:
        _save(d, "spill", {
            "reshards": loop.reshards, "path": "spill"
            if any("in-memory reshard" in str(c.message) for c in caught)
            else loop.last_reshard["path"],
            "moved": loop.last_reshard["bytes_moved"],
            "spilled": bool(glob.glob(os.path.join(
                d, "ckpt_spill", "reshard-spill", "*.manifest.json"))),
            "uncompressed": _chunk_compressors(glob.glob(os.path.join(
                d, "ckpt_spill", "reshard-spill", "*.rio"))) == {0},
            "warned": any("in-memory reshard" in str(c.message)
                          for c in caught)}, p)
    # the loops that must raise
    for name in ("no_generation", "plain_rejects", "flapping",
                 "settle_flap"):
        prog, loss, scope, pe = _session(d)
        run = _runner(pe, prog, loss, scope)
        if name == "no_generation":
            loop = _loop(d, name, scope, prog, pe, None)

            def fn(step):
                raise Reshard("peer died in chunk 0", epoch=1,
                              members=("w0",))
        elif name == "plain_rejects":
            loop = RecoveryLoop(os.path.join(d, "ckpt_" + name), scope,
                                prog)

            def fn(step):
                raise Reshard("peer gone", epoch=1)
        elif name == "flapping":
            w = _StubWatcher()
            loop = _loop(d, name, scope, prog, pe, w, max_reshards=3)

            def fn(step, w=w):
                w.epoch += 1
                run(step)
        else:
            class _Flapper(_StubWatcher):
                def snapshot(self):
                    self.epoch += 1
                    return self.epoch, self.members

            loop = _loop(d, name, scope, prog, pe, _Flapper(),
                         settle_seconds=0.01, max_reshards=2)
            fn = run
        try:
            loop.run(fn, MAX_STEPS if name != "plain_rejects" else 2,
                     steps_per_call=K)
            msg = "nothing raised"
        except (RuntimeError, Reshard) as e:
            msg = "%s: %s" % (type(e).__name__, e)
        if rank == 0:
            _save(d, name, {"raised": msg})
        dist.barrier()

    # reshard_state alone, and against the disk round trip
    prog, loss, scope, pe = _session(d)
    pe.run_chunk(prog, feed_chunk(0), fetch_list=[loss.name], step0=0,
                 scope=scope)
    names = sorted(v.name for v in prog.list_vars() if v.persistable)
    before = {n: np.asarray(scope.find_var(n)) for n in names}
    state = snapshot_state(scope, prog)
    save_sharded_checkpoint(os.path.join(d, "unit_disk"), 0, state=state,
                            process_index=rank, num_processes=4)
    pe.set_mesh(make_mesh((2,), ("dp",)), epoch=1)
    targets = pe.state_shardings(prog)
    moved = reshard_state(scope, prog, targets, state=state,
                          place=CPUPlace())
    mine = {n: scope.find_var(n) for n in names}
    empty = all(v is None for v in mine.values())
    equal = empty or all(
        np.array_equal(_np(mine[n]), before[n]) for n in names)
    dist.barrier()
    from paddle_tpu_torch import Scope
    disk = Scope()
    load_sharded_checkpoint(os.path.join(d, "unit_disk"), disk, targets,
                            place=CPUPlace())
    disk_equal = all(
        (disk.find_var(n) is None) == (mine[n] is None)
        and (mine[n] is None
             or _np(disk.find_var(n)).tobytes() == _np(mine[n]).tobytes())
        for n in names)
    flags = [None] * 4
    dist.all_gather_object(flags, (empty, equal, disk_equal))
    # the coverage check: every rank hands in half the rows of the only
    # piece (rank 0 holds it; the exchange is a collective)
    cut = snapshot_state(scope, prog, names=["fc_0.w_0"])
    for name, (shape, dtype, pieces) in cut.items():
        cut[name] = (shape, dtype, [
            (((0, a.shape[0] // 2),) + tuple(idx[1:]),
             a[: a.shape[0] // 2]) for idx, a in pieces])
    coverage = ""
    try:
        reshard_state(scope, prog, {"fc_0.w_0": mesh_lib.replicated(
            pe.mesh)}, names=["fc_0.w_0"], state=cut, place=CPUPlace())
    except IOError as e:
        coverage = str(e)
    if rank == 0:
        _save(d, "unit", {"moved": moved,
                          "equal": all(f[1] for f in flags),
                          "disk_equal": all(f[2] for f in flags),
                          "outside_empty": [f[0] for f in flags],
                          "coverage": coverage})


def _spill_job(rank, world, d, steps):
    """One job of the spill path: restore what the directory holds onto
    this world's mesh, train ``steps``, save, end."""
    from paddle_tpu_torch.distributed.recovery import RecoveryLoop
    from paddle_tpu_torch.core.place import CPUPlace

    prog, loss, scope, pe = _session(d, world)
    loop = RecoveryLoop(os.path.join(d, "ckpt"), scope, prog,
                        target_shardings=pe.state_shardings(prog),
                        place=CPUPlace())
    first = []

    def step_fn(step):
        first.append(step)
        pe.run_chunk(prog, feed_chunk(step), fetch_list=[loss.name],
                     step0=step, scope=scope)

    loop.run(step_fn, steps[1], start_step=0, steps_per_call=K)
    p = _params(scope)
    if rank == 0 and world == 2:
        _save(d, "spill_job", {"resumed_at": first[0], "world": world}, p)


def _lost_job(rank, d):
    """Rank 1 dies after committing step 1; rank 0 reports what its loop
    raised and how long it took."""
    import time

    from paddle_tpu_torch.core.place import CPUPlace
    from paddle_tpu_torch.distributed.recovery import RecoveryLoop
    from paddle_tpu_torch.distributed.sharded_checkpoint import \
        latest_sharded_checkpoint

    prog, loss, scope, pe = _session(d, 2)
    ckpt = os.path.join(d, "ckpt")
    loop = RecoveryLoop(ckpt, scope, prog,
                        target_shardings=pe.state_shardings(prog),
                        place=CPUPlace())
    t0 = {}

    def step_fn(step):
        if step == 2:
            if rank == 1:
                os._exit(0)     # the process is lost
            t0["t"] = time.monotonic()
        pe.run_chunk(prog, feed_chunk(step), fetch_list=[loss.name],
                     step0=step, scope=scope)

    try:
        loop.run(step_fn, MAX_STEPS, steps_per_call=K)
        raised = ""
    except Exception as e:  # the backend's error, whichever it is
        raised = "%s: %s" % (type(e).__name__, e)
    best = latest_sharded_checkpoint(ckpt, quarantine=False)
    _save(d, "lost", {"raised": raised[:400],
                      "seconds": time.monotonic() - t0["t"],
                      "last_generation": best and best["step"]})
    os._exit(0)     # the world is broken: no barrier to leave by


def _worker(rank, world, d):
    harness.join(rank, world, d, SPAWN_TIMEOUT)
    with open(os.path.join(d, "job.json")) as f:
        job = json.load(f)
    if job["job"] == "elastic":
        _elastic(rank, d)
    elif job["job"] == "lost":
        _lost_job(rank, d)
    else:
        _spill_job(rank, world, d, job["steps"])
    harness.leave()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
