"""The training-health guard (``paddle_tpu_torch/guard.py``) against the
JAX package's (``paddle_tpu/guard.py``), on the CPU.

The port's versions of ``tests/test_guard.py``'s ``TestDivergenceDetector``,
``TestStepGuard``, ``TestClipGuardCompose``,
``TestHealthPipeline::test_scale_reseeded_when_scaling_config_changes``,
``TestGuardCompileInvariants`` and ``TestHealthTracker``: each runs the
same scenario in both packages, on the same model (the JAX startup's
weights carried over by ``interop.load_reference_state``), the same
feeds and the same ``guard.nonfinite`` rule, and holds the port to the
contract the JAX test states AND to the JAX package's numbers: the same
skipped steps, non-finite flags, loss scales and counters exactly; the
health rows' loss and gradient norm, the losses and the state at 1e-5
(float32 in another summation order); state bitwise unchanged across a
skipped step. The AMP case trains the tiny transformer under dynamic
loss scaling in both packages and holds them at PERF.md section 2's
AMP bounds.

``TestHealthManifests``, ``TestDivergenceRollbackChaos`` and
``TestParallelGuard`` wait for the port's checkpoints, recovery loop
and ParallelExecutor; the checkify test is
``tests/test_torch_debug.py::test_checkify_throw_does_not_orphan_queued_rows``."""

import os
import types

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import fault as jfault
from paddle_tpu import guard as jguard
from paddle_tpu import layers as jlayers
from paddle_tpu import telemetry as jtel
from paddle_tpu import unique_name as jnames
from paddle_tpu.data_feeder import stack_feeds as jstack
from paddle_tpu_torch import fault as tfault
from paddle_tpu_torch import guard as tguard
from paddle_tpu_torch import interop
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import telemetry as ttel
from paddle_tpu_torch import unique_name as tnames
from paddle_tpu_torch.data_feeder import stack_feeds as tstack

# Under pytest-xdist each worker takes its share of the cores for
# torch's intra-op threads: six workers at torch's default thread count
# oversubscribe the cores, and a test of seconds then takes minutes.
_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, os.cpu_count() // int(_WORKERS)))

CPU = tfluid.CPUPlace()
TOL = 1e-5

J = types.SimpleNamespace(name="jax", fluid=jfluid, layers=jlayers,
                          guard=jguard, fault=jfault, tel=jtel, names=jnames,
                          stack=jstack, exe=lambda: jfluid.Executor())
T = types.SimpleNamespace(name="port", fluid=tfluid, layers=tlayers,
                          guard=tguard, fault=tfault, tel=ttel, names=tnames,
                          stack=tstack, exe=lambda: tfluid.Executor(CPU))


@pytest.fixture(autouse=True)
def _clean_fault_and_telemetry():
    for P in (J, T):
        P.fault.clear()
        P.tel.reset()
        P.tel.disable()
    yield
    for P in (J, T):
        P.fault.clear()
        P.tel.reset()
        P.tel.disable()


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _build(P, clip=None, loss_scale_factor=None, reg=None, shared=False):
    """tests/test_guard.py's tiny fc net (optionally a global-norm clip,
    a loss amplifier, a regularizer, or one weight shared by two fc
    layers), under a fresh name guard."""
    fluid, layers = P.fluid, P.layers
    with P.names.guard():
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            x = layers.data("x", [8])
            label = layers.data("label", [1], dtype="int64")
            if shared:
                attr = fluid.ParamAttr(name="shared_w")
                h = layers.fc(x, 8, act="relu", param_attr=attr)
                h = layers.fc(h, 8, act="relu", param_attr=attr)
            else:
                h = layers.fc(x, 8, act="relu")
            predict = layers.fc(h, 4, act="softmax")
            loss = layers.mean(layers.cross_entropy(predict, label))
            if loss_scale_factor:
                loss = layers.scale(loss, scale=loss_scale_factor)
            if clip is not None:
                fluid.clip.set_gradient_clip(clip(fluid))
            try:
                fluid.optimizer.SGD(0.1, regularization=reg(P)
                                    if reg else None).minimize(loss)
            finally:
                fluid.clip.set_gradient_clip(None)
    return prog, startup, loss


def _feeds(n, batch=4, seed=0):
    rng = np.random.RandomState(seed)
    return [{"x": rng.rand(batch, 8).astype(np.float32),
             "label": rng.randint(0, 4, (batch, 1)).astype(np.int64)}
            for _ in range(n)]


def _state(P, scope):
    return {n: _np(v).copy() for n, v in scope.vars.items()
            if v is not None and not n.startswith("guard@")}


def _gvar(scope, name):
    return _np(scope.find_var(name)).item()


def _pair(build_kw=None, guard_kw=None):
    """The model in both packages on the JAX startup's weights: {P:
    (program, loss, scope)}; the guard armed with ``guard_kw``."""
    out, arrays = {}, None
    for P in (J, T):
        prog, startup, loss = _build(P, **(build_kw or {}))
        if guard_kw is not None:
            P.guard.enable(prog, loss, **guard_kw)
        scope = P.fluid.Scope()
        if P is J:
            P.exe().run(startup, scope=scope)
            arrays = {v.name: np.asarray(scope.find_var(v.name))
                      for v in prog.list_vars() if v.persistable}
        else:
            interop.load_reference_state(arrays, scope, CPU, prog)
        out[P.name] = (prog, loss, scope)
    return out


def _same_health(jh, th):
    """Health rows equal: flags and scale exactly, loss and gnorm at
    TOL (NaN where the JAX package has NaN)."""
    jh, th = np.asarray(jh, np.float64), np.asarray(th, np.float64)
    assert jh.shape == th.shape
    np.testing.assert_array_equal(th[:, 2:], jh[:, 2:])
    np.testing.assert_allclose(th[:, :2], jh[:, :2], rtol=TOL, atol=TOL)


def _same_state(js, ts):
    assert set(js) == set(ts)
    for n in js:
        np.testing.assert_allclose(ts[n], js[n], rtol=TOL, atol=TOL,
                                   err_msg=n)


class TestDivergenceDetector:
    """The host-side detector is the JAX package's: the same sequence of
    observations trips both at the same step with the same reason."""

    @staticmethod
    def _both(kw, rows):
        res = []
        for P in (J, T):
            det = P.guard.DivergenceDetector(**kw)
            got = None
            for i, (loss, gnorm, skipped) in enumerate(rows):
                try:
                    det.observe(i, loss, gnorm, skipped=skipped)
                except P.guard.Divergence as e:
                    got = (e.reason, e.step, e.onset_step)
                    break
            res.append((got, det._skips, dict(det._strikes),
                        dict(det._ema)))
        assert res[0] == res[1]
        return res[1]

    def test_consecutive_skips_trip(self):
        got = self._both(dict(max_consecutive_skips=3),
                         [(1.0, 1.0, True), (1.0, 1.0, True),
                          (float("nan"), float("nan"), True)])
        assert got[0][0] == "nonfinite_steps"

    def test_clean_step_resets_skip_streak(self):
        got = self._both(dict(max_consecutive_skips=2),
                         [(1.0, 1.0, True), (1.0, 1.0, False),
                          (1.0, 1.0, True), (1.0, 1.0, True)])
        assert got[0] == ("nonfinite_steps", 3, 2)

    def test_loss_spike_needs_patience(self):
        got = self._both(dict(spike_factor=10.0, patience=2, warmup=3),
                         [(1.0, 1.0, False)] * 6
                         + [(100.0, 1.0, False)] * 2)
        assert got[0][:2] == ("loss_spike", 7)

    def test_spike_not_folded_into_ema(self):
        got = self._both(dict(spike_factor=10.0, patience=100, warmup=3),
                         [(1.0, 1.0, False)] * 6 + [(1000.0, 1.0, False)])
        assert got[0] is None and got[3]["loss"] == 1.0

    def test_reset_clears_history(self):
        for P in (J, T):
            det = P.guard.DivergenceDetector(max_consecutive_skips=2)
            det.observe(0, 1.0, 1.0, skipped=True)
            det.reset()
            det.observe(1, 1.0, 1.0, skipped=True)
            assert det._skips == 1


class TestStepGuard:
    def test_nonfinite_step_skipped_scale_halves_then_regrows(self):
        """The poisoned step applies NO update (bitwise), bumps the skip
        counter and halves the scale; three clean steps regrow it; the
        rule is credited once and the metrics count it; the health rows,
        counters and state equal the JAX package's."""
        pair = _pair(guard_kw=dict(dynamic_loss_scale=True,
                                   init_loss_scale=1024.0,
                                   growth_interval=3, divergence=False))
        feeds = _feeds(6)
        res = {}
        for P in (J, T):
            prog, loss, scope = pair[P.name]
            P.tel.enable()
            exe = P.exe()
            rule = P.fault.inject("guard.nonfinite", crash_on_nth=2,
                                  times=1)
            rows = []
            exe.run(prog, feed=feeds[0], fetch_list=[loss.name], scope=scope)
            rows.append(exe.poll_health())
            assert rows[0].shape == (1, 6) and rows[0][0, 2] == 0.0
            before = _state(P, scope)
            exe.run(prog, feed=feeds[1], fetch_list=[loss.name], scope=scope)
            rows.append(exe.poll_health())
            assert rows[1][0, 2] == 1.0
            after = _state(P, scope)
            assert set(before) == set(after)
            for n in before:
                assert np.array_equal(before[n], after[n]), n
            assert _gvar(scope, "guard@skipped_steps") == 1
            assert _gvar(scope, "guard@loss_scale") == 512.0
            for i in range(2, 5):
                exe.run(prog, feed=feeds[i], fetch_list=[loss.name],
                        scope=scope)
                rows.append(exe.poll_health())
            assert _gvar(scope, "guard@loss_scale") == 1024.0
            assert rule.fires == 1
            roll = P.tel.summary()
            assert roll["paddle_tpu_guard_skipped_steps_total"] == 1
            assert roll["paddle_tpu_fault_injected_total"] == 1
            assert roll["paddle_tpu_guard_nonfinite_total"] == 1
            exe.run(prog, feed=feeds[5], fetch_list=[loss.name], scope=scope)
            assert not np.array_equal(after["fc_0.w_0"],
                                      _np(scope.find_var("fc_0.w_0")))
            exe.poll_health()
            res[P.name] = (np.concatenate(rows), _state(P, scope),
                           _gvar(scope, "guard@good_steps"))
        _same_health(res["jax"][0], res["port"][0])
        _same_state(res["jax"][1], res["port"][1])
        assert res["jax"][2] == res["port"][2]

    def test_guard_on_matches_guard_off_bitwise(self):
        """No fault and no scaling: the guarded trajectory is bitwise
        the unguarded one (the reductions only observe, the select keeps
        the candidate)."""
        feeds = _feeds(4)
        runs = {}
        for armed in (False, True):
            pair = _pair(guard_kw={} if armed else None)
            for P in (J, T):
                prog, loss, scope = pair[P.name]
                exe = P.exe()
                out = exe.run_chunk(prog, feed_chunk=P.stack(feeds),
                                    fetch_list=[loss.name], scope=scope,
                                    step0=1)[0]
                runs[P.name, armed] = (np.asarray(out), _state(P, scope))
        for P in (J, T):
            (l0, s0), (l1, s1) = runs[P.name, False], runs[P.name, True]
            assert np.array_equal(l0, l1)
            assert set(s0) == set(s1)
            for n in s0:
                assert np.array_equal(s0[n], s1[n]), (P.name, n)
        np.testing.assert_allclose(runs["port", True][0],
                                   runs["jax", True][0], rtol=TOL)
        _same_state(runs["jax", True][1], runs["port", True][1])

    def test_scale_rides_the_chunk_carry(self):
        """A mid-chunk overflow halves the scale for the very next
        in-chunk step."""
        pair = _pair(guard_kw=dict(dynamic_loss_scale=True,
                                   init_loss_scale=64.0,
                                   growth_interval=100, divergence=False))
        rows = {}
        for P in (J, T):
            prog, loss, scope = pair[P.name]
            exe = P.exe()
            P.fault.inject("guard.nonfinite", crash_on_nth=2, times=1)
            exe.run_chunk(prog, feed_chunk=P.stack(_feeds(4)), k=4,
                          fetch_list=[loss.name], scope=scope, step0=0)
            h = exe.poll_health()
            assert h.shape == (4, 6)
            assert list(h[:, 2]) == [0.0, 1.0, 0.0, 0.0]
            assert list(h[:, 5]) == [64.0, 32.0, 32.0, 32.0]
            assert _gvar(scope, "guard@skipped_steps") == 1
            rows[P.name] = h
        _same_health(rows["jax"], rows["port"])

    def test_shared_param_grad_unscaled_exactly_once(self):
        """A shared parameter's accumulated gradient is unscaled only at
        its final producer: with scaling it equals the unscaled run's."""
        feed = _feeds(1)[0]
        grads = {}
        for scaling in (False, True):
            pair = _pair(build_kw=dict(shared=True), guard_kw=dict(
                dynamic_loss_scale=True, init_loss_scale=4.0,
                divergence=False) if scaling else None)
            for P in (J, T):
                prog, loss, scope = pair[P.name]
                exe = P.exe()
                out = exe.run(prog, feed=feed, scope=scope,
                              fetch_list=[loss.name, "shared_w@GRAD"])
                if scaling:
                    exe.poll_health()
                grads[P.name, scaling] = np.asarray(out[1])
        for P in (J, T):
            np.testing.assert_allclose(grads[P.name, True],
                                       grads[P.name, False], rtol=1e-6)
        np.testing.assert_allclose(grads["port", True], grads["jax", True],
                                   rtol=TOL, atol=TOL)

    def test_chunked_equals_sequential_with_guard(self):
        """guard + run_chunk == guard + K run() calls, bitwise (skips
        and scale updates fold identically), with a poisoned step."""
        feeds = _feeds(4)
        res = {}
        for chunked in (False, True):
            pair = _pair(guard_kw=dict(dynamic_loss_scale=True,
                                       init_loss_scale=8.0,
                                       growth_interval=2, divergence=False))
            for P in (J, T):
                prog, loss, scope = pair[P.name]
                P.fault.clear()
                P.fault.inject("guard.nonfinite", crash_on_nth=3, times=1)
                exe = P.exe()
                if chunked:
                    losses = list(exe.run_chunk(
                        prog, feed_chunk=P.stack(feeds), scope=scope,
                        fetch_list=[loss.name], step0=1)[0])
                    h = exe.poll_health()
                else:
                    exe._step = 1
                    losses, h = [], []
                    for f in feeds:
                        losses.append(exe.run(prog, feed=f, scope=scope,
                                              fetch_list=[loss.name])[0])
                        h.append(exe.last_health)
                    exe.poll_health()
                    h = np.concatenate(h)
                res[P.name, chunked] = (np.asarray(losses, np.float32),
                                        _state(P, scope), np.asarray(h),
                                        _gvar(scope, "guard@loss_scale"))
        for P in (J, T):
            seq, ch = res[P.name, False], res[P.name, True]
            assert seq[3] == ch[3]
            assert np.array_equal(seq[0], ch[0])
            assert np.array_equal(seq[2], ch[2], equal_nan=True)
            for n in seq[1]:
                assert np.array_equal(seq[1][n], ch[1][n]), (P.name, n)
        # step0=1: the chunk's steps are 2..5 1-based, the 3rd poisoned
        assert list(res["port", True][2][:, 2]) == [0.0, 1.0, 0.0, 0.0]
        _same_health(res["jax", True][2], res["port", True][2])
        _same_state(res["jax", True][1], res["port", True][1])
        assert res["jax", True][3] == res["port", True][3]


def _global_clip(norm):
    return lambda fluid: fluid.clip.GradientClipByGlobalNorm(norm)


class TestClipGuardCompose:
    def test_global_norm_clip_factor_math(self):
        """Every grad scaled by clip_norm / max(gnorm, clip_norm)."""
        clip_norm = 0.5
        pair = _pair(build_kw=dict(clip=_global_clip(clip_norm)))
        for P in (J, T):
            prog, loss, scope = pair[P.name]
            gnames = [g for _, g in prog._op_role_vars]
            fetch = [loss.name] + gnames + [g + "@CLIP" for g in gnames]
            out = P.exe().run(prog, feed=_feeds(1)[0], fetch_list=fetch,
                              scope=scope)
            raw = out[1:1 + len(gnames)]
            clipped = out[1 + len(gnames):]
            gnorm = np.sqrt(sum(float(np.sum(np.square(g))) for g in raw))
            factor = clip_norm / max(gnorm, clip_norm)
            for r, c in zip(raw, clipped):
                np.testing.assert_allclose(c, r * factor, rtol=1e-5)

    def test_clipped_finite_step_is_not_skipped(self):
        """A huge-but-finite gradient is clipped and applied; the health
        norm reports the pre-clip magnitude, as in the JAX package."""
        pair = _pair(build_kw=dict(clip=_global_clip(1.0),
                                   loss_scale_factor=1e8),
                     guard_kw=dict(divergence=False))
        rows = {}
        for P in (J, T):
            prog, loss, scope = pair[P.name]
            exe = P.exe()
            before = _state(P, scope)
            exe.run(prog, feed=_feeds(1)[0], fetch_list=[loss.name],
                    scope=scope)
            h = exe.poll_health()
            assert h[0, 2] == 0.0 and np.isfinite(h[0, 1]) and h[0, 1] > 1e6
            after = _state(P, scope)
            assert not np.array_equal(before["fc_0.w_0"], after["fc_0.w_0"])
            assert float(np.abs(after["fc_0.w_0"]
                                - before["fc_0.w_0"]).max()) < 1.0
            rows[P.name] = h
        _same_health(rows["jax"][:, 2:], rows["port"][:, 2:])
        np.testing.assert_allclose(rows["port"][:, :2], rows["jax"][:, :2],
                                   rtol=TOL)

    def test_poisoned_step_skipped_even_under_clip(self):
        pair = _pair(build_kw=dict(clip=_global_clip(1.0)),
                     guard_kw=dict(dynamic_loss_scale=True,
                                   init_loss_scale=16.0, divergence=False))
        rows = {}
        for P in (J, T):
            prog, loss, scope = pair[P.name]
            exe = P.exe()
            P.fault.inject("guard.nonfinite", crash_on_nth=1, times=1)
            before = _state(P, scope)
            exe.run(prog, feed=_feeds(1)[0], fetch_list=[loss.name],
                    scope=scope)
            h = exe.poll_health()
            assert h[0, 2] == 1.0
            after = _state(P, scope)
            for n in before:
                assert np.array_equal(before[n], after[n]), n
            assert _gvar(scope, "guard@loss_scale") == 8.0
            rows[P.name] = h
        _same_health(rows["jax"], rows["port"])

    def test_gnorm_not_double_counted_under_clip_plus_regularizer(self):
        """A zero-coefficient L2 decay renames the clipped grads; the
        guard's coverage is keyed by parameter, so the health norm is
        the no-regularizer run's."""
        norms = {}
        for reg in (None, lambda P: P.fluid.regularizer.L2Decay(0.0)):
            pair = _pair(build_kw=dict(clip=_global_clip(1.0), reg=reg),
                         guard_kw=dict(divergence=False))
            for P in (J, T):
                prog, loss, scope = pair[P.name]
                exe = P.exe()
                exe.run(prog, feed=_feeds(1)[0], fetch_list=[loss.name],
                        scope=scope)
                norms[P.name, reg is None] = float(exe.poll_health()[0, 1])
        for P in (J, T):
            np.testing.assert_allclose(norms[P.name, False],
                                       norms[P.name, True], rtol=1e-5)
        np.testing.assert_allclose(norms["port", False], norms["jax", False],
                                   rtol=TOL)

    def test_clip_and_guard_compose_in_run_chunk(self):
        pair = _pair(build_kw=dict(clip=_global_clip(1.0)),
                     guard_kw=dict(divergence=False))
        rows = {}
        for P in (J, T):
            prog, loss, scope = pair[P.name]
            exe = P.exe()
            out = exe.run_chunk(prog, feed_chunk=P.stack(_feeds(4)), k=4,
                                fetch_list=[loss.name], scope=scope)
            assert np.isfinite(out[0]).all()
            h = exe.poll_health()
            assert h.shape == (4, 6) and h[:, 2].sum() == 0
            assert np.isfinite(h[:, 1]).all()
            rows[P.name] = h
        _same_health(rows["jax"], rows["port"])


class TestHealthPipeline:
    def test_scale_reseeded_when_scaling_config_changes(self):
        """Arming dynamic scaling on a scope that ran the guard without
        it re-seeds the scale to init_loss_scale."""
        pair = _pair(guard_kw=dict(divergence=False))
        for P in (J, T):
            prog, loss, scope = pair[P.name]
            exe = P.exe()
            exe.run(prog, feed=_feeds(1)[0], fetch_list=[loss.name],
                    scope=scope)
            assert _gvar(scope, "guard@loss_scale") == 1.0
            P.guard.enable(prog, loss, dynamic_loss_scale=True,
                           init_loss_scale=64.0, divergence=False)
            exe.run(prog, feed=_feeds(1)[0], fetch_list=[loss.name],
                    scope=scope)
            exe.poll_health()
            assert _gvar(scope, "guard@loss_scale") == 64.0
            assert _gvar(scope, "guard@good_steps") == 1


class TestGuardCompileInvariants:
    def test_guard_toggle_is_one_named_recompile(self):
        """One plan per (program, guard) key in the port (one executable
        in the JAX package): the guard flip is one named rebuild, and
        guarded steady state is pure cache hits."""
        pair = _pair()
        for P in (J, T):
            prog, loss, scope = pair[P.name]
            P.tel.enable()
            exe = P.exe()
            chunk = P.stack(_feeds(2))
            exe.run_chunk(prog, feed_chunk=chunk, fetch_list=[loss.name],
                          scope=scope)
            base = P.tel.recompile_detector.compile_count(prog.fingerprint)
            P.guard.enable(prog, loss, divergence=False)
            for _ in range(3):
                exe.run_chunk(prog, feed_chunk=chunk, fetch_list=[loss.name],
                              scope=scope)
            exe.poll_health()
            assert P.tel.recompile_detector.compile_count(
                prog.fingerprint) == base + 1, P.name
            diffs = [e for e in P.tel.recompile_detector.events
                     if any(d.startswith("guard:") for d in e["diff"])]
            assert diffs, P.name

    def test_arming_poison_is_its_own_executable(self):
        """Arming guard.nonfinite is one named rebuild; clearing the rule
        returns to the cached plan."""
        pair = _pair(guard_kw=dict(divergence=False))
        for P in (J, T):
            prog, loss, scope = pair[P.name]
            P.tel.enable()
            exe = P.exe()
            f = _feeds(1)[0]
            exe.run(prog, feed=f, fetch_list=[loss.name], scope=scope)
            base = P.tel.recompile_detector.compile_count(prog.fingerprint)
            with P.fault.scope("guard.nonfinite", crash_on_nth=10 ** 9):
                exe.run(prog, feed=f, fetch_list=[loss.name], scope=scope)
                assert P.tel.recompile_detector.compile_count(
                    prog.fingerprint) == base + 1
            exe.run(prog, feed=f, fetch_list=[loss.name], scope=scope)
            exe.poll_health()
            assert P.tel.recompile_detector.compile_count(
                prog.fingerprint) == base + 1, P.name


class TestHealthTracker:
    def test_clean_flag_tracks_skip_delta(self):
        import jax.numpy as jnp

        for P, mk in ((J, lambda v, dt: jnp.asarray(v, dt)),
                      (T, lambda v, dt: torch.tensor(v, dtype=dt))):
            prog, _, loss = _build(P)
            P.guard.enable(prog, loss)
            scope = P.fluid.Scope()
            u32 = jnp.uint32 if P is J else torch.int64
            f32 = jnp.float32 if P is J else torch.float32
            scope.set_var("guard@skipped_steps", mk(0, u32))
            scope.set_var("guard@loss_scale", mk(4.0, f32))
            tracker = P.guard.HealthTracker(prog, scope)
            assert tracker.block()["health"] == {
                "clean": True, "skipped_steps_total": 0, "loss_scale": 4.0}
            scope.set_var("guard@skipped_steps", mk(2, u32))
            assert tracker.peek()["health"]["clean"] is False
            assert tracker.block()["health"]["clean"] is False
            assert tracker.block()["health"]["clean"] is True
            scope.set_var("guard@skipped_steps", mk(5, u32))
            tracker.resync()
            assert tracker.block()["health"]["clean"] is True


def test_reset_state_reseeds_in_place_and_erases():
    pair = _pair(guard_kw=dict(dynamic_loss_scale=True,
                               init_loss_scale=32.0, divergence=False))
    prog, loss, scope = pair["port"]
    exe = T.exe()
    T.fault.inject("guard.nonfinite", crash_on_nth=1, times=1)
    exe.run(prog, feed=_feeds(1)[0], fetch_list=[loss.name], scope=scope)
    exe.poll_health()
    scale = scope.find_var("guard@loss_scale")
    assert scale.item() == 16.0
    tguard.reset_state(scope, prog)
    assert scope.find_var("guard@loss_scale") is scale and scale.item() == 32.0
    assert _gvar(scope, "guard@skipped_steps") == 0
    tguard.reset_state(scope)
    assert all(scope.find_var(n) is None for n in tguard.STATE_NAMES)


_LM = dict(vocab_size=50, seq_len=16, d_model=32, num_layers=1, num_heads=2)


def _amp_pair(scale=256.0):
    """The tiny transformer LM under bf16 AMP with dynamic loss scaling
    (``amp.enable(prog, loss=..., dynamic_loss_scale=True)``) in both
    packages, on the JAX startup's weights: {P: (program, loss,
    scope)}."""
    from paddle_tpu.models.transformer import build_transformer_lm as jlm
    from paddle_tpu_torch.models.transformer import build_transformer_lm \
        as tlm

    out, arrays = {}, None
    for P, build in ((J, jlm), (T, tlm)):
        with P.names.guard():
            prog, startup, _, (loss,) = build(**_LM)
        P.fluid.amp.enable(prog, loss=loss, dynamic_loss_scale=True,
                           init_loss_scale=scale, growth_interval=2,
                           divergence=False)
        scope = P.fluid.Scope()
        if P is J:
            P.exe().run(startup, scope=scope)
            arrays = {v.name: np.asarray(scope.find_var(v.name))
                      for v in prog.list_vars() if v.persistable}
        else:
            interop.load_reference_state(arrays, scope, CPU, prog)
        out[P.name] = (prog, loss, scope)
    return out


def _lm_feeds(n, seed):
    rng = np.random.RandomState(seed)
    return [{"tokens": rng.randint(0, 50, (2, 16)).astype(np.int64),
             "targets": rng.randint(0, 50, (2, 16)).astype(np.int64)}
            for _ in range(n)]


def test_amp_transformer_under_the_guard_matches_jax():
    """AMP under the guard, 4 run() steps with step 2 poisoned, in both
    packages from the same weights: skipped at step 2 only, the state
    bitwise unchanged across it, and the losses and each parameter's
    update over the 4 steps at PERF.md section 2's AMP bounds (first
    loss rtol 1e-2; each update within 0.5 of its own L2 norm, all
    together 0.2; an update under 1e-4 of the largest held in the whole
    only)."""
    pair = _amp_pair()
    res = {}
    for P in (J, T):
        prog, loss, scope = pair[P.name]
        init = _state(P, scope)
        P.fault.inject("guard.nonfinite", crash_on_nth=2, times=1)
        exe = P.exe()
        losses, states, rows = [], [], []
        for f in _lm_feeds(4, 3):
            losses.append(float(np.asarray(exe.run(
                prog, feed=f, fetch_list=[loss], scope=scope)[0])))
            states.append(_state(P, scope))
            rows.append(exe.last_health)
        exe.poll_health()
        rows = np.concatenate(rows)
        assert list(rows[:, 2]) == [0.0, 1.0, 0.0, 0.0], P.name
        assert list(rows[:, 5]) == [256.0, 128.0, 128.0, 256.0], P.name
        for n in states[0]:
            assert np.array_equal(states[0][n], states[1][n]), (P.name, n)
        res[P.name] = (losses, states[-1], init)
    np.testing.assert_allclose(res["port"][0][0], res["jax"][0][0],
                               rtol=1e-2)
    jfin, tfin, init = res["jax"][1], res["port"][1], res["jax"][2]
    upd = {n: (tfin[n].astype(np.float64) - init[n],
               jfin[n].astype(np.float64) - init[n])
           for n in init if init[n].dtype.kind == "f"
           and np.abs(jfin[n] - init[n]).max() > 0}
    big = max(np.linalg.norm(j) for _, j in upd.values())
    num = den = 0.0
    for n, (t, j) in upd.items():
        nj = np.linalg.norm(j)
        num += np.linalg.norm(t - j) ** 2
        den += nj ** 2
        if nj >= 1e-4 * big:
            assert np.linalg.norm(t - j) <= 0.5 * nj, n
    assert np.sqrt(num / den) <= 0.2


def test_amp_guard_scale_and_skips_match_jax():
    """The same AMP model through run_chunk (K=5, step 2 poisoned): the
    health rows' skips and scales equal the JAX package's exactly (the
    scale halved at the skip, regrown after 2 clean steps), the losses
    at rtol 1e-2."""
    pair = _amp_pair()
    rows = {}
    for P in (J, T):
        prog, loss, scope = pair[P.name]
        P.fault.inject("guard.nonfinite", crash_on_nth=2, times=1)
        exe = P.exe()
        exe.run_chunk(prog, feed_chunk=P.stack(_lm_feeds(5, 4)),
                      fetch_list=[loss], scope=scope, step0=0)
        rows[P.name] = exe.poll_health()
    for h in rows.values():
        assert list(h[:, 2]) == [0.0, 1.0, 0.0, 0.0, 0.0]
        assert list(h[:, 5]) == [256.0, 128.0, 128.0, 256.0, 256.0]
    np.testing.assert_array_equal(rows["port"][:, 2:], rows["jax"][:, 2:])
    np.testing.assert_allclose(rows["port"][:, 0], rows["jax"][:, 0],
                               rtol=1e-2)
