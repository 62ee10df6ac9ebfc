"""The port's one-shot serving tier on the CPU: ``ServingEngine``,
``DynamicBatcher``, ``ServingServer``/``ServingClient`` (``infer`` and
``generate``) and ``python -m paddle_tpu_torch serve``, held to the cases
of ``tests/test_serving.py`` and against the JAX package's engine on the
same weights (carried by ``interop.load_reference_state``).

Tolerances: the port against the JAX package at rtol 1e-5 (float32
math in another summation order); the engine BITWISE against the port's
own ``Executor.run`` on the same padded bucket, and at rtol 1e-5 against
``Executor.run`` on the request's rows alone (a product over fewer rows
may take another kernel on the CPU: a one-row product differs from a
two-row one in the last bit); the int8 engine's dequantized weights
bitwise equal to the JAX package's grid. Greedy tokens over ``generate``
identical to an in-process ``DecodeLoop``."""

import os
import signal
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu import layers as jlayers
from paddle_tpu import unique_name as jnames
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu_torch import fault, interop, layers, telemetry
from paddle_tpu_torch import unique_name as tnames
from paddle_tpu_torch.core.lower import concat_time_padded
from paddle_tpu_torch.distributed import rpc
from paddle_tpu_torch.models.stacked_lstm import stacked_lstm_net
from paddle_tpu_torch.models.transformer import (build_transformer_decode,
                                                 transformer_lm)
from paddle_tpu_torch.serving import (BatchTooLarge, Closed,
                                      DeadlineExceeded, DecodeEngine,
                                      DecodeLoop, DynamicBatcher, NotReady,
                                      Overloaded, ServingClient,
                                      ServingEngine, ServingServer,
                                      default_buckets)

_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, os.cpu_count() // int(_WORKERS)))

CPU = fluid.CPUPlace()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean():
    fault.clear()
    telemetry.reset()
    telemetry.disable()
    yield
    fault.clear()
    telemetry.reset()
    telemetry.disable()


def _mlp(fl, ly, names):
    with names.guard():
        prog, startup = fl.Program(), fl.Program()
        with fl.program_guard(prog, startup):
            img = ly.data("img", [16])
            hidden = ly.fc(img, 32, act="relu")
            pred = ly.fc(hidden, 10, act="softmax")
    return prog, startup, pred


@pytest.fixture(scope="module")
def model():
    """The JAX package's MLP weights in a port scope, both packages'
    inference programs, and the port's direct answers."""
    jprog, jstart, jpred = _mlp(jfluid, jlayers, jnames)
    jscope = jfluid.Scope()
    jexe = jfluid.Executor()
    jexe.run(jstart, scope=jscope)
    arrays = {v.name: np.asarray(jscope.find_var(v.name))
              for v in jstart.list_vars() if v.persistable}
    prog, startup, pred = _mlp(fluid, layers, tnames)
    scope = fluid.Scope()
    interop.load_reference_state(arrays, scope, CPU, startup)
    exe = fluid.Executor(CPU)
    infer_prog = fluid.io.get_inference_program([pred], prog)
    X = np.random.RandomState(0).rand(64, 16).astype(np.float32)
    return SimpleNamespace(
        scope=scope, prog=infer_prog, exe=exe, pred=pred.name, X=X,
        jscope=jscope, jprog=jfluid.io.get_inference_program([jpred], jprog),
        jexe=jexe, arrays=arrays)


@pytest.fixture(scope="module")
def engine(model):
    eng = ServingEngine(model.prog, ["img"], [model.pred],
                        scope=model.scope, max_batch=8, place=CPU)
    eng.warmup()
    return eng


def _ref_rows(model, lo, hi):
    """Direct Executor.run on exactly rows [lo:hi)."""
    return model.exe.run(model.prog, feed={"img": model.X[lo:hi]},
                         fetch_list=[model.pred], scope=model.scope)[0]


def _ref_bucket(model, rows, bucket):
    """Executor.run on ``rows`` padded with zero rows to ``bucket``,
    sliced back: the eager run of the padded bucket."""
    x = np.zeros((bucket, rows.shape[1]), np.float32)
    x[:len(rows)] = rows
    return model.exe.run(model.prog, feed={"img": x},
                         fetch_list=[model.pred],
                         scope=model.scope)[0][:len(rows)]


def _assert_rows(got, model, lo, hi):
    np.testing.assert_allclose(got, _ref_rows(model, lo, hi), rtol=1e-5,
                               atol=1e-7)


# ---- engine: buckets, padding, the cache ----


class TestEngine:
    def test_default_buckets(self):
        assert default_buckets(8) == (1, 2, 4, 8)
        assert default_buckets(6) == (1, 2, 4, 6)
        assert default_buckets(1) == (1,)

    def test_bucket_selection_and_too_large(self, engine):
        assert engine.bucket_for(1) == 1
        assert engine.bucket_for(3) == 4
        assert engine.bucket_for(8) == 8
        with pytest.raises(BatchTooLarge):
            engine.bucket_for(9)

    def test_warmup_builds_every_bucket(self, engine):
        assert engine.ready
        assert engine.compile_count() == len(engine.buckets) == 4
        costs = engine.bucket_costs()
        assert sorted(costs) == [1, 2, 4, 8]
        flops = [costs[b]["flops"] for b in sorted(costs)]
        # two fc products: 2 (16 x 32 + 32 x 10) flops a row
        assert flops == [2.0 * (16 * 32 + 32 * 10) * b
                         for b in sorted(costs)]

    @pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
    def test_padded_infer_bitwise_equals_executor(self, model, engine, n):
        out = engine.infer({"img": model.X[:n]})[0]
        assert out.shape == (n, 10)
        assert np.array_equal(out, _ref_bucket(model, model.X[:n],
                                               engine.bucket_for(n)))
        _assert_rows(out, model, 0, n)

    @pytest.mark.parametrize("n", [1, 3, 8])
    def test_outputs_equal_the_jax_engines(self, model, engine, n):
        jeng = JEngine(model.jprog, ["img"], [model.pred],
                       scope=model.jscope, max_batch=8)
        want = np.asarray(jeng.infer({"img": model.X[:n]})[0])
        np.testing.assert_allclose(engine.infer({"img": model.X[:n]})[0],
                                   want, rtol=1e-5, atol=1e-7)

    def test_infer_reuses_the_cache(self, model, engine):
        before = engine.compile_count()
        for n in (1, 2, 3, 4, 5, 7, 8):
            engine.infer({"img": model.X[:n]})
        assert engine.compile_count() == before

    def test_tensors_in_and_out(self, model, engine):
        out = engine.infer({"img": torch.from_numpy(model.X[:3])},
                           return_numpy=False)[0]
        assert isinstance(out, torch.Tensor) and out.shape == (3, 10)
        assert np.array_equal(out.numpy(), _ref_bucket(model, model.X[:3],
                                                       4))

    def test_feeds_of_another_dtype_or_layout(self, model, engine):
        """Rows go straight into the bucket's buffer: float64 rows, a
        Fortran-ordered copy, a strided view and a float64 tensor answer
        as the float32 rows do."""
        want = engine.infer({"img": model.X[:3]})[0]
        wide = model.X[:3].astype(np.float64)
        strided = np.stack([model.X[:3], model.X[:3]], 1)[:, 0]
        assert not strided.flags.c_contiguous
        for rows in (wide, np.asfortranarray(wide), strided,
                     torch.from_numpy(wide)):
            assert np.array_equal(engine.infer({"img": rows})[0], want)

    def test_strict_refuses_cold_bucket(self, model):
        eng = ServingEngine(model.prog, ["img"], [model.pred],
                            scope=model.scope, buckets=(2,), place=CPU)
        with pytest.raises(NotReady):
            eng.infer({"img": model.X[:2]}, strict=True)
        eng.warmup()
        out = eng.infer({"img": model.X[:1]}, strict=True)[0]
        assert np.array_equal(out, _ref_bucket(model, model.X[:1], 2))
        _assert_rows(out, model, 0, 1)

    def test_rejects_training_program(self):
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            img = layers.data("img", [16])
            label = layers.data("label", [1], dtype="int64")
            pred = layers.fc(img, 10, act="softmax")
            loss = layers.mean(layers.cross_entropy(pred, label))
            fluid.optimizer.SGD(0.1).minimize(loss)
        scope = fluid.Scope()
        fluid.Executor(CPU).run(startup, scope=scope)
        with pytest.raises(ValueError, match="pure inference"):
            ServingEngine(prog, ["img", "label"], [loss.name], scope=scope,
                          place=CPU)

    def test_rejects_batch_reducing_fetch(self):
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            img = layers.data("img", [16])
            pred = layers.fc(img, 10, act="softmax")
            m = layers.mean(pred)
        scope = fluid.Scope()
        fluid.Executor(CPU).run(startup, scope=scope)
        infer = fluid.io.get_inference_program([m], prog)
        with pytest.raises(ValueError, match="batch-led"):
            ServingEngine(infer, ["img"], [m.name], scope=scope, place=CPU)

    def test_rejects_missing_state_and_without_place_needs_a_card(
            self, model):
        with pytest.raises(ValueError, match="neither feeds nor in scope"):
            ServingEngine(model.prog, ["img"], [model.pred],
                          scope=fluid.Scope(), place=CPU)
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present: the engine runs on it")
        with pytest.raises(RuntimeError, match="CPUPlace"):
            ServingEngine(model.prog, ["img"], [model.pred],
                          scope=model.scope)

    def test_recompile_free_steady_state(self, model):
        """After warmup, traffic of every admissible batch size is all
        cache hits: the misses and bucket-build counters freeze."""
        telemetry.enable()
        eng = ServingEngine(model.prog, ["img"], [model.pred],
                            scope=model.scope, max_batch=4,
                            service="steady", place=CPU)
        eng.warmup()
        s = telemetry.summary()
        misses0 = s["paddle_tpu_executor_jit_cache_misses_total"]
        assert misses0 == len(eng.buckets) == 3
        assert s["paddle_tpu_serving_bucket_compiles_total"] == 3
        rng = np.random.RandomState(1)
        for _ in range(40):
            eng.infer({"img": model.X[:int(rng.randint(1, 5))]})
        s = telemetry.summary()
        assert s["paddle_tpu_executor_jit_cache_misses_total"] == misses0
        assert s["paddle_tpu_serving_bucket_compiles_total"] == 3
        assert s["paddle_tpu_executor_jit_cache_hits_total"] >= 40
        assert telemetry.recompile_detector.compile_count(
            model.prog.fingerprint) == misses0
        assert "paddle_tpu_deploy_output_mean_ratio" in s


class TestState:
    def test_swap_state_reaches_the_runs(self, model):
        scope = fluid.Scope()
        interop.load_reference_state(model.arrays, scope, CPU,
                                     [model.prog])
        eng = ServingEngine(model.prog, ["img"], [model.pred], scope=scope,
                            max_batch=4, place=CPU)
        eng.warmup()
        before = eng.infer({"img": model.X[:3]})[0]
        held = scope.find_var("fc_0.w_0")
        new = {n: scope.find_var(n).numpy() * 0.5 for n in eng._state_names}
        old = eng.swap_state(new)
        assert scope.find_var("fc_0.w_0") is held      # copied in place
        assert np.array_equal(held.numpy(), new["fc_0.w_0"])
        want = model.exe.run(model.prog, feed={"img": model.X[:3]},
                             fetch_list=[model.pred], scope=scope)[0]
        after = eng.infer({"img": model.X[:3]})[0]
        assert np.array_equal(after, want) and not np.allclose(after,
                                                               before)
        eng.swap_state(old)
        assert np.array_equal(eng.infer({"img": model.X[:3]})[0], before)
        with pytest.raises(ValueError, match="missing"):
            eng.swap_state({})
        bad = dict(new, **{"fc_0.w_0": np.zeros((3, 3), np.float32)})
        with pytest.raises(ValueError, match="state signature"):
            eng.swap_state(bad)
        assert np.array_equal(eng.infer({"img": model.X[:3]})[0], before)

    def test_a_replaced_scope_entry_is_read(self, model):
        scope = fluid.Scope()
        interop.load_reference_state(model.arrays, scope, CPU,
                                     [model.prog])
        eng = ServingEngine(model.prog, ["img"], [model.pred], scope=scope,
                            max_batch=2, place=CPU)
        eng.warmup()
        scope.set_var("fc_1.b_0", scope.find_var("fc_1.b_0") + 1.0)
        want = model.exe.run(model.prog, feed={"img": model.X[:2]},
                             fetch_list=[model.pred], scope=scope)[0]
        assert np.array_equal(eng.infer({"img": model.X[:2]})[0], want)

    def test_int8_grid_is_the_jax_packages(self, model):
        eng = ServingEngine(model.prog, ["img"], [model.pred],
                            scope=model.scope, max_batch=4, place=CPU,
                            quantize="int8")
        jeng = JEngine(model.jprog, ["img"], [model.pred],
                       scope=model.jscope, max_batch=4, quantize="int8")
        jstate = jeng._state()
        assert sorted(eng._qstate) == sorted(
            n for n, v in jstate.items() if isinstance(v, tuple))
        assert sorted(eng._qstate) == ["fc_0.w_0", "fc_1.w_0"]
        env = eng._env_state()
        for n, (q, scale) in eng._qstate.items():
            jq, jscale = jstate[n]
            assert np.array_equal(q.numpy(), np.asarray(jq))
            assert np.float32(scale.item()) == np.float32(jscale)
            deq = np.asarray(jq).astype(np.float32) * np.float32(jscale)
            assert np.array_equal(env[n].numpy(), deq)
        eng.warmup()
        want = np.asarray(jeng.infer({"img": model.X[:3]})[0])
        np.testing.assert_allclose(eng.infer({"img": model.X[:3]})[0],
                                   want, rtol=1e-5, atol=1e-7)
        # a swap re-quantizes in place
        q = eng._qstate["fc_0.w_0"][0]
        new = {n: model.scope.find_var(n).numpy() * 2.0
               for n in eng._state_names}
        scope_before = {n: model.scope.find_var(n).clone()
                        for n in eng._state_names}
        try:
            eng.swap_state(new)
            assert eng._qstate["fc_0.w_0"][0] is q
            assert np.array_equal(eng._env_state()["fc_0.w_0"].numpy(),
                                  deq_of(new["fc_0.w_0"]))
        finally:
            eng.swap_state(scope_before)


def deq_of(arr):
    absmax = float(np.max(np.abs(arr.astype(np.float32))))
    scale = max(absmax, 1e-30) / 127.0
    q = np.clip(np.round(arr.astype(np.float32) / scale), -127, 127
                ).astype(np.int8)
    return q.astype(np.float32) * np.float32(scale)


# ---- ragged sequences: the stacked LSTM through engine and batcher ----


DICT, HID, T = 40, 8, 12


@pytest.fixture(scope="module")
def lstm():
    with tnames.guard():
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            words = layers.data("words", [1], dtype="int64", lod_level=1)
            pred = stacked_lstm_net(words, DICT, class_dim=2, emb_dim=HID,
                                    hid_dim=HID, stacked_num=3)
    scope = fluid.Scope()
    exe = fluid.Executor(CPU)
    exe.run(startup, scope=scope)
    infer = fluid.io.get_inference_program([pred], prog)
    return SimpleNamespace(prog=infer, scope=scope, exe=exe, pred=pred.name)


def _seqs(rng, rows):
    lens = rng.randint(2, T + 1, rows).astype(np.int32)
    ids = np.zeros((rows, int(lens.max()), 1), np.int64)
    for i, l in enumerate(lens):
        ids[i, :l, 0] = rng.randint(1, DICT, l)
    return fluid.PackedSeq(ids, lens)


def test_ragged_sequences_through_engine_and_batcher(lstm):
    """Requests of 1-3 ragged rows from 4 threads, coalesced by the
    batcher into padded buckets: every answer equals the executor on the
    request's rows alone (rtol 1e-5), so no padded row or batch-mate
    leaks into it."""
    eng = ServingEngine(lstm.prog, ["words"], [lstm.pred], scope=lstm.scope,
                        seq_lens={"words": T}, max_batch=8, place=CPU)
    eng.warmup()
    assert eng.compile_count() == 4
    reqs = [_seqs(np.random.RandomState(i), 1 + i % 3) for i in range(16)]
    results = [None] * len(reqs)
    with DynamicBatcher(eng, max_delay_ms=20, max_queue=64) as b:
        def worker(k):
            for i in range(k, len(reqs), 4):
                results[i] = b.submit({"words": reqs[i]}).result(60)[0]

        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert b.batches_dispatched() < len(reqs)   # coalesced
    for req, got in zip(reqs, results):
        want = lstm.exe.run(lstm.prog, feed={"words": req},
                            fetch_list=[lstm.pred], scope=lstm.scope)[0]
        assert got.shape == (len(req.lengths), 2)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert eng.compile_count() == 4
    with pytest.raises(ValueError, match="exceeds padded seq_len"):
        eng.validate_feed("words", fluid.PackedSeq(
            np.zeros((1, T + 1, 1), np.int64), np.array([T + 1])))
    with pytest.raises(TypeError, match="PackedSeq"):
        eng.validate_feed("words", np.zeros((1, 3, 1), np.int64))


def test_launches_on_capturing_streams_stay_apart(monkeypatch):
    """While a capture counts, launches on a capturing stream go to its
    tally, from whatever thread (autograd runs a backward on its own),
    and launches on other streams to the counter; each replay credits
    the tally; counts from many threads are exact. A thread-local flag
    stands in for the card's capturing stream."""
    from paddle_tpu_torch import kernels

    stream = threading.local()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: getattr(stream, "capturing", False))
    counter = {"k": 0}

    def launch(times, capturing):
        stream.capturing = capturing
        for _ in range(times):
            kernels.count_launch(counter, "k")

    with kernels.capturing_launches() as tally:
        launch(2, True)
        for t in (threading.Thread(target=launch, args=(5, False)),
                  threading.Thread(target=launch, args=(3, True))):
            t.start()
            t.join(10)
        with pytest.raises(RuntimeError, match="already counts"):
            with kernels.capturing_launches():
                pass
    assert counter["k"] == 5 and tally == [(counter, {"k": 5})]
    launch(1, True)                # a capture nobody counts: the counter
    assert counter["k"] == 6
    kernels.credit_launches(tally)
    kernels.credit_launches(tally)
    assert counter["k"] == 16
    threads = [threading.Thread(target=launch, args=(20000, False))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert counter["k"] == 16 + 4 * 20000


def test_every_wrapper_counts_through_count_launch():
    """A wrapper that added to its ``launches`` dict itself would count
    its launches at a capture and never at a replay."""
    import glob
    import re

    sources = glob.glob(os.path.join(REPO, "paddle_tpu_torch", "kernels",
                                     "*.py"))
    direct = [(os.path.basename(p), m.group(0))
              for p in sources
              for m in re.finditer(r"launches\[[^\]]*\]\s*\+=",
                                   open(p).read())]
    assert direct == []
    calls = sum(open(p).read().count("count_launch(launches, ")
                for p in sources)
    assert calls == 12


def test_concat_time_padded_numpy_and_torch_agree():
    rng = np.random.RandomState(0)
    datas = [rng.rand(2, 3, 4).astype(np.float32),
             rng.rand(1, 5, 4).astype(np.float32)]
    lens = [np.array([3, 1], np.int32), np.array([5], np.int32)]
    d, l = concat_time_padded(datas, lens, xp=np)
    td, tl = concat_time_padded([torch.from_numpy(x) for x in datas],
                                [torch.from_numpy(x) for x in lens])
    assert d.shape == (3, 5, 4) and np.array_equal(d, td.numpy())
    assert np.array_equal(l, tl.numpy()) and l.tolist() == [3, 1, 5]
    assert np.array_equal(d[:2, :3], datas[0]) and not d[:2, 3:].any()


# ---- batcher: coalescing, admission, deadlines, drain ----


class _GateEngine:
    """Duck-typed engine whose infer blocks on a gate."""

    feed_names = ("x",)
    buckets = (1, 2, 4)
    max_batch = 4
    ready = True

    def __init__(self, fail=False):
        self.gate = threading.Event()
        self.gate.set()
        self.calls = []
        self.fail = fail

    def bucket_for(self, n):
        for b in self.buckets:
            if n <= b:
                return b
        raise BatchTooLarge("batch %d > %d" % (n, self.max_batch))

    def compile_count(self):
        return len(self.buckets) if self.ready else 0

    def validate_feed(self, name, v):
        pass

    def infer(self, feed):
        assert self.gate.wait(10), "gate never opened"
        if self.fail:
            raise RuntimeError("engine exploded")
        self.calls.append(int(np.shape(feed["x"])[0]))
        return [np.asarray(feed["x"]) * 2.0]


def _wait(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.005)


class TestBatcher:
    def test_coalesces_within_delay_window(self):
        eng = _GateEngine()
        eng.gate.clear()
        b = DynamicBatcher(eng, max_delay_ms=30, max_queue=16)
        try:
            x = np.arange(4, dtype=np.float32).reshape(4, 1)
            futs = [b.submit({"x": x[i:i + 1]}) for i in range(4)]
            eng.gate.set()
            res = [f.result(timeout=10) for f in futs]
            assert eng.calls == [4]
            for i, r in enumerate(res):
                assert np.array_equal(r[0], x[i:i + 1] * 2.0)
        finally:
            eng.gate.set()
            b.close()

    def test_full_batch_dispatches_before_delay(self):
        eng = _GateEngine()
        b = DynamicBatcher(eng, max_delay_ms=5000, max_queue=16)
        try:
            x = np.ones((4, 1), np.float32)
            t0 = time.monotonic()
            futs = [b.submit({"x": x[i:i + 1]}) for i in range(4)]
            [f.result(timeout=10) for f in futs]
            assert time.monotonic() - t0 < 2.5
        finally:
            b.close()

    def test_overload_sheds_with_explicit_error(self):
        telemetry.enable()
        eng = _GateEngine()
        eng.gate.clear()
        b = DynamicBatcher(eng, max_delay_ms=1, max_queue=2, name="ovl")
        try:
            x = np.ones((1, 1), np.float32)
            first = b.submit({"x": x})
            _wait(lambda: b.depth() == 0)
            f2, f3 = b.submit({"x": x}), b.submit({"x": x})
            with pytest.raises(Overloaded):
                b.submit({"x": x})
            assert telemetry.summary()[
                "paddle_tpu_serving_rejected_total"] == 1
            eng.gate.set()
            for f in (first, f2, f3):
                assert f.result(timeout=10)[0].shape == (1, 1)
        finally:
            eng.gate.set()
            b.close()

    def test_deadline_expired_request_fails_typed(self):
        eng = _GateEngine()
        eng.gate.clear()
        b = DynamicBatcher(eng, max_delay_ms=1, max_queue=8)
        try:
            x = np.ones((1, 1), np.float32)
            blocker = b.submit({"x": x})
            _wait(lambda: b.depth() == 0)
            doomed = b.submit({"x": x}, timeout=0.02)
            time.sleep(0.1)
            eng.gate.set()
            assert blocker.result(timeout=10)
            with pytest.raises(DeadlineExceeded):
                doomed.result(timeout=10)
        finally:
            eng.gate.set()
            b.close()

    def test_short_deadline_on_idle_engine_is_served(self):
        eng = _GateEngine()
        b = DynamicBatcher(eng, max_delay_ms=200, max_queue=4)
        try:
            x = np.ones((1, 1), np.float32)
            t0 = time.monotonic()
            out = b.submit({"x": x}, timeout=0.05).result(timeout=5)
            assert time.monotonic() - t0 < 0.15
            assert np.array_equal(out[0], x * 2.0)
        finally:
            b.close()

    def test_drain_flushes_every_admitted_request(self):
        eng = _GateEngine()
        eng.gate.clear()
        b = DynamicBatcher(eng, max_delay_ms=1, max_queue=8)
        x = np.ones((1, 1), np.float32)
        futs = [b.submit({"x": x}) for _ in range(5)]
        closer = threading.Thread(target=b.close,
                                  kwargs={"drain": True, "timeout": 20})
        closer.start()
        time.sleep(0.05)
        eng.gate.set()
        closer.join(20)
        assert not closer.is_alive()
        for f in futs:
            assert np.array_equal(f.result(timeout=1)[0], x * 2.0)
        with pytest.raises(Closed):
            b.submit({"x": x})

    def test_oversized_request_is_batch_too_large_not_overloaded(self):
        eng = _GateEngine()
        b = DynamicBatcher(eng, max_batch=2, max_queue=4)
        try:
            with pytest.raises(BatchTooLarge):
                b.submit({"x": np.ones((3, 1), np.float32)})
        finally:
            b.close()

    def test_drain_timeout_reports_incomplete_flush(self):
        eng = _GateEngine()
        eng.gate.clear()
        b = DynamicBatcher(eng, max_delay_ms=1, max_queue=4)
        fut = b.submit({"x": np.ones((1, 1), np.float32)})
        assert b.close(drain=True, timeout=0.2) is False
        eng.gate.set()
        assert b.close(drain=True, timeout=10) is True
        assert fut.result(timeout=1)[0].shape == (1, 1)

    def test_malformed_request_rejected_alone(self, model, engine):
        b = DynamicBatcher(engine, max_delay_ms=30, max_queue=8)
        try:
            good = b.submit({"img": model.X[:1]})
            with pytest.raises(ValueError, match="shape"):
                b.submit({"img": np.ones((1, 8), np.float32)})
            _assert_rows(good.result(timeout=10)[0], model, 0, 1)
        finally:
            b.close()

    def test_engine_failure_surfaces_on_every_future(self):
        eng = _GateEngine(fail=True)
        b = DynamicBatcher(eng, max_delay_ms=10, max_queue=8)
        try:
            x = np.ones((1, 1), np.float32)
            futs = [b.submit({"x": x}) for _ in range(3)]
            for f in futs:
                with pytest.raises(RuntimeError, match="engine exploded"):
                    f.result(timeout=10)
        finally:
            b.close()


# ---- the RPC front-end ----


class TestServer:
    def test_e2e_64_concurrent_bitwise_equal_zero_recompiles(self, model):
        rng = np.random.RandomState(7)
        spans = []
        for _ in range(64):
            lo = int(rng.randint(0, 56))
            spans.append((lo, lo + int(rng.randint(1, 9))))
        refs = [_ref_rows(model, lo, hi) for lo, hi in spans]

        telemetry.enable()
        eng = ServingEngine(model.prog, ["img"], [model.pred],
                            scope=model.scope, max_batch=8, place=CPU)
        srv = ServingServer(eng, max_delay_ms=5, max_queue=256).start()
        try:
            misses0 = telemetry.summary()[
                "paddle_tpu_executor_jit_cache_misses_total"]
            assert misses0 == len(eng.buckets)
            assert ServingClient(srv.address).ready()["ready"]
            results = [None] * 64

            def worker(i):
                lo, hi = spans[i]
                with ServingClient(srv.address) as c:
                    results[i] = c.infer({"img": model.X[lo:hi]})[0]

            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(64)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(30)
            for i in range(64):
                assert results[i] is not None, "request %d lost" % i
                np.testing.assert_allclose(results[i], refs[i], rtol=1e-5,
                                           atol=1e-7)
            s = telemetry.summary()
            assert s["paddle_tpu_executor_jit_cache_misses_total"] \
                == misses0, "traffic rebuilt a bucket after warmup"
            assert s["paddle_tpu_serving_bucket_compiles_total"] \
                == len(eng.buckets)
            assert s["paddle_tpu_serving_requests_total"] >= 64
            assert s["paddle_tpu_serving_batches_total"] >= 1
            assert s["paddle_tpu_serving_first_response_seconds:count"] \
                >= 64
        finally:
            srv.drain()

    def test_overload_over_rpc_is_typed(self):
        eng = _GateEngine()
        eng.gate.clear()
        batcher = DynamicBatcher(eng, max_delay_ms=1, max_queue=1,
                                 name="rpc_ovl")
        srv = ServingServer(batcher=batcher).start(warmup=False)
        try:
            x = np.ones((1, 1), np.float32)
            got = {"overloaded": 0, "ok": 0}
            lock = threading.Lock()

            def worker():
                with ServingClient(srv.address) as c:
                    try:
                        c.infer({"x": x})
                        key = "ok"
                    except Overloaded:
                        key = "overloaded"
                    with lock:
                        got[key] += 1

            threads = [threading.Thread(target=worker) for _ in range(6)]
            for t in threads:
                t.start()
            _wait(lambda: got["overloaded"] >= 1, timeout=10)
            eng.gate.set()
            for t in threads:
                t.join(20)
            assert got["ok"] + got["overloaded"] == 6
            assert got["overloaded"] >= 1 and got["ok"] >= 1
        finally:
            eng.gate.set()
            srv.drain()

    def test_ready_answers_false_during_warmup(self):
        eng = _GateEngine()
        eng.ready = False
        warm_gate = threading.Event()

        def warmup():
            assert warm_gate.wait(10), "warmup gate never opened"
            eng.ready = True

        eng.warmup = warmup
        srv = ServingServer(eng, max_delay_ms=1)
        starter = threading.Thread(target=srv.start)
        starter.start()
        try:
            with ServingClient(srv.address) as c:
                assert c.ready()["ready"] is False
                assert c.health()["status"] == "serving"
                with pytest.raises(Overloaded, match="warming up"):
                    c.infer({"x": np.ones((1, 1), np.float32)})
                warm_gate.set()
                starter.join(10)
                assert c.ready()["ready"] is True
                out = c.infer({"x": np.ones((1, 1), np.float32)})[0]
                assert np.array_equal(out, np.full((1, 1), 2.0,
                                                   np.float32))
        finally:
            warm_gate.set()
            starter.join(10)
            srv.drain()

    def test_health_ready_deploy_and_drain_refuses_new_work(self, model,
                                                            engine):
        srv = ServingServer(engine, max_delay_ms=1).start()
        c = ServingClient(srv.address)
        try:
            assert c.health()["status"] == "serving"
            r = c.ready()
            assert r["ready"] and r["compiled"] == 4
            assert r["buckets"] == [1, 2, 4, 8]
            assert c._ch.call("deploy") == {"generation": None,
                                            "watching": False}
            out = c.infer({"img": model.X[:2]})[0]
            _assert_rows(out, model, 0, 2)
            with pytest.raises(BatchTooLarge):
                c.infer({"img": model.X[:9]})
            srv.drain()
            assert srv.rpc_health()["status"] == "draining"
            assert not srv.rpc_ready()["ready"]
            with pytest.raises((Overloaded, rpc.RpcError)):
                c.infer({"img": model.X[:1]})
        finally:
            c.close()
            srv.drain()

    def test_client_fails_over_across_an_address_list(self, model, engine):
        dead = ServingServer(engine, max_delay_ms=1).start()
        dead_addr = dead.address
        dead.drain()
        live = ServingServer(engine, max_delay_ms=1).start()
        try:
            with ServingClient([dead_addr, live.address],
                               max_attempts=1) as c:
                out = c.infer({"img": model.X[:1]})[0]
                _assert_rows(out, model, 0, 1)
                assert c.failovers == 1 and c._primary == 1
        finally:
            live.drain()


@pytest.mark.chaos
class TestServingChaos:
    def test_dropped_client_mid_batch_loses_nothing_else(self, model,
                                                         engine):
        srv = ServingServer(engine, max_delay_ms=20, max_queue=64).start()
        try:
            fault.inject("victim.infer.recv", drop=1.0, times=1, seed=3)
            results = [None] * 9

            def victim():
                ch = rpc.RpcChannel(srv.address, service="victim")
                try:
                    with pytest.raises(rpc.RpcError):
                        ch.call("infer", {"inputs": {"img": {
                            "data": model.X[:1].tolist(),
                            "dtype": "float32"}}})
                finally:
                    ch.close()

            def worker(i):
                with ServingClient(srv.address) as c:
                    results[i] = c.infer({"img": model.X[i:i + 2]})[0]

            threads = [threading.Thread(target=victim)]
            threads += [threading.Thread(target=worker, args=(i,))
                        for i in range(9)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(30)
            for i in range(9):
                assert results[i] is not None, "request %d lost" % i
                _assert_rows(results[i], model, i, i + 2)
            with ServingClient(srv.address) as c:
                _assert_rows(c.infer({"img": model.X[:1]})[0], model, 0, 1)
        finally:
            srv.drain()

    def test_slow_handler_still_answers(self, model, engine):
        srv = ServingServer(engine, max_delay_ms=1).start()
        try:
            fault.inject("serving.handler", delay_ms=80, times=2, seed=5)
            t0 = time.monotonic()
            with ServingClient(srv.address) as c:
                out = c.infer({"img": model.X[:1]})[0]
            assert time.monotonic() - t0 >= 0.08
            _assert_rows(out, model, 0, 1)
        finally:
            srv.drain()

    def test_drain_waits_for_inflight_reply_writes(self, model, engine):
        srv = ServingServer(engine, max_delay_ms=1).start()
        fault.inject("serving.reply", delay_ms=250, times=1, seed=11)
        results = [None]

        def worker():
            with ServingClient(srv.address) as c:
                results[0] = c.infer({"img": model.X[:1]})[0]

        t = threading.Thread(target=worker)
        t.start()
        _wait(lambda: srv._inflight >= 1, timeout=10)
        t0 = time.monotonic()
        srv.drain()
        assert time.monotonic() - t0 >= 0.1
        t.join(10)
        _assert_rows(results[0], model, 0, 1)

    def test_preemption_during_drain_loses_no_admitted_request(
            self, model, engine):
        class Preemption(Exception):
            pass

        srv = ServingServer(engine, max_delay_ms=20, max_queue=64).start()
        futs = [srv.batcher.submit({"img": model.X[i:i + 1]})
                for i in range(6)]
        fault.inject("serving.drain", error=Preemption, crash_on_nth=1,
                     seed=9)
        with pytest.raises(Preemption):
            srv.drain()
        for i, f in enumerate(futs):
            _assert_rows(f.result(timeout=10)[0], model, i, i + 1)
        srv.drain()
        with pytest.raises(Closed):
            srv.batcher.submit({"img": model.X[:1]})


# ---- generate over RPC ----


VOCAB = 29
LM = dict(d_model=16, num_layers=1, num_heads=2, max_len=32)


@pytest.fixture(scope="module")
def decoder():
    with tnames.guard():
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            tokens = layers.data("tokens", [-1], dtype="int64")
            transformer_lm(tokens, VOCAB, **LM)
    scope = fluid.Scope()
    fluid.Executor(CPU).run(startup, scope=scope)
    pre, dec, meta = build_transformer_decode(vocab_size=VOCAB, **LM)
    eng = DecodeEngine(pre, dec, meta, num_slots=4, prompt_buckets=(8, 16),
                       scope=scope, place=CPU, service="lm")
    eng.warmup()
    return eng


PROMPTS = [np.arange(1, 6), np.arange(3, 15) % VOCAB, np.array([7, 2]),
           np.arange(20, 29)]


def test_generate_over_rpc_equals_the_in_process_loop(decoder):
    """Tokens over ``generate`` from 4 threads equal an in-process
    ``DecodeLoop``'s; the loop's name defaults to the engine's service
    and its telemetry is recorded; a 1 ms deadline comes back as reason
    "deadline" or a typed DeadlineExceeded."""
    with DecodeLoop(decoder) as loop:
        assert loop.name == "lm"
        want = [loop.submit(p, max_new_tokens=6).result(60)[0]
                for p in PROMPTS]
    telemetry.enable()
    loop = DecodeLoop(decoder)
    srv = ServingServer(decoder=loop).start()
    got = [None] * len(PROMPTS)
    try:
        def worker(i):
            with ServingClient(srv.address) as c:
                toks, reason = c.generate(PROMPTS[i], max_new_tokens=6)
                assert reason == "length"
                got[i] = toks

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(PROMPTS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert got == want
        with ServingClient(srv.address) as c:
            try:
                toks, reason = c.generate(PROMPTS[0], max_new_tokens=30,
                                          deadline_ms=1)
                assert reason in ("deadline", "length")
            except DeadlineExceeded:
                pass
            with pytest.raises(Overloaded, match="one-shot"):
                c.infer({"img": np.ones((1, 16), np.float32)})
            with pytest.raises(BatchTooLarge):
                c.generate(np.ones(17, np.int64))
        assert decoder.compile_count() == 3
    finally:
        srv.drain()
    s = telemetry.summary()
    assert s["paddle_tpu_decode_requests_total"] >= len(PROMPTS)
    assert s["paddle_tpu_decode_steps_total"] >= 5
    assert s["paddle_tpu_decode_prefill_seconds_total"] > 0
    assert "paddle_tpu_decode_slot_occupancy_ratio" in s


@pytest.mark.chaos
def test_decode_step_fault_seam_fails_live_generations(decoder):
    """A crash rule at ``<name>.decode_step`` fails the live
    generations with the error; the loop keeps serving the next one."""
    with DecodeLoop(decoder, name="seam") as loop:
        fault.inject("seam.decode_step", crash_on_nth=1, seed=1)
        g = loop.submit(PROMPTS[0], max_new_tokens=4)
        with pytest.raises(fault.FaultInjected):
            g.result(60)
        fault.clear()
        toks, reason = loop.submit(PROMPTS[0],
                                   max_new_tokens=4).result(60)
        assert reason == "length" and len(toks) == 4


# ---- python -m paddle_tpu_torch serve ----


def test_serve_subcommand_answers_and_drains(tmp_path):
    """``python -m paddle_tpu_torch serve --place cpu`` boots over a
    saved inference model, answers an RPC infer bitwise-identically to an
    in-process load of the same model, and drains to exit 0 on SIGTERM;
    what is not ported exits 2 naming its ROADMAP item."""
    model_dir = str(tmp_path / "model")
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        img = layers.data("img", [8])
        pred = layers.fc(img, 4, act="softmax")
    exe = fluid.Executor(CPU)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(model_dir, ["img"], [pred], exe,
                                      main_program=prog)
    x = np.random.RandomState(0).rand(2, 8).astype(np.float32)
    with fluid.scope_guard(fluid.Scope()):
        prog2, _, fetches = fluid.io.load_inference_model(model_dir, exe)
        ref = exe.run(prog2, feed={"img": x},
                      fetch_list=[f.name for f in fetches])[0]

    env = dict(os.environ, PYTHONPATH=REPO)
    cmd = [sys.executable, "-m", "paddle_tpu_torch", "serve",
           "--model-dir", model_dir, "--port", "0", "--max-batch", "4",
           "--max-delay-ms", "2", "--place", "cpu", "--die-with-parent"]
    r = subprocess.run(cmd + ["--replicas", "2"], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 2 and "item 10" in r.stdout, r.stdout
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env,
                            cwd=REPO)
    try:
        line = ""
        deadline = time.time() + 120
        while time.time() < deadline:
            line = proc.stdout.readline()
            if "serving listening on" in line or proc.poll() is not None:
                break
        assert "serving listening on" in line, line
        host, port = line.split("listening on ")[1].split(" ")[0].split(":")
        with ServingClient((host, int(port))) as c:
            assert c.ready()["ready"]
            out = c.infer({"img": x})[0]
        assert np.array_equal(out, ref), (out, ref)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
