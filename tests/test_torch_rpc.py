"""The port's copies of ``tracing.py`` and ``distributed/rpc.py``, held to
the cases of ``tests/test_tracing.py`` and ``tests/test_chaos.py`` that
touch only these modules (and the serving tier the port has): span
semantics, context propagation across the channel (one trace per logical
call, retransmits and half-open probes included), the typed framing
errors, the circuit breaker, deadlines, seeded backoff, the flight
recorder, and one serving request as one connected trace across client
-> server -> batcher -> engine. The two packages speak one wire
protocol: a port client is answered by a JAX-package server and the
other way round."""

import io
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import layers as jlayers
from paddle_tpu import unique_name as jnames
from paddle_tpu.serving import (ServingClient as JClient,
                                ServingEngine as JEngine,
                                ServingServer as JServer)
from paddle_tpu_torch import fault, interop, layers, telemetry, tracing
from paddle_tpu_torch import unique_name as tnames
from paddle_tpu_torch.distributed import rpc
from paddle_tpu_torch.serving import (DynamicBatcher, ServingClient,
                                      ServingEngine, ServingServer)

_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, os.cpu_count() // int(_WORKERS)))

CPU = tfluid.CPUPlace()


@pytest.fixture(autouse=True)
def _fresh_tracing():
    """Tracing and telemetry off and zeroed around every test; no fault
    rule, sink or open span may leak."""
    fault.clear()
    tracing.reset()
    tracing.disable()
    telemetry.reset()
    telemetry.disable()
    yield
    assert not tracing.open_spans(), tracing.open_spans()
    fault.clear()
    tracing.reset()
    tracing.disable()
    telemetry.reset()
    telemetry.disable()


class _Echo:
    """Duck-typed engine: doubles its one feed."""

    feed_names = ("x",)
    buckets = (1, 2, 4)
    max_batch = 4
    ready = True

    def bucket_for(self, n):
        return next(b for b in self.buckets if n <= b)

    def compile_count(self):
        return len(self.buckets)

    def validate_feed(self, name, v):
        pass

    def infer(self, feed):
        return [np.asarray(feed["x"]) * 2.0]


@pytest.fixture
def server():
    srv = ServingServer(batcher=DynamicBatcher(_Echo(), max_delay_ms=1))
    srv.start(warmup=False)
    yield srv
    srv.drain()


def _by_id(spans):
    return {s["span_id"]: s for s in spans}


def _assert_connected(spans):
    by_id = _by_id(spans)
    assert len(by_id) == len(spans), "duplicated span ids"
    for s in spans:
        if s["parent_id"] is not None:
            assert s["parent_id"] in by_id, (s["name"], s["parent_id"])


def _mlp(fluid, layers_, names):
    with names.guard():
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            img = layers_.data("img", [4])
            pred = layers_.fc(img, 2, act="softmax")
    return prog, startup, pred


def _port_engine(max_batch=2):
    scope = tfluid.Scope()
    prog, startup, pred = _mlp(tfluid, layers, tnames)
    tfluid.Executor(CPU).run(startup, scope=scope)
    infer = tfluid.io.get_inference_program([pred], prog)
    eng = ServingEngine(infer, ["img"], [pred.name], scope=scope,
                        max_batch=max_batch, place=CPU)
    eng.warmup()
    return eng


# ---- span semantics ----


class TestSpans:
    def test_nesting_ids_and_records(self):
        tracing.enable()
        with tracing.span("paddle_tpu.test.root", a=1) as root:
            assert tracing.current() is root.ctx
            with tracing.child_span("paddle_tpu.test.child") as child:
                assert child.ctx.trace_id == root.ctx.trace_id
            assert tracing.current() is root.ctx
        spans = tracing.flight_recorder.spans()
        assert [s["name"] for s in spans] == [
            "paddle_tpu.test.child", "paddle_tpu.test.root"]
        child_rec, root_rec = spans
        assert root_rec["parent_id"] is None
        assert child_rec["parent_id"] == root_rec["span_id"]
        assert root_rec["attrs"] == {"a": 1}
        assert root_rec["dur_us"] >= child_rec["dur_us"] >= 0
        _assert_connected(spans)

    def test_disabled_is_noop_nullcontext(self):
        import contextlib

        assert isinstance(tracing.span("paddle_tpu.test.off"),
                          contextlib.nullcontext)
        assert tracing.record_span("paddle_tpu.test.off", 0.0, 1.0) \
            is None
        assert tracing.inject() is None
        assert tracing.flight_recorder.spans() == []

    def test_name_convention_enforced(self):
        tracing.enable()
        for bad in ("no_dots", "paddle_tpu.Caps.op", "paddle_tpu.one",
                    "other.sub.op", "paddle_tpu..op"):
            with pytest.raises(ValueError, match="convention"):
                tracing.start_span(bad)

    def test_sampled_out_propagates_but_records_nothing(self):
        tracing.enable(sample=0.0)
        with tracing.span("paddle_tpu.test.root") as root:
            assert root.ctx.sampled is False
            assert tracing.inject()["sampled"] is False
            with tracing.child_span("paddle_tpu.test.child") as child:
                assert child.ctx.trace_id == root.ctx.trace_id
        assert tracing.flight_recorder.spans() == []

    def test_inject_extract_roundtrip_and_malformed(self):
        tracing.enable()
        with tracing.span("paddle_tpu.test.root") as root:
            ctx = tracing.extract(tracing.inject())
            assert (ctx.trace_id, ctx.span_id) == (root.ctx.trace_id,
                                                   root.ctx.span_id)
        for bad in (None, 7, "x", {}, {"trace_id": 3, "span_id": "a"},
                    {"trace_id": "", "span_id": "a"}):
            assert tracing.extract(bad) is None

    def test_activate_crosses_threads(self):
        tracing.enable()
        with tracing.span("paddle_tpu.test.root") as root:
            ctx = root.ctx

            def worker():
                with tracing.activate(ctx):
                    with tracing.child_span("paddle_tpu.test.child"):
                        pass

            t = threading.Thread(target=worker)
            t.start()
            t.join()
        child = next(s for s in tracing.flight_recorder.spans()
                     if s["name"] == "paddle_tpu.test.child")
        assert child["trace_id"] == ctx.trace_id
        assert child["parent_id"] == ctx.span_id

    def test_ring_is_bounded(self):
        tracing.enable()
        cap = tracing.flight_recorder._spans.maxlen
        for _ in range(cap + 50):
            with tracing.span("paddle_tpu.test.root"):
                pass
        assert len(tracing.flight_recorder.spans()) == cap

    def test_record_span_retroactive(self):
        tracing.enable()
        with tracing.span("paddle_tpu.test.root") as root:
            t0 = time.monotonic()
            rec = tracing.record_span("paddle_tpu.test.child",
                                      t0 - 0.010, t0, parent=root.ctx,
                                      bucket=8)
        assert rec["parent_id"] == root.ctx.span_id
        assert 9000 <= rec["dur_us"] <= 11000
        assert rec["attrs"] == {"bucket": 8}

    def test_broken_sink_warns_not_raises(self):
        tracing.enable()

        def bad_sink(span):
            raise RuntimeError("boom")

        tracing.add_sink(bad_sink)
        with pytest.warns(UserWarning, match="sink"):
            with tracing.span("paddle_tpu.test.root"):
                pass
        tracing.remove_sink(bad_sink)


class TestFlightRecorder:
    def test_dump_schema_and_atomicity(self, tmp_path):
        telemetry.enable()
        tracing.enable()
        telemetry.counter("paddle_tpu_t_flight_total").inc(3)
        with tracing.span("paddle_tpu.test.root"):
            pass
        telemetry.emit("step", executor="t")
        path = tracing.flight_recorder.dump(
            str(tmp_path / "f.json"), reason="unit")
        with open(path) as f:
            doc = json.load(f)
        assert doc["schema"] == tracing.FLIGHT_SCHEMA
        assert doc["reason"] == "unit"
        assert [s["name"] for s in doc["spans"]] == \
            ["paddle_tpu.test.root"]
        assert any(e["kind"] == "step" for e in doc["events"])
        assert doc["telemetry_delta"]["paddle_tpu_t_flight_total"] == 3
        assert os.listdir(tmp_path) == ["f.json"]

    def test_on_crash_without_dump_dir_is_noop(self):
        tracing.enable()
        assert tracing.flight_recorder.on_crash("unit") is None

    def test_flightrec_and_metrics_endpoints(self, server):
        telemetry.enable()
        tracing.enable()
        with tracing.span("paddle_tpu.test.root"):
            pass
        ch = rpc.RpcChannel(server.address, service="t", seed=1)
        try:
            rec = ch.call("flightrec", idempotent=True)
            assert rec["schema"] == tracing.FLIGHT_SCHEMA
            assert "paddle_tpu.test.root" in [s["name"]
                                              for s in rec["spans"]]
            met = ch.call("metrics", idempotent=True)
            assert met["schema"] == telemetry.FLEET_SCHEMA
            assert met["role"] == "replica" and met["enabled"]
        finally:
            ch.close()
            tracing.disable()


# ---- RPC propagation (chaos) ----


@pytest.mark.chaos
class TestRpcPropagation:
    def test_client_server_one_trace(self, server):
        ch = rpc.RpcChannel(server.address, service="t", seed=1)
        try:
            tracing.enable()
            assert ch.call("health", idempotent=True) == \
                {"status": "serving"}
            tracing.disable()
        finally:
            ch.close()
        spans = tracing.flight_recorder.spans()
        assert sorted(s["name"] for s in spans) == [
            "paddle_tpu.rpc.client", "paddle_tpu.rpc.server"]
        client = next(s for s in spans
                      if s["name"] == "paddle_tpu.rpc.client")
        srv = next(s for s in spans if s["name"] == "paddle_tpu.rpc.server")
        assert srv["trace_id"] == client["trace_id"]
        assert srv["parent_id"] == client["span_id"]
        assert client["attrs"] == {"service": "t", "method": "health"}
        _assert_connected(spans)

    def test_retransmit_stays_one_trace(self, server):
        """The reply to a processed call is dropped; the channel
        retransmits: both server dispatches land in the one logical
        call's trace, under its one client span."""
        ch = rpc.RpcChannel(server.address, service="t", seed=1,
                            max_attempts=3)
        try:
            tracing.enable()
            with fault.scope("t.health.recv", drop=1.0, times=1):
                assert ch.call("health", idempotent=True) == \
                    {"status": "serving"}
            tracing.disable()
        finally:
            ch.close()
        spans = tracing.flight_recorder.spans()
        clients = [s for s in spans if s["name"] == "paddle_tpu.rpc.client"]
        servers = [s for s in spans if s["name"] == "paddle_tpu.rpc.server"]
        assert len(clients) == 1 and len(servers) == 2
        assert {s["trace_id"] for s in spans} == {clients[0]["trace_id"]}
        for s in servers:
            assert s["parent_id"] == clients[0]["span_id"]
        assert clients[0]["attrs"]["retries"] == 1
        _assert_connected(spans)

    def test_half_open_probe_carries_fresh_trace(self, server):
        br = rpc.CircuitBreaker("t", failure_threshold=1,
                                reset_timeout=0.05)
        ch = rpc.RpcChannel(server.address, service="t", seed=1,
                            max_attempts=1, breaker=br)
        try:
            tracing.enable()
            with fault.scope("t.connect", drop=1.0, times=1):
                with pytest.raises(rpc.RpcConnectionError):
                    ch.call("health", idempotent=True)
            assert br.state == rpc.OPEN
            time.sleep(0.06)
            assert ch.call("health", idempotent=True) == \
                {"status": "serving"}
            assert br.state == rpc.CLOSED
            tracing.disable()
        finally:
            ch.close()
        spans = tracing.flight_recorder.spans()
        clients = [s for s in spans if s["name"] == "paddle_tpu.rpc.client"]
        servers = [s for s in spans if s["name"] == "paddle_tpu.rpc.server"]
        assert len(clients) == 2 and len(servers) == 1
        failed = next(s for s in clients if "error" in s)
        probe = next(s for s in clients if "error" not in s)
        assert failed["trace_id"] != probe["trace_id"]
        assert servers[0]["parent_id"] == probe["span_id"]
        _assert_connected(spans)

    def test_sampled_out_call_records_nothing_anywhere(self, server):
        ch = rpc.RpcChannel(server.address, service="t", seed=1)
        try:
            tracing.enable(sample=0.0)
            assert ch.call("health", idempotent=True) == \
                {"status": "serving"}
            tracing.disable()
        finally:
            ch.close()
        assert tracing.flight_recorder.spans() == []


class TestServingTrace:
    def test_one_request_one_connected_trace(self):
        server = ServingServer(_port_engine(), max_delay_ms=1.0).start()
        try:
            tracing.enable()
            with ServingClient(server.address) as c:
                out = c.infer(
                    {"img": np.random.rand(1, 4).astype(np.float32)})
            tracing.disable()
            assert out[0].shape == (1, 2)
        finally:
            server.drain()
        spans = tracing.flight_recorder.spans()
        assert {s["name"] for s in spans} == {
            "paddle_tpu.serving.client_infer", "paddle_tpu.rpc.client",
            "paddle_tpu.rpc.server", "paddle_tpu.serving.queue_wait",
            "paddle_tpu.serving.batch_form", "paddle_tpu.serving.compute",
            "paddle_tpu.serving.engine_infer"}
        assert len({s["trace_id"] for s in spans}) == 1
        roots = [s for s in spans if s["parent_id"] is None]
        assert [r["name"] for r in roots] == \
            ["paddle_tpu.serving.client_infer"]
        _assert_connected(spans)
        comp = next(s for s in spans
                    if s["name"] == "paddle_tpu.serving.compute")
        assert comp["attrs"]["bucket"] == 1
        assert comp["attrs"]["pad_rows"] == 0
        eng = next(s for s in spans
                   if s["name"] == "paddle_tpu.serving.engine_infer")
        assert eng["attrs"]["bucket"] == 1

    def test_untraced_engine_call_spawns_no_orphan_trace(self):
        engine = _port_engine()
        tracing.enable()
        engine.infer({"img": np.random.rand(1, 4).astype(np.float32)})
        tracing.disable()
        assert tracing.flight_recorder.spans() == []


# ---- typed framing, breaker, deadlines, backoff ----


class TestRpcFraming:
    def test_clean_eof_returns_none(self):
        assert rpc.recv_msg(io.BytesIO(b"")) is None

    def test_partial_line_is_connection_error(self):
        with pytest.raises(rpc.RpcConnectionError):
            rpc.recv_msg(io.BytesIO(b'{"ok": tru'))

    def test_malformed_frame_is_connection_error_not_jsondecode(self):
        try:
            rpc.recv_msg(io.BytesIO(b"not json at all\n"))
        except json.JSONDecodeError:
            pytest.fail("json.JSONDecodeError leaked out of the transport")
        except rpc.RpcConnectionError:
            pass

    def test_error_family(self):
        for cls in (rpc.RpcConnectionError, rpc.RpcTimeout,
                    rpc.RpcRemoteError, rpc.CircuitOpenError):
            assert issubclass(cls, rpc.RpcError)
        assert issubclass(rpc.RpcConnectionError, ConnectionError)
        assert issubclass(rpc.RpcRemoteError, RuntimeError)
        assert issubclass(rpc.RpcTimeout, TimeoutError)

    def test_remote_error_is_typed_and_keeps_the_connection(self, server):
        ch = rpc.RpcChannel(server.address, service="t", seed=1)
        try:
            with pytest.raises(rpc.RpcRemoteError, match="unknown method"):
                ch.call("no_such_method", idempotent=True)
            assert ch.call("health", idempotent=True)["status"] == \
                "serving"
        finally:
            ch.close()


@pytest.mark.chaos
class TestCircuitBreaker:
    def test_state_machine_with_fake_clock(self):
        now = [0.0]
        br = rpc.CircuitBreaker(failure_threshold=2, reset_timeout=10.0,
                                clock=lambda: now[0])
        br.allow()
        br.record_failure()
        br.allow()
        br.record_failure()
        assert br.state == rpc.OPEN
        with pytest.raises(rpc.CircuitOpenError):
            br.allow()
        now[0] = 10.1
        br.allow()
        assert br.state == rpc.HALF_OPEN
        with pytest.raises(rpc.CircuitOpenError):
            br.allow()
        br.record_failure()
        assert br.state == rpc.OPEN
        now[0] = 20.2
        br.allow()
        br.record_success()
        assert br.state == rpc.CLOSED

    def test_half_open_probe_takeover_after_timeout(self):
        now = [0.0]
        br = rpc.CircuitBreaker(failure_threshold=1, reset_timeout=10.0,
                                clock=lambda: now[0])
        br.record_failure()
        now[0] = 10.1
        br.allow()
        with pytest.raises(rpc.CircuitOpenError):
            br.allow()
        now[0] = 20.2
        br.allow()
        br.record_success()
        assert br.state == rpc.CLOSED

    def test_unexpected_exception_resolves_probe(self, server):
        ch = rpc.RpcChannel(server.address, service="t", seed=1,
                            breaker=rpc.CircuitBreaker(
                                "t", failure_threshold=99))
        try:
            with pytest.raises(TypeError):       # json.dumps(bytes)
                ch.call("health", params={"x": b"\x00"})
            assert not ch.breaker._probing
            assert ch.call("health", idempotent=True)["status"] == \
                "serving"
        finally:
            ch.close()

    def test_expired_deadline_fails_before_connecting(self):
        ch = rpc.RpcChannel(("127.0.0.1", 1), service="t",
                            connect_timeout=30.0, max_attempts=1, seed=1)
        t0 = time.monotonic()
        with pytest.raises(rpc.RpcTimeout):
            ch.call("ping", idempotent=True, timeout=0.0)
        assert time.monotonic() - t0 < 1.0

    def test_breaker_trips_and_fast_fails_a_dead_peer(self):
        telemetry.enable()
        ch = rpc.RpcChannel(("127.0.0.1", 1), service="dead",
                            max_attempts=1, seed=1,
                            breaker=rpc.CircuitBreaker(
                                "dead", failure_threshold=2,
                                reset_timeout=60.0))
        for _ in range(2):
            with pytest.raises(rpc.RpcConnectionError):
                ch.call("health", idempotent=True)
        assert ch.breaker.state == rpc.OPEN
        with pytest.raises(rpc.CircuitOpenError):
            ch.call("health", idempotent=True)
        s = telemetry.summary()
        assert s["paddle_tpu_rpc_client_errors_total"] >= 2
        assert s["paddle_tpu_rpc_breaker_transitions_total"] >= 1


def _backoffs(seed):
    ch = rpc.RpcChannel(("127.0.0.1", 1), service="b", seed=seed,
                        backoff_base=0.01, backoff_max=1.0)
    return [ch._backoff(i) for i in range(6)]


def test_seeded_backoff_is_deterministic_and_bounded():
    a, b = _backoffs(3), _backoffs(3)
    assert a == b
    assert _backoffs(4) != a
    assert all(0.0 <= x <= 1.0 for x in a)


@pytest.mark.chaos
def test_retries_only_idempotent_calls(server):
    """A dropped reply is retried for an idempotent call and fails fast
    (typed) for one that is not."""
    telemetry.enable()
    ch = rpc.RpcChannel(server.address, service="t", seed=1,
                        max_attempts=3)
    try:
        with fault.scope("t.health.recv", drop=1.0, times=1):
            assert ch.call("health", idempotent=True)["status"] == \
                "serving"
        assert telemetry.summary()["paddle_tpu_rpc_retry_total"] == 1
        with fault.scope("t.health.recv", drop=1.0, times=1):
            with pytest.raises(rpc.RpcConnectionError):
                ch.call("health", idempotent=False)
    finally:
        ch.close()


# ---- one wire protocol for both packages ----


def test_a_port_client_and_a_jax_server_and_the_other_way_round():
    """The port's client infers against a JAX-package server, and the
    JAX package's client against a port server, with the same weights:
    the same answers at rtol 1e-5."""
    jscope = jfluid.Scope()
    jprog, jstart, jpred = _mlp(jfluid, jlayers, jnames)
    jfluid.Executor().run(jstart, scope=jscope)
    jinf = jfluid.io.get_inference_program([jpred], jprog)
    jeng = JEngine(jinf, ["img"], [jpred.name], scope=jscope, max_batch=2)

    tscope = tfluid.Scope()
    tprog, tstart, tpred = _mlp(tfluid, layers, tnames)
    interop.load_reference_state(
        {v.name: np.asarray(jscope.find_var(v.name))
         for v in jstart.list_vars() if v.persistable},
        tscope, CPU, tstart)
    tinf = tfluid.io.get_inference_program([tpred], tprog)
    teng = ServingEngine(tinf, ["img"], [tpred.name], scope=tscope,
                         max_batch=2, place=CPU)
    x = np.random.RandomState(0).rand(2, 4).astype(np.float32)
    jsrv = JServer(jeng, max_delay_ms=1).start()
    tsrv = ServingServer(teng, max_delay_ms=1).start()
    try:
        with ServingClient(jsrv.address) as c:
            assert c.ready()["ready"]
            from_jax = c.infer({"img": x})[0]
        with JClient(tsrv.address) as c:
            assert c.ready()["ready"]
            from_port = c.infer({"img": x})[0]
    finally:
        jsrv.drain()
        tsrv.drain()
    np.testing.assert_allclose(from_port, from_jax, rtol=1e-5, atol=1e-7)
