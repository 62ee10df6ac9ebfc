"""Serving front-end on the hardened line-JSON RPC channel.

Capability parity: the JAX package's ``serving/server.py`` (the same
wire protocol, so a port client talks to a JAX-package server and the
other way round), over the port's engine, batcher and decode loop.
Membership self-registration (``register``) and the deploy watcher
behind ``rpc_deploy`` are not ported: ``rpc_deploy`` answers its
no-watcher branch.

The network half of the serving vertical: the same typed-``RpcError``
framing, fault-injection sites, and ``serve_stream`` request loop the
master/pserver/membership services run on, so every transport
failure mode the chaos suite exercises there holds here too.

Wire protocol (one JSON object per line, like every other service;
arrays ride as base64 raw bytes + dtype/shape — the same scheme the
pserver uses on this channel, exactly bitwise and ~10x smaller than
JSON floats; a plain nested-list ``"data"`` field is accepted too for
hand-written clients):

    {"method": "infer",  "params": {"inputs": {name: {"b64": "...",
        "dtype": "float32", "shape": [1, 784]}}, "deadline_ms": 250}}
    -> {"ok": true, "result": {"outputs": [{"b64": ..., "dtype": ...,
        "shape": [...]}]}}
    {"method": "health"} -> {"status": "serving" | "draining"}
    {"method": "ready"}  -> {"ready": bool}   (true only after warmup)

Overload, deadline, and request-shape failures surface as application
errors whose message is prefixed ``Overloaded:`` / ``DeadlineExceeded:``
/ ``BatchTooLarge:`` — the ``ServingClient`` maps them back to the
typed exceptions, so a caller distinguishes "shed load, back off" from
"slow down the deadline" from "this request can never fit, split it"
from a transport failure without parsing free text.

Graceful drain (``drain()``, wired to SIGTERM by ``paddle_tpu serve``):
readiness flips false, the listener stops accepting, the batcher
flushes every admitted request, THEN open connections are torn down —
an in-flight request admitted before the signal always gets its answer.
"""

import base64
import socket
import socketserver
import threading
import time
import warnings
from concurrent.futures import TimeoutError as _FutureTimeout

import numpy as np

from paddle_tpu_torch import fault
from paddle_tpu_torch import tracing
from paddle_tpu_torch.distributed import rpc
from paddle_tpu_torch.serving.batcher import (Closed, DeadlineExceeded,
                                              DynamicBatcher, Overloaded)
from paddle_tpu_torch.serving.engine import BatchTooLarge

__all__ = ["ServingServer", "ServingClient"]


def _encode(arr):
    """base64 raw bytes + dtype/shape — the pserver's array scheme on
    this channel: exactly bitwise, ~10x smaller than JSON floats."""
    arr = np.ascontiguousarray(arr)
    return {"b64": base64.b64encode(arr.tobytes()).decode("ascii"),
            "dtype": str(arr.dtype), "shape": list(arr.shape)}


def _decode(obj):
    if "b64" in obj:
        arr = np.frombuffer(base64.b64decode(obj["b64"]),
                            dtype=obj.get("dtype", "float32"))
    else:  # hand-written clients may send plain nested lists
        arr = np.asarray(obj["data"], dtype=obj.get("dtype", "float32"))
    if "shape" in obj:
        arr = arr.reshape(obj["shape"])
    return arr


class ServingServer(rpc.FederationRpcMixin):
    """``ServingServer(engine, address=("127.0.0.1", 0)).start()`` —
    owns a ``DynamicBatcher`` over the engine (or accepts a pre-built
    one via ``batcher=``). ``.address`` is the bound endpoint.

    Answers the fleet federation endpoints (``rpc_metrics`` /
    ``rpc_flightrec``) on the same channel as ``infer``, so the
    FleetCollector scrapes replicas without a second listener."""

    fleet_role = "replica"

    def __init__(self, engine=None, address=("127.0.0.1", 0),
                 batcher=None, service="serving", max_batch=None,
                 max_delay_ms=5.0, max_queue=128, result_timeout=300.0,
                 decoder=None, deadline_slack=5.0):
        if batcher is None and engine is not None:
            batcher = DynamicBatcher(engine, max_batch=max_batch,
                                     max_delay_ms=max_delay_ms,
                                     max_queue=max_queue, name=service)
        if batcher is None and decoder is None:
            raise ValueError("pass an engine, a batcher, or a decoder")
        self.batcher = batcher
        #: the continuous-batching decode loop behind ``generate``
        #: (serving/decode.DecodeLoop); None = one-shot inference only
        self.decoder = decoder
        if engine is not None:
            self.engine = engine
        elif batcher is not None:
            self.engine = batcher.engine
        else:
            self.engine = decoder.engine
        self.service = service
        # server-side cap on a deadline-LESS request's wait (a stuck
        # dispatcher must not pin handler threads forever); requests
        # with a deadline use their own
        self._result_timeout = float(result_timeout)
        # how long past a request's OWN deadline a handler keeps
        # waiting for the decode loop's step boundary — mirrors the
        # RpcClient's reply slack: past deadline + slack the client has
        # already given up, so waiting any longer only pins the handler
        self._deadline_slack = float(deadline_slack)
        self._stop = threading.Event()
        self._draining = False
        self._drained = False
        self._drain_lock = threading.Lock()
        # in-flight request accounting (dispatch THROUGH reply write):
        # drain() waits on it, so a computed answer is never cut off by
        # process exit mid-serialization
        self._inflight = 0
        self._inflight_cv = threading.Condition()

        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                rpc.serve_stream(outer, outer.service, self.rfile,
                                 self.connection, outer._stop)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server(tuple(address), Handler)
        self.address = self._server.server_address

    # ---- serve_stream hooks: in-flight accounting ----

    def _handle_request(self, req):
        with self._inflight_cv:
            self._inflight += 1
        try:
            return rpc.dispatch(self, self.service, req)
        except BaseException:
            # dispatch never raises in practice; if it ever does, the
            # reply hook won't run — release the slot here
            with self._inflight_cv:
                self._inflight -= 1
                self._inflight_cv.notify_all()
            raise

    def _reply_sent(self, req):
        with self._inflight_cv:
            self._inflight -= 1
            self._inflight_cv.notify_all()

    # ---- lifecycle ----

    def start(self, warmup=True):
        """Start answering, THEN warm every bucket: health/readiness
        answer immediately (``ready`` false, infer refused with
        ``Overloaded: warming up``) instead of hanging in the listen
        backlog for the duration of a long warmup; ``start`` returns
        once the last bucket compiled, so a balancer that waits for
        ``ready`` never routes to a cold replica."""
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="serving-server")
        self._thread.start()
        if warmup and not self.engine.ready:
            self.engine.warmup()
        return self

    def drain(self, timeout=30.0):
        """Graceful SIGTERM path: stop admitting (readiness false, new
        submits refused), flush every in-flight batch, then stop the
        listener. Idempotent — and re-runnable: a
        drain interrupted by a (real or injected) preemption marks
        nothing complete, so the retry still flushes and closes."""
        with self._drain_lock:
            if self._drained:
                return
            self._draining = True  # readiness flips false immediately
            if fault._active:
                # the preemption-during-drain chaos seam: an injected
                # Preemption here must not lose an admitted request
                fault.fire(self.service + ".drain")
            if self.batcher is not None and \
                    not self.batcher.close(drain=True, timeout=timeout):
                # admitted requests are still flushing: refusing to
                # report a clean drain (exiting now would strand them);
                # the dispatcher keeps running — retry drain()
                raise RuntimeError(
                    "drain timed out after %.1fs with admitted requests "
                    "still in flight; retry drain()" % timeout)
            if self.decoder is not None and \
                    not self.decoder.close(drain=True, timeout=timeout):
                # same contract for admitted GENERATIONS: each finishes
                # within its own termination bounds; a flush still
                # running past the timeout is retried, never stranded
                raise RuntimeError(
                    "drain timed out after %.1fs with generations still "
                    "in flight; retry drain()" % timeout)
            # every future resolved; now wait for the handler threads to
            # finish WRITING the replies — a computed answer cut off by
            # process exit mid-serialization is still a lost request
            deadline = time.monotonic() + timeout
            with self._inflight_cv:
                while self._inflight > 0:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise RuntimeError(
                            "drain timed out with %d reply write(s) "
                            "still in flight; retry drain()"
                            % self._inflight)
                    self._inflight_cv.wait(remaining)
            self._stop.set()
            self._server.shutdown()
            self._server.server_close()
            self._drained = True

    def shutdown(self, timeout=30.0):
        self.drain(timeout=timeout)

    # ---- RPC methods (dispatched by rpc.serve_stream) ----

    def rpc_infer(self, inputs=None, deadline_ms=None):
        if fault._active:
            fault.fire(self.service + ".handler")
        if not self.engine.ready or self._draining:
            raise Overloaded("Overloaded: replica not ready (%s)"
                             % ("draining" if self._draining
                                else "warming up"))
        if self.batcher is None:
            raise Overloaded("Overloaded: this replica serves generate "
                             "only (no one-shot infer engine)")
        feed = {k: _decode(v) for k, v in (inputs or {}).items()}
        timeout = (float(deadline_ms) / 1000.0) if deadline_ms else None
        try:
            fut = self.batcher.submit(feed, timeout=timeout)
        except Closed:
            raise Overloaded("Overloaded: draining")
        except BatchTooLarge as e:
            # a permanent request-shape verdict, typed across the wire
            # (never Overloaded: retrying elsewhere can't make it fit)
            raise BatchTooLarge("BatchTooLarge: %s" % e)
        try:
            outs = fut.result(
                timeout=timeout if timeout else self._result_timeout)
        except DeadlineExceeded:
            raise DeadlineExceeded(
                "DeadlineExceeded: %s ms elapsed in queue" % deadline_ms)
        except (TimeoutError, _FutureTimeout):
            # concurrent.futures.TimeoutError is NOT the builtin
            # TimeoutError before py3.11 — catch both
            if timeout:
                raise DeadlineExceeded(
                    "DeadlineExceeded: no result within the request's "
                    "%s ms deadline" % deadline_ms)
            # the CLIENT set no deadline; hitting the server-side cap
            # is a replica-overload signal, not a deadline the caller
            # never asked for
            raise Overloaded(
                "Overloaded: no result within the server cap (%.0fs)"
                % self._result_timeout)
        return {"outputs": [_encode(o) for o in outs]}

    def rpc_generate(self, tokens=None, max_new_tokens=32, eos_id=None,
                     deadline_ms=None):
        """Autoregressive generation (SERVING.md §Autoregressive
        decoding): one prompt in, the generated token ids + finish
        reason out. The deadline spans the WHOLE generation — the
        decode loop terminates the generation AT the deadline and this
        returns the partial output with reason ``"deadline"`` (a typed
        ``DeadlineExceeded`` surfaces only when not even a slot freed
        in time). Re-sending the same prompt is a re-prefill — greedy
        decoding makes the retry idempotent, which is exactly what the
        router's failover leans on."""
        if fault._active:
            fault.fire(self.service + ".handler")
        if self.decoder is None:
            raise Overloaded("Overloaded: this replica has no decode "
                             "loop (one-shot infer only)")
        if not self.decoder.engine.ready or self._draining:
            raise Overloaded("Overloaded: replica not ready (%s)"
                             % ("draining" if self._draining
                                else "warming up"))
        prompt = np.asarray(tokens or [], np.int64).reshape(-1)
        timeout = (float(deadline_ms) / 1000.0) if deadline_ms else None
        try:
            gen = self.decoder.submit(prompt,
                                      max_new_tokens=int(max_new_tokens),
                                      eos_id=eos_id, timeout=timeout)
        except Closed:
            raise Overloaded("Overloaded: draining")
        except BatchTooLarge as e:
            # prompt past the bucket ladder / no cache room: a
            # permanent request-shape verdict, typed across the wire
            raise BatchTooLarge("BatchTooLarge: %s" % e)
        try:
            # slack past the deadline: the loop itself finishes the
            # generation AT the deadline; the extra second only covers
            # scheduling jitter before this thread observes it
            out, reason = gen.result(
                timeout=(timeout + 1.0) if timeout
                else self._result_timeout)
        except DeadlineExceeded:
            raise DeadlineExceeded(
                "DeadlineExceeded: %s ms elapsed before a decode slot "
                "freed" % deadline_ms)
        except TimeoutError:
            if not timeout:
                gen.cancel()
                raise Overloaded(
                    "Overloaded: generation not finished within the "
                    "server cap (%.0fs)" % self._result_timeout)
            # the loop terminates the generation AT the deadline; a
            # dispatch spanning it only defers the step boundary past
            # the 1s jitter slack. Keep waiting — but only by the
            # deadline SLACK, not the full server cap: past deadline +
            # slack the client has already torn down the call (the
            # RpcClient budget is deadline + its own slack), so a
            # 300s wait here would pin a handler thread for a reply
            # nobody reads.
            grace = min(self._deadline_slack, self._result_timeout)
            try:
                out, reason = gen.result(timeout=grace)
            except TimeoutError:
                gen.cancel()
                raise DeadlineExceeded(
                    "DeadlineExceeded: generation not finished within "
                    "the request's %s ms deadline plus the %.0fs "
                    "slack" % (deadline_ms, grace))
        return {"tokens": [int(t) for t in out],
                "finish_reason": reason,
                "prompt_len": int(prompt.size)}

    def rpc_health(self):
        return {"status": "draining" if self._draining else "serving"}

    def rpc_ready(self):
        return {"ready": bool(self.engine.ready and not self._draining),
                "buckets": list(self.engine.buckets),
                "compiled": self.engine.compile_count(),
                "generation": getattr(self.engine,
                                      "deploy_generation", None)}

    def rpc_deploy(self, generation=None):
        """Admin: the deploy plane of THIS replica. With no params,
        report the serving generation and watcher state; with
        ``generation``, swap to exactly that generation — the canary
        path (the SERVING pin moves only on promotion, so stable
        replicas are untouched)."""
        w = getattr(self, "deploy_watcher", None)
        if w is None:
            return {"generation": getattr(self.engine,
                                          "deploy_generation", None),
                    "watching": False}
        if generation is None:
            return {"generation": w.generation, "watching": True}
        ok = w.swap_to_generation(int(generation))
        return {"ok": bool(ok), "generation": w.generation,
                "watching": True}

    def rpc_drain(self):
        """Admin: start a graceful drain WITHOUT blocking this handler
        thread (drain waits for every in-flight reply write — including
        this call's own — so draining inline would deadlock). The
        caller polls ``health`` until the listener closes; a drain that
        times out retries itself on the next ``rpc_drain``."""
        if not self._drained:
            # each call (re)tries the drain: drain() is idempotent and
            # re-runnable, and concurrent attempts serialize on the
            # drain lock — a timed-out earlier flush gets retried here
            t = threading.Thread(target=self._drain_quietly, daemon=True,
                                 name="serving-drain-%s" % self.service)
            t.start()
        return {"draining": True}

    def _drain_quietly(self):
        try:
            self.drain()
        except RuntimeError as e:
            # admitted requests still flushing past the timeout: the
            # dispatcher keeps running, a later drain/rpc_drain retries
            warnings.warn("background drain incomplete: %s" % e,
                          RuntimeWarning)


def _address_list(address):
    """One endpoint or many: a ``"host:port"`` string, a ``(host,
    port)`` pair, or a list/tuple of either — the ROUTER LIST a fleet
    client fails over across."""
    if isinstance(address, str):
        return [address]
    if isinstance(address, (list, tuple)):
        if (len(address) == 2 and isinstance(address[0], str)
                and isinstance(address[1], int)):
            return [tuple(address)]
        return [a if isinstance(a, str) else tuple(a) for a in address]
    return [address]


class ServingClient:
    """Typed client over ``RpcChannel``: ``infer`` sends one request
    (arrays in, arrays out), re-raising remote ``Overloaded`` /
    ``DeadlineExceeded`` as the local exception types.

    Retry taxonomy: ``infer`` is stateless and idempotent, so a
    CONNECTION LOSS (peer vanished, EOF mid-frame, reset) is safe to
    retry and rides the channel's bounded retries transparently. The
    typed application verdicts — ``Overloaded`` (shed load, go
    elsewhere) and ``DeadlineExceeded`` (the request's budget is gone)
    — surface immediately and are never retried here: retrying an
    overloaded box amplifies the overload, and a dead deadline stays
    dead. The deadline budget spans the WHOLE retry sequence, not each
    attempt: ``deadline_ms`` (plus ``deadline_slack`` for the reply to
    travel) caps the channel's overall deadline, and a transport
    timeout past it surfaces as ``DeadlineExceeded``.

    ``address`` may be a LIST of endpoints (replicated routers): the
    client holds one channel per router and applies the SAME taxonomy
    across them — a transport failure (connection loss, hang-bound
    timeout with budget remaining, open breaker) moves to the next
    router and the survivor becomes the new primary; the typed
    application verdicts surface immediately because any router would
    answer the same. The deadline budget spans the whole cross-router
    sequence too."""

    def __init__(self, address, call_timeout=60.0, deadline_slack=5.0,
                 generate_timeout=330.0, **channel_kw):
        self._chs = [rpc.RpcChannel(a, service="serving",
                                    call_timeout=call_timeout,
                                    **channel_kw)
                     for a in _address_list(address)]
        self._primary = 0
        #: cross-endpoint failovers performed (plain counter for tests;
        #: the channels' telemetry carries the operator-facing errors)
        self.failovers = 0
        self._call_timeout = call_timeout
        self._deadline_slack = float(deadline_slack)
        # a generation legitimately runs for minutes, so ``generate``'s
        # hang bound must be generation-scale, not ``infer``-scale: the
        # default covers the server's deadline-less result cap (300s)
        # plus reply travel. None falls back to ``call_timeout``.
        self._generate_timeout = generate_timeout

    @property
    def _ch(self):
        """The current primary channel (kept for single-endpoint
        callers and tests that reach into the transport)."""
        return self._chs[self._primary]

    def _call_failover(self, method, params=None, idempotent=True,
                       timeout=None, budget_end=None):
        """One call, tried across every endpoint starting at the
        primary. Transport verdicts rotate to the next endpoint while
        deadline budget remains; whoever answers becomes the new
        primary. With one endpoint this is exactly ``channel.call``."""
        n = len(self._chs)
        last = None
        for i in range(n):
            idx = (self._primary + i) % n
            t = timeout
            if budget_end is not None:
                remaining = budget_end - time.monotonic()
                if remaining <= 0 and last is not None:
                    break  # no budget left for another endpoint
                if remaining > 0:
                    t = remaining if t is None else min(t, remaining)
            try:
                out = self._chs[idx].call(method, params,
                                          idempotent=idempotent,
                                          timeout=t)
            except (rpc.RpcConnectionError, rpc.RpcTimeout,
                    rpc.CircuitOpenError) as e:
                last = e
                if n > 1:
                    self.failovers += 1
                continue
            self._primary = idx
            return out
        raise last

    def infer(self, feed, deadline_ms=None):
        # the trace ROOT of a serving request: everything downstream —
        # the rpc client/server spans, the batcher's queue-wait and
        # batch-form, the engine's bucket dispatch — joins this trace
        # through the channel's context propagation
        with tracing.span("paddle_tpu.serving.client_infer"):
            res = self._call_typed(
                "infer", {"inputs": {k: _encode(v)
                                     for k, v in feed.items()}},
                deadline_ms)
        return [_decode(o) for o in res["outputs"]]

    def _call_typed(self, method, params, deadline_ms,
                    hang_timeout=None):
        """One deadline-budgeted idempotent call with the typed
        ``Overloaded`` / ``DeadlineExceeded`` / ``BatchTooLarge``
        mapping — shared by ``infer`` and ``generate``.
        ``hang_timeout`` overrides the channel's ``call_timeout`` as
        the hang bound for calls whose legitimate duration outgrows it
        (a generation)."""
        hang = self._call_timeout if hang_timeout is None \
            else hang_timeout
        timeout = hang if hang != self._call_timeout else None
        budget_end = None
        if deadline_ms:
            params["deadline_ms"] = float(deadline_ms)
            # overall budget across every retry attempt: the server
            # answers a typed DeadlineExceeded AT the deadline, so the
            # slack only needs to cover the reply's travel time. The
            # channel's call_timeout stays the HANG bound — a deadline
            # longer than it must not extend how long one dead/hung
            # server can pin this call (a router needs the RpcTimeout
            # back while budget remains, to fail over)
            budget = float(deadline_ms) / 1000.0 + self._deadline_slack
            timeout = budget if hang is None else min(budget, hang)
            budget_end = time.monotonic() + budget
        try:
            res = self._call_failover(method, params, idempotent=True,
                                      timeout=timeout,
                                      budget_end=budget_end)
        except rpc.RpcRemoteError as e:
            msg = str(e)
            if "Overloaded:" in msg:
                raise Overloaded(msg)
            if "DeadlineExceeded:" in msg:
                raise DeadlineExceeded(msg)
            if "BatchTooLarge:" in msg:
                raise BatchTooLarge(msg)
            raise
        except rpc.RpcTimeout as e:
            if budget_end is not None and time.monotonic() >= budget_end:
                # the transport burned the request's own budget: that
                # IS a deadline verdict, typed like the server's
                raise DeadlineExceeded(
                    "DeadlineExceeded: %s ms budget (plus %.1fs slack) "
                    "spent across retries: %s"
                    % (deadline_ms, self._deadline_slack, e))
            # hang bound hit with budget remaining: surface the
            # transport verdict so a failover tier can go elsewhere
            raise
        return res

    def generate(self, tokens, max_new_tokens=32, eos_id=None,
                 deadline_ms=None):
        """One autoregressive generation: returns ``(tokens,
        finish_reason)``. Greedy decoding is deterministic, so a
        connection-loss retry (a re-prefill on the same or another
        replica) reproduces the same output — ``generate`` therefore
        rides the channel's idempotent retries exactly like ``infer``;
        the typed ``Overloaded`` / ``DeadlineExceeded`` verdicts
        surface immediately, never retried here."""
        hang = self._generate_timeout
        if deadline_ms and hang is not None:
            # the hang bound protects against a DEAD replica; a healthy
            # generation legitimately runs to its deadline, so an
            # explicit longer budget extends the bound, never the
            # reverse (min() would kill a progressing generation early)
            hang = max(hang,
                       float(deadline_ms) / 1000.0 + self._deadline_slack)
        with tracing.span("paddle_tpu.decode.generate"):
            res = self._call_typed(
                "generate",
                {"tokens": [int(t) for t in np.asarray(tokens).reshape(-1)],
                 "max_new_tokens": int(max_new_tokens),
                 "eos_id": None if eos_id is None else int(eos_id)},
                deadline_ms, hang_timeout=hang)
        return list(res["tokens"]), res["finish_reason"]

    def health(self):
        return self._call_failover("health", idempotent=True)

    def ready(self):
        return self._call_failover("ready", idempotent=True)

    def drain(self):
        """Ask the server to start a graceful background drain
        (idempotent; poll ``health`` until the listener closes). An
        ADMIN verb: always sent to the current primary endpoint only —
        failing a drain order over to a different box would drain the
        wrong one."""
        return self._ch.call("drain", idempotent=True)

    def abort(self):
        """Tear down the transport out from under an in-flight call —
        the router's hedge-loser cancellation. ``shutdown`` wakes a
        thread blocked in ``recv`` with EOF, which surfaces as a typed
        ``RpcConnectionError`` on that thread; the channel itself
        reconnects lazily if reused."""
        for ch in self._chs:
            sock = ch._sock
            if sock is not None:
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass

    def close(self):
        for ch in self._chs:
            ch.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
