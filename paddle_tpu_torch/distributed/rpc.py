"""Hardened line-JSON RPC shared by master / pserver / membership.

A copy of the JAX package's ``distributed/rpc.py`` (which imports no
JAX), over this package's ``fault``, ``telemetry`` and ``tracing``: the
same frames, typed errors, retries, breaker and metric names, so a port
client talks to a JAX-package server and the other way round.

One transport, extracted from the three hand-rolled clients those
services grew independently. The wire format is unchanged (one JSON
object per line, ``{"method", "params"}`` -> ``{"ok", "result"|"error"}``)
so old clients interoperate; what changes is everything around it:

* **Typed errors.** EOF mid-frame, a malformed line, or a vanished peer
  raise ``RpcConnectionError``; per-call deadline overruns raise
  ``RpcTimeout``; a server-side exception raises ``RpcRemoteError``
  (subclassing ``RuntimeError``, which is what the old clients threw);
  a tripped breaker raises ``CircuitOpenError``. All derive from
  ``RpcError``, so callers can catch the whole family — and
  ``json.JSONDecodeError`` never leaks out of the transport again.
* **Per-call deadlines** (connect + socket timeout budgeted across
  retries), **exponential backoff with full jitter** (per-channel
  entropy by default so a client fleet never retries in lockstep;
  ``seed=`` pins the sequence for deterministic tests), and **bounded
  retries of idempotent calls only** — a non-idempotent call fails
  fast on the first connection error.
* **Circuit breaker** per channel (or shared across channels via the
  ``breaker=`` argument): ``failure_threshold`` consecutive transport
  failures trip it OPEN (calls fast-fail without touching the network);
  after ``reset_timeout`` it HALF-OPENs one probe; probe success closes
  it, probe failure re-opens it. Remote application errors do NOT count
  — the server answered, the circuit is healthy.
* **Telemetry**: ``paddle_tpu_rpc_retry_total``,
  ``paddle_tpu_rpc_client_errors_total``,
  ``paddle_tpu_rpc_breaker_state_count``,
  ``paddle_tpu_rpc_breaker_transitions_total`` (see OBSERVABILITY.md).
* **Fault injection** (``fault.py``) at ``<service>.<method>``
  plus ``.connect`` / ``.send`` / ``.recv`` sub-sites; one branch per
  call when the harness is idle.

The server half shares ``serve_stream``/``dispatch``: the per-connection
request loop every service's handler delegates to.
"""

import json
import random
import socket
import threading
import time

from paddle_tpu_torch import fault
from paddle_tpu_torch import telemetry
from paddle_tpu_torch import tracing

__all__ = ["RpcError", "RpcConnectionError", "RpcTimeout",
           "RpcRemoteError", "CircuitOpenError", "CircuitBreaker",
           "RpcChannel", "send_msg", "recv_msg", "serve_stream",
           "dispatch", "FederationRpcMixin"]


class RpcError(Exception):
    """Base of every error the RPC tier raises."""


class RpcConnectionError(RpcError, ConnectionError):
    """Peer vanished: EOF mid-frame, malformed frame, reset, failed
    connect. Safe to retry for idempotent calls."""


class RpcTimeout(RpcError, TimeoutError):
    """A per-call deadline elapsed."""


class RpcRemoteError(RpcError, RuntimeError):
    """The server dispatched the call and raised; carries the remote
    message. NOT a transport failure — the connection stays usable."""


class CircuitOpenError(RpcError):
    """The circuit breaker is open: failing fast without touching the
    network. Retry after the breaker's reset timeout."""


# ---- framing ----

def send_msg(sock, obj, site=None):
    """One line-JSON frame. ``site`` is the fault-injection point for
    partial-write/drop rules (one branch when the harness is idle)."""
    data = (json.dumps(obj) + "\n").encode()
    if fault._active and site is not None:
        fault.sendall(sock, data, site)
    else:
        sock.sendall(data)


def recv_msg(file, site=None):
    """Read one frame. Returns the decoded object, or None on CLEAN EOF
    (peer closed between frames). A partial line (peer died mid-write)
    or an undecodable line raises ``RpcConnectionError`` — never
    ``json.JSONDecodeError``."""
    if fault._active and site is not None:
        fault.fire(site)
    line = file.readline()
    if not line:
        return None
    if not line.endswith(b"\n" if isinstance(line, bytes) else "\n"):
        raise RpcConnectionError(
            "connection closed mid-frame (%d-byte partial line)"
            % len(line))
    try:
        return json.loads(line)
    except ValueError as e:
        raise RpcConnectionError("malformed RPC frame: %s" % e)


# ---- circuit breaker ----

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"
_STATE_CODE = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}


class CircuitBreaker:
    """Consecutive-failure breaker with timed half-open probing.

    Thread-safe; may be shared by several channels talking to the same
    endpoint so one client's failures protect the others."""

    def __init__(self, service="rpc", failure_threshold=5,
                 reset_timeout=30.0, clock=time.monotonic):
        self.service = service
        self.failure_threshold = failure_threshold
        self.reset_timeout = reset_timeout
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probing = False
        self._probe_started = 0.0

    @property
    def state(self):
        with self._lock:
            return self._state

    def _transition(self, to):
        # caller holds the lock
        if to == self._state:
            return
        self._state = to
        if telemetry.enabled():
            telemetry.set_breaker_state(self.service, _STATE_CODE[to])
            telemetry.record_breaker_transition(self.service, to)

    def allow(self):
        """Gate one call attempt. Raises ``CircuitOpenError`` while open
        (or while a half-open probe is already in flight)."""
        with self._lock:
            if self._state == OPEN:
                if self._clock() - self._opened_at < self.reset_timeout:
                    raise CircuitOpenError(
                        "%s circuit open (%d consecutive failures; "
                        "retry in %.3gs)"
                        % (self.service, self._failures,
                           self.reset_timeout
                           - (self._clock() - self._opened_at)))
                self._transition(HALF_OPEN)
                self._probing = False
            if self._state == HALF_OPEN:
                # a probe whose caller died without reporting back (an
                # exception outside the RPC error paths) must not wedge
                # the breaker half-open forever: after reset_timeout the
                # next caller takes the probe over
                if self._probing and (self._clock() - self._probe_started
                                      < self.reset_timeout):
                    raise CircuitOpenError(
                        "%s circuit half-open: probe already in flight"
                        % self.service)
                self._probing = True
                self._probe_started = self._clock()

    def record_success(self):
        with self._lock:
            self._failures = 0
            self._probing = False
            self._transition(CLOSED)

    def record_failure(self):
        with self._lock:
            self._failures += 1
            self._probing = False
            if (self._state == HALF_OPEN
                    or self._failures >= self.failure_threshold):
                self._opened_at = self._clock()
                self._transition(OPEN)

    def abort_probe(self):
        """The attempt resolved without a transport verdict (a
        client-side bug raised before the network was touched): free the
        half-open probe slot without counting a consecutive failure — a
        deterministic caller bug must not report the endpoint down."""
        with self._lock:
            self._probing = False


# ---- client channel ----

class RpcChannel:
    """Persistent client connection with deadlines, bounded retries of
    idempotent calls (exponential backoff, deterministic jitter), and a
    circuit breaker. One socket, calls serialized; reconnects lazily
    after any transport failure."""

    def __init__(self, address, service="rpc", connect_timeout=10.0,
                 call_timeout=None, max_attempts=3, backoff_base=0.05,
                 backoff_max=2.0, breaker=None, seed=None):
        if isinstance(address, str):
            host, port = address.rsplit(":", 1)
            address = (host, int(port))
        self._addr = tuple(address)
        self.service = service
        self._connect_timeout = connect_timeout
        self._call_timeout = call_timeout
        self._max_attempts = max(1, int(max_attempts))
        self._backoff_base = backoff_base
        self._backoff_max = backoff_max
        self.breaker = breaker if breaker is not None else CircuitBreaker(
            service=service)
        # seed=None (default): system entropy, so every channel in a
        # trainer fleet jitters independently; explicit seed: pinned
        # backoff sequence for deterministic chaos tests
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._sock = None
        self._file = None

    # -- socket lifecycle (call with self._lock held) --

    def _ensure(self, deadline=None):
        if self._sock is None:
            if fault._active:
                fault.fire(self.service + ".connect")
            timeout = self._connect_timeout
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise RpcTimeout("%s: deadline exceeded before connect"
                                     % self.service)
                timeout = min(timeout, remaining)
            try:
                self._sock = socket.create_connection(self._addr, timeout)
            except socket.timeout as e:
                raise RpcTimeout("%s connect: %s" % (self.service, e))
            self._sock.settimeout(self._call_timeout)
            self._file = self._sock.makefile("rb")

    def _drop_connection(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
            self._file = None

    def _backoff(self, attempt):
        # full jitter over an exponential ladder, seeded => deterministic
        hi = min(self._backoff_max, self._backoff_base * (2 ** attempt))
        return hi * (0.5 + 0.5 * self._rng.random())

    # -- the call path --

    def call(self, method, params=None, idempotent=False, timeout=None):
        """One RPC. Non-idempotent calls get exactly one attempt;
        idempotent calls up to ``max_attempts`` with backoff, budgeted
        against ``timeout`` (falling back to the channel's
        ``call_timeout``) as an overall deadline.

        Tracing: ONE client span per *logical* call; every retry
        attempt injects the SAME context into the frame's reserved
        ``trace`` field, so retransmits land in one trace with the
        server-side spans all parented to this span (never orphaned or
        duplicated ids — chaos-pinned in tests/test_tracing.py)."""
        if not tracing.enabled():
            return self._call(method, params, idempotent, timeout,
                              None, None)
        with tracing.span("paddle_tpu.rpc.client", service=self.service,
                          method=str(method)) as sp:
            return self._call(method, params, idempotent, timeout,
                              tracing.inject(), sp)

    def _call(self, method, params, idempotent, timeout, trace, sp):
        site = "%s.%s" % (self.service, method)
        budget = self._call_timeout if timeout is None else timeout
        deadline = None if budget is None else time.monotonic() + budget
        attempts = self._max_attempts if idempotent else 1
        last_err = None
        for attempt in range(attempts):
            try:
                self.breaker.allow()
            except CircuitOpenError:
                if telemetry.enabled():
                    telemetry.record_rpc_client_error(
                        self.service, "circuit_open")
                raise
            try:
                result = self._attempt(method, params, site, deadline,
                                       trace)
            except RpcRemoteError:
                # the server answered: circuit healthy, nothing to retry
                self.breaker.record_success()
                if telemetry.enabled():
                    telemetry.record_rpc_client_error(self.service,
                                                      "remote")
                raise
            except (fault.FaultInjected, RpcError, OSError) as e:
                self.breaker.record_failure()
                with self._lock:
                    self._drop_connection()
                last_err = e
                if attempt + 1 < attempts:
                    pause = self._backoff(attempt)
                    if deadline is not None and \
                            time.monotonic() + pause >= deadline:
                        break  # no budget left for another attempt
                    if telemetry.enabled():
                        telemetry.record_rpc_retry(self.service, method)
                    if sp is not None:
                        sp.set_attr("retries", attempt + 1)
                    time.sleep(pause)
                continue
            except Exception:
                # unexpected failure (e.g. unserializable params): not a
                # transport verdict, so don't count it against the
                # breaker — but the probe slot must still be freed or a
                # half-open probe would stay "in flight" forever
                self.breaker.abort_probe()
                with self._lock:
                    self._drop_connection()
                raise
            else:
                self.breaker.record_success()
                return result
        kind = "timeout" if isinstance(
            last_err, (socket.timeout, RpcTimeout)) else "connection"
        if telemetry.enabled():
            telemetry.record_rpc_client_error(self.service, kind)
        if kind == "timeout":
            raise RpcTimeout("%s deadline exceeded: %s" % (site, last_err))
        raise RpcConnectionError("%s failed after %d attempt(s): %s"
                                 % (site, attempts, last_err))

    def _attempt(self, method, params, site, deadline, trace=None):
        frame = {"method": method, "params": params or {}}
        if trace is not None:
            # reserved field: one context per LOGICAL call, identical
            # across retransmits (old servers ignore unknown keys)
            frame["trace"] = trace
        with self._lock:
            self._ensure(deadline)
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise RpcTimeout("%s: deadline exceeded before send"
                                     % site)
                self._sock.settimeout(remaining)
            try:
                if fault._active:
                    fault.fire(site)
                send_msg(self._sock, frame, site=site + ".send")
                resp = recv_msg(self._file, site=site + ".recv")
            except socket.timeout as e:
                raise RpcTimeout("%s: %s" % (site, e))
            finally:
                if deadline is not None and self._sock is not None:
                    self._sock.settimeout(self._call_timeout)
        if resp is None:
            raise RpcConnectionError("%s: server closed the connection"
                                     % site)
        if not resp.get("ok"):
            raise RpcRemoteError("%s error: %s"
                                 % (self.service, resp.get("error")))
        return resp.get("result")

    def close(self):
        with self._lock:
            self._drop_connection()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---- fleet federation endpoints ----

class FederationRpcMixin:
    """``rpc_metrics`` / ``rpc_flightrec`` — the two federation
    endpoints of the fleet observability plane, answered on the SAME
    line-JSON channel a service already serves (no extra port, no
    extra listener). Mixed into every server class whose handler
    delegates to ``serve_stream``: ServingServer, RouterServer,
    MembershipServer, MasterServer, PserverServer.

    ``fleet_role`` is the coarse role the rollup labels series with
    (replica / router / membership / master / pserver); the process-
    unique proc name is the server's ``service`` when it has one."""

    fleet_role = "proc"

    def _fleet_proc(self):
        return getattr(self, "service", None) or self.fleet_role

    def rpc_metrics(self):
        """This process's mergeable registry snapshot — one atomic cut
        (``Registry.snapshot``). Answered even with telemetry disabled
        (``enabled`` False, frozen registry) so a collector can tell
        "telemetry off" from "process dead"."""
        return {"schema": telemetry.FLEET_SCHEMA,
                "proc": self._fleet_proc(),
                "role": self.fleet_role,
                "enabled": telemetry.enabled(),
                "ts": time.time(),
                "snapshot": telemetry.snapshot()}

    def rpc_flightrec(self, reason="fleet-pull"):
        """The in-memory flight-recorder ring (tracing.FlightRecorder)
        — the fleet collector pulls it ONCE when a process goes stale,
        so the last seconds before a death are preserved off-box."""
        return tracing.flight_recorder.snapshot(reason=str(reason))


# ---- server-side request loop ----

def dispatch(outer, service, req):
    """Dispatch one request to ``outer.rpc_<method>``; always returns a
    response dict (application exceptions surface to the client as
    ``{"ok": False}``, they never kill the connection handler).

    The frame's reserved ``trace`` field (when tracing is on) parents a
    server span to the remote client span, so the handler — and
    anything it calls, like the serving batcher — lands in the
    caller's trace."""
    method = req.get("method")
    with tracing.server_span("paddle_tpu.rpc.server", req.get("trace"),
                             service=service, method=str(method)) as sp:
        with telemetry.rpc_timer(service, method):
            try:
                fn = getattr(outer, "rpc_" + str(method), None)
                if fn is None:
                    raise ValueError("unknown method %r" % method)
                return {"ok": True,
                        "result": fn(**(req.get("params") or {}))}
            except Exception as e:  # surface to client
                if sp is not None:
                    sp.set_attr("error", str(e))
                return {"ok": False, "error": str(e)}


def serve_stream(outer, service, rfile, connection, stop):
    """Per-connection request loop shared by every line-JSON server:
    read frames until clean EOF / connection error / ``stop``. A partial
    or malformed frame is a clean connection teardown (typed
    ``RpcConnectionError`` from ``recv_msg``), not a JSON traceback. If
    ``outer`` defines ``_handle_request(req)`` it wraps dispatch (the
    master uses this for in-flight accounting); otherwise requests go
    straight to ``dispatch``. If ``outer`` defines ``_reply_sent(req)``
    it is called once the reply write finished (or failed) — the
    serving server uses this so graceful drain can wait until every
    computed answer actually left the socket."""
    handle = getattr(outer, "_handle_request", None)
    done = getattr(outer, "_reply_sent", None)
    while not stop.is_set():
        try:
            req = recv_msg(rfile)
        except (RpcError, OSError):
            break  # peer vanished; nothing to answer
        if req is None:
            break
        if stop.is_set():
            # the server shut down while we were parked on the read:
            # close instead of answering — a reply computed by a
            # torn-down backend (a stopped router says "no healthy
            # replicas") would read as an app verdict and stop the
            # client from failing over to a live peer
            break
        if handle is not None:
            resp = handle(req)
        else:
            resp = dispatch(outer, service, req)
        try:
            send_msg(connection, resp, site=service + ".reply")
        except (fault.FaultInjected, OSError):
            break
        finally:
            if done is not None:
                done(req)
