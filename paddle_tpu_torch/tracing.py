"""End-to-end distributed tracing: spans, context propagation, flight
recorder.

A copy of the JAX package's ``tracing.py`` (which imports no JAX), over
this package's ``fault`` and ``telemetry``: the same span names
(``paddle_tpu.<subsystem>.<op>``), wire context and flight-recorder
schema, so a trace crosses between the two packages' RPC peers.

The telemetry registry answers "is production slow RIGHT NOW";
this module answers "WHERE did this request/chunk spend its time" — a
thread-safe span layer whose contexts propagate across the
line-JSON RPC channel, so one serving request is ONE trace spanning
ServingClient -> server -> DynamicBatcher queue-wait -> engine bucket
dispatch, and one training chunk is ONE trace spanning feed staging ->
``run_chunk`` dispatch -> health fetch -> checkpoint/reshard work in
the recovery loops.

Design rules (same contract as telemetry.py):

* **Near-zero overhead when off.** ``enabled()`` is a module-bool read;
  every instrumentation site either guards on it or calls ``span()``,
  which early-returns a shared ``nullcontext`` singleton — the disabled
  hot path pays one predicted branch per site, no ids, no clocks, no
  allocation of Span objects.
* **Names follow** ``paddle_tpu.<subsystem>.<op>`` (dots, unlike the
  underscore metric convention), enforced at span creation AND
  statically by ``tools/metrics_lint.py`` against the OBSERVABILITY.md
  span catalogue.
* **Sampling.** The decision is made ONCE at trace-root creation
  (``set_sample_rate`` / ``FLAGS_trace_sample``) and rides the context
  over the wire: a sampled-out trace still propagates ids (children
  agree with the root) but records nothing anywhere.
* **One trace per logical request.** The RPC client creates one client
  span per *logical* call and injects the SAME context into every
  retransmit, so server-side spans of a retried call share one trace
  and parent — never orphaned, never duplicated ids (chaos-tested in
  tests/test_tracing.py).
* **Flight recorder.** A bounded in-memory ring of the last N completed
  spans + telemetry events, dumped atomically (``fault.atomic_write``,
  fsync'd — the same crash-flush guarantee the JSONL exporters carry)
  next to the existing forensics records whenever ``Divergence``, a
  reshard failure, or an unhandled executor exception fires.

The exporters (schema-versioned JSONL, Chrome ``trace_event`` JSON)
have not been ported; a sink (``add_sink``) receives every recorded
span as a dict.
"""

import contextlib
import json
import os
import random
import re
import threading
import time
import warnings
from collections import deque

from paddle_tpu_torch import fault
from paddle_tpu_torch import telemetry

__all__ = [
    "TraceContext", "Span", "FlightRecorder", "flight_recorder",
    "enable", "disable", "enabled", "set_sample_rate", "sample_rate",
    "span", "child_span", "server_span", "start_span", "finish_span",
    "record_span", "current", "activate", "inject", "extract",
    "add_sink", "remove_sink", "open_spans", "reset",
    "validate_span_name", "TRACE_SCHEMA", "FLIGHT_SCHEMA",
]

TRACE_SCHEMA = "paddle_tpu.trace.v1"
FLIGHT_SCHEMA = "paddle_tpu.flightrec.v1"

# paddle_tpu.<subsystem>.<op> — subsystem one lowercase word, op may use
# underscores; the lint tool applies the same pattern statically
_SPAN_NAME_RE = re.compile(r"^paddle_tpu\.[a-z][a-z0-9]*\.[a-z][a-z0-9_]*$")

_enabled = False
_sample_rate = 1.0
_sampler = random.Random()
_sinks = []
_lock = threading.Lock()
_open = {}             # span_id -> name (the conftest leak guard reads it)
_tls = threading.local()

_validated = set()


def validate_span_name(name):
    """Raise ValueError unless ``name`` matches the repo convention
    (``paddle_tpu.<subsystem>.<op>``). Memoized — span creation sits on
    request hot paths."""
    if name in _validated:
        return
    if not isinstance(name, str) or not _SPAN_NAME_RE.match(name):
        raise ValueError(
            "span name %r violates the paddle_tpu.<subsystem>.<op> "
            "convention (lowercase, dot-separated; op may use "
            "underscores)" % (name,))
    _validated.add(name)


def enable(sample=None):
    """Turn tracing on (spans start recording). ``sample`` optionally
    sets the root-trace sampling rate in the same call."""
    global _enabled
    if sample is not None:
        set_sample_rate(sample)
    flight_recorder._arm()
    _enabled = True


def disable():
    """Turn tracing off — including the flight recorder's telemetry
    event tap, so the disabled state pays its documented one branch
    per site (a registered sink would defeat ``telemetry.emit``'s
    no-sink fast path on every step)."""
    global _enabled
    _enabled = False
    telemetry.remove_sink(flight_recorder._on_event)


def enabled():
    return _enabled


def set_sample_rate(rate, seed=None):
    """Probability that a NEW trace root is sampled (children inherit
    the root's decision, including across the RPC wire). ``seed`` pins
    the sampler for deterministic tests."""
    global _sample_rate, _sampler
    rate = float(rate)
    if not 0.0 <= rate <= 1.0:
        raise ValueError("sample rate must be in [0, 1], got %r" % rate)
    _sample_rate = rate
    if seed is not None:
        _sampler = random.Random(seed)


def sample_rate():
    return _sample_rate


# ---- context ----


class TraceContext:
    """Explicit trace position: (trace_id, span_id, sampled). The wire
    form (``to_wire``/``extract``) rides the RPC frame's reserved
    ``"trace"`` field."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id, span_id, sampled=True):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled

    def to_wire(self):
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "sampled": bool(self.sampled)}

    def __repr__(self):
        return ("TraceContext(trace_id=%r, span_id=%r, sampled=%r)"
                % (self.trace_id, self.span_id, self.sampled))


def _stack():
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current():
    """The active TraceContext on this thread (innermost open span or
    ``activate()`` scope), or None."""
    st = getattr(_tls, "stack", None)
    return st[-1] if st else None


def inject():
    """Wire form of the current context for a reserved RPC frame field,
    or None when no trace is active."""
    ctx = current()
    return None if ctx is None else ctx.to_wire()


def extract(wire):
    """TraceContext from a wire dict, or None when absent/malformed — a
    bad ``trace`` field from an old or hostile client must degrade to
    "no incoming trace", never kill the server dispatch."""
    if not isinstance(wire, dict):
        return None
    tid, sid = wire.get("trace_id"), wire.get("span_id")
    if not (isinstance(tid, str) and tid
            and isinstance(sid, str) and sid):
        return None
    return TraceContext(tid, sid, bool(wire.get("sampled", True)))


@contextlib.contextmanager
def activate(ctx):
    """Make ``ctx`` the current context for the block — the server half
    of propagation (a remote parent), and the cross-thread hand-off
    (e.g. the batcher dispatcher adopting a request's context)."""
    if ctx is None:
        yield None
        return
    st = _stack()
    st.append(ctx)
    try:
        yield ctx
    finally:
        try:
            st.remove(ctx)
        except ValueError:
            pass  # a reset() inside the block already cleared the stack


def _new_id():
    """64-bit hex id. A per-thread PRNG seeded once from OS entropy —
    ``uuid.uuid4`` pays an os.urandom syscall per id (measured ~14 us
    on a shared VM), two orders of magnitude over budget for a span
    layer whose whole A/B bound is a few us per dispatch."""
    rng = getattr(_tls, "idrng", None)
    if rng is None:
        rng = _tls.idrng = random.Random(
            int.from_bytes(os.urandom(8), "big")
            ^ (threading.get_ident() << 16))
    return "%016x" % rng.getrandbits(64)


# ---- spans ----


class Span:
    """One open span. Created by ``start_span`` (or the ``span()``
    context managers); ``finish_span`` records it to the flight
    recorder ring and every sink."""

    __slots__ = ("name", "ctx", "parent_id", "start_ts", "start_mono",
                 "attrs")

    def __init__(self, name, ctx, parent_id, attrs):
        self.name = name
        self.ctx = ctx
        self.parent_id = parent_id
        self.start_ts = time.time()
        self.start_mono = time.monotonic()
        self.attrs = dict(attrs) if attrs else {}

    def set_attr(self, key, value):
        self.attrs[key] = value


def start_span(name, parent=None, attrs=None):
    """Open a span. ``parent=None`` nests under the thread's current
    context, or starts a new (sampling-decided) trace root. The span's
    context becomes current until ``finish_span``."""
    validate_span_name(name)
    if parent is None:
        parent = current()
    if parent is None:
        trace_id = _new_id()
        sampled = _sample_rate >= 1.0 or _sampler.random() < _sample_rate
        parent_id = None
    else:
        trace_id = parent.trace_id
        sampled = parent.sampled
        parent_id = parent.span_id
    sp = Span(name, TraceContext(trace_id, _new_id(), sampled), parent_id,
              attrs)
    _stack().append(sp.ctx)
    if sampled:
        with _lock:
            _open[sp.ctx.span_id] = name
    return sp


def finish_span(sp, error=None):
    """Close ``sp`` and record it (sampled spans only). Returns the
    recorded dict, or None for a sampled-out span."""
    end_mono = time.monotonic()
    st = _stack()
    try:
        st.remove(sp.ctx)
    except ValueError:
        pass  # a reset() between start and finish cleared the stack
    if not sp.ctx.sampled:
        return None
    with _lock:
        _open.pop(sp.ctx.span_id, None)
    rec = {
        "schema": TRACE_SCHEMA, "kind": "span",
        "trace_id": sp.ctx.trace_id, "span_id": sp.ctx.span_id,
        "parent_id": sp.parent_id, "name": sp.name,
        "ts": sp.start_ts,
        "mono_us": sp.start_mono * 1e6,
        "dur_us": max(0.0, (end_mono - sp.start_mono) * 1e6),
        "thread": threading.current_thread().name,
    }
    if error is not None:
        rec["error"] = "%s: %s" % (type(error).__name__, error)
    if sp.attrs:
        rec["attrs"] = sp.attrs
    _record(rec)
    return rec


def record_span(name, start_mono, end_mono, parent=None, **attrs):
    """Record an already-elapsed span from explicit ``time.monotonic()``
    stamps — the retroactive per-request attribution path (the batcher
    knows a request's queue wait only once its batch dispatched).
    ``parent`` defaults to the current context; records nothing for a
    sampled-out (or absent, when no root can be made) parent."""
    if not _enabled:
        return None
    validate_span_name(name)
    if parent is None:
        parent = current()
    if parent is None:
        trace_id, parent_id = _new_id(), None
        sampled = _sample_rate >= 1.0 or _sampler.random() < _sample_rate
    else:
        trace_id, parent_id = parent.trace_id, parent.span_id
        sampled = parent.sampled
    if not sampled:
        return None
    now = time.monotonic()
    rec = {
        "schema": TRACE_SCHEMA, "kind": "span",
        "trace_id": trace_id, "span_id": _new_id(),
        "parent_id": parent_id, "name": name,
        "ts": time.time() - (now - start_mono),
        "mono_us": start_mono * 1e6,
        "dur_us": max(0.0, (end_mono - start_mono) * 1e6),
        "thread": threading.current_thread().name,
    }
    if attrs:
        rec["attrs"] = attrs
    _record(rec)
    return rec


class _SpanCM:
    """Context-manager form; yields the Span (attrs mutable mid-flight)
    and records the exception class of an escaping error."""

    __slots__ = ("name", "parent", "attrs", "sp")

    def __init__(self, name, parent, attrs):
        self.name = name
        self.parent = parent
        self.attrs = attrs

    def __enter__(self):
        self.sp = start_span(self.name, parent=self.parent,
                             attrs=self.attrs)
        return self.sp

    def __exit__(self, etype, evalue, tb):
        finish_span(self.sp, error=evalue)
        return False


_NULL = contextlib.nullcontext()


def span(name, parent=None, **attrs):
    """``with tracing.span(name, key=value) as sp:`` — opens a child of
    the current context (or a new root). The one-branch no-op
    ``nullcontext`` singleton when tracing is off."""
    if not _enabled:
        return _NULL
    return _SpanCM(name, parent, attrs)


def child_span(name, **attrs):
    """Like ``span`` but records ONLY when a trace is already active —
    never creates a new root (for shared helpers like the serving
    engine that would otherwise spawn one orphan trace per call)."""
    if not _enabled or current() is None:
        return _NULL
    return _SpanCM(name, None, attrs)


def server_span(name, wire, **attrs):
    """Span parented to a REMOTE context extracted from an RPC frame's
    reserved ``trace`` field (or a new root when the client sent none).
    The server half of cross-process propagation."""
    if not _enabled:
        return _NULL
    return _SpanCM(name, extract(wire), attrs)


# ---- recording: sinks + flight-recorder ring ----


def add_sink(fn):
    """``fn(span_dict)`` is called for every completed sampled span.
    The JSONL trace exporter registers itself here; tests register a
    plain list.append."""
    if fn not in _sinks:
        _sinks.append(fn)


def remove_sink(fn):
    try:
        _sinks.remove(fn)
    except ValueError:
        pass


def _record(rec):
    flight_recorder._spans.append(rec)
    for fn in list(_sinks):
        try:
            fn(rec)
        except Exception as e:  # a broken sink must not kill the caller
            warnings.warn("tracing sink %r failed: %s" % (fn, e))


def open_spans():
    """Names of spans started but not finished — the conftest
    session-end guard fails tier-1 when this is non-empty."""
    with _lock:
        return sorted(_open.values())


def reset():
    """Full tracing reset (tests): sinks, open-span accounting, the
    current thread's context stack, sampling, and the flight recorder."""
    global _sample_rate
    with _lock:
        _open.clear()
    del _sinks[:]
    _sample_rate = 1.0
    st = getattr(_tls, "stack", None)
    if st:
        del st[:]
    flight_recorder.reset()


# ---- flight recorder ----


class FlightRecorder:
    """Bounded ring of the last N completed spans + telemetry events,
    plus the telemetry-summary delta since arming. ``dump()`` writes
    one atomic (fsync'd) JSON document — the crash forensics companion:
    the recovery loop drops a dump next to its ``divergence-*.json``
    records, the elastic loop on a reshard failure, and the executor on
    an unhandled dispatch exception (``on_crash``, no-op until
    ``set_dump_dir`` armed a location)."""

    def __init__(self, capacity=512, event_capacity=256):
        self._spans = deque(maxlen=capacity)
        self._events = deque(maxlen=event_capacity)
        self.dump_dir = None
        self._baseline = {}

    def _arm(self):
        """Called by ``enable()``: baseline the telemetry summary (the
        dump's delta denominator) and tap the telemetry event bus."""
        self._baseline = telemetry.summary()
        telemetry.add_sink(self._on_event)  # idempotent

    def _on_event(self, event):
        self._events.append(event)

    def set_dump_dir(self, dirname):
        """Arm automatic ``on_crash`` dumps into ``dirname`` (the
        recovery loop points this at its checkpoint/forensics
        directory)."""
        self.dump_dir = dirname

    def spans(self):
        return list(self._spans)

    def events(self):
        return list(self._events)

    def reset(self):
        self._spans.clear()
        self._events.clear()
        self.dump_dir = None
        self._baseline = {}
        telemetry.remove_sink(self._on_event)

    def _delta(self):
        base = self._baseline
        out = {}
        try:
            for k, v in telemetry.summary().items():
                prev = base.get(k, 0)
                if v != prev:
                    out[k] = (v - prev if isinstance(v, (int, float))
                              else v)
        except Exception:
            pass  # the dump must succeed even if a metric misbehaves
        return out

    def snapshot(self, reason=""):
        return {
            "schema": FLIGHT_SCHEMA, "reason": reason, "ts": time.time(),
            "spans": list(self._spans),
            "events": list(self._events),
            "telemetry_delta": self._delta(),
        }

    def dump(self, path=None, reason=""):
        """Write the ring atomically (temp file + fsync + rename via
        ``fault.atomic_write`` — a crash mid-dump never leaves a torn
        record). ``path=None`` derives one under ``dump_dir`` (or
        returns None when no directory is armed)."""
        if path is None:
            if not self.dump_dir:
                return None
            path = os.path.join(
                self.dump_dir,
                "flightrec-%s-%d.json" % (reason or "manual",
                                          time.time_ns()))
        doc = self.snapshot(reason)
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        fault.atomic_write(path, json.dumps(doc, default=str).encode())
        return path

    def on_crash(self, reason, path=None):
        """Best-effort dump on an unhandled failure: never raises (the
        original exception is the story; a full disk must not replace
        it), no-op without an explicit ``path`` or an armed
        ``dump_dir``."""
        try:
            return self.dump(path, reason=reason)
        except OSError as e:
            warnings.warn("flight-recorder dump failed (%s): %s"
                          % (reason, e), RuntimeWarning)
            return None


flight_recorder = FlightRecorder()
