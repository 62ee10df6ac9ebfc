"""Always-on runtime telemetry: metrics registry + recompile-storm detector.

A copy of the JAX package's ``telemetry.py`` (stdlib only there too):
the same metric names (``paddle_tpu_<subsystem>_<name>_<unit>``, so
OBSERVABILITY.md's names hold), the same registry, sinks, facades and
recompile-storm detector. Two things differ:

* the device-memory gauges (:func:`sample_device_memory`) read the
  PyTorch caching allocator (``torch.cuda.memory_allocated`` /
  ``max_memory_allocated``) of the executor's card, where the JAX
  package sums ``jax.live_arrays``;
* the port runs programs eagerly, so what the recompile detector counts
  as a "compile" is what the port builds per signature: an executor
  plan (``core/executor.py``: the pass pipeline's clone, the guard's
  plan) and a captured CUDA graph (``core/graphs.py``).

Design rules (as in the JAX package):

* **Near-zero overhead when off.** `enabled()` is a module-bool read;
  every hot-path instrumentation site guards on it and the default is
  OFF, so the per-step cost in the disabled state is one predicted
  branch. No sockets, threads, or files exist until a sink is attached.
* **Names follow** ``paddle_tpu_<subsystem>_<name>_<unit>`` (enforced at
  metric creation); counters end in ``_total`` per Prometheus
  convention.
* **Bounded label cardinality.** A metric rejects new label-sets past
  ``max_series`` (default 256) instead of silently eating memory — a
  cardinality explosion is a bug in the instrumentation site, not load.
* **Recompile-storm detector**: every plan build or capture is recorded
  with the (program-version, signature) key that missed and a diff
  against the PREVIOUS signature of the same program; after
  ``threshold`` rebuilds of one program it warns (rate-limited).

Exporters (Prometheus text, JSONL event log) arrive with the
observability modules of a later slice.
"""

import contextlib
import functools
import re
import threading
import time
import warnings
import zlib

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "RecompileDetector",
    "registry", "counter", "gauge", "histogram", "enable", "disable",
    "enabled", "reset", "snapshot", "summary", "add_sink", "remove_sink",
    "emit",
    "recompile_detector", "program_label", "value_bytes",
    "record_executor_step", "observe_rpc", "rpc_timer", "timed_get",
    "record_checkpoint", "sample_device_memory", "EVENT_SCHEMA",
    "record_fault", "record_rpc_retry", "record_rpc_client_error",
    "set_breaker_state", "record_breaker_transition", "record_quarantine",
    "record_preemption", "set_resume_step",
    "record_jit_hit", "record_serving_enqueue", "record_serving_batch",
    "record_serving_reject", "record_serving_first_response",
    "record_serving_compile", "record_aot_cache",
    "record_router_request", "record_router_failover",
    "record_router_ejection", "set_router_replicas",
    "record_decode_request", "record_decode_prefill",
    "record_decode_step", "set_decode_occupancy",
    "record_guard_health", "record_guard_rollback",
    "record_guard_divergence", "record_debug_unflattenable",
    "record_reshard", "record_cluster_epoch", "set_world_size",
    "merge_histogram_state", "FLEET_SCHEMA",
]

EVENT_SCHEMA = "paddle_tpu.telemetry.v1"
# the fleet observability plane's wire/JSONL schema (paddle_tpu/fleet):
# rpc_metrics replies, fleet rollup lines, and SloBreach events all
# carry it, so a consumer can reject a version it does not understand
FLEET_SCHEMA = "paddle_tpu.fleet.v1"

# paddle_tpu_<subsystem>_<name...>_<unit>; the lint tool applies the same
# pattern repo-wide so ad-hoc sites can't drift from the convention
_UNITS = ("seconds", "bytes", "total", "count", "ratio", "info")
_NAME_RE = re.compile(
    r"^paddle_tpu_[a-z][a-z0-9]*(_[a-z0-9]+)+_(%s)$" % "|".join(_UNITS))
_LABEL_RE = re.compile(r"^[a-z_][a-z0-9_]*$")

_enabled = False


def enable():
    """Turn the hot-path instrumentation on (metrics start accumulating)."""
    global _enabled
    _enabled = True


def disable():
    global _enabled
    _enabled = False


def enabled():
    return _enabled


def validate_metric_name(name, kind=None):
    """Raise ValueError unless ``name`` matches the repo convention
    (``paddle_tpu_<subsystem>_<name>_<unit>``; counters end ``_total``)."""
    if not _NAME_RE.match(name):
        raise ValueError(
            "metric name %r violates the paddle_tpu_<subsystem>_<name>_"
            "<unit> convention (unit in %s)" % (name, list(_UNITS)))
    if kind == "counter" and not name.endswith("_total"):
        raise ValueError("counter %r must end with _total" % name)
    if kind in ("gauge", "histogram") and name.endswith("_total"):
        raise ValueError("%s %r must not end with _total (counters only)"
                         % (kind, name))


class _Metric:
    kind = None

    def __init__(self, name, help="", labelnames=(), max_series=256):
        validate_metric_name(name, self.kind)
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError("bad label name %r on %r" % (ln, name))
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self.max_series = max_series
        self._lock = threading.Lock()
        self._series = {}  # labelvalue tuple -> state

    def _key(self, labels):
        if set(labels) != set(self.labelnames):
            raise ValueError(
                "metric %s takes labels %s, got %s"
                % (self.name, self.labelnames, sorted(labels)))
        return tuple(str(labels[ln]) for ln in self.labelnames)

    def _state(self, labels):
        key = self._key(labels)
        st = self._series.get(key)
        if st is None:
            if len(self._series) >= self.max_series:
                raise ValueError(
                    "metric %s exceeded max_series=%d distinct label sets "
                    "— label cardinality explosion (offending labels: %r)"
                    % (self.name, self.max_series, key))
            st = self._series[key] = self._new_state()
        return st

    def samples(self):
        """[(labels dict, state snapshot)] — a consistent copy."""
        with self._lock:
            return [(dict(zip(self.labelnames, k)), self._copy_state(v))
                    for k, v in sorted(self._series.items())]

    def clear(self):
        with self._lock:
            self._series.clear()

    # subclass hooks
    def _new_state(self):
        raise NotImplementedError

    @staticmethod
    def _copy_state(st):
        return st


class Counter(_Metric):
    kind = "counter"

    def _new_state(self):
        return [0.0]

    def inc(self, amount=1, **labels):
        if amount < 0:
            raise ValueError("counter %s cannot decrease" % self.name)
        with self._lock:
            self._state(labels)[0] += amount

    def value(self, **labels):
        with self._lock:
            st = self._series.get(self._key(labels))
            return st[0] if st else 0.0

    @staticmethod
    def _copy_state(st):
        return st[0]


class Gauge(_Metric):
    kind = "gauge"

    def _new_state(self):
        return [0.0]

    def set(self, value, **labels):
        with self._lock:
            self._state(labels)[0] = float(value)

    def inc(self, amount=1, **labels):
        with self._lock:
            self._state(labels)[0] += amount

    def dec(self, amount=1, **labels):
        self.inc(-amount, **labels)

    def value(self, **labels):
        with self._lock:
            st = self._series.get(self._key(labels))
            return st[0] if st else 0.0

    @staticmethod
    def _copy_state(st):
        return st[0]


# powers-of-~3 seconds ladder: covers 100us kernel launches through
# multi-minute first-step compiles in 14 buckets
DEFAULT_BUCKETS = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0,
                   3.0, 10.0, 30.0, 100.0, 300.0)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help="", labelnames=(), buckets=None,
                 max_series=256):
        self.buckets = tuple(sorted(
            DEFAULT_BUCKETS if buckets is None else buckets))
        if not self.buckets:
            raise ValueError("histogram %s needs at least one bucket" % name)
        if "count" in labelnames:
            raise ValueError(
                "histogram %s may not use label 'count' (reserved by the "
                "bulk observe(value, count=N) form)" % name)
        super().__init__(name, help, labelnames, max_series)

    def _new_state(self):
        # cumulative-to-le counts per finite bucket + (+Inf via count)
        return {"count": 0, "sum": 0.0,
                "buckets": [0] * len(self.buckets)}

    def observe(self, value, count=1, **labels):
        """Record ``count`` observations of ``value`` in O(buckets):
        the bulk form keeps per-dispatch telemetry O(1) when a chunked
        executor reports K per-step samples at once. (``count`` is
        reserved — a label may not use that name.)"""
        value = float(value)
        count = int(count)
        with self._lock:
            st = self._state(labels)
            st["count"] += count
            st["sum"] += value * count
            for i, le in enumerate(self.buckets):
                if value <= le:
                    st["buckets"][i] += count

    def value(self, **labels):
        """{"count", "sum", "buckets"} snapshot (zeros when unseen)."""
        with self._lock:
            st = self._series.get(self._key(labels))
            return (self._copy_state(st) if st else
                    {"count": 0, "sum": 0.0,
                     "buckets": [0] * len(self.buckets)})

    @staticmethod
    def _copy_state(st):
        return {"count": st["count"], "sum": st["sum"],
                "buckets": list(st["buckets"])}


class Registry:
    """Get-or-create metric store. One process-wide instance (``registry``)
    backs the module-level helpers; tests may build private ones."""

    def __init__(self):
        self._metrics = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls) or m.labelnames != tuple(labelnames):
                    raise ValueError(
                        "metric %r re-registered as %s%s but exists as %s%s"
                        % (name, cls.__name__, tuple(labelnames),
                           type(m).__name__, m.labelnames))
                return m
            m = cls(name, help=help, labelnames=labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name, help="", labelnames=()):
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()):
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(), buckets=None):
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def metrics(self):
        with self._lock:
            return [self._metrics[n] for n in sorted(self._metrics)]

    def _atomic_samples(self):
        """``[(metric, samples)]`` copied as ONE cut across the whole
        registry: every metric's lock is held simultaneously while the
        states are copied, so a writer that updates two metrics
        back-to-back (a counter paired with a histogram observe) can
        never appear half-applied in a scrape. Per-metric locking gave
        each metric a consistent copy but sampled them at different
        instants — a fleet rollup built from such a snapshot could
        show more batches than enqueues. Acquisition is in registry
        (sorted-name) order and no hot path ever takes two metric
        locks, so the sweep cannot deadlock; writers block for only
        the O(series) copy."""
        metrics = self.metrics()
        for m in metrics:
            m._lock.acquire()
        try:
            return [(m, [(dict(zip(m.labelnames, k)), m._copy_state(v))
                         for k, v in sorted(m._series.items())])
                    for m in metrics]
        finally:
            for m in metrics:
                m._lock.release()

    def snapshot(self):
        """{name: {"type", "help", "series": [{"labels", "value"}]}} —
        the JSONL/bench embed form; Histogram values are
        {"count","sum","buckets"} dicts. The whole snapshot is one
        atomic cut (``_atomic_samples``): this is the mergeable form
        the fleet federation scrapes over ``rpc_metrics``."""
        out = {}
        for m, samples in self._atomic_samples():
            entry = {"type": m.kind, "help": m.help, "series": []}
            if isinstance(m, Histogram):
                entry["buckets"] = list(m.buckets)
            for labels, value in samples:
                entry["series"].append({"labels": labels, "value": value})
            out[m.name] = entry
        return out

    def summary(self):
        """Flat {name: value} rollup across label sets (the bench-JSON
        embed): counters/gauges sum their series; histograms roll up
        to ``name:count`` / ``name:sum``. Same atomic cut as
        ``snapshot``."""
        out = {}
        for m, samples in self._atomic_samples():
            if not samples:
                continue
            if isinstance(m, Histogram):
                out[m.name + ":count"] = sum(s["count"] for _, s in samples)
                out[m.name + ":sum"] = round(
                    sum(s["sum"] for _, s in samples), 6)
            else:
                out[m.name] = sum(v for _, v in samples)
        return out

    def reset(self):
        """Zero every metric by dropping its series. The metric OBJECTS
        survive — instrumentation sites hold direct references, so
        dropping them would silently disconnect the hot paths."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m.clear()


registry = Registry()


def counter(name, help="", labelnames=()):
    return registry.counter(name, help, labelnames)


def gauge(name, help="", labelnames=()):
    return registry.gauge(name, help, labelnames)


def histogram(name, help="", labelnames=(), buckets=None):
    return registry.histogram(name, help, labelnames, buckets)


def snapshot():
    return registry.snapshot()


def summary():
    """Flat {name: value} rollup across label sets (the bench-JSON embed):
    counters/gauges sum their series; histograms roll up to
    ``name:count`` / ``name:sum``. One atomic cut across the registry
    (see ``Registry._atomic_samples``)."""
    return registry.summary()


def merge_histogram_state(a, b):
    """Merge two Histogram state dicts (``{"count","sum","buckets"}``)
    bucket-wise — the fleet rollup's histogram combiner. Both states
    must come from the same bucket ladder (same length); the caller
    (fleet/rollup.py) falls back to a count/sum-only merge when two
    processes disagree on ladders."""
    if len(a["buckets"]) != len(b["buckets"]):
        raise ValueError(
            "histogram bucket ladders differ (%d vs %d buckets); merge "
            "count/sum only" % (len(a["buckets"]), len(b["buckets"])))
    return {"count": a["count"] + b["count"],
            "sum": a["sum"] + b["sum"],
            "buckets": [x + y for x, y in zip(a["buckets"], b["buckets"])]}


def reset():
    """Full telemetry reset (tests): metrics, sinks, detector state."""
    registry.reset()
    del _sinks[:]
    recompile_detector.reset()


# ---- event bus (JSONL exporter feed) ----

_sinks = []


def add_sink(fn):
    """``fn(event_dict)`` is called for every emitted event. The JSONL
    exporter registers itself here; custom sinks (e.g. a test capturing
    step events) may too."""
    if fn not in _sinks:
        _sinks.append(fn)


def remove_sink(fn):
    try:
        _sinks.remove(fn)
    except ValueError:
        pass


def emit(kind, **fields):
    """One structured event to every sink. No-op without sinks (the
    per-step hot path pays a truthiness check)."""
    if not _sinks:
        return
    event = {"schema": EVENT_SCHEMA, "ts": time.time(), "kind": kind}
    event.update(fields)
    for fn in list(_sinks):
        try:
            fn(event)
        except Exception as e:  # a broken sink must not kill training
            warnings.warn("telemetry sink %r failed: %s" % (fn, e))


# ---- recompile-storm detector ----


def program_label(program_or_fp):
    """Stable short label for a program: "p<id%2^16>.v<version>"."""
    fp = getattr(program_or_fp, "fingerprint", program_or_fp)
    if isinstance(fp, tuple) and len(fp) >= 2:
        head = fp[0] if isinstance(fp[0], int) else zlib.crc32(
            str(fp[0]).encode())
        return "p%04x.v%s" % (head & 0xFFFF, fp[1])
    return str(fp)


def _sig_diff(old, new):
    """Human-readable field-level diff of two signature dicts."""
    diffs = []
    for k in sorted(set(old) | set(new)):
        a, b = old.get(k), new.get(k)
        if a != b:
            diffs.append("%s: %r -> %r" % (k, a, b))
    return diffs


class RecompileDetector:
    """Records every retrace with the argument-signature diff that caused
    it; warns (rate-limited) after ``threshold`` retraces of the same
    program — each warning names the exact fields that wobbled."""

    def __init__(self, threshold=5, warn_interval=60.0):
        self.threshold = threshold
        self.warn_interval = warn_interval
        self._lock = threading.Lock()
        self._last_sig = {}    # program key -> signature dict
        self._counts = {}      # program key -> compile count
        self._last_warn = {}   # program key -> monotonic ts
        self.events = []       # bounded in-memory ring of recompile records

    def reset(self):
        with self._lock:
            self._last_sig.clear()
            self._counts.clear()
            self._last_warn.clear()
            del self.events[:]

    def record(self, program_fp, signature):
        """Call on every jit-cache MISS. ``signature`` is a flat dict
        (shape signature, fetch names, flags...). Returns
        (compile_count_for_program, diff_list) — diff vs the previous
        signature of the same program ([] on first compile)."""
        key = program_label(program_fp)
        with self._lock:
            n = self._counts.get(key, 0) + 1
            self._counts[key] = n
            prev = self._last_sig.get(key)
            self._last_sig[key] = dict(signature)
            diff = _sig_diff(prev, signature) if prev is not None else []
            record = {"program": key, "compile_index": n, "diff": diff}
            self.events.append(record)
            del self.events[:-256]
            storm = n >= self.threshold
            now = time.monotonic()
            warn_now = storm and (now - self._last_warn.get(key, -1e18)
                                  >= self.warn_interval)
            if warn_now:
                self._last_warn[key] = now
        _RECOMPILES.inc(program=key)
        emit("recompile", program=key, compile_index=n, diff=diff)
        if warn_now:
            warnings.warn(
                "recompile storm: program %s has been traced %d times "
                "(threshold %d). Last signature change: %s. A host-side "
                "shape/dtype wobble is retracing the step function — pad "
                "or bucket the wobbling input (see OBSERVABILITY.md)."
                % (key, n, self.threshold,
                   "; ".join(diff) or "<first signatures identical>"),
                RuntimeWarning, stacklevel=3)
        return n, diff

    def compile_count(self, program_fp):
        with self._lock:
            return self._counts.get(program_label(program_fp), 0)


recompile_detector = RecompileDetector()


# ---- the metric catalogue used by runtime instrumentation sites ----
# (created eagerly so the Prometheus endpoint exposes the full catalogue
# with zero values from process start; creation is import-time only)

_STEP_TIME = histogram(
    "paddle_tpu_executor_step_duration_seconds",
    "Walltime of one Executor.run dispatch (first step includes "
    "trace+compile)", labelnames=("executor",))
_FEED_BYTES = counter(
    "paddle_tpu_executor_feed_bytes_total",
    "Host->device feed payload bytes", labelnames=("executor",))
_FETCH_BYTES = counter(
    "paddle_tpu_executor_fetch_bytes_total",
    "Fetched result bytes (device metadata; no sync)",
    labelnames=("executor",))
_STEPS = counter(
    "paddle_tpu_executor_steps_total", "Executor.run calls",
    labelnames=("executor",))
_JIT_HITS = counter(
    "paddle_tpu_executor_jit_cache_hits_total",
    "Program-cache hits keyed per program", labelnames=("program",))
_JIT_MISSES = counter(
    "paddle_tpu_executor_jit_cache_misses_total",
    "Plan builds and graph captures (the port's compiles)",
    labelnames=("program",))
_RECOMPILES = counter(
    "paddle_tpu_executor_recompiles_total",
    "Retraces recorded by the recompile-storm detector",
    labelnames=("program",))
_COMPILE_SECONDS = counter(
    "paddle_tpu_executor_compile_seconds_total",
    "Cumulative walltime of cache-miss steps (trace+compile+first run)",
    labelnames=("executor",))
_DEVICE_LIVE = gauge(
    "paddle_tpu_device_memory_live_bytes",
    "Bytes the caching allocator holds for tensors (memory_allocated)")
_DEVICE_PEAK = gauge(
    "paddle_tpu_device_memory_peak_bytes",
    "Caching allocator peak (max_memory_allocated)")
_PE_STEP_TIME = histogram(
    "paddle_tpu_parallel_step_duration_seconds",
    "ParallelExecutor.run walltime per mesh", labelnames=("mesh",))
_ALLREDUCE_BYTES = counter(
    "paddle_tpu_parallel_allreduce_payload_bytes_total",
    "Estimated dp gradient all-reduce payload per step (trainable param "
    "bytes, f32)", labelnames=("mesh",))
_COMM_BUCKETS = gauge(
    "paddle_tpu_comm_buckets_count",
    "Gradient buckets per compiled step under the explicit "
    "communication layer", labelnames=("mesh",))
_COMM_PRE_BYTES = counter(
    "paddle_tpu_comm_payload_pre_bytes_total",
    "Modeled per-device wire bytes the bucketed gradient exchange "
    "would move UNQUANTIZED (2x payload per all-reduce)",
    labelnames=("mesh",))
_COMM_POST_BYTES = counter(
    "paddle_tpu_comm_payload_post_bytes_total",
    "Modeled per-device wire bytes actually moved (transport width "
    "after quantization, plus scale vectors)", labelnames=("mesh",))
_COMM_AR_BYTES = counter(
    "paddle_tpu_comm_allreduce_bytes_total",
    "Per-dispatch bucket all-reduce payload (padded flat-bucket bytes "
    "x 2 phases x in-graph steps)", labelnames=("mesh",))
_READER_DEPTH = gauge(
    "paddle_tpu_reader_queue_depth_count",
    "Prefetch queue depth observed at each consumer get",
    labelnames=("reader",))
_READER_STARVED = counter(
    "paddle_tpu_reader_starved_seconds_total",
    "Consumer time blocked on an empty prefetch queue",
    labelnames=("reader",))
_RPC_LATENCY = histogram(
    "paddle_tpu_rpc_server_latency_seconds",
    "Server-side RPC handler latency", labelnames=("service", "method"),
    buckets=(1e-5, 1e-4, 1e-3, 1e-2, 0.1, 1.0, 10.0, 60.0))
_HEARTBEAT_AGE = gauge(
    "paddle_tpu_membership_heartbeat_age_seconds",
    "Interval since the previous heartbeat of the same member, observed "
    "at heartbeat receipt", labelnames=("kind", "member"))
_CKPT_TIME = histogram(
    "paddle_tpu_checkpoint_io_duration_seconds",
    "Sharded checkpoint save/restore walltime", labelnames=("op",))
_CKPT_BYTES = counter(
    "paddle_tpu_checkpoint_io_bytes_total",
    "Sharded checkpoint bytes written/read", labelnames=("op",))
_RPC_RETRIES = counter(
    "paddle_tpu_rpc_retry_total",
    "Client-side RPC retries (idempotent calls re-sent after a "
    "connection-class failure)", labelnames=("service", "method"))
_RPC_CLIENT_ERRORS = counter(
    "paddle_tpu_rpc_client_errors_total",
    "Client-side RPC call failures after retries, by kind "
    "(connection/timeout/remote/circuit_open)",
    labelnames=("service", "kind"))
_BREAKER_STATE = gauge(
    "paddle_tpu_rpc_breaker_state_count",
    "Circuit-breaker state per service: 0 closed, 1 open, 2 half-open",
    labelnames=("service",))
_BREAKER_TRANSITIONS = counter(
    "paddle_tpu_rpc_breaker_transitions_total",
    "Circuit-breaker state transitions", labelnames=("service", "to"))
_FAULTS = counter(
    "paddle_tpu_fault_injected_total",
    "Faults injected by the paddle_tpu.fault harness",
    labelnames=("site", "action"))
_CKPT_QUARANTINED = counter(
    "paddle_tpu_checkpoint_quarantined_total",
    "Checkpoint generations moved to quarantine/ after failing "
    "verification", labelnames=("reason",))
_PREEMPTIONS = counter(
    "paddle_tpu_recovery_preemptions_total",
    "Preemptions (real or injected) caught by the recovery wrapper")
_RESUME_STEP = gauge(
    "paddle_tpu_recovery_resume_step_count",
    "Step the recovery wrapper last resumed training at")
_SERVING_QUEUE_DEPTH = gauge(
    "paddle_tpu_serving_queue_depth_count",
    "Batcher admission-queue depth observed at each enqueue",
    labelnames=("batcher",))
_SERVING_REQUESTS = counter(
    "paddle_tpu_serving_requests_total",
    "Requests admitted into the dynamic batcher",
    labelnames=("batcher",))
_SERVING_BATCHES = counter(
    "paddle_tpu_serving_batches_total",
    "Batches dispatched to the engine, by padded bucket",
    labelnames=("batcher", "bucket"))
_SERVING_BATCH_SIZE = histogram(
    "paddle_tpu_serving_batch_size_count",
    "Coalesced rows per dispatched batch (pre-padding)",
    labelnames=("batcher",),
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512))
_SERVING_PAD_WASTE = histogram(
    "paddle_tpu_serving_padding_waste_ratio",
    "Padding rows / bucket rows per batch (0 = perfectly full)",
    labelnames=("batcher",),
    buckets=(0.0, 0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0))
_SERVING_TTFR = histogram(
    "paddle_tpu_serving_first_response_seconds",
    "Enqueue-to-response latency per request (queue wait + batch run)",
    labelnames=("batcher",),
    buckets=(1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0, 3.0,
             10.0, 60.0))
_SERVING_REJECTED = counter(
    "paddle_tpu_serving_rejected_total",
    "Requests shed at admission (queue_full), refused during drain "
    "(closed), or expired before dispatch (deadline)",
    labelnames=("batcher", "reason"))
_SERVING_COMPILES = counter(
    "paddle_tpu_serving_bucket_compiles_total",
    "Engine bucket executables compiled (== bucket count after warmup; "
    "growth under traffic means bucketing is broken)",
    labelnames=("service", "bucket"))
_SERVING_COMPILE_SECONDS = counter(
    "paddle_tpu_serving_compile_seconds_total",
    "Cumulative walltime of serving AOT bucket compiles",
    labelnames=("service",))
_SERVING_BUCKET_COST = gauge(
    "paddle_tpu_serving_bucket_cost_flops_count",
    "XLA cost_analysis flops of each bucket's compiled executable",
    labelnames=("service", "bucket"))
_SERVING_AOT_CACHE = counter(
    "paddle_tpu_serving_aot_cache_total",
    "Persistent AOT executable cache events: hit (deserialized, no "
    "compile), miss (cold key), store, error (corrupt/stale entry "
    "degraded to a compile)", labelnames=("service", "event"))
_ROUTER_REQUESTS = counter(
    "paddle_tpu_router_requests_total",
    "Requests completed by the serving router, by outcome (ok / "
    "deadline / exhausted = every replica tried and failed / "
    "unroutable = no healthy replica existed)",
    labelnames=("outcome",))
_ROUTER_LATENCY = histogram(
    "paddle_tpu_router_request_seconds",
    "End-to-end router request latency including every failover hop",
    buckets=(1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0, 3.0,
             10.0, 60.0))
_ROUTER_FAILOVERS = counter(
    "paddle_tpu_router_failovers_total",
    "Requests re-routed to another replica, by trigger (connection / "
    "timeout / overloaded / circuit_open)", labelnames=("reason",))
_ROUTER_EJECTIONS = counter(
    "paddle_tpu_router_ejections_total",
    "Replicas removed from the routable set, by cause (breaker / "
    "membership / drain / removed)", labelnames=("reason",))
_ROUTER_REPLICAS = gauge(
    "paddle_tpu_router_replicas_count",
    "Known replicas by routability (routable / unroutable), sampled "
    "every health tick", labelnames=("state",))
_ROUTER_HEDGES = counter(
    "paddle_tpu_router_hedges_total",
    "Hedged-request events on the serving router, by outcome (fired = "
    "a backup request was launched / win = the backup answered first / "
    "loss = the primary answered first, backup cancelled / capped = "
    "the hedge threshold passed but the rate cap suppressed the "
    "backup)", labelnames=("outcome",))
_ROUTER_HEDGE_THRESHOLD = gauge(
    "paddle_tpu_router_hedge_threshold_seconds",
    "Live per-bucket hedge threshold: how long the router waits on the "
    "primary before launching a backup (rolling local p95, seeded from "
    "the fleet HedgeSignal, static fallback until data exists)",
    labelnames=("bucket",))
_SUPERVISOR_RESTARTS = counter(
    "paddle_tpu_fleet_supervisor_restarts_total",
    "Replica restarts performed by the fleet supervisor, by typed "
    "reason (exit = the child process died / lease_expired = the "
    "membership lease lapsed while the process looked alive — a hang "
    "— or an adopted replica's lease lapsed / never_ready = a spawn "
    "missed its ready window)", labelnames=("reason",))
_SUPERVISOR_QUARANTINES = counter(
    "paddle_tpu_fleet_supervisor_quarantines_total",
    "Replicas put in flap quarantine by the supervisor (too many "
    "restarts inside the flap window; no restarts until it expires)")
_SUPERVISOR_REPLICAS = gauge(
    "paddle_tpu_fleet_supervisor_replicas_count",
    "Supervisor-owned replicas by lifecycle state (running / pending "
    "= spawn scheduled, backoff not elapsed / quarantined / adopted = "
    "discovered via membership, process owned elsewhere), sampled "
    "every supervision tick", labelnames=("state",))
_SUPERVISOR_SCALE_EVENTS = counter(
    "paddle_tpu_fleet_supervisor_scale_events_total",
    "Autoscale decisions the supervisor applied, by direction (up / "
    "down)", labelnames=("direction",))
_DECODE_REQUESTS = counter(
    "paddle_tpu_decode_requests_total",
    "Generations finished by the continuous-batching decode loop, by "
    "outcome (eos / length / deadline / cancelled / error) — plus the "
    "admission verdicts shed (queue full), closed (draining), and "
    "expired (deadline passed while queued)",
    labelnames=("service", "outcome"))
_DECODE_STEPS = counter(
    "paddle_tpu_decode_steps_total",
    "Decode-step executable dispatches (one per token step over the "
    "whole slot array)", labelnames=("service",))
_DECODE_PREFILL_SECONDS = counter(
    "paddle_tpu_decode_prefill_seconds_total",
    "Cumulative walltime spent in prefill dispatches (prompt "
    "ingestion), the other half of the prefill-vs-decode split",
    labelnames=("service",))
_DECODE_STEP_SECONDS = counter(
    "paddle_tpu_decode_step_seconds_total",
    "Cumulative walltime spent in decode-step dispatches",
    labelnames=("service",))
_DECODE_OCCUPANCY = gauge(
    "paddle_tpu_decode_slot_occupancy_ratio",
    "Active generation slots / total slots, sampled every loop "
    "iteration (sustained 1.0 + shed growth = add slots or replicas)",
    labelnames=("service",))
_DECODE_TOKENS = histogram(
    "paddle_tpu_decode_tokens_count",
    "Tokens generated per finished generation",
    labelnames=("service",),
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024))
_GUARD_SKIPPED = counter(
    "paddle_tpu_guard_skipped_steps_total",
    "Training steps whose state update was skipped in-graph because the "
    "loss or a gradient was non-finite", labelnames=("program",))
_GUARD_NONFINITE = counter(
    "paddle_tpu_guard_nonfinite_total",
    "Non-finite observations in the guard's health summary, by location "
    "(loss / grad)", labelnames=("program", "location"))
_GUARD_SCALE = gauge(
    "paddle_tpu_guard_loss_scale_ratio",
    "Current dynamic loss scale (1.0 when scaling is disabled)",
    labelnames=("program",))
_GUARD_ROLLBACKS = counter(
    "paddle_tpu_guard_rollbacks_total",
    "Divergence rollbacks: restores to the newest generation whose "
    "manifest health block was clean")
_GUARD_DIVERGENCE = counter(
    "paddle_tpu_guard_divergence_total",
    "Divergence events raised by the host-side detector, by reason "
    "(nonfinite_steps / loss_spike / grad_norm_spike)",
    labelnames=("reason",))
_DEBUG_UNFLATTENABLE = counter(
    "paddle_tpu_debug_unflattenable_total",
    "Op outputs the FLAGS_check_nan_inf debug guard could not flatten "
    "(value escaped the NaN scan)", labelnames=("op",))
_ELASTIC_RESHARDS = counter(
    "paddle_tpu_elastic_reshards_total",
    "Live reshards performed by the elastic training loop, by state "
    "hand-off path (memory = in-process reshard, spill = checkpoint-"
    "directory fallback, restore = mid-chunk loss restored from the "
    "newest generation)", labelnames=("path",))
_ELASTIC_DOWNTIME = histogram(
    "paddle_tpu_elastic_downtime_seconds",
    "Training pause per live reshard: chunk-boundary stop to state "
    "redistributed (snapshot + executor rebuild + redistribution). A "
    "FIRST-seen device count's XLA re-lower happens lazily on the next "
    "dispatch — budget it from executor_compile_seconds_total / the "
    "bench's post-reshard chunk wall, not from this histogram",
    buckets=(0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0, 30.0, 100.0, 300.0))
_ELASTIC_STATE_MOVED = counter(
    "paddle_tpu_elastic_state_moved_bytes_total",
    "Parameter/optimizer/guard state bytes redistributed across live "
    "reshards", labelnames=("path",))
_ELASTIC_EPOCH = gauge(
    "paddle_tpu_elastic_cluster_epoch_count",
    "Current membership cluster epoch (bumps when the member set "
    "changes: join, drain, lease expiry)")
_ELASTIC_WORLD = gauge(
    "paddle_tpu_elastic_world_devices_count",
    "Device count of the mesh the elastic loop is currently training on")


# ---- hot-path helper facades (each call site stays one line) ----

def _never_raise(fn):
    """Telemetry must never kill training. A failure inside a facade —
    most plausibly the max_series cardinality cap on a long-churning
    label like program or member — degrades to ONE warning per site and
    dropped samples, instead of an exception escaping into Executor.run,
    an RPC handler, or a heartbeat loop."""
    warned = []

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except Exception as e:
            if not warned:
                warned.append(True)
                warnings.warn(
                    "telemetry %s failed (samples dropped from here on; "
                    "fix the instrumentation): %s" % (fn.__name__, e),
                    RuntimeWarning)
            return None
    return wrapper


@_never_raise
def record_executor_step(executor, step, duration, cache_hit, feed_bytes,
                         fetch_bytes, program, mesh=None, steps=1):
    """Per-run accounting shared by Executor and ParallelExecutor; the
    caller has already checked ``enabled()`` (and timed the step).

    ``steps`` > 1 is a chunked dispatch (``run_chunk``): the step
    counter advances by K for the ONE call, and the per-step duration
    histograms receive K samples of chunk_wall/K — so histogram count
    stays equal to logical steps and histogram sum stays equal to
    walltime, same invariants as sequential execution. Feed/fetch bytes
    are the whole super-batch (it crosses the boundary once)."""
    steps = max(1, int(steps))
    per_step = duration / steps
    _STEP_TIME.observe(per_step, count=steps, executor=executor)
    _STEPS.inc(steps, executor=executor)
    if feed_bytes:
        _FEED_BYTES.inc(feed_bytes, executor=executor)
    if fetch_bytes:
        _FETCH_BYTES.inc(fetch_bytes, executor=executor)
    plabel = program_label(program)
    if cache_hit:
        _JIT_HITS.inc(program=plabel)
    else:
        _COMPILE_SECONDS.inc(duration, executor=executor)
    if mesh is not None:
        _PE_STEP_TIME.observe(per_step, count=steps, mesh=mesh)
    emit("step", executor=executor, step=int(step),
         duration_s=duration, cache_hit=bool(cache_hit),
         feed_bytes=int(feed_bytes), fetch_bytes=int(fetch_bytes),
         program=plabel, **(({"mesh": mesh} if mesh else {})
                            | ({"steps": steps} if steps > 1 else {})))


@_never_raise
def record_jit_miss(program, signature):
    """Cache-miss bookkeeping: miss counter + recompile detector (which
    owns the recompiles counter, the diff event, and the storm warning)."""
    _JIT_MISSES.inc(program=program_label(program))
    return recompile_detector.record(
        getattr(program, "fingerprint", program), signature)


@_never_raise
def record_jit_hit(program):
    """Cache-hit bookkeeping for callers that manage their own compiled-
    executable cache (the serving engine) — keeps the jit hit/miss
    counters one source of truth across training and serving."""
    _JIT_HITS.inc(program=program_label(program))


@_never_raise
def record_serving_enqueue(batcher, depth):
    _SERVING_REQUESTS.inc(batcher=batcher)
    _SERVING_QUEUE_DEPTH.set(depth, batcher=batcher)


@_never_raise
def record_serving_batch(batcher, bucket, rows, waste_ratio):
    _SERVING_BATCHES.inc(batcher=batcher, bucket=bucket)
    _SERVING_BATCH_SIZE.observe(rows, batcher=batcher)
    _SERVING_PAD_WASTE.observe(waste_ratio, batcher=batcher)
    emit("serving_batch", batcher=batcher, bucket=int(bucket),
         rows=int(rows), waste_ratio=float(waste_ratio))


@_never_raise
def record_serving_reject(batcher, reason):
    _SERVING_REJECTED.inc(batcher=batcher, reason=reason)
    emit("serving_reject", batcher=batcher, reason=reason)


@_never_raise
def record_serving_first_response(batcher, seconds):
    _SERVING_TTFR.observe(seconds, batcher=batcher)


@_never_raise
def record_serving_compile(service, bucket, seconds, flops=0.0):
    _SERVING_COMPILES.inc(service=service, bucket=bucket)
    _SERVING_COMPILE_SECONDS.inc(seconds, service=service)
    if flops:
        _SERVING_BUCKET_COST.set(flops, service=service, bucket=bucket)
    emit("serving_compile", service=service, bucket=int(bucket),
         duration_s=seconds, flops=float(flops or 0.0))


@_never_raise
def record_aot_cache(service, event):
    _SERVING_AOT_CACHE.inc(service=service, event=event)
    emit("serving_aot_cache", service=service, event=event)


@_never_raise
def record_decode_request(service, outcome, tokens=None):
    """One generation reached a terminal outcome (or was refused at
    admission — then ``tokens`` is None and only the counter moves)."""
    _DECODE_REQUESTS.inc(service=service, outcome=outcome)
    if tokens is not None:
        _DECODE_TOKENS.observe(tokens, service=service)
    emit("decode_request", service=service, outcome=outcome,
         **({"tokens": int(tokens)} if tokens is not None else {}))


@_never_raise
def record_decode_prefill(service, seconds):
    _DECODE_PREFILL_SECONDS.inc(seconds, service=service)


@_never_raise
def record_decode_step(service, seconds):
    _DECODE_STEPS.inc(service=service)
    _DECODE_STEP_SECONDS.inc(seconds, service=service)


@_never_raise
def set_decode_occupancy(service, ratio):
    _DECODE_OCCUPANCY.set(ratio, service=service)


@_never_raise
def record_router_request(outcome, seconds):
    _ROUTER_REQUESTS.inc(outcome=outcome)
    _ROUTER_LATENCY.observe(seconds)


@_never_raise
def record_router_failover(reason):
    _ROUTER_FAILOVERS.inc(reason=reason)
    emit("router_failover", reason=reason)


@_never_raise
def record_router_ejection(reason):
    _ROUTER_EJECTIONS.inc(reason=reason)
    emit("router_ejection", reason=reason)


@_never_raise
def set_router_replicas(routable, unroutable):
    _ROUTER_REPLICAS.set(routable, state="routable")
    _ROUTER_REPLICAS.set(unroutable, state="unroutable")


@_never_raise
def record_router_hedge(outcome):
    _ROUTER_HEDGES.inc(outcome=outcome)


@_never_raise
def set_hedge_threshold(bucket, seconds):
    _ROUTER_HEDGE_THRESHOLD.set(seconds, bucket=str(bucket))


@_never_raise
def record_supervisor_restart(reason):
    _SUPERVISOR_RESTARTS.inc(reason=reason)
    emit("supervisor_restart", reason=reason)


@_never_raise
def record_supervisor_quarantine():
    _SUPERVISOR_QUARANTINES.inc()
    emit("supervisor_quarantine")


@_never_raise
def set_supervisor_replicas(**states):
    for state, n in states.items():
        _SUPERVISOR_REPLICAS.set(n, state=state)


@_never_raise
def record_supervisor_scale(direction):
    _SUPERVISOR_SCALE_EVENTS.inc(direction=direction)
    emit("supervisor_scale", direction=direction)


@_never_raise
def record_allreduce_payload(mesh_label, nbytes):
    if nbytes:
        _ALLREDUCE_BYTES.inc(nbytes, mesh=mesh_label)


@_never_raise
def record_comm_dispatch(mesh_label, buckets, pre_bytes, post_bytes,
                         allreduce_bytes):
    """One guarded-dispatch's gradient-communication accounting from
    the executor's static CommPlan (no device sync)."""
    _COMM_BUCKETS.set(buckets, mesh=mesh_label)
    if pre_bytes:
        _COMM_PRE_BYTES.inc(pre_bytes, mesh=mesh_label)
    if post_bytes:
        _COMM_POST_BYTES.inc(post_bytes, mesh=mesh_label)
    if allreduce_bytes:
        _COMM_AR_BYTES.inc(allreduce_bytes, mesh=mesh_label)


@_never_raise
def reader_queue_observed(reader, depth, starved_seconds=0.0):
    _READER_DEPTH.set(depth, reader=reader)
    if starved_seconds > 0.0:
        _READER_STARVED.inc(starved_seconds, reader=reader)


def timed_get(q, reader):
    """Instrumented ``q.get()`` for prefetch consumers: records queue
    depth and, when the queue was empty at entry (producer-starved), the
    time spent blocked. The caller has already checked ``enabled()``."""
    t0 = time.perf_counter() if q.empty() else None
    item = q.get()
    reader_queue_observed(
        reader, q.qsize(),
        (time.perf_counter() - t0) if t0 is not None else 0.0)
    return item


@_never_raise
def observe_rpc(service, method, seconds):
    _RPC_LATENCY.observe(seconds, service=service, method=method)


@contextlib.contextmanager
def rpc_timer(service, method):
    """Times one server-side RPC dispatch into the latency histogram;
    free when telemetry is disabled."""
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        observe_rpc(service, str(method), time.perf_counter() - t0)


@_never_raise
def record_heartbeat_age(kind, member, age_seconds):
    _HEARTBEAT_AGE.set(age_seconds, kind=kind, member=member)


@_never_raise
def record_fault(site, action):
    _FAULTS.inc(site=site, action=action)


@_never_raise
def record_rpc_retry(service, method):
    _RPC_RETRIES.inc(service=service, method=str(method))


@_never_raise
def record_rpc_client_error(service, kind):
    _RPC_CLIENT_ERRORS.inc(service=service, kind=kind)


@_never_raise
def set_breaker_state(service, state_code):
    _BREAKER_STATE.set(state_code, service=service)


@_never_raise
def record_breaker_transition(service, to):
    _BREAKER_TRANSITIONS.inc(service=service, to=to)
    emit("breaker", service=service, to=to)


@_never_raise
def record_guard_health(program, skipped, nonfinite_loss, nonfinite_grad,
                        loss_scale):
    """Per-dispatch guard accounting (one call per run/run_chunk on the
    guarded path): the caller has already checked ``enabled()``."""
    plabel = program_label(program)
    if skipped:
        _GUARD_SKIPPED.inc(skipped, program=plabel)
    if nonfinite_loss:
        _GUARD_NONFINITE.inc(nonfinite_loss, program=plabel,
                             location="loss")
    if nonfinite_grad:
        _GUARD_NONFINITE.inc(nonfinite_grad, program=plabel,
                             location="grad")
    _GUARD_SCALE.set(loss_scale, program=plabel)
    if skipped:
        emit("guard_skip", program=plabel, skipped=int(skipped),
             nonfinite_loss=int(nonfinite_loss),
             nonfinite_grad=int(nonfinite_grad),
             loss_scale=float(loss_scale))


@_never_raise
def record_guard_rollback():
    _GUARD_ROLLBACKS.inc()


@_never_raise
def record_guard_divergence(reason):
    _GUARD_DIVERGENCE.inc(reason=reason)
    emit("divergence", reason=reason)


@_never_raise
def record_debug_unflattenable(op_type):
    _DEBUG_UNFLATTENABLE.inc(op=op_type)


@_never_raise
def record_reshard(path, downtime_s, bytes_moved, epoch=None,
                   devices=None):
    """One live reshard performed by the elastic loop. ``path`` is the
    state hand-off route (memory / spill / restore)."""
    _ELASTIC_RESHARDS.inc(path=path)
    _ELASTIC_DOWNTIME.observe(downtime_s)
    if bytes_moved:
        _ELASTIC_STATE_MOVED.inc(bytes_moved, path=path)
    if epoch is not None:
        _ELASTIC_EPOCH.set(epoch)
    if devices is not None:
        _ELASTIC_WORLD.set(devices)
    emit("reshard", path=path, downtime_s=float(downtime_s),
         bytes_moved=int(bytes_moved),
         **(({"epoch": int(epoch)} if epoch is not None else {})
            | ({"devices": int(devices)} if devices is not None else {})))


@_never_raise
def record_cluster_epoch(epoch):
    _ELASTIC_EPOCH.set(epoch)


@_never_raise
def set_world_size(devices):
    _ELASTIC_WORLD.set(devices)


@_never_raise
def record_quarantine(reason):
    _CKPT_QUARANTINED.inc(reason=reason)


@_never_raise
def record_preemption():
    _PREEMPTIONS.inc()


@_never_raise
def set_resume_step(step):
    _RESUME_STEP.set(step)
    emit("restore", resume_step=int(step))


@_never_raise
def record_checkpoint(op, seconds, nbytes):
    _CKPT_TIME.observe(seconds, op=op)
    if nbytes:
        _CKPT_BYTES.inc(nbytes, op=op)
    emit("checkpoint", op=op, duration_s=seconds, bytes=int(nbytes))


def value_bytes(v):
    """Best-effort byte size of a feed/fetch value (metadata only — never
    forces a device sync)."""
    nb = getattr(v, "nbytes", None)
    if nb is not None:
        return int(nb)
    data = getattr(v, "data", None)  # PackedSeq
    if data is not None and hasattr(data, "nbytes"):
        lengths = getattr(v, "lengths", None)
        return int(data.nbytes) + int(getattr(lengths, "nbytes", 0) or 0)
    return 0


def sample_device_memory(device=None):
    """Update the device live/peak gauges from the PyTorch caching
    allocator of ``device`` (the current card when None): live is
    ``torch.cuda.memory_allocated``, peak ``max_memory_allocated``. A
    CPU device, or no card, leaves the gauges alone."""
    try:
        import torch

        if device is not None and torch.device(device).type != "cuda":
            return
        if not torch.cuda.is_available():
            return
        _DEVICE_LIVE.set(torch.cuda.memory_allocated(device))
        _DEVICE_PEAK.set(torch.cuda.max_memory_allocated(device))
    except Exception:
        pass
