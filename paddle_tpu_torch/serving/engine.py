"""One-shot inference engine: one captured CUDA graph per batch bucket.

Capability parity: the JAX package's ``serving/engine.py``. A
``ServingEngine`` serves one inference ``Program`` at a fixed set of
batch-size *buckets* (1/2/4/.../max_batch by default): a request is
padded to the nearest bucket, run, and sliced back to its rows.

* **Warm before ready.** ``warmup()`` builds every bucket: on the card
  it runs the bucket once eagerly on zero feeds (on a side stream: the
  kernels are built and loaded, the library handles made) and captures
  it into a CUDA graph (``core/graphs.CapturedRun``) over fixed feed
  buffers and the scope's state tensors, the port's form of the JAX
  package's ahead-of-time executables; on the CPU it runs the bucket
  once eagerly. ``ready`` flips only after the last bucket, and
  ``compile_count()`` (``len(buckets)`` after warmup) is frozen while
  traffic stays inside the buckets.
* **The cache** (``serving/compile_cache.py``) is keyed on (program
  fingerprint, bucket, feed dtype signature); a build is recorded as a
  jit miss and a ``paddle_tpu_serving_bucket_compiles_total``, a hit as
  a jit hit. ``bucket_costs()`` gives each bucket's counted flops.
* **Replays.** A bucket's graph reads fixed buffers, so its copy-in (a
  request's rows straight into the buffer, numpy or tensors from either
  device, the rows past them zeroed), its replay and its copy-out run
  under the bucket's lock, all on the engine's own stream (which first waits for the caller's stream, and
  which the caller's stream waits for after). Numpy results are read
  under the lock; ``return_numpy=False`` gives clones, which no later
  replay overwrites. Concurrent ``infer()`` calls are safe.
* **State.** The graphs captured the scope's state tensors, so
  ``swap_state`` copies the new values INTO them (shapes and dtypes
  must match) under the swap lock, and a replay is launched under the
  same lock: one replay reads one generation's weights. A scope entry
  replaced by someone else (``scope.set_var``) is copied into the
  captured tensor before the next run, and the scope takes it back.
* ``quantize="int8"`` stores every float state tensor of two or more
  dims as int8 plus one float32 scale (symmetric, per tensor; the JAX
  package's grid, computed on the host with numpy) and dequantizes it
  inside the run (inside the captured graph on the card).

Sequence feeds (``lod_level > 0``) take a ``PackedSeq`` padded to
``seq_lens[name]`` steps; padded rows get length 1 (a mean-pool divides
by it), and their outputs are sliced off before anyone sees them.

``place`` defaults to the card (``CUDAPlace(0)``), which raises when
there is none; the scope's state must live on the engine's device. The
persistent AOT cache (``aot_cache=``) is not ported.
"""

import contextlib
import threading
import time

import numpy as np
import torch

from paddle_tpu_torch import telemetry
from paddle_tpu_torch import tracing
from paddle_tpu_torch.core.executor import (external_reads_and_writes,
                                            run_program)
from paddle_tpu_torch.core.infer import dtype_name, torch_dtype
from paddle_tpu_torch.core.lower import PackedSeq, step_key
from paddle_tpu_torch.core.place import default_place
from paddle_tpu_torch.core.scope import global_scope

__all__ = ["ServingEngine", "NotReady", "BatchTooLarge", "default_buckets"]


class NotReady(RuntimeError):
    """The engine has not finished warmup (or was asked for an unwarmed
    bucket with ``strict=True``)."""


class BatchTooLarge(ValueError):
    """A request's batch exceeds the engine's largest bucket. Split the
    request or build the engine with a larger ``max_batch``."""


def default_buckets(max_batch, start=1):
    """Powers of two from ``start`` up to and including ``max_batch``
    (1/2/4/8/... by default). A non-power-of-two ``max_batch`` becomes
    the final bucket."""
    out, b = [], int(start)
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(int(max_batch))
    return tuple(sorted(set(out)))


def _find_var(program, name):
    for b in program.blocks:
        if b.has_var_local(name):
            return b.vars[name]
    return None


def _dtype_of(v):
    if isinstance(v, torch.Tensor):
        return dtype_name(v.dtype)
    return np.asarray(v).dtype.name


class _Template:
    """A feed's padded shape and dtype at one bucket."""

    __slots__ = ("shape", "dtype", "packed")

    def __init__(self, shape, dtype, packed):
        self.shape, self.dtype, self.packed = shape, dtype, packed


class _Bucket:
    """One built bucket. On the card: its graph (``run``), the feed
    buffers and the outputs it writes, and the lock its copy-in, replay
    and copy-out run under; run eagerly (``run`` None) otherwise."""

    __slots__ = ("run", "feeds", "outs", "lock")

    def __init__(self):
        self.run = None
        self.feeds = None
        self.outs = None
        self.lock = threading.Lock()


class ServingEngine:
    """``ServingEngine(program, feed_names, fetch_names).warmup()`` then
    ``infer({name: array})`` — pads the batch to the nearest bucket,
    replays the bucket's graph, slices the padding back off.

    ``program`` must be an inference program (``io.load_inference_model``
    or ``io.get_inference_program``): an op writing a persistable
    variable (an optimizer update) is rejected at construction, and so
    is a fetch that is not batch-led (a mean over the batch would
    include padding rows and coalesced batch-mates' rows).

    ``seq_lens`` maps a sequence feed name to its fixed padded time
    dimension. See the module docstring for ``quantize``, ``place`` and
    the threading contract."""

    def __init__(self, program, feed_names, fetch_names, scope=None,
                 max_batch=8, buckets=None, seq_lens=None,
                 service="serving", quantize=None, place=None):
        self.device = default_place(place)
        self.program = program
        self.feed_names = tuple(feed_names)
        self.fetch_names = tuple(
            v if isinstance(v, str) else v.name for v in fetch_names)
        self.scope = scope if scope is not None else global_scope()
        self.buckets = tuple(sorted(set(
            int(b) for b in (buckets or default_buckets(max_batch)))))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError("buckets must be positive ints, got %r"
                             % (self.buckets,))
        self.max_batch = self.buckets[-1]
        self.service = service
        self._seq_lens = dict(seq_lens or {})
        if quantize not in (None, "int8"):
            raise ValueError("quantize must be None or 'int8', got %r"
                             % (quantize,))
        self._quantize = quantize
        # swaps and replay launches are serialized: one run reads one
        # generation's weights
        self._swap_lock = threading.Lock()
        self.deploy_generation = None

        reads, written = external_reads_and_writes(program)
        feed_set = set(self.feed_names)
        bad = sorted(
            n for n in written
            if (v := _find_var(program, n)) is not None and v.persistable)
        if bad:
            raise ValueError(
                "ServingEngine needs a pure inference program, but ops "
                "write persistable state %s — transpile/prune the "
                "training program first (io.get_inference_program)" % bad)
        for fn in self.fetch_names:
            var = _find_var(program, fn)
            shape = getattr(var, "shape", None) if var is not None \
                else None
            if not shape or int(shape[0]) != -1:
                raise ValueError(
                    "fetch %r has shape %s, which is not batch-led: a "
                    "batch-reducing fetch (e.g. a mean over the batch) "
                    "would silently include padding rows and coalesced "
                    "batch-mates' rows — fetch per-row outputs and "
                    "reduce client-side" % (fn, shape))
        self._state_names = tuple(
            n for n in reads
            if n not in feed_set and self.scope.find_var(n) is not None)
        missing = [n for n in reads
                   if n not in feed_set
                   and self.scope.find_var(n) is None
                   and n not in written]
        if missing:
            raise ValueError(
                "inference program reads %s which are neither feeds nor "
                "in scope (load the parameters first)" % missing)
        elsewhere = sorted(
            n for n in self._state_names
            if getattr(self.scope.find_var(n), "device", self.device)
            != self.device)
        if elsewhere:
            raise ValueError(
                "state %s is not on the engine's device %s (load the "
                "model with an Executor on that place)"
                % (elsewhere, self.device))
        # the state tensors every run reads (and every graph captured)
        self._state_bufs = {n: self.scope.find_var(n)
                            for n in self._state_names}
        self._qstate = None     # name -> (int8 tensor, float32 scale)
        self._deq = {}          # name -> original dtype name
        if quantize == "int8":
            self._qstate = {}
            for n in self._state_names:
                q = self._quantize_weight(n, self._state_bufs[n])
                if q is not None:
                    self._qstate[n] = q

        from paddle_tpu_torch.serving.compile_cache import CompiledCache
        self._compiled_cache = CompiledCache(service=service)
        self._ready = False
        self._sig = tuple(
            (n, str(v.dtype) if (v := _find_var(program, n)) is not None
             else "?") for n in self.feed_names)
        self._templates = {}
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        # capture each bucket on the card; False runs every bucket
        # eagerly there (the reference a replay is held against)
        self._capture = self.device.type == "cuda"

    # ---- bucket selection ----

    def bucket_for(self, n):
        """Smallest bucket >= n; ``BatchTooLarge`` past the last one."""
        if n < 1:
            raise ValueError("batch must be >= 1, got %d" % n)
        for b in self.buckets:
            if n <= b:
                return b
        raise BatchTooLarge(
            "batch %d exceeds max bucket %d (buckets: %s)"
            % (n, self.max_batch, list(self.buckets)))

    @property
    def ready(self):
        return self._ready

    def validate_feed(self, name, v):
        """Shape-check ONE request's feed against the declared template
        (trailing dims; the batch dim is the caller's). The batcher runs
        this at admission so a malformed request is rejected alone
        instead of failing the batch-mates it would coalesce with."""
        template = self._template(name, self.buckets[0])
        if template.packed:
            if not isinstance(v, PackedSeq):
                raise TypeError("feed %r needs a PackedSeq" % name)
            shape = tuple(v.data.shape)
            if shape[2:] != template.shape[2:]:
                raise ValueError(
                    "feed %r feature shape %s != declared %s"
                    % (name, shape[2:], template.shape[2:]))
            if shape[1] > template.shape[1]:
                raise ValueError(
                    "feed %r time dim %d exceeds padded seq_len %d"
                    % (name, shape[1], template.shape[1]))
        else:
            if isinstance(v, PackedSeq):
                raise TypeError("feed %r is dense, got a PackedSeq"
                                % name)
            shape = tuple(np.shape(v))
            if shape[1:] != template.shape[1:]:
                raise ValueError(
                    "feed %r shape %s != declared %s"
                    % (name, shape[1:], template.shape[1:]))

    def compile_count(self):
        """Buckets built so far (== len(buckets) after warmup, and
        forever after while traffic stays inside the buckets).
        Lock-free: readiness probes answer during a capture."""
        return self._compiled_cache.count

    def bucket_costs(self):
        """{bucket: {"flops": n}} counted when each bucket was built
        (``compile_cache`` docstring)."""
        return self._compiled_cache.costs()

    # ---- building ----

    def _template(self, name, bucket):
        cached = self._templates.get((name, bucket))
        if cached is not None:
            return cached
        var = _find_var(self.program, name)
        if var is None or var.shape is None:
            raise ValueError("feed %r is not a declared variable of the "
                             "program" % name)
        shape = [int(d) for d in var.shape]
        shape[0] = int(bucket)
        for i in range(1, len(shape)):
            if shape[i] == -1:
                t = self._seq_lens.get(name)
                if t is None:
                    raise ValueError(
                        "feed %r has unknown dim %d; pass seq_lens={%r: N} "
                        "to fix the padded length" % (name, i, name))
                shape[i] = int(t)
        t = _Template(tuple(shape), np.dtype(var.dtype), var.lod_level > 0)
        self._templates[(name, bucket)] = t
        return t

    def _quantize_weight(self, name, v):
        """Symmetric per-tensor int8 of a float tensor of two or more
        dims, as the JAX package quantizes (host-side numpy, once at
        load and at each swap): ``(int8 tensor, float32 scale)`` on the
        engine's device, or None for a tensor that stays as it is."""
        if not isinstance(v, torch.Tensor) or v.dim() < 2 \
                or not v.is_floating_point() or not v.numel():
            return None
        q, scale = _int8_grid(v.detach().float().cpu().numpy())
        self._deq[name] = dtype_name(v.dtype)
        return (torch.from_numpy(q).to(self.device),
                torch.tensor(scale, dtype=torch.float32,
                             device=self.device))

    def _env_state(self):
        """The state as the program reads it: the state tensors, with
        each quantized one dequantized (on the device: inside the graph
        under capture)."""
        env = dict(self._state_bufs)
        if self._qstate:
            for n, (q, scale) in self._qstate.items():
                env[n] = (q.to(torch.float32) * scale).to(
                    torch_dtype(self._deq[n]))
        return env

    def _sync_state(self):
        """Copy a scope entry someone replaced into the tensor the runs
        read, and put that tensor back in the scope (call under the swap
        lock). A quantized engine reads its own int8 state, refreshed by
        ``swap_state`` only."""
        for n, buf in self._state_bufs.items():
            cur = self.scope.find_var(n)
            if cur is buf:
                continue
            if not isinstance(cur, torch.Tensor) \
                    or tuple(cur.shape) != tuple(buf.shape) \
                    or cur.dtype != buf.dtype:
                raise ValueError(
                    "scope variable %r is %s, not the %s %s the engine "
                    "was built over" % (
                        n, None if cur is None else "%s %s" % (
                            getattr(cur, "dtype", type(cur)),
                            tuple(getattr(cur, "shape", ()))),
                        buf.dtype, tuple(buf.shape)))
            buf.copy_(cur)
            self.scope.set_var(n, buf)

    def _run_program(self, feeds, rngs=None):
        """The program over the state and ``feeds`` (name -> tensor or
        PackedSeq on the device); returns the fetched values."""
        env = self._env_state()
        env.update(feeds)
        run_program(self.program, self.device, env,
                    step_key(self.program.random_seed, 0), rngs=rngs,
                    training=False)
        return [env[n] for n in self.fetch_names]

    def _zero_feeds(self, bucket):
        """Zeroed feed buffers of ``bucket`` rows on the engine's device
        (a sequence feed's lengths 1: mean-pools divide by them)."""
        feeds = {}
        for name in self.feed_names:
            t = self._template(name, bucket)
            data = torch.zeros(t.shape, dtype=torch_dtype(t.dtype.name),
                               device=self.device)
            feeds[name] = (PackedSeq(data, torch.ones(
                (bucket,), dtype=torch.int32, device=self.device))
                if t.packed else data)
        return feeds

    def _build(self, bucket):
        """Build ``bucket``: returns ``(entry, cost)``."""
        from torch.utils.flop_counter import FlopCounterMode

        entry = _Bucket()
        if not self._capture:
            with self._swap_lock, FlopCounterMode(display=False) as fc:
                self._sync_state()
                self._run_program(self._zero_feeds(bucket))
            return entry, {"flops": float(fc.get_total_flops())}

        from paddle_tpu_torch.core import graphs

        dev = self.device
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        stream.wait_stream(self._stream)
        draws = graphs.RecordDraws()
        with self._swap_lock:
            self._sync_state()
            with torch.cuda.stream(stream), \
                    FlopCounterMode(display=False) as fc:
                self._run_program(self._zero_feeds(bucket), rngs=draws)
            entry.feeds = self._zero_feeds(bucket)
            entry.run = graphs.CapturedRun(dev, draws.calls)
            entry.outs = entry.run.capture(
                lambda rngs: self._run_program(entry.feeds, rngs=rngs),
                stream)
            self._stream.wait_stream(stream)
        return entry, {"flops": float(fc.get_total_flops())}

    def _compiled(self, bucket, allow_compile=True):
        key = (bucket, self._sig)
        if not allow_compile:
            hit = self._compiled_cache.lookup(self.program, key)
            if hit is None:
                raise NotReady(
                    "bucket %d not warmed (warmed: %s) — call warmup() "
                    "or pass a bucket-aligned batch"
                    % (bucket, self.buckets))
            return hit
        return self._compiled_cache.get(
            self.program, key, lambda: self._build(bucket),
            cost_key=bucket, bucket=bucket,
            miss_sig=lambda: {
                "serving_bucket": bucket,
                "feeds": ",".join("%s:%s" % p for p in self._sig),
                "fetch": ",".join(self.fetch_names)})

    def warmup(self):
        """Build EVERY bucket; the engine reports ``ready`` only once
        the last one exists. Returns {bucket: seconds}."""
        times = {}
        for b in self.buckets:
            t0 = time.perf_counter()
            self._compiled(b)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            times[b] = time.perf_counter() - t0
        self._ready = True
        return times

    # ---- state ----

    def swap_state(self, new_state):
        """Hot-swap the bound parameters to a new generation's values
        (numpy arrays or tensors), copied into the tensors the graphs
        read.

        Every state name must be present with the exact shape and dtype
        the engine was built over (a mismatch raises before anything is
        touched). Extra names in ``new_state`` are ignored. Returns the
        replaced values (name -> a copy of the old tensor) so a failed
        multi-target swap can be reversed."""
        missing = sorted(set(self._state_names) - set(new_state))
        if missing:
            raise ValueError("swap state is missing %s" % (missing,))
        for n in self._state_names:
            cur, new = self._state_bufs[n], new_state[n]
            if (tuple(np.shape(new)) != tuple(cur.shape)
                    or _dtype_of(new) != dtype_name(cur.dtype)):
                raise ValueError(
                    "swap would change the state signature of %r "
                    "(%s %s -> %s %s) — that is a different bucket "
                    "family, deploy it as a fresh replica instead"
                    % (n, dtype_name(cur.dtype), tuple(cur.shape),
                       _dtype_of(new), tuple(np.shape(new))))
        with self._swap_lock, self._on_stream():
            self._sync_state()
            old = {}
            for n in self._state_names:
                cur = self._state_bufs[n]
                old[n] = cur.clone()
                new = new_state[n]
                cur.copy_(new if isinstance(new, torch.Tensor)
                          else torch.from_numpy(np.asarray(new)))
                if self._qstate and n in self._qstate:
                    q, scale = self._qstate[n]
                    nq, nscale = _int8_grid(
                        cur.detach().float().cpu().numpy())
                    q.copy_(torch.from_numpy(nq))
                    scale.fill_(float(nscale))
        return old

    def _on_stream(self):
        """Work on the engine's stream, ordered after the caller's (and
        the caller's after it, on exit)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return _StreamContext(self._stream, self.device)

    # ---- inference ----

    def infer(self, feed, return_numpy=True, strict=False):
        """Run one padded-batch inference. ``feed`` maps each feed name
        to an array whose leading dim is the request batch (all feeds
        agree); results are sliced back to that batch. ``strict=True``
        refuses to build a cold bucket (serving mode: warmup owns every
        build)."""
        n = None
        for name in self.feed_names:
            if name not in feed:
                raise ValueError("missing feed %r" % name)
            v = feed[name]
            rows = (v.data.shape[0] if isinstance(v, PackedSeq)
                    else np.shape(v)[0])
            if n is None:
                n = int(rows)
            elif int(rows) != n:
                raise ValueError(
                    "feed %r has batch %d but %r has %d"
                    % (name, rows, self.feed_names[0], n))
        bucket = self.bucket_for(n)
        # child_span: only records under an active trace (the batcher
        # activates a request's context)
        with tracing.child_span("paddle_tpu.serving.engine_infer",
                                bucket=bucket, rows=n,
                                pad_rows=bucket - n):
            rows = {name: self._rows(name, feed[name], bucket)
                    for name in self.feed_names}
            entry = self._compiled(bucket, allow_compile=not strict)
            if entry.run is None:
                outs = self._run_eager(rows, n, bucket, return_numpy)
            else:
                outs = self._replay(entry, rows, n, return_numpy)
            if telemetry.enabled():
                self._note_output(outs)
        return outs

    def _run_eager(self, rows, n, bucket, return_numpy):
        feeds = self._zero_feeds(bucket)
        for k, buf in feeds.items():
            _fill(buf, rows[k], n)
        with self._swap_lock:
            self._sync_state()
            outs = self._run_program(feeds)
            outs = [self._slice(o, n) for o in outs]
            if return_numpy:
                return [_numpy(o) for o in outs]
        return outs

    def _replay(self, entry, rows, n, return_numpy):
        with entry.lock, self._on_stream():
            for k, buf in entry.feeds.items():
                _fill(buf, rows[k], n)
            with self._swap_lock:
                self._sync_state()
                entry.run.replay(step_key(self.program.random_seed, 0))
            outs = [self._slice(o, n) for o in entry.outs]
            if return_numpy:
                return [_numpy(o) for o in outs]
            return [_clone(o) for o in outs]

    def _note_output(self, outs):
        """Export the first fetch's batch mean as a gauge — the canary
        judge's output-distribution signal."""
        o = outs[0] if outs else None
        if isinstance(o, PackedSeq):
            o = o.data
        if o is None:
            return
        arr = _numpy(o) if isinstance(o, torch.Tensor) else np.asarray(o)
        if arr.dtype.kind not in "fiu" or not arr.size:
            return
        telemetry.gauge(
            "paddle_tpu_deploy_output_mean_ratio",
            "batch mean of the first fetch, last dispatch — the canary "
            "judge's output-distribution signal").set(
                float(np.mean(arr.astype(np.float64))))

    def _rows(self, name, v, bucket):
        """One feed's request rows, checked (:meth:`validate_feed`), as
        a tensor of the declared dtype where they lie (on the host for
        numpy; a PackedSeq of such tensors for a sequence feed)."""
        self.validate_feed(name, v)
        dtype = torch_dtype(self._template(name, bucket).dtype.name)
        if isinstance(v, PackedSeq):
            return PackedSeq(_tensor(v.data, dtype),
                             _tensor(v.lengths, torch.int32))
        return _tensor(v, dtype)

    @staticmethod
    def _slice(o, n):
        if isinstance(o, PackedSeq):
            return PackedSeq(o.data[:n], o.lengths[:n])
        if hasattr(o, "ndim") and o.ndim >= 1:
            return o[:n]
        return o


def _int8_grid(arr):
    """The JAX package's symmetric per-tensor int8 grid of a float32
    array: ``(q int8, float32 scale)``."""
    absmax = float(np.max(np.abs(arr.astype(np.float32))))
    scale = max(absmax, 1e-30) / 127.0
    q = np.clip(np.round(arr.astype(np.float32) / scale),
                -127, 127).astype(np.int8)
    return q, np.float32(scale)


def _numpy(o):
    """A fetched value as numpy (a PackedSeq's data); bfloat16 comes
    back widened to float32, as the executor returns it."""
    if isinstance(o, PackedSeq):
        o = o.data
    if o.dtype == torch.bfloat16:
        o = o.float()
    return o.detach().cpu().numpy()


def _tensor(v, dtype):
    """A feed value as a tensor of ``dtype``, where it lies (numpy on
    the host, without a copy where it already has the dtype)."""
    if isinstance(v, torch.Tensor):
        return v.detach().to(dtype)
    arr = np.asarray(v)
    if arr.dtype.name != dtype_name(dtype):
        arr = arr.astype(dtype_name(dtype))
    return torch.from_numpy(np.ascontiguousarray(arr))


def _fill(buf, rows, n):
    """Write ``n`` request rows into a bucket's zero-padded feed buffer
    and zero the rows past them (a sequence's padded rows get length
    1, its steps past the request's longest 0)."""
    if isinstance(buf, PackedSeq):
        t = rows.data.shape[1]
        buf.data[:n, :t].copy_(rows.data)
        buf.data[:n, t:].zero_()
        buf.data[n:].zero_()
        buf.lengths[:n].copy_(rows.lengths)
        buf.lengths[n:].fill_(1)
        return
    buf[:n].copy_(rows)
    buf[n:].zero_()


def _clone(o):
    if isinstance(o, PackedSeq):
        return PackedSeq(o.data.clone(), o.lengths.clone())
    return o.clone()


class _StreamContext:
    """Run on ``stream`` after the caller's current stream; the caller's
    stream waits for ``stream`` on exit."""

    def __init__(self, stream, device):
        self.stream, self.device = stream, device
        self._ctx = None

    def __enter__(self):
        caller = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(caller)
        self._ctx = torch.cuda.stream(self.stream)
        self._ctx.__enter__()
        return self

    def __exit__(self, *exc):
        self._ctx.__exit__(*exc)
        torch.cuda.current_stream(self.device).wait_stream(self.stream)
        return False
