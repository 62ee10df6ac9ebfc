"""Deadline-aware dynamic micro-batcher with bounded-queue admission.

Capability parity: the JAX package's ``serving/batcher.py``, over the
port's ``ServingEngine`` (a batch is one replay of a bucket's CUDA
graph on the card).

Concurrent requests enqueue; one dispatcher thread coalesces them into
a batch up to ``max_batch`` rows or ``max_delay_ms`` after the oldest
waiting request arrived — whichever comes first — pads the batch to the
engine's nearest bucket (so steady traffic never triggers a recompile),
runs the pre-compiled executable once, and scatters per-request result
slices back to the waiting futures.

Admission control is a *bounded* queue: past ``max_queue`` waiting
requests, ``submit()`` raises ``Overloaded`` immediately (load
shedding) instead of growing latency without bound — the
``paddle_tpu_serving_rejected_total`` counter is the overload signal.
Per-request deadlines propagate: an expired request is failed with
``DeadlineExceeded`` at dispatch instead of wasting a batch slot, and
the coalescing window never waits past the earliest deadline in the
queue.

``close(drain=True)`` is the graceful-drain half of SIGTERM handling:
new submits are refused, every request already admitted is flushed
through the engine, then the dispatcher exits. No admitted request is
ever silently dropped — each future resolves with a result or a typed
exception.
"""

import collections
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from paddle_tpu_torch import telemetry
from paddle_tpu_torch import tracing
from paddle_tpu_torch.core.lower import PackedSeq, concat_time_padded
from paddle_tpu_torch.serving.engine import BatchTooLarge

__all__ = ["DynamicBatcher", "Overloaded", "Closed", "DeadlineExceeded"]


class Overloaded(RuntimeError):
    """The admission queue is full: the request was rejected at the
    door (load shedding), not queued into unbounded latency. Back off
    and retry."""


class Closed(RuntimeError):
    """The batcher is draining or closed; no new work is admitted."""


class DeadlineExceeded(TimeoutError):
    """The request's deadline elapsed before its batch dispatched."""


class _Pending:
    __slots__ = ("feed", "rows", "future", "enqueued", "deadline", "ctx")

    def __init__(self, feed, rows, deadline):
        self.feed = feed
        self.rows = rows
        self.future = Future()
        self.enqueued = time.monotonic()
        self.deadline = deadline
        # trace context captured at ADMISSION (the submitting thread —
        # for RPC requests, the server span): the dispatcher thread
        # records this request's queue-wait/batch-form/compute spans
        # against it once the batch runs
        self.ctx = tracing.current() if tracing.enabled() else None


class DynamicBatcher:
    """``DynamicBatcher(engine).submit({name: array}) -> Future`` whose
    result is the per-request list of fetch arrays."""

    def __init__(self, engine, max_batch=None, max_delay_ms=5.0,
                 max_queue=128, name="default"):
        self.engine = engine
        self.max_batch = min(int(max_batch or engine.max_batch),
                             engine.max_batch)
        self.max_delay = float(max_delay_ms) / 1000.0
        self.max_queue = int(max_queue)
        self.name = name
        self._cv = threading.Condition()
        self._queue = collections.deque()
        self._closed = False
        self._batches = 0
        self._thread = threading.Thread(
            target=self._dispatch_loop, daemon=True,
            name="serving-batcher-%s" % name)
        self._thread.start()

    # ---- admission ----

    def submit(self, feed, timeout=None):
        """Enqueue one request (each feed's leading dim is its row
        count; all feeds agree). Returns a Future resolving to the list
        of fetch arrays sliced to this request's rows. Raises
        ``Overloaded`` when the bounded queue is full, ``Closed`` after
        drain began, ``BatchTooLarge`` for oversized requests."""
        rows = None
        for n in self.engine.feed_names:
            if n not in feed:
                raise ValueError("missing feed %r" % n)
            v = feed[n]
            # full shape validation at ADMISSION: a malformed request
            # must fail alone, never poison the batch-mates it would
            # have coalesced with
            self.engine.validate_feed(n, v)
            r = int(v.data.shape[0] if isinstance(v, PackedSeq)
                    else np.shape(v)[0])
            rows = r if rows is None else rows
            if r != rows:
                raise ValueError("feed row counts disagree: %d vs %d"
                                 % (r, rows))
        if rows > self.max_batch:
            # can never fit ANY batch this batcher dispatches: a
            # permanent condition, so the error must be the
            # non-retryable BatchTooLarge, never Overloaded ("back off
            # and retry" would loop forever)
            self.engine.bucket_for(rows)  # engine-level BatchTooLarge
            raise BatchTooLarge(
                "request rows %d exceed batcher max_batch %d; split "
                "the request" % (rows, self.max_batch))
        deadline = (time.monotonic() + timeout) if timeout else None
        req = _Pending(feed, rows, deadline)
        with self._cv:
            if self._closed:
                if telemetry.enabled():
                    telemetry.record_serving_reject(self.name, "closed")
                raise Closed("serving is draining; request refused")
            if len(self._queue) >= self.max_queue:
                if telemetry.enabled():
                    telemetry.record_serving_reject(self.name, "queue_full")
                raise Overloaded(
                    "Overloaded: %d requests waiting (max_queue=%d)"
                    % (len(self._queue), self.max_queue))
            self._queue.append(req)
            if telemetry.enabled():
                telemetry.record_serving_enqueue(self.name,
                                                 len(self._queue))
            self._cv.notify_all()
        return req.future

    def depth(self):
        with self._cv:
            return len(self._queue)

    def batches_dispatched(self):
        with self._cv:
            return self._batches

    # ---- the dispatcher ----

    def _take_batch(self):
        """Block until work exists, coalesce up to max_batch rows or
        max_delay (bounded further by the earliest deadline), then pop
        the batch. Returns None when closed and fully drained."""
        with self._cv:
            while not self._queue:
                if self._closed:
                    return None
                # submit() and close() both notify under this lock, so
                # a plain wait never misses a state change (no polling)
                self._cv.wait()
            window_end = self._queue[0].enqueued + self.max_delay
            while True:
                rows = 0
                for r in self._queue:
                    rows += r.rows
                if rows >= self.max_batch or self._closed:
                    break
                now = time.monotonic()
                if any(r.deadline is not None and r.deadline < window_end
                       for r in self._queue):
                    # coalescing to the full window would cross a
                    # request's deadline: stop waiting and dispatch NOW
                    # (waiting until exactly the deadline would expire
                    # it by scheduling jitter)
                    break
                if now >= window_end:
                    break
                self._cv.wait(window_end - now)
            batch, rows = [], 0
            while self._queue and rows + self._queue[0].rows \
                    <= self.max_batch:
                req = self._queue.popleft()
                batch.append(req)
                rows += req.rows
            return batch

    def _dispatch_loop(self):
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            now = time.monotonic()
            live = []
            for req in batch:
                if req.deadline is not None and now > req.deadline:
                    req.future.set_exception(DeadlineExceeded(
                        "deadline elapsed %.1f ms before dispatch"
                        % ((now - req.deadline) * 1000)))
                    if telemetry.enabled():
                        telemetry.record_serving_reject(self.name,
                                                        "deadline")
                else:
                    live.append(req)
            if not live:
                continue
            self._run_batch(live)

    def _run_batch(self, batch):
        rows = sum(r.rows for r in batch)
        tr = tracing.enabled()
        t_form0 = time.monotonic() if tr else 0.0
        try:
            feed = {
                n: _stack([r.feed[n] for r in batch])
                for n in self.engine.feed_names}
            bucket = self.engine.bucket_for(rows)
            t_run0 = time.monotonic() if tr else 0.0
            outs = self._infer(feed, batch) if tr \
                else self.engine.infer(feed)
        except BaseException as e:
            # an engine failure must surface on EVERY waiting future —
            # a silently dropped request is the one unforgivable bug
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(e)
            return
        t_run1 = time.monotonic() if tr else 0.0
        if telemetry.enabled():
            telemetry.record_serving_batch(
                self.name, bucket, rows,
                (bucket - rows) / float(bucket))
        off = 0
        now = time.monotonic()
        for r in batch:
            r.future.set_result([_row_slice(o, off, r.rows)
                                 for o in outs])
            if telemetry.enabled():
                telemetry.record_serving_first_response(
                    self.name, now - r.enqueued)
            off += r.rows
        if tr:
            # AFTER delivering the futures: the spans carry captured
            # monotonic stamps, so recording (and any sink's export
            # write) must not sit on the waiting clients' latency
            self._record_spans(batch, rows, bucket, t_form0, t_run0,
                               t_run1)
        with self._cv:
            self._batches += 1

    def _infer(self, feed, batch):
        """Engine call on the dispatcher thread with the first SAMPLED
        request's context active, so the engine's own span lands in a
        real recorded trace — a sampled-out context would silence the
        span for every sampled batch-mate (the batch is shared;
        per-request timing is attributed retroactively by
        ``_record_spans``)."""
        first = next((r.ctx for r in batch
                      if r.ctx is not None and r.ctx.sampled), None)
        with tracing.activate(first):
            return self.engine.infer(feed)

    def _record_spans(self, batch, rows, bucket, t_form0, t_run0, t_run1):
        """Retroactive per-request attribution: each traced request
        gets queue-wait (enqueue -> dispatch), batch-form (stack + pad)
        and compute (engine call) spans in ITS OWN trace — padding
        waste and bucket ride the compute span's attrs, so a p99
        breakdown can split padded rows from real compute."""
        pad = bucket - rows
        for r in batch:
            if r.ctx is None:
                continue
            tracing.record_span("paddle_tpu.serving.queue_wait",
                                r.enqueued, t_form0, parent=r.ctx,
                                batcher=self.name)
            tracing.record_span("paddle_tpu.serving.batch_form",
                                t_form0, t_run0, parent=r.ctx,
                                rows=r.rows, batch_rows=rows)
            tracing.record_span("paddle_tpu.serving.compute",
                                t_run0, t_run1, parent=r.ctx,
                                bucket=bucket, batch_rows=rows,
                                pad_rows=pad)

    # ---- lifecycle ----

    def close(self, drain=True, timeout=30.0):
        """Stop admitting; with ``drain=True`` flush every admitted
        request through the engine first, else fail them with
        ``Closed``. Joins the dispatcher; returns True when it exited
        (every admitted request resolved), False when the flush is
        still running past ``timeout`` — callers that promise a clean
        drain must check (re-calling close resumes the join)."""
        with self._cv:
            self._closed = True
            if not drain:
                while self._queue:
                    req = self._queue.popleft()
                    req.future.set_exception(
                        Closed("serving shut down before dispatch"))
            self._cv.notify_all()
        self._thread.join(timeout)
        return not self._thread.is_alive()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _host(v):
    """A feed value as numpy."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _stack(vals):
    """Concatenate request feeds along the batch axis. PackedSeq inputs
    are padded to the common max time dim first (their lengths carry
    the truth) — same semantics as LoD concat (core.lower helper)."""
    if any(isinstance(v, PackedSeq) for v in vals):
        data, lengths = concat_time_padded(
            [_host(v.data) for v in vals],
            [_host(v.lengths).astype(np.int32) for v in vals], xp=np)
        return PackedSeq(data, lengths)
    return np.concatenate([_host(v) for v in vals], axis=0)


def _row_slice(o, off, rows):
    if isinstance(o, PackedSeq):
        return PackedSeq(o.data[off:off + rows], o.lengths[off:off + rows])
    if hasattr(o, "ndim") and getattr(o, "ndim", 0) >= 1:
        return o[off:off + rows]
    return o
