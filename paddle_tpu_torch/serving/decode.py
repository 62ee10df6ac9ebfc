"""Autoregressive decode serving: the prefill/decode program pair + a
continuous-batching token scheduler.

The JAX package's ``serving/decode.py`` on PyTorch. A language model
serves *generations* — a prompt, then one token per step until
EOS/length/deadline. Exactly two program families serve every request:

* a **prefill ladder** over prompt-length buckets — batch 1, writing
  the prompt's K/V into its claimed cache slot (``fused_attention``
  cache_mode="prefill") and returning the prompt logits; and
* **ONE decode step** over the full slot array — every token of every
  generation, regardless of how many slots are live, is the same
  ``[num_slots, 1]`` run (free rows compute masked garbage; the active
  set is host bookkeeping).

On the card each program entry (the decode step, each prefill bucket)
is a CUDA graph (``core/graphs.py``), the port's form of the JAX
package's executables: ``warmup()`` runs each entry once eagerly on a
scratch cache (the kernels are built and loaded, the library handles
made) and captures it, and every later call replays it.
``compile_count()`` counts the captured entries (``len(buckets) + 1``
after warmup, frozen while a loop serves). A graph reads fixed token,
position and slot buffers, the scope's state tensors, and the engine's
cache buffers, which the cache in use holds (``_bind``): a cache that
does not hold them has its values copied in and takes them, and the
cache that held them before gets its values back in buffers of its own.
``KVCache.reset()`` zeroes the buffers in place, so a ``DecodeLoop``
that resets its cache after a failure keeps them. On the CPU the
entries run eagerly. The cache buffers live on the engine's device and
are updated in place.

Scheduling is **continuous batching** (`DecodeLoop`): requests claim
and release slots BETWEEN token steps. A finished short generation
frees its slot while its neighbors keep decoding; admission is a
bounded queue with typed ``Overloaded`` shedding when it fills.
Termination is per-request: EOS id, ``max_new_tokens``, deadline (the
generation finishes with what it has, reason ``"deadline"``), or
client cancel (the slot is freed at the next step boundary).

Failure model: an engine failure mid-run fails every LIVE generation
with the error, resets the cache + slot array, and keeps serving the
queue. Queued requests survive.

The KV cache is float32 or bfloat16 (``DecodeEngine(cache_dtype=)``):
a bfloat16 cache goes through the bfloat16 decode kernel.

Telemetry: the loop records each request's outcome, each prefill and
decode step, and the slot occupancy (``paddle_tpu_decode_*``)
under its name, which defaults to the engine's ``service``. Fault
seam: ``<name>.decode_step`` fires before every decode step (a delay
rule slows each token step, a crash rule fails the live generations).
The persistent AOT cache and the hot-swap barrier
(``DecodeLoop.request_swap``) arrive with later slices.
"""

import collections
import threading
import time
import weakref

import numpy as np
import torch

from paddle_tpu_torch import fault
from paddle_tpu_torch import telemetry
from paddle_tpu_torch.core.executor import (external_reads_and_writes,
                                            run_program)
from paddle_tpu_torch.core.infer import dtype_name
from paddle_tpu_torch.core.lower import step_key
from paddle_tpu_torch.core.place import default_place
from paddle_tpu_torch.core.scope import global_scope
from paddle_tpu_torch.serving.batcher import (Closed, DeadlineExceeded,
                                              Overloaded)
from paddle_tpu_torch.serving.engine import (BatchTooLarge, _find_var,
                                             default_buckets)
from paddle_tpu_torch.serving import kv_cache
from paddle_tpu_torch.serving.kv_cache import KVCache, SlotAllocator

__all__ = ["DecodeEngine", "DecodeLoop", "Generation", "active_loops"]


#: live (not yet closed) DecodeLoops: every loop a test starts must be
#: close()d
_LIVE_LOOPS = set()
_LIVE_LOCK = threading.Lock()


def active_loops():
    """Snapshot of DecodeLoops whose dispatcher thread is still owed a
    close()."""
    with _LIVE_LOCK:
        return sorted(l.name for l in _LIVE_LOOPS)


def default_prompt_buckets(max_prompt):
    """Powers of two up to and including ``max_prompt`` (8/16/32/...);
    a non-power-of-two max becomes the final bucket."""
    return default_buckets(max_prompt, start=8)


class DecodeEngine:
    """The program pair for one decode model.

    ``DecodeEngine(prefill_prog, decode_prog, meta)`` — programs and
    meta from ``models.transformer.build_transformer_decode``.
    ``warmup()`` runs the prefill ladder + the decode step once;
    ``prefill()`` / ``decode_step()`` drive them, updating the cache
    buffers in place.

    ``place`` defaults to ``CUDAPlace(0)`` and raises when there is no
    CUDA device; the parameters in ``scope`` must already live on that
    device. ``cache_dtype`` is the KV cache's dtype, as in the JAX
    package: ``"float32"``, or ``"bfloat16"`` (half the bytes; the
    attention op rounds K/V to it on write, and the decode kernel reads
    it widened, the query and the logits staying float32); it is part of
    every entry's key. ``prefill``/``decode_step`` mutate the KVCache
    they are handed and must be called from ONE thread (the
    DecodeLoop's)."""

    def __init__(self, prefill_program, decode_program, meta, *,
                 num_slots=8, prompt_buckets=None, scope=None, place=None,
                 service="decode", cache_dtype="float32"):
        self.device = default_place(place)
        self.service = service
        self.prefill_program = prefill_program
        self.decode_program = decode_program
        self.meta = meta
        self.num_slots = int(num_slots)
        self.cache_dtype = cache_dtype
        self._cache_dt = kv_cache.cache_dtype(cache_dtype)
        self._kv = ("kv", dtype_name(self._cache_dt))
        self.scope = scope if scope is not None else global_scope()
        buckets = tuple(sorted(set(
            int(b) for b in (prompt_buckets
                             or default_prompt_buckets(meta.max_len // 2)))))
        if not buckets or buckets[0] < 1 or buckets[-1] > meta.max_len:
            raise ValueError(
                "prompt buckets must be in 1..max_len=%d, got %r"
                % (meta.max_len, buckets))
        self.buckets = buckets

        self._state_names = self._validate(decode_program,
                                           (meta.tokens_name,
                                            meta.pos_name))
        self._prefill_state = self._validate(prefill_program,
                                             (meta.tokens_name,
                                              meta.slot_name))
        self._warm = set()
        self._ready = False
        # key -> _EntryGraph on the card; None runs every entry eagerly
        self._graphs = {} if self.device.type == "cuda" else None
        # the buffers every graph reads as the cache, and the cache
        # that holds them
        self._cache_buffers = None
        self._owner = None

    # ---- program validation (the ServingEngine contract) ----

    def _validate(self, program, extra_feeds):
        feed_set = set(self.meta.cache_names) | set(extra_feeds)
        reads, written = external_reads_and_writes(program)
        bad = sorted(
            n for n in written
            if (v := _find_var(program, n)) is not None and v.persistable)
        if bad:
            raise ValueError(
                "decode programs must be pure inference, but ops write "
                "persistable state %s" % bad)
        state = tuple(n for n in reads
                      if n not in feed_set
                      and self.scope.find_var(n) is not None)
        missing = [n for n in reads
                   if n not in feed_set
                   and self.scope.find_var(n) is None
                   and n not in written]
        if missing:
            raise ValueError(
                "decode program reads %s which are neither feeds nor in "
                "scope (create or load the parameters first)" % missing)
        elsewhere = sorted(n for n in state
                           if self.scope.find_var(n).device != self.device)
        if elsewhere:
            raise ValueError(
                "parameters %s are not on the engine's device %s"
                % (elsewhere, self.device))
        return state

    # ---- warmup ----

    @property
    def ready(self):
        return self._ready

    def compile_count(self):
        """Program entries warmed so far (== len(buckets) + 1 after
        warmup, frozen forever after)."""
        return len(self._warm)

    def _key(self, key):
        """An entry's key: the entry and the cache dtype, as the JAX
        package's ``_dtype_sig`` carries ``("kv", dtype)``."""
        return key + (self._kv,)

    def bucket_for(self, n):
        """Smallest prompt bucket >= n; BatchTooLarge past the last."""
        if n < 1:
            raise ValueError("prompt length must be >= 1, got %d" % n)
        for b in self.buckets:
            if n <= b:
                return b
        raise BatchTooLarge(
            "prompt length %d exceeds max bucket %d (buckets: %s)"
            % (n, self.buckets[-1], list(self.buckets)))

    def _state(self):
        return {n: self.scope.find_var(n) for n in self._state_names}

    def swap_state(self, new_state):
        """Swap the decode weights: shapes, dtypes and device must match
        exactly. Call it between steps (on the decode loop's thread, or
        with no loop running). The new values are copied into the
        scope's tensors, which the graphs read; returns copies of the
        previous state."""
        missing = sorted(set(self._state_names) - set(new_state))
        if missing:
            raise ValueError("swap state is missing %s" % (missing,))
        for n in self._state_names:
            cur, new = self.scope.find_var(n), new_state[n]
            if (tuple(new.shape) != tuple(cur.shape)
                    or new.dtype != cur.dtype or new.device != cur.device):
                raise ValueError(
                    "swap would change the state signature of %r "
                    "(%s %s %s -> %s %s %s)"
                    % (n, cur.dtype, tuple(cur.shape), cur.device,
                       new.dtype, tuple(new.shape), new.device))
        old = {}
        for n in self._state_names:
            cur = self.scope.find_var(n)
            old[n] = cur.clone()
            cur.copy_(new_state[n])
        return old

    def warmup(self):
        """Make the decode step + every prefill bucket ready: on the card
        run each once on a scratch cache and capture it; on the CPU run
        each once on a scratch cache. ``ready`` flips only after the
        LAST one. Returns {key: seconds}."""
        times = {}
        scratch = self.new_cache() if self._graphs is None else None
        for key in [("decode",)] + [("prefill", b) for b in self.buckets]:
            t0 = time.perf_counter()
            if self._graphs is not None:
                if self._key(key) not in self._graphs:
                    self._capture(key)
            elif key[0] == "decode":
                self.decode_step(np.zeros(self.num_slots, np.int64),
                                 scratch)
            else:
                self.prefill(np.zeros(key[1], np.int64), 0, scratch)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            times[key] = time.perf_counter() - t0
        self._ready = True
        return times

    def new_cache(self):
        return KVCache(self.meta, self.num_slots, dtype=self._cache_dt,
                       device=self.device)

    # ---- dispatch ----

    def _program(self, key):
        if key[0] == "decode":
            return self.decode_program, self._state_names
        return self.prefill_program, self._prefill_state

    def _run(self, key, feeds, cache):
        if cache.dtype != self._cache_dt:
            raise ValueError(
                "the cache holds %s but the engine's cache_dtype is %s"
                % (cache.dtype, self._kv[1]))
        if self._graphs is None:
            return self._run_eager(key, feeds, cache)
        g = self._graphs.get(self._key(key))
        if g is None:
            g = self._capture(key)
        self._bind(cache)
        for n, buf in g.state.items():
            cur = self.scope.find_var(n)
            if cur is not buf:      # a swap or a training step replaced it
                buf.copy_(cur)
                self.scope.set_var(n, buf)
        for n, buf in g.feeds.items():
            buf.copy_(torch.from_numpy(feeds[n]))
        g.run.replay()
        return g.logits

    def _run_eager(self, key, feeds, cache):
        program, names = self._program(key)
        env = {n: self.scope.find_var(n) for n in names}
        env.update(cache.buffers)
        env.update({n: torch.from_numpy(v).to(self.device)
                    for n, v in feeds.items()})
        run_program(program, self.device, env,
                    step_key(program.random_seed, 0), training=False)
        # the ops updated the buffers in place and re-emit them
        cache.buffers = {n: env[o] for n, o in self.meta.cache_outs.items()}
        self._warm.add(self._key(key))
        return env[self.meta.logits_name]

    def _feeds(self, key):
        """Zero feeds of an entry's shapes."""
        if key[0] == "decode":
            return {self.meta.tokens_name: np.zeros((self.num_slots, 1, 1),
                                                    np.int64),
                    self.meta.pos_name: np.zeros(self.num_slots, np.int32)}
        return {self.meta.tokens_name: np.zeros((1, key[1]), np.int64),
                self.meta.slot_name: np.zeros(1, np.int32)}

    def _capture(self, key):
        """Run entry ``key`` once eagerly on a scratch cache, on the
        capture's side stream, then capture it over the engine's cache
        buffers, fixed feed buffers and the scope's state tensors."""
        from paddle_tpu_torch.core import graphs

        program, names = self._program(key)
        dev = self.device
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            self._run_eager(key, self._feeds(key), self.new_cache())
        torch.cuda.current_stream(dev).wait_stream(stream)
        if self._cache_buffers is None:
            self._cache_buffers = self.new_cache().buffers
        g = _EntryGraph()
        g.state = {n: self.scope.find_var(n) for n in names}
        g.feeds = {n: torch.from_numpy(v).to(dev)
                   for n, v in self._feeds(key).items()}
        g.run = graphs.CapturedRun(dev)

        def body(rngs):
            env = dict(g.state)
            env.update(self._cache_buffers)
            env.update(g.feeds)
            run_program(program, dev, env, step_key(program.random_seed, 0),
                        rngs=rngs, training=False)
            for n, o in self.meta.cache_outs.items():
                if env[o] is not self._cache_buffers[n]:
                    raise RuntimeError(
                        "%s: the cache output %r is not the cache buffer "
                        "it updates in place" % (key, o))
            return env[self.meta.logits_name]

        g.logits = g.run.capture(body, stream)
        self._graphs[self._key(key)] = g
        self._warm.add(self._key(key))
        return g

    def _bind(self, cache):
        """Make ``cache`` hold the buffers the graphs read (module
        docstring)."""
        mine = self._cache_buffers
        if all(cache.buffers[n] is t for n, t in mine.items()):
            return
        owner = self._owner() if self._owner is not None else None
        if owner is not None and owner is not cache and all(
                owner.buffers[n] is t for n, t in mine.items()):
            owner.buffers = {n: t.clone() for n, t in mine.items()}
        for n, t in mine.items():
            t.copy_(cache.buffers[n])
        cache.buffers = dict(mine)
        self._owner = weakref.ref(cache)

    def prefill(self, prompt, slot, cache):
        """Ingest one prompt into cache row ``slot``. ``prompt`` is a
        1-D int sequence (host-padded here to its bucket). Returns the
        fp32 logits row at the prompt's LAST real token — argmax of it
        is the first generated token."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        n = len(prompt)
        bucket = self.bucket_for(n)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :n] = prompt
        logits = self._run(("prefill", bucket), {
            self.meta.tokens_name: toks,
            self.meta.slot_name: np.asarray([slot], np.int32)}, cache)
        cache.pos[slot] = n
        return logits[0, n - 1].float().cpu().numpy()

    def decode_step(self, tokens, cache):
        """One token step over the FULL slot array: ``tokens`` [slots]
        (last emitted token per slot; free rows feed 0), positions come
        from ``cache.pos``. Returns fp32 logits [slots, 1, vocab]; the
        caller advances ``cache.pos`` for the slots it considers live."""
        logits = self._run(("decode",), {
            self.meta.tokens_name: np.asarray(tokens, np.int64).reshape(
                self.num_slots, 1, 1),
            self.meta.pos_name: cache.pos.copy()}, cache)
        return logits.float().cpu().numpy()


class _EntryGraph:
    """A captured prefill or decode entry: its graph (``CapturedRun``),
    the state tensors and feed buffers it reads, its logits buffer."""

    __slots__ = ("run", "state", "feeds", "logits")


class Generation:
    """Handle for one submitted generation. ``result()`` blocks for
    ``(tokens, finish_reason)`` — reason one of ``"eos"`` /
    ``"length"`` / ``"deadline"`` (budget spent mid-generation: the
    partial output is returned, not an error) / ``"cancelled"`` — or
    raises the typed admission/engine error. ``cancel()`` frees the
    slot at the next step boundary without touching the neighbors."""

    __slots__ = ("prompt", "max_new_tokens", "eos_id", "deadline",
                 "tokens", "token_times", "finish_reason", "error",
                 "slot", "submitted", "_done", "_cancelled")

    def __init__(self, prompt, max_new_tokens, eos_id, deadline):
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.deadline = deadline
        self.tokens = []
        self.token_times = []
        self.finish_reason = None
        self.error = None
        self.slot = None
        self.submitted = time.monotonic()
        self._done = threading.Event()
        self._cancelled = False

    def cancel(self):
        """Client went away: release the slot at the next step
        boundary. Idempotent; a no-op once the generation finished."""
        self._cancelled = True

    def done(self):
        return self._done.is_set()

    def result(self, timeout=None):
        if not self._done.wait(timeout):
            raise TimeoutError(
                "generation not finished within %.1fs" % (timeout or 0))
        if self.error is not None:
            raise self.error
        return list(self.tokens), self.finish_reason


class DecodeLoop:
    """The continuous-batching scheduler: one thread owns the KV cache,
    the slot array, and the prefill/decode runs.

    Each iteration: (1) sweep — finish cancelled/expired live
    generations and free their slots; (2) admit — claim a free slot
    per queued request (FIFO) and prefill it; (3) step — ONE decode
    run over the whole slot array, append each live slot's token,
    terminate on EOS / max_new_tokens / deadline. Slots therefore turn
    over BETWEEN token steps.

    Admission is a bounded queue: ``submit()`` raises ``Overloaded``
    past ``max_queue`` waiting requests, ``Closed`` once draining."""

    def __init__(self, engine, max_queue=64, name=None):
        self.engine = engine
        self.name = name or engine.service
        self.max_queue = int(max_queue)
        self.cache = engine.new_cache()
        self.slots = SlotAllocator(engine.num_slots)
        self._cv = threading.Condition()
        self._queue = collections.deque()
        self._live = {}            # slot -> Generation
        self._admitting = None     # popped from _queue, not yet _live
        self._last_tok = np.zeros(engine.num_slots, np.int64)
        self._closed = False
        self._steps = 0
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name="serving-decode-%s" % self.name)
        with _LIVE_LOCK:
            _LIVE_LOOPS.add(self)
        self._thread.start()

    # ---- admission ----

    def submit(self, prompt, max_new_tokens=32, eos_id=None,
               timeout=None):
        """Enqueue one generation. ``timeout`` (seconds) is the
        request's whole-generation deadline. Returns a ``Generation``.
        Raises ``Overloaded`` (queue full — shed, go elsewhere),
        ``Closed`` (draining), ``BatchTooLarge`` (prompt exceeds the
        bucket ladder, or prompt + 1 token exceeds the cache).

        ``max_new_tokens`` is clamped to the cache room the prompt
        leaves (``max_len - len(prompt)``); a generation cut short by
        that geometry finishes with reason ``"length"``."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        self.engine.bucket_for(len(prompt))       # BatchTooLarge ladder
        room = self.engine.meta.max_len - len(prompt)
        if room < 1:
            raise BatchTooLarge(
                "prompt length %d leaves no cache room (max_len=%d)"
                % (len(prompt), self.engine.meta.max_len))
        max_new = min(int(max_new_tokens), room)
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        deadline = (time.monotonic() + timeout) if timeout else None
        g = Generation(prompt, max_new, eos_id, deadline)
        with self._cv:
            if self._closed:
                if telemetry.enabled():
                    telemetry.record_decode_request(self.name, "closed")
                raise Closed("decode loop is draining; request refused")
            if len(self._queue) >= self.max_queue:
                if telemetry.enabled():
                    telemetry.record_decode_request(self.name, "shed")
                raise Overloaded(
                    "Overloaded: %d generations waiting (max_queue=%d, "
                    "slots=%d)" % (len(self._queue), self.max_queue,
                                   self.engine.num_slots))
            self._queue.append(g)
            self._cv.notify_all()
        return g

    def depth(self):
        with self._cv:
            return len(self._queue)

    def live_count(self):
        return self.slots.active_count()

    def steps_dispatched(self):
        return self._steps

    # ---- the loop ----

    def _loop(self):
        while True:
            with self._cv:
                while not self._queue and not self._live \
                        and not self._closed:
                    self._cv.wait()
                if self._closed and not self._queue and not self._live:
                    return
            try:
                self._sweep()
                self._admit()
                self._step()
            except BaseException as e:  # engine failure: see module doc
                self._fail_live(e)

    def _emit(self, g, tok):
        g.tokens.append(int(tok))
        g.token_times.append(time.monotonic())

    def _finish(self, g, reason):
        self.slots.release(g.slot)
        del self._live[g.slot]
        self.cache.pos[g.slot] = 0
        self._last_tok[g.slot] = 0
        g.finish_reason = reason
        g._done.set()
        if telemetry.enabled():
            telemetry.record_decode_request(self.name, reason,
                                            tokens=len(g.tokens))
            telemetry.set_decode_occupancy(self.name,
                                           self.slots.occupancy())

    def _fail_error(self, g, err, outcome):
        g.error = err
        g._done.set()
        if telemetry.enabled():
            telemetry.record_decode_request(self.name, outcome)

    def _fail_live(self, e):
        """Engine failure mid-run: the cache may hold a half-written
        step — fail every LIVE generation, reset cache + slots, and keep
        serving the queue."""
        for g in list(self._live.values()):
            self.slots.release(g.slot)
            self._fail_error(g, e if isinstance(e, Exception)
                             else RuntimeError(repr(e)), "error")
        self._live.clear()
        self.cache.reset()
        self.slots.reset()
        self._last_tok[:] = 0
        if telemetry.enabled():
            telemetry.set_decode_occupancy(self.name, 0.0)
        if not isinstance(e, Exception):  # KeyboardInterrupt etc.
            # this thread is about to die: nothing will ever serve the
            # queue again — fail queued generations too (no client may
            # block forever on result()) and refuse further submits
            with self._cv:
                self._closed = True
                queued, self._queue = list(self._queue), \
                    collections.deque()
            for g in queued:
                self._fail_error(g, RuntimeError(repr(e)), "error")
            raise e

    def _check_termination(self, g, now):
        """The per-request termination ladder (cancel > deadline >
        eos > length). Returns the finish reason or None."""
        if g._cancelled:
            return "cancelled"
        if g.deadline is not None and now > g.deadline:
            return "deadline"
        if g.eos_id is not None and g.tokens \
                and g.tokens[-1] == g.eos_id:
            return "eos"
        if len(g.tokens) >= g.max_new_tokens:
            return "length"
        return None

    def _sweep(self):
        now = time.monotonic()
        for g in list(self._live.values()):
            reason = self._check_termination(g, now)
            if reason is not None:
                self._finish(g, reason)

    def _expire_queued(self):
        """Fail cancelled/deadline-expired requests ANYWHERE in the
        queue (called under ``_cv``): a buried request must not wait
        for the head to drain before its typed verdict surfaces."""
        now = time.monotonic()
        keep = collections.deque()
        for g in self._queue:
            if g._cancelled:
                g.finish_reason = "cancelled"
                g._done.set()
                if telemetry.enabled():
                    telemetry.record_decode_request(self.name,
                                                    "cancelled")
            elif g.deadline is not None and now > g.deadline:
                self._fail_error(g, DeadlineExceeded(
                    "deadline elapsed before a slot freed"), "expired")
            else:
                keep.append(g)
        self._queue = keep

    def _admit(self):
        while True:
            with self._cv:
                self._expire_queued()
                if not self._queue:
                    return
                slot = self.slots.claim()
                if slot is None:
                    return
                g = self._queue.popleft()
                # visible to close(drain=False) while it is in
                # neither _queue nor _live (prefill in flight)
                self._admitting = g
            t0 = time.perf_counter()
            try:
                last_logits = self.engine.prefill(g.prompt, slot,
                                                  self.cache)
            except BaseException as e:
                # fail THIS request here (it never reached _live, so
                # _fail_live can't see it), then let the loop's
                # handler reset the cache
                self.slots.release(slot)
                self.cache.pos[slot] = 0
                with self._cv:
                    self._admitting = None
                if isinstance(e, Exception):
                    self._fail_error(g, e, "error")
                raise
            if telemetry.enabled():
                telemetry.record_decode_prefill(
                    self.name, time.perf_counter() - t0)
                telemetry.set_decode_occupancy(self.name,
                                               self.slots.occupancy())
            g.slot = slot
            self._live[slot] = g
            with self._cv:
                # under _cv AFTER the _live insert: close(drain=False)
                # always sees g in _admitting or in _live, never gone
                self._admitting = None
            tok = int(np.argmax(last_logits))
            self._emit(g, tok)
            self._last_tok[slot] = tok
            reason = self._check_termination(g, time.monotonic())
            if reason is not None:
                self._finish(g, reason)

    def _step(self):
        if not self._live:
            return
        if fault._active:
            # chaos seam: a delay rule here slows every token step (a
            # loaded chip), a crash rule poisons the dispatch
            fault.fire(self.name + ".decode_step")
        t0 = time.perf_counter()
        logits = self.engine.decode_step(self._last_tok, self.cache)
        dt = time.perf_counter() - t0
        self._steps += 1
        live = sorted(self._live)
        for s in live:
            self.cache.pos[s] += 1
        if telemetry.enabled():
            telemetry.record_decode_step(self.name, dt)
            telemetry.set_decode_occupancy(self.name,
                                           self.slots.occupancy())
        now = time.monotonic()
        for s in live:
            g = self._live[s]
            if g._cancelled or (g.deadline is not None
                                and now > g.deadline):
                # the token this step computed for a gone client is
                # discarded; the slot frees here, mid-generation
                self._finish(g, "cancelled" if g._cancelled
                             else "deadline")
                continue
            tok = int(np.argmax(logits[s]))
            self._emit(g, tok)
            self._last_tok[s] = tok
            reason = self._check_termination(g, now)
            if reason is not None:
                self._finish(g, reason)

    # ---- lifecycle ----

    def close(self, drain=True, timeout=30.0):
        """Stop admitting. ``drain=True`` finishes every admitted
        generation (queued included) within their own termination
        bounds; ``drain=False`` cancels live generations and fails
        queued ones with ``Closed``. Returns True when the loop thread
        exited (re-call to resume the join on timeout)."""
        with self._cv:
            self._closed = True
            if not drain:
                while self._queue:
                    g = self._queue.popleft()
                    self._fail_error(g, Closed(
                        "decode loop shut down before a slot freed"),
                        "closed")
                # snapshot: the loop thread del-etes finished entries
                # from _live without holding _cv
                for g in list(self._live.values()):
                    g._cancelled = True
                if self._admitting is not None:
                    self._admitting._cancelled = True
            self._cv.notify_all()
        self._thread.join(timeout)
        ok = not self._thread.is_alive()
        if ok:
            with _LIVE_LOCK:
                _LIVE_LOOPS.discard(self)
        return ok

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
