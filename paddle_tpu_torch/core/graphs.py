"""CUDA graphs: the port's form of the JAX package's one compiled dispatch.

The JAX package traces a training step once and runs K steps as one
jitted ``lax.scan`` (``Executor.run_chunk``); the port runs a step
eagerly, op by op, and pays the host's launch cost for every kernel.
On the card ``Executor.run_chunk`` instead captures one step of a plan
into a ``torch.cuda.CUDAGraph`` and replays it, one replay a step; the
decode engine (``serving/decode.py``) captures its decode step and each
prefill bucket the same way (:class:`CapturedRun`). A replay launches
the same kernels on the same shapes as the eager step it was captured
from, so it computes the same bits.

What a replay needs, and how it gets it:

* **State stays in place.** A graph reads and writes the addresses it
  was captured over. The captured step therefore ends by copying every
  persistable it writes into the tensor it read, and the scope keeps
  those tensors: after ``run_chunk`` the scope's tensors (and any
  reference a caller took before the call) hold the new values. Before
  each replay a scope tensor that is not the graph's own (a ``run()``
  in between replaced it, or another scope's value was set) is copied
  into the graph's tensor, which the scope then holds again, so
  ``run()`` and ``run_chunk()`` interleave freely. A persistable the
  step makes without reading it is a tensor of the graph's, set into
  the scope after each replay.
* **Feeds.** Each feed is a fixed buffer that takes step ``i``'s slice
  of the ``[K, ...]`` chunk before replay ``i`` (``data`` and
  ``lengths`` of a ``PackedSeq``). A new feed shape or dtype, new fetch
  names or another scope make a new capture, kept on the executor's
  plan; a plan that goes frees its graphs and their memory pools.
* **Random streams.** An op's stream is a generator seeded on the host
  from ``op_seed(step_key(seed, step), uid, salt)``. The eager step
  before a capture records which streams the step asks for, in order
  (:class:`RecordDraws`); the capture hands out that many generators
  registered with the graph (``CUDAGraph.register_generator_state``),
  and before every replay each is seeded with the key ``run()`` would
  use at that step. A replay then draws what ``run()`` draws.
* **Launch counts.** The kernels' wrappers count on the host, and a
  replay runs no Python: the capture's counts are taken back, and each
  replay adds them once.
* **The guard** (``guard.py``). A guarded plan's step chooses between
  the candidate and the old value of each state tensor on the device,
  and its guard state (``guard@loss_scale``, ``guard@good_steps``,
  ``guard@skipped_steps``) is scope tensors the graph reads and updates
  in place like the parameters. The step index a poison window compares
  with is a device tensor of the graph's, set before each replay like a
  feed; the fault rules were read when the plan was built. Each step's
  health row is a trailing output, copied into the chunk's ``[K, 6]``
  rows after its replay and read on the host after the chunk, never
  inside the captured step.
* **The first step.** The first ``run_chunk`` of a plan runs its first
  step eagerly, on the side stream the capture then uses (that run loads
  the kernels and makes the library handles and workspaces), captures
  the step, and replays it for the chunk's other steps; later chunks
  replay all K. No step runs twice and no state changes outside a
  counted step.

Nothing falls back: a capture or a replay that fails raises (a host
read inside a lowering, say, fails the capture).
"""

import torch

from paddle_tpu_torch import telemetry
from paddle_tpu_torch.core.executor import run_step, slice_feed
from paddle_tpu_torch.core.lower import (PackedSeq, RowSparse, op_seed,
                                         step_key)

__all__ = ["run_chunk", "StepGraph", "CapturedRun", "RecordDraws",
           "launch_counters"]

# graphs a plan keeps; the oldest goes first
MAX_GRAPHS = 8


def launch_counters():
    """The launch-count dicts of every kernel wrapper."""
    from paddle_tpu_torch.kernels import (bn_grad, conv1x1_bwd,
                                          flash_attention, gru_cell,
                                          lstm_cell)
    return [m.launches for m in (flash_attention, lstm_cell, gru_cell,
                                 bn_grad, conv1x1_bwd)]


class RecordDraws:
    """``TraceContext.rngs`` of the eager run before a capture: draws as
    ``run()`` does and records the (op uid, salt) of every stream the
    step asks for, in order."""

    def __init__(self):
        self.calls = []

    def generator(self, ctx, uid, salt):
        self.calls.append((uid, salt))
        return torch.Generator(device=ctx.device).manual_seed(
            op_seed(ctx.key, uid, salt))


class _GraphDraws:
    """``TraceContext.rngs`` under capture: the graph's generators, in
    the order the eager run asked for streams."""

    def __init__(self, calls, gens):
        self.calls, self.gens, self.next = calls, gens, 0

    def generator(self, ctx, uid, salt):
        i = self.next
        if i >= len(self.calls) or self.calls[i] != (uid, salt):
            raise RuntimeError(
                "the step under capture asks for the random stream of op "
                "%d (salt %d) where its eager run asked for %s"
                % (uid, salt, self.calls[i] if i < len(self.calls)
                   else "none"))
        self.next += 1
        return self.gens[i]


class CapturedRun:
    """One CUDA graph with its random streams and launch counts.

    ``draws``: the (op uid, salt) streams the captured run asks for, in
    order (:class:`RecordDraws`). :meth:`capture` runs ``fn(rngs)``
    under capture on ``stream`` (``rngs`` goes to the run's
    ``TraceContext``) and returns what it returns; :meth:`replay`
    seeds each stream for the step whose key is ``key`` and replays."""

    def __init__(self, device, draws=()):
        self.device = device
        self.draws = list(draws)
        self.gens = [torch.Generator(device=device) for _ in self.draws]
        self.graph = torch.cuda.CUDAGraph()
        for g in self.gens:
            self.graph.register_generator_state(g)
        self.delta = None

    def capture(self, fn, stream):
        counters = launch_counters()
        before = [dict(c) for c in counters]
        rngs = _GraphDraws(self.draws, self.gens)
        try:
            with torch.cuda.graph(self.graph, stream=stream):
                out = fn(rngs)
        finally:
            after = [dict(c) for c in counters]
            for c, b in zip(counters, before):
                c.update(b)
        if rngs.next != len(self.draws):
            raise RuntimeError(
                "the step under capture asked for %d random streams, its "
                "eager run for %d" % (rngs.next, len(self.draws)))
        self.delta = [{n: a[n] - b.get(n, 0) for n in a
                       if a[n] != b.get(n, 0)}
                      for a, b in zip(after, before)]
        return out

    def replay(self, key=0):
        for (uid, salt), g in zip(self.draws, self.gens):
            g.manual_seed(op_seed(key, uid, salt))
        self.graph.replay()
        for c, d in zip(launch_counters(), self.delta):
            for n, v in d.items():
                c[n] += v

    def close(self):
        self.graph.reset()
        self.gens = []


def _tensors(v):
    if isinstance(v, PackedSeq):
        return [v.data, v.lengths]
    if isinstance(v, RowSparse):
        return [v.rows, v.values]
    return [v]


def _rebuild(v, ts):
    """A value like ``v`` (a tensor, PackedSeq or RowSparse) made of the
    tensors ``ts``, in ``_tensors``' order."""
    if isinstance(v, PackedSeq):
        return PackedSeq(*ts)
    if isinstance(v, RowSparse):
        return RowSparse(ts[0], ts[1], v.height)
    return ts[0]


def _storages(values):
    return {t.untyped_storage().data_ptr() for v in values
            for t in _tensors(v)}


def _clone(v):
    return _rebuild(v, [t.clone() for t in _tensors(v)])


def _buffer_like(v):
    return _rebuild(v, [torch.empty_like(
        t, memory_format=torch.contiguous_format) for t in _tensors(v)])


def _copy_into(dst, src):
    for d, s in zip(_tensors(dst), _tensors(src)):
        d.copy_(s)


def _stacked_like(v, k):
    return _rebuild(v, [t.new_empty((k,) + tuple(t.shape))
                        for t in _tensors(v)])


def _row(v, i):
    return _rebuild(v, [t[i] for t in _tensors(v)])


def _sig(v):
    """A feed's per-step signature (its chunk's without the K axis)."""
    return tuple((tuple(t.shape[1:]), str(t.dtype)) for t in _tensors(v))


class StepGraph:
    """One step of an executor plan, captured over fixed feed buffers
    and the scope's state tensors (see the module docstring)."""

    def __init__(self, executor, plan, feed, fetch_names, scope, draws,
                 stream):
        self.program = plan.program
        self.state = {}
        seen = set()
        for n in plan.state_names(scope, feed, executor.device):
            v = scope.find_var(n)
            s = v.untyped_storage().data_ptr()
            if s in seen:
                # two names on one tensor: the step may write them apart
                v = v.clone()
                scope.set_var(n, v)
            seen.add(s)
            # made on the side stream by the eager step; replays use them
            # on the current one
            v.record_stream(torch.cuda.current_stream(v.device))
            self.state[n] = v
        self.feeds = {n: _buffer_like(v) for n, v in feed.items()}
        for n, v in feed.items():
            _copy_into(self.feeds[n], v)
        # the step index a guard's poison window compares with
        self.step_t = None
        if plan.guard is not None and plan.guard.poison is not None:
            self.step_t = torch.zeros((), dtype=torch.int64,
                                      device=executor.device)
        self.outputs = {}
        self.run = CapturedRun(executor.device, draws)
        self.fetches = self.run.capture(
            lambda rngs: self._step(executor, plan, fetch_names, rngs),
            stream)

    def _step(self, executor, plan, fetch_names, rngs):
        env = dict(self.state)
        env.update(self.feeds)
        fetches, writes = run_step(plan, executor.device, env, self.state,
                                   0, fetch_names, self.step_t, rngs)
        held = _storages(list(self.state.values())
                         + list(self.feeds.values()))
        copies = []
        for n, v in writes.items():
            if _storages([v]) & held:
                v = _clone(v)          # a view of a buffer the step reads
            old = self.state.get(n)
            if old is None:
                self.outputs[n] = v
            elif v is not old:
                copies.append((old, v))
        overwritten = _storages([old for old, _ in copies])
        kept = []
        for f in fetches:
            if _storages([f]) & overwritten:
                f = _clone(f)          # keep the value the step computed
            kept.append(f)
        for old, v in copies:
            old.copy_(v)
        return kept

    def replay(self, feed, step, scope):
        for n, buf in self.state.items():
            cur = scope.find_var(n)
            if cur is buf:
                continue
            if cur is None or tuple(cur.shape) != tuple(buf.shape) \
                    or cur.dtype != buf.dtype or cur.device != buf.device:
                raise ValueError(
                    "scope variable %r is %s, not the %s %s %s the graph "
                    "was captured over" % (
                        n, None if cur is None else "%s %s %s" % (
                            cur.dtype, tuple(cur.shape), cur.device),
                        buf.dtype, tuple(buf.shape), buf.device))
            buf.copy_(cur)
            scope.set_var(n, buf)
        for n, buf in self.feeds.items():
            _copy_into(buf, feed[n])
        if self.step_t is not None:
            self.step_t.fill_(step)
        self.run.replay(step_key(self.program.random_seed, step))
        for n, v in self.outputs.items():
            scope.set_var(n, v)

    def close(self):
        self.run.close()
        self.state, self.feeds, self.outputs, self.fetches = {}, {}, {}, []


def run_chunk(executor, plan, chunk, k, fetch_names, scope, base):
    """``Executor.run_chunk`` on the card: K steps from ``base``, each a
    replay of the plan's graph for this chunk's signature (the first of
    a new signature runs eagerly, then is captured). Returns the fetches
    stacked ``[K, ...]`` on the device, then a guarded plan's health
    rows ``[K, 6]``."""
    dev = executor.device
    key = (tuple(sorted((n, _sig(v)) for n, v in chunk.items())),
           tuple(fetch_names), scope.token)
    with torch.cuda.device(dev):
        graph = plan.graphs.get(key)
        first, start = [], 0
        if graph is None:
            stream = torch.cuda.Stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            feed0 = slice_feed(chunk, 0)
            draws = RecordDraws()
            with torch.cuda.stream(stream):
                first = executor._run_step(plan, feed0, scope, base,
                                           fetch_names, rngs=draws)
            torch.cuda.current_stream(dev).wait_stream(stream)
            start = 1
            graph = StepGraph(executor, plan, feed0, fetch_names, scope,
                              draws.calls, stream)
            if telemetry.enabled():
                telemetry.record_jit_miss(plan.user, {
                    "fetch": ",".join(fetch_names), "graph": str(key[0]),
                    "guard": str(plan.guard.key) if plan.guard else None})
            plan.graphs[key] = graph
            while len(plan.graphs) > MAX_GRAPHS:
                plan.graphs.pop(next(iter(plan.graphs))).close()
        outs = [_stacked_like(f, k) for f in graph.fetches]
        for o, f in zip(outs, first):
            _copy_into(_row(o, 0), f)
            for t in _tensors(f):
                t.record_stream(torch.cuda.current_stream(dev))
        for i in range(start, k):
            graph.replay(slice_feed(chunk, i), base + i, scope)
            for o, f in zip(outs, graph.fetches):
                _copy_into(_row(o, i), f)
    return outs
