"""Executor: run a program's global block eagerly on one device.

Capability parity: `paddle/fluid/framework/executor.cc:133` (Run) and the
Python wrapper `python/paddle/fluid/executor.py:181`. The JAX package
traces a block once into a jitted function; PyTorch runs eagerly, so
``run`` interprets the block op by op on the executor's device (see
``core.lower.run_block``) with no compile step and no program cache.

* Persistable variables (parameters) live in a Scope as tensors on the
  executor's device. A program that writes one (the startup program's
  initializers) stores the new tensor back into the scope.
* feed/fetch need no feed/fetch ops: feeds enter the environment before
  the block runs, fetches are read from it afterwards. A ``lod_level >
  0`` var takes a ragged list (one array per sequence), packed here into
  a ``PackedSeq``, or a ``PackedSeq``; a fetched sequence comes back as
  a ``PackedSeq`` of numpy arrays, and a bfloat16 one (mixed precision,
  ``amp.py``) comes back as float32.
* An op that updates a persistable in place (``adam``'s ParamOut and
  moments, names equal to its inputs') is written back to the scope
  with the other persistables the block wrote.
* A program with a pass config (``passes.enable``) runs as its
  transformed clone. The JAX executor applies the pipeline when it
  compiles a variant; there is no compile step here, so the executor
  keeps one clone per (program identity and version, config key) and
  rewrites nothing on later steps. The fetch names only protect
  variables from removal by a rewrite, so the pipeline runs again only
  for a fetch the clone does not protect yet, and the new clone (which
  protects the old names too) takes the old one's place. The passes
  rename no persistable, so what the clone writes lands in the scope
  under the user's names.
* ``run_chunk`` runs K steps a call over a super-batch feed, as the
  JAX package's ``lax.scan`` over K steps does: eagerly on the CPU, and
  on the card as replays of one CUDA graph captured from the plan's
  first step (``core/graphs.py``), the counterpart of the JAX package's
  one compiled dispatch.
"""

import numpy as np
import torch

from paddle_tpu_torch import passes as passes_lib
from paddle_tpu_torch.core import ir
from paddle_tpu_torch.core.infer import torch_dtype
from paddle_tpu_torch.core.lower import (PackedSeq, TraceContext, run_block,
                                         step_key)
from paddle_tpu_torch.core.place import default_place
from paddle_tpu_torch.core.scope import global_scope

__all__ = ["Executor", "external_reads_and_writes", "persistable_writes",
           "run_program", "slice_feed", "stack_steps"]

# plans an executor keeps; the oldest goes first (a dropped plan is made
# again when its program next runs)
MAX_PLANS = 16


def external_reads_and_writes(program):
    """Names read before written in block 0, and names written by
    block-0 ops. A sub-block reads only what its control-flow op lists
    as inputs in block 0, so block 0 holds every outside read."""
    written = set()
    reads = []
    seen_reads = set()
    for op in program.global_block().ops:
        for n in op.input_arg_names:
            if n and n not in written and n not in seen_reads:
                seen_reads.add(n)
                reads.append(n)
        written.update(n for n in op.output_arg_names if n)
    return reads, written


class _Plan:
    """What the executor keeps for one (program version, pass config):
    the program it runs (the user's, or the pass pipeline's clone), its
    outside reads and its writes, the fetch names the clone protects,
    and the CUDA graphs captured from it (``core/graphs.py``). Holding
    the user program keeps its id() from being reused."""

    __slots__ = ("user", "program", "reads", "written", "protected",
                 "graphs")

    def __init__(self, user, program, protected):
        self.user = user
        self.program = program
        self.reads, self.written = external_reads_and_writes(program)
        self.protected = protected
        self.graphs = {}

    def close(self):
        """Free the plan's graphs and their memory pools."""
        for g in self.graphs.values():
            g.close()
        self.graphs.clear()


class Executor:
    """``Executor(place).run(program, feed={...}, fetch_list=[...])``.

    ``place`` defaults to ``CUDAPlace(0)`` and raises when there is no
    CUDA device: running on the CPU is asked for with ``CPUPlace()``.

    ``run_chunk`` runs K steps a call; on the card each step after a
    plan's first is one replay of a captured CUDA graph
    (``core/graphs.py``).
    """

    def __init__(self, place=None):
        self.device = default_place(place)
        self._step = 0
        # (program fingerprint, pass config key) -> _Plan
        self._plans = {}

    def _plan(self, program, fetch_names):
        cfg = passes_lib.plan_for(program)
        key = (program.fingerprint, cfg.key if cfg else None)
        plan = self._plans.get(key)
        if plan is None or (cfg is not None
                            and not plan.protected.issuperset(fetch_names)):
            run, protected = program, frozenset()
            if cfg is not None:
                # the fetches are protected from removal by a rewrite
                protected = frozenset(fetch_names).union(
                    plan.protected if plan else ())
                run, _ = passes_lib.apply(program, protected=protected)
            old = self._plans.pop(key, None)
            if old is not None:
                old.close()
            plan = self._plans[key] = _Plan(program, run, protected)
            while len(self._plans) > MAX_PLANS:
                self._plans.pop(next(iter(self._plans))).close()
        return plan

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True):
        program = program if program is not None \
            else ir.default_main_program()
        scope = scope if scope is not None else global_scope()
        fetch_names = _fetch_names(fetch_list)
        plan = self._plan(program, fetch_names)
        feed = {n: self._to_device(plan.program, n, v)
                for n, v in (feed or {}).items()}
        fetches = self._run_step(plan, feed, scope, self._step, fetch_names)
        self._step += 1
        if return_numpy:
            return [_to_numpy(f) for f in fetches]
        return fetches

    def run_chunk(self, program=None, feed_chunk=None, k=None,
                  fetch_list=None, scope=None, return_numpy=True,
                  step0=None):
        """K training steps in one call: every feed carries a leading
        ``[K, ...]`` axis (a super-batch: ``DataFeeder.feed_chunk`` or
        ``stack_feeds``), staged onto the device in one copy.

        The result is K sequential ``run()`` calls: step ``base + i``
        draws from ``step_key(seed, base + i)``, the step counter
        advances by K (``step0`` pins the base), and fetches come back
        stacked ``[K, ...]`` (tensors on the device with
        ``return_numpy=False``).

        On the CPU the K steps run eagerly. On the card the plan's first
        step runs eagerly and is then captured into a CUDA graph, which
        every later step replays (``core/graphs.py``): the graph keeps
        the scope's state tensors and updates them in place, so tensors
        taken from the scope before the call hold the values after it
        (the JAX package donates them instead). A capture or a replay
        that fails raises; nothing falls back to eager steps."""
        program = program if program is not None \
            else ir.default_main_program()
        scope = scope if scope is not None else global_scope()
        fetch_names = _fetch_names(fetch_list)
        plan = self._plan(program, fetch_names)
        chunk = {n: self._to_device(plan.program, n, v)
                 for n, v in (feed_chunk or {}).items()}
        k = _chunk_k(chunk, k)
        if step0 is not None:
            self._step = int(step0)
        base = self._step
        self._step += k
        if self.device.type == "cuda":
            from paddle_tpu_torch.core import graphs
            fetches = graphs.run_chunk(self, plan, chunk, k, fetch_names,
                                       scope, base)
        else:
            steps = [self._run_step(plan, slice_feed(chunk, i), scope,
                                    base + i, fetch_names)
                     for i in range(k)]
            fetches = [stack_steps([s[j] for s in steps])
                       for j in range(len(fetch_names))]
        if return_numpy:
            return [_to_numpy(f) for f in fetches]
        return fetches

    def _run_step(self, plan, feed, scope, step, fetch_names, rngs=None):
        """One eager step of ``plan`` at step index ``step``: reads state
        from the scope, writes the persistables it changes back by
        replacing the scope's tensors, returns the fetches. ``rngs``:
        see ``TraceContext.rngs``."""
        env = {}
        for n in plan.reads:
            if n in feed:
                continue
            v = scope.find_var(n)
            if v is not None:
                if v.device != self.device:
                    raise ValueError(
                        "scope variable %r lives on %s but this executor "
                        "runs on %s" % (n, v.device, self.device))
                env[n] = v
        env.update(feed)

        program = plan.program
        run_program(program, self.device, env,
                    step_key(program.random_seed, step), rngs=rngs)

        # write back state: persistables this block wrote (startup
        # initializers, in-place updates)
        for n, v in persistable_writes(program, plan.written, env).items():
            scope.set_var(n, v)

        missing = [n for n in fetch_names if n not in env]
        if missing:
            raise KeyError("fetch %s: not computed by the program"
                           % missing)
        return [env[n] for n in fetch_names]

    def _to_device(self, program, name, v):
        if isinstance(v, PackedSeq):
            return PackedSeq(self._to_device(program, name, v.data),
                             torch.as_tensor(v.lengths).to(self.device,
                                                           torch.int32))
        if isinstance(v, torch.Tensor):
            return v.to(self.device)
        if isinstance(v, (list, tuple)):
            var = _find_var(program, name)
            if var is not None and var.lod_level > 0:
                return self._to_device(program, name,
                                       _pack_ragged(v, var.dtype))
        return torch.as_tensor(np.asarray(v), device=self.device)


def run_program(program, device, env, key, rngs=None, training=True):
    """Run ``program``'s global block over ``env`` (name -> tensor) on
    ``device``, without autograd, drawing the random streams of the step
    whose key is ``key`` (``rngs``: see ``TraceContext.rngs``)."""
    ctx = TraceContext(key=key, training=training, program=program,
                       device=device)
    ctx.rngs = rngs
    with torch.no_grad():
        run_block(ctx, program.global_block(), env)
    return env


def _fetch_names(fetch_list):
    return [v.name if isinstance(v, ir.Variable) else str(v)
            for v in (fetch_list or [])]


def persistable_writes(program, written, env):
    """{name: value} of the persistables the block wrote."""
    b0 = program.global_block()
    out = {}
    for n in written:
        v = b0.vars.get(n)
        if v is not None and v.persistable and n in env:
            out[n] = env[n]
    return out


def slice_feed(chunk, i):
    """Step ``i``'s feed of a super-batch chunk (views)."""
    return {n: PackedSeq(v.data[i], v.lengths[i])
            if isinstance(v, PackedSeq) else v[i]
            for n, v in chunk.items()}


def stack_steps(values):
    """K steps' values of one fetch -> one ``[K, ...]`` value."""
    if isinstance(values[0], PackedSeq):
        return PackedSeq(torch.stack([v.data for v in values]),
                         torch.stack([v.lengths for v in values]))
    return torch.stack(values)


def _chunk_k(chunk, k):
    """Resolve and check the steps-a-call K of a super-batch feed: every
    feed must carry the same leading [K, ...] axis."""
    for name, v in chunk.items():
        arr = v.data if isinstance(v, PackedSeq) else v
        lead = arr.shape[0] if arr.dim() else None
        if lead is None:
            raise ValueError(
                "run_chunk feed %r is a scalar — super-batch feeds need a "
                "leading [K, ...] axis" % name)
        if k is None:
            k = int(lead)
        elif int(lead) != k:
            raise ValueError(
                "run_chunk feed %r has leading dim %d but k=%d — stack "
                "every feed over the same K steps (DataFeeder.feed_chunk "
                "/ stack_feeds)" % (name, lead, k))
    if k is None:
        raise ValueError("run_chunk needs k= when there are no feeds")
    if k < 1:
        raise ValueError("run_chunk k must be >= 1, got %d" % k)
    return int(k)


def _find_var(program, name):
    for b in program.blocks:
        if b.has_var_local(name):
            return b.vars[name]
    return None


def _to_numpy(v):
    """A fetch as numpy. numpy has no bfloat16, so a bfloat16 fetch (a
    mixed-precision activation) comes back widened to float32, exactly;
    ``return_numpy=False`` keeps the tensor and its dtype."""
    if isinstance(v, PackedSeq):
        return PackedSeq(_to_numpy(v.data), v.lengths.cpu().numpy())
    if v.dtype == torch.bfloat16:
        v = v.float()
    return v.cpu().numpy()


def _pack_ragged(seqs, dtype):
    """list of per-example sequences (list/array [len_i, ...]) ->
    PackedSeq of numpy arrays, zero-padded to the longest."""
    np_dtype = np.dtype(dtype)
    arrs = [np.asarray(s, dtype=np_dtype) for s in seqs]
    lengths = np.asarray([a.shape[0] for a in arrs], dtype=np.int32)
    max_len = max(1, int(lengths.max()) if len(arrs) else 1)
    tail = arrs[0].shape[1:] if arrs else ()
    out = np.zeros((len(arrs), max_len) + tail, dtype=np_dtype)
    for i, a in enumerate(arrs):
        out[i, : a.shape[0]] = a
    return PackedSeq(torch.as_tensor(out, dtype=torch_dtype(np_dtype.name)),
                     torch.as_tensor(lengths))
