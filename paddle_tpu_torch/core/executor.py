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
  ``amp.py``) comes back as float32. A ``TensorArray`` (the control-flow
  ops' arrays) is fed, kept in a scope and fetched the same way: a
  fetched one is a ``TensorArray`` of numpy arrays.
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
* A guarded program (``guard.enable``, or ``amp.enable(...,
  dynamic_loss_scale=True)``) runs each step under a ``TraceGuard``:
  every state tensor the step writes is chosen between its candidate
  and its old value on the device, and each step's health row (loss,
  grad_norm, skipped, nonfinite_loss, nonfinite_grad, loss_scale) comes
  back as a trailing result that the executor strips. As in the JAX
  package the rows of a dispatch are processed on the host (metrics,
  fault accounting, the divergence detector) at the NEXT dispatch, or at
  ``poll_health``. The guard plan's key (config, scaling knobs, poison
  window, fault rule) is part of the plan key, so arming the guard or
  ``guard.nonfinite`` builds one named plan, and clearing the rule
  returns to the cached one.
* ``use_program_cache=False`` builds the plan for this call only (no
  cached plan is read or kept); on the card such a ``run_chunk`` runs
  its K steps eagerly, without graphs.
* With ``telemetry.enable()`` each call is recorded, and each plan
  built (a cache miss: the port's compile) goes to the recompile
  detector with a signature that names the guard and pass config.
* With ``FLAGS_verify_ir`` (on by default) the plan's final program is
  verified (``paddle_tpu_torch/analysis``) the first time the plan
  meets a call: on every plan miss, and again for each new (feed
  signature, fetch names, scope) it is run with, so a pass or a feed
  mix-up raises a typed ``VerifyError`` before anything runs. A call
  the plan has seen verifies nothing. The flag is in no plan key.
* With ``FLAGS_check_nan_inf`` every float output of every op is
  checked on the device (``core/debug.py``); the executor reads the
  step's result once, after the state is written back and the health
  rows are queued, and raises ``debug.NanInfError`` naming the first
  op whose output held a NaN or an Inf. The flag is part of the plan
  key (``nan_guard``).
* A ``LoDTensor`` fed to a ``lod_level > 0`` variable is packed into a
  ``PackedSeq`` on the device; fed to a ``lod_level == 0`` one it is
  its dense array, as in the JAX package.
"""

import time
import warnings

import numpy as np
import torch

from paddle_tpu_torch import analysis
from paddle_tpu_torch import guard as guard_lib
from paddle_tpu_torch import passes as passes_lib
from paddle_tpu_torch import telemetry
from paddle_tpu_torch.core import debug, ir
from paddle_tpu_torch.core.infer import torch_dtype
from paddle_tpu_torch.core.lod_tensor import LoDTensor
from paddle_tpu_torch.core.lower import (PackedSeq, RowSparse, TensorArray,
                                         TraceContext, _fold_in, run_block,
                                         step_key)
from paddle_tpu_torch.core.place import default_place
from paddle_tpu_torch.core.scope import global_scope

__all__ = ["Executor", "external_reads_and_writes", "fold_step_key",
           "persistable_writes", "run_program", "run_step", "slice_feed",
           "stack_steps", "stage_feed"]

# plans an executor keeps; the oldest goes first (a dropped plan is made
# again when its program next runs)
MAX_PLANS = 16


def external_reads_and_writes(program):
    """Names read before written in block 0, conservatively including
    every read of a sub-block an op of block 0 names (its
    ``*block_id``/``*block_ids`` attributes), and names written by
    block-0 ops. The executor's plans, the decode engine and the serving
    engine find the state a program reads with it; the engines also
    refuse a program that writes persistable state."""
    written = set()
    reads = []
    seen_reads = set()

    def note_read(n):
        if n and n not in written and n not in seen_reads:
            seen_reads.add(n)
            reads.append(n)

    for op in program.global_block().ops:
        for n in op.input_arg_names:
            note_read(n)
        for sub_idx in _sub_block_ids(op):
            for n in _block_external_reads(program.block(sub_idx), program):
                note_read(n)
        written.update(n for n in op.output_arg_names if n)
    return reads, written


def _sub_block_ids(op):
    ids = []
    for k, v in op.attrs.items():
        if k.endswith("block_id") and isinstance(v, int):
            ids.append(v)
        if k.endswith("block_ids") and isinstance(v, (list, tuple)):
            ids.extend(v)
    return ids


def _block_external_reads(block, program):
    """Names ``block`` (and the sub-blocks its ops name) reads before
    writing them, in order, repeats kept."""
    written = set()
    reads = []
    for op in block.ops:
        for n in op.input_arg_names:
            if n and n not in written:
                reads.append(n)
        for sub_idx in _sub_block_ids(op):
            reads.extend(_block_external_reads(program.block(sub_idx),
                                               program))
        written.update(x for x in op.output_arg_names if x)
    return reads


class _Plan:
    """What the executor keeps for one (program version, pass config):
    the program it runs (the user's, or the pass pipeline's clone), its
    outside reads and its writes, the fetch names the clone protects,
    and the CUDA graphs captured from it (``core/graphs.py``). Holding
    the user program keeps its id() from being reused."""

    __slots__ = ("user", "program", "reads", "written", "protected",
                 "graphs", "guard", "nan_guard", "verified", "comm")

    def __init__(self, user, program, protected, guard=None,
                 nan_guard=False):
        self.user = user
        self.program = program
        self.reads, self.written = external_reads_and_writes(program)
        self.protected = protected
        self.graphs = {}
        # guard.GuardPlan of a guarded program, else None
        self.guard = guard
        # FLAGS_check_nan_inf when the plan was built: each step then
        # ends with its debug.NanCheck slot
        self.nan_guard = nan_guard
        # the (feed signature, fetch names, scope) calls verified
        self.verified = set()
        # ParallelExecutor's data-parallel step (parallel/
        # parallel_executor._CommStep, set by its _attach): makes each
        # step's comm layer and folds the rank into the step key; None
        # on one device
        self.comm = None

    def step_key(self, step):
        """The root random key of step ``step`` (``TraceContext.key``)."""
        return fold_step_key(self.program.random_seed, step,
                             self.rank_fold())

    def rank_fold(self):
        """The data-parallel rank a step key folds in, or None."""
        return None if self.comm is None else self.comm.rank_fold

    def verify(self, feed, fetch_names, scope, chunk=None):
        """``FLAGS_verify_ir``'s check of one call: verify the plan's
        program against the call's feed signature, fetch names and
        scope the first time the plan meets them."""
        if not analysis.enabled():
            return
        infos = {n: analysis.feed_info(v, chunk=chunk)
                 for n, v in feed.items()}
        sig = (tuple(sorted((n, None if i is None else (i.shape, i.dtype))
                            for n, i in infos.items())),
               tuple(fetch_names), scope.token)
        if sig in self.verified:
            return
        analysis.verify_prepared(self.program, feed_vals=feed,
                                 fetch_names=fetch_names, scope=scope,
                                 chunk=chunk)
        self.verified.add(sig)

    def state_names(self, scope, feed, device):
        """The names of the scope state one step reads: the outside
        reads that are not fed; under the guard also the guard's state
        (made on ``device`` if missing) and the write-only persistables
        that have a value in ``scope`` (the skip needs their old value:
        ``guard.prepare_carry``)."""
        names = [n for n in self.reads
                 if n not in feed and scope.find_var(n) is not None]
        if self.guard is not None:
            b0 = self.program.global_block()
            extra = [n for n in self.written
                     if n not in names and n not in feed
                     and (v := b0.vars.get(n)) is not None and v.persistable]
            guard_lib.prepare_carry(scope, self.guard, names, sorted(extra),
                                    device)
        if self.comm is not None:
            names.extend(n for n in self.comm.state_names
                         if scope.find_var(n) is not None)
        return names

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
        # (program fingerprint, pass config key, guard plan key) -> _Plan
        self._plans = {}
        # guarded dispatches whose health rows are not processed yet:
        # (guard plan, program, base step, rows on the device), oldest
        # first; the rows of dispatch N are processed after dispatch
        # N + 1 is submitted (or at poll_health)
        self._pending_health = []
        self._last_health = None
        # whether the last _plan() call found its plan cached
        self._last_plan_hit = True
        # each step's debug.NanCheck records in the current dispatch
        self._nan_records = []

    def _plan(self, program, fetch_names, use_cache=True):
        cfg = passes_lib.plan_for(program)
        gplan = guard_lib.plan_for(program)
        nan_guard = debug.check_nan_inf_enabled()
        key = (program.fingerprint, cfg.key if cfg else None,
               gplan.key if gplan else None, nan_guard) + self._plan_key()
        plan = self._plans.get(key) if use_cache else None
        if plan is not None and (cfg is None
                                 or plan.protected.issuperset(fetch_names)):
            self._last_plan_hit = True
            return plan
        self._last_plan_hit = False
        run, protected = program, frozenset()
        if cfg is not None:
            # the fetches are protected from removal by a rewrite
            protected = frozenset(fetch_names).union(
                plan.protected if plan else ())
            run, _ = passes_lib.apply(program, protected=protected)
        new = _Plan(program, run, protected, gplan, nan_guard)
        self._attach(new)
        if telemetry.enabled():
            telemetry.record_jit_miss(program, _miss_signature(
                fetch_names, nan_guard=nan_guard,
                guard=str(gplan.key) if gplan else None,
                passes=str(cfg.key) if cfg else None))
        if not use_cache:
            return new
        old = self._plans.pop(key, None)
        if old is not None:
            old.close()
        self._plans[key] = new
        while len(self._plans) > MAX_PLANS:
            self._plans.pop(next(iter(self._plans))).close()
        return new

    def _plan_key(self):
        """What else a plan is built for (``ParallelExecutor``: the mesh,
        the comm config, ZeRO)."""
        return ()

    def _attach(self, plan):
        """Finish a new plan (``ParallelExecutor``: its comm step)."""

    def _verified_feed(self, feed, axis):
        """The feed values ``FLAGS_verify_ir`` checks against the
        program's data vars (``axis``: 1 for a ``[K, ...]`` chunk):
        these ones (``ParallelExecutor``: the global shapes of feeds it
        cut to this rank's time chunk)."""
        return feed

    def _store(self, scope, name, value):
        """Write one step's persistable back into the scope."""
        scope.set_var(name, value)

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True, use_program_cache=True):
        t0 = time.perf_counter() if telemetry.enabled() else 0.0
        program = program if program is not None \
            else ir.default_main_program()
        scope = scope if scope is not None else global_scope()
        fetch_names = _fetch_names(fetch_list)
        plan = self._plan(program, fetch_names, use_program_cache)
        hit = self._last_plan_hit
        feed = {n: self._to_device(plan.program, n, v)
                for n, v in (feed or {}).items()}
        plan.verify(self._verified_feed(feed, 0), fetch_names, scope)
        step = self._step
        self._nan_records = []
        fetches = self._run_step(plan, feed, scope, step, fetch_names)
        self._step += 1
        fetches = self._after_dispatch(plan, program, step, fetches)
        if t0:
            self._record(program, step, t0, hit, feed, fetches, 1)
        self._drain_health(keep_latest=True)
        if return_numpy:
            return [_to_numpy(f) for f in fetches]
        return fetches

    def run_chunk(self, program=None, feed_chunk=None, k=None,
                  fetch_list=None, scope=None, return_numpy=True,
                  use_program_cache=True, step0=None):
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
        that fails raises; nothing falls back to eager steps.
        ``use_program_cache=False`` runs the K steps eagerly on every
        device, with a plan made for this call.

        A guarded program's K health rows come back as one ``[K, 6]``
        tensor on the device, processed at the next dispatch."""
        t0 = time.perf_counter() if telemetry.enabled() else 0.0
        program = program if program is not None \
            else ir.default_main_program()
        scope = scope if scope is not None else global_scope()
        fetch_names = _fetch_names(fetch_list)
        plan = self._plan(program, fetch_names, use_program_cache)
        hit = self._last_plan_hit
        chunk = {n: self._to_device(plan.program, n, v)
                 for n, v in (feed_chunk or {}).items()}
        k = _chunk_k(chunk, k)
        plan.verify(self._verified_feed(chunk, 1), fetch_names, scope,
                    chunk=k)
        self._nan_records = []
        if step0 is not None:
            self._step = int(step0)
        base = self._step
        self._step += k
        n_out = len(fetch_names) + (plan.guard is not None) \
            + plan.nan_guard
        if self.device.type == "cuda" and use_program_cache:
            from paddle_tpu_torch.core import graphs
            fetches = graphs.run_chunk(self, plan, chunk, k, fetch_names,
                                       scope, base)
        else:
            steps = [self._run_step(plan, slice_feed(chunk, i), scope,
                                    base + i, fetch_names)
                     for i in range(k)]
            fetches = [stack_steps([s[j] for s in steps])
                       for j in range(n_out)]
        fetches = self._after_dispatch(plan, program, base, fetches)
        if t0:
            self._record(program, base, t0, hit, chunk, fetches, k)
        self._drain_health(keep_latest=True)
        if return_numpy:
            return [_to_numpy(f) for f in fetches]
        return fetches

    def _run_step(self, plan, feed, scope, step, fetch_names, rngs=None):
        """One eager step of ``plan`` at step index ``step``: reads state
        from the scope, writes the persistables it changes back by
        replacing the scope's tensors, returns the fetches (and, for a
        guarded plan, the step's health row after them). ``rngs``: see
        ``TraceContext.rngs``."""
        env = {}
        for n in plan.state_names(scope, feed, self.device):
            v = scope.find_var(n)
            if v.device != self.device:
                raise ValueError(
                    "scope variable %r lives on %s but this executor "
                    "runs on %s" % (n, v.device, self.device))
            env[n] = v
        old = dict(env)
        env.update(feed)
        step_t = None
        if plan.guard is not None and plan.guard.poison is not None:
            step_t = torch.full((), step, dtype=torch.int64,
                                device=self.device)
        nan = debug.NanCheck() if plan.nan_guard else None
        fetches, writes = run_step(plan, self.device, env, old,
                                   plan.step_key(step), fetch_names, step_t,
                                   rngs, nan)
        # write back state: persistables this block wrote (startup
        # initializers, updates)
        for n, v in writes.items():
            self._store(scope, n, v)
        if nan is not None:
            self._nan_records.append(nan.records)
        return fetches

    def _after_dispatch(self, plan, program, base, fetches):
        """Strip a guarded dispatch's health rows off its results and
        queue them for processing; then, under the NaN/Inf guard, read
        the dispatch's slots (its one host read) and raise for the
        first failing op: after the state was written back and the
        rows were queued, so neither is lost."""
        fetches = list(fetches)
        slots = fetches.pop() if plan.nan_guard else None
        if plan.guard is not None:
            self._queue_health(plan, program, base, fetches.pop())
        if slots is not None:
            bad = debug.first_failure(slots, self._nan_records)
            if bad is not None:
                i, (name, op_type, uid) = bad
                chunked = slots.dim() > 0
                raise debug.NanInfError(
                    name, op_type, uid,
                    step=base + i if chunked else None, chunk_step=i)
        return fetches

    def _queue_health(self, plan, program, base, rows):
        self._pending_health.append((plan.guard, program, int(base),
                                     rows))
        if len(self._pending_health) > 16:
            warnings.warn(
                "guard health backlog exceeded 16 dispatches (repeatedly "
                "failing runs?); dropping the oldest rows", RuntimeWarning)
            del self._pending_health[0]

    def _record(self, program, step, t0, hit, feed, fetches, steps):
        telemetry.record_executor_step(
            executor=type(self).__name__, step=step,
            duration=time.perf_counter() - t0, cache_hit=hit,
            feed_bytes=sum(telemetry.value_bytes(v) for v in feed.values()),
            fetch_bytes=sum(telemetry.value_bytes(f) for f in fetches),
            program=program, steps=steps)
        if not hit or step % 16 < steps:
            telemetry.sample_device_memory(self.device)

    def _drain_health(self, keep_latest):
        """Process queued health rows in dispatch order; ``keep_latest``
        leaves the newest entry queued (its rows may still be in flight
        on the card). Entries leave the queue before they are processed,
        so a raising detector cannot process them twice."""
        while len(self._pending_health) > (1 if keep_latest else 0):
            self._process_health(self._pending_health.pop(0))

    def _process_health(self, entry):
        plan, program, base, dev = entry
        h = _health_numpy(dev)
        self._last_health = h
        try:
            guard_lib.after_dispatch(plan, program, h, base)
        except guard_lib.Divergence:
            # whoever catches this abandons the trajectory: the newer
            # dispatches' rows belong to it
            del self._pending_health[:]
            raise

    def poll_health(self):
        """Process the health rows of every queued guarded dispatch (this
        waits for them on the card). Raises ``guard.Divergence`` if the
        detector trips. Returns the latest rows (numpy [steps, 6]: loss,
        grad_norm, skipped, nonfinite_loss, nonfinite_grad, loss_scale),
        or None before the first guarded dispatch."""
        self._drain_health(keep_latest=False)
        return self._last_health

    @property
    def last_health(self):
        """Health rows of the most recent guarded dispatch. A pure read:
        queued rows are converted but not processed (that happens at the
        next dispatch or :meth:`poll_health`)."""
        if self._pending_health:
            return _health_numpy(self._pending_health[-1][3])
        return self._last_health

    def close(self):
        """Process the queued health rows, then free the plans and their
        graphs. A divergence found here is a warning: there is no loop
        left to roll back."""
        try:
            self.poll_health()
        except guard_lib.Divergence as e:
            warnings.warn("divergence detected while draining health "
                          "rows at close: %s" % e, RuntimeWarning)
        finally:
            for plan in self._plans.values():
                plan.close()
            self._plans.clear()

    def _to_device(self, program, name, v):
        return stage_feed(program, name, v, self.device)

    def cost_analysis(self, program=None, feed=None, fetch_list=None,
                      scope=None):
        """Flops and bytes accessed of one step of the plan's final
        program (``analysis/cost.py``): ``{"flops", "bytes accessed",
        "flops by op"}``. The JAX package reads XLA's cost model here;
        the port counts each op's work from its shapes, which a run of
        the step on the meta device gives. Nothing runs on the card and
        nothing in the scope moves (the plan is built, and verified,
        as ``run`` would build it)."""
        from paddle_tpu_torch.analysis import cost

        program = program if program is not None \
            else ir.default_main_program()
        scope = scope if scope is not None else global_scope()
        fetch_names = _fetch_names(fetch_list)
        plan = self._plan(program, fetch_names)
        cpu = torch.device("cpu")
        values = {n: stage_feed(plan.program, n, v, cpu)
                  for n, v in (feed or {}).items()}
        plan.verify(values, fetch_names, scope)
        for n in plan.reads:
            if n not in values and scope.find_var(n) is not None:
                values[n] = scope.find_var(n)
        return cost.step_cost(plan.program, values)

    def memory_analysis(self, program=None, feed=None, fetch_list=None,
                        scope=None):
        """Not ported yet: a step's peak needs the allocator's reading
        of a real step, which moves the scope. It arrives with the
        port's benchmark (ROADMAP Queue 1 item 1)."""
        raise NotImplementedError(
            "Executor.memory_analysis is not ported yet: it comes with "
            "the port's benchmark (ROADMAP Queue 1 item 1)")

    def hlo_text(self, program=None, feed=None, fetch_list=None,
                 scope=None, optimized=True):
        """No counterpart: the port compiles no HLO. Its structural
        audit is the census of the collectives a data-parallel step
        issues (``parallel/comm_audit.py``, ``ParallelExecutor.
        last_census``)."""
        raise NotImplementedError(
            "Executor.hlo_text has no counterpart in the port: its "
            "structural audit is the census of the collectives a step "
            "issues (paddle_tpu_torch.parallel.comm_audit, "
            "ParallelExecutor.last_census), which ROADMAP.md Queue 1 "
            "item 4 brought with the data-parallel executor")


def stage_feed(program, name, v, device):
    """One feed value as the executor runs it on ``device``: a tensor,
    or a ``PackedSeq`` (a ragged list or a ``LoDTensor`` fed to a
    ``lod_level > 0`` variable) or a ``TensorArray``."""
    if isinstance(v, TensorArray):
        return TensorArray(stage_feed(program, name, v.data, device),
                           torch.as_tensor(v.size).to(device, torch.int32))
    if isinstance(v, PackedSeq):
        return PackedSeq(stage_feed(program, name, v.data, device),
                         torch.as_tensor(v.lengths).to(device, torch.int32))
    if isinstance(v, torch.Tensor):
        return v.to(device)
    if isinstance(v, LoDTensor):
        # reference semantics: a lod set on a lod_level=0 var is inert
        # (the book tests attach a [0,1,..,N] lod to plain [N,1] id
        # feeds); only a declared LoD var packs
        var = _find_var(program, name)
        ragged = v.to_ragged()
        if var is not None and var.lod_level > 0 and ragged is not None:
            return stage_feed(program, name,
                              _pack_ragged(ragged, var.dtype), device)
        return torch.as_tensor(v.numpy(), device=device)
    if isinstance(v, (list, tuple)):
        var = _find_var(program, name)
        if var is not None and var.lod_level > 0:
            return stage_feed(program, name, _pack_ragged(v, var.dtype),
                              device)
    return torch.as_tensor(np.asarray(v), device=device)


def run_program(program, device, env, key, rngs=None, training=True,
                guard=None, nan=None, comm=None):
    """Run ``program``'s global block over ``env`` (name -> tensor) on
    ``device``, without autograd, drawing the random streams of the step
    whose key is ``key`` (``rngs``: see ``TraceContext.rngs``) under the
    ``guard.TraceGuard`` ``guard``, if any, checking every op's float
    outputs into the ``debug.NanCheck`` ``nan``, if any, with the
    data-parallel comm layer ``comm`` (``parallel/collectives.
    TraceComm``), if any."""
    ctx = TraceContext(key=key, training=training, program=program,
                       device=device, guard=guard, comm=comm)
    ctx.rngs = rngs
    ctx.nan = nan
    with torch.no_grad():
        run_block(ctx, program.global_block(), env)
    return env


def run_step(plan, device, env, old, key, fetch_names, step_t, rngs,
             nan=None):
    """One training step of ``plan`` over ``env`` (the state the step
    reads, ``old``, plus the feeds), eagerly or under graph capture
    (``core/graphs.py``). Returns ``(fetches, writes)``: the fetches,
    then the health row of a guarded plan, then the slot of the
    ``debug.NanCheck`` ``nan`` (given under the NaN/Inf guard: the
    index of the step's first failing output, or -1, on the device);
    and {name: value} of the
    persistables the step wrote (for a guarded plan, the guard's choice
    between candidate and old value, and the guard's state). ``step_t``:
    the step index as a 0-d int64 tensor on the device, which a poison
    window compares with. A data-parallel plan (``plan.comm``) runs the
    step under its comm layer: the gradient exchange completes before
    the writes are taken (the error-feedback carry among them), the loss
    must be global, and a fetch of this rank's rows comes back global."""
    program = plan.program
    tg = None
    if plan.guard is not None:
        tg = guard_lib.TraceGuard(
            plan.guard, {n: env[n] for n in guard_lib.STATE_NAMES}, step_t,
            program)
    tc = plan.comm.trace(env) if plan.comm is not None else None
    run_program(program, device, env, key, rngs=rngs, guard=tg, nan=nan,
                comm=tc)
    writes = persistable_writes(program, plan.written, env)
    if tc is not None:
        writes.update(plan.comm.finish(tc, env, writes))
    extra = []
    if tg is not None:
        writes, health = guard_lib.finalize(tg, env, old, writes)
        extra = [health]
    if nan is not None:
        extra.append(nan.slot(device))
    missing = [n for n in fetch_names if n not in env]
    if missing:
        raise KeyError("fetch %s: not computed by the program" % missing)
    fetches = [env[n] for n in fetch_names]
    if tc is not None:
        fetches = [tc.gather_fetch(n, v, _find_var(program, n))
                   for n, v in zip(fetch_names, fetches)]
    return fetches + extra, writes


def fold_step_key(random_seed, step, rank=None):
    """``step_key(random_seed, step)``, with a data-parallel rank folded
    in where one is given (each rank draws its own streams, as the JAX
    package's local view folds ``axis_index``)."""
    key = step_key(random_seed, step)
    return key if rank is None else _fold_in(key, rank)


def _miss_signature(fetch_names, **extra):
    """The recompile detector's signature of one plan build: one field
    per setting so its diff names what changed (None fields dropped)."""
    sig = {"fetch": ",".join(fetch_names)}
    sig.update({k: v for k, v in extra.items() if v is not None})
    return sig


def _health_numpy(rows):
    """Health rows (a device tensor) as numpy [steps, 6]."""
    h = rows.detach().to("cpu", torch.float32).numpy()
    return h if h.ndim == 2 else h[None, :]


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
            if isinstance(v, PackedSeq) else TensorArray(v.data[i], v.size[i])
            if isinstance(v, TensorArray) else v[i]
            for n, v in chunk.items()}


def stack_steps(values):
    """K steps' values of one fetch -> one ``[K, ...]`` value (a
    RowSparse's rows and values stacked, as ``lax.scan`` stacks its
    leaves in the JAX package)."""
    if isinstance(values[0], RowSparse):
        return RowSparse(torch.stack([v.rows for v in values]),
                         torch.stack([v.values for v in values]),
                         values[0].height)
    if isinstance(values[0], PackedSeq):
        return PackedSeq(torch.stack([v.data for v in values]),
                         torch.stack([v.lengths for v in values]))
    if isinstance(values[0], TensorArray):
        return TensorArray(torch.stack([v.data for v in values]),
                           torch.stack([v.size for v in values]))
    return torch.stack(values)


def _chunk_k(chunk, k):
    """Resolve and check the steps-a-call K of a super-batch feed: every
    feed must carry the same leading [K, ...] axis."""
    for name, v in chunk.items():
        arr = v.data if isinstance(v, (PackedSeq, TensorArray)) else v
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
    ``return_numpy=False`` keeps the tensor and its dtype. A RowSparse
    comes back as the JAX executor returns it (``np.asarray`` of the
    object): a 0-d object array holding the RowSparse, here of numpy
    arrays."""
    if isinstance(v, RowSparse):
        out = np.empty((), dtype=object)
        out[()] = RowSparse(_to_numpy(v.rows), _to_numpy(v.values),
                            v.height)
        return out
    if isinstance(v, PackedSeq):
        return PackedSeq(_to_numpy(v.data), v.lengths.cpu().numpy())
    if isinstance(v, TensorArray):
        return TensorArray(_to_numpy(v.data), v.size.cpu().numpy())
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
