"""ParallelExecutor: data, tensor, sequence, pipeline and expert
parallelism over a ``torch.distributed`` mesh.

Capability parity: `paddle/fluid/framework/parallel_executor.cc:54` and
the JAX package's ``parallel/parallel_executor.py``, on its ``dp``,
``(dp, 'mp')``, ``(dp, 'sp')`` meshes and their products with 'pp' and
'ep'.
The JAX package compiles one program over every device; the port runs
one process a rank, as PyTorch's DDP does (NCCL between cards, gloo on
the CPU), and keeps the JAX package's API: ``pe.run(feed=<global
batch>)`` takes the global batch, each rank cuts its own rows out of
every batch-leading feed (var shape ``[-1, ...]``; ``distribute.
global_batch_feed`` marks a batch that is already this rank's), and
fetches of batch rows come back global.

Two preparation paths, as in the JAX package:

* ``comm_config=None`` is the GLOBAL view: the result is the serial
  program's on the global batch. Parameter gradients are exchanged one
  a gradient (``collectives``, rank-order sums), the loss ``mean``,
  training batch norm's statistics and the two channel sums of its
  backward, and ``accuracy`` reduce across the ranks. ``zero_stage=1``
  (the default) keeps 1/N of each optimizer accumulator on a rank: the
  gradient is reduce-scattered, the optimizer op runs on this rank's
  rows and the parameter is all-gathered; ``np.asarray`` of the
  accumulator still reads the whole array (``collectives.
  ShardedState``). The training-health guard composes: under ZeRO each
  rank records its gradient rows and the sum of squares is summed over
  the ranks, so a poisoned gradient on one rank skips the step on all.
* ``comm_config=CommConfig(...)`` is the LOCAL view with its documented
  DDP deltas: batch-norm statistics per rank (each rank keeps its own
  running statistics, warned), and the bucketed, quantized or ZeRO-1
  exchange of ``collectives``. The fp32 bucketed path is bitwise the
  ``None`` path wherever the two views agree (no batch norm), and
  ZeRO-1 bitwise zero_stage 0, at every world size.

Over a ``(dp, 'mp')`` mesh (``CommConfig``, or the global view at
zero_stage 0) the ranks of one dp row get the same rows and split each
'mp'-sharded weight (``collectives``: each step slices the scope's full
weights to this rank's shard, places the Megatron all-reduces over the
rank's mp line, exchanges the gradients over its dp line and writes the
updated weights back whole). Over a ``(dp, 'sp')`` mesh in the global
view with ``seq_axis='sp'`` each rank also cuts the time axis
(dimension 1) of every batch-leading feed to its chunk; ``position_ids``
count from the chunk's start, ``mean`` divides by the whole mesh's
count, ``fused_attention`` runs the ring of ``context_parallel`` over
the rank's sp line, and the parameter gradients are summed over every
rank of the mesh in rank order.

Over a mesh with a 'pp' axis (the global view, zero_stage 0 wherever
the mesh's dp axis has more than one rank) the ranks of one dp row get
the same rows; the ``pipeline`` op runs its schedule (GPipe or 1F1B)
over the rank's pp line, the rank running its own stage, and every
other op (the embeddings, the head) runs on every rank of the line
alike. Each rank persistently holds only its stage's slice of every
stacked parameter, and of each one's optimizer accumulators of the same
shape: the scope holds a ``collectives.ShardedState`` over the pp line,
whose ``np.asarray`` reads the whole ``[S, ...]`` value (the JAX package
lays the accumulators out by ZeRO-1 over 'dp' instead). Over an 'ep'
axis each rank holds its ``E/ep`` experts of every ``moe`` op's ``WIn``
and ``WOut`` (and their accumulators) the same way; the router runs in
full on every rank and only the rank's own experts run (``parallel.
expert_parallel``). On both axes the parameter gradients are exchanged
over the rank's dp line only, the loss ``mean`` divides by the dp
line's rows, and a global norm (``global_norm_clip``, the guard's)
sums each held parameter's part over its line.

Random ops draw per-rank streams in both paths at a world above one (the
rank of the gradient exchange folded into the step key, as the JAX
package's local view folds ``axis_index``); at one rank they draw what
``Executor`` draws.

``run_chunk`` on the card captures one step, its collectives included,
into a CUDA graph (``core/graphs.py``); the process group has run a
collective before (``distribute.init_multihost``).
"""

import warnings
import weakref

import numpy as np
import torch
import torch.distributed as dist

from paddle_tpu_torch import passes as passes_lib
from paddle_tpu_torch import telemetry, tracing
from paddle_tpu_torch.core import ir
from paddle_tpu_torch.core.executor import Executor, _find_var, stage_feed
from paddle_tpu_torch.core.lower import PackedSeq, TensorArray
from paddle_tpu_torch.core.place import CPUPlace, CUDAPlace
from paddle_tpu_torch.core.scope import global_scope
from paddle_tpu_torch.parallel import collectives
from paddle_tpu_torch.parallel import mesh as mesh_lib
from paddle_tpu_torch.parallel.comm_audit import Census
from paddle_tpu_torch.parallel.distribute import HostLocalBatch

__all__ = ["ParallelExecutor"]

class _CommStep:
    """What a data-parallel plan adds to every step (``_Plan.comm``):
    the comm plan, the step's ``TraceComm`` with its census, and the
    rank folded into the step key. It holds its executor weakly: the
    executor holds the plan, and a strong reference back would keep
    both (and the plan's CUDA graphs) alive until a cyclic
    collection."""

    def __init__(self, pe, plan, global_view, program):
        self._pe = weakref.ref(pe)
        mesh = pe.mesh
        self.mesh = mesh
        if plan.mp_axis is not None or set(mesh.axis_names) & {"pp", "ep"}:
            # the gradient exchange runs over the rank's dp line (none,
            # on a mesh without the batch axis: the rank alone)
            self.rank = mesh.axis_rank(plan.axis)
            self.group = mesh.axis_group(plan.axis) \
                if plan.axis in mesh.shape else collectives.SOLO
        else:
            self.rank = pe._rank
            self.group = mesh.group
        # the rank a step key folds in: none at one rank, where the
        # streams are the plain Executor's
        self.rank_fold = None if plan.world == 1 else self.rank
        self.plan = plan
        self.program = program
        self.global_view = global_view
        self.loss_name = pe.loss_name
        self.state_names = plan.state_names
        # the shape np.asarray gives a ZeRO accumulator: its declared one
        # under the global view, [world, rows] under a CommConfig (the
        # JAX package's layouts)
        self.zero_shapes = {n: tuple(int(d) for d in
                                     _find_var(program, n).shape)
                            for n in plan.zero_state} if global_view \
            else None
        # one accumulator whose scope value tells the layout (layout
        # changes are all-or-nothing): the O(1) probe of a plan without
        # ZeRO for a scope a ZeRO plan left sharded
        self.probe = next((v.name for v in program.list_vars()
                           if v.persistable
                           and v.name not in plan.axis_params
                           and getattr(v, "optimizer_state_for", None)
                           and v.shape and int(np.prod(
                               [int(d) for d in v.shape])) > 1), None)

    def trace(self, env):
        census = Census(self.program)
        pe = self._pe()
        pe.last_census = census
        tc = collectives.TraceComm(
            self.plan, {n: env[n] for n in self.plan.state_names},
            local_seed=pe._batch_feeds, rank=self.rank, group=self.group,
            global_view=self.global_view, census=census, mesh=self.mesh)
        if self.plan.mp_axis is not None:
            tc.enter_mp(env)
        return tc

    def finish(self, tc, env, writes):
        """Close a step's comm layer: the exchange completed, the
        'mp'-sharded weights gathered back whole, the loss checked
        global, a persistable written from this rank's rows warned once
        (its ranks keep their own copies: the local view's batch-norm
        statistics). Returns the writes it adds or replaces (the
        error-feedback carry, the whole 'mp'-sharded weights)."""
        ef = tc.finish(env)
        if self.plan.mp_axis is not None:
            ef.update(tc.gather_mp(writes))
        if self.global_view:
            if self.loss_name and self.loss_name in tc.local:
                raise ValueError(
                    "ParallelExecutor(comm_config=None): the loss %r is "
                    "still this rank's value — the port's global view "
                    "reduces a batch-spanning `mean` (and batch-norm "
                    "statistics, accuracy) across the ranks, not this "
                    "loss head" % self.loss_name)
        else:
            tc.check_loss_global(self.loss_name, env)
        warned = self._pe()._warned_local_state
        for n in writes:
            if n in tc.local and n not in warned:
                warned.add(n)
                warnings.warn(
                    "comm_config: persistable %r is updated from "
                    "per-device batch-local values (e.g. batch-norm "
                    "statistics); each device keeps its own copy "
                    "(DDP semantics)" % n, RuntimeWarning)
        return ef


class ParallelExecutor(Executor):
    """Drop-in for the reference API:

        pe = ParallelExecutor(use_cuda=True, loss_name=loss.name)
        loss_val, = pe.run(fetch_list=[loss.name], feed=feeder.feed(batch))

    run in every process of the mesh's process group (``distribute.
    init_multihost``). ``mesh=`` or ``mesh_shape=``/``axis_names=``
    name the dp mesh (default: every rank of the world). ``use_cuda``:
    this rank's card over NCCL (the default), else the CPU over gloo;
    ``place`` names the device outright. The mesh's axes are
    ``batch_axis`` and 'mp' (tensor parallelism) or ``seq_axis``
    (sequence parallelism, in the global view), and in the global view
    'pp' (the ``pipeline`` op's stages) and 'ep' (the ``moe`` op's
    experts)."""

    def __init__(self, use_cuda=True, loss_name=None, main_program=None,
                 share_vars_from=None, num_threads=None, allow_op_delay=False,
                 mesh=None, mesh_shape=None, axis_names=None,
                 batch_axis="dp", seq_axis=None, donate_params=True,
                 zero_stage=1, comm_config=None, place=None):
        if place is None:
            place = CUDAPlace(torch.cuda.current_device()
                              if torch.cuda.is_available() else 0) \
                if use_cuda else CPUPlace()
        super().__init__(place)
        self.mesh = mesh if mesh is not None else mesh_lib.make_mesh(
            mesh_shape, axis_names)
        extra = [a for a in self.mesh.axis_names
                 if a not in (batch_axis, "mp", seq_axis, "pp", "ep")]
        if extra:
            raise ValueError(
                "ParallelExecutor over axes %r: axis %r is neither the "
                "batch axis %r, 'mp', 'pp', 'ep', nor the seq_axis (%r)"
                % (self.mesh.axis_names, extra[0], batch_axis, seq_axis))
        held = [a for a in ("pp", "ep") if a in self.mesh.axis_names]
        if held and comm_config is not None:
            raise ValueError(
                "ParallelExecutor over axes %r: the %r axis runs in the "
                "global view (comm_config=None)"
                % (self.mesh.axis_names, held[0]))
        if held and seq_axis is not None:
            raise ValueError(
                "ParallelExecutor over axes %r: ring attention inside a "
                "pipeline stage or beside the experts' axis is not "
                "supported (the JAX package's note, context_parallel.py); "
                "drop seq_axis or the %r axis"
                % (self.mesh.axis_names, held[0]))
        backend = dist.get_backend(self.mesh.group)
        want = "nccl" if self.device.type == "cuda" else "gloo"
        if backend != want:
            raise ValueError(
                "ParallelExecutor on %s runs its collectives over %s, but "
                "the process group's backend is %s (init_multihost picks "
                "it from the device)" % (self.device, want, backend))
        self._rank = self.mesh.rank()
        self.batch_axis = batch_axis
        self.seq_axis = seq_axis
        self.main_program = main_program
        self.loss_name = loss_name
        self.donate_params = donate_params
        self.comm_config = comm_config
        self.zero_stage = zero_stage
        self._comm_plans = {}  # program fingerprint -> ACTIVE CommPlan
        self._warned_local_state = set()
        self._batch_feeds = frozenset()
        self._time_cut = {}     # feed name -> sp ranks its time is cut over
        self._scope = None
        #: the collectives of the last step (``comm_audit.Census``)
        self.last_census = None

    @property
    def device_count(self):
        return self.mesh.size

    def set_mesh(self, mesh, epoch=None):
        """Re-point this executor at a NEW mesh mid-run — the elastic
        rebuild (``ElasticRecoveryLoop.rebuild`` calls it with a mesh
        that ``make_mesh`` built over the live ranks, then reshards the
        state onto ``state_shardings()``).

        Every rank of the default group calls it (``make_mesh`` did too),
        also a rank the new mesh leaves out: that rank runs no step until
        a later mesh takes it back. The plans, their CUDA graphs (which
        captured the old groups' collectives) and the comm plans go, and
        the old mesh's process groups are destroyed, so the next step
        builds its plan anew on the new mesh's groups: once an epoch.
        ``epoch`` stamps the membership epoch into the plan-miss
        signature (``note_epoch``), so that rebuild is attributed to the
        epoch that moved. A ``ShardedState`` in the scope names its old
        group: onto a mesh of the same ranks the next step re-wraps its
        rows onto the new groups (``collectives.regroup``); onto other
        ranks take the ``snapshot_state`` cut before this call and
        reshard from it after (``ElasticRecoveryLoop`` does)."""
        old, self.mesh = self.mesh, mesh
        self._rank = mesh.rank() if dist.get_rank() in mesh.ranks \
            else None
        for plan in self._plans.values():
            plan.close()
        self._plans.clear()
        self._comm_plans.clear()
        self.last_census = None
        _release_groups(old, mesh)
        self.note_epoch(epoch if epoch is not None else self.cluster_epoch)
        if telemetry.enabled():
            telemetry.set_world_size(mesh.size)
        return self

    # ---- running ----

    def _resolve_program(self, program):
        return (program if program is not None else self.main_program) \
            or ir.default_main_program()

    def run(self, fetch_list=None, feed=None, feed_dict=None, program=None,
            scope=None, return_numpy=True, step0=None):
        feed = feed if feed is not None else (feed_dict or {})
        program = self._resolve_program(program)
        self._scope = scope if scope is not None else global_scope()
        out = super().run(program=program,
                          feed=self._cut_feeds(program, feed, 0),
                          fetch_list=fetch_list, scope=self._scope,
                          return_numpy=return_numpy, step0=step0)
        self._post_dispatch_telemetry(program, 1)
        return out

    def run_chunk(self, program=None, feed_chunk=None, k=None,
                  fetch_list=None, scope=None, return_numpy=True,
                  use_program_cache=True, step0=None):
        program = self._resolve_program(program)
        self._scope = scope if scope is not None else global_scope()
        start = self._step if step0 is None else int(step0)
        out = super().run_chunk(
            program=program,
            feed_chunk=self._cut_feeds(program, feed_chunk or {}, 1), k=k,
            fetch_list=fetch_list, scope=self._scope,
            return_numpy=return_numpy,
            use_program_cache=use_program_cache, step0=step0)
        self._post_dispatch_telemetry(program, self._step - start)
        return out

    def _cut_feeds(self, program, feed, axis):
        """Each batch-leading feed staged on the device and cut to this
        rank's rows along ``axis`` (1 for a ``[K, ...]`` chunk), a view,
        over the mesh's batch axis (the ranks of one dp row of a
        ``(dp, 'mp')`` mesh get the same rows), and over a sequence axis
        also to its time chunk along the next dimension;
        ``HostLocalBatch`` values fed as they are. Notes the batch feeds'
        names: the comm layer's seed of rank-local values."""
        m = self.mesh
        dp, dpr = m.axis_size(self.batch_axis), m.axis_rank(self.batch_axis)
        sp = spr = None
        if self.seq_axis is not None and self.seq_axis in m.shape:
            sp, spr = m.axis_size(self.seq_axis), m.axis_rank(self.seq_axis)
        out, local, cut = {}, set(), {}
        for n, v in feed.items():
            var = _find_var(program, n)
            lead = var is not None and var.shape and var.shape[0] == -1
            if lead:
                local.add(n)
            if isinstance(v, HostLocalBatch):
                out[n] = v.value
                continue
            if not lead:
                out[n] = v
                continue
            v = _rows(n, stage_feed(program, n, v, self.device), axis, dpr,
                      dp)
            if sp is not None and _dim(v) > axis + 1:
                v = _rows(n, v, axis + 1, spr, sp, "time")
                cut[n] = sp
            out[n] = v
        self._batch_feeds = frozenset(local)
        self._time_cut = cut
        return out

    def _verified_feed(self, feed, axis):
        """A feed cut to this rank's time chunk is verified at its global
        time length (the data var declares the whole sequence)."""
        if not self._time_cut:
            return feed
        out = dict(feed)
        for n, sp in self._time_cut.items():
            v = feed.get(n)
            if isinstance(v, torch.Tensor) and v.dim() > axis + 1:
                shape = list(v.shape)
                shape[axis + 1] *= sp
                out[n] = torch.empty(shape, dtype=v.dtype, device="meta")
        return out

    def _store(self, scope, name, value):
        cur = scope.find_var(name)
        if isinstance(cur, collectives.ShardedState) \
                and not isinstance(value, collectives.ShardedState):
            value = collectives.ShardedState.wrap(value, cur.full_shape,
                                                  cur.group, cur.ranks)
        scope.set_var(name, value)

    # ---- plans ----

    def _plan_key(self):
        return (self.mesh, self.zero_stage, self.loss_name,
                self.comm_config.key if self.comm_config is not None
                else None)

    def _plan(self, program, fetch_names, use_cache=True):
        plan = super()._plan(program, fetch_names, use_cache)
        self._prepare_state(plan, self._scope or global_scope())
        return plan

    def _attach(self, plan):
        """Build the plan's comm step: the global view, or the comm
        path with the JAX package's rejections."""
        program = plan.program
        scope = self._scope or global_scope()
        pass_cfg = passes_lib.plan_for(plan.user)
        cfg = self.comm_config
        if cfg is not None and plan.nan_guard:
            warnings.warn(
                "comm_config is not supported together with "
                "FLAGS_check_nan_inf (checkify); falling back to the "
                "partitioner-placed collectives", RuntimeWarning)
            cfg = None
        if cfg is None:
            if pass_cfg is not None and pass_cfg.layout is not None:
                raise NotImplementedError(
                    "ParallelExecutor(comm_config=None) with the NHWC "
                    "layout pass: training batch norm takes global "
                    "statistics there, and the B7 kernel cannot take a "
                    "cross-rank sum between its channel sums and dx yet "
                    "(ROADMAP.md Queue 1 item 4)")
            zero = self.zero_stage
            if set(self.mesh.axis_names) & {"pp", "ep"} \
                    and self.mesh.axis_size(self.batch_axis) == 1:
                # ZeRO-1 over a dp line of one rank shards nothing
                zero = 0
            cplan = collectives.CommPlan(
                collectives.CommConfig(bucket_mb=0.0, zero_stage=zero),
                program, scope, self.mesh, self.batch_axis,
                require_grads=False, seq_axis=self.seq_axis)
            self._comm_plans[plan.user.fingerprint] = cplan
            plan.comm = _CommStep(self, cplan, True, program)
            return
        if pass_cfg is not None and pass_cfg.layout is not None:
            raise ValueError(
                "comm_config and the NHWC layout pass do not compose: "
                "passes.enable(layout='NHWC') changes the program's "
                "image layout (and, with feed_layout='NHWC', the feed "
                "contract itself), which the comm path's bucket plan "
                "cannot honor. Feed-preserving pass configs "
                "(epilogue_fusion / pallas_reductions / remat with "
                "layout=None) compose fine — use those, or drop "
                "comm_config.")
        if self.zero_stage and not cfg.zero_stage:
            raise ValueError(
                "comm_config requires zero_stage=0 on the executor — "
                "the partitioner-annotation ZeRO sharding and the "
                "flat-bucket layout do not compose (the bucket "
                "reduction materializes replicated gradients). For "
                "sharded optimizer state under the comm path use "
                "CommConfig(zero_stage=1) instead.")
        if plan.guard is not None and "mp" in self.mesh.axis_names:
            raise ValueError(
                "comm_config over a (dp, 'mp') tensor-parallel mesh "
                "does not compose with the training-health guard yet: "
                "the guard's health summary records whole gradients at "
                "the optimizer op, but mp-sharded parameters hold only "
                "this device's hidden-dim shard there. Disable "
                "guard.enable() or drop the 'mp' axis.")
        if cfg.zero_stage and plan.guard is not None:
            raise ValueError(
                "CommConfig(zero_stage=1) does not compose with the "
                "training-health guard yet: the guard's health summary "
                "records gradients at the optimizer op, which under "
                "ZeRO-1 holds only this device's 1/N shard. Disable "
                "guard.enable() or use zero_stage=0.")
        cplan = collectives.plan_for(cfg, program, scope, self.mesh,
                                     self.batch_axis)
        self._comm_plans[plan.user.fingerprint] = cplan
        plan.comm = _CommStep(self, cplan, False, program)

    def _prepare_state(self, plan, scope):
        """Bring the scope to the plan's layout: ZeRO accumulators to
        this rank's rows (or back to whole arrays for a plan without
        ZeRO), the error-feedback carry seeded. O(1) when nothing
        changed."""
        step = plan.comm
        group, rank = step.group, step.rank
        cplan = step.plan
        if cplan.config.zero_stage:
            if not collectives.zero_layout_current(scope, cplan,
                                                   step.zero_shapes, group):
                collectives.ensure_zero_state(scope, cplan, rank,
                                              group, step.zero_shapes)
        elif step.probe is not None and isinstance(
                scope.find_var(step.probe), collectives.ShardedState):
            collectives.restore_full_opt_state(scope, plan.program)
        collectives.ensure_state(scope, cplan, rank, group, self.device)
        if cplan.axis_params:
            collectives.ensure_axis_state(scope, cplan.axis_params,
                                          self.mesh)

    # ---- telemetry and the audit ----

    def _mesh_label(self):
        return ",".join("%s=%d" % (a, n) for a, n in self.mesh.shape.items())

    def _post_dispatch_telemetry(self, program, steps):
        """The dispatch's gradient payload and comm accounting from the
        static plan, and under tracing one ``paddle_tpu.parallel.comm``
        span carrying it (host side: no device sync)."""
        plan = self._comm_plans.get(program.fingerprint)
        if plan is None:
            return
        if telemetry.enabled():
            telemetry.record_allreduce_payload(
                self._mesh_label(), steps * plan.grad_bytes)
            if self.comm_config is not None:
                collectives.TraceComm.record_dispatch(
                    plan, self._mesh_label(), steps)
        if tracing.enabled():
            with tracing.child_span("paddle_tpu.parallel.comm",
                                    buckets=len(plan.buckets),
                                    wire_bytes=steps * plan.wire_bytes(),
                                    quantize=str(plan.config.quantize),
                                    steps=steps, mesh=self._mesh_label()):
                pass

    def compiled_hlo(self, fetch_list=None, feed=None, program=None,
                     scope=None):
        """No counterpart: the port compiles no HLO. Its structural audit
        is the census of the collectives a step issues
        (``parallel/comm_audit.py``, ``last_census``)."""
        raise NotImplementedError(
            "ParallelExecutor.compiled_hlo has no counterpart in the port: "
            "its structural audit is the census of the collectives a step "
            "issues (paddle_tpu_torch.parallel.comm_audit, "
            "ParallelExecutor.last_census), which ROADMAP.md Queue 1 "
            "item 4 brought with the data-parallel executor")

    def state_shardings(self, program=None):
        """{persistable var name: ``mesh.Sharding``}: the layout each
        state value has on this executor's mesh (accumulators over dp
        under ZeRO, the comm plan's error-feedback and ZeRO state)."""
        program = program or self.main_program or ir.default_main_program()
        out = {}
        held = collectives.axis_sharded(program, self.mesh)
        for b in program.blocks:
            for n, v in b.vars.items():
                if not v.persistable or n in out:
                    continue
                owner = getattr(v, "optimizer_state_for", None)
                if n in held:
                    ov = _find_var(program, owner) if owner else v
                    out[n] = mesh_lib.param_sharding(self.mesh, ov)
                elif self.zero_stage >= 1 and owner is not None \
                        and getattr(v, "sharding", None) is None:
                    out[n] = mesh_lib.zero_sharding(
                        self.mesh, v, _find_var(program, owner),
                        self.batch_axis)
                else:
                    out[n] = mesh_lib.param_sharding(self.mesh, v)
        plan = self._comm_plans.get(program.fingerprint)
        if plan is not None and self.comm_config is not None:
            for n in plan.state_names:
                out[n] = mesh_lib.Sharding(
                    self.mesh, (self.batch_axis, None) if n.endswith("p1")
                    else (self.batch_axis,))
            for n, spec in collectives.zero_specs(plan).items():
                out[n] = mesh_lib.Sharding(self.mesh, spec)
            # mp-sharded parameters and their accumulators: the slice a
            # rank holds for a step (the scope keeps them whole)
            for n, spec in collectives.mp_specs(plan, program).items():
                out[n] = mesh_lib.Sharding(self.mesh, spec)
        return out


def _release_groups(old, new):
    """Destroy the process groups ``old`` made that ``new`` does not use
    (the default group stays)."""
    keep = {id(g) for g in [new.group, *new.axis_groups.values()]}
    seen = set()
    for g in [old.group, *old.axis_groups.values()]:
        if g is None or id(g) in keep or id(g) in seen \
                or g is dist.GroupMember.NON_GROUP_MEMBER \
                or g is dist.GroupMember.WORLD:
            continue
        seen.add(id(g))
        dist.destroy_process_group(g)


def _dim(v):
    return (v.data if isinstance(v, (PackedSeq, TensorArray)) else v).dim()


def _rows(name, v, axis, rank, world, what="batch"):
    """Rank ``rank``'s rows of a staged feed value along ``axis`` (of
    ``world`` equal shares)."""
    if isinstance(v, PackedSeq):
        if what == "time":
            raise ValueError(
                "ParallelExecutor feed %r: a sequence (PackedSeq) feed "
                "does not split over a sequence axis; feed padded "
                "[batch, time] tensors" % name)
        return PackedSeq(_rows(name, v.data, axis, rank, world),
                         _rows(name, v.lengths, axis, rank, world))
    if isinstance(v, TensorArray):
        return TensorArray(_rows(name, v.data, axis, rank, world, what),
                           v.size)
    n = v.shape[axis]
    if n % world:
        raise ValueError(
            "ParallelExecutor feed %r: %s %d does not split over the "
            "mesh's %d ranks" % (name, what, n, world))
    m = n // world
    return v.narrow(axis, rank * m, m)
