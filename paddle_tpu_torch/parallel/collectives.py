"""Gradient communication over ``torch.distributed``: the bucketed,
backward-overlapped, quantized and ZeRO-1 gradient exchange, and the
tensor-parallel ('mp') collectives of the Megatron layout.

Capability parity: the JAX package's ``parallel/collectives.py``. The
reference hand-places one NCCL all-reduce a gradient
(`details/multi_devices_graph_builder.cc:100-112`); the port runs one
process a rank, as DDP does, and this layer owns the exchange:

* **Local view.** Every rank runs the same program on its rows of the
  global batch. Parameter gradients materialize as per-rank partial
  sums; :class:`TraceComm` (carried on ``TraceContext.comm``) follows
  which values are this rank's rows (``local``), coalesces the
  gradients into ~``bucket_mb`` flat buckets (dtype-segregated, in
  materialization order) and launches each bucket's exchange with
  ``async_op=True`` the moment its last gradient exists, mid-backward;
  the exchange is waited on at the bucket's first reader (the optimizer
  op, a clip), so it overlaps the rest of the backward.
* **A fixed reduction order.** An element's sum over ranks is the same
  bits whatever bucket it sits in and whatever the world size does to a
  ring's order: a bucket is padded to a multiple of the world and
  exchanged by ``all_to_all`` (rank d receives chunk d of every rank's
  bucket), rank d adds its chunk's ``world`` partials in RANK ORDER
  (``((g_0 + g_1) + g_2) + ...``) and the reduced chunks are
  all-gathered. The per-gradient exchange of ``comm_config=None`` runs
  the same code on one-gradient buckets, so the bucketed path is
  bitwise the per-gradient one at every world size; ZeRO-1 stops after
  the rank-order sum (its shard is bitwise the all-reduced chunk). Wire
  cost is an all-reduce's: one scatter and one gather phase.
  A gradient narrower than its parameter (the embeddings' bfloat16
  ``@GRAD`` under AMP) travels widened, exactly, in its bucket's dtype,
  is summed there and comes back in its own dtype (the JAX package's
  comm path refuses such a gradient; its global view sums it in
  bfloat16): at one rank it is its own bits.
* **Quantized** (``quantize="int8"`` / ``"fp8"``): the two-phase
  exchange of the JAX package: a per-rank per-bucket scale, the
  quantized chunks all-to-all, each rank dequantizes and adds its chunk
  in float32 (rank order), requantizes and all-gathers, with an
  error-feedback residual in both phases carried in the scope
  (``comm@ef<b>@p1``/``@p2``: under the guard it is skip-gated like the
  parameters). fp8 travels as a ``uint8`` view (no backend reduces
  float8). The quantize and dequantize passes are plain PyTorch, as
  they are jnp in the JAX package.
* **ZeRO-1** (``CommConfig(zero_stage=1)``): buckets are
  reduce-scattered (per-parameter chunking, each value padded to
  ``rows * world``); each rank applies the program's own optimizer op
  to its owned rows of the parameter and of its accumulators, and the
  updated rows are all-gathered back. An accumulator keeps 1/N of its
  elements on a rank: the scope holds a :class:`ShardedState`, whose
  ``np.asarray`` gathers the whole array (a collective: every rank of
  the mesh must ask).

* **Tensor parallelism** (a ``(dp, 'mp')`` mesh): every 'mp'-sharded
  parameter is classified by where the axis cuts it (``col``: its last
  dimension, ``row``: its first, ``shard``: a 1-D value such as a
  column-split fc's bias), and :class:`TraceComm`'s weight-locality
  analysis places the two all-reduces of each Megatron pair over the
  rank's mp group: after a row-split matmul's forward output
  (``fwd_row``) and after a column-split matmul's input gradient
  (``bwd_col``). The scope keeps every weight at its full logical
  shape, as the JAX package's does ("checkpoints are layout-free"): a
  step slices each sharded parameter and its accumulators to this
  rank's shard (:func:`mp_specs`), and the updated shards are
  all-gathered over the mp group back into the full values it writes.
  An mp-sharded parameter's gradient is its shard, so its bucket slot
  is shard-sized; the buckets exchange over the rank's dp line.

The global-view ``comm_config=None`` path of ``ParallelExecutor`` uses
this module too, with one gradient a bucket and the lowerings' global
forms (``mean``, batch-norm statistics, ``accuracy``) that need
:meth:`TraceComm.sum_ranks`; over a ``(dp, 'sp')`` mesh its ranks are
all the mesh's (a rank holds a time chunk of its rows), and
``fused_attention`` runs the ring of ``context_parallel`` over the
rank's sp line. Every collective a step issues is recorded in the
step's :class:`parallel.comm_audit.Census` with the mesh axis it runs
over.

Rejections keep the JAX package's wording; they are raised where the
JAX package raises them.
"""

import warnings

import numpy as np
import torch
import torch.distributed as dist

from paddle_tpu_torch import telemetry
from paddle_tpu_torch.core.lower import PackedSeq, RowSparse

__all__ = ["CommConfig", "CommPlan", "TraceComm", "plan_for",
           "ensure_state", "fold_ef_state", "EF_PREFIX", "state_names",
           "ensure_zero_state", "restore_full_opt_state",
           "fold_zero_state", "zero_specs", "mp_specs", "ShardedState",
           "axis_sharded", "ensure_axis_state", "SOLO"]

# reserved scope-name prefix for the error-feedback residual carry
EF_PREFIX = "comm@ef"


# one rank's flat tensor gathered into [world * n] (renamed in newer torch)
_all_gather_flat = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def _itemsize(dtype_name):
    return torch.empty((), dtype=getattr(torch, dtype_name)).element_size()


def _dtype_name(t):
    return str(t.dtype).replace("torch.", "")


class CommConfig:
    """Gradient-communication policy for a :class:`ParallelExecutor`
    (the descendant of the reference ``BuildStrategy`` fuse/overlap
    knobs).

    * ``bucket_mb`` — target flat-bucket payload in MiB; gradients are
      coalesced in materialization order until a bucket reaches it.
    * ``quantize`` — ``None`` (float32, exact), ``"int8"`` (symmetric
      per-rank per-bucket scale) or ``"fp8"`` (e4m3 on the wire as
      bytes).
    * ``error_feedback`` — carry the quantization residual into the
      next step's bucket (EF-SGD); only meaningful when quantizing.
    * ``overlap`` — launch each bucket's exchange at its last gradient
      (mid-backward). ``False`` defers every bucket to the first
      gradient consumer.
    * ``zero_stage`` — 0 (replicated optimizer state) or 1
      (reduce-scattered buckets, 1/N of the optimizer state a rank,
      parameter all-gather).
    """

    def __init__(self, bucket_mb=4.0, quantize=None, error_feedback=True,
                 overlap=True, zero_stage=0):
        if quantize not in (None, "int8", "fp8"):
            raise ValueError("quantize must be None, 'int8' or 'fp8', "
                             "got %r" % (quantize,))
        if zero_stage not in (0, 1):
            raise ValueError("zero_stage must be 0 or 1, got %r"
                             % (zero_stage,))
        self.bucket_mb = float(bucket_mb)
        self.quantize = quantize
        self.error_feedback = bool(error_feedback) and quantize is not None
        self.overlap = bool(overlap)
        self.zero_stage = int(zero_stage)

    @property
    def key(self):
        """Hashable identity for the executor's plan cache and the
        recompile detector's signature."""
        return ("comm", self.bucket_mb, self.quantize,
                self.error_feedback, self.overlap, self.zero_stage)

    def __repr__(self):
        return ("CommConfig(bucket_mb=%g, quantize=%r, error_feedback=%s, "
                "overlap=%s, zero_stage=%d)"
                % (self.bucket_mb, self.quantize, self.error_feedback,
                   self.overlap, self.zero_stage))


class _Bucket:
    """One flat reduction unit: ``grads`` in materialization order,
    their element counts and the padded flat length. Under ZeRO-1 the
    flat layout is per-parameter chunked: each value padded to ``rows *
    world`` and laid out ``[world, rows]``, so rank d's chunk holds row d
    of every member parameter."""

    __slots__ = ("idx", "dtype", "grads", "sizes", "nelem", "padded",
                 "close_uid", "rows", "shard_len")

    def __init__(self, idx, dtype):
        self.idx = idx
        self.dtype = dtype
        self.grads = []       # [(param_name, grad_name)]
        self.sizes = []       # [element count]
        self.nelem = 0
        self.padded = 0       # nelem padded to a multiple of world size
        self.close_uid = -1   # uid of the op materializing the LAST grad
        self.rows = []        # ZeRO: per-param shard rows ceil(n/world)
        self.shard_len = 0    # ZeRO: per-rank shard elements

    @property
    def bytes(self):
        return self.nelem * _itemsize(self.dtype)

    @property
    def padded_bytes(self):
        return self.padded * _itemsize(self.dtype)


class _ZeroUpdate:
    """One parameter's sharded optimizer application (ZeRO-1): where
    its gradient shard lives in the bucket, and which op slots carry
    sharded accumulators."""

    __slots__ = ("param", "grad", "bucket", "off", "rows", "nelem",
                 "shard_ins", "shard_outs", "gather_outs", "clip_uid")

    def __init__(self, param, grad, bucket, off, rows, nelem,
                 shard_ins, shard_outs, gather_outs, clip_uid=None):
        self.param = param
        self.grad = grad
        self.bucket = bucket
        self.off = off          # element offset inside the rank's shard
        self.rows = rows        # shard elements of this param
        self.nelem = nelem      # true (unpadded) elements
        self.shard_ins = shard_ins      # {slot: accumulator name}
        self.shard_outs = shard_outs    # {slot: accumulator name}
        self.gather_outs = gather_outs  # slots whose value is ParamOut
        self.clip_uid = clip_uid        # global_norm_clip op serving it


class CommPlan:
    """What one executor plan needs to know about its gradient
    communication: the bucket layout (deterministic: materialization
    order, dtype-segregated, greedy fill to ``bucket_mb``) and the
    static byte accounting the telemetry and the smoke report — the JAX
    package's plan, whose ``describe()`` it equals.

    ``seq_axis``: the global view over a ``(dp, seq_axis)`` mesh (never
    a CommConfig's plan, which keeps the JAX package's refusal of such a
    mesh): the gradients are exchanged over every rank of the mesh, each
    holding a time chunk of its rows."""

    def __init__(self, config, program, scope, mesh, batch_axis,
                 require_grads=True, seq_axis=None):
        axes = tuple(mesh.axis_names)
        self.seq_axis = None
        # the stage ('pp') and expert ('ep') axes of the global view: their
        # parameters are held 1/n a rank (``ensure_axis_state``), and the
        # gradient exchange runs over the rank's dp line
        held = tuple(a for a in ("pp", "ep") if a in axes) \
            if not require_grads else ()
        if axes == (batch_axis,):
            self.mp_axis = None
        elif axes == (batch_axis, "mp"):
            self.mp_axis = "mp"
        elif held and set(axes) <= {batch_axis, "mp", "pp", "ep"}:
            self.mp_axis = "mp" if "mp" in axes else None
        elif seq_axis is not None and seq_axis in axes \
                and set(axes) <= {batch_axis, seq_axis}:
            self.mp_axis = None
            self.seq_axis = seq_axis
        else:
            raise ValueError(
                "comm_config requires a pure data-parallel mesh with the "
                "single axis %r, or a (%r, 'mp') tensor-parallel mesh; got "
                "axes %r — other multi-axis meshes keep the "
                "partitioner-placed collectives"
                % (batch_axis, batch_axis, axes))
        self.config = config
        self.axis = batch_axis
        # the ranks of the gradient exchange: the dp line (every rank of
        # the mesh in the global view over a sequence axis)
        self.world = mesh.size if self.seq_axis is not None \
            else int(mesh.axis_size(batch_axis))
        self.mp = int(mesh.shape["mp"]) if self.mp_axis else 1
        # {name: (axis, size)} of every parameter (and same-shaped
        # optimizer accumulator) whose leading dim a 'pp' or 'ep' axis cuts
        self.axis_params = {}
        if held:
            if config.zero_stage and self.world > 1:
                raise ValueError(
                    "ParallelExecutor(comm_config=None) over a mesh with "
                    "axes %r: ZeRO-1 over %r does not compose with the "
                    "stage and expert axes yet (a stacked parameter and "
                    "its accumulators are held 1/n a rank over %r "
                    "already); pass zero_stage=0"
                    % (axes, batch_axis, held))
            self.axis_params = axis_sharded(program, mesh)
        self.mp_params = {}  # param name -> "col" | "row" | "shard"
        self.mp_state = {}   # optimizer accumulator name -> owning param
        self.mp_dims = {}    # sharded name -> the dimension 'mp' cuts
        if self.mp_axis is not None:
            if "pp" in held:
                _refuse_mp_in_stages(program, axes)
            self._plan_mp(config, program)
        pg = list(getattr(program, "_op_role_vars", ()))
        if not pg and require_grads:
            raise ValueError(
                "comm_config needs parameter gradients to bucket, but the "
                "program carries no _op_role_vars — call minimize() first")
        # grad name -> uid of its FINAL producing op (a shared
        # parameter's grad is accumulated: only the last binding is the
        # materialized gradient)
        grads = {g: p for p, g in pg}
        final = {}
        # the position of each gradient's final producer: the order the
        # ops run in. A pass (the epilogue fusion) gives the ops it makes
        # new, larger uids where they replace earlier ones, so uid order
        # is not run order there (it is for a program no pass rewrote)
        pos = {}
        order = []
        for i, op in enumerate(program.global_block().ops):
            for names in op.outputs.values():
                for n in names:
                    if n in grads:
                        if n not in final:
                            order.append(n)
                        final[n] = op.uid
                        pos[n] = i
        missing = [g for g in grads if g not in final]
        if missing:
            raise ValueError("comm_config: gradients %s are never produced "
                             "by the program" % missing)
        order.sort(key=lambda g: pos[g])

        cap = max(1, int(config.bucket_mb * (1 << 20)))
        self.buckets = []
        by_dtype = {}
        for g in order:
            p = grads[g]
            var = scope.find_var(p)
            if var is None or not hasattr(var, "shape"):
                raise ValueError(
                    "comm_config: parameter %r has no value in scope at "
                    "compile time (run the startup program first)" % p)
            n = int(np.prod(tuple(var.shape))) if var.dim() else 1
            if p in self.axis_params:
                # held 1/n a rank: the gradient is this rank's slice (the
                # scope may hold the whole value or the rank's slice)
                decl = _decl_shape(program, p)
                n = int(np.prod(decl)) // self.axis_params[p][1]
            if p in self.mp_params:
                # an mp-sharded parameter's gradient materializes as this
                # rank's shard, so its bucket slot is shard-sized
                n //= self.mp
            dt = _dtype_name(var)
            b = by_dtype.get(dt)
            if b is None or (b.grads
                             and b.bytes + n * _itemsize(dt) > cap):
                b = _Bucket(len(self.buckets), dt)
                self.buckets.append(b)
                by_dtype[dt] = b
            b.grads.append((p, g))
            b.sizes.append(n)
            b.nelem += n
        for b in self.buckets:
            b.close_uid = final[max((g for _, g in b.grads),
                                    key=lambda g: pos[g])]
            if config.zero_stage:
                b.rows = [-(-n // self.world) for n in b.sizes]
                b.shard_len = sum(b.rows)
                b.padded = b.shard_len * self.world
            else:
                b.padded = -(-b.nelem // self.world) * self.world
        self._final = final
        self._grad_bucket = {g: b for b in self.buckets
                             for _, g in b.grads}
        self.zero_updates = {}   # optimizer op uid -> _ZeroUpdate
        self.zero_state = {}     # accumulator name -> (param, nelem, rows, dt)
        self.zero_clips = {}     # global_norm_clip uid -> norm plan
        if config.zero_stage:
            self._plan_zero(program, scope)

    def _plan_mp(self, config, program):
        """Tensor-parallel planning, the JAX package's: classify every
        'mp'-sharded parameter by WHERE the axis cuts it — ``col`` (last
        dim: the Megatron column split, no forward collective) vs ``row``
        (first dim: the row split whose output is a partial sum to
        all-reduce) vs ``shard`` (1-D values such as the column-split
        fc's bias, which ride their producer's locality) — and map each
        parameter's optimizer accumulators onto the same shard layout."""
        mp = self.mp
        shapes = {}
        for v in program.list_vars():
            if not v.persistable:
                continue
            sh = tuple(getattr(v, "sharding", None) or ())
            if "mp" not in sh:
                continue
            if sh.count("mp") > 1:
                raise ValueError(
                    "comm_config: parameter %r is sharded over 'mp' on "
                    "more than one dim (%r) — the mp axis cuts each "
                    "weight exactly once" % (v.name, sh))
            dim = sh.index("mp")
            shape = tuple(int(d) for d in (v.shape or ()))
            if not shape or dim >= len(shape) or shape[dim] % mp:
                raise ValueError(
                    "comm_config: parameter %r (shape %s) dim %d is not "
                    "divisible by the mp axis size %d"
                    % (v.name, shape, dim, mp))
            if len(shape) >= 2 and dim == len(shape) - 1:
                kind = "col"
            elif len(shape) >= 2 and dim == 0:
                kind = "row"
            else:
                kind = "shard"
            self.mp_params[v.name] = kind
            self.mp_dims[v.name] = dim
            shapes[v.name] = shape
        if not self.mp_params:
            raise ValueError(
                "comm_config got a (%r, 'mp') mesh but the program has "
                "no mp-sharded parameters (declare them with "
                "ParamAttr(sharding=(None, 'mp')) / (('mp', None))); "
                "use a pure data-parallel mesh instead"
                % (self.axis,))
        if config.zero_stage:
            raise ValueError(
                "comm_config: CommConfig(zero_stage=1) does not compose "
                "with a tensor-parallel 'mp' axis yet — the [world, "
                "rows] accumulator chunking assumes replicated "
                "parameters; use zero_stage=0 on the (%r, 'mp') mesh"
                % (self.axis,))
        if config.error_feedback:
            raise ValueError(
                "comm_config: error_feedback does not compose with an "
                "'mp' axis: the residual carry is dp-sharded [world, "
                "padded] and REPLICATES over mp, but each mp device "
                "would write a distinct residual into it. Pass "
                "CommConfig(error_feedback=False) — stateless "
                "quantization composes fine.")
        for v in program.list_vars():
            owner = getattr(v, "optimizer_state_for", None)
            if owner in self.mp_params and v.shape and \
                    tuple(int(d) for d in v.shape) == shapes[owner]:
                self.mp_state[v.name] = owner
                self.mp_dims[v.name] = self.mp_dims[owner]

    def _plan_zero(self, program, scope):
        """ZeRO-1 planning: map every bucketed gradient to exactly ONE
        optimizer op, directly or through ONE shared
        ``global_norm_clip`` op; any other consumer cannot be served
        from a shard and raises, as in the JAX package."""
        block = program.global_block()
        grad_of = {}
        for b in self.buckets:
            off = 0
            for (p, g), n, r in zip(b.grads, b.sizes, b.rows):
                grad_of[g] = (p, b, off, r, n)
                off += r

        def var_of(n):
            for blk in program.blocks:
                if n in blk.vars:
                    return blk.vars[n]
            return None

        consumers = {}
        for op in block.ops:
            for names in op.inputs.values():
                for n in names:
                    consumers.setdefault(n, []).append(op)
        for g, (p, b, off, r, n) in grad_of.items():
            ops = [op for op in consumers.get(g, ())]
            clip_op = None
            grad_in = g
            if len(ops) == 1 and ops[0].type == "global_norm_clip":
                clip_op = ops[0]
                xs = list(clip_op.inputs.get("X", ()))
                outs = list(clip_op.outputs.get("Out", ()))
                gi = xs.index(g) if g in xs else -1
                grad_in = outs[gi] if 0 <= gi < len(outs) else None
                ops = list(consumers.get(grad_in, ())) if grad_in \
                    else []
            opt = [op for op in ops
                   if op.inputs.get("Param") == [p]
                   and op.inputs.get("Grad") == [grad_in]]
            if len(opt) != 1 or len(ops) != 1:
                raise ValueError(
                    "CommConfig(zero_stage=1): gradient %r of parameter "
                    "%r must be consumed by exactly its optimizer op "
                    "(optionally through one shared global_norm_clip), "
                    "but its consumers are %s — per-gradient clipping, "
                    "regularization, or custom gradient reads do not "
                    "compose with reduce-scattered buckets (each device "
                    "only holds a 1/N shard); use zero_stage=0"
                    % (g, p, [op.type for op in ops]))
            op = opt[0]
            if clip_op is not None:
                zc = self.zero_clips.setdefault(
                    clip_op.uid,
                    {"clip_norm": float(clip_op.attrs["clip_norm"]),
                     "members": []})
                zc["members"].append((b.idx, off, r, n))
            if op.type == "lamb":
                raise ValueError(
                    "CommConfig(zero_stage=1): lamb's trust-ratio "
                    "norms span the WHOLE parameter — computing them "
                    "over a 1/N shard would change the update math. "
                    "Use zero_stage=0 with lamb.")
            pshape = tuple(scope.find_var(p).shape)
            shard_ins, shard_outs, gather_outs = {}, {}, []
            for slot, names in op.inputs.items():
                if slot in ("Param", "Grad") or not names:
                    continue
                v = var_of(names[0])
                if (v is not None
                        and getattr(v, "optimizer_state_for", None) == p
                        and tuple(int(d) for d in (v.shape or ()))
                        == pshape):
                    shard_ins[slot] = names[0]
                    self.zero_state[names[0]] = (p, n, r, b.dtype)
            for slot, names in op.outputs.items():
                if not names:
                    continue
                if names[0] == p:
                    gather_outs.append(slot)
                elif names[0] in shard_ins.values():
                    shard_outs[slot] = names[0]
            if not gather_outs:
                raise ValueError(
                    "CommConfig(zero_stage=1): optimizer op %r for "
                    "parameter %r has no output slot writing the "
                    "parameter back — cannot all-gather the updated "
                    "shards" % (op.type, p))
            self.zero_updates[op.uid] = _ZeroUpdate(
                p, g, b.idx, off, r, n, shard_ins, shard_outs,
                tuple(gather_outs),
                clip_uid=clip_op.uid if clip_op is not None else None)

    @property
    def zero_state_bytes(self):
        """(full_bytes, per_rank_bytes) of the sharded optimizer state."""
        full = per_dev = 0
        for name, (p, n, r, dt) in self.zero_state.items():
            item = _itemsize(dt)
            full += n * item
            per_dev += r * item
        return full, per_dev

    @property
    def key(self):
        held = (tuple(sorted(self.axis_params)),) if self.axis_params \
            else ()
        return (self.config.key, self.axis, self.world,
                self.mp_axis, self.mp,
                tuple(sorted(self.mp_params.items())),
                tuple((b.dtype, tuple(b.sizes)) for b in self.buckets)) \
            + held

    @property
    def state_names(self):
        """Error-feedback carry names (empty unless quantizing with EF):
        per bucket the phase-1 residual and, without ZeRO, the phase-2
        residual."""
        if not self.config.error_feedback:
            return ()
        phases = ("p1",) if self.config.zero_stage else ("p1", "p2")
        return tuple("%s%d@%s" % (EF_PREFIX, b.idx, ph)
                     for b in self.buckets for ph in phases)

    # ---- static byte accounting (telemetry / smoke / docs) ----

    @property
    def grad_bytes(self):
        return sum(b.bytes for b in self.buckets)

    _UNSET = object()

    def wire_bytes(self, mode=_UNSET):
        """Modeled per-rank-step communication volume, the JAX package's
        model: an all-reduce moves ~2x its payload (scatter + gather
        phases); the quantized exchange moves the same two phases at
        transport width plus the float32 scales."""
        q = self.config.quantize if mode is CommPlan._UNSET else mode
        total = 0
        for b in self.buckets:
            if q is None:
                total += 2 * b.padded_bytes
            elif self.config.zero_stage:
                total += b.padded + 4 * self.world + b.padded_bytes
            else:
                total += 2 * b.padded + 2 * 4 * self.world
        return total

    @property
    def pre_quant_bytes(self):
        return self.wire_bytes(mode=None)

    def describe(self):
        return {
            "buckets": len(self.buckets),
            "bucket_bytes": [b.bytes for b in self.buckets],
            "grad_bytes": self.grad_bytes,
            "wire_bytes": self.wire_bytes(),
            "quantize": self.config.quantize,
            "world": self.world,
            "mp": self.mp,
            "mp_params": len(self.mp_params),
        }


def _decl_shape(program, name):
    for b in program.blocks:
        if name in b.vars:
            return tuple(int(d) for d in b.vars[name].shape)
    raise KeyError(name)


def _refuse_mp_in_stages(program, axes):
    """Raise if a ``pipeline`` op's stage reads an 'mp'-sharded value: a
    stage body runs with no comm layer, so the partial sums of its 'mp'
    products would never be reduced."""
    shardings = {v.name: tuple(getattr(v, "sharding", None) or ())
                 for v in program.list_vars()}
    for block in program.blocks:
        for op in block.ops:
            if op.type != "pipeline":
                continue
            for n in op.inputs.get("Params", []) + \
                    op.inputs.get("Consts", []):
                if "mp" in shardings.get(n, ()):
                    raise ValueError(
                        "ParallelExecutor(comm_config=None) over a mesh "
                        "with axes %r: the pipeline stage reads %r, "
                        "sharded %r over 'mp' — tensor-parallel weights "
                        "inside a pipeline stage are not supported (the "
                        "stage body runs with no 'mp' collectives); keep "
                        "'mp'-sharded weights outside the Pipeline region"
                        % (axes, n, shardings[n]))


def axis_sharded(program, mesh):
    """{name: (axis, size)} of the persistables whose leading dim the
    mesh's 'pp' or 'ep' axis cuts (``sharding[0]``): the stage-stacked
    parameters, the experts' weights, and each one's optimizer
    accumulators of the same shape, which the global view holds 1/n a
    rank as well."""
    out = {}
    for v in program.list_vars():
        sh = tuple(getattr(v, "sharding", None) or ())
        if v.persistable and sh and sh[0] in ("pp", "ep") \
                and sh[0] in mesh.shape:
            n = int(mesh.shape[sh[0]])
            if int(v.shape[0]) % n:
                raise ValueError(
                    "parameter %r (shape %s): its leading dim does not "
                    "split over the mesh's %r axis of %d"
                    % (v.name, tuple(v.shape), sh[0], n))
            out[v.name] = (sh[0], n)
    shapes = {n: _decl_shape(program, n) for n in out}
    for v in program.list_vars():
        owner = getattr(v, "optimizer_state_for", None)
        if owner in shapes and v.shape and \
                tuple(int(d) for d in v.shape) == shapes[owner]:
            out[v.name] = out[owner]
    return out


def ensure_axis_state(scope, held, mesh):
    """Hold every 'pp'/'ep'-cut persistable of ``held`` (``axis_sharded``)
    in ``scope`` as this rank's leading-dim slice (a :class:`ShardedState`
    over the rank's line of that axis, whose ``np.asarray`` gathers the
    whole value): a whole value (a fresh startup run) keeps this rank's
    rows; one already held is left as it is."""
    for name, (axis, n) in held.items():
        cur = scope.find_var(name)
        if cur is None or isinstance(cur, ShardedState):
            continue
        rows = cur.shape[0] // n
        local = cur.narrow(0, mesh.axis_rank(axis) * rows, rows).clone()
        scope.set_var(name, ShardedState.wrap(local, tuple(cur.shape),
                                              mesh.axis_group(axis)))


class _Solo:
    """The group of a line of one rank that the mesh has no axis for
    (the dp line of a mesh without 'dp'): its collectives are the
    identity and issue nothing."""

    def __repr__(self):
        return "SOLO"


SOLO = _Solo()


class _Done:
    def wait(self):
        return None


def plan_for(config, program, scope, mesh, batch_axis="dp"):
    """Build the :class:`CommPlan` for one executor plan. Behind
    ``FLAGS_verify_ir`` the finished plan is checked against the program
    it was built from (``analysis.effects``): every parameter gradient
    in exactly one bucket, ZeRO shard updates touching only owned state,
    and, over an 'mp' axis, every sharded weight closed by its Megatron
    pair and no unsafe op reading an 'mp'-local value — a malformed plan
    is a typed VerifyError, never a silently dropped reduction."""
    plan = CommPlan(config, program, scope, mesh, batch_axis)
    from paddle_tpu_torch import analysis

    if analysis.enabled():
        analysis.effects.check_comm_plan(plan, program)
        if plan.mp_params:
            analysis.effects.check_mp_placement(plan, program)
    return plan


# ---- scope state: the error-feedback carry and the ZeRO shards ----


class ShardedState(torch.Tensor):
    """This rank's rows of a state value the mesh holds 1/N a rank (a
    ZeRO-1 accumulator, an error-feedback residual): a tensor (its flat
    local rows) to every lowering, graph and copy, whose ``np.asarray``
    all-gathers the whole value in its full shape, as ``np.asarray`` of
    the JAX package's sharded array reads the global one. The gather is
    a collective over the mesh's group: every rank must ask. Results of
    operations on it are plain tensors."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    @staticmethod
    def wrap(local, full_shape, group=None):
        t = local.as_subclass(ShardedState)
        t.full_shape = tuple(int(d) for d in full_shape)
        t.group = group
        return t

    def full(self):
        """The whole value on this rank's device (a collective)."""
        world = dist.get_world_size(self.group)
        local = self.as_subclass(torch.Tensor).reshape(-1).contiguous()
        out = local.new_empty(world * local.numel())
        _all_gather_flat(out, local, group=self.group)
        n = int(np.prod(self.full_shape)) if self.full_shape else 1
        return out.reshape(-1)[:n].reshape(self.full_shape)

    def __array__(self, dtype=None, copy=None):
        v = self.full()
        if v.dtype == torch.bfloat16:
            v = v.float()
        a = v.cpu().numpy()
        return a if dtype is None else a.astype(dtype)


def _local_rows(full, rows, rank, world):
    """Rank ``rank``'s ``rows`` elements of ``full`` flattened and padded
    to ``rows * world``."""
    flat = full.reshape(-1)
    if rows * world > flat.numel():
        flat = torch.cat([flat, flat.new_zeros(rows * world - flat.numel())])
    return flat[rank * rows:(rank + 1) * rows].clone()


def state_names(scope):
    """Error-feedback carry names present in ``scope``."""
    return [n for n in scope.local_var_names()
            if n.startswith(EF_PREFIX)]


def ensure_state(scope, plan, rank=0, group=None, device=None):
    """Seed the error-feedback residual carry in ``scope``: phase-1 is
    ``[world, padded]`` (row d: rank d's own residual over the bucket;
    this rank keeps its row), phase-2 ``[padded]`` (rank d keeps chunk
    d). A value of another layout (a changed ``bucket_mb``) resets to
    zero, warned, as in the JAX package; a world change is refused by
    ``ParallelExecutor.set_mesh`` until the elastic rebuild is ported."""
    if not plan.config.error_feedback:
        return
    w = plan.world
    for b in plan.buckets:
        phases = [("p1", (w, b.padded), b.padded)]
        if not plan.config.zero_stage:
            phases.append(("p2", (b.padded,), b.padded // w))
        for ph, full, local in phases:
            name = "%s%d@%s" % (EF_PREFIX, b.idx, ph)
            cur = scope.find_var(name)
            if isinstance(cur, ShardedState) and cur.full_shape == full:
                continue
            if cur is not None:
                warnings.warn(
                    "comm_config: bucket %d's layout changed (same "
                    "name, different gradient set) — resetting its "
                    "error-feedback residual instead of folding "
                    "foreign mass" % b.idx, RuntimeWarning)
            scope.set_var(name, ShardedState.wrap(
                torch.zeros(local, dtype=getattr(torch, b.dtype),
                            device=device), full, group))


def fold_ef_state(old, phase, nelem, new_shape):
    """Re-shape an error-feedback residual across a world-size change
    WITHOUT losing gradient mass (numpy in, numpy out, the JAX package's
    function): phase-1 rows sum into row 0 of the new layout, phase-2
    keeps its global positions; padding tails are stripped against the
    true element count before re-padding."""
    old = np.asarray(old)
    out = np.zeros(new_shape, old.dtype)
    if phase == "p1":
        mass = old.reshape(old.shape[0], -1)[:, :nelem].sum(axis=0)
        out.reshape(out.shape[0], -1)[0, :nelem] = mass
    else:
        out[:nelem] = old[:nelem]
    return out


def mp_specs(plan, program):
    """{mp-sharded parameter (and its shadowing optimizer accumulator):
    spec} — which slice of each a rank holds for a step: the 'mp' axis
    on the dimension it cuts. The scope keeps the full logical shape
    (each step slices its shard and all-gathers the update back, so
    checkpoints are layout-free)."""
    out = {}
    if not plan.mp_axis:
        return out
    for v in program.list_vars():
        if v.name in plan.mp_params and getattr(v, "sharding", None):
            out[v.name] = tuple(a if a == "mp" else None
                                for a in v.sharding)
    for acc, owner in plan.mp_state.items():
        if owner in out:
            out[acc] = out[owner]
    return out


def zero_specs(plan):
    """{accumulator name: spec} of the ZeRO-1 optimizer state:
    ``[world, rows]`` arrays row-sharded over dp."""
    if not plan.config.zero_stage:
        return {}
    return {name: (plan.axis, None) for name in plan.zero_state}


def ensure_zero_state(scope, plan, rank=0, group=None, full_shapes=None):
    """Bring every ZeRO-sharded accumulator in ``scope`` to this plan's
    layout: a full value (a fresh startup run, a zero_stage 0 -> 1 flip)
    keeps this rank's rows; the right layout already is a no-op.
    ``full_shapes``: {name: the shape ``np.asarray`` gives} (default
    ``[world, rows]``, the JAX package's comm layout; the global-view
    ZeRO keeps each accumulator's declared shape)."""
    for name, (p, n, r, dt) in plan.zero_state.items():
        cur = scope.find_var(name)
        if cur is None:
            continue
        full = (full_shapes or {}).get(name, (plan.world, r))
        if isinstance(cur, ShardedState):
            if cur.full_shape == full and tuple(cur.shape) == (r,):
                continue
            cur = cur.full()
        # fold_zero_state's re-chunking, this rank's row of it
        scope.set_var(name, ShardedState.wrap(
            _local_rows(cur.reshape(-1)[:n], r, rank, plan.world), full,
            group))


def zero_layout_current(scope, plan, full_shapes=None):
    """O(1) probe: True when the scope already carries this plan's ZeRO
    layout (layout changes are all-or-nothing, so one accumulator
    tells)."""
    for name, (p, n, r, dt) in plan.zero_state.items():
        cur = scope.find_var(name)
        full = (full_shapes or {}).get(name, (plan.world, r))
        return cur is None or (isinstance(cur, ShardedState)
                               and cur.full_shape == full
                               and tuple(cur.shape) == (r,))
    return True


def fold_zero_state(old, nelem, new_shape):
    """Re-chunk a ZeRO accumulator across a layout change without
    losing state (numpy, the JAX package's function): the old rows
    concatenate back to the padded flat value, the pad tail is stripped
    and the flat value is re-padded into the new chunking."""
    flat = np.asarray(old).reshape(-1)[:nelem]
    out = np.zeros(int(np.prod(new_shape)), flat.dtype)
    out[:nelem] = flat
    return out.reshape(new_shape)


def restore_full_opt_state(scope, program):
    """Undo the ZeRO scope layout (a zero_stage 1 -> 0 flip): every
    ``optimizer_state_for``-tagged persistable the scope holds as a
    :class:`ShardedState` is gathered (a collective) and set back in its
    declared shape. Returns the number of values converted."""
    fixed = 0
    for v in program.list_vars():
        if not v.persistable \
                or getattr(v, "optimizer_state_for", None) is None \
                or not v.shape:
            continue
        cur = scope.find_var(v.name)
        if not isinstance(cur, ShardedState):
            continue
        full = tuple(int(d) for d in v.shape)
        n = int(np.prod(full))
        scope.set_var(v.name, cur.full().reshape(-1)[:n].reshape(full)
                      .clone())
        fixed += 1
    return fixed


# ---- the step's collectives (carried on TraceContext as ctx.comm) ----


def _sum_rows(t):
    """``t[0] + t[1] + ...`` over the leading (rank) axis, in rank
    order."""
    acc = t[0]
    for r in range(1, t.shape[0]):
        acc = acc + t[r]
    return acc


def gather_line(t, group, world, note=None, tag=None, axis=None):
    """[world, *t.shape]: every rank's ``t`` over ``group`` of ``world``
    ranks, in rank order; ``note(kind, t, wire, tag, axis)`` records the
    collective (a step's census)."""
    src = t.reshape(-1).contiguous()
    out = src.new_empty(world * src.numel())
    _all_gather_flat(out, src, group=group)
    if note is not None:
        note("all_gather", out,
             out.element_size() * out.numel() * (world - 1) // world,
             tag, axis)
    return out.view((world,) + tuple(t.shape))


def sum_line(t, group, world, note=None, tag=None, axis=None):
    """The sum of ``t`` over the ``world`` ranks of ``group``, the same
    bits on every rank: every rank's value gathered, added in rank
    order."""
    return _sum_rows(gather_line(t, group, world, note, tag, axis))


class _Pending:
    """A bucket's exchange in flight: the phase-1 work, the rows it
    receives, the ranks' scales (quantized), the gradients' shapes, and
    the send buffer, which must outlive the exchange."""

    __slots__ = ("work", "recv", "scales", "shapes", "send")

    def __init__(self, work, recv, scales, shapes, send):
        self.work, self.recv, self.scales = work, recv, scales
        self.shapes, self.send = shapes, send


class TraceComm:
    """One step's communication state: made by the executor for each
    step and carried through the block run as ``TraceContext.comm``.
    Tracks which env names hold this rank's rows (``local``) against
    replicated values, launches each bucket's exchange at its close op,
    completes it at its first reader, and hands the reduced gradients
    back to the env for the optimizer, clip and regularizer ops.

    ``global_view``: the ``comm_config=None`` path (the JAX package's
    global view): batch norm takes global statistics and ``accuracy``
    counts the global batch; under a CommConfig they stay per-rank
    (DDP semantics). ``census``: the step's
    :class:`parallel.comm_audit.Census`. ``mesh``: the executor's mesh,
    whose line groups the tensor axis's collectives and the ring over a
    sequence axis run in (``rank`` and ``group`` are the gradient
    exchange's: the rank's dp line, or the whole mesh in the global
    view over a sequence axis)."""

    def __init__(self, plan, ef_state, local_seed=(), rank=0, group=None,
                 global_view=False, census=None, mesh=None):
        self.plan = plan
        self.axis = plan.axis
        self.world = plan.world
        self.rank = int(rank)
        self.group = group
        self.global_view = global_view
        self.census = census
        self.mesh = mesh
        # the mesh axes the gradient exchange spans (the census's label)
        self.exchange_axis = "x".join(mesh.axis_names) \
            if mesh is not None and plan.seq_axis is not None else plan.axis
        self.seq_axis = plan.seq_axis
        # weight-locality taint (tensor parallelism): names whose env
        # value is this rank's 'mp' shard — seeded with the sharded
        # weights, biases and their optimizer accumulators, grown by
        # propagation, shrunk where the analysis places an all-reduce
        self.mp_axis = plan.mp_axis
        self.mp = plan.mp
        self.mp_local = set(plan.mp_params) | set(plan.mp_state)
        self.mp_group = self.mp_rank = None
        if self.mp_axis is not None:
            self.mp_group = mesh.axis_group("mp")
            self.mp_rank = mesh.axis_rank("mp")
        self.local = set(local_seed)   # env names holding this rank's rows
        self._globalized = set()       # op uids whose outputs are replicated
        self._global_names = set()     # single outputs made replicated
        self._launched = {}            # bucket idx -> _Pending
        self._reduced = set()          # bucket idx launched (or done)
        self._done = set()
        self.ef_in = dict(ef_state)    # name -> carried residual (local)
        self.ef_out = {}
        self._warned = set()
        self._zero_shards = {}         # bucket idx -> this rank's shard
        self._clip_factor = {}         # clip op uid -> replicated factor
        self._grad_dtypes = {}         # grad name -> its materialized dtype
        self.memo = {}                 # (op uid, tag) -> forward values
        self._last_uid = -1

    # -- the collectives, each recorded in the census --

    def _note(self, kind, t, wire, tag, axis=None):
        if self.census is not None:
            self.census.add(kind, _dtype_name(t), int(t.numel()), wire,
                            self._last_uid, tag,
                            axis or self.exchange_axis)

    def note_collective(self, kind, t, wire, tag, axis):
        """Record one collective of ``kind`` a lowering issued itself
        (the pipeline's sends and broadcasts, the experts' sums)."""
        self._note(kind, t, wire, tag, axis)

    def line_sq(self, pairs):
        """The sum of squares of the gradients ``pairs`` ([(parameter,
        gradient)]) over the whole parameters: each 'pp'/'ep'-held
        parameter's part summed over its line (rank order), the rest
        counted once (the global norm of a clip or of the guard)."""
        plain, held = None, {}
        for name, g in pairs:
            v = g.values if isinstance(g, RowSparse) else g
            sq = torch.sum(torch.square(v.to(torch.float32)))
            ax = self.plan.axis_params.get(name)
            if ax is None:
                plain = sq if plain is None else plain + sq
            else:
                held[ax[0]] = sq if ax[0] not in held else held[ax[0]] + sq
        total = plain
        for axis in sorted(held):
            part = _sum_rows(self._all_gather(
                held[axis].reshape(1), "norm", self.mesh.axis_group(axis),
                self.mesh.shape[axis], axis)).reshape(())
            total = part if total is None else total + part
        return total

    def note_p2p(self, t, tag, axis):
        """Record one point-to-point exchange of ``t`` (the ring's)."""
        self._note("send_recv", t, t.element_size() * t.numel(), tag, axis)

    def _all_to_all(self, flat, tag, async_op=False):
        """``flat`` ([world * m]) -> ([world, m] rows received: row r is
        rank r's chunk of this rank's index), and the work."""
        n = flat.numel()
        if self.group is SOLO:
            return _Done(), flat.view(1, n), flat
        send = flat.contiguous()
        wire_t = send.view(torch.uint8) \
            if send.dtype == torch.float8_e4m3fn else send
        recv = torch.empty_like(wire_t)
        work = dist.all_to_all_single(recv, wire_t, group=self.group,
                                      async_op=async_op)
        self._note("all_to_all", wire_t,
                   wire_t.element_size() * n * (self.world - 1)
                   // self.world, tag)
        if send.dtype == torch.float8_e4m3fn:
            recv = recv.view(torch.float8_e4m3fn)
        return work, recv.view(self.world, n // self.world), send

    def _all_gather(self, x, tag, group=None, world=None, axis=None):
        """[world, *x.shape]: every rank's ``x`` in rank order (over the
        exchange's group, or ``group`` of ``world`` ranks along mesh
        ``axis``)."""
        if group is None and world is None:
            group, world = self.group, self.world
        if group is SOLO:
            return x.reshape((1,) + tuple(x.shape))
        fp8 = x.dtype == torch.float8_e4m3fn
        out = gather_line(x.view(torch.uint8) if fp8 else x, group, world,
                          self._note, tag, axis)
        return out.view(torch.float8_e4m3fn) if fp8 else out

    def sum_ranks(self, t, tag="sum"):
        """The sum over the mesh's ranks of ``t``, the same bits on every
        rank: all ranks' values gathered, added in rank order."""
        return _sum_rows(self._all_gather(t, tag))

    def gather_rows(self, t, tag="gather"):
        """The ranks' ``t`` concatenated along dim 0, in rank order."""
        g = self._all_gather(t, tag)
        return g.reshape((-1,) + tuple(t.shape[1:]))

    # -- locality (called from core.lower.run_block) --

    def reads_local(self, op):
        return any(n in self.local
                   for names in op.inputs.values() for n in names)

    def propagate(self, op):
        """After an op binds its outputs: outputs of an op reading any
        local value are local, unless its lowering made them replicated
        (``mark_global``)."""
        if op.uid in self._globalized or not self.reads_local(op):
            return
        for names in op.outputs.values():
            self.local.update(n for n in names
                              if n and n not in self._global_names)

    def mark_global(self, op, slots=None):
        """Called by a lowering that reduced across ranks itself: its
        outputs (those of ``slots``, default all) are replicated."""
        if slots is None:
            self._globalized.add(op.uid)
            return
        for s in slots:
            self._global_names.update(n for n in op.outputs.get(s, ())
                                      if n)

    # -- bucket lifecycle (called from core.lower.run_block) --

    def before_op(self, op, env):
        """Before ``op`` lowers: every bucket holding a gradient it reads
        is completed now (launched first if it was not) — in non-overlap
        mode every pending bucket — so nothing reads a partial sum, and
        the guard records reduced gradients."""
        pending = {self.plan._grad_bucket[g].idx
                   for names in op.inputs.values() for g in names
                   if g in self.plan._grad_bucket
                   and self.plan._grad_bucket[g].idx not in self._done}
        if pending:
            todo = sorted(pending) if self.plan.config.overlap else \
                [b.idx for b in self.plan.buckets]
            for i in todo:
                if i not in self._done:
                    self._complete(self.plan.buckets[i], env)
        self._last_uid = op.uid

    def after_op(self, op, env):
        """Bucket trigger: ``op`` closing a bucket (its last gradient
        just materialized) launches the bucket's exchange here,
        mid-backward; with ``overlap=False`` it waits for the first
        consumer instead. Over an 'mp' axis the weight-locality analysis
        runs first: the Megatron pair's all-reduce goes at the op that
        makes the value partial, before any bucket of the op's
        gradients is launched."""
        self._last_uid = op.uid
        if self.mp_axis is not None:
            self._mp_after_op(op, env)
        if not self.plan.config.overlap:
            return
        for b in self.plan.buckets:
            if b.close_uid == op.uid and b.idx not in self._reduced:
                self._launch(b, env)

    # -- weight-locality analysis (tensor parallelism) --

    # ops that act elementwise / per-position / per-head over an
    # 'mp'-local activation, so the shard view is exact and the taint
    # just propagates (their _grad twins resolve to the same base type;
    # analysis.effects._MP_SAFE is its static twin)
    _MP_SAFE = frozenset((
        "elementwise_add", "elementwise_mul", "elementwise_sub",
        "relu", "gelu", "tanh", "sigmoid", "square", "dropout", "scale",
        "cast", "sum", "reshape", "reshape2", "transpose", "transpose2",
        "concat", "split", "fused_attention"))

    def enter_mp(self, env):
        """Start of a step over an 'mp' axis: each sharded parameter and
        accumulator in ``env`` (full logical shape, as the scope keeps
        it) becomes this rank's shard along the dimension 'mp' cuts."""
        for n, dim in self.plan.mp_dims.items():
            v = env.get(n)
            if v is None:
                continue
            size = v.shape[dim] // self.mp
            env[n] = v.narrow(dim, self.mp_rank * size, size).contiguous()

    def gather_mp(self, writes):
        """End of a step over an 'mp' axis: {name: full value} of every
        sharded parameter and accumulator the step writes, its ranks'
        shards all-gathered over the mp group, concatenated along the
        dimension 'mp' cuts (in the order of the plan)."""
        out = {}
        for n, dim in self.plan.mp_dims.items():
            v = writes.get(n)
            if v is None:
                continue
            parts = self._all_gather(v, "mp.param", self.mp_group, self.mp,
                                     "mp")
            full = list(v.shape)
            full[dim] *= self.mp
            out[n] = parts.movedim(0, dim).reshape(full)
        return out

    def _mp_after_op(self, op, env):
        t = op.type
        grad = t.endswith("_grad")
        base = t[: -len("_grad")] if grad else t
        if base in ("mul", "matmul"):
            y = (op.inputs.get("Y") or (None,))[0]
            kind = self.plan.mp_params.get(y)
            if kind == "row":
                if not grad:
                    # row-split forward: each rank contracted only its
                    # shard of the K dim — the output is a partial sum;
                    # THE all-reduce of the Megatron pair goes here
                    self._mp_psum(op, "Out", env, site="fwd_row")
                else:
                    # dX = dOut @ W_shard^T is the exact hidden shard;
                    # dW = X_shard^T @ dOut is the exact row shard
                    self._mp_mark(op, ("GRAD@X", "GRAD@Y"))
                return
            if kind == "col":
                if not grad:
                    # column-split forward: output columns are this
                    # rank's — exact shard, identity collective
                    self._mp_mark(op, ("Out",))
                else:
                    # dX = dOut_shard @ W_shard^T sums over the sharded
                    # column dim — partial; the backward all-reduce.
                    # dW = X^T @ dOut_shard is the exact column shard
                    self._mp_psum(op, "GRAD@X", env, site="bwd_col")
                    self._mp_mark(op, ("GRAD@Y",))
                return
        reads = [n for names in op.inputs.values() for n in names
                 if n and n in self.mp_local]
        if not reads:
            return
        pnames = op.inputs.get("Param")
        if pnames and pnames[0] in self.plan.mp_params:
            # optimizer op updating a sharded parameter: the update is
            # elementwise over aligned shards; scalar carries like Adam's
            # beta-pow read no shard values and stay replicated
            return
        if base in self._MP_SAFE:
            self._mp_mark_all(op)
            return
        raise ValueError(
            "comm_config: op %r (uid %d) consumes tensor-parallel local "
            "value(s) %s — only elementwise/reshape/attention ops and "
            "the mul/matmul Megatron pair may read an 'mp'-sharded "
            "activation. Close the split with a row-split projection "
            "(ParamAttr(sharding=('mp', None))) before this consumer, "
            "or drop the 'mp' axis."
            % (op.type, op.uid, sorted(set(reads))[:4]))

    def _mp_psum(self, op, slot, env, site):
        """The sum over the rank's mp group of ``op``'s ``slot`` outputs
        (``dist.all_reduce``, in place on the fresh output), recorded in
        the census as ``mp.<site>`` on the 'mp' axis."""
        placed = 0
        for n in op.outputs.get(slot, ()):
            if not n or n not in env:
                continue
            v = env[n]
            data = (v.data if isinstance(v, PackedSeq) else v).contiguous()
            dist.all_reduce(data, group=self.mp_group)
            self._note("all_reduce", data, 2 * data.element_size()
                       * data.numel() * (self.mp - 1) // self.mp,
                       "mp." + site, "mp")
            env[n] = PackedSeq(data, v.lengths) \
                if isinstance(v, PackedSeq) else data
            self.mp_local.discard(n)
            placed += 1
        if placed and telemetry.enabled():
            telemetry.counter(
                "paddle_tpu_comm_mp_collectives_total",
                "tensor-parallel all-reduces placed by the step's "
                "weight-locality analysis, by site (fwd_row: row-split "
                "forward output; bwd_col: column-split backward input "
                "grad); incremented as each is issued, every step",
                labelnames=("site",)).inc(placed, site=site)

    def _mp_mark(self, op, slots):
        for slot in slots:
            for n in op.outputs.get(slot, ()):
                if n:
                    self.mp_local.add(n)

    def _mp_mark_all(self, op):
        for names in op.outputs.values():
            for n in names:
                if n:
                    self.mp_local.add(n)

    def adjust_reshape(self, op, shape, x):
        """Head-split/merge reshapes carry GLOBAL dims in their static
        attrs; under an 'mp'-local input the first divisible non-copied
        target dim is divided by mp so the local reshape matches the
        local buffer (the JAX package's rule). The data-parallel and
        sequence axes never resize a reshape's target (it copies their
        dims with 0)."""
        if self.mp_axis is None or op is None:
            return shape
        names = op.inputs.get("X", ())
        if not names or names[0] not in self.mp_local:
            return shape
        xshape = tuple(getattr(x, "shape", ()))
        have = 1
        for d in xshape:
            have *= int(d)
        want = 1
        for d in shape:
            want *= int(d)
        if want == have:
            return shape
        if want != have * self.mp:
            raise ValueError(
                "comm_config: reshape (op uid %d) target %r does not "
                "match the 'mp'-local input %r — the global target must "
                "be exactly mp=%d times the local buffer"
                % (op.uid, tuple(shape), xshape, self.mp))
        out = list(shape)
        for skip_copied in (True, False):
            for i, s in enumerate(out):
                if s <= 0 or s % self.mp:
                    continue
                if skip_copied and i < len(xshape) \
                        and int(xshape[i]) == s:
                    continue   # dim copied from the already-local input
                out[i] = s // self.mp
                return out
        raise ValueError(
            "comm_config: reshape (op uid %d) target %r has no dim "
            "divisible by the mp axis size %d to localize"
            % (op.uid, tuple(shape), self.mp))

    def finish(self, env):
        """Close the step: complete every bucket not yet consumed and
        return the error-feedback carry's new values."""
        for b in self.plan.buckets:
            if b.idx not in self._done:
                self._complete(b, env)
        return dict(self.ef_out)

    def check_loss_global(self, loss_name, env):
        if loss_name and loss_name in self.local:
            raise ValueError(
                "comm_config requires the loss %r to be produced by a "
                "batch-spanning `mean` op (the lowering that re-emits "
                "the global reduction under local view); this program's "
                "loss is still a per-device value. Restructure the loss "
                "head or disable comm_config." % loss_name)
        if loss_name and loss_name in self.mp_local:
            raise ValueError(
                "comm_config: the loss %r is still an 'mp'-local shard "
                "— an open tensor-parallel split reached the loss head. "
                "Close every column split with a row-split projection "
                "(ParamAttr(sharding=('mp', None)))." % loss_name)

    def _gather_global(self, t):
        """A local batch-leading value back to the global one: over a
        sequence axis its time chunks (dimension 1) are gathered over
        the rank's sp line first, then the rows over the dp line; else
        its rows over the exchange's group."""
        if self.seq_axis is None:
            return self.gather_rows(t, "fetch")
        m = self.mesh
        if t.dim() >= 2:
            sp = m.axis_size(self.seq_axis)
            g = self._all_gather(t, "fetch", m.axis_group(self.seq_axis),
                                 sp, self.seq_axis)
            t = g.movedim(0, 1).reshape(
                (t.shape[0], sp * t.shape[1]) + tuple(t.shape[2:]))
        if self.axis in m.shape:
            dp = m.axis_size(self.axis)
            g = self._all_gather(t, "fetch", m.axis_group(self.axis), dp,
                                 self.axis)
            t = g.reshape((-1,) + tuple(t.shape[1:]))
        return t

    def gather_fetch(self, name, value, var):
        """Fetch repair for local values: a batch-leading fetch (var
        shape ``[-1, ...]``) is all-gathered back to the global batch
        (and, over a sequence axis, its time chunks to the whole
        sequence); any other local fetch returns this rank's value
        (warned once a step), and so does an 'mp'-local one."""
        if value is not None and name in self.mp_local:
            # hidden-dim shards carry no leading axis to gather over; the
            # caller gets this rank's slice (the parameters themselves
            # are written back whole: gather_mp)
            if name not in self._warned:
                self._warned.add(name)
                warnings.warn(
                    "comm_config: fetch %r is an 'mp'-local shard; the "
                    "fetched value is one device's slice" % name,
                    RuntimeWarning)
            return value
        if value is None or name not in self.local:
            return value
        lead = var is not None and getattr(var, "shape", None) \
            and var.shape[0] == -1
        if isinstance(value, PackedSeq):
            if lead:
                return PackedSeq(self._gather_global(value.data),
                                 self._gather_global(value.lengths))
        elif lead and isinstance(value, torch.Tensor) and value.dim() >= 1:
            return self._gather_global(value)
        if name not in self._warned:
            self._warned.add(name)
            warnings.warn(
                "comm_config: fetch %r is a per-device batch-local value "
                "with no batch-leading dimension to gather over; the "
                "fetched value is device 0's shard" % name,
                RuntimeWarning)
        return value

    # -- the reductions --

    def _launch(self, b, env):
        """Phase 1 of bucket ``b``'s exchange, launched asynchronously:
        the flat bucket (ZeRO: ``[world, shard_len]`` by parameter
        rows), quantized if asked, all-to-all."""
        missing = [g for _, g in b.grads if g not in env]
        if missing:
            raise RuntimeError(
                "comm_config: bucket %d is being reduced (a member "
                "gradient was consumed) before gradients %s "
                "materialized — this program interleaves gradient "
                "consumption with the backward in a way the bucket "
                "layout cannot serve; use a smaller bucket_mb"
                % (b.idx, missing))
        self._reduced.add(b.idx)
        parts, shapes = [], []
        for (p, g), n in zip(b.grads, b.sizes):
            v = env[g]
            if isinstance(v, RowSparse):
                v = self._densify(g, v)
            self._grad_dtypes[g] = v.dtype
            if _dtype_name(v) != b.dtype and v.is_floating_point() \
                    and v.element_size() < _itemsize(b.dtype):
                # a gradient narrower than its parameter (the embeddings'
                # bfloat16 @GRAD under AMP) travels widened, exactly, in
                # its bucket's dtype and comes back in its own
                v = v.to(getattr(torch, b.dtype))
            if _dtype_name(v) != b.dtype:
                raise TypeError(
                    "comm_config: gradient %r materialized as %s but its "
                    "bucket was planned for %s (param dtype); mixed-"
                    "precision gradient buckets need matching dtypes"
                    % (g, v.dtype, b.dtype))
            shapes.append(tuple(v.shape))
            parts.append(v.reshape(-1))
        w = self.world
        if self.plan.config.zero_stage:
            rows = []
            for v, n, r in zip(parts, b.sizes, b.rows):
                if r * w > n:
                    v = torch.cat([v, v.new_zeros(r * w - n)])
                rows.append(v.reshape(w, r))
            flat = (rows[0] if len(rows) == 1
                    else torch.cat(rows, dim=1)).reshape(-1)
        else:
            flat = parts[0] if len(parts) == 1 else torch.cat(parts)
            if b.padded > b.nelem:
                flat = torch.cat([flat, flat.new_zeros(b.padded - b.nelem)])
        tag = "bucket%d" % b.idx
        scales = None
        cfg = self.plan.config
        if cfg.quantize is not None:
            p1 = "%s%d@p1" % (EF_PREFIX, b.idx)
            if cfg.error_feedback:
                flat = flat + self.ef_in[p1].reshape(-1)
            q, scale = _quantize(flat, cfg.quantize)
            if cfg.error_feedback:
                self.ef_out[p1] = flat - _dequantize(q, scale)
            scales = self._all_gather(scale.reshape(1), tag + ".scale")
            flat = q
        work, recv, send = self._all_to_all(flat, tag, async_op=True)
        self._launched[b.idx] = _Pending(work, recv, scales, shapes, send)

    def _complete(self, b, env):
        """Wait for bucket ``b``'s phase 1, add this rank's chunk in rank
        order (dequantized, under quantization) and, without ZeRO,
        all-gather the reduced chunks back into the gradients."""
        if b.idx not in self._reduced:
            self._launch(b, env)
        pend = self._launched.pop(b.idx)
        pend.work.wait()
        self._done.add(b.idx)
        cfg = self.plan.config
        tag = "bucket%d" % b.idx
        if pend.scales is None:
            shard = _sum_rows(pend.recv)
        else:
            sc = pend.scales.reshape(-1).to(torch.float32)
            shard = _sum_rows(pend.recv.to(torch.float32) * sc[:, None]) \
                .to(getattr(torch, b.dtype))
        if cfg.zero_stage:
            self._zero_shards[b.idx] = shard
            return
        if cfg.quantize is None:
            red = self._all_gather(shard, tag).reshape(-1)
        else:
            p2 = "%s%d@p2" % (EF_PREFIX, b.idx)
            if cfg.error_feedback:
                shard = shard + self.ef_in[p2]
            q2, s2 = _quantize(shard, cfg.quantize)
            if cfg.error_feedback:
                self.ef_out[p2] = shard - _dequantize(q2, s2)
            s2s = self._all_gather(s2.reshape(1), tag + ".scale2")
            allq = self._all_gather(q2, tag)
            red = (allq.to(torch.float32)
                   * s2s.reshape(-1, 1).to(torch.float32)) \
                .reshape(-1).to(getattr(torch, b.dtype))
        off = 0
        for ((p, g), n), shape in zip(zip(b.grads, b.sizes), pend.shapes):
            env[g] = red[off:off + n].reshape(shape).to(self._grad_dtypes[g])
            off += n
            self.local.discard(g)   # reduced: replicated from here on

    def _densify(self, g, v):
        if "rowsparse" not in self._warned:
            self._warned.add("rowsparse")
            warnings.warn(
                "comm_config: densifying row-sparse gradient %r "
                "into its bucket (sparse-aware bucketing is not "
                "implemented)" % g, RuntimeWarning)
        return v.to_dense()

    def maybe_zero_update(self, ctx, op, env):
        """ZeRO-1 interception (``run_block`` calls it before the normal
        lowering): ``op`` being a bucketed parameter's optimizer op runs
        on this rank's OWNED rows — the gradient's rows from the
        reduce-scattered bucket, the parameter's rows, the accumulators'
        local rows — and the updated parameter rows are all-gathered
        back. Returns True when it handled the op."""
        if ctx.guard is not None and self.plan.axis_params:
            ctx.guard.line_sq = self.line_sq
        if not self.plan.config.zero_stage:
            return False
        zc = self.plan.zero_clips.get(op.uid)
        if zc is not None:
            self._lower_zero_clip(ctx, op, zc)
            return True
        zu = self.plan.zero_updates.get(op.uid)
        if zu is None:
            return False
        from paddle_tpu_torch.core import registry

        b = self.plan.buckets[zu.bucket]
        shard = self._zero_shards[b.idx]
        gs = shard[zu.off:zu.off + zu.rows].to(self._grad_dtypes[zu.grad])
        if zu.clip_uid is not None:
            gs = gs * self._clip_factor[zu.clip_uid].to(gs.dtype)
        pfull = env[zu.param]
        ps = _local_rows(pfull, zu.rows, self.rank, self.world)
        spec = registry.get(op.type)
        ins = {}
        for slot, names in op.inputs.items():
            if slot == "Param":
                ins[slot] = [ps]
            elif slot == "Grad":
                ins[slot] = [gs]
            elif slot in zu.shard_ins:
                ins[slot] = [env[names[0]].reshape(-1)]
            else:
                ins[slot] = [env[n] if n else None for n in names]
        if ctx.amp_dtype is not None:
            from paddle_tpu_torch import amp
            ins = amp.cast_ins(spec, ins, ctx.amp_dtype)
        if ctx.guard is not None:
            # the global-view ZeRO under the guard: the health summary
            # records this rank's gradient rows, and its sum of squares
            # is summed over the ranks before the skip decision
            ins = ctx.guard.before_op(op, spec, ins)
            ctx.guard.sq_across = self.sum_ranks
        result = registry.normalize_outputs(
            spec.lower(ctx.for_op(op), ins, op.attrs, op))
        for slot, names in op.outputs.items():
            vals = result.get(slot, ())
            for i, name in enumerate(names):
                if not name or i >= len(vals) or vals[i] is None:
                    continue
                v = vals[i]
                if slot in zu.gather_outs:
                    full = self._all_gather(v, "param").reshape(-1)
                    env[name] = full[:zu.nelem].reshape(pfull.shape)
                elif slot in zu.shard_outs:
                    env[name] = v.reshape(zu.rows)
                else:
                    env[name] = v
        # the gathered parameter is replicated again
        self.mark_global(op)
        return True

    def _lower_zero_clip(self, ctx, op, zc):
        """``global_norm_clip`` under ZeRO-1: the global norm from the
        sum over ranks of each rank's sum of squares over its gradient
        rows (the pad tail is zeros), one scalar collective; the factor
        scales each owned shard at its optimizer op."""
        ssq = torch.zeros((), dtype=torch.float32,
                          device=next(iter(self._zero_shards.values()))
                          .device)
        for bidx, off, rows, n in sorted(zc["members"]):
            sh = self._zero_shards[bidx][off:off + rows]
            ssq = ssq + torch.sum(torch.square(sh.to(torch.float32)))
        gsq = self.sum_ranks(ssq.reshape(1), "clip").reshape(())
        clip_norm = float(zc["clip_norm"])
        self._clip_factor[op.uid] = clip_norm / torch.clamp_min(
            torch.sqrt(gsq), clip_norm)
        if ctx.guard is not None:
            ctx.guard.note_clip_norm(gsq, op.attrs.get("param_names", ()))
        self.mark_global(op)

    # -- telemetry (host side, post-dispatch) --

    @staticmethod
    def record_dispatch(plan, mesh_label, steps):
        telemetry.record_comm_dispatch(
            mesh_label, len(plan.buckets),
            steps * plan.pre_quant_bytes,
            steps * plan.wire_bytes(),
            steps * sum(2 * b.padded_bytes for b in plan.buckets))


def _quantize(x, mode):
    """Symmetric per-tensor quantization to the transport dtype:
    ``(q, scale)`` with ``x ~= q * scale``; int8 on the [-127, 127]
    grid, fp8 e4m3 normalized into +-448. A NaN anywhere makes the
    scale NaN, so a poisoned step stays unhealthy."""
    xf = x.to(torch.float32)
    absmax = torch.max(torch.abs(xf))
    if mode == "int8":
        scale = torch.clamp_min(absmax, 1e-30) / 127.0
        q = torch.clamp(torch.round(xf / scale), -127.0, 127.0) \
            .to(torch.int8)
        return q, scale
    scale = torch.clamp_min(absmax, 1e-30) / 448.0
    return (xf / scale).to(torch.float8_e4m3fn), scale


def _dequantize(q, scale):
    return q.to(torch.float32) * scale.to(torch.float32)
