"""Block lowering: interpret a Block's ops over an environment of tensors.

The JAX package traces a block once under ``jax.jit`` and runs the
compiled computation. PyTorch runs eagerly, so here ``run_block`` calls
each op's lowering in program order on real tensors (or on meta tensors,
for construction-time shape inference), binding its outputs into the
environment for the ops that follow.

Randomness is deterministic per (step, op uid), as in the JAX package:
``step_key(random_seed, step)`` derives the step's key, and an op's
stream is that key mixed with its uid (and a salt), seeding a
``torch.Generator`` on the program's device. The two packages draw
different numbers from the same seed; tests that compare them carry
weights across with ``paddle_tpu_torch.interop``. A captured CUDA graph
(``core/graphs.py``) hands out its own registered generators instead
(``TraceContext.rngs``) and seeds each from :func:`op_seed` before every
replay, so a replay draws what the eager step draws.

A grad op that ``append_backward`` emitted (``<type>_grad``) runs the
forward op's ``grad_lower`` or, by default, ``registry.generic_grad``.

Mixed precision (``amp.py``): with ``program.amp_dtype`` set, each op's
inputs are cast by ``amp.cast_ins`` as they enter its lowering, and
before a hand-written ``grad_lower``; the generic grad casts inside the
forward it differentiates (``registry.generic_grad``).

The training-health guard (``guard.py``) rides ``TraceContext.guard``:
``run_op`` hands each op's inputs to ``guard.before_op`` (after the amp
casts) and each output to ``guard.rewrite_output``, as the JAX
package's lowering does; the generic grad's outputs pass through
``rewrite_output`` too.

The NaN/Inf debug guard (``core/debug.py``) rides ``TraceContext.nan``:
``run_op`` hands each op's bound outputs to the step's ``NanCheck``,
which records a device-side finiteness flag for each float tensor, as
the JAX package's ``_bind_outputs`` calls ``debug.guard_outputs``.

The data-parallel comm layer (``parallel/collectives.py``) rides
``TraceContext.comm``: ``run_block`` calls its ``before_op`` (a
bucketed gradient is reduced before anything reads it), lets its
``maybe_zero_update`` run a ZeRO-1 optimizer op on this rank's shard in
place of the normal lowering, and after each op its ``propagate``
(which values are this rank's rows) and ``after_op`` (a bucket whose
last gradient just materialized is launched there, mid-backward), as
the JAX package's ``run_block`` does.

A control-flow op (``scan_block``, ``recompute``) runs its sub-block
with the same ``run_block``, over a fresh environment that holds only
the op's ``Params``/``X``/``Init`` bindings; an error inside it is annotated with
the inner op and block, then with the control-flow op and its block.
"""

import torch

from paddle_tpu_torch.core import registry
from paddle_tpu_torch.core.ir import VarType

__all__ = ["TraceContext", "run_block", "run_op", "step_key", "op_seed",
           "PackedSeq", "RowSparse", "TensorArray", "add_rows",
           "wrap_ids", "last_writes", "concat_time_padded"]


class PackedSeq:
    """The LoD tensor: a padded dense buffer + per-sequence lengths.

    The reference represents variable-length batches as LoDTensor
    (offset vectors alongside the buffer, `framework/lod_tensor.h:58`).
    As in the JAX package, the same capability is carried as ``data``
    padded to [batch, max_len, ...] with an int32 ``lengths`` [batch];
    sequence ops consume the pair and mask internally. Gradients flow
    through ``data`` only."""

    __slots__ = ("data", "lengths")

    def __init__(self, data, lengths):
        self.data = data
        self.lengths = lengths

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    def mask(self, dtype=torch.float32):
        """[batch, max_len] validity mask."""
        t = torch.arange(self.data.shape[1], dtype=torch.int32,
                         device=self.data.device)
        return (t[None, :] < self.lengths[:, None]).to(dtype)

    def __repr__(self):
        return "PackedSeq(data=%s, lengths=%s)" % (
            tuple(self.data.shape), tuple(self.lengths.shape))


class RowSparse:
    """Row-sparse gradient: the SelectedRows redesign (reference
    `framework/selected_rows.h`, `operators/math/selected_rows_functor.cc`),
    as the JAX package carries it. ``rows`` [K] int32 indices into a
    height-``height`` table; ``values`` [K, ...] per-row data. Duplicate
    rows are allowed and mean summation. Produced by lookup_table's
    backward under ``is_sparse`` and consumed by the sparse-aware
    optimizer ops: an embedding update touches K rows, not the whole
    [V, D] table. K is the batch's id count, so a step's shapes stay
    fixed and a CUDA graph captures it. Rows are added with
    :func:`add_rows`."""

    __slots__ = ("rows", "values", "height")

    def __init__(self, rows, values, height):
        self.rows = rows
        self.values = values
        self.height = int(height)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def shape(self):
        return (self.height,) + tuple(self.values.shape[1:])

    def to_dense(self):
        return add_rows(self.values.new_zeros(self.shape), self.rows,
                        self.values)

    def astype(self, dtype):
        return RowSparse(self.rows, self.values.to(dtype), self.height)

    def __repr__(self):
        return "RowSparse(rows=%s, values=%s, height=%d)" % (
            tuple(self.rows.shape), tuple(self.values.shape), self.height)


class TensorArray:
    """Fixed-capacity tensor array, as the JAX package carries it: a
    stacked ``[capacity, ...]`` buffer ``data`` plus a 0-d int32 ``size``
    on the same device. It replaces the reference's growing
    LoDTensorArray with one static allocation, so writes index the
    buffer on the device (no host read of the index) and a CUDA graph
    captures them. Gradients flow through ``data`` only. A program
    reads a tensor-array variable that no op has written yet as None:
    the first ``write_to_array`` allocates the buffer."""

    __slots__ = ("data", "size")

    def __init__(self, data, size):
        self.data = data
        self.size = size

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    def __repr__(self):
        return "TensorArray(data=%s, size=%s)" % (
            tuple(self.data.shape), tuple(self.size.shape))


def wrap_ids(ids, n):
    """``(index, in_range)`` of integer ids into an axis of ``n``, as jnp
    indexes: a negative id wraps once; ``in_range`` is False for an id
    outside [-n, n), whose ``index`` is a valid row to read and discard.
    Three elementwise kernels (a clamp, a remainder, a compare), no host
    read."""
    c = torch.clamp(ids, -n, n - 1)
    return torch.remainder(c, n), c == ids


def last_writes(idx, size):
    """``idx`` (int64 targets along the last dim, in [0, size]; ``size``
    is a spare slot the caller drops) with every write but the last to
    each target sent to the spare slot: the winner jnp's scatter leaves
    among duplicates on the CPU, picked explicitly (the largest position
    of each target), so the card writes the CPU's bits and only the
    written update gets a gradient, as under ``jax.vjp``."""
    pos = torch.arange(idx.shape[-1], device=idx.device).expand(
        idx.shape).contiguous()
    last = torch.full(tuple(idx.shape[:-1]) + (size + 1,), -1,
                      dtype=torch.int64, device=idx.device).scatter_reduce(
        -1, idx, pos, "amax")
    return torch.where(last.gather(-1, idx) == pos, idx, size)


def add_rows(t, rows, values):
    """``t`` with ``values[i]`` added to row ``rows[i]`` for every i (a
    new tensor), duplicate rows added one after another in index order,
    as the JAX package's scatter-add on the CPU adds them, so the result
    has the same bits from run to run. On the card ``index_put(...,
    accumulate=True)`` sorts the rows (stably) and adds each row's
    duplicates in one thread; ``index_add`` would add them by atomics
    there, in any order. On the CPU ``index_add`` is the serial loop,
    where ``index_put`` adds by atomics across threads. A negative row
    wraps once and a row out of range is dropped, as jnp's scatter does
    (an embedding id out of range reaches here through a ``RowSparse``
    gradient): such rows add into a spare row that the result leaves
    out, where an index out of range would fault on the card."""
    n = t.shape[0]
    idx, ok = wrap_ids(rows.to(torch.int64), n)
    rows = torch.where(ok, idx, n)
    ext = torch.cat([t, t.new_zeros((1,) + tuple(t.shape[1:]))])
    if t.device.type == "cuda":
        ext.index_put_((rows,), values, accumulate=True)
    else:
        ext.index_add_(0, rows, values)
    return ext[:n]


_MASK64 = (1 << 64) - 1


def concat_time_padded(datas, lengths_list, xp=torch):
    """LoD batch-concat semantics shared by the concat op lowering and
    the serving batcher: pad each ``[batch, time, ...]`` buffer to the
    common max time dim (the per-sequence lengths carry the truth), then
    concatenate along batch. ``xp`` is ``torch`` (tensors) or ``numpy``
    (host arrays). Returns ``(data, lengths)``."""
    maxt = max(d.shape[1] for d in datas)
    if xp is torch:
        datas = [torch.nn.functional.pad(
            d, [0, 0] * (d.dim() - 2) + [0, maxt - d.shape[1]])
            if d.shape[1] < maxt else d for d in datas]
        return torch.cat(datas, dim=0), torch.cat(lengths_list)
    datas = [
        xp.pad(d, [(0, 0), (0, maxt - d.shape[1])]
               + [(0, 0)] * (d.ndim - 2)) if d.shape[1] < maxt else d
        for d in datas]
    return (xp.concatenate(datas, axis=0),
            xp.concatenate(lengths_list))


def _splitmix64(x):
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def _fold_in(key, data):
    return _splitmix64(key ^ _splitmix64(int(data) & _MASK64))


def step_key(random_seed, step_idx):
    """Per-step root key: the program's seed folded with the step index."""
    return _fold_in(_splitmix64(int(random_seed) & _MASK64), step_idx)


def op_seed(key, uid, salt=0):
    """The seed of one op's stream in the step whose key is ``key``."""
    k = _fold_in(key, uid)
    if salt:
        k = _fold_in(k, salt)
    return k


class TraceContext:
    """Carried through a block run; provides the device, per-op random
    streams and the mode flag to op lowerings."""

    def __init__(self, key=0, training=True, program=None, device=None,
                 guard=None, comm=None):
        self.key = int(key)
        self.training = training
        self.program = program
        self.device = device if device is not None else torch.device("cpu")
        # mixed precision: the compute dtype cast in at lowering
        # boundaries (amp.py); None = full precision
        self.amp_dtype = getattr(program, "amp_dtype", None)
        # the training-health guard (guard.TraceGuard): records the
        # optimizer-input grads, poisons and unscales them, scales the
        # backward's seed; None = unguarded
        self.guard = guard
        # the data-parallel comm layer (parallel/collectives.TraceComm):
        # batch locality, bucket triggers, the ZeRO-1 interception and
        # the local-view lowerings' cross-rank sums; None = one device
        self.comm = comm
        # None, or what hands out the generators (``core/graphs.py``:
        # the ones a CUDA graph registered, or a recorder of the draws)
        self.rngs = None
        # the step's debug.NanCheck under FLAGS_check_nan_inf, else None
        self.nan = None
        self._op = None

    def for_op(self, op):
        c = TraceContext.__new__(TraceContext)
        c.key = self.key
        c.training = self.training
        c.program = self.program
        c.device = self.device
        c.amp_dtype = self.amp_dtype
        c.guard = self.guard
        c.comm = self.comm
        c.rngs = self.rngs
        c.nan = self.nan
        c._op = op
        return c

    def rng(self, op=None, salt=0):
        """A ``torch.Generator`` on this run's device, seeded from the
        step key, the op's uid and ``salt``; None on the meta device
        (shape inference draws nothing)."""
        if self.device.type == "meta":
            return None
        op = op if op is not None else self._op
        uid = op.uid if op is not None else 0
        if self.rngs is not None:
            return self.rngs.generator(self, uid, salt)
        return torch.Generator(device=self.device).manual_seed(
            op_seed(self.key, uid, salt))


def run_block(ctx, block, env):
    """Run ``block``'s ops in order over ``env`` (name -> tensor),
    mutating and returning env.

    A program the remat pass planned (``passes/remat.py``) re-runs a
    segment's forward ops at its first grad op (:func:`_replay_segment`)
    and drops each segment-internal value from ``env`` after the op the
    plan's ``release`` table names, so the eager run holds what the JAX
    package's fenced replay holds.

    Errors are annotated with the failing op's identity — the
    enforce-layer capability of the reference (`platform/enforce.h:195`):
    the user sees WHICH op in WHICH block failed."""
    remat = getattr(ctx.program, "_remat_plan", None) \
        if block.idx == 0 and ctx.program is not None else None
    for op in block.ops:
        try:
            if remat is not None:
                seg = remat.by_trigger.get(op.uid)
                if seg is not None:
                    _replay_segment(ctx, block, seg, env)
            comm = ctx.comm if block.idx == 0 else None
            if comm is not None:
                comm.before_op(op, env)
                if comm.maybe_zero_update(ctx, op, env):
                    comm.propagate(op)
                    continue
            run_op(ctx, block, op, env)
            if comm is not None:
                comm.propagate(op)
                comm.after_op(op, env)
            if remat is not None:
                for n in remat.release.get(op.uid, ()):
                    env.pop(n, None)
        except Exception as e:
            e.add_note(
                "  [paddle_tpu_torch] while running op '%s' (uid %d) in "
                "block %d\n    inputs:  %s\n    outputs: %s"
                % (op.type, op.uid, block.idx, dict(op.inputs),
                   dict(op.outputs)))
            raise
    return env


def _replay_segment(ctx, block, seg, env):
    """Re-run a remat segment's forward ops (``passes/remat.py``) and
    rebind its internal activations for the grad ops that follow. The
    replay runs through the same ``run_op`` with the same TraceContext:
    per-op random streams fold the same uids into the same step key
    (dropout masks replay bitwise, never re-drawn) and amp casts
    re-apply, so every re-materialized value is the stored one."""
    sub = dict(env)
    for i in range(seg.start, seg.end):
        run_op(ctx, block, block.ops[i], sub)
    for n in seg.internal:
        env[n] = sub[n]


def run_op(ctx, block, op, env):
    if op.type.endswith("_grad") and not registry.has(op.type):
        _run_generic_grad_op(ctx, block, op, env)
        return
    spec = registry.get(op.type)
    ins = {slot: [_lookup(env, block, n) for n in names]
           for slot, names in op.inputs.items()}
    if ctx.amp_dtype is not None:
        from paddle_tpu_torch import amp
        ins = amp.cast_ins(spec, ins, ctx.amp_dtype)
    if ctx.guard is not None:
        # the guard records the optimizer-input grads after the casts,
        # as the update math sees them
        ins = ctx.guard.before_op(op, spec, ins)
    result = spec.lower(ctx.for_op(op), ins, op.attrs, op)
    if ctx.guard is not None:
        result = _guard_rewrite(ctx.guard, op, result)
    updates = _bind_outputs(env, op, result)
    if ctx.nan is not None:
        ctx.nan.check(op, updates)


def _guard_rewrite(guard, op, result):
    """The guard's output rewrites (the seed's scaling, a parameter
    gradient's poison and unscale at its final producer) over one
    lowering's result."""
    result = registry.normalize_outputs(result)
    out = {}
    for slot, vals in result.items():
        names = op.outputs.get(slot, ())
        out[slot] = [
            guard.rewrite_output(names[i], v, op.uid)
            if i < len(names) and names[i] else v
            for i, v in enumerate(vals)]
    return out


def _run_generic_grad_op(ctx, block, op, env):
    """Execute a grad op emitted by append_backward.

    Grad op layout (see backward.py): inputs = forward inputs under their
    original slots + ``GRAD@<slot>`` cotangent slots; outputs =
    ``GRAD@<slot>`` per differentiable forward input slot. A missing /
    empty-name cotangent means "no gradient flows to this output" (zeros).
    """
    spec = registry.get(op.type[: -len("_grad")])
    fwd_ins, out_grads = {}, {}
    for slot, names in op.inputs.items():
        vals = [_lookup(env, block, n) if n else None for n in names]
        if slot.startswith("GRAD@"):
            out_grads[slot[len("GRAD@"):]] = vals
        else:
            fwd_ins[slot] = vals
    fwd_op = _FwdOpView(op)
    if spec.grad_lower is not None:
        if ctx.amp_dtype is not None:
            from paddle_tpu_torch import amp
            fwd_ins = amp.cast_ins(spec, fwd_ins, ctx.amp_dtype)
        gins = spec.grad_lower(ctx.for_op(fwd_op), fwd_ins, out_grads,
                               fwd_op.attrs, fwd_op)
    else:
        gins = registry.generic_grad(ctx, spec, fwd_op, fwd_ins, out_grads)
    for slot, names in op.outputs.items():
        assert slot.startswith("GRAD@"), slot
        base = slot[len("GRAD@"):]
        gs = gins.get(base, [])
        for i, n in enumerate(names):
            if not n:
                continue
            g = gs[i] if i < len(gs) else None
            if g is None:
                # a gradient the forward says is zero: zeros shaped like
                # the forward input
                g = _zeros_like(fwd_ins[base][i])
            if ctx.guard is not None:
                g = ctx.guard.rewrite_output(n, g, op.uid)
            env[n] = g


def _zeros_like(v):
    if isinstance(v, TensorArray):
        return TensorArray(torch.zeros_like(v.data), v.size)
    if isinstance(v, RowSparse):
        return RowSparse(v.rows, torch.zeros_like(v.values), v.height)
    if isinstance(v, PackedSeq):
        return PackedSeq(torch.zeros_like(v.data), v.lengths)
    return torch.zeros_like(v)


class _FwdOpView:
    """Presents a grad op as its forward op (same attrs, forward uid for
    the same random draws)."""

    __slots__ = ("type", "attrs", "uid", "inputs", "outputs", "block")

    def __init__(self, grad_op):
        self.type = grad_op.type[: -len("_grad")]
        self.attrs = grad_op.attrs
        self.uid = grad_op.attrs.get("fwd_op_uid", grad_op.uid)
        self.inputs = {k: v for k, v in grad_op.inputs.items()
                       if not k.startswith("GRAD@")}
        self.outputs = {}
        self.block = grad_op.block


def _lookup(env, block, name):
    if name in env:
        return env[name]
    if block.has_var(name) and block.var(name).type == VarType.TENSOR_ARRAY:
        return None               # an array no op has written yet
    raise KeyError(
        "op input %r has no value at run time (not fed, not in scope, and "
        "not produced by an earlier op in block %d)" % (name, block.idx))


def _bind_outputs(env, op, result):
    """Bind a lowering's outputs into ``env``; returns the bound
    ``[(name, value)]``."""
    result = registry.normalize_outputs(result)
    updates = []
    for slot, names in op.outputs.items():
        if slot not in result:
            continue
        vals = result[slot]
        for i, n in enumerate(names):
            if n and i < len(vals) and vals[i] is not None:
                env[n] = vals[i]
                updates.append((n, vals[i]))
    return updates
