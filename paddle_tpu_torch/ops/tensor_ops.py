"""Tensor-manipulation op lowerings.

Capability parity: reference cast/concat/split/reshape/transpose/expand/
pad/crop/slice/gather/scatter/multiplex/one_hot/top_k/arg_max/argsort/
fill*/assign/hash/row_conv and the random family
(`paddle/fluid/operators/`, §2.3 "Tensor manipulation"), as the JAX
package's ``ops/tensor_ops.py`` lowers them, with its gradient flags,
and its four vision ops (``resize_nearest``, ``resize_bilinear``,
``grid_sampler``, ``roi_pool``).

Every lowering runs on the card inside a captured CUDA graph: no value
goes to or comes from the host while a step runs (constants are Python
scalars or ``torch.arange``, never ``torch.tensor`` of a host list), and
an output whose size would depend on the data (``unique_with_counts``)
has the static size the JAX package gives it. Out-of-range indices
follow ``jnp``: ``gather`` (``jnp.take``) fills the row with NaN,
``gather_nd`` and ``multiplex`` clamp, ``scatter`` drops the update
(and under ``overwrite`` the last of duplicate ids wins); all of them
wrap a negative id once. Integer results are recorded as
the JAX package records them with 64-bit types off (int32). The random
ops draw from the op's generator (``TraceContext.rng``), so a graph
replay draws what the eager step draws.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.infer import torch_dtype
from paddle_tpu_torch.core.lower import (PackedSeq, add_rows,
                                         concat_time_padded, last_writes)
from paddle_tpu_torch.core.registry import op
from paddle_tpu_torch.ops.beam_search_ops import top_k_lower_index_first


def _x(ins, slot="X"):
    return ins[slot][0]


@op("cast", seq_map=True)
def _cast(ctx, ins, attrs, o):
    return _x(ins).to(torch_dtype(attrs["out_dtype"]))


@op("reshape")
def _reshape(ctx, ins, attrs, o):
    x = _x(ins)
    shape = list(attrs["shape"])
    # paddle semantics: 0 means copy input dim at that position
    for i, s in enumerate(shape):
        if s == 0:
            shape[i] = x.shape[i]
    if ctx is not None and getattr(ctx, "comm", None) is not None:
        # the comm layer's reshape hook (a tensor-axis shard resizes the
        # target; the data-parallel axis keeps it)
        shape = ctx.comm.adjust_reshape(o, shape, x)
    return {"Out": x.reshape(shape), "XShape": None}


op("reshape2")(_reshape)


@op("squeeze")
def _squeeze(ctx, ins, attrs, o):
    x = _x(ins)
    axes = attrs.get("axes", [])
    if not axes:
        return x.squeeze()
    # only axes of size 1 go, as jnp.squeeze over the JAX package's filter
    return x.squeeze(tuple(a for a in axes if x.shape[a] == 1))


@op("unsqueeze")
def _unsqueeze(ctx, ins, attrs, o):
    x = _x(ins)
    for a in sorted(attrs["axes"]):
        x = x.unsqueeze(a)
    return x


@op("transpose")
def _transpose(ctx, ins, attrs, o):
    return {"Out": _x(ins).permute(*attrs["axis"]), "XShape": None}


op("transpose2")(_transpose)


@op("flatten")
def _flatten(ctx, ins, attrs, o):
    x = _x(ins)
    return x.reshape(math.prod(x.shape[:attrs.get("axis", 1)]), -1)


@op("expand")
def _expand(ctx, ins, attrs, o):
    """Paddle's expand tiles by ``expand_times`` (``jnp.tile``), which
    ``torch.Tensor.expand`` does not do."""
    return torch.tile(_x(ins), tuple(attrs["expand_times"]))


@op("tile")
def _tile(ctx, ins, attrs, o):
    return torch.tile(_x(ins), tuple(attrs["repeat_times"]))


@op("stack")
def _stack(ctx, ins, attrs, o):
    return {"Y": torch.stack(ins["X"], dim=attrs.get("axis", 0))}


@op("unstack")
def _unstack(ctx, ins, attrs, o):
    return {"Y": list(torch.unbind(_x(ins), dim=attrs.get("axis", 0)))}


@op("split")
def _split(ctx, ins, attrs, o):
    x = _x(ins)
    axis = attrs.get("axis", 0)
    sections = attrs.get("sections")
    if sections:
        parts = torch.split(x, list(sections), dim=axis)
    else:
        parts = torch.split(x, x.shape[axis] // attrs.get("num", 0), dim=axis)
    return {"Out": list(parts)}


@op("pad")
def _pad(ctx, ins, attrs, o):
    x = _x(ins)
    p = attrs["paddings"]  # flat [before0, after0, before1, after1, ...]
    # F.pad takes the pairs from the last dim back
    flat = [int(v) for i in reversed(range(x.dim()))
            for v in (p[2 * i], p[2 * i + 1])]
    return F.pad(x, flat, value=attrs.get("pad_value", 0.0))


@op("pad2d")
def _pad2d(ctx, ins, attrs, o):
    x = _x(ins)  # NCHW
    top, bottom, left, right = (int(v) for v in attrs["paddings"])
    mode = attrs.get("mode", "constant")
    if mode == "constant":
        return F.pad(x, [left, right, top, bottom],
                     value=attrs.get("pad_value", 0.0))
    return F.pad(x, [left, right, top, bottom],
                 mode={"reflect": "reflect", "edge": "replicate"}[mode])


@op("crop")
def _crop(ctx, ins, attrs, o):
    """``lax.dynamic_slice``: an offset that would run past a dim moves
    back until the window fits."""
    x = _x(ins)
    for d, (off, n) in enumerate(zip(attrs.get("offsets"), attrs["shape"])):
        x = x.narrow(d, min(max(int(off), 0), x.shape[d] - int(n)), int(n))
    return x


def _slice_dim(x, axis, start, end, step):
    """x[..., start:end:step, ...] on ``axis`` with Python's rules
    (negative starts, ends clamped, negative steps)."""
    start, end, step = slice(start, end, step).indices(x.shape[axis])
    if step > 0:
        idx = [slice(None)] * x.dim()
        idx[axis] = slice(start, end, step)
        return x[tuple(idx)]
    return x.index_select(axis, torch.arange(start, end, step,
                                             device=x.device))


@op("slice")
def _slice(ctx, ins, attrs, o):
    x = _x(ins)
    for a, s, e in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        x = _slice_dim(x, a, s, e, 1)
    return x


@op("strided_slice")
def _strided_slice(ctx, ins, attrs, o):
    x = _x(ins)
    for a, s, e, st in zip(attrs["axes"], attrs["starts"], attrs["ends"],
                           attrs.get("strides", [1] * len(attrs["axes"]))):
        x = _slice_dim(x, a, s, e, st)
    return x


@op("reverse")
def _reverse(ctx, ins, attrs, o):
    axes = attrs["axis"]
    return torch.flip(_x(ins), tuple(axes) if isinstance(axes, (list, tuple))
                      else (axes,))


@op("shape", no_grad=True)
def _shape(ctx, ins, attrs, o):
    x = _x(ins, "Input")
    out = torch.zeros((x.dim(),), dtype=torch.int32, device=x.device)
    for i, d in enumerate(x.shape):
        out[i] = d              # a fill with a Python scalar: no host copy
    return out


# ---- indexing ----

def _wrap(idx, n):
    """A negative id counts from the end, once (numpy's rule)."""
    return torch.where(idx < 0, idx + n, idx)


@op("gather", nondiff_inputs=("Index",))
def _gather(ctx, ins, attrs, o):
    """``jnp.take``: a negative id wraps once; an id out of [-n, n) reads
    a row of NaN (of the lowest value for an integer X), where CUDA
    indexing would fault."""
    x, idx = _x(ins), ins["Index"][0].to(torch.int64)
    if idx.dim() == 2 and idx.shape[1] == 1:
        idx = idx[:, 0]
    axis = attrs.get("axis", 0) % x.dim()
    n = x.shape[axis]
    idx = _wrap(idx, n)
    ok = (idx >= 0) & (idx < n)
    out = torch.index_select(x, axis, torch.clamp(idx, 0, max(n - 1, 0))
                             .reshape(-1))
    out = out.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])
    fill = float("nan") if x.is_floating_point() else \
        torch.iinfo(x.dtype).min
    ok = ok.reshape((1,) * axis + tuple(idx.shape)
                    + (1,) * (x.dim() - axis - 1))
    return torch.where(ok, out, fill)


def _clamped_grad(out, valid):
    """``out`` whose gradient reaches only the ``valid`` entries: jnp
    indexing clamps an id in the forward, and its transpose (a scatter)
    drops the update of an id that was out of range."""
    return torch.where(valid, out, out.detach())


@op("gather_nd", nondiff_inputs=("Index",))
def _gather_nd(ctx, ins, attrs, o):
    """``x[tuple(index[..., i])]`` as jnp indexes: a negative id wraps,
    then every id is clamped into its dim (the gradient of a clamped
    row is dropped)."""
    x, idx = _x(ins), ins["Index"][0].to(torch.int64)
    m = idx.shape[-1]
    keys = [_wrap(idx[..., i], x.shape[i]) for i in range(m)]
    valid = torch.ones_like(idx[..., 0], dtype=torch.bool)
    for i, k in enumerate(keys):
        valid = valid & (k >= 0) & (k < x.shape[i])
    out = x[tuple(torch.clamp(k, 0, x.shape[i] - 1)
                  for i, k in enumerate(keys))]
    return _clamped_grad(out, valid.reshape(
        tuple(valid.shape) + (1,) * (x.dim() - m)))


@op("scatter", nondiff_inputs=("Ids",))
def _scatter(ctx, ins, attrs, o):
    """``x.at[ids].set(updates)`` (``overwrite``) or ``.add``: a negative
    id wraps once, and an update whose id is out of range is dropped
    (written to a spare row that the result leaves out). Among duplicate
    ids under ``overwrite`` the last update wins, as the JAX package's
    scatter on the CPU has it, and only it is written
    (``last_writes``)."""
    x, ids, upd = _x(ins), ins["Ids"][0].to(torch.int64), ins["Updates"][0]
    if ids.dim() == 2 and ids.shape[1] == 1:
        ids = ids[:, 0]
    n = x.shape[0]
    ids = _wrap(ids, n)
    ids = torch.where((ids >= 0) & (ids < n), ids, n)
    ext = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    if attrs.get("overwrite", True):
        ext = ext.index_put((last_writes(ids, n),), upd.to(x.dtype))
    else:
        ext = add_rows(ext, ids, upd.to(x.dtype))
    return ext[:n]


@op("multiplex", nondiff_inputs=("Ids",))
def _multiplex(ctx, ins, attrs, o):
    """Row i of the output is row i of X[ids[i]]; an id out of range is
    clamped (after a negative one wraps), as jnp indexing does, and
    passes no gradient."""
    stacked = torch.stack(ins["X"], dim=0)           # [K, B, ...]
    k = stacked.shape[0]
    ids = _wrap(ins["Ids"][0].to(torch.int64).reshape(-1), k)
    out = stacked[torch.clamp(ids, 0, k - 1),
                  torch.arange(stacked.shape[1], device=stacked.device)]
    return _clamped_grad(out, ((ids >= 0) & (ids < k)).reshape(
        (-1,) + (1,) * (out.dim() - 1)))


@op("one_hot", no_grad=True)
def _one_hot(ctx, ins, attrs, o):
    """``jax.nn.one_hot``: float32, and an id outside [0, depth) gives a
    row of zeros (``F.one_hot`` would raise)."""
    x = _x(ins).to(torch.int64)
    if x.dim() >= 2 and x.shape[-1] == 1:
        x = x.squeeze(-1)
    depth = torch.arange(attrs["depth"], device=x.device)
    return (x[..., None] == depth).to(torch.float32)


@op("arg_max", no_grad=True)
def _arg_max(ctx, ins, attrs, o):
    return torch.argmax(_x(ins), dim=attrs.get("axis", -1)).to(torch.int32)


@op("arg_min", no_grad=True)
def _arg_min(ctx, ins, attrs, o):
    return torch.argmin(_x(ins), dim=attrs.get("axis", -1)).to(torch.int32)


@op("argsort", no_grad=True)
def _argsort(ctx, ins, attrs, o):
    """Ties keep their order (``jnp.argsort`` is stable)."""
    v, i = torch.sort(_x(ins), dim=attrs.get("axis", -1), stable=True)
    return {"Out": v, "Indices": i.to(torch.int32)}


@op("unique_with_counts", no_grad=True)
def _unique_with_counts(ctx, ins, attrs, o):
    """``jnp.unique(x, size=x.size)`` at a static shape: the sorted
    distinct values, padded with the smallest, their counts (0 in the
    padding) and each element's index into them. Built from a stable
    sort, the adjacent differences and a running sum on the device
    (``torch.unique`` reads its size on the host)."""
    x = _x(ins).reshape(-1)
    s, perm = torch.sort(x, stable=True)
    new = torch.ones_like(s, dtype=torch.bool)
    new[1:] = s[1:] != s[:-1]
    group = torch.cumsum(new.to(torch.int64), 0) - 1
    vals = s[:1].expand(s.shape[0]).clone().scatter(0, group, s)
    counts = torch.zeros_like(group).scatter_add(
        0, group, torch.ones_like(group))
    index = torch.empty_like(group).scatter(0, perm, group)
    return {"Out": vals, "Index": index.to(torch.int32),
            "Count": counts.to(torch.int32)}


@op("hash", no_grad=True)
def _hash(ctx, ins, attrs, o):
    """The JAX package's multiplicative hash: x as uint32, times
    2654435761 + 97 i modulo 2**32, xor its high half into the low, then
    ``astype(int64)``, which is int32 with 64-bit types off (a value of
    2**31 or more wraps negative), then a floor ``%`` by hash_size.
    torch has no full uint32 arithmetic: it runs in int64 on 32-bit
    values, the product split in two 16-bit halves of the multiplier so
    nothing overflows."""
    x = _x(ins).to(torch.int64) & 0xFFFFFFFF
    size = attrs["hash_size"]
    outs = []
    for i in range(attrs.get("num_hash", 1)):
        m = 2654435761 + 97 * i
        h = (x * (m & 0xFFFF) + (((x * (m >> 16)) & 0xFFFF) << 16)) \
            & 0xFFFFFFFF
        h = h ^ (h >> 16)
        h = torch.where(h >= 2 ** 31, h - 2 ** 32, h)
        outs.append(torch.remainder(h, size).to(torch.int32))
    return torch.stack(outs, dim=-2) if len(outs) > 1 else outs[0]


@op("similarity_focus", no_grad=True)
def _similarity_focus(ctx, ins, attrs, o):
    x = _x(ins)  # NCHW
    axis = attrs["axis"]
    sel = torch.cat([x.narrow(axis, int(i), 1) for i in attrs["indexes"]],
                    dim=axis)
    m = torch.amax(sel, dim=axis, keepdim=True)
    return torch.where(x >= m, 1.0, 0.0).to(x.dtype)


# ---- fills and arithmetic ----

@op("fill_zeros_like", no_grad=True)
def _fill_zeros_like(ctx, ins, attrs, o):
    # over a PackedSeq, the JAX package's tree_map zeroes the lengths too
    x = _x(ins)
    if isinstance(x, PackedSeq):
        return PackedSeq(torch.zeros_like(x.data), torch.zeros_like(x.lengths))
    return torch.zeros_like(x)


@op("minus")
def _minus(ctx, ins, attrs, o):
    return _x(ins) - _x(ins, "Y")


@op("linspace", no_grad=True)
def _linspace(ctx, ins, attrs, o):
    return torch.linspace(attrs["start"], attrs["stop"], attrs["num"],
                          dtype=torch_dtype(attrs.get("dtype", "float32")),
                          device=ctx.device)


@op("range", no_grad=True)
def _range(ctx, ins, attrs, o):
    return torch.arange(attrs["start"], attrs["end"], attrs.get("step", 1),
                        dtype=torch_dtype(attrs.get("dtype", "float32")),
                        device=ctx.device)


@op("row_conv")
def _row_conv(ctx, ins, attrs, o):
    """Lookahead row convolution (`operators/row_conv_op`): out[t] =
    sum_{j<k} x[t+j] * w[j] over the time axis of [B, T, D]; a
    PackedSeq's steps past its length are zero."""
    x, w = _x(ins), ins["Filter"][0]  # w: [future_context, D]
    data = x.data if isinstance(x, PackedSeq) else x
    k, t = w.shape[0], data.shape[1]
    pad = F.pad(data, [0, 0, 0, k - 1])
    out = sum(pad[:, j:j + t] * w[j][None, None, :] for j in range(k))
    if isinstance(x, PackedSeq):
        return PackedSeq(out * x.mask(out.dtype)[..., None], x.lengths)
    return out


@op("concat")
def _concat(ctx, ins, attrs, o):
    """Reference concat_op. For PackedSeq inputs the LoD row dim
    ([batch, time] here) counts as ONE reference dim, so a feature-axis
    concat (axis>=1) shifts by one and keeps the lengths."""
    xs = ins["X"]
    axis = attrs.get("axis", 0)
    if any(isinstance(v, PackedSeq) for v in xs):
        lengths = next(v.lengths for v in xs if isinstance(v, PackedSeq))
        datas = [v.data if isinstance(v, PackedSeq) else v for v in xs]
        if axis == 0:
            out, lengths = concat_time_padded(
                datas,
                [v.lengths if isinstance(v, PackedSeq)
                 else torch.full((v.shape[0],), v.shape[1],
                                 dtype=torch.int32, device=v.device)
                 for v in xs])
            return PackedSeq(out, lengths)
        # axis >= 1 shifts past the two-dim token axis; -1 is the last
        # feature axis of the padded buffer
        return PackedSeq(torch.cat(datas, dim=axis + 1 if axis >= 1
                                   else axis), lengths)
    return torch.cat(xs, dim=axis)


@op("top_k")
def _top_k(ctx, ins, attrs, o):
    """``lax.top_k``: largest first, the lower index first among equal
    values (``torch.topk`` promises no order for ties)."""
    x, k = _x(ins), attrs.get("k", 1)
    if x.is_floating_point():
        v, i = top_k_lower_index_first(x, k)
    else:
        v, i = torch.sort(x, dim=-1, descending=True, stable=True)
        v, i = v[..., :k], i[..., :k]
    return {"Out": v, "Indices": i}


@op("assign")
def _assign(ctx, ins, attrs, o):
    return _x(ins)


@op("assign_value", no_grad=True)
def _assign_value(ctx, ins, attrs, o):
    vals = np.asarray(attrs["values"], dtype=attrs.get("dtype", "float32"))
    return torch.as_tensor(vals.reshape(attrs["shape"]), device=ctx.device)


@op("fill_constant", no_grad=True)
def _fill_constant(ctx, ins, attrs, o):
    dtype = torch_dtype(attrs.get("dtype", "float32"))
    shape = tuple(int(s) for s in attrs.get("shape", []))
    return torch.full(shape, attrs.get("value", 0.0), dtype=dtype,
                      device=ctx.device)


def _batch_size_like_shape(ins, attrs):
    ref = ins["Input"][0]
    ref = ref.data if isinstance(ref, PackedSeq) else ref
    shape = list(attrs["shape"])
    shape[attrs.get("output_dim_idx", 0)] = \
        ref.shape[attrs.get("input_dim_idx", 0)]
    return tuple(int(s) for s in shape), ref.device


@op("fill_constant_batch_size_like", no_grad=True)
def _fill_constant_bsl(ctx, ins, attrs, o):
    """A constant whose ``output_dim_idx`` dim is the ``input_dim_idx``
    dim of Input (a PackedSeq's padded buffer counts its batch there)."""
    shape, device = _batch_size_like_shape(ins, attrs)
    return torch.full(shape, attrs.get("value", 0.0),
                      dtype=torch_dtype(attrs.get("dtype", "float32")),
                      device=device)


@op("increment", no_grad=True)
def _increment(ctx, ins, attrs, o):
    x = _x(ins)
    step = attrs.get("step", 1.0)
    # keep the dtype: an int counter stays int (the JAX package casts
    # the step to the counter's dtype)
    return x + (step if x.is_floating_point() else int(step))


@op("where", nondiff_inputs=("Condition",))
def _where(ctx, ins, attrs, o):
    return torch.where(ins["Condition"][0], _x(ins), _x(ins, "Y"))


@op("uniform_random", no_grad=True)
def _uniform_random(ctx, ins, attrs, o):
    shape = tuple(int(s) for s in attrs["shape"])
    dtype = torch_dtype(attrs.get("dtype", "float32"))
    out = torch.empty(shape, dtype=dtype, device=ctx.device)
    return out.uniform_(attrs.get("min", -1.0), attrs.get("max", 1.0),
                        generator=ctx.rng(salt=attrs.get("seed", 0)))


@op("gaussian_random", no_grad=True)
def _gaussian_random(ctx, ins, attrs, o):
    shape = tuple(int(s) for s in attrs["shape"])
    dtype = torch_dtype(attrs.get("dtype", "float32"))
    out = torch.empty(shape, dtype=dtype, device=ctx.device)
    return out.normal_(attrs.get("mean", 0.0), attrs.get("std", 1.0),
                       generator=ctx.rng(salt=attrs.get("seed", 0)))


@op("uniform_random_batch_size_like", no_grad=True)
def _uniform_random_bsl(ctx, ins, attrs, o):
    shape, device = _batch_size_like_shape(ins, attrs)
    out = torch.empty(shape, dtype=torch_dtype(attrs.get("dtype", "float32")),
                      device=device)
    return out.uniform_(attrs.get("min", -1.0), attrs.get("max", 1.0),
                        generator=ctx.rng(salt=attrs.get("seed", 0)))


@op("truncated_gaussian_random", no_grad=True)
def _truncated_gaussian_random(ctx, ins, attrs, o):
    """mean + std * a standard normal truncated to [-2, 2], drawn as
    ``jax.random.truncated_normal`` draws it: a uniform between the two
    bounds' CDFs through the inverse CDF."""
    shape = tuple(int(s) for s in attrs["shape"])
    dtype = torch_dtype(attrs.get("dtype", "float32"))
    lo, hi = (0.5 * math.erfc(2.0 / math.sqrt(2.0)),
              0.5 * math.erfc(-2.0 / math.sqrt(2.0)))
    u = torch.empty(shape, dtype=dtype, device=ctx.device).uniform_(
        lo, hi, generator=ctx.rng(salt=attrs.get("seed", 0)))
    z = torch.clamp(math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0), -2.0, 2.0)
    return attrs.get("mean", 0.0) + attrs.get("std", 1.0) * z


@op("randint", no_grad=True)
def _randint(ctx, ins, attrs, o):
    return torch.randint(attrs.get("low", 0), attrs.get("high", 100),
                         tuple(int(s) for s in attrs["shape"]),
                         generator=ctx.rng(salt=attrs.get("seed", 0)),
                         dtype=torch.int32, device=ctx.device)


@op("shuffle_batch", no_grad=True)
def _shuffle_batch(ctx, ins, attrs, o):
    """A permutation of the rows: the stable order of uniform keys drawn
    on the device (``torch.randperm`` is not captured by a graph)."""
    x = _x(ins)
    keys = torch.rand(x.shape[0], generator=ctx.rng(), device=x.device)
    perm = torch.argsort(keys, stable=True)
    return {"Out": x[perm], "ShuffleIdx": perm.to(torch.int32)}


@op("sampling_id", no_grad=True)
def _sampling_id(ctx, ins, attrs, o):
    """One id a row of X [B, V] drawn with X's probabilities, by the
    Gumbel-max form ``jax.random.categorical`` uses: the argmax of
    log(max(x, 1e-20)) plus Gumbel noise."""
    x = _x(ins)
    u = torch.empty_like(x).uniform_(
        torch.finfo(x.dtype).tiny, 1.0,
        generator=ctx.rng(salt=attrs.get("seed", 0)))
    logits = torch.log(torch.clamp(x, min=1e-20)) - torch.log(-torch.log(u))
    return torch.argmax(logits, dim=-1).to(torch.int32)


@op("random_crop", no_grad=True)
def _random_crop(ctx, ins, attrs, o):
    """A window of ``shape`` over X's trailing dims at a random start
    drawn for each dim on the device (whole leading dims), gathered by
    index so no start comes to the host."""
    x = _x(ins)
    shape = [int(s) for s in attrs["shape"]]
    lead = x.dim() - len(shape)
    gen = ctx.rng(salt=attrs.get("seed", 0))
    for i, s in enumerate(shape):
        d = lead + i
        start = torch.randint(0, max(x.shape[d] - s, 0) + 1, (1,),
                              generator=gen, device=x.device)
        x = x.index_select(d, start + torch.arange(s, device=x.device))
    return x


@op("position_ids", no_grad=True)
def _position_ids(ctx, ins, attrs, o):
    """Positions 0..s-1 of each row. In the global view over a sequence
    axis a rank holds a time chunk of its rows: its positions count from
    the chunk's start (the global form, as ``mean``'s)."""
    x = _x(ins)
    b, s = x.shape[0], x.shape[1]
    start = 0
    comm = ctx.comm if ctx is not None else None
    if comm is not None and getattr(comm, "seq_axis", None) is not None \
            and comm.reads_local(o):
        start = comm.mesh.axis_rank(comm.seq_axis) * s
    # int32 as the JAX package records it (torch.arange defaults to int64)
    return {"Out": torch.arange(start, start + s, dtype=torch.int32,
                                device=x.device).expand(b, s)}


# ---- the vision ops: resizing, grid sampling, ROI pooling ----

@op("resize_nearest")
def _resize_nearest(ctx, ins, attrs, o):
    """Output cell i reads input cell floor(i * H / out_h), as the JAX
    package indexes (not ``F.interpolate``'s scale rule)."""
    x = _x(ins)  # NCHW
    oh, ow = attrs["out_h"], attrs["out_w"]
    h, w = x.shape[2], x.shape[3]
    ridx = torch.div(torch.arange(oh, device=x.device) * h, oh,
                     rounding_mode="floor")
    cidx = torch.div(torch.arange(ow, device=x.device) * w, ow,
                     rounding_mode="floor")
    return x[:, :, ridx][:, :, :, cidx]


def _resize_weights(n_in, n_out, device):
    """``jax.image.resize``'s linear weights [n_in, n_out]: half-pixel
    centres, the triangle kernel widened by in/out when shrinking (it
    antialiases), each column normalised to sum 1, and a column whose
    sample lies outside the input zero. float32 throughout, as the JAX
    package computes it with 64-bit types off."""
    inv_scale = float(np.float32(1.0 / (n_out / n_in)))
    kscale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device)
              + 0.5) * inv_scale - 0.5
    dist = torch.abs(sample[None, :] - torch.arange(
        n_in, dtype=torch.float32, device=device)[:, None]) / kscale
    wts = torch.clamp_min(1.0 - torch.abs(dist), 0.0)
    total = torch.sum(wts, dim=0, keepdim=True)
    wts = torch.where(torch.abs(total) > 1000.0 * float(np.finfo(
        np.float32).eps), wts / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], wts, 0.0)


@op("resize_bilinear")
def _resize_bilinear(ctx, ins, attrs, o):
    """``jax.image.resize(x, ..., "bilinear")``: a dim whose size stays is
    left alone; the others are contracted with :func:`_resize_weights`
    (half-pixel centres, antialiased when shrinking). Not
    ``F.interpolate``'s bilinear, which neither antialiases nor
    renormalises at the edges."""
    x = _x(ins)  # NCHW
    oh, ow = attrs["out_h"], attrs["out_w"]
    h, w = x.shape[2], x.shape[3]
    if h != oh:
        x = torch.einsum("nchw,ho->ncow", x,
                         _resize_weights(h, oh, x.device).to(x.dtype))
    if w != ow:
        x = torch.einsum("nchw,wp->nchp", x,
                         _resize_weights(w, ow, x.device).to(x.dtype))
    return x


@op("grid_sampler")
def _grid_sampler(ctx, ins, attrs, o):
    """Bilinear sampling of X [N, C, H, W] at Grid [N, OH, OW, 2] (x, y in
    [-1, 1], corners aligned), as the JAX package samples: the four
    neighbours clamped into the image and the weights taken from the
    clamped lower neighbour, differentiable in X and Grid."""
    x, grid = _x(ins), ins["Grid"][0]
    n, c, h, w = x.shape
    gx = (grid[..., 0] + 1) * (w - 1) / 2
    gy = (grid[..., 1] + 1) * (h - 1) / 2
    x0 = torch.clamp(torch.floor(gx).to(torch.int64), 0, w - 1)
    y0 = torch.clamp(torch.floor(gy).to(torch.int64), 0, h - 1)
    x1, y1 = torch.clamp(x0 + 1, 0, w - 1), torch.clamp(y0 + 1, 0, h - 1)
    wx = gx - x0.to(gx.dtype)
    wy = gy - y0.to(gy.dtype)
    xl = x.permute(0, 2, 3, 1)
    bidx = torch.arange(n, device=x.device)[:, None, None]

    def g(yy, xx):
        return xl[bidx, yy, xx]  # [N, OH, OW, C]
    out = (g(y0, x0) * ((1 - wx) * (1 - wy))[..., None] +
           g(y0, x1) * (wx * (1 - wy))[..., None] +
           g(y1, x0) * ((1 - wx) * wy)[..., None] +
           g(y1, x1) * (wx * wy)[..., None])
    return {"Output": out.permute(0, 3, 1, 2)}


def _linspace01(n):
    """``jnp.linspace(0, 1, n + 1)`` as Python floats: XLA multiplies by
    the float32 reciprocal of n, which ``torch.linspace`` does not."""
    r = np.float32(1) / np.float32(n)
    return [float(np.float32(i) * r) for i in range(n)] + [1.0]


@op("roi_pool", nondiff_inputs=("ROIs",))
def _roi_pool(ctx, ins, attrs, o):
    """ROI max pooling (reference `roi_pool_op`), as the JAX package pools:
    ROIs [R, 5] (batch index, x1, y1, x2, y2) or [R, 4] (image 0), end
    coordinates inclusive (the exclusive bound is round(x2 * scale) + 1),
    each bin at least one cell. The maximum is ``amax`` over the masked
    image, whose gradient splits among equal values as ``jnp.max``'s
    does; the ROIs pass no gradient."""
    x = _x(ins)  # NCHW
    rois = ins["ROIs"][0]
    ph, pw = attrs.get("pooled_height", 1), attrs.get("pooled_width", 1)
    scale = attrs.get("spatial_scale", 1.0)
    if rois.shape[-1] == 5:
        bidx = rois[:, 0].to(torch.int64)
        boxes = rois[:, 1:]
    else:
        bidx = torch.zeros(rois.shape[0], dtype=torch.int64,
                           device=rois.device)
        boxes = rois
    c, h, w = x.shape[1], x.shape[2], x.shape[3]
    i32 = torch.int32

    def corner(j):
        return torch.round(boxes[:, j] * scale).to(i32)
    x1, y1 = corner(0), corner(1)
    x2 = torch.maximum(corner(2) + 1, x1 + 1)
    y2 = torch.maximum(corner(3) + 1, y1 + 1)
    img = x[bidx]  # [R, C, H, W]
    lowest = torch.finfo(x.dtype).min
    yy = torch.arange(h, device=x.device)[None, :]
    xx = torch.arange(w, device=x.device)[None, :]

    def span(lo, hi, fr, grid, a, b):
        s0 = lo + ((hi - lo) * fr[a]).to(i32)
        s1 = lo + torch.ceil((hi - lo) * fr[b]).to(i32)
        return (grid >= s0[:, None]) & (grid < torch.maximum(
            s1, s0 + 1)[:, None])
    ys, xs = _linspace01(ph), _linspace01(pw)
    rows = []
    for i in range(ph):
        my = span(y1, y2, ys, yy, i, i + 1)              # [R, H]
        cols = []
        for j in range(pw):
            mx = span(x1, x2, xs, xx, j, j + 1)          # [R, W]
            m2 = (my[:, :, None] & mx[:, None, :])[:, None]
            cols.append(torch.amax(torch.where(m2, img, lowest),
                                   dim=(2, 3)))
        rows.append(torch.stack(cols, -1))
    return {"Out": torch.stack(rows, -2), "Argmax": None}
