"""Elementwise, activation, reduction and linear-algebra op lowerings.

Capability parity: reference `paddle/fluid/operators/` elementwise group
(`elementwise_op_function.h` broadcasting), `activation_op.*`,
`scale_op`, `reduce_op.*`, `mean_op`, `sum_op`, the norms,
`cumsum_op`, `label_smooth_op`, `mul_op`/`matmul_op`, `dot`, `cos_sim`,
`bilinear_tensor_product`, `iou_similarity` and `lookup_table_op` (with
its row-sparse gradient), as the JAX package's ``ops/math_ops.py``
lowers them, with its gradient flags: every op of that module. A plain
product stays ``torch.matmul`` (``torch.einsum`` for the bilinear
form), as the JAX package left it to XLA.
"""

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core import registry
from paddle_tpu_torch.core.lower import PackedSeq, RowSparse, wrap_ids
from paddle_tpu_torch.core.registry import op


def _x(ins, slot="X"):
    return ins[slot][0]


# ---- paddle-style broadcasting: Y aligned to X starting at `axis` ----

def _bcast_y(x, y, axis):
    if tuple(x.shape) == tuple(y.shape):
        return y
    if axis is None or axis == -1:
        axis = x.dim() - y.dim()
    yshape = list(y.shape)
    # trailing dims of size 1 in Y are trimmed (paddle semantics) when they
    # don't line up against X at the given axis
    while len(yshape) > 1 and yshape[-1] == 1 and \
            (axis + len(yshape) > x.dim() or
             tuple(x.shape[axis:axis + len(yshape)]) != tuple(yshape)):
        yshape = yshape[:-1]
    new_shape = [1] * axis + yshape + [1] * (x.dim() - axis - len(yshape))
    if len(new_shape) != x.dim():
        return y  # fall back to numpy broadcasting
    return y.reshape(new_shape)


def _elementwise(name, fn):
    @op("elementwise_" + name, seq_map=True)
    def _ew(ctx, ins, attrs, o):
        x, y = _x(ins), _x(ins, "Y")
        return fn(x, _bcast_y(x, y, attrs.get("axis", -1)))
    return _ew


_elementwise("add", torch.add)
_elementwise("sub", torch.sub)
_elementwise("mul", torch.mul)
_elementwise("div", torch.div)
_elementwise("max", torch.maximum)
_elementwise("min", torch.minimum)
_elementwise("pow", torch.pow)
# jnp.mod takes the divisor's sign (Python's rule): torch.remainder, not
# torch.fmod. floor_divide rounds toward minus infinity in both; it is
# piecewise constant, so its gradient is zero, as jnp.floor_divide's
# (torch has no derivative for it: it is taken off the graph)
_elementwise("mod", torch.remainder)
_elementwise("floordiv",
             lambda x, y: torch.floor_divide(x.detach(), y.detach()))


# ---- activations (activation_op.cc catalogue) ----

# The JAX package's table, op for op. ``round`` rounds half to even as
# ``jnp.round`` does (so does ``torch.round``); ``gelu`` is the exact
# erf form (reference gelu_op defaults to non-approximate); ``softplus``
# is ``logaddexp(x, 0)`` as ``jax.nn.softplus``.
_ACTIVATIONS = {
    "sigmoid": torch.sigmoid,
    "logsigmoid": F.logsigmoid,
    "exp": torch.exp,
    "relu": torch.relu,
    "tanh": torch.tanh,
    "tanh_shrink": lambda x: x - torch.tanh(x),
    "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt,
    "abs": torch.abs,
    "ceil": torch.ceil,
    "floor": torch.floor,
    "round": torch.round,
    "cos": torch.cos,
    "sin": torch.sin,
    "reciprocal": lambda x: 1.0 / x,
    "log": torch.log,
    "square": torch.square,
    "softplus": lambda x: torch.logaddexp(x, torch.zeros_like(x)),
    "softsign": F.softsign,
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "silu": F.silu,
    "sign": torch.sign,
    "erf": torch.erf,
}

for _name, _fn in _ACTIVATIONS.items():
    op(_name, seq_map=True)(lambda ctx, ins, attrs, o, fn=_fn: fn(_x(ins)))


@op("leaky_relu", seq_map=True)
def _leaky_relu(ctx, ins, attrs, o):
    # jax.nn.leaky_relu: the slope-1 side includes 0 (its gradient too)
    x = _x(ins)
    return torch.where(x >= 0, x, attrs.get("alpha", 0.02) * x)


@op("elu", seq_map=True)
def _elu(ctx, ins, attrs, o):
    # jax.nn.elu: expm1 of the non-positive side only
    x = _x(ins)
    pos = x > 0
    return torch.where(pos, x, attrs.get("alpha", 1.0) * torch.expm1(
        torch.where(pos, torch.zeros_like(x), x)))


@op("relu6")
def _relu6(ctx, ins, attrs, o):
    return torch.clamp(_x(ins), 0.0, attrs.get("threshold", 6.0))


@op("pow")
def _pow(ctx, ins, attrs, o):
    return torch.pow(_x(ins), attrs.get("factor", 1.0))


@op("hard_sigmoid")
def _hard_sigmoid(ctx, ins, attrs, o):
    slope = attrs.get("slope", 0.2)
    offset = attrs.get("offset", 0.5)
    return torch.clamp(_x(ins) * slope + offset, 0.0, 1.0)


@op("soft_relu")
def _soft_relu(ctx, ins, attrs, o):
    t = attrs.get("threshold", 40.0)
    return torch.log1p(torch.exp(torch.clamp(_x(ins), -t, t)))


@op("swish")
def _swish(ctx, ins, attrs, o):
    return _x(ins) * torch.sigmoid(attrs.get("beta", 1.0) * _x(ins))


@op("brelu")
def _brelu(ctx, ins, attrs, o):
    return torch.clamp(_x(ins), attrs.get("t_min", 0.0),
                       attrs.get("t_max", 24.0))


@op("prelu")
def _prelu(ctx, ins, attrs, o):
    x, alpha = _x(ins), _x(ins, "Alpha")
    mode = attrs.get("mode", "all")
    if mode == "all":
        a = alpha.reshape(())
    elif mode == "channel":
        a = alpha.reshape((1, -1) + (1,) * (x.dim() - 2))
    else:
        a = alpha.reshape((1,) + tuple(x.shape[1:]))
    return torch.where(x > 0, x, a * x)


@op("maxout")
def _maxout(ctx, ins, attrs, o):
    x = _x(ins)  # NCHW
    g = attrs["groups"]
    n, c, h, w = x.shape
    # amax spreads a tie's gradient evenly, as jnp.max's does
    return torch.amax(x.reshape(n, c // g, g, h, w), dim=2)


@op("hard_shrink")
def _hard_shrink(ctx, ins, attrs, o):
    t = attrs.get("threshold", 0.5)
    x = _x(ins)
    return torch.where(torch.abs(x) > t, x, 0.0)


@op("soft_shrink")
def _soft_shrink(ctx, ins, attrs, o):
    lam = attrs.get("lambda", 0.5)
    x = _x(ins)
    return torch.sign(x) * torch.clamp(torch.abs(x) - lam, min=0.0)


@op("thresholded_relu")
def _thresholded_relu(ctx, ins, attrs, o):
    t = attrs.get("threshold", 1.0)
    x = _x(ins)
    return torch.where(x > t, x, 0.0)


@op("stanh")
def _stanh(ctx, ins, attrs, o):
    a = attrs.get("scale_a", 2.0 / 3.0)
    b = attrs.get("scale_b", 1.7159)
    return b * torch.tanh(a * _x(ins))


# ---- scale / clip / misc unary with attrs ----

@op("scale")
def _scale(ctx, ins, attrs, o):
    s = attrs.get("scale", 1.0)
    b = attrs.get("bias", 0.0)
    if attrs.get("bias_after_scale", True):
        return _x(ins) * s + b
    return (_x(ins) + b) * s


@op("clip")
def _clip(ctx, ins, attrs, o):
    return torch.clamp(_x(ins), attrs["min"], attrs["max"])


@op("clip_by_norm")
def _clip_by_norm(ctx, ins, attrs, o):
    x = _x(ins)
    max_norm = attrs["max_norm"]
    norm = torch.sqrt(torch.sum(torch.square(x)))
    return torch.where(norm > max_norm,
                       x * (max_norm / torch.clamp(norm, min=1e-12)), x)


@op("global_norm_clip", no_grad=True)
def _global_norm_clip(ctx, ins, attrs, o):
    """GradientClipByGlobalNorm as ONE fused op over every grad in the
    group: factor = clip_norm / max(global_norm, clip_norm), one
    sum-of-squares reduction instead of the reference's per-grad
    squared_l2_norm + sum + sqrt op chain (`python/paddle/fluid/
    clip.py:137`). The reduction runs in float32 whatever the
    gradients' dtype; a row-sparse gradient contributes its values
    (duplicate rows unmerged, as in the JAX package) and is scaled
    row by row. Under the training-health guard the reduction is
    shared: the guard's health norm reuses it (``guard.py``)."""
    gs = ins["X"]

    def sq(g):
        v = g.values if isinstance(g, RowSparse) else g
        return torch.sum(torch.square(v.to(torch.float32)))

    comm = ctx.comm
    if comm is not None and comm.plan.axis_params:
        # parameters held 1/n a rank (the stage and expert axes): each
        # one's part of the norm is summed over its line
        gnorm_sq = comm.line_sq(list(zip(attrs.get("param_names", ()),
                                         gs)))
    else:
        gnorm_sq = sum(sq(g) for g in gs)
    clip_norm = float(attrs["clip_norm"])
    factor = clip_norm / torch.clamp(torch.sqrt(gnorm_sq), min=clip_norm)

    def scale(g):
        if isinstance(g, RowSparse):
            return RowSparse(g.rows, g.values * factor.to(g.values.dtype),
                             g.height)
        return g * factor.to(g.dtype)

    if ctx.guard is not None:
        ctx.guard.note_clip_norm(gnorm_sq, attrs.get("param_names", ()))
    return {"Out": [scale(g) for g in gs]}


@op("label_smooth")
def _label_smooth(ctx, ins, attrs, o):
    x = _x(ins)
    eps = attrs.get("epsilon", 0.0)
    if ins.get("PriorDist") and ins["PriorDist"][0] is not None:
        return (1 - eps) * x + eps * ins["PriorDist"][0]
    return (1 - eps) * x + eps / x.shape[-1]


@op("cumsum")
def _cumsum(ctx, ins, attrs, o):
    """``exclusive`` subtracts x from the inclusive sum, as the JAX
    package does (not a shifted sum: the last bits follow its form)."""
    x = _x(ins)
    axis = attrs.get("axis", -1)
    if attrs.get("reverse"):
        r = torch.flip(torch.cumsum(torch.flip(x, (axis,)), axis,
                                    dtype=x.dtype), (axis,))
    else:
        r = torch.cumsum(x, axis, dtype=x.dtype)
    if attrs.get("exclusive"):
        r = r - x
    return r


def pairwise_iou(x, y):
    """[N,4] x [M,4] xyxy boxes -> [N,M] IoU."""
    def area(b):
        return torch.clamp(b[..., 2] - b[..., 0], min=0) * \
            torch.clamp(b[..., 3] - b[..., 1], min=0)
    xi = torch.maximum(x[:, None, 0], y[None, :, 0])
    yi = torch.maximum(x[:, None, 1], y[None, :, 1])
    xa = torch.minimum(x[:, None, 2], y[None, :, 2])
    ya = torch.minimum(x[:, None, 3], y[None, :, 3])
    inter = torch.clamp(xa - xi, min=0) * torch.clamp(ya - yi, min=0)
    union = area(x)[:, None] + area(y)[None, :] - inter
    return inter / torch.clamp(union, min=1e-10)


@op("iou_similarity")
def _iou_similarity(ctx, ins, attrs, o):
    return pairwise_iou(_x(ins), _x(ins, "Y"))


# ---- reductions ----

def _reduce_dims(x, attrs):
    """The dims a reduce op folds: all of them under ``reduce_all``."""
    if attrs.get("reduce_all", False):
        return tuple(range(x.dim()))
    dim = attrs.get("dim", [0])
    return tuple(dim) if isinstance(dim, (list, tuple)) else (dim,)


def _prod_over(x, dims, keepdim):
    # torch.prod folds one dim a call: fold the highest first, so the
    # lower dims keep their places
    for d in sorted({d % x.dim() for d in dims} if x.dim() else (),
                    reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


_REDUCERS = {
    "sum": lambda x, d, k: torch.sum(x, dim=d, keepdim=k),
    "mean": lambda x, d, k: torch.mean(x, dim=d, keepdim=k),
    # amax/amin split a tie's gradient evenly, as jnp.max/min's do
    "max": lambda x, d, k: torch.amax(x, dim=d, keepdim=k),
    "min": lambda x, d, k: torch.amin(x, dim=d, keepdim=k),
    "prod": _prod_over,
}

for _name, _fn in _REDUCERS.items():
    op("reduce_" + _name)(
        lambda ctx, ins, attrs, o, fn=_fn: fn(
            _x(ins), _reduce_dims(_x(ins), attrs),
            attrs.get("keep_dim", False)))


@op("mean")
def _mean(ctx, ins, attrs, o):
    """Reference mean_op. Over a PackedSeq the reference's LoD buffer
    holds only real tokens, so the packed mean masks padding out.

    Under the data-parallel comm layer's local view (``ctx.comm`` set,
    input holding this rank's rows) this is the GLOBAL batch's mean:
    the ranks' equal shares make it the mean of the ranks' means, summed
    over the ranks in rank order and divided by the world (at one rank
    exactly ``torch.mean``); a PackedSeq divides the ranks' summed
    numerators by their summed token counts (``tests/test_comm.py``'s
    global token count). The value is that, and its gradient is the
    local term's (``mean / world``, ``num / global count``), so every
    per-row cotangent carries the global divisor. The generic grad
    recomputes the forward for its gradient only: there the cross-rank
    sums are not issued again, and a PackedSeq's global count comes from
    the forward's (``comm.memo``)."""
    x = _x(ins)
    comm = ctx.comm if ctx.comm is not None and ctx.comm.reads_local(o) \
        else None
    if comm is not None:
        comm.mark_global(o)
    grad_only = comm is not None and torch.is_grad_enabled()
    if isinstance(x, PackedSeq):
        mask = x.mask(x.data.dtype)
        mask = mask.reshape(tuple(mask.shape) + (1,) * (x.data.dim() - 2))
        num = torch.sum(x.data * mask)
        denom = torch.sum(mask) * _prod(x.data.shape[2:])
        if comm is None:
            return num / denom
        if grad_only:
            return num / comm.memo[(o.uid, "denom")]
        both = comm.sum_ranks(torch.stack([num, denom.to(num.dtype)]),
                              "mean")
        comm.memo[(o.uid, "denom")] = both[1]
        return both[0] / both[1]
    if comm is None:
        return torch.mean(x)
    m = torch.mean(x)
    if grad_only:
        return m / comm.world
    return comm.sum_ranks(m.reshape(1), "mean").reshape(()) / comm.world


@op("sum", seq_map=True)
def _sum(ctx, ins, attrs, o):
    """Reference sum_op. Over row-sparse inputs only, the sum is their
    concatenation (duplicate rows accumulate where the rows are applied,
    `selected_rows_functor.cc`): the backward emits it when one table is
    looked up several times. Mixed inputs are densified first."""
    xs = ins["X"]
    if any(isinstance(x, RowSparse) for x in xs):
        if all(isinstance(x, RowSparse) for x in xs):
            return RowSparse(torch.cat([x.rows for x in xs]),
                             torch.cat([x.values for x in xs]),
                             xs[0].height)
        xs = [x.to_dense() if isinstance(x, RowSparse) else x for x in xs]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


@op("l1_norm")
def _l1_norm(ctx, ins, attrs, o):
    return torch.sum(torch.abs(_x(ins)))


@op("squared_l2_norm")
def _squared_l2_norm(ctx, ins, attrs, o):
    return torch.sum(torch.square(_x(ins)))


@op("squared_l2_distance")
def _squared_l2_distance(ctx, ins, attrs, o):
    d = _x(ins) - _x(ins, "Y")
    return {"Out": torch.sum(torch.square(d), dim=tuple(range(1, d.dim())),
                             keepdim=True),
            "sub_result": d}


@op("frobenius_norm")
def _frobenius_norm(ctx, ins, attrs, o):
    x = _x(ins)
    if attrs.get("reduce_all", False) or "dim" not in attrs:
        return torch.sqrt(torch.sum(torch.square(x)))
    return torch.sqrt(torch.sum(torch.square(x), dim=tuple(attrs["dim"]),
                                keepdim=attrs.get("keep_dim", False)))


@op("norm")
def _norm(ctx, ins, attrs, o):
    x = _x(ins)
    n = torch.sqrt(torch.sum(torch.square(x), dim=attrs.get("axis", 1),
                             keepdim=True) + attrs.get("epsilon", 1e-10))
    return {"Out": x / n, "Norm": n}


# ---- comparisons and logicals (no grad) ----

def _cmp(name, fn):
    @op(name, no_grad=True)
    def _c(ctx, ins, attrs, o, fn=fn):
        return fn(_x(ins), _x(ins, "Y"))
    return _c


_cmp("less_than", torch.lt)
_cmp("less_equal", torch.le)
_cmp("greater_than", torch.gt)
_cmp("greater_equal", torch.ge)
_cmp("equal", torch.eq)
_cmp("not_equal", torch.ne)
_cmp("logical_and", torch.logical_and)
_cmp("logical_or", torch.logical_or)
_cmp("logical_xor", torch.logical_xor)


@op("logical_not", no_grad=True)
def _logical_not(ctx, ins, attrs, o):
    return torch.logical_not(_x(ins))


@op("isfinite", no_grad=True)
def _isfinite(ctx, ins, attrs, o):
    return torch.all(torch.isfinite(_x(ins)))


# ---- linear algebra ----

def _prod(t):
    r = 1
    for v in t:
        r *= int(v)
    return r


@op("mul")
def _mul(ctx, ins, attrs, o):
    """Reference mul_op: flatten X to 2D at x_num_col_dims, Y at
    y_num_col_dims, then gemm (`operators/mul_op.cc`). A PackedSeq X
    counts its LoD row dim ([batch, time] here) as ONE reference dim,
    so the split point shifts by one and the result keeps the lengths
    (fc applied per token to a variable-length batch)."""
    x, y = _x(ins), _x(ins, "Y")
    xd = attrs.get("x_num_col_dims", 1)
    yd = attrs.get("y_num_col_dims", 1)
    lengths = None
    if isinstance(x, PackedSeq):
        lengths, x = x.lengths, x.data
        # x_num_col_dims == 1 is the LoD meaning "rows = tokens", which
        # span padded dims (0, 1); values >= 2 address the padded buffer
        if xd == 1:
            xd = 2
    if isinstance(y, PackedSeq):
        y = y.data
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape(_prod(xs[:xd]), _prod(xs[xd:]))
    y2 = y.reshape(_prod(ys[:yd]), _prod(ys[yd:]))
    out = torch.matmul(x2, y2).reshape(xs[:xd] + ys[yd:])
    return PackedSeq(out, lengths) if lengths is not None else out


@op("matmul")
def _matmul(ctx, ins, attrs, o):
    """Reference matmul_op: ``transpose_X``/``transpose_Y`` swap the last
    two dims of an operand of two or more (a 1-D operand stays as it
    is), then ``torch.matmul``'s batch broadcasting, scaled by
    ``alpha``."""
    x, y = _x(ins), _x(ins, "Y")
    if attrs.get("transpose_X", False) and x.dim() > 1:
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False) and y.dim() > 1:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    alpha = attrs.get("alpha", 1.0)
    return out * alpha if alpha != 1.0 else out


@op("bilinear_tensor_product")
def _bilinear_tensor_product(ctx, ins, attrs, o):
    x, y, w = _x(ins), _x(ins, "Y"), _x(ins, "Weight")
    out = torch.einsum("bi,oij,bj->bo", x, w, y)     # w: [out, xdim, ydim]
    if ins.get("Bias") and ins["Bias"][0] is not None:
        out = out + ins["Bias"][0].reshape(1, -1)
    return out


@op("cos_sim")
def _cos_sim(ctx, ins, attrs, o):
    x, y = _x(ins), _x(ins, "Y")
    xn = torch.sqrt(torch.sum(torch.square(x), -1, keepdim=True))
    yn = torch.sqrt(torch.sum(torch.square(y), -1, keepdim=True))
    out = torch.sum(x * y, -1, keepdim=True) / torch.clamp(xn * yn,
                                                           min=1e-12)
    return {"Out": out, "XNorm": xn, "YNorm": yn}


@op("dot")
def _dot(ctx, ins, attrs, o):
    return torch.sum(_x(ins) * _x(ins, "Y"), dim=-1, keepdim=True)


@op("lookup_table", nondiff_inputs=("Ids",))
def _lookup_table(ctx, ins, attrs, o):
    w, ids = _x(ins, "W"), _x(ins, "Ids")

    def lookup(ids):
        ids = ids.to(torch.int64)
        # the reference's [.., 1] id convention: a trailing id dim of 1 goes
        if ids.dim() > 1 and ids.shape[-1] == 1:
            ids = ids.squeeze(-1)
        # jnp.take: a negative id wraps once, an id out of range reads a
        # row of NaN (and passes no gradient), where F.embedding would
        # raise on the CPU and fault on the card
        idx, ok = wrap_ids(ids, w.shape[0])
        out = torch.where(ok[..., None], F.embedding(idx, w), float("nan"))
        pad = attrs.get("padding_idx", -1)
        if pad is not None and pad >= 0:
            out = torch.where((ids == pad)[..., None], 0.0, out)
        return out

    if isinstance(ids, PackedSeq):  # sequence ids -> sequence of embeddings
        return PackedSeq(lookup(ids.data), ids.lengths)
    return lookup(ids)


def _lookup_table_grad(ctx, ins, out_grads, attrs, o):
    """``is_sparse``: a ``RowSparse`` gradient (rows = the looked-up ids,
    values = the output cotangents) instead of a scatter-add into a
    dense [V, D] zeros, the sparse-update path of the reference
    (`selected_rows_functor.cc`, `distribute_transpiler.py:531`). A
    PackedSeq's padded steps and the rows of ``padding_idx`` contribute
    zeros.

    Dense: what the generic grad gives (autograd through the lowering,
    as in the JAX package), formed without recomputing the lookup: the
    cotangent, zero where the id is out of range or ``padding_idx``,
    scattered to the rows by ``embedding_dense_backward``, the kernel
    autograd calls for ``F.embedding``. Under AMP the generic grad
    runs (its casts)."""
    w, ids = ins["W"][0], ins["Ids"][0]
    dy = out_grads.get("Out", [None])[0]
    if not attrs.get("is_sparse", False) and (dy is None or
                                              ctx.amp_dtype is not None):
        spec = registry.REGISTRY["lookup_table"]
        return registry.generic_grad(ctx, spec, o, ins, out_grads)
    if dy is None:
        return {}
    ids_arr = ids.data if isinstance(ids, PackedSeq) else ids
    dy_arr = dy.data if isinstance(dy, PackedSeq) else dy
    pad = attrs.get("padding_idx", -1)
    if not attrs.get("is_sparse", False):
        ids64 = ids_arr.to(torch.int64)
        if ids64.dim() > 1 and ids64.shape[-1] == 1:
            ids64 = ids64.squeeze(-1)
        idx, keep = wrap_ids(ids64, w.shape[0])
        if pad is not None and pad >= 0:
            keep = keep & (ids64 != pad)
        g = torch.where(keep[..., None], dy_arr.to(w.dtype).reshape(
            tuple(idx.shape) + (w.shape[1],)), 0.0)
        return {"W": [torch.ops.aten.embedding_dense_backward(
            g, idx, w.shape[0], -1, False)], "Ids": [None]}
    ids_flat = ids_arr.to(torch.int32).reshape(-1)
    vals = dy_arr.reshape(ids_flat.shape[0], -1)
    if isinstance(ids, PackedSeq):
        vals = vals * ids.mask(vals.dtype).reshape(-1, 1)
    if pad is not None and pad >= 0:
        vals = torch.where((ids_flat == pad)[:, None], 0.0, vals)
    return {"W": [RowSparse(ids_flat, vals, w.shape[0])], "Ids": [None]}


registry.REGISTRY["lookup_table"].grad_lower = _lookup_table_grad
