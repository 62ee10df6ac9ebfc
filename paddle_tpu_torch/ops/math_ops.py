"""Elementwise, activation, reduction and linear-algebra op lowerings.

Capability parity: reference `paddle/fluid/operators/` elementwise group
(`elementwise_op_function.h` broadcasting), `activation_op.*`,
`scale_op`, `reduce_sum_op`, `mean_op`, `sum_op`, `mul_op` and
`lookup_table_op`, as the JAX package's
``ops/math_ops.py`` lowers them, with its gradient flags. A plain
product stays ``torch.matmul``, as the JAX package left it to XLA. The
module's other ops arrive with later slices.
"""

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core import registry
from paddle_tpu_torch.core.lower import PackedSeq
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


@op("gelu", seq_map=True)
def _gelu(ctx, ins, attrs, o):
    # exact erf form (reference gelu_op defaults to non-approximate)
    return F.gelu(_x(ins), approximate="none")


@op("relu", seq_map=True)
def _relu(ctx, ins, attrs, o):
    return torch.relu(_x(ins))


@op("tanh", seq_map=True)
def _tanh(ctx, ins, attrs, o):
    return torch.tanh(_x(ins))


@op("scale")
def _scale(ctx, ins, attrs, o):
    s = attrs.get("scale", 1.0)
    b = attrs.get("bias", 0.0)
    if attrs.get("bias_after_scale", True):
        return _x(ins) * s + b
    return (_x(ins) + b) * s


# ---- reductions ----

@op("reduce_sum")
def _reduce_sum(ctx, ins, attrs, o):
    x = _x(ins)
    keep = attrs.get("keep_dim", False)
    if attrs.get("reduce_all", False):
        return torch.sum(x, dim=tuple(range(x.dim())), keepdim=keep)
    dim = attrs.get("dim", [0])
    dim = tuple(dim) if isinstance(dim, (list, tuple)) else (dim,)
    return torch.sum(x, dim=dim, keepdim=keep)


@op("mean")
def _mean(ctx, ins, attrs, o):
    """Reference mean_op. Over a PackedSeq the reference's LoD buffer
    holds only real tokens, so the packed mean masks padding out."""
    x = _x(ins)
    if isinstance(x, PackedSeq):
        mask = x.mask(x.data.dtype)
        mask = mask.reshape(tuple(mask.shape) + (1,) * (x.data.dim() - 2))
        num = torch.sum(x.data * mask)
        denom = torch.sum(mask) * _prod(x.data.shape[2:])
        return num / denom
    return torch.mean(x)


@op("sum", seq_map=True)
def _sum(ctx, ins, attrs, o):
    xs = ins["X"]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


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


@op("lookup_table", nondiff_inputs=("Ids",))
def _lookup_table(ctx, ins, attrs, o):
    w, ids = _x(ins, "W"), _x(ins, "Ids")

    def lookup(ids):
        ids = ids.to(torch.int64)
        # the reference's [.., 1] id convention: a trailing id dim of 1 goes
        if ids.dim() > 1 and ids.shape[-1] == 1:
            ids = ids.squeeze(-1)
        out = F.embedding(ids, w)
        pad = attrs.get("padding_idx", -1)
        if pad is not None and pad >= 0:
            out = torch.where((ids == pad)[..., None], 0.0, out)
        return out

    if isinstance(ids, PackedSeq):  # sequence ids -> sequence of embeddings
        return PackedSeq(lookup(ids.data), ids.lengths)
    return lookup(ids)


def _lookup_table_grad(ctx, ins, out_grads, attrs, o):
    """The dense gradient of the table (``is_sparse`` False) is the
    generic one: a [V, D] scatter-add, as in the JAX package. The
    row-sparse gradient of ``is_sparse`` arrives with a later slice."""
    if attrs.get("is_sparse", False):
        raise NotImplementedError(
            "lookup_table(is_sparse=True): row-sparse gradients arrive "
            "with a later slice")
    spec = registry.REGISTRY["lookup_table"]
    return registry.generic_grad(ctx, spec, o, ins, out_grads)


registry.REGISTRY["lookup_table"].grad_lower = _lookup_table_grad
