"""Tensor-manipulation op lowerings.

Capability parity: reference cast/reshape/transpose/squeeze/unsqueeze/
concat/top_k/assign/fill_constant/fill_constant_batch_size_like/
increment/where/uniform_random/gaussian_random
(`paddle/fluid/operators/`, §2.3
"Tensor manipulation"), as the JAX package's ``ops/tensor_ops.py``
lowers them, with its gradient flags. The module's other ops arrive
with later slices.
"""

import torch

from paddle_tpu_torch.core.infer import torch_dtype
from paddle_tpu_torch.core.lower import PackedSeq
from paddle_tpu_torch.core.registry import op


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
    return {"Out": x.reshape(shape), "XShape": None}


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


def concat_time_padded(datas, lengths_list):
    """LoD batch-concat: pad each ``[batch, time, ...]`` buffer to the
    common max time dim, then concatenate along batch. Returns
    ``(data, lengths)``."""
    maxt = max(d.shape[1] for d in datas)
    datas = [torch.nn.functional.pad(
        d, [0, 0] * (d.dim() - 2) + [0, maxt - d.shape[1]])
        if d.shape[1] < maxt else d for d in datas]
    return torch.cat(datas, dim=0), torch.cat(lengths_list)


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
    v, i = torch.topk(_x(ins), attrs.get("k", 1), dim=-1)
    return {"Out": v, "Indices": i}


@op("assign")
def _assign(ctx, ins, attrs, o):
    return _x(ins)


@op("fill_constant", no_grad=True)
def _fill_constant(ctx, ins, attrs, o):
    dtype = torch_dtype(attrs.get("dtype", "float32"))
    shape = tuple(int(s) for s in attrs.get("shape", []))
    return torch.full(shape, attrs.get("value", 0.0), dtype=dtype,
                      device=ctx.device)


@op("fill_constant_batch_size_like", no_grad=True)
def _fill_constant_bsl(ctx, ins, attrs, o):
    """A constant whose ``output_dim_idx`` dim is the ``input_dim_idx``
    dim of Input (a PackedSeq's padded buffer counts its batch there)."""
    ref = _x(ins, "Input")
    ref = ref.data if isinstance(ref, PackedSeq) else ref
    shape = list(attrs["shape"])
    shape[attrs.get("output_dim_idx", 0)] = \
        ref.shape[attrs.get("input_dim_idx", 0)]
    return torch.full(tuple(shape), attrs.get("value", 0.0),
                      dtype=torch_dtype(attrs.get("dtype", "float32")),
                      device=ref.device)


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


@op("position_ids", no_grad=True)
def _position_ids(ctx, ins, attrs, o):
    x = _x(ins)
    b, s = x.shape[0], x.shape[1]
    # int32 as the JAX package records it (torch.arange defaults to int64)
    return {"Out": torch.arange(s, dtype=torch.int32,
                                device=x.device).expand(b, s)}
