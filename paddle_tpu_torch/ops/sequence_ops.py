"""Sequence op lowerings over PackedSeq (the LoD tensor).

Capability parity: reference `operators/sequence_pool_op`,
`sequence_conv_op` (with `math/context_project`), `sequence_pad_op`,
`sequence_mask_op` and `math/sequence_pooling.*`,
which operate on LoDTensors, as the JAX
package's ``ops/sequence_ops.py`` lowers them: variable-length batches
are PackedSeq (padded dense [B, T, ...] + lengths [B]) and masking
replaces offset arithmetic. The module's other ops arrive with later
slices.
"""

import torch

from paddle_tpu_torch.core.infer import torch_dtype
from paddle_tpu_torch.core.lower import PackedSeq
from paddle_tpu_torch.core.registry import op


def _seq(ins, slot="X"):
    v = ins[slot][0]
    if not isinstance(v, PackedSeq):
        raise TypeError("op expects a PackedSeq input for slot %s, got %s"
                        % (slot, type(v)))
    return v


@op("sequence_pool")
def _sequence_pool(ctx, ins, attrs, o):
    s = _seq(ins)
    ptype = attrs.get("pooltype", "AVERAGE").upper()
    x = s.data
    m = s.mask(x.dtype)
    m = m.reshape(tuple(m.shape) + (1,) * (x.dim() - 2))
    lens = torch.clamp_min(s.lengths, 1).to(x.dtype)
    lens = lens.reshape((-1,) + (1,) * (x.dim() - 2))
    if ptype == "SUM":
        out = torch.sum(x * m, dim=1)
    elif ptype == "AVERAGE":
        out = torch.sum(x * m, dim=1) / lens
    elif ptype == "SQRT":
        out = torch.sum(x * m, dim=1) / torch.sqrt(lens)
    elif ptype == "MAX":
        # amax splits a tie's gradient evenly, as JAX's max does
        neg = torch.finfo(x.dtype).min
        out = torch.amax(torch.where(m > 0, x, neg), dim=1)
    elif ptype == "LAST":
        idx = torch.clamp_min(s.lengths - 1, 0).to(torch.int64)
        out = torch.take_along_dim(
            x, idx.reshape((-1, 1) + (1,) * (x.dim() - 2)), dim=1
        ).squeeze(1)
    elif ptype == "FIRST":
        out = x[:, 0]
    else:
        raise ValueError("unknown pooltype %r" % ptype)
    return {"Out": out, "MaxIndex": None}


@op("sequence_conv")
def _sequence_conv(ctx, ins, attrs, o):
    """Context-window projection and one GEMM over time (reference
    sequence_conv_op, math/context_project): step t sees rows t +
    contextStart .. t + contextStart + contextLength - 1 of its own
    sequence (zeros outside it), concatenated into [B, T, ctx * D] and
    multiplied by Filter [ctx * D, out]; steps past a row's length are
    zero."""
    s = _seq(ins)
    w = ins["Filter"][0]
    ctx_len = attrs.get("contextLength", 3)
    ctx_start = attrs.get("contextStart", -(ctx_len // 2))
    x = s.data                                    # [B, T, D]
    t = torch.arange(x.shape[1], device=x.device)[None, :]
    cols = []
    for j in range(ctx_len):
        shift = ctx_start + j
        valid = (t + shift >= 0) & (t + shift < s.lengths[:, None])
        cols.append(torch.where(valid[..., None],
                                torch.roll(x, -shift, dims=1), 0.0))
    out = torch.matmul(torch.cat(cols, dim=-1), w)
    return PackedSeq(out * s.mask(out.dtype)[..., None], s.lengths)


@op("sequence_pad")
def _sequence_pad(ctx, ins, attrs, o):
    """PackedSeq -> dense padded tensor + length vector (reference
    sequence_pad_op). ``pad_value`` overwrites the buffer's padded
    positions (the PackedSeq buffer zero-fills them)."""
    s = _seq(ins)
    data = s.data
    pad_value = attrs.get("pad_value", None)
    if pad_value is not None and pad_value != 0.0:
        m = s.mask(torch.bool)
        m = m.reshape(tuple(m.shape) + (1,) * (data.dim() - 2))
        data = torch.where(m, data, torch.full((), pad_value,
                                               dtype=data.dtype,
                                               device=data.device))
    return {"Out": data, "Length": s.lengths.to(torch.int64)}


@op("sequence_mask", no_grad=True)
def _sequence_mask(ctx, ins, attrs, o):
    """[B, maxlen] validity mask from a PackedSeq's lengths (maxlen = its
    padded length unless given) or from a lengths tensor (maxlen given)."""
    x = ins["X"][0]
    lens = (x.lengths if isinstance(x, PackedSeq) else x).to(torch.int32)
    maxlen = attrs.get("maxlen", -1)
    if maxlen < 0:
        if not isinstance(x, PackedSeq):
            raise ValueError("sequence_mask of a lengths tensor needs maxlen")
        maxlen = x.data.shape[1]
    t = torch.arange(maxlen, dtype=torch.int32, device=lens.device)
    return {"Y": (t[None, :] < lens.reshape(-1, 1)).to(
        torch_dtype(attrs.get("out_dtype", "int64")))}
