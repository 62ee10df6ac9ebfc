"""Sequence op lowerings over PackedSeq (the LoD tensor).

Capability parity: the reference's `operators/sequence_*` family (pool,
conv with `math/context_project`, pad and unpad, mask, softmax, expand
and expand_as, concat, reverse, erase, slice, reshape, scatter,
enumerate), `lod_reset_op` and `math/sequence_pooling.*`, which operate
on LoDTensors, as the JAX package's ``ops/sequence_ops.py`` lowers
them: variable-length batches are PackedSeq (padded dense [B, T, ...] +
lengths [B]) and masking replaces offset arithmetic.

Every lowering keeps its shapes static and reads no value on the host,
so a CUDA graph captures it. Lengths are int32, as the JAX package
carries them; a compaction (``sequence_erase``) sorts unique integer
keys, and ``sequence_scatter`` adds duplicate ids through
``core.lower.add_rows``, in the same order on every run.
"""

import torch

from paddle_tpu_torch.core.infer import torch_dtype
from paddle_tpu_torch.core.lower import PackedSeq, add_rows, wrap_ids
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


def _tail(t, ndim):
    """``t`` [B, T] reshaped to broadcast over a [B, T, ...] buffer of
    ``ndim`` dims."""
    return t.reshape(tuple(t.shape) + (1,) * (ndim - 2))


def compact_rows(x, keep):
    """Each row of ``x`` [B, T] with its ``keep`` steps moved to the
    front in order and zeros after them, and the kept counts [B] int32.
    The order is a sort of unique integer keys (dropped, position), the
    same on every device."""
    t = x.shape[1]
    pos = torch.arange(t, device=x.device)
    order = torch.argsort((~keep).to(torch.int64) * t + pos[None, :], dim=1)
    counts = torch.sum(keep, dim=1, dtype=torch.int32)
    out = torch.where(pos[None, :] < counts[:, None],
                      torch.take_along_dim(x, order, dim=1), 0)
    return out, counts


def _int_consts(values, device):
    """A 1-D int64 tensor of static ``values``, made by fills on
    ``device`` (a copy from the host would break a CUDA graph's
    capture)."""
    return torch.stack([torch.full((), int(v), dtype=torch.int64,
                                   device=device) for v in values])


@op("sequence_softmax")
def _sequence_softmax(ctx, ins, attrs, o):
    """Softmax over each sequence's valid steps: padding is masked to
    the dtype's lowest value and zeroed after, and the sum is floored at
    1e-12 so an empty row stays 0."""
    s = _seq(ins)
    x = s.data  # [B, T] or [B, T, 1]
    squeeze = x.dim() == 3 and x.shape[-1] == 1
    if squeeze:
        x = x.squeeze(-1)
    m = s.mask(x.dtype)
    x = torch.where(m > 0, x, torch.finfo(x.dtype).min)
    sm = torch.softmax(x, dim=1) * m
    sm = sm / torch.clamp_min(torch.sum(sm, 1, keepdim=True), 1e-12)
    if squeeze:
        sm = sm[..., None]
    return PackedSeq(sm, s.lengths)


@op("sequence_expand")
def _sequence_expand(ctx, ins, attrs, o):
    """Expand each batch row of dense X along a new time axis to Y's
    lengths (reference sequence_expand_op at ref_level 0, a row
    broadcast); a PackedSeq X is read under Y's lengths, masked to the
    steps valid in both, so no gradient reaches X's padding."""
    x = ins["X"][0]
    y = _seq(ins, "Y")
    if not isinstance(x, PackedSeq):
        data = x[:, None].expand((x.shape[0], y.data.shape[1])
                                 + tuple(x.shape[1:]))
        return PackedSeq(data * _tail(y.mask(data.dtype), data.dim()),
                         y.lengths)
    xd = x.data
    t_idx = torch.arange(xd.shape[1], dtype=torch.int32, device=xd.device)
    valid = t_idx[None, :] < torch.minimum(x.lengths, y.lengths)[:, None]
    return PackedSeq(xd * _tail(valid.to(xd.dtype), xd.dim()), y.lengths)


@op("sequence_expand_as")
def _sequence_expand_as(ctx, ins, attrs, o):
    return _sequence_expand(ctx, ins, attrs, o)


@op("sequence_concat")
def _sequence_concat(ctx, ins, attrs, o):
    """Concatenate the sequences of each example along time: step t of
    the output reads operand k's step t - (lengths of operands before
    k) where that falls inside operand k."""
    seqs = list(ins["X"])
    total = sum(s.data.shape[1] for s in seqs)
    b = seqs[0].data.shape[0]
    tail = tuple(seqs[0].data.shape[2:])
    dev = seqs[0].data.device
    out = torch.zeros((b, total) + tail, dtype=seqs[0].data.dtype,
                      device=dev)
    lens = sum(s.lengths for s in seqs)
    offset = torch.zeros((b,), dtype=torch.int32, device=dev)
    t_idx = torch.arange(total, dtype=torch.int32, device=dev)
    for s in seqs:
        src_t = t_idx[None, :] - offset[:, None]             # [B, total]
        valid = (src_t >= 0) & (src_t < s.lengths[:, None])
        idx = torch.clamp(src_t, 0, s.data.shape[1] - 1).to(torch.int64)
        src = torch.take_along_dim(s.data, _tail(idx, 2 + len(tail)),
                                   dim=1)
        out = torch.where(_tail(valid, 2 + len(tail)), src, out)
        offset = offset + s.lengths
    return PackedSeq(out, lens)


@op("sequence_reverse")
def _sequence_reverse(ctx, ins, attrs, o):
    s = _seq(ins)
    b, t = s.data.shape[:2]
    idx = s.lengths[:, None].to(torch.int64) - 1 - torch.arange(
        t, device=s.data.device)[None, :]
    idx = torch.clamp(idx, 0, t - 1)
    data = torch.take_along_dim(s.data, _tail(idx, s.data.dim()), dim=1)
    return {"Y": PackedSeq(data * _tail(s.mask(data.dtype), data.dim()),
                           s.lengths)}


@op("sequence_erase", no_grad=True)
def _sequence_erase(ctx, ins, attrs, o):
    """Remove the ``tokens`` from each sequence and close the gaps
    (reference sequence_erase_op), keeping the order."""
    s = _seq(ins)
    b, t = s.data.shape[:2]
    flat = s.data.to(torch.int32).reshape(b, t)
    hit = torch.zeros_like(flat, dtype=torch.bool)
    for tok in attrs.get("tokens", []):
        hit = hit | (flat == int(tok))
    newdata, newlens = compact_rows(flat, ~hit & s.mask(torch.bool))
    return PackedSeq(newdata.to(s.data.dtype).reshape(s.data.shape),
                     newlens)


@op("sequence_slice")
def _sequence_slice(ctx, ins, attrs, o):
    """Steps Offset .. Offset + Length of each sequence, clipped to it."""
    s = _seq(ins)
    offset = ins["Offset"][0].to(torch.int32).reshape(-1)
    length = ins["Length"][0].to(torch.int32).reshape(-1)
    b, t = s.data.shape[:2]
    t_idx = torch.arange(t, dtype=torch.int32, device=s.data.device)
    src_t = torch.clamp(t_idx[None, :] + offset[:, None], 0, t - 1)
    data = torch.take_along_dim(
        s.data, _tail(src_t.to(torch.int64), s.data.dim()), dim=1)
    newlens = torch.minimum(length, torch.clamp_min(s.lengths - offset, 0))
    m = t_idx[None, :] < newlens[:, None]
    return PackedSeq(data * _tail(m.to(data.dtype), data.dim()), newlens)


@op("sequence_reshape")
def _sequence_reshape(ctx, ins, attrs, o):
    """[B, T, D] -> [B, T * D / new_dim, new_dim]; each length becomes
    floor(length * D / new_dim)."""
    s = _seq(ins)
    new_dim = attrs["new_dim"]
    b, t, d = s.data.shape
    if (t * d) % new_dim:
        raise ValueError("sequence_reshape: %d steps of width %d do not "
                         "split into rows of %d" % (t, d, new_dim))
    data = s.data.reshape(b, t * d // new_dim, new_dim)
    return PackedSeq(data, torch.div(s.lengths * d, new_dim,
                                     rounding_mode="floor"))


@op("sequence_unpad")
def _sequence_unpad(ctx, ins, attrs, o):
    """A dense [B, T, ...] buffer and its lengths as a PackedSeq."""
    x = ins["X"][0]
    return PackedSeq(x, ins["Length"][0].to(torch.int32).reshape(-1))


@op("sequence_scatter", nondiff_inputs=("Ids",))
def _sequence_scatter(ctx, ins, attrs, o):
    """X [B, D] with Updates[b, i] added at column Ids[b, i] for each
    valid step i of row b. Duplicate ids add one after another in index
    order (``core.lower.add_rows``), a negative id wraps once and an id
    out of range is dropped, as jnp's scatter-add does."""
    x = ins["X"][0]
    ids = _seq(ins, "Ids")
    upd = _seq(ins, "Updates")
    b, d = x.shape[0], x.shape[1]
    idx = ids.data.to(torch.int64).reshape(b, -1)
    u = upd.data.reshape(b, idx.shape[1], -1).squeeze(-1) \
        if upd.data.dim() > 2 else upd.data.reshape(b, -1)
    u = u * ids.mask(u.dtype)
    col, ok = wrap_ids(idx, d)
    rows = torch.arange(b, device=x.device)[:, None] * d
    flat = torch.where(ok, rows + col, b * d)
    return add_rows(x.reshape(-1), flat.reshape(-1),
                    u.reshape(-1)).reshape(x.shape)


@op("sequence_enumerate", no_grad=True)
def _sequence_enumerate(ctx, ins, attrs, o):
    """Each step's window of ``win_size`` ids from its own sequence,
    ``pad_value`` past the sequence's end: [B, T, win_size] int32."""
    s = _seq(ins)
    win = attrs["win_size"]
    pad = attrs.get("pad_value", 0)
    b, t = s.data.shape[:2]
    x = s.data.to(torch.int32).reshape(b, t)
    t_idx = torch.arange(t, device=x.device)
    outs = []
    for j in range(win):
        valid = (t_idx[None, :] + j) < s.lengths[:, None]
        outs.append(torch.where(valid, torch.roll(x, -j, dims=1), pad))
    return PackedSeq(torch.stack(outs, dim=-1), s.lengths)


@op("sequence_roll")
def _sequence_roll(ctx, ins, attrs, o):
    """shifted[t] = x[t + offset] inside each sequence's valid region,
    zero outside: the building block of v2 context projection
    (reference operators/math/context_project.h). A dense X counts every
    step as valid."""
    s = ins["X"][0]
    off = int(attrs.get("offset", 0))
    x = s.data if isinstance(s, PackedSeq) else s
    t_len = x.shape[1]
    lens = s.lengths if isinstance(s, PackedSeq) else torch.full(
        (x.shape[0],), t_len, dtype=torch.int32, device=x.device)
    t = torch.arange(t_len, dtype=torch.int32, device=x.device)
    src = t + off
    valid = (src >= 0) & (src[None, :] < lens[:, None]) & \
        (t[None, :] < lens[:, None])
    out = torch.index_select(x, 1, torch.clamp(src, 0, t_len - 1))
    out = torch.where(valid[..., None] if x.dim() == 3 else valid, out, 0.0)
    return PackedSeq(out, lens) if isinstance(s, PackedSeq) else out


@op("lod_reset")
def _lod_reset(ctx, ins, attrs, o):
    """Re-segment a batch of sequences (reference `lod_reset_op.cc`): the
    flat token stream is kept, only the sequence boundaries change. The
    new boundaries come from the static attr ``target_lod`` (level-0
    offsets) or from a PackedSeq ``Y`` whose lengths are adopted; a dense
    ``Y`` (offsets known only at run time) has no static output shape
    and raises. Out[b2, t2] is token off2[b2] + t2 of the flat stream:
    of X's valid steps in order for a PackedSeq X (its row found by a
    search of the running lengths), of X's rows for a dense X."""
    x = ins["X"][0]
    y = ins.get("Y", [None])[0]
    target = attrs.get("target_lod", None)
    data = x.data if isinstance(x, PackedSeq) else x
    dev = data.device

    if isinstance(y, PackedSeq):
        len2 = y.lengths.to(torch.int64)
        b2, t2max = y.data.shape[0], y.data.shape[1]
        off2 = torch.cumsum(len2, 0) - len2
    elif y is not None:
        raise TypeError(
            "lod_reset: Y must be a PackedSeq whose lengths become the "
            "target segmentation; a dense Y (run-time offsets) gives no "
            "static output shape: pass target_lod instead")
    elif target:
        target = [int(v) for v in target]
        bounds = _int_consts(target, dev)
        len2 = bounds[1:] - bounds[:-1]
        off2 = bounds[:-1]
        b2 = len(target) - 1
        t2max = max(target[i + 1] - target[i] for i in range(b2))
    else:
        raise ValueError("lod_reset needs a PackedSeq Y or target_lod")

    ii = (off2[:, None] + torch.arange(t2max, device=dev)[None, :]
          ).reshape(-1)                                      # [B2 * T2]
    if isinstance(x, PackedSeq):
        b1, t1 = data.shape[0], data.shape[1]
        cum1 = torch.cumsum(x.lengths.to(torch.int64), 0)
        sb = torch.clamp_max(torch.searchsorted(cum1, ii, right=True),
                             b1 - 1)
        start = torch.where(sb > 0, cum1[torch.clamp_min(sb - 1, 0)], 0)
        st = torch.clamp(ii - start, 0, t1 - 1)
        gathered = data[sb, st].reshape((b2, t2max) + tuple(data.shape[2:]))
    else:
        gathered = data[torch.clamp(ii, 0, data.shape[0] - 1)]
        gathered = gathered.reshape((b2, t2max) + tuple(data.shape[1:]))
    mask = torch.arange(t2max, device=dev)[None, :] < len2[:, None]
    gathered = torch.where(_tail(mask, gathered.dim()), gathered, 0)
    return {"Out": PackedSeq(gathered, len2.to(torch.int32))}
