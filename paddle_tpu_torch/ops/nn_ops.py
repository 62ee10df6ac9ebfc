"""Neural-network op lowerings.

Capability parity: reference `conv_op` (and its depthwise form),
`pool_op`, `lrn_op`, `batch_norm_op`, `layer_norm_op`, `dropout_op`,
`softmax_op`, `log_softmax`, `cross_entropy_op`,
`softmax_with_cross_entropy_op` and `square_error_cost`, as the JAX
package's
``ops/nn_ops.py`` lowers them, with its gradient flags, and the fused
``conv2d_bn_act`` the epilogue-fusion pass emits (``passes/epilogue.py``).
The vision family too: the 3-D and transposed convolutions
(`conv_transpose_op`), `pool3d`, the pools with an index
(`pool_with_index_op`), `unpool_op`, `spp_op` and `im2sequence_op`.
Convolution and pooling go to the library (``torch.nn.functional``), as
the JAX package leaves them to XLA; an NHWC activation is handed over as
a channels-last view, so no copy is made for the layout. The loss
family too: the pointwise and ranking losses (`sigmoid_cross_entropy_
with_logits_op`, `huber_loss_op`, `smooth_l1_loss_op`, `hinge_loss_op`,
`modified_huber_loss_op`, `rank_loss_op`, `margin_rank_loss_op`,
`log_loss_op`, `kldiv_loss_op`, `bpr_loss_op`), the sampled and
tree-structured softmax heads (`nce_op`, `hierarchical_sigmoid_op`) and
the NTM shift (`conv_shift_op`), each with the JAX package's formula,
overflows included. The heads gather rows of W per example
(:class:`_RowGather`), whose backward adds a row's duplicates in index
order. ``moe`` arrives with a later slice.
"""

import math

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core import registry
from paddle_tpu_torch.core.infer import torch_dtype
from paddle_tpu_torch.core.lower import add_rows, last_writes, wrap_ids
from paddle_tpu_torch.core.registry import op


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


def _to_nchw(x, attrs):
    """``(NCHW view of x, whether x was NHWC)``."""
    nhwc = attrs.get("data_layout", "NCHW") == "NHWC"
    return (x.permute(0, 3, 1, 2) if nhwc else x), nhwc


def _from_nchw(y, nhwc):
    return y.permute(0, 2, 3, 1) if nhwc else y


# ---- convolution ----

@op("conv2d")
def _conv2d(ctx, ins, attrs, o):
    x, w = ins["Input"][0], ins["Filter"][0]  # NCHW or NHWC; OIHW
    strides = _pair(attrs.get("strides", [1, 1]))
    pads = _pair(attrs.get("paddings", [0, 0]))
    dil = _pair(attrs.get("dilations", [1, 1]))
    groups = attrs.get("groups", 1) or 1
    # 1x1/stride-1 NCHW convs take the fused backward when the flag is
    # on: one kernel forms dx and dw from one dy (kernels/conv1x1_bwd.py);
    # the forward is the same convolution either way
    from paddle_tpu_torch.kernels import conv1x1_bwd as _k1

    if _k1.supported(x, w, attrs):
        return {"Output": _k1.conv1x1(x, w)}
    # NHWC keeps the filter logically OIHW: optimizer state and
    # checkpoints are layout-independent
    xn, nhwc = _to_nchw(x, attrs)
    out = F.conv2d(xn, w, None, strides, pads, dil, groups)
    return {"Output": _from_nchw(out, nhwc)}


@op("depthwise_conv2d")
def _depthwise_conv2d(ctx, ins, attrs, o):
    a = dict(attrs)
    caxis = 3 if attrs.get("data_layout", "NCHW") == "NHWC" else 1
    a["groups"] = ins["Input"][0].shape[caxis]
    return _conv2d(ctx, ins, a, o)


# ---- pooling ----

def _pool_pads(sizes, k, strides, pads, ceil_mode):
    """Per-dim (lo, hi) padding; ceil_mode adds high-side padding so the
    last partial window is kept (reference pool_op.cc ceil mode). Padded
    cells never contribute: max pools pad with -inf, avg pools divide by
    the true in-window count."""
    out = []
    for d, kk, s, p in zip(sizes, k, strides, pads):
        hi = p
        if ceil_mode:
            n_out = -(-(d + 2 * p - kk) // s) + 1
            hi = max(p, (n_out - 1) * s + kk - d - p)
        out.append((p, hi))
    return out


@op("pool2d")
def _pool2d(ctx, ins, attrs, o):
    x, nhwc = _to_nchw(ins["X"][0], attrs)
    ptype = attrs.get("pooling_type", "max")
    k = _pair(attrs.get("ksize", [2, 2]))
    if attrs.get("global_pooling", False):
        k = tuple(x.shape[2:4])
        strides, pads = (1, 1), (0, 0)
    else:
        strides = _pair(attrs.get("strides", [1, 1]))
        pads = _pair(attrs.get("paddings", [0, 0]))
    ceil_mode = attrs.get("ceil_mode", False)
    pp = _pool_pads(x.shape[2:4], k, strides, pads, ceil_mode)
    padded = any(lo or hi for lo, hi in pp)
    # the library pads by itself when the padding is symmetric and at
    # most half a window; anything else is padded here first
    native = all(lo == hi and 2 * lo <= kk for (lo, hi), kk in zip(pp, k))
    flat = (pp[1][0], pp[1][1], pp[0][0], pp[0][1])
    if ptype == "max":
        if native:
            out = F.max_pool2d(x, k, strides, tuple(lo for lo, _ in pp))
        else:
            out = F.max_pool2d(F.pad(x, flat, value=float("-inf")), k,
                               strides)
    elif not padded:
        out = F.avg_pool2d(x, k, strides)
    elif attrs.get("exclusive", True) or ceil_mode:
        if native:
            out = F.avg_pool2d(x, k, strides, tuple(lo for lo, _ in pp),
                               count_include_pad=False)
        else:
            s = F.avg_pool2d(F.pad(x, flat), k, strides, divisor_override=1)
            cnt = F.avg_pool2d(F.pad(torch.ones_like(x), flat), k, strides,
                               divisor_override=1)
            out = s / torch.clamp_min(cnt, 1.0)
    else:
        out = F.avg_pool2d(F.pad(x, flat), k, strides)
    return _from_nchw(out, nhwc)


# ---- normalization ----

def _bn_axes(x, attrs):
    layout = attrs.get("data_layout", "NCHW")
    caxis = 1 if layout == "NCHW" else x.dim() - 1
    axes = tuple(i for i in range(x.dim()) if i != caxis)
    bshape = [1] * x.dim()
    bshape[caxis] = x.shape[caxis]
    return axes, bshape


def _bn_stats(xf, axes):
    """Batch mean/var from sum(x) and sum(x*x). The E[x^2] - E[x]^2 form
    can go slightly negative under fp32 cancellation when |mean| >> std,
    so clamp at 0 to keep rsqrt(var+eps) finite."""
    mean = torch.mean(xf, dim=axes)
    msq = torch.mean(xf * xf, dim=axes)
    return mean, torch.clamp_min(msq - mean * mean, 0.0)


@op("batch_norm", stateful_outputs=("MeanOut", "VarianceOut"),
    nondiff_inputs=("Mean", "Variance"))
def _batch_norm(ctx, ins, attrs, o):
    x = ins["X"][0]
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    rmean, rvar = ins["Mean"][0], ins["Variance"][0]
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    is_test = attrs.get("is_test", False)
    axes, bshape = _bn_axes(x, attrs)

    # statistics always in fp32, and the running stats are fp32 state
    xf = x.to(torch.float32)
    if is_test or not ctx.training:
        mean, var = rmean.to(torch.float32), rvar.to(torch.float32)
        new_rmean, new_rvar = rmean, rvar
    else:
        mean, var = _bn_stats(xf, axes)
        # running stats are state, not part of the loss graph
        new_rmean = (momentum * rmean + (1 - momentum) * mean).detach()
        new_rvar = (momentum * rvar + (1 - momentum) * var).detach()

    inv = torch.rsqrt(var + eps)
    y = (xf - mean.reshape(bshape)) * inv.reshape(bshape) \
        * scale.to(torch.float32).reshape(bshape) \
        + bias.to(torch.float32).reshape(bshape)
    return {"Y": y.to(x.dtype), "MeanOut": new_rmean,
            "VarianceOut": new_rvar,
            "SavedMean": mean, "SavedVariance": var}


def _batch_norm_grad(ctx, ins, out_grads, attrs, o):
    """Hand-written BN backward (reference `batch_norm_op.cc` GradKernel):
    two passes over (x, dy) instead of autograd's chain through mean and
    var. Stats are recomputed from x (grad ops receive forward inputs,
    not saved outputs).

    When the reduction pass tagged this op (``use_pallas_reduction``,
    passes/reductions.py) and the kernel's preconditions hold, the whole
    training-mode chain, the four channel sums plus the dx elementwise,
    is one call of ``kernels.bn_grad.bn_grad``: the CUDA kernel on the
    card, its plain version on the CPU."""
    x, scale = ins["X"][0], ins["Scale"][0]
    dy = (out_grads.get("Y") or [None])[0]
    if dy is None:
        return {}
    eps = attrs.get("epsilon", 1e-5)
    is_test = attrs.get("is_test", False) or not ctx.training
    if not is_test and attrs.get("use_pallas_reduction", False):
        from paddle_tpu_torch.kernels import bn_grad as _kbn

        if _kbn.supported(x, attrs):
            dx, dscale, dbias = _kbn.bn_grad(
                x, dy, scale, eps, tile=attrs.get("pallas_tile"))
            return {"X": [dx], "Scale": [dscale], "Bias": [dbias]}
    axes, bshape = _bn_axes(x, attrs)
    xf = x.to(torch.float32)
    dyf = dy.to(torch.float32)
    sf = scale.to(torch.float32)
    if is_test:
        mean = ins["Mean"][0].to(torch.float32)
        var = ins["Variance"][0].to(torch.float32)
    else:
        mean, var = _bn_stats(xf, axes)
    inv = torch.rsqrt(var + eps)
    xhat = (xf - mean.reshape(bshape)) * inv.reshape(bshape)
    dbias = torch.sum(dyf, dim=axes)
    dscale = torch.sum(dyf * xhat, dim=axes)
    if is_test:
        dx = dyf * (sf * inv).reshape(bshape)
    else:
        n = 1
        for i in axes:
            n *= x.shape[i]
        dx = (sf * inv).reshape(bshape) / n * (
            n * dyf - dbias.reshape(bshape) - xhat * dscale.reshape(bshape))
    return {"X": [dx.to(x.dtype)], "Scale": [dscale], "Bias": [dbias]}


registry.REGISTRY["batch_norm"].grad_lower = _batch_norm_grad


# ---- fused conv epilogue (passes/epilogue.py rewrite target) ----

def _bn_slot_ins(ins, conv_out):
    return {"X": [conv_out], "Scale": ins["Scale"], "Bias": ins["Bias"],
            "Mean": ins["Mean"], "Variance": ins["Variance"]}


def _fused_conv_lower(attrs):
    return _depthwise_conv2d \
        if attrs.get("conv_type") == "depthwise_conv2d" else _conv2d


def _epilogue_tail(y, res, attrs):
    if res is not None:
        y = torch.add(y, res)
    return torch.relu(y) if attrs.get("act", None) == "relu" else y


@op("conv2d_bn_act", stateful_outputs=("MeanOut", "VarianceOut"),
    nondiff_inputs=("Mean", "Variance"))
def _conv2d_bn_act(ctx, ins, attrs, o):
    """conv2d -> batch_norm [-> residual add] [-> relu] as one op.

    Emitted by the epilogue-fusion pass; re-uses the constituent
    lowerings verbatim (the same conv call, the same float32 batch
    statistics and casts, ``torch.relu``), so the fused program computes
    bitwise what the unfused one does."""
    conv_out = _fused_conv_lower(attrs)(
        ctx, {"Input": ins["Input"], "Filter": ins["Filter"]}, attrs,
        o)["Output"]
    bn = _batch_norm(ctx, _bn_slot_ins(ins, conv_out), attrs, o)
    res = ins["Residual"][0] if attrs.get("with_residual", False) else None
    return {"Out": _epilogue_tail(bn["Y"], res, attrs),
            "MeanOut": bn["MeanOut"], "VarianceOut": bn["VarianceOut"],
            "SavedMean": bn["SavedMean"],
            "SavedVariance": bn["SavedVariance"]}


def _conv2d_bn_act_grad(ctx, ins, out_grads, attrs, o):
    """The fused epilogue's backward, chained by hand from the pieces the
    unfused program runs, in its order: autograd through the add/relu
    tail, then the hand-written batch-norm backward (one launch of the
    batch-norm backward kernel when the reduction pass tagged the op),
    then autograd through the recomputed convolution, which is the fused
    1x1 backward's ``conv1x1`` where ``conv2d`` would route there."""
    dy = (out_grads.get("Out") or [None])[0]
    if dy is None:
        return {}
    x, w = ins["Input"][0], ins["Filter"][0]
    res = ins["Residual"][0] if attrs.get("with_residual", False) else None
    conv_lower = _fused_conv_lower(attrs)
    with torch.enable_grad():
        xl, wl = x.detach().requires_grad_(), w.detach().requires_grad_()
        conv_out = conv_lower(ctx, {"Input": [xl], "Filter": [wl]}, attrs,
                              o)["Output"]
    bn_ins = _bn_slot_ins(ins, conv_out.detach())
    y_bn = _batch_norm(ctx, bn_ins, attrs, o)["Y"]
    with torch.enable_grad():
        leaves = [y_bn.detach().requires_grad_()]
        if res is not None:
            leaves.append(res.detach().requires_grad_())
        out = _epilogue_tail(leaves[0], leaves[1] if res is not None
                             else None, attrs)
        tail = torch.autograd.grad(out, leaves,
                                   dy.to(out.dtype).reshape(out.shape))
    bg = _batch_norm_grad(ctx, bn_ins, {"Y": [tail[0]]}, attrs, o)
    with torch.enable_grad():
        dx, dw = torch.autograd.grad(conv_out, [xl, wl],
                                     bg["X"][0].to(conv_out.dtype))
    # under amp the generic conv grad yields the master dtype through the
    # cast's backward; mirror it from the Filter var's declaration
    wdecl = o.block.var(o.inputs["Filter"][0]).dtype \
        if getattr(o, "block", None) is not None else None
    if wdecl is not None and torch_dtype(wdecl) != dw.dtype:
        dw = dw.to(torch_dtype(wdecl))
    grads = {"Input": [dx], "Filter": [dw], "Scale": bg["Scale"],
             "Bias": bg["Bias"]}
    if res is not None:
        grads["Residual"] = [tail[1]]
    return grads


registry.REGISTRY["conv2d_bn_act"].grad_lower = _conv2d_bn_act_grad


@op("layer_norm")
def _layer_norm(ctx, ins, attrs, o):
    x = ins["X"][0]
    eps = attrs.get("epsilon", 1e-5)
    begin = attrs.get("begin_norm_axis", 1)
    axes = tuple(range(begin, x.dim()))
    mean = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, correction=0, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    shape = tuple(x.shape[begin:])
    if ins.get("Scale") and ins["Scale"][0] is not None:
        y = y * ins["Scale"][0].reshape(shape)
    if ins.get("Bias") and ins["Bias"][0] is not None:
        y = y + ins["Bias"][0].reshape(shape)
    # squeeze() drops every size-1 dim, as jnp's squeeze() does
    return {"Y": y, "Mean": mean.squeeze(), "Variance": var.squeeze()}


@op("dropout", seq_map=True)
def _dropout(ctx, ins, attrs, o):
    """Reference `dropout_op`, as the JAX package draws it: the keep
    mask comes from 8 random bits an element, so the keep probability
    is quantised to 1/256 (clamped at both edges), and
    ``upscale_in_train`` divides by the realised keep probability. The
    draw is the op's own stream (``TraceContext.rng``); the grad op
    recomputes this forward under the forward op's uid, so it redraws
    the same mask."""
    x = ins["X"][0]
    p = attrs.get("dropout_prob", 0.5)
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if attrs.get("is_test", False) or not ctx.training or p == 0.0:
        # downgrade mode scales by the keep probability at test time
        # (train applies the raw mask); upscale mode is the identity
        out = x * (1.0 - p) if (impl == "downgrade_in_infer" and p > 0.0) \
            else x
        return {"Out": out, "Mask": torch.ones_like(x)}
    thresh = max(1, int(round((1.0 - p) * 256.0)))
    if thresh >= 256:               # the keep probability rounds to 1
        mask = torch.ones_like(x)
        realized_keep = 1.0
    else:
        if x.device.type == "meta":
            bits = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
        else:
            bits = torch.randint(0, 256, tuple(x.shape), dtype=torch.uint8,
                                 generator=ctx.rng(), device=x.device)
        mask = (bits < thresh).to(x.dtype)
        realized_keep = thresh / 256.0
    if impl == "upscale_in_train":
        out = x * mask / realized_keep
    else:
        out = x * mask
    return {"Out": out, "Mask": mask}


@op("lrn")
def _lrn(ctx, ins, attrs, o):
    """Reference `lrn_op` across channels (NCHW): x / (k + alpha *
    sum of the n neighbouring channels' squares) ** beta."""
    x = ins["X"][0]
    n = attrs.get("n", 5)
    alpha, beta = attrs.get("alpha", 1e-4), attrs.get("beta", 0.75)
    k = attrs.get("k", 2.0)
    half = n // 2
    pad = F.pad(torch.square(x), (0, 0, 0, 0, half, half))
    acc = sum(pad[:, i:i + x.shape[1]] for i in range(n))
    mid = k + alpha * acc
    return {"Out": x / torch.pow(mid, beta), "MidOut": mid}


# ---- softmax & losses ----

@op("softmax", seq_map=True)
def _softmax(ctx, ins, attrs, o):
    return torch.softmax(ins["X"][0], dim=attrs.get("axis", -1))


@op("log_softmax", seq_map=True)
def _log_softmax(ctx, ins, attrs, o):
    return torch.log_softmax(ins["X"][0], dim=attrs.get("axis", -1))


@op("square_error_cost")
def _square_error_cost(ctx, ins, attrs, o):
    return torch.square(ins["X"][0] - ins["Y"][0])


def _take_label(x, label):
    """``jnp.take_along_axis(x, label[..., None], -1)`` for hard labels:
    a negative label wraps once, and a label out of [-C, C) reads NaN
    (jnp's fill), with no gradient into ``x``; ``take_along_dim`` would
    read another class on the CPU and fault on the card."""
    lab = label.to(torch.int64)
    if lab.dim() == x.dim() and lab.shape[-1] == 1:
        lab = lab.squeeze(-1)
    idx, ok = wrap_ids(lab[..., None], x.shape[-1])
    return torch.where(ok, torch.take_along_dim(x, idx, dim=-1),
                       float("nan"))


@op("cross_entropy", nondiff_inputs=("Label",), seq_map=True)
def _cross_entropy(ctx, ins, attrs, o):
    """Takes probabilities (post-softmax), like the reference
    `cross_entropy_op` (`operators/cross_entropy_op.cc`)."""
    x, label = ins["X"][0], ins["Label"][0]
    if attrs.get("soft_label", False):
        loss = -torch.sum(label * torch.log(torch.clamp_min(x, 1e-20)), -1,
                          keepdim=True)
    else:
        p = _take_label(x, label)
        loss = -torch.log(torch.clamp_min(p, 1e-20))
    return {"Y": loss}


@op("softmax_with_cross_entropy", nondiff_inputs=("Label",), seq_map=True)
def _softmax_with_cross_entropy(ctx, ins, attrs, o):
    """Reference `softmax_with_cross_entropy_op`: the loss from logits
    through a log-softmax, and the softmax itself."""
    logits, label = ins["Logits"][0], ins["Label"][0]
    logp = torch.log_softmax(logits, dim=-1)
    if attrs.get("soft_label", False):
        loss = -torch.sum(label * logp, -1, keepdim=True)
    else:
        loss = -_take_label(logp, label)
    return {"Loss": loss, "Softmax": torch.exp(logp)}


# ---- the vision family: 3-D and transposed convolutions, the other
# pools, unpooling, spatial pyramids, image-to-sequence ----

_CONV_T = {2: F.conv_transpose2d, 3: F.conv_transpose3d}


@op("conv3d")
def _conv3d(ctx, ins, attrs, o):
    x, w = ins["Input"][0], ins["Filter"][0]  # NCDHW, OIDHW
    return {"Output": F.conv3d(
        x, w, None, _pair(attrs.get("strides", [1, 1, 1]), 3),
        _pair(attrs.get("paddings", [0, 0, 0]), 3),
        _pair(attrs.get("dilations", [1, 1, 1]), 3),
        attrs.get("groups", 1) or 1)}


def _conv_transpose(x, w, attrs, nd, extra=None):
    """The gradient of an ``nd``-D convolution with respect to its input,
    as the JAX package computes it (the input dilated by the strides,
    convolved with the flipped, IO-swapped filter at padding k_eff-1-p):
    output size (H-1)*s - 2p + k_eff, plus ``extra`` cells on the high
    side. The filter is [C_in, C_out / groups, k...], the library's
    layout. The library takes an extra size below max(stride, dilation)
    as ``output_padding``; a larger one (the JAX package allows up to
    stride + dilation - 1) is cut from the unpadded output, where the
    cells past its end receive no input and stay zero."""
    strides = _pair(attrs.get("strides", [1] * nd), nd)
    pads = _pair(attrs.get("paddings", [0] * nd), nd)
    dil = _pair(attrs.get("dilations", [1] * nd), nd)
    groups = attrs.get("groups", 1) or 1
    extra = extra or (0,) * nd
    if all(e < max(s, d) for e, s, d in zip(extra, strides, dil)):
        return _CONV_T[nd](x, w, None, strides, pads, tuple(extra), groups,
                           dil)
    full = _CONV_T[nd](x, w, None, strides, 0, 0, groups, dil)
    keff = [(w.shape[2 + i] - 1) * dil[i] + 1 for i in range(nd)]
    for i in range(nd):
        size = (x.shape[2 + i] - 1) * strides[i] - 2 * pads[i] + keff[i] \
            + extra[i]
        have = full.shape[2 + i] - pads[i]
        full = full.narrow(2 + i, pads[i], min(size, have))
        if size > have:
            spec = [0, 0] * (nd - 1 - i) + [0, size - have]
            full = F.pad(full, spec)
    return full


@op("conv2d_transpose")
def _conv2d_transpose(ctx, ins, attrs, o):
    """Reference `conv_transpose_op.cc`: the gradient of conv2d with
    respect to its input; output size (H-1)*stride - 2*pad + k_eff."""
    return {"Output": _conv_transpose(ins["Input"][0], ins["Filter"][0],
                                      attrs, 2)}


@op("conv3d_transpose")
def _conv3d_transpose(ctx, ins, attrs, o):
    """Transposed 3-D conv (reference `conv_transpose_op.cc` Conv3D).
    ``output_size`` picks among the sizes a strided conv maps to one
    input size: its surplus over the default is high-side padding, and
    one out of [default, default + stride + dilation - 1) raises, as in
    the JAX package."""
    x, w = ins["Input"][0], ins["Filter"][0]  # NCDHW; [Cin, Cout, kd,kh,kw]
    strides = _pair(attrs.get("strides", [1, 1, 1]), 3)
    pads = _pair(attrs.get("paddings", [0, 0, 0]), 3)
    dil = _pair(attrs.get("dilations", [1, 1, 1]), 3)
    keff = [(w.shape[2 + i] - 1) * dil[i] + 1 for i in range(3)]
    out_size = attrs.get("output_size", None)
    extra = [0, 0, 0]
    if out_size:
        for i in range(3):
            dflt = (x.shape[2 + i] - 1) * strides[i] - 2 * pads[i] + keff[i]
            extra[i] = int(out_size[i]) - dflt
            if not 0 <= extra[i] < strides[i] + max(0, dil[i] - 1) + 1:
                raise ValueError(
                    "conv3d_transpose output_size[%d]=%s unreachable "
                    "(default %d, stride %d)" % (i, out_size[i], dflt,
                                                 strides[i]))
    return {"Output": _conv_transpose(x, w, attrs, 3, extra)}


def _pool_nd(x, attrs, nd):
    """``pool2d``'s rule over the last ``nd`` dims of an NC... tensor:
    max pools pad with -inf, average pools divide by the count of cells
    inside the image where padding (or ceil mode) adds cells and
    ``exclusive`` holds, else by the window's size."""
    ptype = attrs.get("pooling_type", "max")
    k = _pair(attrs.get("ksize", [2] * nd), nd)
    if attrs.get("global_pooling", False):
        k = tuple(x.shape[2:])
        strides, pads = (1,) * nd, (0,) * nd
    else:
        strides = _pair(attrs.get("strides", [1] * nd), nd)
        pads = _pair(attrs.get("paddings", [0] * nd), nd)
    ceil_mode = attrs.get("ceil_mode", False)
    pp = _pool_pads(x.shape[2:], k, strides, pads, ceil_mode)
    flat = tuple(v for lo, hi in reversed(pp) for v in (lo, hi))
    padded = any(lo or hi for lo, hi in pp)
    mp = {2: F.max_pool2d, 3: F.max_pool3d}[nd]
    ap = {2: F.avg_pool2d, 3: F.avg_pool3d}[nd]
    if ptype == "max":
        return mp(F.pad(x, flat, value=float("-inf")), k, strides)
    s = ap(F.pad(x, flat), k, strides, divisor_override=1)
    if (attrs.get("exclusive", True) or ceil_mode) and padded:
        cnt = ap(F.pad(torch.ones_like(x), flat), k, strides,
                 divisor_override=1)
        return s / torch.clamp_min(cnt, 1.0)
    n = 1
    for kk in k:
        n *= kk
    return s / float(n)


@op("pool3d")
def _pool3d(ctx, ins, attrs, o):
    """3-D pooling over NCDHW (reference `pool_op.cc` Pool3D kernels)."""
    return _pool_nd(ins["X"][0], attrs, 3)


def _max_with_index(x, attrs, nd):
    """Max pool and the flat position of each maximum in the unpadded
    map (reference `pool_with_index_op.cc`), as the JAX package finds
    them: padding with the dtype's lowest value, the windows as patches
    (row-major within a window), the first maximum of each. The maximum
    is ``amax``, whose gradient splits among equal values as
    ``jnp.max``'s does."""
    k = _pair(attrs.get("ksize", [2] * nd), nd)
    strides = _pair(attrs.get("strides", k), nd)
    pads = _pair(attrs.get("paddings", [0] * nd), nd)
    lowest = torch.finfo(x.dtype).min
    xp = F.pad(x, tuple(v for p in reversed(pads) for v in (p, p)),
               value=lowest)
    for i in range(nd):
        xp = xp.unfold(2 + i, k[i], strides[i])
    outs = tuple(xp.shape[2:2 + nd])
    patches = xp.reshape(tuple(xp.shape[:2 + nd]) + (-1,))
    win = torch.argmax(patches, dim=-1)
    out = torch.amax(patches, dim=-1)
    mask = torch.zeros_like(win)
    for i in range(nd):
        inner = 1
        for kk in k[i + 1:]:
            inner *= kk
        wi = torch.div(win, inner, rounding_mode="floor") % k[i]
        shape = [1] * nd
        shape[i] = outs[i]
        zi = torch.arange(outs[i], device=x.device).reshape(shape) \
            * strides[i] - pads[i] + wi
        mask = mask * x.shape[2 + i] + zi
    return {"Out": out, "Mask": mask.to(torch.int32)}


@op("pool2d_with_index")
def _pool2d_with_index(ctx, ins, attrs, o):
    return _max_with_index(ins["X"][0], attrs, 2)


@op("max_pool3d_with_index")
def _max_pool3d_with_index(ctx, ins, attrs, o):
    return _max_with_index(ins["X"][0], attrs, 3)


@op("unpool")
def _unpool(ctx, ins, attrs, o):
    """Max-unpooling (reference `unpool_op.cc`): the pooled values go back
    to the positions max_pool2d_with_index's Mask recorded."""
    x, idx = ins["X"][0], ins["Indices"][0]
    n, c, h, w = x.shape
    k = _pair(attrs.get("ksize", [2, 2]))
    strides = _pair(attrs.get("strides", [1, 1]))
    pads = _pair(attrs.get("paddings", [0, 0]))
    ho = (h - 1) * strides[0] - 2 * pads[0] + k[0]
    wo = (w - 1) * strides[1] - 2 * pads[1] + k[1]
    # jnp's scatter: a negative index wraps once, one out of range is
    # dropped (the spare slot), the last of duplicates wins
    size = ho * wo
    at, ok = wrap_ids(idx.reshape(n * c, h * w).to(torch.int64), size)
    at = last_writes(torch.where(ok, at, size), size)
    out = x.new_zeros((n * c, size + 1)).scatter(
        1, at, x.reshape(n * c, h * w))
    return {"Out": out[:, :size].reshape(n, c, ho, wo)}


@op("spp")
def _spp(ctx, ins, attrs, o):
    """Spatial pyramid pooling (reference `spp_op.cc`): level l pools the
    map into 2^l x 2^l bins (kernel ceil(dim / bins), padded so the
    windows tile it), each level flattened, all concatenated: [N, C *
    sum(4^l)]. Average bins divide by their cells inside the image."""
    x = ins["X"][0]
    n, c, h, w = x.shape
    ptype = attrs.get("pooling_type", "max")
    outs = []
    for lvl in range(attrs.get("pyramid_height", 1)):
        bins = 2 ** lvl
        kh, kw = -(-h // bins), -(-w // bins)
        ph, pw = (kh * bins - h + 1) // 2, (kw * bins - w + 1) // 2
        flat = (pw, kw * bins - w - pw, ph, kh * bins - h - ph)
        if ptype == "max":
            pooled = F.max_pool2d(F.pad(x, flat, value=float("-inf")),
                                  (kh, kw), (kh, kw))
        else:
            s = F.avg_pool2d(F.pad(x, flat), (kh, kw), (kh, kw),
                             divisor_override=1)
            cnt = F.avg_pool2d(F.pad(torch.ones_like(x), flat), (kh, kw),
                               (kh, kw), divisor_override=1)
            pooled = s / torch.clamp_min(cnt, 1.0)
        outs.append(pooled.reshape(n, -1))
    return {"Out": torch.cat(outs, dim=1)}


@op("im2sequence")
def _im2sequence(ctx, ins, attrs, o):
    """Reference `im2sequence_op.cc`, as the JAX package lowers it: the
    VALID patches of the image (``paddings`` is not read), one row a
    patch, [N, OH*OW, C*kh*kw] with the channel outermost in a row."""
    x = ins["X"][0]  # NCHW
    k = _pair(attrs.get("kernels", [1, 1]))
    s = _pair(attrs.get("strides", [1, 1]))
    return F.unfold(x, k, stride=s).transpose(1, 2)


# ---- the loss family (family 4): the pointwise and ranking losses,
# the sampled and tree-structured softmax heads, and the NTM shift ----

class _RowGather(torch.autograd.Function):
    """``w[idx]`` for int64 rows ``idx`` in range (any shape): rows of
    ``w`` [V, ...] gathered to ``idx.shape + w.shape[1:]``. The backward
    adds the cotangents of one row's reads in index order through
    ``core.lower.add_rows``, so a gradient has the same bits from run to
    run (``index_select``'s and ``embedding``'s backwards add duplicates
    by atomics on the card)."""

    @staticmethod
    def forward(ctx, w, idx):
        ctx.save_for_backward(idx)
        ctx.w_shape = tuple(w.shape)
        return w[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        rows = idx.reshape(-1)
        vals = g.reshape((rows.shape[0],) + ctx.w_shape[1:])
        return add_rows(g.new_zeros(ctx.w_shape), rows, vals), None


def _take_rows(w, ids):
    """``jnp.take(w, ids, axis=0)``: a negative id wraps once, an id out
    of range reads NaN and passes no gradient."""
    idx, ok = wrap_ids(ids.to(torch.int64), w.shape[0])
    out = _RowGather.apply(w, idx)
    ok = ok.reshape(tuple(ok.shape) + (1,) * (out.dim() - ok.dim()))
    return torch.where(ok, out, float("nan"))


def _sigmoid_ce(x, label):
    """max(x, 0) - x label + log1p(exp(-|x|)), the JAX formula with its
    derivatives at x = 0: the maximum splits the gradient (as
    ``torch.maximum`` does) and |x| passes it whole (jnp.abs's
    derivative is 1 at 0, ``torch.abs``'s 0)."""
    a = torch.where(x >= 0, x, -x)
    return torch.maximum(x, torch.zeros_like(x)) - x * label + \
        torch.log1p(torch.exp(-a))


@op("sigmoid_cross_entropy_with_logits")
def _sigmoid_cross_entropy_with_logits(ctx, ins, attrs, o):
    return _sigmoid_ce(ins["X"][0], ins["Label"][0])


@op("huber_loss")
def _huber_loss(ctx, ins, attrs, o):
    x, y = ins["X"][0], ins["Y"][0]
    d = attrs.get("delta", 1.0)
    r = y - x
    a = torch.abs(r)
    loss = torch.where(a <= d, 0.5 * r * r, d * (a - 0.5 * d))
    return {"Out": loss, "Residual": r}


@op("smooth_l1_loss")
def _smooth_l1_loss(ctx, ins, attrs, o):
    x, y = ins["X"][0], ins["Y"][0]
    sigma = attrs.get("sigma", 1.0)
    s2 = sigma * sigma
    d = x - y
    if ins.get("InsideWeight") and ins["InsideWeight"][0] is not None:
        d = d * ins["InsideWeight"][0]
    a = torch.abs(d)
    loss = torch.where(a < 1.0 / s2, 0.5 * d * d * s2, a - 0.5 / s2)
    if ins.get("OutsideWeight") and ins["OutsideWeight"][0] is not None:
        loss = loss * ins["OutsideWeight"][0]
    out = torch.sum(loss.reshape(loss.shape[0], -1), -1, keepdim=True)
    return {"Out": out, "Diff": d}


@op("hinge_loss", nondiff_inputs=("Labels",))
def _hinge_loss(ctx, ins, attrs, o):
    logits, labels = ins["Logits"][0], ins["Labels"][0]
    m = 1.0 - (2.0 * labels - 1.0) * logits
    return {"Loss": torch.maximum(m, torch.zeros_like(m))}


@op("modified_huber_loss", nondiff_inputs=("Y",))
def _modified_huber_loss(ctx, ins, attrs, o):
    x, y = ins["X"][0], ins["Y"][0]
    z = x * (2.0 * y - 1.0)
    loss = torch.where(z >= 1.0, 0.0, torch.where(
        z >= -1.0, torch.square(1.0 - z), -4.0 * z))
    return {"Out": loss, "IntermediateVal": z}


@op("rank_loss")
def _rank_loss(ctx, ins, attrs, o):
    """log1p(exp(d)) - label d, as the JAX package writes it: inf where
    d passes about 88 (softplus would not overflow)."""
    label, left, right = ins["Label"][0], ins["Left"][0], ins["Right"][0]
    d = left - right
    return torch.log1p(torch.exp(d)) - label * d


@op("margin_rank_loss")
def _margin_rank_loss(ctx, ins, attrs, o):
    label, x1, x2 = ins["Label"][0], ins["X1"][0], ins["X2"][0]
    m = -label * (x1 - x2) + attrs.get("margin", 0.0)
    act = torch.maximum(torch.zeros_like(m), m)
    return {"Out": act, "Activated": (act > 0).to(x1.dtype)}


@op("log_loss")
def _log_loss(ctx, ins, attrs, o):
    p, label = ins["Predicted"][0], ins["Labels"][0]
    eps = attrs.get("epsilon", 1e-4)
    return {"Loss": -label * torch.log(p + eps)
            - (1 - label) * torch.log(1 - p + eps)}


@op("kldiv_loss")
def _kldiv_loss(ctx, ins, attrs, o):
    """target (log(max(target, 1e-20)) - x), then the reduction: "mean"
    (the default), "sum", "batchmean" (the sum over the batch size) or
    none. The result goes to "Loss", which the JAX package's layer does
    not name (ROADMAP.md Queue 3)."""
    x, tgt = ins["X"][0], ins["Target"][0]
    loss = tgt * (torch.log(torch.clamp_min(tgt, 1e-20)) - x)
    red = attrs.get("reduction", "mean")
    if red == "mean":
        loss = torch.mean(loss)
    elif red == "sum":
        loss = torch.sum(loss)
    elif red == "batchmean":
        loss = torch.sum(loss) / x.shape[0]
    return {"Loss": loss}


@op("bpr_loss", nondiff_inputs=("Label",))
def _bpr_loss(ctx, ins, attrs, o):
    """-sum_j log(sigmoid(x_label - x_j)) / (C - 1) over every class j,
    the label's own included, as the JAX package writes it: log of the
    sigmoid, -inf where the difference passes about -88 below (the
    log-sigmoid would stay finite)."""
    x = ins["X"][0]
    diff = _take_label(x, ins["Label"][0]) - x
    n = x.shape[-1]
    return {"Y": -torch.sum(torch.log(torch.sigmoid(diff)), -1,
                            keepdim=True) / (n - 1)}


def nce_draw(gen, batch, num_neg, total, device):
    """The negatives of one ``nce`` op: [batch, num_neg] int64 ids
    uniform in [0, total) from ``gen`` (``TraceContext.rng``), on the
    device (a captured graph replays the draw)."""
    if device.type == "meta":
        return torch.empty((batch, num_neg), dtype=torch.int64,
                           device=device)
    return torch.randint(0, total, (batch, num_neg), generator=gen,
                         dtype=torch.int64, device=device)


def nce_logits(x, w, b, ids, num_true, num_neg, total):
    """The arithmetic of ``nce`` on its sampled ids [B, T + N] (the T
    label columns first): each row's logits against its ids' rows of W
    (and of the bias [V, 1]) less log(N / total), the sigmoid cross
    entropy against 1 for the labels and 0 for the negatives, summed
    over the row. Returns (cost [B, 1], logits [B, T + N])."""
    logits = torch.einsum("bd,btd->bt", x, _take_rows(w, ids))
    if b is not None:
        logits = logits + _take_rows(b.reshape(-1), ids)
    pnoise = torch.full((), float(num_neg) / total, dtype=torch.float32,
                        device=x.device)
    logits = logits - torch.log(pnoise)
    labels01 = torch.cat(
        [torch.ones((x.shape[0], num_true), device=x.device),
         torch.zeros((x.shape[0], num_neg), device=x.device)], 1)
    cost = torch.sum(_sigmoid_ce(logits, labels01), 1, keepdim=True)
    return cost, logits


@op("nce", nondiff_inputs=("Label", "SampleWeight"))
def _nce(ctx, ins, attrs, o):
    """Noise-contrastive estimation (`operators/nce_op.*`) as the JAX
    package lowers it: per-example sampled softmax with uniform noise.
    The draw of the negatives (:func:`nce_draw`, the op's own stream)
    and the arithmetic on the ids (:func:`nce_logits`) are apart: the
    two packages draw other numbers from one seed, and the tests hold
    the arithmetic on the JAX package's ids. The grad op recomputes this
    forward under the forward op's uid, so it draws the same ids.
    ``SampleWeight`` is not read (ROADMAP.md Queue 3)."""
    x, w = ins["Input"][0], ins["Weight"][0]       # [B, D], [V, D]
    label = ins["Label"][0].to(torch.int64)         # [B, num_true]
    if label.dim() == 1:
        label = label[:, None]
    num_neg = attrs.get("num_neg_samples", 10)
    total = attrs.get("num_total_classes", w.shape[0])
    b = ins.get("Bias", [None])[0]
    neg = nce_draw(ctx.rng(), x.shape[0], num_neg, total, x.device)
    ids = torch.cat([label, neg], dim=1)
    cost, logits = nce_logits(x, w, b, ids, label.shape[1], num_neg, total)
    return {"Cost": cost, "SampleLogits": logits,
            "SampleLabels": ids.to(torch.int32)}


@op("hierarchical_sigmoid", nondiff_inputs=("Label",))
def _hierarchical_sigmoid(ctx, ins, attrs, o):
    """The JAX package's simplified hierarchical sigmoid: a complete
    binary tree over ``num_classes`` leaves (leaf c at position C + c,
    internal node n at row n - 1 of W [C - 1, D]), ceil(log2(C)) rounds
    each taking one step to the parent, a sigmoid cross entropy at the
    parent's node against the side the path came from, and rounds past
    the root masked out. ``PreOut`` is ``Out`` (ROADMAP.md Queue 3)."""
    x, w = ins["X"][0], ins["W"][0]
    label = ins["Label"][0].to(torch.int64).reshape(-1)
    num_classes = attrs["num_classes"]
    bias = ins.get("Bias", [None])[0]
    code_len = max(1, math.ceil(math.log2(num_classes)))
    idx = label + num_classes
    loss = torch.zeros((x.shape[0], 1), dtype=x.dtype, device=x.device)
    for _ in range(code_len):
        parent = idx // 2
        bit = (idx % 2).to(x.dtype)
        valid = (parent >= 1) & (parent - 1 < num_classes - 1)
        node = torch.clamp(parent - 1, 0, w.shape[0] - 1)
        logit = torch.sum(x * _RowGather.apply(w, node), -1, keepdim=True)
        if bias is not None:
            logit = logit + _RowGather.apply(bias.reshape(-1), node)[:, None]
        ce = _sigmoid_ce(logit, bit[:, None])
        loss = loss + torch.where(valid[:, None], ce, 0.0)
        idx = parent
    return {"Out": loss, "PreOut": loss}


@op("conv_shift")
def _conv_shift(ctx, ins, attrs, o):
    """Circular convolution (reference `conv_shift_op.cc`, the NTM
    shift): Out[b, i] = sum_j X[b, (i + j - (N-1)/2) mod M] Y[b, j] for
    X [B, M] and an odd-width Y [B, N]. X's N shifted copies are rolls,
    whose backward is a roll: no scatter with duplicates."""
    x, y = ins["X"][0], ins["Y"][0]
    half = (y.shape[1] - 1) // 2
    shifted = torch.stack([torch.roll(x, half - j, dims=1)
                           for j in range(y.shape[1])], dim=-1)
    return {"Out": torch.einsum("bmn,bn->bm", shifted, y)}
