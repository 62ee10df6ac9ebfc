"""Neural-network op lowerings.

Capability parity: reference `conv_op`, `pool_op`, `batch_norm_op`,
`layer_norm_op`, `softmax_op` and `cross_entropy_op`, as the JAX
package's ``ops/nn_ops.py`` lowers them, with its gradient flags.
Convolution and pooling go to the library (``torch.nn.functional``), as
the JAX package leaves them to XLA; an NHWC activation is handed over as
a channels-last view, so no copy is made for the layout. The module's
other ops arrive with later slices.
"""

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core import registry
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


# ---- softmax & losses ----

@op("softmax", seq_map=True)
def _softmax(ctx, ins, attrs, o):
    return torch.softmax(ins["X"][0], dim=attrs.get("axis", -1))


@op("cross_entropy", nondiff_inputs=("Label",), seq_map=True)
def _cross_entropy(ctx, ins, attrs, o):
    """Takes probabilities (post-softmax), like the reference
    `cross_entropy_op` (`operators/cross_entropy_op.cc`)."""
    x, label = ins["X"][0], ins["Label"][0]
    if attrs.get("soft_label", False):
        loss = -torch.sum(label * torch.log(torch.clamp_min(x, 1e-20)), -1,
                          keepdim=True)
    else:
        lab = label.to(torch.int64)
        if lab.dim() == x.dim() and lab.shape[-1] == 1:
            lab = lab.squeeze(-1)
        p = torch.take_along_dim(x, lab[..., None], dim=-1)
        loss = -torch.log(torch.clamp_min(p, 1e-20))
    return {"Y": loss}
