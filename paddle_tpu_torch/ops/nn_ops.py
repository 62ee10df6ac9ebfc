"""Neural-network op lowerings.

Capability parity: reference `layer_norm_op`, `softmax_op` and
`cross_entropy_op`, as the JAX package's ``ops/nn_ops.py`` lowers them,
with its gradient flags. The module's other ops arrive with later
slices.
"""

import torch

from paddle_tpu_torch.core.registry import op


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
