"""Optimizer update ops.

Capability parity: the reference's "optimizers are ops" design
(`operators/adam_op`), as the JAX package's ``ops/optimizer_ops.py``
lowers it. Each op returns the new param/accumulator values under *Out
slots whose var names equal the inputs', and the executor writes them
back to the scope. This slice carries the dense ``adam`` update; the
row-sparse branch and the other optimizers arrive with later slices.
"""

import torch

from paddle_tpu_torch.core.registry import op


def _g(ins, slot):
    return ins[slot][0]


@op("adam", no_grad=True,
    stateful_outputs=("ParamOut", "Moment1Out", "Moment2Out",
                      "Beta1PowOut", "Beta2PowOut"))
def _adam(ctx, ins, attrs, o):
    p, g = _g(ins, "Param"), _g(ins, "Grad")
    m1, m2 = _g(ins, "Moment1"), _g(ins, "Moment2")
    b1p, b2p = _g(ins, "Beta1Pow"), _g(ins, "Beta2Pow")
    lr = _g(ins, "LearningRate").reshape(()).to(torch.float32)
    b1, b2 = attrs.get("beta1", 0.9), attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    lr_t = lr * torch.sqrt(1 - b2p.reshape(())) / (1 - b1p.reshape(()))
    m1n = b1 * m1 + (1 - b1) * g
    m2n = b2 * m2 + (1 - b2) * torch.square(g)
    pn = p - (lr_t * m1n / (torch.sqrt(m2n) + eps)).to(p.dtype)
    return {"ParamOut": pn, "Moment1Out": m1n, "Moment2Out": m2n,
            "Beta1PowOut": b1p * b1, "Beta2PowOut": b2p * b2}
