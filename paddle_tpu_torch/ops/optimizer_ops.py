"""Optimizer update ops.

Capability parity: the reference's "optimizers are ops" design
(`operators/adam_op`), as the JAX package's ``ops/optimizer_ops.py``
lowers it. Each op returns the new param/accumulator values under *Out
slots whose var names equal the inputs', and the executor writes them
back to the scope. The dense ``sgd``, ``momentum`` and ``adam`` updates
are here; a row-sparse gradient has no producer in this package yet
(``lookup_table(is_sparse=True)`` raises in its grad), and the other
optimizers arrive with later slices.
"""

import torch

from paddle_tpu_torch.core.registry import op


def _g(ins, slot):
    return ins[slot][0]


def _dense(g, opname):
    if not isinstance(g, torch.Tensor):
        raise NotImplementedError(
            "%s: a row-sparse gradient (%s) arrives with a later slice"
            % (opname, type(g).__name__))
    return g


@op("sgd", no_grad=True, stateful_outputs=("ParamOut",))
def _sgd(ctx, ins, attrs, o):
    p, g = _g(ins, "Param"), _dense(_g(ins, "Grad"), "sgd")
    lr = _g(ins, "LearningRate").reshape(()).to(p.dtype)
    return {"ParamOut": p - lr * g}


@op("momentum", no_grad=True, stateful_outputs=("ParamOut", "VelocityOut"))
def _momentum(ctx, ins, attrs, o):
    p, g = _g(ins, "Param"), _dense(_g(ins, "Grad"), "momentum")
    v = _g(ins, "Velocity")
    lr = _g(ins, "LearningRate").reshape(()).to(p.dtype)
    mu = attrs.get("mu", 0.9)
    v_new = mu * v + g
    if attrs.get("use_nesterov", False):
        p_new = p - lr * (g + mu * v_new)
    else:
        p_new = p - lr * v_new
    return {"ParamOut": p_new, "VelocityOut": v_new}


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
