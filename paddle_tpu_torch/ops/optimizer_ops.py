"""Optimizer update ops.

Capability parity: the reference's "optimizers are ops" design
(`operators/sgd_op.cc`, `momentum_op`, `adam_op`, `adagrad_op`,
`decayed_adagrad_op`, `adadelta_op`, `rmsprop_op`, `ftrl_op`,
`adamax_op`, `proximal_gd_op`, `proximal_adagrad_op`,
`average_accumulates_op`) and LAMB, as the JAX package's
``ops/optimizer_ops.py`` lowers them. Each op returns the new
param/accumulator values under *Out slots whose var names equal the
inputs', and the executor writes them back to the scope. Every update
is elementwise PyTorch over the parameter (LAMB adds two norms).

A row-sparse gradient (``RowSparse``, from ``lookup_table(is_sparse=
True)``) updates only its rows: ``sgd`` adds them unmerged, as the JAX
package does; ``momentum`` densifies (its velocity is dense anyway);
``adam`` is lazy and ``adagrad`` rows-only, both over the merged rows
(:func:`_merge_rows`). The other updates have no sparse branch in the
JAX package, and a row-sparse gradient into one raises here too
(:func:`_dense`). Every scatter that adds goes through
``core.lower.add_rows``, which adds a row's duplicates in index order on
either device, so an update has the same bits from run to run.
"""

import torch

from paddle_tpu_torch.core.lower import RowSparse, add_rows, wrap_ids
from paddle_tpu_torch.core.registry import op


def _g(ins, slot):
    return ins[slot][0]


def _merge_rows(g):
    """Sum duplicate rows (reference MergeAdd in selected_rows_functor.cc)
    so nonlinear updates (adagrad's square, adam's moments) see the
    summed gradient per row. Static shapes, no host read: returns
    (rows [K] int64, values [K, ...], valid [K, 1] bool). The JAX
    package marks the tail past the distinct rows with an out-of-bounds
    row that its scatters drop; torch has no dropping scatter, so here
    the tail repeats the last distinct row and its values: a set writes
    that row's value again, and an add is multiplied by ``valid``. A
    negative row wraps once; a row out of range (an embedding id past
    the table) becomes the spare row ``height``, which sorts last, is
    never valid, and which ``_set_rows`` and ``add_rows`` drop, as the
    JAX package's scatters drop it."""
    k, n = g.rows.shape[0], g.height
    idx, ok = wrap_ids(g.rows.to(torch.int64), n)
    r, order = torch.sort(torch.where(ok, idx, n), stable=True)
    v = g.values[order]
    newseg = torch.cat([torch.ones(1, dtype=torch.bool, device=r.device),
                        r[1:] != r[:-1]])
    seg = torch.cumsum(newseg, 0) - 1
    merged_v = add_rows(torch.zeros_like(v), seg, v)
    merged_r = torch.zeros_like(r).scatter_reduce_(0, seg, r, "amax")
    pos = torch.arange(k, device=r.device)
    last = seg[-1:]
    idx = torch.minimum(pos, last)
    rows = merged_r[idx]
    return rows, merged_v[idx], ((pos <= last) & (rows < n))[:, None]


def _get_rows(t, rows):
    """``t[rows]``; the spare row (``rows == len(t)``) reads the last
    row, a value no caller keeps."""
    return t[torch.clamp(rows, max=t.shape[0] - 1)]


def _set_rows(t, rows, vals):
    """``t`` with ``vals`` written to ``rows``, the spare row dropped."""
    ext = torch.cat([t, t.new_zeros((1,) + tuple(t.shape[1:]))])
    ext[rows] = vals
    return ext[:t.shape[0]]


def _rows_like(p, rows, vals):
    return vals.to(p.dtype).reshape((rows.shape[0],) + tuple(p.shape[1:]))


@op("sgd", no_grad=True, stateful_outputs=("ParamOut",))
def _sgd(ctx, ins, attrs, o):
    p, g = _g(ins, "Param"), _g(ins, "Grad")
    lr = _g(ins, "LearningRate").reshape(()).to(p.dtype)
    if isinstance(g, RowSparse):
        # touch only the gradient's rows (reference sgd_op.h SelectedRows
        # branch), duplicates unmerged
        return {"ParamOut": add_rows(
            p, g.rows, -lr * _rows_like(p, g.rows, g.values))}
    return {"ParamOut": p - lr * g}


@op("momentum", no_grad=True, stateful_outputs=("ParamOut", "VelocityOut"))
def _momentum(ctx, ins, attrs, o):
    p, g, v = _g(ins, "Param"), _g(ins, "Grad"), _g(ins, "Velocity")
    if isinstance(g, RowSparse):
        g = g.to_dense().to(p.dtype)  # the velocity is dense anyway
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
    if isinstance(g, RowSparse):
        # lazy sparse adam (reference adam_op.h SelectedRows branch): the
        # moments decay and the parameter moves on the touched rows only
        rows, mvals, valid = _merge_rows(g)
        vals = _rows_like(p, rows, mvals)
        valid = valid.reshape((-1,) + (1,) * (vals.dim() - 1))
        m1r = b1 * _get_rows(m1, rows) + (1 - b1) * vals
        m2r = b2 * _get_rows(m2, rows) + (1 - b2) * torch.square(vals)
        upd = -(lr_t * m1r / (torch.sqrt(m2r) + eps)).to(p.dtype) * valid
        return {"ParamOut": add_rows(p, rows, upd),
                "Moment1Out": _set_rows(m1, rows, m1r),
                "Moment2Out": _set_rows(m2, rows, m2r),
                "Beta1PowOut": b1p * b1, "Beta2PowOut": b2p * b2}
    m1n = b1 * m1 + (1 - b1) * g
    m2n = b2 * m2 + (1 - b2) * torch.square(g)
    pn = p - (lr_t * m1n / (torch.sqrt(m2n) + eps)).to(p.dtype)
    return {"ParamOut": pn, "Moment1Out": m1n, "Moment2Out": m2n,
            "Beta1PowOut": b1p * b1, "Beta2PowOut": b2p * b2}


@op("adagrad", no_grad=True, stateful_outputs=("ParamOut", "MomentOut"))
def _adagrad(ctx, ins, attrs, o):
    p, g, m = _g(ins, "Param"), _g(ins, "Grad"), _g(ins, "Moment")
    lr = _g(ins, "LearningRate").reshape(()).to(p.dtype)
    eps = attrs.get("epsilon", 1e-6)
    if isinstance(g, RowSparse):
        # reference adagrad_op.h SelectedRows branch: merge the duplicate
        # rows, then update those rows only
        rows, mvals, valid = _merge_rows(g)
        vals = _rows_like(p, rows, mvals)
        valid = valid.reshape((-1,) + (1,) * (vals.dim() - 1))
        mn = add_rows(m, rows, torch.square(vals) * valid)
        upd = -lr * vals / (torch.sqrt(_get_rows(mn, rows)) + eps) * valid
        return {"ParamOut": add_rows(p, rows, upd), "MomentOut": mn}
    mn = m + torch.square(g)
    return {"ParamOut": p - lr * g / (torch.sqrt(mn) + eps), "MomentOut": mn}


def _dense(op_type, g):
    """The gradient of an update with no row-sparse form: a
    ``RowSparse`` raises, as in the JAX package, where such an op has
    no sparse branch; it is never made dense here."""
    if isinstance(g, RowSparse):
        raise TypeError(
            "%s takes a dense gradient; a row-sparse one (an embedding "
            "with is_sparse=True) goes to sgd, momentum, adam or adagrad"
            % op_type)
    return g


@op("adamax", no_grad=True,
    stateful_outputs=("ParamOut", "MomentOut", "InfNormOut"))
def _adamax(ctx, ins, attrs, o):
    """The beta1 power moves by the ``scale`` op the optimizer appends."""
    p, g = _g(ins, "Param"), _dense("adamax", _g(ins, "Grad"))
    m, inf = _g(ins, "Moment"), _g(ins, "InfNorm")
    b1p = _g(ins, "Beta1Pow").reshape(())
    lr = _g(ins, "LearningRate").reshape(()).to(p.dtype)
    b1, b2 = attrs.get("beta1", 0.9), attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    mn = b1 * m + (1 - b1) * g
    infn = torch.maximum(b2 * inf, torch.abs(g))
    pn = p - (lr / (1 - b1p)) * mn / (infn + eps)
    return {"ParamOut": pn, "MomentOut": mn, "InfNormOut": infn}


@op("decayed_adagrad", no_grad=True,
    stateful_outputs=("ParamOut", "MomentOut"))
def _decayed_adagrad(ctx, ins, attrs, o):
    p, g = _g(ins, "Param"), _dense("decayed_adagrad", _g(ins, "Grad"))
    m = _g(ins, "Moment")
    lr = _g(ins, "LearningRate").reshape(()).to(p.dtype)
    decay = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    mn = decay * m + (1 - decay) * torch.square(g)
    return {"ParamOut": p - lr * g / (torch.sqrt(mn) + eps),
            "MomentOut": mn}


@op("adadelta", no_grad=True,
    stateful_outputs=("ParamOut", "AvgSquaredGradOut",
                      "AvgSquaredUpdateOut"))
def _adadelta(ctx, ins, attrs, o):
    """No learning rate: the step is sqrt((E[dx^2] + eps) /
    (E[g^2] + eps)) g."""
    p, g = _g(ins, "Param"), _dense("adadelta", _g(ins, "Grad"))
    ag, au = _g(ins, "AvgSquaredGrad"), _g(ins, "AvgSquaredUpdate")
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    agn = rho * ag + (1 - rho) * torch.square(g)
    upd = -torch.sqrt((au + eps) / (agn + eps)) * g
    aun = rho * au + (1 - rho) * torch.square(upd)
    return {"ParamOut": p + upd, "AvgSquaredGradOut": agn,
            "AvgSquaredUpdateOut": aun}


@op("rmsprop", no_grad=True,
    stateful_outputs=("ParamOut", "MomentOut", "MeanSquareOut",
                      "MeanGradOut"))
def _rmsprop(ctx, ins, attrs, o):
    """Centered, the mean gradient moves and its square comes off the
    mean square; not centered, ``MeanGradOut`` is not returned, so the
    mean gradient keeps its value (ROADMAP.md Queue 3)."""
    p, g = _g(ins, "Param"), _dense("rmsprop", _g(ins, "Grad"))
    mom, ms = _g(ins, "Moment"), _g(ins, "MeanSquare")
    lr = _g(ins, "LearningRate").reshape(()).to(p.dtype)
    rho = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    momentum = attrs.get("momentum", 0.0)
    msn = rho * ms + (1 - rho) * torch.square(g)
    mgn = None
    if attrs.get("centered", False):
        mgn = rho * _g(ins, "MeanGrad") + (1 - rho) * g
        denom = msn - torch.square(mgn) + eps
    else:
        denom = msn + eps
    momn = momentum * mom + lr * g * torch.rsqrt(denom)
    out = {"ParamOut": p - momn, "MomentOut": momn, "MeanSquareOut": msn}
    if mgn is not None:
        out["MeanGradOut"] = mgn
    return out


@op("ftrl", no_grad=True,
    stateful_outputs=("ParamOut", "SquaredAccumOut", "LinearAccumOut"))
def _ftrl(ctx, ins, attrs, o):
    """FTRL-proximal with the JAX package's powers: on the first step
    the old accumulator's power is 0 ** -lr_power."""
    p, g = _g(ins, "Param"), _dense("ftrl", _g(ins, "Grad"))
    sq, lin = _g(ins, "SquaredAccumulator"), _g(ins, "LinearAccumulator")
    lr = _g(ins, "LearningRate").reshape(()).to(p.dtype)
    l1, l2 = attrs.get("l1", 0.0), attrs.get("l2", 0.0)
    power = attrs.get("lr_power", -0.5)
    new_sq = sq + torch.square(g)
    sigma = (torch.pow(new_sq, -power) - torch.pow(sq, -power)) / lr
    new_lin = lin + g - sigma * p
    x = l1 * torch.sign(new_lin) - new_lin
    y = torch.pow(new_sq, -power) / lr + 2 * l2
    pn = torch.where(torch.abs(new_lin) > l1, x / y, torch.zeros_like(p))
    return {"ParamOut": pn, "SquaredAccumOut": new_sq,
            "LinearAccumOut": new_lin}


def _proximal(prox, lr, l1, l2):
    return torch.sign(prox) * torch.clamp_min(
        torch.abs(prox) - lr * l1, 0) / (1 + lr * l2)


@op("proximal_gd", no_grad=True, stateful_outputs=("ParamOut",))
def _proximal_gd(ctx, ins, attrs, o):
    p, g = _g(ins, "Param"), _dense("proximal_gd", _g(ins, "Grad"))
    lr = _g(ins, "LearningRate").reshape(()).to(p.dtype)
    return {"ParamOut": _proximal(p - lr * g, lr, attrs.get("l1", 0.0),
                                  attrs.get("l2", 0.0))}


@op("proximal_adagrad", no_grad=True,
    stateful_outputs=("ParamOut", "MomentOut"))
def _proximal_adagrad(ctx, ins, attrs, o):
    p, g = _g(ins, "Param"), _dense("proximal_adagrad", _g(ins, "Grad"))
    m = _g(ins, "Moment")
    lr = _g(ins, "LearningRate").reshape(()).to(p.dtype)
    mn = m + torch.square(g)
    lr_t = lr * torch.rsqrt(mn)
    return {"ParamOut": _proximal(p - lr_t * g, lr_t, attrs.get("l1", 0.0),
                                  attrs.get("l2", 0.0)),
            "MomentOut": mn}


@op("lamb", no_grad=True,
    stateful_outputs=("ParamOut", "Moment1Out", "Moment2Out",
                      "Beta1PowOut", "Beta2PowOut"))
def _lamb(ctx, ins, attrs, o):
    """LAMB: Adam's bias-corrected step plus weight decay, scaled by the
    trust ratio ||p|| / ||r|| (1 where either norm is 0). The beta
    powers move here, 0-d as the JAX package leaves them."""
    p, g = _g(ins, "Param"), _dense("lamb", _g(ins, "Grad"))
    m1, m2 = _g(ins, "Moment1"), _g(ins, "Moment2")
    b1p = _g(ins, "Beta1Pow").reshape(())
    b2p = _g(ins, "Beta2Pow").reshape(())
    lr = _g(ins, "LearningRate").reshape(()).to(torch.float32)
    b1, b2 = attrs.get("beta1", 0.9), attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-6)
    wd = attrs.get("weight_decay", 0.01)
    m1n = b1 * m1 + (1 - b1) * g
    m2n = b2 * m2 + (1 - b2) * torch.square(g)
    r = (m1n / (1 - b1p)) / (torch.sqrt(m2n / (1 - b2p)) + eps) + wd * p
    w_norm = torch.sqrt(torch.sum(torch.square(p)))
    r_norm = torch.sqrt(torch.sum(torch.square(r)))
    trust = torch.where(w_norm > 0, torch.where(r_norm > 0, w_norm / r_norm,
                                                1.0), 1.0)
    return {"ParamOut": p - lr * trust * r, "Moment1Out": m1n,
            "Moment2Out": m2n, "Beta1PowOut": b1p * b1,
            "Beta2PowOut": b2p * b2}


@op("average_accumulates", no_grad=True,
    stateful_outputs=("out_sum_1", "out_sum_2", "out_sum_3",
                      "out_num_accumulates", "out_old_num_accumulates",
                      "out_num_updates"))
def _average_accumulates(ctx, ins, attrs, o):
    """The JAX package's simplified ModelAverage support
    (`operators/average_accumulates_op`): one running sum and the
    counters move; ``sum_2``, ``sum_3`` and the old count pass through
    (ROADMAP.md Queue 3)."""
    return {
        "out_sum_1": _g(ins, "in_sum_1") + _g(ins, "param"),
        "out_sum_2": _g(ins, "in_sum_2"),
        "out_sum_3": _g(ins, "in_sum_3"),
        "out_num_accumulates": _g(ins, "in_num_accumulates") + 1,
        "out_old_num_accumulates": _g(ins, "in_old_num_accumulates"),
        "out_num_updates": _g(ins, "in_num_updates") + 1,
    }
