"""Optimizer update ops.

Capability parity: the reference's "optimizers are ops" design
(`operators/sgd_op.cc`, `momentum_op`, `adam_op`, `adagrad_op`), as the
JAX package's ``ops/optimizer_ops.py`` lowers it. Each op returns the
new param/accumulator values under *Out slots whose var names equal the
inputs', and the executor writes them back to the scope. Here are the
dense and row-sparse ``sgd``, ``momentum``, ``adam`` and ``adagrad``
updates; the other optimizers arrive with later slices.

A row-sparse gradient (``RowSparse``, from ``lookup_table(is_sparse=
True)``) updates only its rows: ``sgd`` adds them unmerged, as the JAX
package does; ``momentum`` densifies (its velocity is dense anyway);
``adam`` is lazy and ``adagrad`` rows-only, both over the merged rows
(:func:`_merge_rows`). Every scatter that adds goes through
``core.lower.add_rows``, which adds a row's duplicates in index order on
either device, so an update has the same bits from run to run.
"""

import torch

from paddle_tpu_torch.core.lower import RowSparse, add_rows
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
    that row's value again, and an add is multiplied by ``valid``."""
    k = g.rows.shape[0]
    r, order = torch.sort(g.rows.to(torch.int64), stable=True)
    v = g.values[order]
    newseg = torch.cat([torch.ones(1, dtype=torch.bool, device=r.device),
                        r[1:] != r[:-1]])
    seg = torch.cumsum(newseg, 0) - 1
    merged_v = add_rows(torch.zeros_like(v), seg, v)
    merged_r = torch.zeros_like(r).scatter_reduce_(0, seg, r, "amax")
    pos = torch.arange(k, device=r.device)
    last = seg[-1:]
    idx = torch.minimum(pos, last)
    return merged_r[idx], merged_v[idx], (pos <= last)[:, None]


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
        m1r = b1 * m1[rows] + (1 - b1) * vals
        m2r = b2 * m2[rows] + (1 - b2) * torch.square(vals)
        upd = -(lr_t * m1r / (torch.sqrt(m2r) + eps)).to(p.dtype) * valid
        return {"ParamOut": add_rows(p, rows, upd),
                "Moment1Out": m1.index_put((rows,), m1r),
                "Moment2Out": m2.index_put((rows,), m2r),
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
        upd = -lr * vals / (torch.sqrt(mn[rows]) + eps) * valid
        return {"ParamOut": add_rows(p, rows, upd), "MomentOut": mn}
    mn = m + torch.square(g)
    return {"ParamOut": p - lr * g / (torch.sqrt(mn) + eps), "MomentOut": mn}
