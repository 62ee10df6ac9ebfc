"""Expert parallelism: mixture-of-experts with experts sharded over 'ep'.

Capability parity: the JAX package's ``parallel/expert_parallel.py``
(absent in the reference era). Dense dispatch (Mesh-TensorFlow /
Switch-Transformer style), so every shape is static: tokens are routed
top-1 (Switch) or top-k (GShard) with a capacity factor into an
``[E, C, D]`` expert buffer, and the expert FFNs are plain products.

Over a mesh (``ParallelExecutor``'s global view, the ``moe`` op) the
router, the dispatch and the aux loss run in full on every rank of an
ep line, and each rank runs only its own ``E/ep`` experts' FFN
(``w_in``/``w_out`` hold those rows): the tokens enter the local experts
through an identity whose backward sums the cotangents over the ep line,
and the experts' partial outputs leave through a sum over the line whose
backward is the identity (the Megatron pair; the sums are all-gathers
added in rank order, the same bits on every rank). Over a ``(dp, ...)``
mesh a rank holds its rows' tokens, and the capacity and the slot order
stay the global batch's: ``cap = int(cf · T / E)`` of the global T, each
expert's slots offset by the counts of the ranks before it on the dp
line (an exclusive scan of the gathered counts), the aux loss from the
global fractions and mean probabilities.
"""

import torch

from paddle_tpu_torch.parallel.collectives import _sum_rows, gather_line
from paddle_tpu_torch.parallel.mesh import P, Sharding

__all__ = ["switch_moe", "topk_moe", "init_moe_params",
           "moe_param_shardings"]

def init_moe_params(key, d_model, d_ff, num_experts, dtype=torch.float32,
                    place=None):
    """Random MoE parameters from the ``torch.Generator`` ``key`` (the
    JAX package splits a PRNG key three ways; the port draws the three
    in order from the generator, on the generator's own device), put on
    ``place``: None means ``CUDAPlace(0)``, which raises when there is
    no card; pass ``CPUPlace()`` for the CPU."""
    from paddle_tpu_torch.core.place import default_place

    dev = default_place(place)
    s1 = (2.0 / d_model) ** 0.5

    def normal(*shape):
        return torch.randn(shape, generator=key, dtype=dtype,
                           device=key.device).to(dev)

    return {
        "gate": normal(d_model, num_experts) * s1,
        "w_in": normal(num_experts, d_model, d_ff) * s1,
        "w_out": normal(num_experts, d_ff, d_model) * (2.0 / d_ff) ** 0.5,
    }


def moe_param_shardings(mesh, axis="ep"):
    """Shardings placing each expert's FFN on its 'ep' shard."""
    return {
        "gate": Sharding(mesh, P()),
        "w_in": Sharding(mesh, P(axis, None, None)),
        "w_out": Sharding(mesh, P(axis, None, None)),
    }


class Lines:
    """Where a MoE call's tokens and experts live on a mesh: ``ep``
    (group, world, rank) of the rank's ep line, whose rank holds experts
    ``[rank·E/ep, (rank+1)·E/ep)``; ``dp`` (group, world, rank) of its
    dp line, whose rank holds its rows' tokens; ``note(kind, t, wire,
    tag, axis)`` records a collective (a step's census)."""

    def __init__(self, ep=None, dp=None, note=None):
        self.ep = ep if ep is not None and ep[1] > 1 else None
        self.ep_rank = ep[2] if ep is not None else 0
        self.dp = dp if dp is not None and dp[1] > 1 else None
        self.note = note

    def gather(self, t, line, tag, axis):
        """[world, *t.shape]: every rank's ``t`` of ``line``, in order."""
        group, world, _ = line
        return gather_line(t.detach(), group, world, self.note, tag, axis)


class _SumOver(torch.autograd.Function):
    """Forward: the sum over the line's ranks (rank order); backward:
    the identity (each rank's addend's cotangent is the sum's)."""

    @staticmethod
    def forward(ctx, t, lines, line, tag, axis):
        return _sum_rows(lines.gather(t, line, tag, axis))

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None, None


class _Enter(torch.autograd.Function):
    """Forward: the identity; backward: the cotangent summed over the
    line's ranks (the tokens' gradient from every rank's experts)."""

    @staticmethod
    def forward(ctx, t, lines, line, tag, axis):
        ctx.lines, ctx.line, ctx.tag, ctx.axis = lines, line, tag, axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return (_sum_rows(ctx.lines.gather(g, ctx.line, ctx.tag,
                                           ctx.axis)),
                None, None, None, None)


def _one_hot(idx, n, dtype):
    return torch.nn.functional.one_hot(idx.long(), n).to(dtype)


def _dispatch(onehot, claimed, cap, dtype):
    """Capacity-buffer dispatch for one routing choice.

    onehot: [T, E] int assignment; claimed: [E] slots already taken (by
    higher-priority choices and, over a dp line, by the ranks before).
    Returns the [T, E, C] dispatch tensor (zero rows for over-capacity
    assignments)."""
    # 1-based position within the expert's buffer, offset by the slots
    # claimed so far — the offset applies only to the token's OWN expert
    pos = (claimed[None, :] + torch.cumsum(onehot, dim=0)) * onehot
    pos_in_exp = torch.sum(pos, dim=1) - 1                   # [T]
    keep = (pos_in_exp >= 0) & (pos_in_exp < cap)
    disp = (onehot.to(dtype)[:, :, None]
            * _one_hot(torch.clamp(pos_in_exp, 0, cap - 1), cap,
                       dtype)[:, None, :])
    return disp * keep[:, None, None].to(dtype)


def _expert_ffn(params, disp, x):
    """[T,E,C] dispatch -> gather tokens, run expert FFNs, combine."""
    exp_in = torch.einsum("tec,td->ecd", disp, x)            # [E, C, D]
    h = torch.relu(torch.einsum("ecd,edf->ecf", exp_in, params["w_in"]))
    exp_out = torch.einsum("ecf,efd->ecd", h, params["w_out"])
    return torch.einsum("tec,ecd->td", disp, exp_out)


def _counts(lines, oh, tag):
    """(slots the ranks before this one on the dp line claim, the global
    count) of each expert for one choice's [T, E] assignment."""
    n = torch.sum(oh, dim=0)
    if lines is None or lines.dp is None:
        return torch.zeros_like(n), n
    rows = lines.gather(n, lines.dp, tag, "dp")
    before = torch.zeros_like(n)
    for r in range(lines.dp[2]):
        before = before + rows[r]
    return before, _sum_rows(rows)


def _route(params, x, capacity_factor, lines):
    t, d = x.shape
    e = params["gate"].shape[1]
    dpw = lines.dp[1] if lines is not None and lines.dp is not None else 1
    cap = max(1, int(capacity_factor * t * dpw / e))
    logits = x @ params["gate"]                              # [T, E]
    probs = torch.softmax(logits, dim=-1)
    return t, e, dpw, cap, probs


def _aux(probs, onehot1, e, t, dpw, total1, lines, x):
    if lines is None or lines.dp is None:
        frac = torch.mean(onehot1.to(x.dtype), dim=0)       # f_e
        prob_mean = torch.mean(probs, dim=0)                # P_e
    else:
        frac = total1.to(x.dtype) / (t * dpw)
        prob_mean = _SumOver.apply(torch.sum(probs, dim=0), lines,
                                   lines.dp, "moe.aux", "dp") / (t * dpw)
    return e * torch.sum(frac * prob_mean)


def _local_ffns(params, disps, x, lines):
    """Each choice's expert output ([T, D]): over an ep line this rank's
    experts only, their partial outputs summed over the line."""
    if lines is None or lines.ep is None:
        return [_expert_ffn(params, dp_, x) for dp_ in disps]
    el = params["w_in"].shape[0]
    e0 = lines.ep_rank * el
    xin = _Enter.apply(x, lines, lines.ep, "moe.enter", "ep")
    parts = torch.stack([_expert_ffn(params, dp_[:, e0:e0 + el], xin)
                         for dp_ in disps])
    return list(_SumOver.apply(parts, lines, lines.ep, "moe.combine", "ep"))


def switch_moe(params, x, capacity_factor=1.25, lines=None):
    """Top-1 (Switch) MoE over tokens.

    x: [T, D] tokens. Returns (y [T, D], aux_loss) where aux_loss is the
    load-balancing loss (Switch Transformer eq. 4). Tokens over an
    expert's capacity are dropped (pass through the residual path).
    ``lines`` (:class:`Lines`): the mesh placement of the ``moe`` op's
    global view (module docstring)."""
    t, e, dpw, cap, probs = _route(params, x, capacity_factor, lines)
    expert = torch.argmax(probs, dim=-1)                     # [T]
    gate = torch.take_along_dim(probs, expert[:, None], dim=1)[:, 0]

    onehot = _one_hot(expert, e, torch.int32)                # [T, E]
    before, total = _counts(lines, onehot, "moe.counts")
    disp = _dispatch(onehot, before, cap, x.dtype)
    y = _local_ffns(params, [disp], x, lines)[0] * gate[:, None]
    return y, _aux(probs, onehot, e, t, dpw, total, lines, x)


def topk_moe(params, x, k=2, capacity_factor=2.0, lines=None):
    """GShard-style top-k (default top-2) routing.

    x: [T, D]. Gate weights of the k chosen experts are renormalized;
    capacity positions give strict priority to lower-rank choices (all
    first choices claim slots before any second choice — GShard's
    ordering), overflowing assignments are dropped. Returns (y, aux)
    with the same load-balance aux loss as switch_moe computed on the
    top-1 assignment fractions."""
    from paddle_tpu_torch.ops.beam_search_ops import top_k_lower_index_first

    t, e, dpw, cap, probs = _route(params, x, capacity_factor, lines)
    topv, topi = top_k_lower_index_first(probs, k)           # [T, k]
    gates = topv / torch.clamp_min(torch.sum(topv, dim=-1, keepdim=True),
                                   1e-9)

    claimed = torch.zeros((e,), dtype=torch.int32, device=x.device)
    disps, onehot1, total1 = [], None, None
    for j in range(k):
        oh = _one_hot(topi[:, j], e, torch.int32)
        before, total = _counts(lines, oh, "moe.counts")
        if onehot1 is None:
            onehot1, total1 = oh, total
        disps.append(_dispatch(oh, claimed + before, cap, x.dtype))
        claimed = claimed + total
    outs = _local_ffns(params, disps, x, lines)
    y = torch.zeros_like(x)
    for j in range(k):
        y = y + outs[j] * gates[:, j:j + 1]
    return y, _aux(probs, onehot1, e, t, dpw, total1, lines, x)
