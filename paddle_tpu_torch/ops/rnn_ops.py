"""Recurrent op lowerings: the LSTM and the GRU over packed sequences,
the single GRU and LSTM steps, and the projected LSTM.

Capability parity: reference `operators/lstm_op.*`, `gru_op.*`,
`gru_unit_op`, `lstm_unit_op`, `lstmp_op`, `math/lstm_compute.*`,
`math/gru_compute.*` and the fused CUDA cell kernels (`math/detail/`),
as the JAX package's ``ops/rnn_ops.py`` lowers ``lstm``, ``gru``,
``gru_unit``, ``lstm_unit`` and ``lstmp``: a static
trip count (the padded max_len), masked for finished sequences. With
the default activations ``lstm`` runs the whole-sequence kernels of
``kernels/lstm_cell.py`` (B3 forward, B4 backward) and ``gru`` those of
``kernels/gru_cell.py`` (B5, B6); other activations run a plain step
loop that autograd differentiates. ``gru_unit``, ``lstm_unit`` and
``lstmp`` are plain PyTorch, as the JAX package runs no kernel for
them.

One deliberate difference from the JAX package: a reverse LSTM or GRU
writes its outputs back to their positions with a gather, not a
scatter. The JAX lowering scatters with ``.at[b, pos].set`` where every
padded step of a short row is clipped to position 0, so those duplicate
writes of 0 can land after the valid value and position 0 of every row
shorter than the batch's longest comes back 0. Reversing a row's valid
prefix is its own inverse, so the same gather, masked by validity, puts
each output where it belongs. The two packages agree everywhere else.
"""

import torch

from paddle_tpu_torch.core.lower import PackedSeq
from paddle_tpu_torch.core.registry import op

_ACT = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "identity": lambda x: x,
}


def _steps(xs, w, h0, c0, valid, peep, act_g, act_c, act_h):
    """Plain step loop for non-default activations (processing order)."""
    h = w.shape[0]
    h_prev, c_prev = h0, c0
    hs, cs = [], []
    for t in range(xs.shape[1]):
        g = xs[:, t] + h_prev @ w
        gi, gc, gf, go = g[:, :h], g[:, h:2 * h], g[:, 2 * h:3 * h], g[:, 3 * h:]
        if peep is not None:
            gi = gi + c_prev * peep[0]
            gf = gf + c_prev * peep[1]
        i_t, f_t = act_g(gi), act_g(gf)
        c_t = f_t * c_prev + i_t * act_c(gc)
        if peep is not None:
            go = go + c_t * peep[2]
        h_t = act_g(go) * act_h(c_t)
        m = valid[:, t, None].to(h_t.dtype)
        h_t = m * h_t + (1 - m) * h_prev
        c_t = m * c_t + (1 - m) * c_prev
        hs.append(h_t)
        cs.append(c_t)
        h_prev, c_prev = h_t, c_t
    return torch.stack(hs, 1), torch.stack(cs, 1)


@op("lstm")
def _lstm(ctx, ins, attrs, o):
    """dynamic_lstm: Input is a PackedSeq of pre-projected gates [B, T, 4H];
    Weight [H, 4H] recurrent; Bias [1, 4H] (+[1, 3H] peephole when
    use_peepholes). Gate order (reference lstm_op): input, cell
    (candidate), forget, output."""
    s = ins["Input"][0]
    w = ins["Weight"][0]
    bias = ins["Bias"][0] if ins.get("Bias") else None
    h = w.shape[0]
    use_peep = attrs.get("use_peepholes", True)
    act_g = _ACT[attrs.get("gate_activation", "sigmoid")]
    act_c = _ACT[attrs.get("cell_activation", "tanh")]
    act_h = _ACT[attrs.get("candidate_activation", "tanh")]
    is_rev = attrs.get("is_reverse", False)

    x = s.data  # [B, T, 4H]
    b_sz = x.shape[0]
    peep = None
    if bias is not None:
        x = x + bias.reshape(-1)[: 4 * h][None, None, :]
        if use_peep and bias.numel() >= 7 * h:
            peep = bias.reshape(-1)[4 * h:].reshape(3, h)

    h0 = ins["H0"][0] if ins.get("H0") and ins["H0"][0] is not None \
        else x.new_zeros((b_sz, h))
    c0 = ins["C0"][0] if ins.get("C0") and ins["C0"][0] is not None \
        else x.new_zeros((b_sz, h))

    valid, gather_pos = _processing_order(s, is_rev)
    xs = torch.take_along_dim(x, gather_pos, dim=1)

    if act_g is torch.sigmoid and act_c is torch.tanh and act_h is torch.tanh:
        from paddle_tpu_torch.kernels.lstm_cell import lstm_sequence

        # the mask and the peepholes enter in float32, as in the JAX
        # package, whatever the compute dtype
        hs, cs = lstm_sequence(
            xs, w, h0, c0, valid.to(torch.float32),
            peep=None if peep is None else peep.to(torch.float32))
    else:
        hs, cs = _steps(xs, w, h0, c0, valid, peep, act_g, act_c, act_h)
    return {"Hidden": PackedSeq(_positional(hs, valid, gather_pos),
                                s.lengths),
            "Cell": PackedSeq(_positional(cs, valid, gather_pos),
                              s.lengths),
            "BatchGate": None, "BatchCellPreAct": None}


def _gru_steps(xs, w, h0, valid, act_g, act_c):
    """Plain step loop for non-default activations (processing order)."""
    h = w.shape[0]
    w_ur, w_c = w[:, :2 * h], w[:, 2 * h:]
    h_prev = h0
    hs = []
    for t in range(xs.shape[1]):
        g = xs[:, t]
        gu = act_g(g[:, :2 * h] + h_prev @ w_ur)
        u, r = gu[:, :h], gu[:, h:]
        c = act_c(g[:, 2 * h:] + (r * h_prev) @ w_c)
        h_t = u * h_prev + (1 - u) * c
        m = valid[:, t, None].to(h_t.dtype)
        h_t = m * h_t + (1 - m) * h_prev
        hs.append(h_t)
        h_prev = h_t
    return torch.stack(hs, 1)


@op("gru")
def _gru(ctx, ins, attrs, o):
    """dynamic_gru: Input PackedSeq [B, T, 3H] pre-projected; Weight
    packed [H, 3H]: first [H, 2H] = update/reset recurrent, last [H, H] =
    candidate recurrent (reference gru_op layout)."""
    s = ins["Input"][0]
    w = ins["Weight"][0]
    h = w.shape[0]
    bias = ins["Bias"][0] if ins.get("Bias") else None
    act_c = _ACT[attrs.get("activation", "tanh")]
    act_g = _ACT[attrs.get("gate_activation", "sigmoid")]

    x = s.data
    if bias is not None:
        x = x + bias.reshape(-1)[None, None, :]
    h0 = ins["H0"][0] if ins.get("H0") and ins["H0"][0] is not None \
        else x.new_zeros((x.shape[0], h))

    valid, gather_pos = _processing_order(s, attrs.get("is_reverse", False))
    xs = torch.take_along_dim(x, gather_pos, dim=1)
    if act_c is torch.tanh and act_g is torch.sigmoid:
        from paddle_tpu_torch.kernels.gru_cell import gru_sequence

        hs = gru_sequence(xs, w, h0, valid.to(torch.float32))
    else:
        hs = _gru_steps(xs, w, h0, valid, act_g, act_c)
    return {"Hidden": PackedSeq(_positional(hs, valid, gather_pos),
                                s.lengths),
            "BatchGate": None, "BatchResetHiddenPrev": None,
            "BatchHidden": None}


def _processing_order(s, is_rev):
    """``(valid [B, T], gather_pos [B, T, 1])``: step i of a row reads
    position gather_pos[b, i] of its valid prefix, forward or (reverse)
    from len-1 down."""
    b_sz, t_len = s.data.shape[0], s.data.shape[1]
    t_order = torch.arange(t_len, device=s.data.device)
    lens = s.lengths.to(torch.int64)[:, None]
    if is_rev:
        pos = lens - 1 - t_order[None, :]
    else:
        pos = t_order[None, :].expand(b_sz, t_len)
    valid = (pos >= 0) & (pos < lens)
    return valid, torch.clamp(pos, 0, max(t_len - 1, 0))[..., None]


def _positional(ys, valid, gather_pos):
    """Back to positional order: valid[b, p] is p < len for either
    direction, and gather_pos maps position p to the step that computed
    it (the reverse map is its own inverse)."""
    return torch.where(valid[..., None],
                       torch.take_along_dim(ys, gather_pos, dim=1), 0.0)


# gru_unit's integer activation codes (reference gru_unit_op)
_ACT_CODE = {0: "identity", 1: "sigmoid", 2: "tanh", 3: "relu"}


@op("gru_unit")
def _gru_unit(ctx, ins, attrs, o):
    """Single GRU step (reference gru_unit_op): Input=[B,3H]
    preactivations, HiddenPrev=[B,H], Weight=[H,3H]. ``activation`` is
    a name or the reference's integer code."""
    x, h_prev, w = ins["Input"][0], ins["HiddenPrev"][0], ins["Weight"][0]
    h = h_prev.shape[-1]
    if ins.get("Bias") and ins["Bias"][0] is not None:
        x = x + ins["Bias"][0].reshape(-1)[None, :]
    act = attrs.get("activation", "tanh")
    act = _ACT[_ACT_CODE.get(act, "tanh") if isinstance(act, int) else act]
    gu_r = x[:, :2 * h] + h_prev @ w[:, :2 * h]
    gates = torch.sigmoid(gu_r)
    u, r = gates[:, :h], gates[:, h:]
    c = act(x[:, 2 * h:] + (r * h_prev) @ w[:, 2 * h:])
    return {"Hidden": u * h_prev + (1 - u) * c, "Gate": gu_r,
            "ResetHiddenPrev": r * h_prev}


@op("lstm_unit")
def _lstm_unit(ctx, ins, attrs, o):
    """Single LSTM step (reference lstm_unit_op): X=[B,4H]
    preactivations in gate order i, f, c, o, C_prev=[B,H] -> C, H;
    ``forget_bias`` is added to f."""
    x, c_prev = ins["X"][0], ins["C_prev"][0]
    fb = attrs.get("forget_bias", 0.0)
    i, f, c, out = torch.chunk(x, 4, dim=-1)
    new_c = c_prev * torch.sigmoid(f + fb) + torch.sigmoid(i) * torch.tanh(c)
    new_h = torch.tanh(new_c) * torch.sigmoid(out)
    return {"C": new_c, "H": new_h}


@op("lstmp")
def _lstmp(ctx, ins, attrs, o):
    """LSTM with a recurrent projection (reference lstmp_op): the hidden
    state H is projected to P dims (ProjWeight [H, P], then
    ``proj_activation``) and the projection is what recurs (Weight
    [P, 4H], gate order i, c, f, o). As in the JAX package the steps run
    forward and without peepholes whatever ``is_reverse`` and
    ``use_peepholes`` say (ROADMAP.md Queue 3); a finished row keeps its
    projection and cell."""
    s = ins["Input"][0]
    w = ins["Weight"][0]
    proj = ins["ProjWeight"][0]
    bias = ins["Bias"][0] if ins.get("Bias") else None
    h = w.shape[1] // 4
    act_g = _ACT[attrs.get("gate_activation", "sigmoid")]
    act_c = _ACT[attrs.get("cell_activation", "tanh")]
    act_h = _ACT[attrs.get("candidate_activation", "tanh")]
    act_p = _ACT[attrs.get("proj_activation", "identity")]
    x = s.data
    if bias is not None:
        x = x + bias.reshape(-1)[None, None, :4 * h]
    valid = s.mask(x.dtype)
    r_prev = x.new_zeros((x.shape[0], proj.shape[1]))
    c_prev = x.new_zeros((x.shape[0], h))
    steps = 1 if ctx.device.type == "meta" else x.shape[1]
    rs, cs = [], []
    for t in range(steps):
        g = x[:, t] + r_prev @ w
        gi, gc, gf, go = torch.chunk(g, 4, dim=-1)
        c_t = act_g(gf) * c_prev + act_g(gi) * act_c(gc)
        r_t = act_p((act_g(go) * act_h(c_t)) @ proj)
        m = valid[:, t, None]
        r_prev = m * r_t + (1 - m) * r_prev
        c_prev = m * c_t + (1 - m) * c_prev
        rs.append(r_prev)
        cs.append(c_prev)
    def stacked(ys):
        if ctx.device.type == "meta":   # shape inference runs one step
            return ys[0].unsqueeze(1).expand(
                (ys[0].shape[0], x.shape[1]) + tuple(ys[0].shape[1:]))
        return torch.stack(ys, 1)

    return {"Projection": PackedSeq(stacked(rs), s.lengths),
            "Cell": PackedSeq(stacked(cs), s.lengths)}
