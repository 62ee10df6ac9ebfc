"""Recurrent op lowerings: the LSTM over packed sequences.

Capability parity: reference `operators/lstm_op.*`,
`math/lstm_compute.*` and the fused CUDA cell kernels (`math/detail/`),
as the JAX package's ``ops/rnn_ops.py`` lowers ``lstm``: a static trip
count (the padded max_len), masked for finished sequences. With the
default activations the op runs the whole-sequence kernels of
``kernels/lstm_cell.py`` (B3 forward, B4 backward); other activations
run a plain step loop that autograd differentiates.

One deliberate difference from the JAX package: a reverse LSTM writes
its outputs back to their positions with a gather, not a scatter. The
JAX lowering scatters with ``.at[b, pos].set`` where every padded step
of a short row is clipped to position 0, so those duplicate writes of 0
can land after the valid value and position 0 of every row shorter than
the batch's longest comes back 0. Reversing a row's valid prefix is its
own inverse, so the same gather, masked by validity, puts each output
where it belongs. The two packages agree everywhere else.
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
    b_sz, t_len = x.shape[0], x.shape[1]
    peep = None
    if bias is not None:
        x = x + bias.reshape(-1)[: 4 * h][None, None, :]
        if use_peep and bias.numel() >= 7 * h:
            peep = bias.reshape(-1)[4 * h:].reshape(3, h)

    h0 = ins["H0"][0] if ins.get("H0") and ins["H0"][0] is not None \
        else x.new_zeros((b_sz, h))
    c0 = ins["C0"][0] if ins.get("C0") and ins["C0"][0] is not None \
        else x.new_zeros((b_sz, h))

    t_order = torch.arange(t_len, device=x.device)
    lens = s.lengths.to(torch.int64)[:, None]
    if is_rev:
        # step i of a row touches position len-1-i of its valid prefix
        pos = lens - 1 - t_order[None, :]
    else:
        pos = t_order[None, :].expand(b_sz, t_len)
    valid = (pos >= 0) & (pos < lens)
    gather_pos = torch.clamp(pos, 0, max(t_len - 1, 0))[..., None]
    xs = torch.take_along_dim(x, gather_pos, dim=1)

    if act_g is torch.sigmoid and act_c is torch.tanh and act_h is torch.tanh:
        from paddle_tpu_torch.kernels.lstm_cell import lstm_sequence

        hs, cs = lstm_sequence(xs, w, h0, c0, valid.to(x.dtype), peep=peep)
    else:
        hs, cs = _steps(xs, w, h0, c0, valid, peep, act_g, act_c, act_h)
    # back to positional order: valid[b, p] is p < len for either
    # direction, and gather_pos maps position p to the step that computed
    # it (the reverse map is its own inverse)
    hs = torch.where(valid[..., None], torch.take_along_dim(hs, gather_pos,
                                                            dim=1), 0.0)
    cs = torch.where(valid[..., None], torch.take_along_dim(cs, gather_pos,
                                                            dim=1), 0.0)
    return {"Hidden": PackedSeq(hs, s.lengths),
            "Cell": PackedSeq(cs, s.lengths),
            "BatchGate": None, "BatchCellPreAct": None}
