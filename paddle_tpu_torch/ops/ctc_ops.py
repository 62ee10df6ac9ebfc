"""CTC ops: loss, greedy alignment, edit distance.

Capability parity: `operators/warpctc_op.*` (the warp-ctc wrapper),
`operators/ctc_align_op.*` and `operators/edit_distance_op.*`, as the
JAX package's ``ops/ctc_ops.py`` lowers them. The loss is the alpha
recursion in log space over the padded label lattice [B, 2L + 1], one
batched step a frame over the static frame count; its gradient is
autograd's. A label that cannot be aligned in its frames gives a finite
loss near 1e30 (the lattice's floor is -1e30), as in the JAX package,
where warp-ctc returns inf. The blank label is 0 unless the attr
"blank" says otherwise.

Nothing here reads a value on the host, so a CUDA graph captures every
lowering, and the loss's gradient has the same bits from run to run: the
lattice's emissions are gathered by :class:`_EmitGather`, whose backward
adds each frame's duplicate ids (the blanks) in index order through
``core.lower.add_rows`` (the gather's own backward adds them by atomics
on the card, in any order). ``ctc_align`` compacts the kept ids as
``sequence_erase`` does; ``edit_distance`` updates one row of the
dynamic program at a time over the batch and the columns, its insertion
chain a prefix minimum. The integer results are int32 and the distances
float32, as the JAX package returns them with 64-bit types off.
"""

import torch

from paddle_tpu_torch.core.lower import PackedSeq, add_rows
from paddle_tpu_torch.core.registry import op
from paddle_tpu_torch.ops.sequence_ops import compact_rows

_NEG = -1e30


class _EmitGather(torch.autograd.Function):
    """``lp`` [B, T, V] read at ``ext`` [B, S] in every frame: [B, T, S].
    The backward sums the reads of one entry in index order
    (``add_rows``), the same on every run."""

    @staticmethod
    def forward(ctx, lp, ext):
        b, t, v = lp.shape
        idx = ext[:, None, :].expand(b, t, ext.shape[1])
        ctx.save_for_backward(idx)
        ctx.lp_shape = (b, t, v)
        return torch.take_along_dim(lp, idx, dim=2)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        b, t, v = ctx.lp_shape
        rows = torch.arange(b * t, device=g.device).reshape(b, t, 1) * v \
            + idx
        dlp = add_rows(g.new_zeros(b * t * v), rows.reshape(-1),
                       g.reshape(-1))
        return dlp.reshape(b, t, v), None


def ctc_loss(log_probs, logit_lengths, labels, label_lengths, blank=0):
    """log_probs [B, T, V] (log softmax), labels [B, L] padded. Returns
    the per-sequence negative log likelihood [B]."""
    B, T, V = log_probs.shape
    L = labels.shape[1]
    S = 2 * L + 1
    dev = log_probs.device
    # extended label sequence: blank, l1, blank, l2, ... blank
    ext = torch.full((B, S), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = labels.to(torch.int64)
    s_idx = torch.arange(S, device=dev)
    ext_valid = s_idx[None, :] < (2 * label_lengths[:, None] + 1)
    # a step from s - 2 to s skips a blank: only onto a label that
    # differs from the label before that blank
    ext_prev2 = torch.cat([torch.full((B, 2), blank, dtype=torch.int64,
                                      device=dev), ext[:, :-2]], 1)
    skip_ok = (ext != blank) & (ext != ext_prev2) & (s_idx[None, :] >= 2)

    neg = torch.full((B, S), _NEG, dtype=log_probs.dtype, device=dev)
    emit = _EmitGather.apply(log_probs, ext)                 # [B, T, S]
    alpha = torch.where(s_idx[None, :] == 0, emit[:, 0], neg)
    alpha = torch.where((s_idx[None, :] == 1)
                        & (label_lengths[:, None] > 0), emit[:, 0], alpha)
    alphas = [alpha]
    for t in range(1, T):
        prev1 = torch.cat([neg[:, :1], alpha[:, :-1]], 1)
        prev2 = torch.where(skip_ok, torch.cat([neg[:, :2], alpha[:, :-2]],
                                               1), neg)
        new = torch.logaddexp(torch.logaddexp(alpha, prev1), prev2) \
            + emit[:, t]
        alpha = torch.where(ext_valid, new, neg)
        alphas.append(alpha)
    # alpha at each sequence's last frame
    t_last = torch.clamp_min(logit_lengths.to(torch.int64) - 1, 0)
    alpha_last = torch.stack(alphas)[t_last, torch.arange(B, device=dev)]
    s_last = 2 * label_lengths.to(torch.int64)      # the final blank
    final_blank = torch.take_along_dim(alpha_last, s_last[:, None],
                                       dim=1)[:, 0]
    final_label = torch.take_along_dim(
        alpha_last, torch.clamp_min(s_last - 1, 0)[:, None], dim=1)[:, 0]
    final_label = torch.where(label_lengths > 0, final_label, neg[:, 0])
    return -torch.logaddexp(final_blank, final_label)


@op("warpctc", nondiff_inputs=("Label",))
def _warpctc(ctx, ins, attrs, o):
    """Logits PackedSeq [B, T, V] (unnormalised), Label PackedSeq of ids
    [B, L] or [B, L, 1]: the CTC loss [B, 1], divided by each row's
    frame count under ``norm_by_times``. WarpCTCGrad is the loss again,
    as in the JAX package: the gradient comes from autograd."""
    logits, label = ins["Logits"][0], ins["Label"][0]
    if not (isinstance(logits, PackedSeq) and isinstance(label, PackedSeq)):
        raise TypeError("warpctc takes PackedSeq Logits and Label")
    lab = label.data
    if lab.dim() == 3 and lab.shape[-1] == 1:
        lab = lab[:, :, 0]
    log_probs = torch.log_softmax(logits.data, dim=-1)
    loss = ctc_loss(log_probs, logits.lengths, lab, label.lengths,
                    blank=attrs.get("blank", 0))
    if attrs.get("norm_by_times", False):
        loss = loss / torch.clamp_min(logits.lengths.to(loss.dtype), 1.0)
    return {"Loss": loss[:, None], "WarpCTCGrad": loss[:, None]}


@op("ctc_align", no_grad=True)
def _ctc_align(ctx, ins, attrs, o):
    """Greedy CTC decode (operators/ctc_align_op.h): the argmax of each
    frame (the first of tied maxima), repeats merged, blanks dropped,
    the kept ids moved to the front of the row in order."""
    inp = ins["Input"][0]
    if not isinstance(inp, PackedSeq):
        raise TypeError("ctc_align takes a PackedSeq Input")
    blank = attrs.get("blank", 0)
    ids = inp.data
    if ids.dim() == 3:
        ids = torch.argmax(ids, dim=-1) if ids.shape[-1] > 1 \
            else ids[:, :, 0]
    ids = ids.to(torch.int32)
    B, T = ids.shape
    prev = torch.cat([torch.full((B, 1), -1, dtype=torch.int32,
                                 device=ids.device), ids[:, :-1]], 1)
    pos = torch.arange(T, device=ids.device)
    keep = (ids != prev) & (ids != blank) & (pos[None, :]
                                              < inp.lengths[:, None])
    out, new_len = compact_rows(ids, keep)
    return {"Output": PackedSeq(out[:, :, None], new_len)}


def levenshtein(a, la, b, lb):
    """Edit distances [B] float32 between the padded id rows a [B, La]
    (la valid) and b [B, Lb] (lb valid). Row i of the dynamic program,
    over the batch and the columns at once: deletion and substitution
    are elementwise, and the insertion chain new[j] = min_k<=j (c[k] +
    j - k) is j + the running minimum of c[k] - k. A row past la keeps
    the row before it. Entries past lb never reach entry lb, which is
    the answer."""
    B, La = a.shape
    Lb = b.shape[1]
    dev = a.device
    j = torch.arange(Lb + 1, dtype=torch.float32, device=dev)
    row = j.expand(B, Lb + 1)
    for i in range(La):
        cost = (a[:, i:i + 1] != b).to(torch.float32)        # [B, Lb]
        c = torch.cat([row[:, :1] + 1.0,
                       torch.minimum(row[:, 1:] + 1.0, row[:, :-1] + cost)],
                      1)
        new = torch.cummin(c - j, dim=1).values + j
        row = torch.where((la > i)[:, None], new, row)
    return torch.take_along_dim(row, lb.to(torch.int64)[:, None],
                                dim=1)[:, 0]


@op("edit_distance", no_grad=True)
def _edit_distance(ctx, ins, attrs, o):
    """Levenshtein distance of each Hyps row to its Refs row [B, 1],
    divided by the reference's length (at least 1) when ``normalized``;
    SequenceNum is the batch size [1]."""
    hyp, ref = ins["Hyps"][0], ins["Refs"][0]
    if not (isinstance(hyp, PackedSeq) and isinstance(ref, PackedSeq)):
        raise TypeError("edit_distance takes PackedSeq Hyps and Refs")
    h = hyp.data[:, :, 0] if hyp.data.dim() == 3 else hyp.data
    r = ref.data[:, :, 0] if ref.data.dim() == 3 else ref.data
    d = levenshtein(h.to(torch.int32), hyp.lengths, r.to(torch.int32),
                    ref.lengths)
    if attrs.get("normalized", False):
        d = d / torch.clamp_min(ref.lengths.to(d.dtype), 1.0)
    return {"Out": d[:, None],
            "SequenceNum": torch.full((1,), h.shape[0], dtype=torch.int32,
                                      device=h.device)}
