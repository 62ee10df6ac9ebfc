"""Detection and evaluation op lowerings: ``chunk_eval`` so far.

Capability parity: reference `operators/chunk_eval_op.cc`, as the JAX
package's ``ops/detection_ops.py`` lowers it (batched over rows, with
the chunk match walked over time). The module's other ops (box coding,
prior boxes, NMS, the SSD loss, detection mAP) arrive with later slices
(ROADMAP.md).
"""

import torch

from paddle_tpu_torch.core.lower import PackedSeq
from paddle_tpu_torch.core.registry import op

_N_TAG = {"plain": 1, "IOB": 2, "IOE": 2, "IOBES": 4}


@op("chunk_eval", no_grad=True)
def _chunk_eval(ctx, ins, attrs, o):
    """Chunking precision/recall/F1 (reference chunk_eval_op.cc). Tags
    encode (chunk_type, tag) as type * num_tag_types + tag; tag order per
    scheme: plain (the tag IS the type), IOB (B=0, I=1), IOE (I=0, E=1),
    IOBES (B=0, I=1, E=2, S=3). -1 and padding are outside; excluded
    chunk types count as outside. The counts are int32 and the rates
    float32, as the JAX package returns them."""
    scheme = attrs.get("chunk_scheme", "IOB")
    n_tag = _N_TAG[scheme]
    dev = ctx.device

    def prep(x):
        d = x.data if isinstance(x, PackedSeq) else x
        lens = x.lengths if isinstance(x, PackedSeq) else torch.full(
            (d.shape[0],), d.shape[1], dtype=torch.int32, device=d.device)
        return d.reshape(d.shape[0], -1).to(torch.int32), lens

    di, li = prep(ins["Inference"][0])
    dl, ll = prep(ins["Label"][0])
    t = torch.arange(di.shape[1], device=di.device)
    excluded = torch.tensor(
        list(attrs.get("excluded_chunk_types", []) or [-12345]),
        dtype=torch.int32, device=dev)

    def shift_right(v, fill):
        return torch.cat([torch.full_like(v[:, :1], fill), v[:, :-1]], 1)

    def shift_left(v, fill):
        return torch.cat([v[:, 1:], torch.full_like(v[:, :1], fill)], 1)

    def chunk_arrays(tags, lens):
        valid = t[None, :] < lens[:, None]
        tags = torch.where(valid, tags, -1)
        typ = torch.where(tags >= 0, torch.div(tags, n_tag,
                                               rounding_mode="floor"), -1)
        tags = torch.where(torch.isin(typ, excluded), -1, tags)
        typ = torch.where(tags >= 0, typ, -1)
        tag = torch.where(tags >= 0, tags % n_tag, -1)
        inside = tags >= 0
        prev_typ = shift_right(typ, -1)
        prev_tag = shift_right(tag, -1)
        boundary = (prev_typ != typ) | ~shift_right(inside, False)
        if scheme == "plain":
            start = inside & boundary
        elif scheme == "IOB":
            start = inside & ((tag == 0) | boundary)
        elif scheme == "IOE":
            # chunks run ...I I E; a new chunk begins after an E or at a
            # type boundary
            start = inside & (boundary | (prev_tag == 1))
        else:  # IOBES
            start = inside & ((tag == 0) | (tag == 3) | boundary)
        # a chunk ends where the next position does not continue it
        end = inside & (shift_left(start, True) | ~shift_left(inside, False))
        if scheme == "IOE":
            end = end | (inside & (tag == 1))
        elif scheme == "IOBES":
            end = end | (inside & ((tag == 2) | (tag == 3)))
        return start, end, typ

    si, ei, ti = chunk_arrays(di, li)
    sl, el, tl = chunk_arrays(dl, ll)

    # a chunk matches iff both start here with the same type and both
    # end together: walk over time carrying "still matching"
    open_match = torch.zeros(si.shape[0], dtype=torch.bool, device=si.device)
    correct = torch.zeros((), dtype=torch.int32, device=si.device)
    steps = min(si.shape[1], 1) if dev.type == "meta" else si.shape[1]
    for k in range(steps):
        starts = si[:, k] & sl[:, k] & (ti[:, k] == tl[:, k])
        open_match = torch.where(si[:, k] | sl[:, k], starts, open_match)
        both_end = ei[:, k] & el[:, k]
        one_end = ei[:, k] ^ el[:, k]
        correct = correct + torch.sum(open_match & both_end,
                                      dtype=torch.int32)
        open_match = open_match & ~both_end & ~one_end
    n_inf = torch.sum(si, dtype=torch.int32)
    n_lab = torch.sum(sl, dtype=torch.int32)
    prec = correct / torch.clamp(n_inf, min=1)
    rec = correct / torch.clamp(n_lab, min=1)
    f1 = 2 * prec * rec / torch.clamp(prec + rec, min=1e-6)
    return {"Precision": prec.to(torch.float32),
            "Recall": rec.to(torch.float32),
            "F1-Score": f1.to(torch.float32),
            "NumInferChunks": n_inf, "NumLabelChunks": n_lab,
            "NumCorrectChunks": correct}
