"""Detection op lowerings: SSD priors, box coding, matching, hard
negatives, NMS, detection mAP, the SSD loss, and ``chunk_eval``.

Capability parity: reference `operators/prior_box_op.cc`,
`box_coder_op.cc`, `bipartite_match_op.cc`, `target_assign_op.cc`,
`mine_hard_examples_op.cc`, `multiclass_nms_op.cc`,
`detection_map_op.cc`, `chunk_eval_op.cc` and the fluid ``ssd_loss``,
as the JAX package's ``ops/detection_ops.py`` lowers them. Every output
keeps the JAX package's fixed shape, padded and counted where the
reference's size depends on the data (kept detections, mined
negatives), so a step reads no value on the host and a CUDA graph
captures it. The sequential parts (the matching rounds, the greedy NMS,
the greedy true-positive assignment) are loops over a static count,
batched over images and classes. Orders follow the JAX package's: the
first maximum wins an argmax, ``jnp.argsort`` is stable, and
``lax.top_k`` puts the lower index first among equal values.
"""

import torch

import numpy as np

from paddle_tpu_torch.core.lower import PackedSeq
from paddle_tpu_torch.core.registry import op
from paddle_tpu_torch.ops.beam_search_ops import top_k_lower_index_first
from paddle_tpu_torch.ops.math_ops import pairwise_iou
from paddle_tpu_torch.ops.nn_ops import _take_label

_NEG = -1e9

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


def _f32(v):
    """A Python float rounded to float32, as jnp rounds a weak constant."""
    return float(np.float32(v))


# ---- prior boxes ----

@op("prior_box", no_grad=True)
def _prior_box(ctx, ins, attrs, o):
    """SSD prior boxes (reference prior_box_op.cc): for each feature-map
    cell one box per (min size, aspect ratio[, max size]) in normalized
    (x1, y1, x2, y2), for each min size the aspect sweep (1 first, then
    each ratio and, under ``flip``, its inverse) and then the max-size
    box. Output [H, W, P, 4] and its variances. Built from the shapes
    with Python constants: no host list goes to the card."""
    feat, img = ins["Input"][0], ins["Image"][0]   # NCHW
    fh, fw = feat.shape[2], feat.shape[3]
    ih, iw = img.shape[2], img.shape[3]
    dev = feat.device
    min_sizes = [float(s) for s in attrs["min_sizes"]]
    max_sizes = [float(s) for s in attrs.get("max_sizes", []) or []]
    ars = [1.0]
    for r in attrs.get("aspect_ratios", []) or []:
        r = float(r)
        if any(abs(r - e) < 1e-6 for e in ars):
            continue
        ars.append(r)
        if attrs.get("flip", False):
            ars.append(1.0 / r)
    step_w = attrs.get("step_w", 0.0) or iw / fw
    step_h = attrs.get("step_h", 0.0) or ih / fh
    offset = attrs.get("offset", 0.5)
    dims = []
    for k, ms in enumerate(min_sizes):
        for r in ars:
            dims.append((ms * (r ** 0.5), ms / (r ** 0.5)))
        if max_sizes:
            s = (ms * max_sizes[k]) ** 0.5
            dims.append((s, s))
    f32 = torch.float32
    cx = (torch.arange(fw, dtype=f32, device=dev) + _f32(offset)) \
        * _f32(step_w)
    cy = (torch.arange(fh, dtype=f32, device=dev) + _f32(offset)) \
        * _f32(step_h)
    cxg, cyg = cx[None, :].expand(fh, fw), cy[:, None].expand(fh, fw)
    boxes = []
    for bw, bh in dims:
        # jnp halves the float32 size: exact, so the constant is too
        bw, bh = _f32(bw) / 2.0, _f32(bh) / 2.0
        boxes.append(torch.stack([(cxg - bw) / iw, (cyg - bh) / ih,
                                  (cxg + bw) / iw, (cyg + bh) / ih], -1))
    boxes = torch.stack(boxes, 2)
    if attrs.get("clip", False):
        boxes = torch.clamp(boxes, 0.0, 1.0)
    var = attrs.get("variances", [0.1, 0.1, 0.2, 0.2])
    variances = torch.stack([torch.full(tuple(boxes.shape[:3]), _f32(v),
                                        dtype=f32, device=dev)
                             for v in var], -1)
    return {"Boxes": boxes, "Variances": variances}


# ---- box coding ----

def _center_form(b):
    w = b[..., 2] - b[..., 0]
    h = b[..., 3] - b[..., 1]
    return b[..., 0] + w / 2, b[..., 1] + h / 2, w, h


@op("box_coder")
def _box_coder(ctx, ins, attrs, o):
    """Encode boxes [N, 4] against the priors [M, 4] into offsets
    [N, M, 4] (``encode_center_size``), or decode offsets [N, M, 4]
    into boxes, each divided (encode) or scaled (decode) by the prior
    variances. Differentiable in every float input, as the JAX op."""
    prior = ins["PriorBox"][0].reshape(-1, 4)
    pvar = ins["PriorBoxVar"][0] if ins.get("PriorBoxVar") and \
        ins["PriorBoxVar"][0] is not None else None
    if pvar is not None and pvar.dim() > 1:
        pvar = pvar.reshape(-1, 4)
    target = ins["TargetBox"][0]
    code = attrs.get("code_type", "encode_center_size")
    pcx, pcy, pw, ph = _center_form(prior)       # [M]
    if pvar is None:
        pvar = torch.ones(prior.shape[-1:], dtype=prior.dtype,
                          device=prior.device)
    pv = pvar.reshape((1, -1, 4) if pvar.dim() == 2 else (1, 1, 4))
    if code.lower().endswith("encode_center_size"):
        tcx, tcy, tw, th = _center_form(target)  # [N]
        dx = (tcx[:, None] - pcx[None, :]) / pw[None, :]
        dy = (tcy[:, None] - pcy[None, :]) / ph[None, :]
        dw = torch.log(torch.clamp_min(tw[:, None] / pw[None, :], 1e-10))
        dh = torch.log(torch.clamp_min(th[:, None] / ph[None, :], 1e-10))
        out = torch.stack([dx, dy, dw, dh], -1) / pv
    else:
        t = target * pv
        cx = t[..., 0] * pw[None, :] + pcx[None, :]
        cy = t[..., 1] * ph[None, :] + pcy[None, :]
        w = torch.exp(t[..., 2]) * pw[None, :]
        h = torch.exp(t[..., 3]) * ph[None, :]
        out = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                          -1)
    return {"OutputBox": out}


# ---- matching ----

def _bipartite(dist):
    """Greedy bipartite matching of [B, N, M], batched over B: min(N, M)
    rounds, each taking every image's global maximum (the first one,
    row-major) while it is positive and striking out its row and
    column. Returns (col2row [B, M] int32, coldist [B, M])."""
    b, n, m = dist.shape
    dev = dist.device
    d = dist
    col2row = torch.full((b, m), -1, dtype=torch.int32, device=dev)
    coldist = torch.zeros((b, m), dtype=dist.dtype, device=dev)
    rows = torch.arange(n, device=dev)[None, :]
    cols = torch.arange(m, device=dev)[None, :]
    for _ in range(min(n, m) if dev.type != "meta" else 0):
        flat = torch.argmax(d.reshape(b, -1), dim=1)
        r = torch.div(flat, m, rounding_mode="floor")
        c = flat % m
        best = torch.gather(d.reshape(b, -1), 1, flat[:, None])  # [B, 1]
        do = best > 0
        at_c = (cols == c[:, None]) & do                          # [B, M]
        col2row = torch.where(at_c, r[:, None].to(torch.int32), col2row)
        coldist = torch.where(at_c, best, coldist)
        strike = ((rows == r[:, None])[:, :, None]
                  | (cols == c[:, None])[:, None, :]) & do[:, :, None]
        d = torch.where(strike, _NEG, d)
    return col2row, coldist


@op("bipartite_match", no_grad=True)
def _bipartite_match(ctx, ins, attrs, o):
    dist = ins["DistMat"][0]
    batched = dist if dist.dim() == 3 else dist[None]
    col2row, coldist = _bipartite(batched)
    if attrs.get("match_type", "bipartite") == "per_prediction":
        thr = attrs.get("dist_threshold", 0.5)
        best, best_row = torch.max(batched, dim=1)  # the first maximum
        fill = (col2row < 0) & (best >= thr)
        col2row = torch.where(fill, best_row.to(torch.int32), col2row)
        coldist = torch.where(fill, best, coldist)
    if dist.dim() == 2:
        col2row, coldist = col2row[0], coldist[0]
    return {"ColToRowMatchIndices": col2row, "ColToRowMatchDist": coldist}


@op("target_assign", no_grad=True)
def _target_assign(ctx, ins, attrs, o):
    """out[b, m] = X[b, match[b, m]] where matched, else
    ``mismatch_value``; OutWeight is 1 where matched."""
    x = ins["X"][0]
    match = ins["MatchIndices"][0].to(torch.int64)   # [B, M]
    xd = x.data if isinstance(x, PackedSeq) else x   # [B, N, K]
    if xd.dim() == 2:
        xd = xd[:, :, None]
    gather = torch.take_along_dim(
        xd, torch.clamp(match, 0, xd.shape[1] - 1)[:, :, None], dim=1)
    matched = (match >= 0)[:, :, None]
    out = torch.where(matched, gather, torch.full(
        (), attrs.get("mismatch_value", 0), dtype=xd.dtype,
        device=xd.device))
    return {"Out": out, "OutWeight": matched.to(torch.float32)}


def _rank_desc(v):
    """Each entry's place when ``v``'s rows are sorted largest first,
    equal values in index order (two stable argsorts, as the JAX
    package ranks)."""
    order = torch.argsort(-v, dim=-1, stable=True)
    return torch.argsort(order, dim=-1, stable=True)


@op("mine_hard_examples", no_grad=True)
def _mine_hard_examples(ctx, ins, attrs, o):
    """Hard-negative mining (reference mine_hard_examples_op): keep the
    highest-loss unmatched priors, up to neg_pos_ratio x the positives
    of the image. The match comes back with selected negatives -1 and
    the other unmatched -2, beside the selection mask."""
    cls_loss = ins["ClsLoss"][0]                        # [B, M]
    match = ins["MatchIndices"][0].to(torch.int32)      # [B, M]
    ratio = attrs.get("neg_pos_ratio", 3.0)
    is_neg = match < 0
    num_pos = torch.sum(~is_neg, dim=1, dtype=torch.int32)
    num_neg = torch.minimum(
        (num_pos.to(torch.float32) * _f32(ratio)).to(torch.int32),
        torch.sum(is_neg, dim=1, dtype=torch.int32))
    rank = _rank_desc(torch.where(is_neg, cls_loss, _NEG))
    selected = is_neg & (rank < num_neg[:, None])
    updated = torch.where(match >= 0, match, torch.where(
        selected, -1, -2).to(torch.int32))
    return {"UpdatedMatchIndices": updated,
            "NegIndices": selected.to(torch.int32)}


# ---- NMS ----

def _nms_keep(boxes, scores, score_thr, iou_thr, top_k):
    """Greedy NMS of every (image, class) row at once: boxes [B, M, 4],
    scores [B, C, M] -> keep [B, C, M]. Each row is ranked by score
    (stable, largest first); a box is kept if its score passes the
    threshold, its rank is under ``top_k`` and no kept box before it
    overlaps it above ``iou_thr``. A box past ``top_k`` is never kept
    and a box not kept suppresses nothing, so the loop walks the first
    ``top_k`` ranks only and keeps the set the JAX package's full scan
    keeps."""
    b, c, m = scores.shape
    k = min(top_k, m) if top_k > 0 else m
    order = torch.argsort(-scores, dim=-1, stable=True)[..., :k]  # [B,C,K]
    s_sorted = torch.gather(scores, 2, order)
    cand = torch.gather(boxes[:, None].expand(b, c, m, 4), 2,
                        order[..., None].expand(b, c, k, 4))
    over = _batched_iou(cand.reshape(b * c, k, 4)) > iou_thr
    over = over.reshape(b, c, k, k)
    valid = s_sorted > score_thr
    keep = torch.zeros_like(valid)
    for i in range(k if boxes.device.type != "meta" else 0):
        sup = torch.any(keep & over[:, :, i], dim=-1)
        keep[:, :, i] = valid[:, :, i] & ~sup
    return torch.zeros((b, c, m), dtype=torch.bool,
                       device=scores.device).scatter(2, order, keep)


def _batched_iou(x):
    """``pairwise_iou`` of each [K, 4] row set with itself: [R, K, K]."""
    def area(v):
        return torch.clamp(v[..., 2] - v[..., 0], min=0) * \
            torch.clamp(v[..., 3] - v[..., 1], min=0)
    xi = torch.maximum(x[:, :, None, 0], x[:, None, :, 0])
    yi = torch.maximum(x[:, :, None, 1], x[:, None, :, 1])
    xa = torch.minimum(x[:, :, None, 2], x[:, None, :, 2])
    ya = torch.minimum(x[:, :, None, 3], x[:, None, :, 3])
    inter = torch.clamp(xa - xi, min=0) * torch.clamp(ya - yi, min=0)
    union = area(x)[:, :, None] + area(x)[:, None, :] - inter
    return inter / torch.clamp(union, min=1e-10)


@op("multiclass_nms", no_grad=True)
def _multiclass_nms(ctx, ins, attrs, o):
    """Per-class NMS, then the ``keep_top_k`` best over all classes
    (reference multiclass_nms_op.cc). Out is a PackedSeq of
    [B, keep_top_k, 6] rows (label, score, x1, y1, x2, y2), zero past
    each image's count, the counts as lengths."""
    boxes, scores = ins["BBoxes"][0], ins["Scores"][0]  # [B,M,4], [B,C,M]
    if boxes.dim() == 2:
        boxes, scores = boxes[None], scores[None]
    b, c, m = scores.shape
    keep = _nms_keep(boxes, scores, attrs.get("score_threshold", 0.0),
                     attrs.get("nms_threshold", 0.3),
                     attrs.get("nms_top_k", -1))
    bg = attrs.get("background_label", 0)
    if 0 <= bg < c:
        keep[:, bg] = False
    keep_top_k = attrs.get("keep_top_k", -1)
    k = min(keep_top_k if keep_top_k > 0 else c * m, c * m)
    flat = torch.where(keep, scores, _NEG).reshape(b, c * m)
    top_s, top_i = top_k_lower_index_first(flat, k)
    cls = torch.div(top_i, m, rounding_mode="floor").to(scores.dtype)
    sel = torch.gather(boxes, 1, (top_i % m)[..., None].expand(b, k, 4))
    valid = top_s > _NEG / 2
    rows = torch.cat([cls[..., None], top_s[..., None], sel], -1)
    rows = torch.where(valid[..., None], rows, 0.0)
    return {"Out": PackedSeq(rows, torch.sum(valid, 1, dtype=torch.int32))}


# ---- metrics ----

def _seq_parts(v):
    if isinstance(v, PackedSeq):
        return v.data, v.lengths
    return v, torch.full((v.shape[0],), v.shape[1], dtype=torch.int32,
                         device=v.device)


@op("detection_map", no_grad=True)
def _detection_map(ctx, ins, attrs, o):
    """Mean average precision at an IoU threshold (reference
    detection_map_op.cc), as the JAX package computes it: in each image
    the detections in score order take, greedily, the unused ground
    truth of their label with the highest IoU if it reaches the
    threshold; then one precision-recall curve over all images and
    classes, AP = sum(precision at each true positive) / positives.
    DetectRes [B, D, 6] rows (label, score, box) and Label [B, G, 5]
    rows (label, box), PackedSeq or dense."""
    ddata, dlens = _seq_parts(ins["DetectRes"][0])
    gdata, glens = _seq_parts(ins["Label"][0])
    thr = attrs.get("overlap_threshold", 0.5)
    b, d = ddata.shape[0], ddata.shape[1]
    g = gdata.shape[1]
    dev = ddata.device
    dvalid = torch.arange(d, device=dev)[None, :] < dlens[:, None]
    gvalid = torch.arange(g, device=dev)[None, :] < glens[:, None]
    order = torch.argsort(-torch.where(dvalid, ddata[..., 1], _NEG), dim=1,
                          stable=True)
    det = torch.gather(ddata, 1, order[..., None].expand(b, d, 6))
    dv = torch.gather(dvalid, 1, order)
    iou = torch.stack([pairwise_iou(det[i, :, 2:6], gdata[i, :, 1:5])
                       for i in range(b)])                    # [B, D, G]
    same = det[..., 0][:, :, None] == gdata[..., 0][:, None, :]
    cand = torch.where(same & gvalid[:, None, :], iou, 0.0)
    used = torch.zeros((b, g), dtype=torch.bool, device=dev)
    tps = torch.zeros((b, d), dtype=torch.bool, device=dev)
    gcols = torch.arange(g, device=dev)[None, :]
    for i in range(d if dev.type != "meta" else 0):
        row = cand[:, i]
        best = torch.argmax(torch.where(used, 0.0, row), dim=1)  # [B]
        at = gcols == best[:, None]
        ok = (torch.gather(row, 1, best[:, None])[:, 0] >= thr) \
            & ~torch.any(used & at, dim=1) & dv[:, i]
        used = used | (at & ok[:, None])
        tps[:, i] = ok
    tps, sc, dv = tps.reshape(-1), det[..., 1].reshape(-1), dv.reshape(-1)
    npos = torch.sum(glens, dtype=torch.int32)
    order = torch.argsort(-torch.where(dv, sc, _NEG), stable=True)
    tp_sorted = (tps & dv)[order].to(torch.float32)
    valid_sorted = dv[order].to(torch.float32)
    ctp = torch.cumsum(tp_sorted, 0)
    cfp = torch.cumsum(valid_sorted, 0) - ctp
    prec = ctp / torch.clamp_min(ctp + cfp, 1.0)
    ap = torch.sum(prec * tp_sorted) / torch.clamp_min(npos, 1)
    return {"MAP": ap.to(torch.float32), "AccumPosCount": npos,
            "AccumTruePos": ctp[-1].to(torch.int32),
            "AccumFalsePos": cfp[-1].to(torch.int32)}


# ---- the SSD loss ----

@op("ssd_loss", nondiff_inputs=("GTBox", "GTLabel", "PriorBox",
                                "PriorBoxVar"))
def _ssd_loss(ctx, ins, attrs, o):
    """Combined SSD localization and confidence loss (reference
    multibox_loss_layer / fluid layers.ssd_loss), as the JAX package
    computes it: each prior matched to the ground truth of highest IoU
    (the first of equals) when that IoU reaches ``overlap_threshold``;
    smooth-L1 between Loc and the matched box encoded against the prior;
    softmax cross-entropy against the matched label, background for
    the unmatched; of the unmatched, the neg_pos_ratio x positives with
    the highest cross-entropy count as negatives, ranked by two stable
    argsorts (ties go to the lower prior, as in the JAX package). A
    padded ground-truth row of zeros has IoU 0 and matches nothing.

    Inputs: Loc [B, M, 4], Conf [B, M, C] logits, GTBox [B, G, 4],
    GTLabel [B, G, 1] (0 is background), PriorBox [M, 4] (or prior_box's
    [H, W, P, 4]), PriorBoxVar [4] or [M, 4]. Loss [B, 1], divided by
    each image's positives (at least 1); differentiable in Loc and Conf
    only."""
    loc, conf = ins["Loc"][0], ins["Conf"][0]
    gtb, gtl = ins["GTBox"][0], ins["GTLabel"][0]
    prior = ins["PriorBox"][0].reshape(-1, 4)
    thr = attrs.get("overlap_threshold", 0.5)
    bg = attrs.get("background_label", 0)
    neg_ratio = attrs.get("neg_pos_ratio", 3.0)
    b, m = loc.shape[0], prior.shape[0]
    pcx, pcy, pw, ph = _center_form(prior)                   # [M]
    pvar = ins["PriorBoxVar"][0].reshape(-1, 4).expand(m, 4)
    # IoU [B, G, M]
    ix1 = torch.maximum(gtb[:, :, None, 0], prior[None, None, :, 0])
    iy1 = torch.maximum(gtb[:, :, None, 1], prior[None, None, :, 1])
    ix2 = torch.minimum(gtb[:, :, None, 2], prior[None, None, :, 2])
    iy2 = torch.minimum(gtb[:, :, None, 3], prior[None, None, :, 3])
    inter = torch.clamp_min(ix2 - ix1, 0) * torch.clamp_min(iy2 - iy1, 0)
    ag = ((gtb[..., 2] - gtb[..., 0]) * (gtb[..., 3] - gtb[..., 1]))[..., None]
    ap = ((prior[:, 2] - prior[:, 0]) * (prior[:, 3] - prior[:, 1]))[None,
                                                                     None]
    iou = inter / torch.clamp_min(ag + ap - inter, 1e-10)
    best_iou, best_gt = torch.max(iou, dim=1)               # [B, M]
    matched = best_iou >= thr
    g = torch.gather(gtb, 1, best_gt[..., None].expand(b, m, 4))
    gcx, gcy, gw, gh = _center_form(g)
    pw_, ph_ = torch.clamp_min(pw, 1e-10), torch.clamp_min(ph, 1e-10)
    enc = torch.stack([
        (gcx - pcx) / pw_ / pvar[:, 0],
        (gcy - pcy) / ph_ / pvar[:, 1],
        torch.log(torch.clamp_min(gw / pw_, 1e-10)) / pvar[:, 2],
        torch.log(torch.clamp_min(gh / ph_, 1e-10)) / pvar[:, 3]], -1)
    dd = torch.abs(loc - enc)
    sl1 = torch.where(dd < 1.0, 0.5 * dd * dd, dd - 0.5).sum(-1)
    loc_loss = torch.sum(sl1 * matched, dim=1)
    lab = torch.gather(gtl.reshape(b, -1).to(torch.int64), 1, best_gt)
    labels = torch.where(matched, lab, bg)
    logp = torch.log_softmax(conf, dim=-1)
    ce = -_take_label(logp, labels)[..., 0]                  # [B, M]
    npos = torch.clamp_min(torch.sum(matched, dim=1, dtype=torch.int32), 1)
    rank = _rank_desc(torch.where(matched, float("-inf"), ce))
    keep_neg = rank < (_f32(neg_ratio) * npos).to(torch.int32)[:, None]
    conf_loss = torch.sum(ce * matched, dim=1) + torch.sum(
        torch.where(keep_neg & ~matched, ce, 0.0), dim=1)
    loss = (loc_loss + conf_loss) / npos.to(loc.dtype)
    return {"Loss": loss[:, None]}
