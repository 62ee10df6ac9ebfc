"""Metric op lowerings.

Capability parity: reference `operators/accuracy_op`, `auc_op`,
`precision_recall_op`, `positive_negative_pair_op` and `mean_iou_op`
(§2.3 "Metrics"), as the JAX package's ``ops/metric_ops.py`` lowers
them. no_grad.

The histograms and per-class counts add 0/1 floats by ``index_add_``,
which adds by atomics on the card. Their order does not matter: a count
is an integer, exact in float32 below 2**24, so the sums have the same
bits from run to run on either device. A class id out of range is
dropped and a negative one wraps once, as jnp's scatter does.
"""

import torch

from paddle_tpu_torch.core.lower import wrap_ids
from paddle_tpu_torch.core.registry import op


@op("accuracy", no_grad=True)
def _accuracy(ctx, ins, attrs, o):
    """Inputs: Out (top-k values), Indices (top-k indices), Label. The
    fraction of rows whose label is among the top-k indices."""
    idx = ins["Indices"][0].to(torch.int64)
    label = ins["Label"][0].to(torch.int64)
    if label.dim() == 2 and label.shape[1] == 1:
        label = label[:, 0]
    hit = torch.any(idx == label[:, None], dim=1)
    acc = torch.mean(hit.to(torch.float32))
    correct = torch.sum(hit.to(torch.int32)).to(torch.int32)
    total = torch.full((), idx.shape[0], dtype=torch.int32,
                       device=idx.device)
    comm = getattr(ctx, "comm", None)
    if comm is not None and comm.global_view and comm.reads_local(o):
        # the global view counts the global batch: the ranks' equal
        # shares make the accuracy the mean of their accuracies
        acc = comm.sum_ranks(acc.reshape(1), "sum").reshape(()) \
            / comm.world
        both = comm.sum_ranks(torch.stack([correct, total]), "sum")
        correct, total = both[0], both[1]
        comm.mark_global(o)
    return {"Accuracy": acc, "Correct": correct, "Total": total}


def _counts(n, ids, vals):
    """[n] float32: ``vals`` added at ``ids`` (``jnp.zeros(n).at[ids].
    add(vals)``), an id out of [-n, n) dropped into a spare slot."""
    idx, ok = wrap_ids(ids.to(torch.int64), n)
    out = torch.zeros(n + 1, dtype=torch.float32, device=ids.device)
    if isinstance(vals, torch.Tensor):
        vals = vals.to(torch.float32)
    else:   # a constant, made on the device (a graph captures no copy)
        vals = torch.full(idx.shape, vals, dtype=torch.float32,
                          device=ids.device)
    return out.index_add_(0, torch.where(ok, idx, n), vals)[:n]


@op("auc", no_grad=True)
def _auc(ctx, ins, attrs, o):
    """AUC from the prediction's positive column by the histogram
    trapezoid: each score falls in bin trunc(score (num_bins - 1)), the
    labels make a positive and a negative histogram, added to the
    streaming ``StatPos``/``StatNeg`` where given; AUC is P(a positive
    scores above a negative), half for a tie in a bin."""
    pred = ins["Predict"][0]
    label = ins["Label"][0].to(torch.float32).reshape(-1)
    scores = pred[:, 1] if pred.dim() == 2 and pred.shape[1] == 2 \
        else pred.reshape(-1)
    num_bins = attrs.get("num_thresholds", 4095) + 1
    bins = torch.clamp((scores * (num_bins - 1)).to(torch.int32), 0,
                       num_bins - 1)
    pos_hist = _counts(num_bins, bins, label)
    neg_hist = _counts(num_bins, bins, 1.0 - label)
    if ins.get("StatPos") and ins["StatPos"][0] is not None:
        pos_hist = pos_hist + ins["StatPos"][0]
        neg_hist = neg_hist + ins["StatNeg"][0]
    neg_below = torch.cumsum(neg_hist, 0) - neg_hist
    auc_num = torch.sum(pos_hist * (neg_below + 0.5 * neg_hist))
    tot = torch.sum(pos_hist) * torch.sum(neg_hist)
    auc = torch.where(tot > 0, auc_num / torch.clamp_min(tot, 1.0), 0.0)
    return {"AUC": auc, "StatPosOut": pos_hist, "StatNegOut": neg_hist}


@op("precision_recall", no_grad=True)
def _precision_recall(ctx, ins, attrs, o):
    """Macro then micro precision, recall and F1 over ``class_number``
    classes from the predicted class ``Indices``, added to the streaming
    ``StatesInfo`` [C, 4] (columns true positive, false positive, -,
    false negative) where given. ``MaxProbs`` is not read and column 2
    stays zero (ROADMAP.md Queue 3)."""
    pred = ins["Indices"][0].to(torch.int64).reshape(-1)
    label = ins["Labels"][0].to(torch.int64).reshape(-1)
    c = attrs["class_number"]
    hit = (pred == label).to(torch.float32)
    tp = _counts(c, label, hit)
    fp = _counts(c, pred, 1.0 - hit)
    fn = _counts(c, label, 1.0 - hit)
    if ins.get("StatesInfo") and ins["StatesInfo"][0] is not None:
        st = ins["StatesInfo"][0]
        tp, fp, fn = tp + st[:, 0], fp + st[:, 1], fn + st[:, 3]
    prec = tp / torch.clamp_min(tp + fp, 1.0)
    rec = tp / torch.clamp_min(tp + fn, 1.0)
    f1 = 2 * prec * rec / torch.clamp_min(prec + rec, 1e-6)
    macro = torch.stack([torch.mean(prec), torch.mean(rec), torch.mean(f1)])
    tps, fps, fns = torch.sum(tp), torch.sum(fp), torch.sum(fn)
    mprec = tps / torch.clamp_min(tps + fps, 1.0)
    mrec = tps / torch.clamp_min(tps + fns, 1.0)
    micro = torch.stack([mprec, mrec, 2 * mprec * mrec
                         / torch.clamp_min(mprec + mrec, 1e-6)])
    metrics = torch.cat([macro, micro])
    return {"BatchMetrics": metrics, "AccumMetrics": metrics,
            "AccumStatesInfo": torch.stack(
                [tp, fp, torch.zeros_like(tp), fn], dim=1)}


@op("positive_negative_pair", no_grad=True)
def _positive_negative_pair(ctx, ins, attrs, o):
    """Over the pairs of one query whose labels differ (the higher label
    first): how many the scores order the same way, the other way, and
    tie."""
    score = ins["Score"][0].reshape(-1)
    label = ins["Label"][0].reshape(-1)
    qid = ins["QueryID"][0].reshape(-1)
    considered = (qid[:, None] == qid[None, :]) & \
        (label[:, None] - label[None, :] > 0)
    s_diff = score[:, None] - score[None, :]

    def count(m):
        return torch.sum((considered & m).to(torch.float32))
    return {"PositivePair": count(s_diff > 0),
            "NegativePair": count(s_diff < 0),
            "NeutralPair": count(s_diff == 0)}


@op("mean_iou", no_grad=True)
def _mean_iou(ctx, ins, attrs, o):
    """The mean over the classes present (a nonzero union) of
    intersection over union; the per-class wrong and correct counts."""
    pred = ins["Predictions"][0].to(torch.int64).reshape(-1)
    label = ins["Labels"][0].to(torch.int64).reshape(-1)
    c = attrs["num_classes"]
    inter = _counts(c, label, (pred == label).to(torch.float32))
    area_p = _counts(c, pred, 1.0)
    area_l = _counts(c, label, 1.0)
    union = area_p + area_l - inter
    iou = inter / torch.clamp_min(union, 1.0)
    valid = (union > 0).to(torch.float32)
    miou = torch.sum(iou * valid) / torch.clamp_min(torch.sum(valid), 1.0)
    return {"OutMeanIou": miou, "OutWrong": area_p - inter,
            "OutCorrect": inter}
