"""Detection layers: SSD priors, box coding, matching, NMS, mAP and
the SSD loss.

Capability parity: `python/paddle/fluid/layers/detection.py` over the
detection op group (`operators/{prior_box,box_coder,bipartite_match,
target_assign,multiclass_nms,mine_hard_examples,detection_map}_op.cc`),
as the JAX package's ``layers/detection.py`` builds them: the same ops,
slots and attrs, so both packages write the same program.
"""

from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["prior_box", "box_coder", "iou_similarity", "bipartite_match",
           "detection_output", "ssd_loss",
           "target_assign", "multiclass_nms", "mine_hard_examples",
           "detection_map"]


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, name=None):
    helper = LayerHelper("prior_box", name=name)
    box = helper.create_variable_for_type_inference(input.dtype)
    var = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "prior_box", {"Input": [input], "Image": [image]},
        {"Boxes": [box], "Variances": [var]},
        {"min_sizes": list(min_sizes),
         "max_sizes": list(max_sizes or []),
         "aspect_ratios": list(aspect_ratios), "variances": list(variance),
         "flip": flip, "clip": clip, "step_w": steps[0], "step_h": steps[1],
         "offset": offset})
    return box, var


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True, name=None):
    helper = LayerHelper("box_coder", name=name)
    out = helper.create_variable_for_type_inference(target_box.dtype)
    helper.append_op(
        "box_coder",
        {"PriorBox": [prior_box], "PriorBoxVar": [prior_box_var],
         "TargetBox": [target_box]},
        {"OutputBox": [out]},
        {"code_type": code_type, "box_normalized": box_normalized})
    return out


def iou_similarity(x, y, name=None):
    helper = LayerHelper("iou_similarity", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("iou_similarity", {"X": [x], "Y": [y]}, {"Out": [out]})
    return out


def bipartite_match(dist_matrix, match_type="bipartite",
                    dist_threshold=0.5, name=None):
    helper = LayerHelper("bipartite_match", name=name)
    idx = helper.create_variable_for_type_inference("int32")
    dist = helper.create_variable_for_type_inference(dist_matrix.dtype)
    helper.append_op("bipartite_match", {"DistMat": [dist_matrix]},
                     {"ColToRowMatchIndices": [idx],
                      "ColToRowMatchDist": [dist]},
                     {"match_type": match_type,
                      "dist_threshold": dist_threshold})
    return idx, dist


def target_assign(input, matched_indices, mismatch_value=0, name=None):
    helper = LayerHelper("target_assign", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    w = helper.create_variable_for_type_inference("float32")
    helper.append_op("target_assign",
                     {"X": [input], "MatchIndices": [matched_indices]},
                     {"Out": [out], "OutWeight": [w]},
                     {"mismatch_value": mismatch_value})
    return out, w


def multiclass_nms(bboxes, scores, score_threshold=0.0, nms_top_k=-1,
                   keep_top_k=-1, nms_threshold=0.3, background_label=0,
                   name=None):
    """Returns a PackedSeq [B, keep_top_k, 6] of (label, score, box) rows
    with per-image detection counts as lengths."""
    helper = LayerHelper("multiclass_nms", name=name)
    out = helper.create_variable_for_type_inference(bboxes.dtype)
    helper.append_op("multiclass_nms",
                     {"BBoxes": [bboxes], "Scores": [scores]},
                     {"Out": [out]},
                     {"score_threshold": score_threshold,
                      "nms_top_k": nms_top_k, "keep_top_k": keep_top_k,
                      "nms_threshold": nms_threshold,
                      "background_label": background_label})
    return out


def mine_hard_examples(cls_loss, match_indices, neg_pos_ratio=3.0,
                       name=None):
    helper = LayerHelper("mine_hard_examples", name=name)
    upd = helper.create_variable_for_type_inference("int32")
    neg = helper.create_variable_for_type_inference("int32")
    helper.append_op("mine_hard_examples",
                     {"ClsLoss": [cls_loss],
                      "MatchIndices": [match_indices]},
                     {"UpdatedMatchIndices": [upd], "NegIndices": [neg]},
                     {"neg_pos_ratio": neg_pos_ratio})
    return upd, neg


def detection_map(detect_res, label, overlap_threshold=0.5, name=None):
    helper = LayerHelper("detection_map", name=name)
    m = helper.create_variable_for_type_inference("float32")
    pc = helper.create_variable_for_type_inference("int32")
    tp = helper.create_variable_for_type_inference("int32")
    fp = helper.create_variable_for_type_inference("int32")
    helper.append_op("detection_map",
                     {"DetectRes": [detect_res], "Label": [label]},
                     {"MAP": [m], "AccumPosCount": [pc],
                      "AccumTruePos": [tp], "AccumFalsePos": [fp]},
                     {"overlap_threshold": overlap_threshold})
    return m


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3, nms_top_k=400,
                     keep_top_k=200, score_threshold=0.01, name=None):
    """Decode predicted offsets against the priors and run multiclass NMS
    (reference detection_output_layer / fluid detection_output)."""
    decoded = box_coder(prior_box, prior_box_var, loc,
                        code_type="decode_center_size")
    helper = LayerHelper("detection_output", name=name)
    tr = helper.create_variable_for_type_inference(scores.dtype)
    helper.append_op("transpose", {"X": [scores]}, {"Out": [tr]},
                     {"axis": [0, 2, 1]})
    return multiclass_nms(decoded, tr, score_threshold=score_threshold,
                          nms_top_k=nms_top_k, keep_top_k=keep_top_k,
                          nms_threshold=nms_threshold,
                          background_label=background_label)


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var, background_label=0, overlap_threshold=0.5,
             neg_pos_ratio=3.0, name=None):
    """SSD multibox loss (reference fluid layers.ssd_loss /
    multibox_loss_layer); returns [B, 1] per-image losses."""
    helper = LayerHelper("ssd_loss", name=name)
    out = helper.create_variable_for_type_inference(location.dtype)
    helper.append_op(
        "ssd_loss",
        {"Loc": [location], "Conf": [confidence], "GTBox": [gt_box],
         "GTLabel": [gt_label], "PriorBox": [prior_box],
         "PriorBoxVar": [prior_box_var]},
        {"Loss": [out]},
        {"background_label": background_label,
         "overlap_threshold": overlap_threshold,
         "neg_pos_ratio": neg_pos_ratio})
    return out
