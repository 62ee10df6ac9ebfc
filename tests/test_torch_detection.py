"""The detection family in the port against the JAX package, on the
CPU, from the same numpy inputs:

* the 8 detection types (``prior_box``, ``box_coder``,
  ``bipartite_match``, ``target_assign``, ``mine_hard_examples``,
  ``multiclass_nms``, ``detection_map``, ``ssd_loss``) against the JAX
  lowerings at the bounds of ``tests/torch_dense_harness.py``: floats
  within rtol 1e-5 plus 1e-6 of the largest magnitude, integers, kept
  sets and matches exact; ``box_coder``'s and ``ssd_loss``'s gradients
  against ``jax.vjp``; ties in the mining and NMS ranks, and among
  background priors in ``ssd_loss``, go as the JAX package's stable
  argsorts and ``lax.top_k`` send them;
* ``tests/test_detection.py``'s known answers through the port's layers
  and ``Executor``;
* the SSD program (``chip_smoke.ssd_build``, the one function the card
  runs at full width) at a reduced width (a 64x64 input, widths / 16,
  the first three source maps: 376 priors) builds byte-identical JSON,
  main, startup and the evaluation clone; from the JAX startup's weights
  (``interop.load_reference_state``) its Momentum steps give the JAX
  package's losses within rtol 1e-5 (see ``test_ssd_momentum_steps``
  for the mining's ranks); and ``detection_output`` and
  ``detection_map`` on the trained weights give the JAX package's rows
  and mAP;
* the JAX package's NHWC layout pass refuses the SSD program (ROADMAP.md
  Queue 3), so the card trains it in config B."""

import json
import os
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import registry as jreg
from paddle_tpu_torch import interop
from paddle_tpu_torch.core import registry as treg
from torch_dense_harness import check, run_jax, run_port, seq

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, os.cpu_count() // int(_WORKERS)))

CPU = tfluid.CPUPlace()
R = np.random.RandomState(5)
TYPES = ["prior_box", "box_coder", "bipartite_match", "target_assign",
         "mine_hard_examples", "multiclass_nms", "detection_map",
         "ssd_loss"]


def _boxes(*lead):
    a = np.sort(R.rand(*lead, 2, 2), -2)
    return np.concatenate([a[..., 0, :], a[..., 1, :]], -1).astype(
        np.float32)


def _ssd_inputs(b, m, c, g, ties=False):
    prior = _boxes(m)
    gt = np.concatenate([prior[R.randint(0, m, (b, g))]
                         + R.randn(b, g, 4).astype(np.float32) * 0.02], 0)
    gt[1, -1] = 0.0                      # a padded ground-truth row
    conf = R.randn(b, m, c).astype(np.float32)
    if ties:
        conf[:, ::2] = 0.5               # equal logits: equal background ce
    return {"Loc": [R.randn(b, m, 4).astype(np.float32) * 0.2],
            "Conf": [conf], "GTBox": [gt.astype(np.float32)],
            "GTLabel": [R.randint(1, c, (b, g, 1)).astype(np.int32)],
            "PriorBox": [prior],
            "PriorBoxVar": [np.array([.1, .1, .2, .2], np.float32)]}


def _det_rows(b, d, g):
    """detection_map inputs: detections near the ground truth (their
    labels) and elsewhere, scores with ties."""
    gtb = _boxes(b, g)
    gl = R.randint(1, 4, (b, g, 1)).astype(np.float32)
    pick = R.randint(0, g, (b, d))
    near = np.take_along_axis(gtb, pick[..., None], 1) + \
        R.randn(b, d, 4).astype(np.float32) * 0.03
    lab = np.take_along_axis(gl, pick[..., None], 1)
    far = R.rand(b, d, 1) < 0.3
    box = np.where(far, _boxes(b, d), near)
    score = np.round(R.rand(b, d, 1), 1)
    return (np.concatenate([lab, score, box], -1).astype(np.float32),
            np.concatenate([gl, gtb], -1).astype(np.float32))


DET, GT = _det_rows(3, 12, 5)
PRIOR_ATTRS = {"min_sizes": [8.0], "max_sizes": [16.0],
               "aspect_ratios": [2.0], "flip": True, "clip": True,
               "variances": [0.1, 0.1, 0.2, 0.2], "step_w": 0.0,
               "step_h": 0.0, "offset": 0.5}

CASES = [
    ("prior_box", "prior_box", {"Input": [np.zeros((1, 8, 4, 4),
                                                   np.float32)],
                                "Image": [np.zeros((1, 3, 32, 32),
                                                   np.float32)]},
     PRIOR_ATTRS),
    ("prior_box_ssd300_fc7", "prior_box",
     {"Input": [np.zeros((1, 8, 19, 19), np.float32)],
      "Image": [np.zeros((1, 3, 300, 300), np.float32)]},
     dict(PRIOR_ATTRS, min_sizes=[60.0], max_sizes=[111.0],
          aspect_ratios=[2.0, 3.0], clip=False)),
    ("box_coder_encode", "box_coder", {
        "PriorBox": [_boxes(5)], "PriorBoxVar": [np.full((5, 4), 0.1,
                                                         np.float32)],
        "TargetBox": [_boxes(3)]}, {"code_type": "encode_center_size"}),
    ("box_coder_decode", "box_coder", {
        "PriorBox": [_boxes(5)],
        "PriorBoxVar": [np.array([.1, .1, .2, .2], np.float32)],
        "TargetBox": [R.randn(2, 5, 4).astype(np.float32) * 0.3]},
     {"code_type": "decode_center_size"}),
    ("bipartite_match", "bipartite_match", {"DistMat": [np.array(
        [[0.9, 0.4, 0.1], [0.8, 0.7, 0.2]], np.float32)]}, {}),
    ("bipartite_match_batched", "bipartite_match",
     {"DistMat": [R.rand(3, 4, 7).astype(np.float32)]}, {}),
    ("bipartite_match_ties_per_prediction", "bipartite_match",
     {"DistMat": [np.round(R.rand(2, 5, 6), 1).astype(np.float32)]},
     {"match_type": "per_prediction", "dist_threshold": 0.5}),
    ("target_assign", "target_assign", {
        "X": [np.arange(12, dtype=np.float32).reshape(1, 3, 4)],
        "MatchIndices": [np.array([[1, -1, 2, 0]], np.int32)]},
     {"mismatch_value": -9}),
    ("target_assign_packed", "target_assign", {
        "X": [seq(R.randn(2, 4, 3).astype(np.float32), [4, 2])],
        "MatchIndices": [R.randint(-1, 4, (2, 6)).astype(np.int32)]}, {}),
    ("mine_hard_examples", "mine_hard_examples", {
        "ClsLoss": [np.array([[0.9, 0.1, 0.5, 0.7, 0.3]], np.float32)],
        "MatchIndices": [np.array([[2, -1, -1, -1, -1]], np.int32)]},
     {"neg_pos_ratio": 2.0}),
    ("mine_hard_examples_ties", "mine_hard_examples", {
        "ClsLoss": [np.round(R.rand(3, 20), 1).astype(np.float32)],
        "MatchIndices": [R.randint(-1, 3, (3, 20)).astype(np.int32)]},
     {"neg_pos_ratio": 3.0}),
    ("multiclass_nms", "multiclass_nms", {
        "BBoxes": [np.array([[[0, 0, 1, 1], [0, 0, 1.05, 1.05],
                              [2, 2, 3, 3]]], np.float32)],
        "Scores": [np.array([[[0, 0, 0], [0.9, 0.8, 0.7]]], np.float32)]},
     {"score_threshold": 0.1, "nms_threshold": 0.5, "keep_top_k": 5}),
    ("multiclass_nms_top_k", "multiclass_nms", {
        "BBoxes": [_boxes(2, 30)], "Scores": [R.rand(2, 4, 30).astype(
            np.float32)]},
     {"score_threshold": 0.05, "nms_threshold": 0.3, "nms_top_k": 10,
      "keep_top_k": 12, "background_label": 0}),
    ("multiclass_nms_ties", "multiclass_nms", {
        "BBoxes": [_boxes(2, 30)], "Scores": [np.round(R.rand(
            2, 4, 30), 1).astype(np.float32)]},
     {"score_threshold": 0.05, "nms_threshold": 0.45, "nms_top_k": -1,
      "keep_top_k": -1, "background_label": -1}),
    ("detection_map", "detection_map", {"DetectRes": [seq(DET, [12, 7, 0])],
                                        "Label": [seq(GT, [5, 3, 4])]},
     {"overlap_threshold": 0.5}),
    ("detection_map_dense", "detection_map", {"DetectRes": [DET],
                                              "Label": [GT]},
     {"overlap_threshold": 0.3}),
    ("ssd_loss", "ssd_loss", _ssd_inputs(2, 40, 4, 3), {
        "overlap_threshold": 0.5, "neg_pos_ratio": 3.0,
        "background_label": 0}),
    ("ssd_loss_background_ties", "ssd_loss", _ssd_inputs(3, 60, 5, 4, True),
     {"overlap_threshold": 0.4, "neg_pos_ratio": 2.0,
      "background_label": 0}),
]


@pytest.mark.parametrize("name,type,ins,attrs", CASES,
                         ids=[c[0] for c in CASES])
def test_detection_type_matches_the_jax_lowering(name, type, ins, attrs):
    check(type, ins, attrs)


def test_the_cases_cover_the_8_types_with_the_jax_flags():
    assert sorted({c[1] for c in CASES}) == sorted(TYPES)
    for t in TYPES:
        j, p = jreg.get(t), treg.get(t)
        assert (j.no_grad, tuple(j.nondiff_inputs)) == \
            (p.no_grad, tuple(p.nondiff_inputs)), t


def test_the_ties_are_there():
    """The tie cases tie where the order matters: equal losses among the
    negatives, equal scores among NMS candidates."""
    loss = CASES[10][2]["ClsLoss"][0]
    assert any(len(set(r)) < len(r) for r in loss)
    got = run_port("mine_hard_examples", CASES[10][2], CASES[10][3])
    want = run_jax("mine_hard_examples", CASES[10][2], CASES[10][3])
    np.testing.assert_array_equal(got["NegIndices"][0],
                                  want["NegIndices"][0])
    scores = CASES[13][2]["Scores"][0]
    assert len(np.unique(scores)) < scores.size // 4


# ---- tests/test_detection.py's known answers through the layers ----

def _run(build, feed=None):
    prog, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(prog, startup):
        fetches = build()
    exe = tfluid.Executor(CPU)
    exe.run(startup)
    return exe.run(prog, feed=feed or {}, fetch_list=list(fetches),
                   return_numpy=False)


def _np(v):
    return (v.data if isinstance(v, tfluid.PackedSeq) else v).numpy()


def test_prior_box_known_answer():
    det, layers = tfluid.layers.detection, tfluid.layers
    box, var = _run(lambda: det.prior_box(
        layers.data("feat", [8, 4, 4]), layers.data("img", [3, 32, 32]),
        min_sizes=[8.0], max_sizes=[16.0], aspect_ratios=[2.0], flip=True,
        clip=True), {"feat": np.zeros((1, 8, 4, 4), np.float32),
                     "img": np.zeros((1, 3, 32, 32), np.float32)})
    box, var = _np(box), _np(var)
    assert box.shape == var.shape == (4, 4, 4, 4)
    assert (box >= 0).all() and (box <= 1).all()
    assert abs((box[0, 0, 0, 0] + box[0, 0, 0, 2]) / 2 - 4.0 / 32.0) < 1e-6
    np.testing.assert_allclose(var[0, 0, 0], [0.1, 0.1, 0.2, 0.2])


def test_box_coder_round_trip():
    det, layers = tfluid.layers.detection, tfluid.layers
    prior = np.array([[0.1, 0.1, 0.5, 0.5], [0.3, 0.3, 0.9, 0.8]],
                     np.float32)
    pvar = np.full((2, 4), 0.1, np.float32)
    target = np.array([[0.12, 0.2, 0.5, 0.6], [0.3, 0.3, 0.7, 0.8],
                       [0.1, 0.1, 0.3, 0.3]], np.float32)
    enc, = _run(lambda: (det.box_coder(
        layers.data("p", [4]), layers.data("v", [4]), layers.data("t", [4]),
        "encode_center_size"),), {"p": prior, "v": pvar, "t": target})
    assert _np(enc).shape == (3, 2, 4)
    dec, = _run(lambda: (det.box_coder(
        layers.data("p", [4]), layers.data("v", [4]),
        layers.data("t", [-1, 4]), "decode_center_size"),),
        {"p": prior, "v": pvar, "t": _np(enc)})
    np.testing.assert_allclose(_np(dec), np.broadcast_to(
        target[:, None, :], (3, 2, 4)), atol=1e-5)


def test_matching_assignment_and_mining_known_answers():
    det, layers = tfluid.layers.detection, tfluid.layers
    idx, dv = _run(lambda: det.bipartite_match(layers.data("d", [3])),
                   {"d": np.array([[0.9, 0.4, 0.1], [0.8, 0.7, 0.2]],
                                  np.float32)})
    np.testing.assert_array_equal(_np(idx), [0, 1, -1])
    np.testing.assert_allclose(_np(dv), [0.9, 0.7, 0.0], atol=1e-6)
    idx, _ = _run(lambda: det.bipartite_match(
        layers.data("d", [3]), match_type="per_prediction",
        dist_threshold=0.5), {"d": np.array([[0.9, 0.4, 0.6],
                                             [0.8, 0.7, 0.2]], np.float32)})
    np.testing.assert_array_equal(_np(idx), [0, 1, 0])
    x = np.arange(12, dtype=np.float32).reshape(1, 3, 4)
    out, w = _run(lambda: det.target_assign(
        layers.data("x", [3, 4]), layers.data("m", [4], dtype="int32"),
        mismatch_value=-9), {"x": x, "m": np.array([[1, -1, 2, 0]],
                                                   np.int32)})
    np.testing.assert_allclose(_np(out)[0, 0], x[0, 1])
    assert (_np(out)[0, 1] == -9).all()
    np.testing.assert_allclose(_np(w)[0, :, 0], [1, 0, 1, 1])
    upd, neg = _run(lambda: det.mine_hard_examples(
        layers.data("l", [5]), layers.data("m", [5], dtype="int32"),
        neg_pos_ratio=2.0), {"l": np.array([[0.9, 0.1, 0.5, 0.7, 0.3]],
                                           np.float32),
                             "m": np.array([[2, -1, -1, -1, -1]], np.int32)})
    np.testing.assert_array_equal(_np(neg)[0], [0, 0, 1, 1, 0])
    np.testing.assert_array_equal(_np(upd)[0], [2, -2, -1, -1, -2])


def test_nms_and_map_known_answers():
    det, layers = tfluid.layers.detection, tfluid.layers
    scores = np.zeros((1, 2, 3), np.float32)
    scores[0, 1] = [0.9, 0.8, 0.7]
    out, = _run(lambda: (det.multiclass_nms(
        layers.data("b", [3, 4]), layers.data("s", [2, 3]),
        score_threshold=0.1, nms_threshold=0.5, keep_top_k=5),),
        {"b": np.array([[[0, 0, 1, 1], [0, 0, 1.05, 1.05], [2, 2, 3, 3]]],
                       np.float32), "s": scores})
    assert int(out.lengths[0]) == 2
    rows = out.data.numpy()[0]
    assert rows[0][0] == 1.0 and abs(rows[0][1] - 0.9) < 1e-6
    np.testing.assert_allclose(rows[1][2:], [2, 2, 3, 3], atol=1e-6)
    for boxes, want in (([[1, 0.9, 0, 0, 1, 1], [2, 0.8, 2, 2, 3, 3]], 1.0),
                        ([[1, 0.9, 0, 0, 1, 1], [1, 0.8, 5, 5, 6, 6]], 0.5)):
        gt = [[1, 0, 0, 1, 1], [2 if want == 1.0 else 1, 2, 2, 3, 3]]
        prog, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(prog, startup):
            block = prog.current_block()
            d = block.create_var(name="det", shape=(1, 2, 6),
                                 dtype="float32", lod_level=1, is_data=True,
                                 type="packed_seq")
            g = block.create_var(name="gt", shape=(1, 2, 5),
                                 dtype="float32", lod_level=1, is_data=True,
                                 type="packed_seq")
            m = det.detection_map(d, g)
        exe = tfluid.Executor(CPU)
        exe.run(startup)
        two = torch.tensor([2], dtype=torch.int32)
        got = exe.run(prog, feed={
            "det": tfluid.PackedSeq(torch.tensor([boxes], dtype=torch.float32),
                                    two),
            "gt": tfluid.PackedSeq(torch.tensor([gt], dtype=torch.float32),
                                   two)}, fetch_list=[m])[0]
        assert abs(float(got) - want) < 1e-5


# ---- the SSD program at a reduced width ----

SMALL = dict(size=64, div=16, maps=3)
SMALL_PRIORS = 8 * 8 * 4 + 4 * 4 * 6 + 2 * 2 * 6      # 376
SMALL_B = 2


def _ssd(fluid, **kw):
    with fluid.unique_name.guard():
        return chip_smoke.ssd_build(fluid, config="B", **dict(SMALL, **kw))


def _eval(fluid, built):
    with fluid.unique_name.guard():
        return chip_smoke.ssd_eval_program(fluid, built[0], built[2])


def _dump(prog):
    return json.dumps(prog.to_dict(), sort_keys=True, indent=1)


def test_ssd_program_json_is_the_jax_packages():
    j, t = _ssd(jfluid), _ssd(tfluid)
    assert _dump(t[0]) == _dump(j[0])
    assert _dump(t[1]) == _dump(j[1])
    je, te = _eval(jfluid, j)[0], _eval(tfluid, t)[0]
    assert _dump(te) == _dump(je)
    for fluid, built in ((jfluid, j), (tfluid, t)):
        with fluid.unique_name.guard():
            full = chip_smoke.ssd_build(fluid, config="B")
        assert tuple(full[2][2].shape) == (chip_smoke.SSD_PRIORS, 4)
        assert tuple(full[2][1].shape)[1:] == (chip_smoke.SSD_PRIORS, 21)
        assert tuple(built[2][2].shape) == (SMALL_PRIORS, 4)


def _carried(ratio=3.0):
    """Both packages' SSD programs, the JAX startup's weights in a JAX
    scope and carried into a port scope, and a batch."""
    j, t = _ssd(jfluid, neg_pos_ratio=ratio), _ssd(tfluid,
                                                   neg_pos_ratio=ratio)
    jscope, jexe = jfluid.Scope(), jfluid.Executor()
    jexe.run(j[1], scope=jscope)
    arrays = {v.name: np.asarray(jscope.find_var(v.name))
              for v in j[0].list_vars() if v.persistable}
    tscope = tfluid.Scope()
    interop.load_reference_state(arrays, tscope, CPU, [t[0], t[1]])
    feed = chip_smoke.ssd_feed(np.random.RandomState(0), SMALL_B,
                               SMALL["size"])
    return j, t, jscope, jexe, tscope, feed


def _steps(j, t, jscope, jexe, tscope, feed, n):
    train = {k: v for k, v in feed.items() if k != "gt"}
    texe = tfluid.Executor(CPU)
    tfluid.flags.set_flags({"FLAGS_fused_conv1x1_bwd": True})
    try:
        jl, tl = [], []
        for _ in range(n):
            jl.append(float(np.asarray(jexe.run(
                j[0], feed=train, fetch_list=[j[3][0].name],
                scope=jscope)[0])))
            tl.append(float(texe.run(t[0], feed=train, fetch_list=[
                t[3][0].name], scope=tscope)[0]))
    finally:
        tfluid.flags.set_flags({"FLAGS_fused_conv1x1_bwd": False})
    return jl, tl


def test_ssd_momentum_steps():
    """3 Momentum steps within rtol 1e-5 where every unmatched prior is a
    negative (a neg_pos_ratio past the priors). At SSD's ratio 3 the
    negatives are the 3 x positives of highest cross-entropy: after an
    update, near-equal losses among background priors swap ranks on a
    rounding difference and change the selected set, so a 1e-6 change of
    the input moves the JAX package's own third loss by ~1e-4. There the
    first two losses (before and after one update) are held at rtol
    1e-5 and the third at the ResNet bound, 1e-3."""
    for ratio, tols in ((1e6, (1e-5, 1e-5, 1e-5)),
                        (3.0, (1e-5, 1e-5, 1e-3))):
        jl, tl = _steps(*_carried(ratio), 3)
        assert np.isfinite(tl).all() and tl[-1] < tl[0], tl
        for a, b, tol in zip(jl, tl, tols):
            np.testing.assert_allclose(b, a, rtol=tol, err_msg=str(ratio))


def test_ssd_detections_on_the_trained_weights():
    """The JAX package's weights after 3 Momentum steps, carried into the
    port: detection_output's rows (labels, scores, boxes) and counts and
    detection_map's mAP agree at SSD300's test settings."""
    j, t, jscope, jexe, tscope, feed = _carried()
    _steps(j, t, jscope, jexe, tscope, feed, 3)
    arrays = {v.name: np.asarray(jscope.find_var(v.name))
              for v in j[0].list_vars() if v.persistable}
    tscope = tfluid.Scope()
    interop.load_reference_state(arrays, tscope, CPU, [t[0], t[1]])
    je, jdet, jm = _eval(jfluid, j)
    te, tdet, tm = _eval(tfluid, t)
    ev = {n: feed[n] for n in ("img", "gt")}
    jd, jmap = jexe.run(je, feed=ev, fetch_list=[jdet.name, jm.name],
                        scope=jscope)
    td, tmap = tfluid.Executor(CPU).run(te, feed=ev, fetch_list=[
        tdet.name, tm.name], scope=tscope, return_numpy=False)
    np.testing.assert_array_equal(td.lengths.numpy(), np.asarray(
        jd.lengths))
    assert (td.lengths.numpy() > 0).all()
    rows, want = td.data.numpy(), np.asarray(jd.data)
    np.testing.assert_array_equal(rows[..., 0], want[..., 0])
    np.testing.assert_allclose(rows[..., 1:], want[..., 1:], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(tmap), float(np.asarray(jmap)),
                               rtol=1e-5)


def test_jax_layout_pass_refuses_the_ssd_program():
    """The JAX package's NHWC pass cancels the heads' transposes against
    its own boundary transposes and leaves their grad ops without a
    forward: its verifier refuses the program (ROADMAP.md Queue 3). The
    card therefore trains SSD300 in config B (NCHW, the fused 1x1 conv
    backward)."""
    from paddle_tpu.analysis.verifier import VerifyError

    with jfluid.unique_name.guard():
        j = chip_smoke.ssd_build(jfluid, config="A", **SMALL)
    feed = chip_smoke.ssd_feed(np.random.RandomState(0), SMALL_B,
                               SMALL["size"])
    train = {k: v for k, v in feed.items() if k != "gt"}
    train["img"] = np.ascontiguousarray(train["img"].transpose(0, 2, 3, 1))
    scope, exe = jfluid.Scope(), jfluid.Executor()
    exe.run(j[1], scope=scope)
    with pytest.raises(VerifyError, match="transpose_grad"):
        exe.run(j[0], feed=train, fetch_list=[j[3][0].name], scope=scope)
