"""The CTC ops in the port against the JAX package, on the CPU, from the
same numpy inputs:

* ``warpctc`` over ragged frames and labels, repeated labels (a blank
  must separate them), an empty label and a row whose label cannot be
  aligned in its frames, with and without ``norm_by_times``: the loss
  and autograd's gradient against ``jax.vjp`` within rtol 1e-5 plus
  1e-6 of the largest magnitude. The row that cannot be aligned has a
  finite loss near 1e30 in both packages (warp-ctc gives inf), held at
  rtol 1e-5; its gradient is a rounding artifact of the -1e30 floor
  that differs between the packages (JAX's log-add-exp derivative reads
  exp(a - out) = 1 for two equal operands near -1e30, where the true
  value is 1/2, which torch's formula gives): it is held finite and the
  other rows' gradients at the bound (ROADMAP.md Queue 3);
* ``ctc_align`` (ids and logits with tied maxima, whose argmax takes
  the first) and ``edit_distance`` (normalized both ways, empty rows)
  exact, with the JAX package's int32 results;
* the port's run of ``tests/test_crf_ctc.py``'s CTC cases through its
  layers and ``Executor``: 40 Adam steps with a falling loss, a greedy
  decode that recovers the labels, and kitten -> sitting = 3."""

import numpy as np
import pytest

import paddle_tpu_torch as tfluid
from paddle_tpu.core import registry as jreg
from paddle_tpu_torch.core import registry as treg
from torch_dense_harness import check, close, grads, run_jax, run_port, seq

R = np.random.RandomState(29)
CPU = tfluid.CPUPlace()
TYPES = ["warpctc", "ctc_align", "edit_distance"]


def _labels(rows, width):
    data = np.zeros((len(rows), width, 1), np.int32)
    for i, r in enumerate(rows):
        data[i, :len(r), 0] = r
    return seq(data, [len(r) for r in rows])


# ragged frames, repeats (row 1: 3 3 needs 3 frames), an empty label
# (row 3); every row can be aligned
FEASIBLE = {"Logits": [seq(R.randn(4, 7, 5).astype(np.float32) * 2,
                           [7, 5, 4, 6])],
            "Label": [_labels([[1, 2, 2], [3, 3], [1, 2, 3, 4], []], 4)]}
# row 2: four labels with a repeat need 5 frames and have 3
INFEASIBLE = {"Logits": [seq(R.randn(3, 6, 5).astype(np.float32),
                             [6, 5, 3])],
              "Label": [_labels([[4, 1], [2], [1, 1, 2, 3]], 4)]}
WIDE = {"Logits": [seq(R.randn(3, 12, 9).astype(np.float32) * 3,
                       [12, 9, 12])],
        "Label": [_labels([[8, 1, 8, 8, 2], [5, 5, 5], [1, 2, 3, 4, 5, 6]],
                          6)]}


def _align_logits():
    x = R.randn(3, 6, 4).astype(np.float32)
    x[0, 2] = [1.0, 3.0, 3.0, 0.0]         # a tie: the first maximum wins
    x[1, :, 0] = 9.0                       # all blanks
    return seq(x, [6, 6, 4])


CASES = [
    ("warpctc", "warpctc", FEASIBLE, {"blank": 0}),
    ("warpctc_norm_by_times", "warpctc", FEASIBLE,
     {"blank": 0, "norm_by_times": True}),
    ("warpctc_last_blank", "warpctc", WIDE,
     {"blank": 0, "norm_by_times": True}),
    ("warpctc_blank_last_class", "warpctc",
     {"Logits": WIDE["Logits"],
      "Label": [_labels([[0, 1, 0, 7, 2], [5, 5, 5], [1, 2, 3, 0, 5, 6]],
                        6)]}, {"blank": 8}),
    ("ctc_align_logits", "ctc_align", {"Input": [_align_logits()]},
     {"blank": 0}),
    ("ctc_align_ids", "ctc_align",
     {"Input": [seq(np.array([[0, 1, 1, 0, 2, 2, 3], [3, 3, 3, 0, 0, 1, 1],
                              [2, 0, 2, 2, 1, 0, 0]], np.int64)[..., None],
                    [7, 5, 0])]}, {"blank": 0}),
    ("ctc_align_other_blank", "ctc_align",
     {"Input": [seq(R.randint(0, 4, (4, 8, 1)).astype(np.int32),
                    [8, 3, 8, 1])]}, {"blank": 3}),
    ("edit_distance", "edit_distance",
     {"Hyps": [_labels([[1, 2, 3], [4], [], [5, 6, 7, 8]], 4)],
      "Refs": [_labels([[1, 3], [], [2, 2], [8, 7, 6, 5, 4]], 5)]},
     {"normalized": False}),
    ("edit_distance_normalized", "edit_distance",
     {"Hyps": [seq(R.randint(0, 5, (5, 9, 1)).astype(np.int64),
                   [9, 4, 0, 7, 1])],
      "Refs": [seq(R.randint(0, 5, (5, 6, 1)).astype(np.int64),
                   [6, 0, 3, 6, 2])]}, {"normalized": True}),
]


@pytest.mark.parametrize("name,type,ins,attrs", CASES,
                         ids=[c[0] for c in CASES])
def test_ctc_type_matches_the_jax_lowering(name, type, ins, attrs):
    check(type, ins, attrs, lengths=True)


def test_the_cases_cover_the_3_types_with_the_jax_flags():
    assert sorted({c[1] for c in CASES}) == sorted(TYPES)
    for t in TYPES:
        j, p = jreg.get(t), treg.get(t)
        assert (j.no_grad, tuple(j.nondiff_inputs)) == \
            (p.no_grad, tuple(p.nondiff_inputs)), t


@pytest.mark.parametrize("norm", [False, True])
def test_an_infeasible_row_gives_the_jax_packages_finite_loss(norm):
    attrs = {"blank": 0, "norm_by_times": norm}
    got = run_port("warpctc", INFEASIBLE, attrs)["Loss"][0][:, 0]
    want = run_jax("warpctc", INFEASIBLE, attrs)["Loss"][0][:, 0]
    assert np.isfinite(got).all() and got[2] > 1e29
    np.testing.assert_allclose(got, want, rtol=1e-5)
    jg, tg = grads("warpctc", INFEASIBLE, attrs)
    k = ("Logits", 0)
    assert np.isfinite(tg[k]).all()
    close(tg[k][:2], jg[k][:2], "feasible rows' gradient")


def test_a_feasible_row_is_the_sum_over_alignments():
    """Two frames, label [1], blank 0: the alignments are (1, 1), (0, 1)
    and (1, 0), so the loss is -log(p1 p1' + p0 p1' + p1 p0')."""
    x = R.randn(1, 2, 3).astype(np.float32)
    p = np.exp(x[0]) / np.exp(x[0]).sum(-1, keepdims=True)
    want = -np.log(p[0, 1] * p[1, 1] + p[0, 0] * p[1, 1]
                   + p[0, 1] * p[1, 0])
    got = run_port("warpctc", {"Logits": [seq(x, [2])],
                               "Label": [_labels([[1]], 1)]}, {})["Loss"][0]
    np.testing.assert_allclose(got[0, 0], want, rtol=1e-6)


# ---- tests/test_crf_ctc.py's CTC cases through the port ----

def test_ctc_loss_decreases_and_decodes():
    layers = tfluid.layers
    vocab = 6  # 0 = blank
    prog, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(prog, startup):
        x = layers.data("x", [vocab], lod_level=1)
        y = layers.data("y", [1], dtype="int64", lod_level=1)
        logits = layers.fc(x, vocab, num_flatten_dims=2)
        loss = layers.mean(layers.warpctc(logits, y, blank=0))
        tfluid.optimizer.Adam(0.1).minimize(loss)
    exe = tfluid.Executor(CPU)
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(1)

    def make_batch(n=8):
        xs, ys = [], []
        for _ in range(n):
            lab = rng.randint(1, vocab, size=rng.randint(2, 4))
            for j in range(1, len(lab)):
                if lab[j] == lab[j - 1]:
                    lab[j] = lab[j] % (vocab - 1) + 1
            frames = np.repeat(lab, 3)
            f = np.zeros((len(frames), vocab), np.float32)
            f[np.arange(len(frames)), frames] = 1.0
            xs.append(f + rng.randn(*f.shape).astype(np.float32) * 0.1)
            ys.append(lab.astype(np.int64).reshape(-1, 1))
        return xs, ys

    losses = []
    for _ in range(40):
        xs, ys = make_batch()
        losses.append(float(exe.run(prog, feed={"x": xs, "y": ys},
                                    fetch_list=[loss], scope=scope)[0]))
    assert losses[-1] < losses[0]
    assert losses[-1] < 2.0

    dec_prog = tfluid.Program()
    with tfluid.program_guard(dec_prog, tfluid.Program()):
        frames = layers.data("frames", [vocab], lod_level=1)
        decoded = layers.ctc_greedy_decoder(frames, blank=0)
    xs, ys = make_batch(4)
    clean = [np.where(f == f.max(axis=1, keepdims=True), 5.0, 0.0)
             .astype(np.float32) for f in xs]
    out = exe.run(dec_prog, feed={"frames": clean}, fetch_list=[decoded],
                  return_numpy=False)[0]
    for i, lab in enumerate(ys):
        n = int(out.lengths[i])
        assert out.data[i, :n, 0].tolist() == lab[:, 0].tolist(), i


def test_edit_distance_known_values():
    layers = tfluid.layers
    prog, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(prog, startup):
        hyp = layers.data("hyp", [1], dtype="int64", lod_level=1)
        ref = layers.data("ref", [1], dtype="int64", lod_level=1)
        dist, seq_num = layers.edit_distance(hyp, ref, normalized=False)
    exe = tfluid.Executor(CPU)
    exe.run(startup)
    # kitten -> sitting = 3; identical = 0; abc -> b = 2 (2 deletions)
    col = lambda v: np.array(v, np.int64).reshape(-1, 1)  # noqa: E731
    hyps = [col([ord(c) for c in "kitten"]), col([1, 2, 3]), col([1, 2, 3])]
    refs = [col([ord(c) for c in "sitting"]), col([1, 2, 3]), col([2])]
    out, n = exe.run(prog, feed={"hyp": hyps, "ref": refs},
                     fetch_list=[dist, seq_num])
    np.testing.assert_array_equal(np.asarray(out)[:, 0], [3.0, 0.0, 2.0])
    assert np.asarray(n).tolist() == [3]
