"""The sequence op family in the port against the JAX package, on the
CPU, from the same numpy inputs: each of the 13 types (``sequence_unpad``,
``sequence_softmax``, ``sequence_expand``, ``sequence_expand_as``,
``sequence_concat``, ``sequence_reverse``, ``sequence_erase``,
``sequence_slice``, ``sequence_reshape``, ``sequence_scatter``,
``sequence_enumerate``, ``sequence_roll``, ``lod_reset``) through its
lowering in both packages (``tests/torch_dense_harness.py``): float
outputs within rtol 1e-5 plus 1e-6 of the largest magnitude, integers and
lengths exact with the JAX package's dtype (int32 where it declares
int64), and autograd's gradients against ``jax.vjp`` at the same bound.
The shapes are those of the JAX sweeps (``tests/test_op_sweep_rnn_seq.py``
``TestSequenceFamily`` and ``TestMaskedGradients``, ``tests/test_op_tail.py``
``TestLodReset``), with ragged lengths and rows of length 0 where the
JAX op takes them. The 11 sequence and CTC layers build byte-identical
programs in both packages."""

import json

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import registry as jreg
from paddle_tpu_torch.core import registry as treg
from torch_dense_harness import check, run_jax, run_port, seq

R = np.random.RandomState(23)
TYPES = ["sequence_unpad", "sequence_softmax", "sequence_expand",
         "sequence_expand_as", "sequence_concat", "sequence_reverse",
         "sequence_erase", "sequence_slice", "sequence_reshape",
         "sequence_scatter", "sequence_enumerate", "sequence_roll",
         "lod_reset"]


def _ps(b, t, d, lengths, scale=1.0):
    return seq((R.rand(b, t, d).astype(np.float32) - 0.5) * scale, lengths)


def _flat_x(lens, d, t):
    """A PackedSeq whose valid steps are a flat stream of tokens."""
    data = np.zeros((len(lens), t, d), np.float32)
    flat = R.rand(sum(lens), d).astype(np.float32)
    pos = 0
    for b, n in enumerate(lens):
        data[b, :n] = flat[pos:pos + n]
        pos += n
    return seq(data, lens)


_IDS = seq(np.array([[[1], [2], [0], [2]], [[2], [2], [0], [0]],
                     [[3], [0], [0], [0]]], np.int64), [4, 2, 0])

CASES = [
    ("unpad", "sequence_unpad",
     {"X": [R.randn(3, 4, 2).astype(np.float32)],
      "Length": [np.array([4, 2, 0], np.int64)]}, {}),
    ("unpad_2d_lengths", "sequence_unpad",
     {"X": [R.randn(2, 5).astype(np.float32)],
      "Length": [np.array([[3], [5]], np.int64)]}, {}),
    ("softmax", "sequence_softmax", {"X": [_ps(2, 4, 1, [4, 2])]}, {}),
    ("softmax_2d_empty_row", "sequence_softmax",
     {"X": [seq(R.randn(3, 5).astype(np.float32) * 3, [5, 0, 2])]}, {}),
    ("expand_dense", "sequence_expand",
     {"X": [np.array([[1.0], [2.0]], np.float32)],
      "Y": [_ps(2, 3, 1, [3, 2])]}, {"ref_level": -1}),
    ("expand_dense_wide", "sequence_expand",
     {"X": [R.randn(3, 4).astype(np.float32)],
      "Y": [_ps(3, 5, 1, [5, 0, 2])]}, {}),
    ("expand_seq", "sequence_expand",
     {"X": [_ps(2, 2, 3, [1, 2])], "Y": [_ps(2, 4, 1, [3, 4])]}, {}),
    ("expand_seq_shorter_y", "sequence_expand",
     {"X": [_ps(3, 4, 2, [4, 3, 2])], "Y": [_ps(3, 4, 1, [2, 0, 4])]}, {}),
    ("expand_as", "sequence_expand_as",
     {"X": [np.array([[1.0], [2.0]], np.float32)],
      "Y": [_ps(2, 3, 1, [3, 1])]}, {}),
    ("concat", "sequence_concat",
     {"X": [_ps(2, 3, 2, [3, 1]), _ps(2, 2, 2, [1, 2])]}, {}),
    ("concat_three_with_empty", "sequence_concat",
     {"X": [_ps(3, 3, 2, [3, 0, 1]), _ps(3, 2, 2, [0, 2, 1]),
            _ps(3, 4, 2, [2, 4, 0])]}, {}),
    ("reverse", "sequence_reverse", {"X": [_ps(3, 4, 2, [4, 2, 3],
                                                scale=2.0)]}, {}),
    ("reverse_empty_row", "sequence_reverse",
     {"X": [_ps(3, 5, 3, [5, 0, 1])]}, {}),
    ("erase", "sequence_erase", {"X": [_IDS]}, {"tokens": [2]}),
    ("erase_two_tokens", "sequence_erase", {"X": [_IDS]},
     {"tokens": [0, 2]}),
    ("erase_nothing", "sequence_erase", {"X": [_IDS]}, {"tokens": []}),
    ("slice", "sequence_slice",
     {"X": [_ps(3, 4, 2, [4, 2, 3], scale=2.0)],
      "Offset": [np.array([[0], [0], [1]], np.int64)],
      "Length": [np.array([[2], [1], [2]], np.int64)]}, {}),
    ("slice_past_the_end", "sequence_slice",
     {"X": [_ps(3, 5, 2, [5, 2, 0])],
      "Offset": [np.array([[3], [2], [0]], np.int64)],
      "Length": [np.array([[4], [1], [3]], np.int64)]}, {}),
    ("reshape", "sequence_reshape", {"X": [_ps(2, 4, 2, [4, 2])]},
     {"new_dim": 4}),
    ("reshape_narrower", "sequence_reshape",
     {"X": [_ps(3, 3, 4, [3, 1, 0])]}, {"new_dim": 2}),
    ("reshape_floors", "sequence_reshape",
     {"X": [_ps(2, 4, 3, [3, 1])]}, {"new_dim": 4}),
    ("scatter", "sequence_scatter",
     {"X": [np.zeros((2, 5), np.float32)],
      "Ids": [seq(np.array([[[1], [3]], [[0], [0]]], np.int64), [2, 1])],
      "Updates": [seq(np.array([[[1.0], [2.0]], [[3.0], [0.0]]],
                               np.float32), [2, 1])]}, {}),
    ("scatter_duplicates_wrap_and_drop", "sequence_scatter",
     {"X": [R.randn(3, 6).astype(np.float32)],
      "Ids": [seq(np.array([[2, 2, 5, 2], [-1, 0, 7, -1], [1, 1, 1, 1]],
                           np.int64)[..., None], [4, 4, 0])],
      "Updates": [seq(R.randn(3, 4, 1).astype(np.float32), [4, 4, 0])]},
     {}),
    ("enumerate", "sequence_enumerate",
     {"X": [seq(np.arange(8, dtype=np.int64).reshape(2, 4, 1), [4, 3])]},
     {"win_size": 2}),
    ("enumerate_pad", "sequence_enumerate",
     {"X": [seq(R.randint(0, 9, (3, 5, 1)).astype(np.int64), [5, 1, 0])]},
     {"win_size": 3, "pad_value": -1}),
    ("roll_seq", "sequence_roll", {"X": [_ps(3, 5, 2, [5, 3, 0])]},
     {"offset": -1}),
    ("roll_seq_forward", "sequence_roll", {"X": [_ps(2, 4, 3, [4, 2])]},
     {"offset": 2}),
    ("roll_dense", "sequence_roll",
     {"X": [R.randn(2, 4, 3).astype(np.float32)]}, {"offset": 1}),
    ("lod_reset_target_lod", "lod_reset", {"X": [_flat_x([2, 3, 1], 2, 3)]},
     {"target_lod": [0, 3, 6]}),
    ("lod_reset_uneven_target", "lod_reset",
     {"X": [_flat_x([2, 3, 0, 2], 2, 3)]}, {"target_lod": [0, 1, 1, 7]}),
    ("lod_reset_y", "lod_reset",
     {"X": [_flat_x([4, 2], 1, 4)],
      "Y": [seq(np.zeros((3, 3, 1), np.float32), [1, 2, 3])]}, {}),
    ("lod_reset_dense_x", "lod_reset",
     {"X": [R.randn(6, 3).astype(np.float32)]},
     {"target_lod": [0, 2, 6]}),
]


@pytest.mark.parametrize("name,type,ins,attrs", CASES,
                         ids=[c[0] for c in CASES])
def test_sequence_type_matches_the_jax_lowering(name, type, ins, attrs):
    check(type, ins, attrs, lengths=True)


def test_the_cases_cover_the_13_types_with_the_jax_flags():
    assert sorted({c[1] for c in CASES}) == sorted(TYPES)
    for t in TYPES:
        j, p = jreg.get(t), treg.get(t)
        assert (j.no_grad, tuple(j.nondiff_inputs)) == \
            (p.no_grad, tuple(p.nondiff_inputs)), t


def test_lod_reset_refuses_a_dense_y_in_both_packages():
    ins = {"X": [_flat_x([2, 1], 1, 2)],
           "Y": [np.array([0, 1, 3], np.int32)]}
    for run in (run_jax, run_port):
        with pytest.raises(TypeError, match="PackedSeq"):
            run("lod_reset", ins, {})


def test_sequence_scatter_adds_duplicates_in_index_order():
    """Three updates to one column add left to right, as the JAX
    package's scatter-add adds them on the CPU: the port's bits equal
    JAX's where another order would round differently."""
    upd = np.array([[[1e8], [1.0], [-1e8]]], np.float32)
    ins = {"X": [np.zeros((1, 2), np.float32)],
           "Ids": [seq(np.array([[[1], [1], [1]]], np.int64), [3])],
           "Updates": [seq(upd, [3])]}
    got = run_port("sequence_scatter", ins, {})["Out"][0]
    want = run_jax("sequence_scatter", ins, {})["Out"][0]
    np.testing.assert_array_equal(got, want)
    assert got[0, 1] == np.float32(np.float32(1e8) + 1.0) - np.float32(1e8)


# ---- the layers ----

def _build(fluid):
    layers = fluid.layers
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(prog, startup):
        x = layers.data("x", [4], lod_level=1)
        y = layers.data("y", [1], lod_level=1)
        dense = layers.data("dense", [6, 4])
        n = layers.data("n", [1], dtype="int64")
        ids = layers.data("ids", [1], dtype="int64", lod_level=1)
        off = layers.data("off", [1], dtype="int64")
        ln = layers.data("ln", [1], dtype="int64")
        outs = [
            layers.sequence_softmax(layers.fc(x, 1, num_flatten_dims=2),
                                    use_cudnn=False),
            layers.sequence_expand(layers.fc(dense, 3), y, ref_level=-1),
            layers.sequence_reshape(x, new_dim=2),
            layers.sequence_reverse(x),
            layers.sequence_concat([x, layers.sequence_reverse(x)]),
            layers.sequence_slice(x, off, ln),
            layers.sequence_unpad(dense, n),
            layers.lod_reset(x, target_lod=[0, 2, 5]),
            layers.lod_reset(x, y=y),
        ]
        logits = layers.fc(x, 5, num_flatten_dims=2)
        outs.append(layers.warpctc(logits, ids, blank=4, norm_by_times=True))
        dec = layers.ctc_greedy_decoder(logits, blank=4)
        outs.extend(layers.edit_distance(dec, ids, normalized=False))
    return prog, startup, outs


def test_the_layers_build_the_jax_packages_program():
    (jp, js, jo), (tp, ts, to) = _build(jfluid), _build(tfluid)
    for a, b in ((jp, tp), (js, ts)):
        assert json.dumps(b.to_dict(), sort_keys=True) == \
            json.dumps(a.to_dict(), sort_keys=True)
    for a, b in zip(jo, to):
        assert (tuple(b.shape), b.dtype, b.lod_level) == \
            (tuple(a.shape), a.dtype, a.lod_level), a.name
