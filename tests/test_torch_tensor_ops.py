"""The dense op library's tensor types in the port against the JAX
package's lowerings (``ops/tensor_ops.py``: shape, index, fill and
arithmetic ops), on the same numpy inputs, forward and backward, at the
bounds of ``tests/torch_dense_harness.py``; the cases are the JAX sweep's
(``tests/test_op_sweep_tensor.py``) plus one for each place where the
obvious PyTorch call computes something else (``expand`` tiles,
``one_hot`` of an id out of range, ``hash``'s int32 wrap, stable
``argsort``, ``unique_with_counts``' static size, out-of-range ids).

The random ops cannot draw JAX's numbers: they are held to the JAX
tests' properties (bounds, moments, a permutation, a window of the
input, ``sampling_id``'s frequencies) and to the port's determinism
from the (step key, op uid, seed) of their stream. And every type this
slice names is registered."""

import numpy as np
import pytest

from paddle_tpu.core import registry as jreg
from paddle_tpu_torch.core import registry as treg
from torch_dense_harness import check, run_jax, run_port, seq

R = np.random.RandomState(7)
A = R.rand(2, 3, 4).astype(np.float32)


def _f(*shape):
    return R.randn(*shape).astype(np.float32)


def _i(*a):
    return np.array(a, np.int64)


CASES = [
    ("split_sections", "split", {"X": [A]}, {"axis": 2, "sections": [1, 3]}),
    ("split_num", "split", {"X": [A]}, {"axis": 1, "num": 3}),
    ("reshape2", "reshape2", {"X": [A]}, {"shape": [2, 12]}),
    ("reshape2_infer", "reshape2", {"X": [A]}, {"shape": [0, -1]}),
    ("transpose2", "transpose2", {"X": [A]}, {"axis": [2, 0, 1]}),
    ("flatten", "flatten", {"X": [A]}, {"axis": 2}),
    ("flatten_0", "flatten", {"X": [A]}, {"axis": 0}),
    # Paddle's expand TILES (jnp.tile), torch.Tensor.expand does not
    ("expand", "expand", {"X": [A]}, {"expand_times": [2, 1, 3]}),
    ("expand_rank", "expand", {"X": [_f(3, 1)]}, {"expand_times": [2, 2, 4]}),
    ("tile", "tile", {"X": [A]}, {"repeat_times": [1, 2, 1]}),
    ("stack", "stack", {"X": [A, _f(2, 3, 4)]}, {"axis": 1}),
    ("stack_last", "stack", {"X": [A, _f(2, 3, 4), A]}, {"axis": -1}),
    ("unstack", "unstack", {"X": [A]}, {"axis": 1}),
    ("pad", "pad", {"X": [A]}, {"paddings": [0, 1, 1, 0, 0, 2],
                                "pad_value": 0.5}),
    ("pad2d", "pad2d", {"X": [_f(2, 3, 4, 5)]}, {"paddings": [1, 2, 2, 1]}),
    ("pad2d_value", "pad2d", {"X": [_f(2, 3, 4, 5)]},
     {"paddings": [0, 1, 3, 0], "pad_value": -2.0}),
    ("pad2d_reflect", "pad2d", {"X": [_f(2, 3, 4, 5)]},
     {"paddings": [1, 1, 1, 1], "mode": "reflect"}),
    ("pad2d_edge", "pad2d", {"X": [_f(2, 3, 4, 5)]},
     {"paddings": [2, 0, 1, 3], "mode": "edge"}),
    ("crop", "crop", {"X": [A]}, {"offsets": [0, 1, 2], "shape": [2, 2, 2]}),
    # lax.dynamic_slice moves an offset back until the window fits
    ("crop_clamped", "crop", {"X": [A]},
     {"offsets": [1, 2, 3], "shape": [2, 2, 3]}),
    ("slice", "slice", {"X": [A]}, {"axes": [1, 2], "starts": [0, 1],
                                    "ends": [2, 4]}),
    ("slice_negative", "slice", {"X": [A]}, {"axes": [2, 1],
                                             "starts": [-3, -2],
                                             "ends": [-1, 100]}),
    ("slice_past_end", "slice", {"X": [A]}, {"axes": [0], "starts": [1],
                                             "ends": [10 ** 9]}),
    ("strided_slice", "strided_slice", {"X": [A]},
     {"axes": [2], "starts": [0], "ends": [4], "strides": [2]}),
    ("strided_slice_negative", "strided_slice", {"X": [A]},
     {"axes": [2, 1], "starts": [-1, 2], "ends": [-10, 0],
      "strides": [-2, -1]}),
    ("reverse", "reverse", {"X": [A]}, {"axis": [1]}),
    ("reverse_two", "reverse", {"X": [A]}, {"axis": [0, 2]}),
    ("reverse_int", "reverse", {"X": [A]}, {"axis": 2}),
    ("shape", "shape", {"Input": [A]}, {}),
    ("gather", "gather", {"X": [A], "Index": [_i(1, 0)]}, {}),
    ("gather_column", "gather", {"X": [_f(5, 3)],
                                 "Index": [_i(4, 0, 4).reshape(3, 1)]}, {}),
    ("gather_axis1", "gather", {"X": [A], "Index": [_i(2, 0, 2, 1)]},
     {"axis": 1}),
    # jnp.take: a negative id wraps once, one out of range reads NaN
    ("gather_out_of_range", "gather",
     {"X": [_f(3, 4)], "Index": [_i(5, -1, 0, -4, 3)]}, {}),
    ("gather_nd", "gather_nd", {"X": [A], "Index": [_i([0, 1], [1, 2])]},
     {}),
    ("gather_nd_rows", "gather_nd", {"X": [A], "Index": [_i([1], [0], [1])]},
     {}),
    # jnp indexing: a negative id wraps, then every id is clamped
    ("gather_nd_out_of_range", "gather_nd",
     {"X": [_f(4, 3)], "Index": [_i([5, 0], [-1, 2], [2, 7], [-9, -1])]},
     {}),
    ("scatter", "scatter", {"X": [_f(5, 3)], "Ids": [_i(3, 0, 4)],
                            "Updates": [_f(3, 3)]}, {}),
    ("scatter_add_duplicates", "scatter",
     {"X": [_f(5, 3)], "Ids": [_i(3, 0, 3, 3)], "Updates": [_f(4, 3)]},
     {"overwrite": False}),
    ("scatter_negative", "scatter",
     {"X": [_f(5, 3)], "Ids": [_i(-1, 1).reshape(2, 1)],
      "Updates": [_f(2, 3)]}, {}),
    ("multiplex", "multiplex",
     {"X": [_f(4, 5), _f(4, 5), _f(4, 5)],
      "Ids": [np.array([[2], [0], [1], [0]], np.int32)]}, {}),
    # an id out of range is clamped, a negative one wraps first
    ("multiplex_out_of_range", "multiplex",
     {"X": [_f(4, 5), _f(4, 5)],
      "Ids": [np.array([[3], [-1], [-5], [1]], np.int32)]}, {}),
    ("one_hot", "one_hot", {"X": [_i([1], [3], [0])]}, {"depth": 4}),
    # jax.nn.one_hot: an id outside [0, depth) is a row of zeros
    ("one_hot_out_of_range", "one_hot", {"X": [_i(1, 4, -1, 9, 0)]},
     {"depth": 4}),
    ("arg_max", "arg_max", {"X": [_f(3, 6)]}, {"axis": 1}),
    ("arg_min", "arg_min", {"X": [_f(3, 6)]}, {"axis": 0}),
    ("arg_max_ties", "arg_max",
     {"X": [np.array([[1, 3, 3, 0], [2, 2, 2, 2]], np.float32)]}, {}),
    ("argsort", "argsort", {"X": [_f(3, 6)]}, {"axis": 1}),
    # jnp.argsort is stable: ties keep their order
    ("argsort_ties", "argsort",
     {"X": [np.array([[3, 1, 3, 2, 1, 3, 1], [0, 0, 0, 0, 0, 0, 0]],
                     np.float32)]}, {}),
    ("argsort_many_ties", "argsort",
     {"X": [R.randint(0, 3, (2, 3000)).astype(np.float32)]}, {}),
    ("argsort_axis0", "argsort",
     {"X": [R.randint(0, 3, (6, 4)).astype(np.float32)]}, {"axis": 0}),
    ("unique_with_counts", "unique_with_counts", {"X": [_i(2, 3, 2, 5, 3)]},
     {}),
    # padded to x.size with the smallest value, count 0
    ("unique_with_counts_padding", "unique_with_counts",
     {"X": [np.array([3, 1, 3, 2], np.int32)]}, {}),
    ("unique_with_counts_float", "unique_with_counts",
     {"X": [np.array([[0.5, -1.0], [0.5, 2.0], [-1.0, -1.0]], np.float32)]},
     {}),
    ("hash", "hash", {"X": [_i([1, 2], [3, 4])]}, {"hash_size": 1000}),
    # values whose product wraps, negative ids, and hashes >= 2**31 that
    # astype(int64) (int32 with x64 off) turns negative before the %
    ("hash_wraps", "hash",
     {"X": [np.array([[0], [1], [12345], [2 ** 31 - 1], [-1], [-77777],
                      [987654321], [40000]], np.int64)]},
     {"hash_size": 977, "num_hash": 3}),
    ("similarity_focus", "similarity_focus", {"X": [_f(2, 3, 4, 4)]},
     {"axis": 1, "indexes": [0]}),
    ("similarity_focus_two", "similarity_focus", {"X": [_f(2, 3, 4, 4)]},
     {"axis": 1, "indexes": [2, 0]}),
    ("fill_zeros_like", "fill_zeros_like", {"X": [A]}, {}),
    ("minus", "minus", {"X": [A], "Y": [_f(2, 3, 4)]}, {}),
    ("linspace", "linspace", {}, {"start": 0.0, "stop": 1.0, "num": 5}),
    ("linspace_down", "linspace", {}, {"start": 3.0, "stop": -2.0,
                                       "num": 11}),
    ("range", "range", {}, {"start": 1, "end": 9, "step": 2}),
    ("range_int", "range", {}, {"start": -3, "end": 10, "step": 3,
                                "dtype": "int32"}),
    ("range_float_step", "range", {}, {"start": 0.5, "end": 2.0,
                                       "step": 0.25}),
    ("row_conv", "row_conv", {"X": [_f(2, 5, 3)], "Filter": [_f(3, 3)]}, {}),
    ("row_conv_seq", "row_conv",
     {"X": [seq(_f(2, 4, 3), [4, 2])], "Filter": [_f(3, 3)]}, {}),
]


@pytest.mark.parametrize("type,ins,attrs", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_tensor_op_matches_the_jax_lowering(type, ins, attrs):
    check(type, ins, attrs)


def test_gather_out_of_range_reads_nan_and_wraps_negatives():
    x = _f(3, 4)
    out = run_port("gather", {"X": [x], "Index": [_i(5, -1, -4)]},
                   {})["Out"][0]
    np.testing.assert_array_equal(out[1], x[2])
    assert np.isnan(out[0]).all() and np.isnan(out[2]).all()


def test_unique_with_counts_pads_with_the_smallest_value():
    t = run_port("unique_with_counts", {"X": [np.array([3, 1, 3, 2],
                                                       np.int64)]}, {})
    np.testing.assert_array_equal(t["Out"][0], [1, 2, 3, 1])
    np.testing.assert_array_equal(t["Count"][0], [1, 1, 2, 0])
    np.testing.assert_array_equal(t["Index"][0], [2, 0, 2, 1])


def test_int_results_are_recorded_as_int32():
    for type, ins, slot in (("shape", {"Input": [A]}, "Out"),
                            ("arg_max", {"X": [A]}, "Out"),
                            ("argsort", {"X": [A]}, "Indices"),
                            ("hash", {"X": [_i(1, 2)]}, "Out")):
        attrs = {"hash_size": 7} if type == "hash" else {}
        assert run_port(type, ins, attrs)[slot][0].dtype == np.int32, type


# ---- the random ops: properties and determinism ----

def _draw(type, ins, attrs, uid=1, key=0):
    return run_port(type, ins, attrs, uid=uid, key=key)


RANDOM = [
    ("uniform_random_batch_size_like", {"Input": [_f(6, 2)]},
     {"shape": [-1, 500], "min": -2.0, "max": 3.0}),
    ("truncated_gaussian_random", {}, {"shape": [64, 64], "mean": 0.5,
                                       "std": 2.0}),
    ("randint", {}, {"shape": [40, 50], "low": -3, "high": 9}),
    ("shuffle_batch", {"X": [np.arange(64, dtype=np.float32)
                             .reshape(32, 2)]}, {}),
    ("sampling_id", {"X": [np.tile(np.array([[0.2, 0.5, 0.3]], np.float32),
                                   (64, 1))]}, {}),
    ("random_crop", {"X": [_f(2, 3, 8, 8)]}, {"shape": [3, 5, 5]}),
]


@pytest.mark.parametrize("type,ins,attrs", RANDOM,
                         ids=[r[0] for r in RANDOM])
def test_random_op_is_a_function_of_its_stream(type, ins, attrs):
    """The same (step key, op uid, seed) draws the same bits; another
    step, op or seed draws others; the shape and dtype are the JAX
    lowering's."""
    a = _draw(type, ins, attrs)
    b = _draw(type, ins, attrs)
    for s in a:
        np.testing.assert_array_equal(a[s][0], b[s][0])
    first = next(iter(a))
    others = [_draw(type, ins, attrs, uid=2), _draw(type, ins, attrs, key=5)]
    if type != "shuffle_batch":     # it takes no seed attr, in either package
        others.append(_draw(type, ins, dict(attrs, seed=3)))
    for other in others:
        assert not np.array_equal(other[first][0], a[first][0])
    j = run_jax(type, ins, attrs)
    for s in j:
        assert a[s][0].shape == j[s][0].shape, (s, a[s][0].shape)
        assert a[s][0].dtype.kind == j[s][0].dtype.kind


def test_uniform_random_batch_size_like_bounds():
    out = _draw("uniform_random_batch_size_like", {"Input": [_f(6, 2)]},
                {"shape": [-1, 500], "min": -2.0, "max": 3.0})["Out"][0]
    assert out.shape == (6, 500)
    assert out.min() >= -2.0 and out.max() < 3.0
    assert abs(out.mean() - 0.5) < 0.1 and abs(out.std() - 5 / 12 ** 0.5) \
        < 0.1


def test_truncated_gaussian_random_bounds_and_moments():
    out = _draw("truncated_gaussian_random", {},
                {"shape": [128, 128], "mean": 0.5, "std": 2.0})["Out"][0]
    z = (out - 0.5) / 2.0
    assert np.abs(z).max() <= 2.0 + 1e-6
    # a standard normal truncated to [-2, 2] has std 0.8796
    assert abs(z.mean()) < 0.03 and abs(z.std() - 0.8796) < 0.02


def test_randint_bounds():
    out = _draw("randint", {}, {"shape": [40, 50], "low": -3,
                                "high": 9})["Out"][0]
    assert out.dtype == np.int32 and out.min() == -3 and out.max() == 8


def test_shuffle_batch_is_a_permutation():
    x = np.arange(64, dtype=np.float32).reshape(32, 2)
    t = _draw("shuffle_batch", {"X": [x]}, {})
    out, idx = t["Out"][0], t["ShuffleIdx"][0]
    assert sorted(idx.tolist()) == list(range(32)) and \
        idx.tolist() != list(range(32))
    np.testing.assert_array_equal(out, x[idx])


def test_sampling_id_frequencies():
    p = np.array([0.2, 0.5, 0.3], np.float32)
    ids = np.concatenate([
        _draw("sampling_id", {"X": [np.tile(p[None], (2000, 1))]}, {},
              uid=u)["Out"][0] for u in range(5)])
    freq = np.bincount(ids, minlength=3) / ids.size
    np.testing.assert_allclose(freq, p, atol=0.02)
    degenerate = _draw("sampling_id", {"X": [np.tile(
        np.array([[0.0, 1.0, 0.0]], np.float32), (64, 1))]}, {})["Out"][0]
    assert (degenerate == 1).all()


def test_random_crop_is_a_window_of_the_input():
    x = _f(2, 3, 8, 8)
    seen = set()
    for uid in range(6):
        out = _draw("random_crop", {"X": [x]}, {"shape": [3, 5, 5]},
                    uid=uid)["Out"][0]
        assert out.shape == (2, 3, 5, 5)
        hits = [(i, j) for i in range(4) for j in range(4)
                if np.array_equal(out, x[:, :, i:i + 5, j:j + 5])]
        assert len(hits) == 1
        seen.add(hits[0])
    assert len(seen) > 1


# ---- registration ----

MATH = ["elementwise_max", "elementwise_mod", "elementwise_floordiv",
        "reduce_max", "reduce_mean", "reduce_min", "reduce_prod", "l1_norm",
        "squared_l2_norm", "squared_l2_distance", "frobenius_norm", "norm",
        "isfinite", "cumsum", "label_smooth", "matmul", "dot", "cos_sim",
        "bilinear_tensor_product", "iou_similarity", "log_softmax",
        "square_error_cost", "sequence_conv"]
TENSOR = ["split", "reshape2", "transpose2", "flatten", "expand", "tile",
          "stack", "unstack", "pad", "pad2d", "crop", "slice",
          "strided_slice", "reverse", "shape", "gather", "gather_nd",
          "scatter", "multiplex", "one_hot", "arg_max", "arg_min", "argsort",
          "unique_with_counts", "hash", "similarity_focus",
          "fill_zeros_like", "minus", "linspace", "range", "row_conv",
          "uniform_random_batch_size_like", "truncated_gaussian_random",
          "randint", "shuffle_batch", "sampling_id", "random_crop"]


def test_every_type_of_the_slice_is_registered_with_the_jax_flags():
    names = MATH + TENSOR
    assert len(set(names)) == 60
    assert not [n for n in names if not treg.has(n)]
    for n in names:
        j, t = jreg.get(n), treg.get(n)
        assert (j.no_grad, tuple(j.nondiff_inputs)) == \
            (t.no_grad, tuple(t.nondiff_inputs)), n
    assert set(treg.REGISTRY) <= set(jreg.REGISTRY)
    # 179 after the dense op library, 200 with the vision and detection
    # families, 216 with the sequence and CTC families, 242 with the
    # losses, optimizers and metrics
    assert len(set(treg.REGISTRY) & set(jreg.REGISTRY)) == 242


def test_every_case_names_a_type_of_the_slice():
    from test_torch_math_ops import CASES as MCASES
    covered = {c[1] for c in CASES} | {c[1] for c in MCASES} | \
        {r[0] for r in RANDOM}
    assert set(MATH + TENSOR) <= covered
