"""The dense op library's math types in the port against the JAX
package's lowerings, on the same numpy inputs (``ops/math_ops.py``'s
elementwise tail, reductions, norms, products, ``log_softmax`` and
``square_error_cost`` of ``ops/nn_ops.py``, and ``sequence_conv``):
forward outputs and the gradients through each lowering, at the bounds
of ``tests/torch_dense_harness.py``. The cases are the JAX sweeps'
(``tests/test_op_sweep_math.py``, ``test_op_sweep_nn.py``,
``test_op_sweep_rnn_seq.py``) plus one for each place where the obvious
PyTorch call computes something else."""

import numpy as np
import pytest

from torch_dense_harness import check, run_jax, run_port, same, seq

R = np.random.RandomState(42)
X = R.uniform(0.1, 0.9, (3, 4)).astype(np.float32)    # positive domain
XS = (R.rand(3, 4).astype(np.float32) - 0.5) * 4      # signed domain
A = R.rand(2, 3, 4).astype(np.float32) + 0.5
B = R.rand(2, 3, 4).astype(np.float32) + 0.5


def _f(*shape):
    return R.randn(*shape).astype(np.float32)


# (id, op type, inputs, attrs, differentiable here)
CASES = [
    ("max", "elementwise_max", {"X": [A], "Y": [B]}, {}, True),
    ("max_bcast", "elementwise_max", {"X": [A], "Y": [_f(3)]}, {"axis": 1},
     True),
    ("mod", "elementwise_mod", {"X": [A], "Y": [B]}, {}, True),
    # jnp.mod takes the divisor's sign: torch.remainder, not torch.fmod
    ("mod_signs", "elementwise_mod", {"X": [_f(4, 5) * 3],
                                      "Y": [np.where(R.rand(4, 5) > 0.5, 1.0,
                                                     -1.0).astype(np.float32)
                                            * (R.rand(4, 5) + 0.5)
                                            .astype(np.float32)]}, {}, True),
    ("mod_int", "elementwise_mod",
     {"X": [np.array([7, -7, 7, -7, 0], np.int32)],
      "Y": [np.array([3, 3, -3, -3, 5], np.int32)]}, {}, False),
    # piecewise constant: a zero gradient in both packages
    ("floordiv", "elementwise_floordiv", {"X": [A], "Y": [B]}, {}, True),
    ("floordiv_signs", "elementwise_floordiv",
     {"X": [_f(4, 5) * 5], "Y": [_f(4, 5) + 0.1]}, {}, True),
    ("floordiv_int", "elementwise_floordiv",
     {"X": [np.array([7, -7, 7, -7], np.int32)],
      "Y": [np.array([2, 2, -2, -2], np.int32)]}, {}, False),
]
for _r in ("mean", "max", "min", "prod"):
    CASES += [
        ("reduce_%s_dim" % _r, "reduce_" + _r, {"X": [A]}, {"dim": [1]},
         True),
        ("reduce_%s_keep" % _r, "reduce_" + _r, {"X": [A]},
         {"dim": [1], "keep_dim": True}, True),
        ("reduce_%s_all" % _r, "reduce_" + _r, {"X": [A]},
         {"reduce_all": True}, True),
        ("reduce_%s_dims" % _r, "reduce_" + _r, {"X": [A]},
         {"dim": [0, -1], "keep_dim": False}, True),
        ("reduce_%s_all_keep" % _r, "reduce_" + _r, {"X": [A]},
         {"reduce_all": True, "keep_dim": True}, True),
    ]
CASES += [
    ("l1_norm", "l1_norm", {"X": [XS]}, {}, True),
    ("squared_l2_norm", "squared_l2_norm", {"X": [XS]}, {}, True),
    ("squared_l2_distance", "squared_l2_distance",
     {"X": [_f(4, 5)], "Y": [_f(4, 5)]}, {}, True),
    ("squared_l2_distance_3d", "squared_l2_distance",
     {"X": [_f(3, 2, 4)], "Y": [_f(3, 2, 4)]}, {}, True),
    ("frobenius_norm_dim", "frobenius_norm", {"X": [A]}, {"dim": [1, 2]},
     True),
    ("frobenius_norm_all", "frobenius_norm", {"X": [A]}, {}, True),
    ("frobenius_norm_keep", "frobenius_norm", {"X": [A]},
     {"dim": [2], "keep_dim": True}, True),
    ("norm", "norm", {"X": [X]}, {"axis": 1}, True),
    ("norm_last", "norm", {"X": [A]}, {"axis": -1, "epsilon": 1e-6}, True),
    ("isfinite", "isfinite", {"X": [XS]}, {}, False),
    ("isfinite_inf", "isfinite",
     {"X": [np.array([1.0, np.inf, 2.0], np.float32)]}, {}, False),
    ("cumsum", "cumsum", {"X": [XS]}, {"axis": 1}, True),
    ("cumsum_exclusive", "cumsum", {"X": [A]},
     {"axis": 1, "exclusive": True}, True),
    ("cumsum_reverse", "cumsum", {"X": [A]}, {"axis": -1, "reverse": True},
     True),
    ("cumsum_both", "cumsum", {"X": [A]},
     {"axis": 0, "exclusive": True, "reverse": True}, True),
    ("label_smooth", "label_smooth",
     {"X": [np.eye(4, dtype=np.float32)[R.randint(0, 4, 5)]]},
     {"epsilon": 0.1}, True),
    ("label_smooth_prior", "label_smooth",
     {"X": [np.eye(4, dtype=np.float32)[R.randint(0, 4, 5)]],
      "PriorDist": [np.array([[0.1, 0.2, 0.3, 0.4]], np.float32)]},
     {"epsilon": 0.2}, True),
    ("matmul", "matmul", {"X": [_f(3, 4)], "Y": [_f(4, 5)]}, {}, True),
    ("matmul_t", "matmul", {"X": [_f(4, 3)], "Y": [_f(5, 4)]},
     {"transpose_X": True, "transpose_Y": True, "alpha": 0.5}, True),
    ("matmul_batch", "matmul", {"X": [_f(2, 3, 4, 5)], "Y": [_f(5, 6)]},
     {}, True),
    ("matmul_bcast", "matmul", {"X": [_f(2, 1, 3, 4)], "Y": [_f(3, 4, 5)]},
     {"alpha": 2.0}, True),
    ("matmul_heads", "matmul", {"X": [_f(2, 4, 6, 8)], "Y": [_f(2, 4, 6, 8)]},
     {"transpose_Y": True, "alpha": 8 ** -0.5}, True),
    # a 1-D operand stays as it is under transpose_X / transpose_Y
    ("matmul_vec_mat", "matmul", {"X": [_f(4)], "Y": [_f(5, 4)]},
     {"transpose_X": True, "transpose_Y": True}, True),
    ("matmul_vec_vec", "matmul", {"X": [_f(4)], "Y": [_f(4)]},
     {"transpose_Y": True}, True),
    ("dot", "dot", {"X": [_f(3, 5)], "Y": [_f(3, 5)]}, {}, True),
    ("cos_sim", "cos_sim", {"X": [_f(4, 6)], "Y": [_f(4, 6)]}, {}, True),
    ("cos_sim_bcast", "cos_sim", {"X": [_f(4, 6)], "Y": [_f(1, 6)]}, {},
     True),
    ("bilinear", "bilinear_tensor_product",
     {"X": [_f(3, 4)], "Y": [_f(3, 5)], "Weight": [_f(6, 4, 5)]}, {}, True),
    ("bilinear_bias", "bilinear_tensor_product",
     {"X": [_f(3, 4)], "Y": [_f(3, 5)], "Weight": [_f(6, 4, 5)],
      "Bias": [_f(1, 6)]}, {}, True),
    ("iou", "iou_similarity",
     {"X": [np.array([[0, 0, 2, 2], [1, 1, 3, 3]], np.float32)],
      "Y": [np.array([[0, 0, 2, 2]], np.float32)]}, {}, True),
    ("iou_random", "iou_similarity",
     {"X": [np.sort(R.rand(5, 2, 2), 1).reshape(5, 4).astype(np.float32)],
      "Y": [np.sort(R.rand(3, 2, 2), 1).reshape(3, 4).astype(np.float32)]},
     {}, True),
    ("log_softmax", "log_softmax", {"X": [_f(4, 5)]}, {}, True),
    ("log_softmax_axis0", "log_softmax", {"X": [_f(4, 5) * 10]},
     {"axis": 0}, True),
    ("log_softmax_seq", "log_softmax", {"X": [seq(_f(2, 4, 5), [4, 2])]},
     {}, True),
    ("square_error_cost", "square_error_cost",
     {"X": [_f(4, 1)], "Y": [_f(4, 1)]}, {}, True),
    ("sequence_conv", "sequence_conv",
     {"X": [seq(_f(2, 4, 2), [4, 3])], "Filter": [_f(6, 4)]},
     {"contextLength": 3, "contextStart": -1}, True),
    ("sequence_conv_ahead", "sequence_conv",
     {"X": [seq(_f(3, 5, 3), [5, 1, 3])], "Filter": [_f(12, 2)]},
     {"contextLength": 4, "contextStart": 0}, True),
    ("sequence_conv_behind", "sequence_conv",
     {"X": [seq(_f(2, 6, 2), [6, 4])], "Filter": [_f(4, 3)]},
     {"contextLength": 2, "contextStart": -2}, True),
]


@pytest.mark.parametrize("type,ins,attrs,grad",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_math_op_matches_the_jax_lowering(type, ins, attrs, grad):
    check(type, ins, attrs, grad)


def test_sequence_conv_zeroes_steps_past_each_length():
    s = seq(_f(2, 5, 3), [5, 2])
    out = run_port("sequence_conv", {"X": [s], "Filter": [_f(9, 4)]},
                   {"contextLength": 3, "contextStart": -1})["Out"][0]
    assert not out[1, 2:].any() and out[0].all()


def test_matmul_1d_operand_is_not_transposed():
    """``transpose_X`` on a 1-D X is a no-op in both packages: [4] @ [4, 5]
    gives [5] (a transpose to [4, 1] first would not multiply)."""
    ins = {"X": [_f(4)], "Y": [_f(4, 5)]}
    j = run_jax("matmul", ins, {"transpose_X": True})
    t = run_port("matmul", ins, {"transpose_X": True})
    same(j, t)
    assert t["Out"][0].shape == (5,)


def test_isfinite_is_one_boolean():
    t = run_port("isfinite", {"X": [np.array([[1.0, np.nan]], np.float32)]},
                 {})["Out"][0]
    assert t.shape == () and t.dtype == np.bool_ and not t
