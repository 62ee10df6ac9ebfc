"""The vision op family in the port against the JAX package's lowerings
(``ops/nn_ops.py``: ``conv3d``, ``conv2d_transpose``,
``conv3d_transpose``, ``pool3d``, ``pool2d_with_index``,
``max_pool3d_with_index``, ``unpool``, ``spp``, ``im2sequence``;
``ops/tensor_ops.py``: ``resize_nearest``, ``resize_bilinear``,
``grid_sampler``, ``roi_pool``), on the same numpy inputs, forward and
backward (autograd against ``jax.vjp``), at the bounds of
``tests/torch_dense_harness.py``: floats within rtol 1e-5 plus 1e-6 of
the largest magnitude, integers (the pools' masks) exact.

The cases are the JAX sweeps' (``tests/test_op_sweep_nn.py``,
``tests/test_op_sweep_tensor.py``, ``tests/test_detection.py``) and one
for each place where the obvious PyTorch call computes something else:
groups and dilation in the transposed convolutions, an ``output_size``
past the library's ``output_padding`` limit, ceil mode and the
non-exclusive average in ``pool3d``, a padded window of equal negative
values in ``pool2d_with_index``, duplicate unpooling targets (the last
wins), the antialiased shrink of ``jax.image.resize``, samples outside
the image in ``grid_sampler``, and bins whose bounds come from
``jnp.linspace``'s float32 steps in ``roi_pool``."""

import numpy as np
import pytest

from paddle_tpu.core import registry as jreg
from paddle_tpu_torch.core import registry as treg
from torch_dense_harness import check, run_port

R = np.random.RandomState(11)


def _f(*shape):
    return R.randn(*shape).astype(np.float32)


CASES = [
    ("conv3d", "conv3d", {"Input": [_f(1, 2, 5, 5, 5)],
                          "Filter": [_f(3, 2, 3, 3, 3)]},
     {"strides": [1, 1, 1], "paddings": [0, 0, 0]}),
    ("conv3d_groups_dilated", "conv3d",
     {"Input": [_f(2, 4, 5, 6, 5)], "Filter": [_f(4, 2, 3, 3, 3)]},
     {"strides": [2, 1, 1], "paddings": [1, 1, 0], "dilations": [1, 2, 1],
      "groups": 2}),
    ("conv2d_transpose", "conv2d_transpose",
     {"Input": [_f(1, 2, 4, 4)], "Filter": [_f(2, 3, 3, 3)]},
     {"strides": [2, 2], "paddings": [1, 1]}),
    ("conv2d_transpose_groups_dilated", "conv2d_transpose",
     {"Input": [_f(2, 4, 5, 4)], "Filter": [_f(4, 3, 3, 2)]},
     {"strides": [2, 1], "paddings": [0, 1], "dilations": [2, 1],
      "groups": 2}),
    ("conv2d_transpose_decoder", "conv2d_transpose",
     {"Input": [_f(2, 8, 5, 5)], "Filter": [_f(8, 4, 4, 4)]},
     {"strides": [2, 2], "paddings": [1, 1]}),
    ("conv3d_transpose_output_size", "conv3d_transpose",
     {"Input": [_f(1, 2, 3, 3, 3)], "Filter": [_f(2, 3, 3, 3, 3)]},
     {"strides": [2, 2, 2], "paddings": [1, 1, 1],
      "output_size": [6, 7, 5]}),
    ("conv3d_transpose_groups", "conv3d_transpose",
     {"Input": [_f(1, 4, 3, 3, 3)], "Filter": [_f(4, 2, 2, 3, 3)]},
     {"strides": [2, 1, 2], "paddings": [0, 1, 0], "groups": 2,
      "dilations": [1, 2, 1]}),
    ("pool3d_max_ceil", "pool3d", {"X": [_f(2, 2, 5, 6, 5)]},
     {"pooling_type": "max", "ksize": [2, 3, 2], "strides": [2, 2, 2],
      "paddings": [1, 0, 1], "ceil_mode": True}),
    ("pool3d_avg_exclusive", "pool3d", {"X": [_f(2, 2, 5, 6, 5)]},
     {"pooling_type": "avg", "ksize": [2, 3, 2], "strides": [2, 2, 2],
      "paddings": [1, 1, 0]}),
    ("pool3d_avg_inclusive", "pool3d", {"X": [_f(2, 2, 5, 6, 5)]},
     {"pooling_type": "avg", "ksize": [2, 2, 2], "strides": [2, 2, 2],
      "paddings": [1, 1, 0], "exclusive": False}),
    ("pool3d_global", "pool3d", {"X": [_f(2, 2, 4, 4, 4)]},
     {"pooling_type": "avg", "global_pooling": True}),
    ("pool2d_with_index", "pool2d_with_index", {"X": [_f(2, 2, 6, 6)]},
     {"ksize": [2, 2], "strides": [2, 2]}),
    ("pool2d_with_index_negative_padded", "pool2d_with_index",
     {"X": [np.full((1, 1, 4, 4), -5.0, np.float32)]},
     {"ksize": [2, 2], "strides": [2, 2], "paddings": [1, 1]}),
    ("pool2d_with_index_odd", "pool2d_with_index", {"X": [_f(2, 2, 7, 6)]},
     {"ksize": [3, 2], "strides": [2, 1], "paddings": [1, 1]}),
    ("max_pool3d_with_index", "max_pool3d_with_index",
     {"X": [_f(1, 2, 5, 6, 4)]},
     {"ksize": [2, 3, 2], "strides": [2, 2, 1], "paddings": [1, 1, 0]}),
    ("unpool", "unpool", {"X": [_f(2, 2, 3, 3)], "Indices": [
        R.randint(0, 36, (2, 2, 3, 3)).astype(np.int32)]},
     {"ksize": [2, 2], "strides": [2, 2]}),
    ("unpool_duplicates", "unpool", {"X": [_f(1, 1, 2, 2)], "Indices": [
        np.array([[[[3, 3], [3, 0]]]], np.int32)]},
     {"ksize": [2, 2], "strides": [2, 2]}),
    ("spp_max", "spp", {"X": [_f(2, 3, 7, 5)]},
     {"pyramid_height": 3, "pooling_type": "max"}),
    ("spp_avg", "spp", {"X": [_f(2, 3, 7, 5)]},
     {"pyramid_height": 3, "pooling_type": "avg"}),
    ("im2sequence", "im2sequence", {"X": [_f(1, 2, 4, 4)]},
     {"kernels": [2, 2], "strides": [2, 2]}),
    ("im2sequence_strided", "im2sequence", {"X": [_f(2, 3, 5, 6)]},
     {"kernels": [3, 2], "strides": [1, 2], "paddings": [1, 1]}),
    ("resize_nearest_down", "resize_nearest", {"X": [_f(1, 2, 4, 4)]},
     {"out_h": 2, "out_w": 2}),
    ("resize_nearest_up", "resize_nearest", {"X": [_f(2, 2, 5, 3)]},
     {"out_h": 7, "out_w": 8}),
    ("resize_bilinear_up", "resize_bilinear", {"X": [_f(1, 2, 4, 4)]},
     {"out_h": 8, "out_w": 8}),
    ("resize_bilinear_shrink", "resize_bilinear", {"X": [_f(2, 3, 9, 7)]},
     {"out_h": 4, "out_w": 11}),
    ("resize_bilinear_one_dim", "resize_bilinear", {"X": [_f(2, 3, 9, 7)]},
     {"out_h": 9, "out_w": 3}),
    ("grid_sampler", "grid_sampler", {"X": [_f(2, 3, 5, 6)], "Grid": [
        (R.rand(2, 4, 3, 2) * 2.4 - 1.2).astype(np.float32)]}, {}),
    ("roi_pool", "roi_pool", {
        "X": [np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4)],
        "ROIs": [np.array([[0, 0, 0, 3, 3]], np.float32)]},
     {"pooled_height": 2, "pooled_width": 2, "spatial_scale": 1.0}),
    ("roi_pool_scaled", "roi_pool", {"X": [_f(2, 3, 12, 10)], "ROIs": [
        np.array([[0, 1, 2, 7, 9], [1, 0, 0, 9, 11], [1, 3.4, 2.6, 5.5, 4.5]],
                 np.float32)]},
     {"pooled_height": 3, "pooled_width": 2, "spatial_scale": 0.8}),
    ("roi_pool_four_columns", "roi_pool", {"X": [_f(1, 2, 9, 9)], "ROIs": [
        np.array([[0, 0, 8, 8], [2, 1, 4, 7]], np.float32)]},
     {"pooled_height": 7, "pooled_width": 3, "spatial_scale": 1.0}),
]

TYPES = ["conv3d", "conv2d_transpose", "conv3d_transpose", "pool3d",
         "pool2d_with_index", "max_pool3d_with_index", "unpool", "spp",
         "im2sequence", "resize_nearest", "resize_bilinear", "grid_sampler",
         "roi_pool"]


@pytest.mark.parametrize("name,type,ins,attrs", CASES,
                         ids=[c[0] for c in CASES])
def test_vision_type_matches_the_jax_lowering(name, type, ins, attrs):
    check(type, ins, attrs)


def test_the_cases_cover_the_13_vision_types():
    assert sorted({c[1] for c in CASES}) == sorted(TYPES)
    assert all(treg.has(t) and jreg.has(t) for t in TYPES)


def test_known_answers():
    """tests/test_op_sweep_{nn,tensor}.py's reference values."""
    x = np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4)
    out = run_port("roi_pool", {"X": [x], "ROIs": [np.array(
        [[0, 0, 0, 3, 3]], np.float32)]}, {"pooled_height": 2,
                                             "pooled_width": 2})["Out"][0]
    np.testing.assert_array_equal(out[0, 0], [[5, 7], [13, 15]])
    a = _f(1, 2, 4, 4)
    np.testing.assert_array_equal(run_port(
        "resize_nearest", {"X": [a]}, {"out_h": 2, "out_w": 2})["Out"][0],
        a[:, :, ::2, ::2])
    assert run_port("im2sequence", {"X": [a]}, {
        "kernels": [2, 2], "strides": [2, 2]})["Out"][0].shape == (1, 4, 8)
    ys, xs = np.meshgrid(np.linspace(-1, 1, 5), np.linspace(-1, 1, 5),
                         indexing="ij")
    img = _f(1, 2, 5, 5)
    np.testing.assert_allclose(run_port("grid_sampler", {
        "X": [img], "Grid": [np.stack([xs, ys], -1)[None].astype(
            np.float32)]}, {})["Output"][0], img, atol=1e-5)
    out = run_port("pool2d_with_index", {"X": [np.full(
        (1, 1, 4, 4), -5.0, np.float32)]}, {"ksize": [2, 2], "strides": [
            2, 2], "paddings": [1, 1]})
    assert (out["Out"][0] == -5.0).all()
    assert ((out["Mask"][0] >= 0) & (out["Mask"][0] < 16)).all()


def test_conv3d_transpose_refuses_an_unreachable_output_size():
    ins = {"Input": [_f(1, 2, 3, 3, 3)], "Filter": [_f(2, 3, 3, 3, 3)]}
    with pytest.raises(ValueError, match="unreachable"):
        run_port("conv3d_transpose", ins, {
            "strides": [2, 2, 2], "paddings": [1, 1, 1],
            "output_size": [8, 5, 5]})


def test_the_port_registers_200_of_the_jax_packages_250_types():
    jtypes, ttypes = set(jreg.REGISTRY), set(treg.REGISTRY)
    assert len(jtypes) == 250
    # 200 with the vision and detection families, 216 since the sequence
    # and CTC families, 242 since the losses, optimizers and metrics
    assert len(jtypes & ttypes) == 242
    assert set(TYPES) <= ttypes
