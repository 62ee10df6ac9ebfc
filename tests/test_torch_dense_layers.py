"""The dense op library's layers, ``nets`` compositions and initializers
in the port against the JAX package, on the CPU.

* Each of the 49 layer names builds a program (main and startup) whose
  JSON is byte-identical to the JAX package's.
* ``nets.sequence_conv_pool``, ``nets.glu`` and
  ``nets.scaled_dot_product_attention`` run against the JAX ones on the
  same weights (the JAX startup's scope carried over by
  ``interop.load_reference_state``): outputs and one SGD step's
  parameter gradients within rtol 1e-5 (atol 1e-6 of the largest
  magnitude).
* ``Bilinear`` and ``NumpyArrayInitializer`` give exactly the JAX
  package's values; ``TruncatedNormal`` and ``MSRA`` draw other numbers
  (another generator) and are held to their bounds and moments."""

import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import layers as jlayers
from paddle_tpu import nets as jnets
from paddle_tpu import unique_name as jnames
from paddle_tpu_torch import interop
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import nets as tnets
from paddle_tpu_torch import unique_name as tnames

_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, os.cpu_count() // int(_WORKERS)))

CPU = tfluid.CPUPlace()


def _pkg(fluid):
    if fluid is jfluid:
        return jlayers, jnames, jnets
    return tlayers, tnames, tnets


def _dump(prog):
    return json.dumps(prog.to_dict(), sort_keys=True, indent=1)


def _body(fluid, layers, name):
    """One use of layer ``name`` over small data vars."""
    x = layers.data("x", [3, 4])
    a = layers.data("a", [6])
    b = layers.data("b", [5])
    ids = layers.data("ids", [1], dtype="int64")
    img = layers.data("img", [3, 8, 8])
    words = layers.data("words", [4], lod_level=1)
    init = fluid.initializer
    calls = {
        "mul": lambda: layers.mul(a, layers.create_parameter([6, 5],
                                                             "float32")),
        "matmul": lambda: layers.matmul(x, x, transpose_y=True, alpha=0.5),
        "reduce_mean": lambda: layers.reduce_mean(x, dim=1, keep_dim=True),
        "reduce_max": lambda: layers.reduce_max(x),
        "reduce_min": lambda: layers.reduce_min(x, dim=[1, 2]),
        "reduce_prod": lambda: layers.reduce_prod(x, dim=-1),
        "split": lambda: (layers.split(x, [1, 2], dim=1),
                          layers.split(x, 2, dim=-1)),
        "stack": lambda: layers.stack([x, x], axis=1),
        "unstack": lambda: layers.unstack(x, axis=1),
        "expand": lambda: layers.expand(x, [1, 2, 1]),
        "flatten": lambda: layers.flatten(x, axis=2),
        "gather": lambda: layers.gather(a, ids),
        "gather_nd": lambda: layers.gather_nd(
            x, layers.data("idx2", [2], dtype="int64")),
        "scatter": lambda: layers.scatter(a, ids, layers.data("u", [6]),
                                          overwrite=False),
        "slice": lambda: layers.slice(x, axes=[1, 2], starts=[0, -3],
                                      ends=[2, 100]),
        "strided_slice": lambda: layers.strided_slice(
            x, axes=[2], starts=[-1], ends=[-5], strides=[-2]),
        "shape": lambda: layers.shape(x),
        "one_hot": lambda: layers.one_hot(ids, 10),
        "pad": lambda: layers.pad(x, [0, 0, 1, 0, 0, 2], pad_value=0.5),
        "pad2d": lambda: layers.pad2d(img, [1, 0, 2, 1], mode="reflect"),
        "cumsum": lambda: layers.cumsum(x, axis=1, exclusive=True,
                                        reverse=True),
        "l2_normalize": lambda: layers.l2_normalize(x, axis=-1),
        "label_smooth": lambda: layers.label_smooth(
            layers.one_hot(ids, 4), epsilon=0.2),
        "multiplex": lambda: layers.multiplex(
            [a, a], layers.data("mi", [1], dtype="int32")),
        "cos_sim": lambda: layers.cos_sim(a, layers.fc(b, 6)),
        "square_error_cost": lambda: layers.square_error_cost(
            layers.fc(a, 1), layers.data("y", [1])),
        "sequence_conv": lambda: layers.sequence_conv(words, 6, 3,
                                                      act="tanh"),
        "bilinear_tensor_product": lambda: layers.bilinear_tensor_product(
            a, b, 7, act="relu"),
        "hash": lambda: layers.hash(ids, 1000, num_hash=2),
        "sampling_id": lambda: layers.sampling_id(
            layers.softmax(layers.fc(a, 4)), seed=3),
        "similarity_focus": lambda: layers.similarity_focus(img, 1, [0, 2]),
        "argsort": lambda: layers.argsort(x, axis=1),
        "unique_with_counts": lambda: layers.unique_with_counts(ids),
        "random_crop": lambda: layers.random_crop(img, [3, 5, 5], seed=2),
        "row_conv": lambda: layers.row_conv(words, 2, act="relu"),
        "gaussian_random": lambda: layers.gaussian_random([3, 4], std=2.0,
                                                          seed=1),
        "uniform_random_batch_size_like": lambda:
            layers.uniform_random_batch_size_like(x, [-1, 7], min=0.0),
        "gaussian_random_batch_size_like": lambda:
            layers.gaussian_random_batch_size_like(x, [-1, 7], std=0.5),
        "create_tensor": lambda: layers.create_tensor("float32"),
        "create_parameter": lambda: [
            layers.create_parameter([3, 4], "float32"),
            layers.create_parameter([4], "float32", is_bias=True),
            layers.create_parameter(
                [8, 3, 3, 3], "float32", attr=fluid.ParamAttr(
                    initializer=init.MSRA(uniform=False))),
            layers.create_parameter(
                [5, 6], "float32",
                default_initializer=init.TruncatedNormal(0.1, 0.5, seed=4)),
            layers.create_parameter(
                [4, 2, 4, 4], "float32",
                default_initializer=init.Bilinear()),
            layers.create_parameter(
                [2, 3], "float32", default_initializer=init.
                NumpyArrayInitializer(np.arange(6.0).reshape(2, 3)))],
        "sums": lambda: layers.sums([x, x, x]),
        "ones": lambda: layers.ones([2, 3], "float32"),
        "zeros": lambda: layers.zeros([2, 3], "int32"),
        "zeros_like": lambda: layers.zeros_like(x),
        "argmin": lambda: layers.argmin(x, axis=1),
        "argmax": lambda: layers.argmax(x, axis=2),
        "reverse": lambda: layers.reverse(x, 1),
        "linspace": lambda: layers.linspace(0, 1, 5),
        "range": lambda: layers.range(0, 10, 2, "int32"),
    }
    return calls[name]()


NAMES = ["mul", "matmul", "reduce_mean", "reduce_max", "reduce_min",
         "reduce_prod", "split", "stack", "unstack", "expand", "flatten",
         "gather", "gather_nd", "scatter", "slice", "strided_slice", "shape",
         "one_hot", "pad", "pad2d", "cumsum", "l2_normalize", "label_smooth",
         "multiplex", "cos_sim", "square_error_cost", "sequence_conv",
         "bilinear_tensor_product", "hash", "sampling_id",
         "similarity_focus", "argsort", "unique_with_counts", "random_crop",
         "row_conv", "gaussian_random", "uniform_random_batch_size_like",
         "gaussian_random_batch_size_like", "create_tensor",
         "create_parameter", "sums", "ones", "zeros", "zeros_like", "argmin",
         "argmax", "reverse", "linspace", "range"]


def _program(fluid, body):
    layers, names, nets = _pkg(fluid)
    with names.guard():
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            out = body(fluid, layers, nets)
    return prog, startup, out


def test_the_slice_names_its_49_layers():
    assert len(set(NAMES)) == 49
    assert not [n for n in NAMES if not hasattr(tlayers, n)]
    assert set(NAMES) <= set(tlayers.nn.__all__) | set(tlayers.tensor.__all__)


@pytest.mark.parametrize("name", NAMES)
def test_layer_builds_the_jax_packages_json(name):
    j = _program(jfluid, lambda f, l_, n: _body(f, l_, name))
    t = _program(tfluid, lambda f, l_, n: _body(f, l_, name))
    assert _dump(t[0]) == _dump(j[0])
    assert _dump(t[1]) == _dump(j[1])


# ---- the vision family's layers, the family-1 layers and the
# detection layers ----

def _vision_body(fluid, layers, name):
    """One use of a vision, family-1 or detection layer over small data
    vars."""
    img = layers.data("img", [3, 8, 8])
    vol = layers.data("vol", [2, 5, 6, 5])
    words = layers.data("words", [4], lod_level=1)
    ids = layers.data("ids", [1], dtype="int64")
    det = layers.detection
    feat = layers.data("feat", [8, 4, 4])
    boxes = layers.data("boxes", [6, 4])

    def prior():
        return det.prior_box(feat, img, [4.0], [6.0], [2.0, 3.0], flip=True,
                             clip=True, steps=(2.0, 2.0), offset=0.4)
    calls = {
        "conv3d": lambda: layers.conv3d(vol, 3, 3, padding=1, act="relu"),
        "conv2d_transpose": lambda: [
            layers.conv2d_transpose(img, 4, filter_size=3, stride=2,
                                    padding=1),
            layers.conv2d_transpose(img, 4, output_size=16, stride=2,
                                    padding=1, groups=1, act="relu")],
        "pool3d": lambda: layers.pool3d(vol, 2, "avg", 2, ceil_mode=True,
                                        exclusive=False),
        "max_pool3d_with_index": lambda: layers.max_pool3d_with_index(
            vol, 2, 2, 1),
        "conv3d_transpose": lambda: layers.conv3d_transpose(
            vol, 4, output_size=[10, 12, 10], filter_size=2, stride=2,
            groups=2),
        "unpool": lambda: layers.unpool(
            layers.data("pm", [3, 4, 4]),
            layers.data("mk", [3, 4, 4], dtype="int32"), 2, 2),
        "spp": lambda: layers.spp(img, 2, "avg"),
        "im2sequence": lambda: layers.im2sequence(img, 2, 2),
        "grid_sampler": lambda: layers.grid_sampler(
            img, layers.data("grid", [4, 4, 2])),
        "image_resize": lambda: layers.image_resize(img, scale=1.5),
        "resize_bilinear": lambda: layers.resize_bilinear(img, [5, 7]),
        "resize_nearest": lambda: layers.resize_nearest(img, [16, 16]),
        "group_norm": lambda: layers.group_norm(img, 3, act="relu"),
        "batch_norm_1d": lambda: layers.batch_norm_1d(layers.data("v", [6])),
        "sequence_last_step": lambda: layers.sequence_last_step(words),
        "dice_loss": lambda: layers.dice_loss(
            layers.softmax(layers.fc(layers.data("a", [6]), 4)), ids),
        "WeightNormParamAttr": lambda: layers.fc(
            layers.data("b", [5]), 3, param_attr=fluid.WeightNormParamAttr(
                dim=0, name="wn")),
        "prior_box": prior,
        "box_coder": lambda: det.box_coder(
            layers.reshape(prior()[0], [-1, 4]),
            layers.reshape(prior()[1], [-1, 4]), boxes),
        "iou_similarity": lambda: det.iou_similarity(boxes, boxes),
        "bipartite_match": lambda: det.bipartite_match(
            layers.data("dist", [5]), "per_prediction", 0.4),
        "target_assign": lambda: det.target_assign(
            boxes, layers.data("match", [7], dtype="int32"), -1),
        "multiclass_nms": lambda: det.multiclass_nms(
            boxes, layers.data("scores", [3, 6]), 0.05, 4, 5, 0.4, 1),
        "mine_hard_examples": lambda: det.mine_hard_examples(
            layers.data("cls_loss", [7]),
            layers.data("match", [7], dtype="int32"), 2.0),
        "detection_map": lambda: det.detection_map(
            layers.data("dets", [5, 6]), layers.data("gt", [3, 5]), 0.4),
        "detection_output": lambda: det.detection_output(
            layers.data("loc", [6, 4]), layers.data("sc", [6, 3]),
            layers.data("pb", [4]), layers.data("pv", [4]),
            nms_threshold=0.45, keep_top_k=3),
        "ssd_loss": lambda: det.ssd_loss(
            layers.data("loc", [6, 4]), layers.data("conf", [6, 3]),
            layers.data("gb", [2, 4]),
            layers.data("gl", [2, 1], dtype="int64"),
            layers.data("pb", [4]), layers.data("pv", [4]),
            overlap_threshold=0.4, neg_pos_ratio=2.0),
    }
    return calls[name]()


VISION_NAMES = ["conv3d", "conv2d_transpose", "pool3d",
                "max_pool3d_with_index", "conv3d_transpose", "unpool", "spp",
                "im2sequence", "grid_sampler", "image_resize",
                "resize_bilinear", "resize_nearest"]
FAMILY1_NAMES = ["group_norm", "batch_norm_1d", "sequence_last_step",
                 "dice_loss", "WeightNormParamAttr"]
DETECTION_NAMES = ["prior_box", "box_coder", "iou_similarity",
                   "bipartite_match", "detection_output", "ssd_loss",
                   "target_assign", "multiclass_nms", "mine_hard_examples",
                   "detection_map"]


def test_the_slice_names_its_layers():
    import paddle_tpu.layers.detection as jdet

    assert set(DETECTION_NAMES) == set(jdet.__all__) == \
        set(tlayers.detection.__all__)
    assert all(hasattr(tlayers, n) for n in VISION_NAMES + FAMILY1_NAMES[:-1])
    assert set(VISION_NAMES + FAMILY1_NAMES[:-1]) <= set(tlayers.nn.__all__)
    assert tfluid.WeightNormParamAttr(dim=1, name="w").dim == 1


@pytest.mark.parametrize("name", VISION_NAMES + FAMILY1_NAMES +
                         DETECTION_NAMES)
def test_vision_and_detection_layer_builds_the_jax_packages_json(name):
    j = _program(jfluid, lambda f, l_, n: _vision_body(f, l_, name))
    t = _program(tfluid, lambda f, l_, n: _vision_body(f, l_, name))
    assert _dump(t[0]) == _dump(j[0])
    assert _dump(t[1]) == _dump(j[1])


def test_gaussian_random_batch_size_like_emits_a_uniform_draw():
    """Both packages emit ``uniform_random_batch_size_like`` in mean +/- 3
    std (ROADMAP.md Queue 3): the port keeps the JSON identical."""
    prog, _, out = _program(tfluid, lambda f, l_, n:
                            l_.gaussian_random_batch_size_like(
                                l_.data("x", [3]), [-1, 4], mean=1.0,
                                std=0.5))
    op = prog.global_block().ops[-1]
    assert op.type == "uniform_random_batch_size_like"
    assert (op.attrs["min"], op.attrs["max"]) == (-0.5, 2.5)


# ---- nets against the JAX package on the same weights ----

def _nets_case(which):
    def body(fluid, layers, nets):
        if which == "sequence_conv_pool":
            x = layers.data("x", [5], lod_level=1)
            out = nets.sequence_conv_pool(x, num_filters=4, filter_size=3,
                                          act="tanh", pool_type="sum")
        elif which == "glu":
            x = layers.data("x", [3, 6])
            out = nets.glu(layers.fc(x, 8, num_flatten_dims=2), dim=-1)
        else:
            x = layers.data("x", [6, 8])
            q = layers.fc(x, 8, num_flatten_dims=2)
            # no key bias: softmax over the keys cancels its gradient to
            # rounding noise in both packages
            k = layers.fc(x, 8, num_flatten_dims=2, bias_attr=False)
            out = nets.scaled_dot_product_attention(
                q, k, x, num_heads=2 if which == "attention_heads" else 1)
        loss = layers.mean(layers.square(out))
        fluid.optimizer.SGD(0.1).minimize(loss)
        return out, loss
    return body


def _nets_feed(which):
    rng = np.random.RandomState(3)
    if which == "sequence_conv_pool":
        return {"x": [rng.randn(n, 5).astype(np.float32) for n in (4, 2, 5)]}
    if which == "glu":
        return {"x": rng.randn(4, 3, 6).astype(np.float32)}
    return {"x": rng.randn(3, 6, 8).astype(np.float32)}


@pytest.mark.parametrize("which", ["sequence_conv_pool", "glu", "attention",
                                   "attention_heads"])
def test_nets_match_the_jax_package_on_its_weights(which):
    jp, js, (jout, jloss) = _program(jfluid, _nets_case(which))
    tp, ts, (tout, tloss) = _program(tfluid, _nets_case(which))
    assert _dump(tp) == _dump(jp)
    jscope = jfluid.Scope()
    jexe = jfluid.Executor()
    jexe.run(js, scope=jscope)
    arrays = {v.name: np.asarray(jscope.find_var(v.name))
              for v in jp.list_vars() if v.persistable}
    tscope = tfluid.Scope()
    interop.load_reference_state(arrays, tscope, CPU, [tp, ts])
    grads = sorted(p.name + "@GRAD" for p in jp.global_block()
                   .all_parameters())
    feed = _nets_feed(which)
    fetch = [jout.name, jloss.name] + grads
    j = jexe.run(jp, feed=feed, fetch_list=fetch, scope=jscope)
    t = tfluid.Executor(CPU).run(tp, feed=feed, fetch_list=fetch,
                                 scope=tscope)
    for name, a, b in zip(fetch, j, t):
        a = np.asarray(a.data if hasattr(a, "lengths") else a)
        b = np.asarray(b.data if hasattr(b, "lengths") else b)
        np.testing.assert_allclose(b, a, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(a).max()),
                                   err_msg=name)


# ---- initializers ----

def _startup_values(fluid, make):
    prog, startup, _ = _program(fluid, lambda f, l_, n: make(f, l_))
    scope = fluid.Scope()
    exe = fluid.Executor(CPU) if fluid is tfluid else fluid.Executor()
    exe.run(startup, scope=scope)
    return {p.name: np.asarray(scope.find_var(p.name))
            for p in prog.global_block().all_parameters()}


@pytest.mark.parametrize("shape,which", [
    ([4, 2, 4, 4], "bilinear"), ([3, 3, 5, 5], "bilinear"),
    ([2, 3], "numpy"), ([2, 2, 2], "numpy_int")])
def test_bilinear_and_numpy_initializers_match_exactly(shape, which):
    def make(fluid, layers):
        init = fluid.initializer
        if which == "bilinear":
            i = init.Bilinear()
        else:
            v = np.arange(np.prod(shape)).reshape(shape)
            i = init.NumpyArrayInitializer(
                v.astype(np.int32 if which == "numpy_int" else np.float32))
        return layers.create_parameter(
            shape, "int32" if which == "numpy_int" else "float32",
            default_initializer=i)
    j = _startup_values(jfluid, make)
    t = _startup_values(tfluid, make)
    assert sorted(j) == sorted(t)
    for n in j:
        np.testing.assert_array_equal(t[n], j[n])
        assert t[n].dtype == j[n].dtype


@pytest.mark.parametrize("which", ["truncated", "msra_uniform",
                                   "msra_normal"])
def test_truncated_normal_and_msra_bounds_and_moments(which):
    shape = [256, 192]
    fan_in = 256

    def make(fluid, layers):
        init = fluid.initializer
        i = {"truncated": init.TruncatedNormal(0.1, 0.5, seed=1),
             "msra_uniform": init.MSRAInitializer(seed=2),
             "msra_normal": init.MSRA(uniform=False)}[which]
        return layers.create_parameter(shape, "float32",
                                       default_initializer=i)
    (w,) = _startup_values(tfluid, make).values()
    (jw,) = _startup_values(jfluid, make).values()
    assert w.shape == jw.shape == tuple(shape)
    for v in (w, jw):
        if which == "truncated":
            z = (v - 0.1) / 0.5
            assert np.abs(z).max() <= 2.0 + 1e-5
            assert abs(z.mean()) < 0.02 and abs(z.std() - 0.8796) < 0.02
        elif which == "msra_uniform":
            lim = (6.0 / fan_in) ** 0.5
            assert np.abs(v).max() <= lim
            assert abs(v.std() - lim / 3 ** 0.5) < 0.02 * lim
        else:
            assert abs(v.std() - (2.0 / fan_in) ** 0.5) < 0.02 * \
                (2.0 / fan_in) ** 0.5
            assert abs(v.mean()) < 0.02 * (2.0 / fan_in) ** 0.5
