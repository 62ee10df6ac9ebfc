"""v2 composable layers.

Capability parity: `python/paddle/v2/layer.py` + the
trainer_config_helpers layer DSL it wraps (SURVEY §2.9). Each call emits
ops into the default Program through the fluid-style layers, so v2 models
share the IR, executor and autodiff with the fluid frontend (the
reference maintained a second 53k-LoC C++ stack for this), and a v2
program's JSON is byte-identical to paddle_tpu's.

v2 signature style is keyword-based: ``layer.fc(input=x, size=10,
act=activation.Softmax())``.
"""

from paddle_tpu_torch import layers as L
from paddle_tpu_torch import nets as N
from paddle_tpu_torch.v2.activation import act_name
from paddle_tpu_torch.v2.data_type import InputType
from paddle_tpu_torch.v2.pooling import pool_name

__all__ = ["data", "fc", "embedding", "lstmemory", "gru", "simple_lstm",
           "conv2d", "img_conv", "img_pool", "simple_img_conv_pool",
           "batch_norm", "dropout", "concat", "pooling",
           "first_seq", "last_seq", "classification_cost",
           "cross_entropy_cost", "square_error_cost", "mse_cost",
           "accuracy",
           # composition / math layers
           "addto", "cos_sim", "trans", "scaling", "slope_intercept",
           "power", "interpolation", "sum_to_one_norm", "img_cmrnorm",
           "max_id", "seq_concat", "expand",
           # costs
           "rank_cost", "huber_regression_cost", "smooth_l1_cost",
           "multi_binary_label_cross_entropy_cost", "crf", "crf_decoding",
           "ctc", "nce",
           # mixed DSL + projections
           "mixed", "full_matrix_projection", "identity_projection",
           "table_projection", "dotmul_projection", "context_projection",
           # recurrent
           "recurrent_group", "memory",
           # round-3 breadth
           "clip", "pad", "maxout", "prelu", "multiplex", "row_conv",
           # round-4 tail
           "AggregateLevel", "ExpandLevel", "LayerType", "LayerOutput",
           "layer_support", "grumemory", "regression_cost", "mse_cost",
           "maxid_layer", "convex_comb_layer", "print_layer",
           "sub_nested_seq_layer", "BeamInput", "cross_entropy_over_beam",
           "block_expand", "hsigmoid", "spp", "conv_shift", "sampling_id",
           "eos", "kmax_seq_score", "seq_reshape", "seq_slice", "sub_seq",
           "repeat", "rotate", "switch_order", "resize", "crop",
           "bilinear_interp", "upsample", "roi_pool", "cross_channel_norm",
           "row_l2_norm", "scale_shift", "out_prod", "dot_prod",
           "l2_distance", "linear_comb", "tensor", "factorization_machine",
           "gated_unit", "get_output", "printer", "cross_entropy",
           "cross_entropy_with_selfnorm", "huber_classification_cost",
           "sum_cost", "warp_ctc", "img_conv3d", "img_pool3d",
           "dotmul_operator", "conv_operator", "conv_projection",
           "scaling_projection", "slice_projection",
           "trans_full_matrix_projection", "selective_fc", "lstm_step",
           "gru_step", "gru_step_naive", "recurrent", "priorbox",
           "detection_output", "multibox_loss", "beam_search",
           "StaticInput", "GeneratedInput", "BaseGeneratedInput",
           "SubsequenceInput", "scale_sub_region", "lambda_cost",
           "multi_binary_label_cross_entropy"]


def data(name, type):
    assert isinstance(type, InputType), "use paddle.v2.data_type.*"
    var = L.data(name, type.shape, dtype=type.dtype,
                 lod_level=type.seq_level)
    if type.dtype == "int64":
        var._v2_vocab = type.dim  # vocab size for downstream embedding
    return var


def fc(input, size, act=None, bias_attr=None, param_attr=None, name=None):
    if isinstance(input, (list, tuple)):
        input = L.concat(list(input), axis=-1)
    # sequence inputs apply the projection per timestep (reference fc
    # over LoD input)
    nfd = 2 if getattr(input, "lod_level", 0) else 1
    out = L.fc(input, size, num_flatten_dims=nfd, act=act_name(act),
               bias_attr=bias_attr, param_attr=param_attr, name=name)
    return _register_name(name, out)


def embedding(input, size, param_attr=None):
    """v2 ``size`` is the embedding dim; the vocab size comes from the
    input's declared integer_value(_sequence) range."""
    return L.embedding(input, size=[_vocab_of(input), size],
                       param_attr=param_attr)


def _vocab_of(var):
    v = getattr(var, "_v2_vocab", None)
    if v is not None:
        return v
    raise ValueError(
        "embedding needs the vocab size: create the input with "
        "data(name, integer_value_sequence(vocab_size))")


def lstmemory(input, size=None, reverse=False, act=None, name=None):
    """Fused LSTM over a sequence (reference LstmLayer; v2 expects the
    input already projected to 4*hidden)."""
    hidden_dim = size or input.shape[-1] // 4
    if input.shape[-1] != hidden_dim * 4:
        input = L.fc(input, hidden_dim * 4, num_flatten_dims=2)
    h, c = L.dynamic_lstm(input, hidden_dim * 4, is_reverse=reverse,
                          candidate_activation=act_name(act) or "tanh")
    return h


def simple_lstm(input, size, act=None, reverse=False):
    return lstmemory(L.fc(input, size * 4, num_flatten_dims=2),
                     size=size, act=act, reverse=reverse)


def gru(input, size, reverse=False):
    proj = L.fc(input, size * 3, num_flatten_dims=2)
    return L.dynamic_gru(proj, size, is_reverse=reverse)


def conv2d(input, num_filters, filter_size, stride=1, padding=0, act=None,
           name=None):
    return L.conv2d(input, num_filters, filter_size, stride=stride,
                    padding=padding, act=act_name(act), name=name)


img_conv = conv2d


def img_pool(input, pool_size, pool_type=None, stride=None, padding=0):
    ptype = pool_name(pool_type)
    if ptype == "average":
        ptype = "avg"
    return L.pool2d(input, pool_size=pool_size, pool_type=ptype or "max",
                    pool_stride=stride or pool_size, pool_padding=padding)


def simple_img_conv_pool(input, filter_size, num_filters, pool_size,
                         pool_stride, act=None, **kw):
    return N.simple_img_conv_pool(input, num_filters=num_filters,
                                  filter_size=filter_size,
                                  pool_size=pool_size,
                                  pool_stride=pool_stride,
                                  act=act_name(act), **kw)


def batch_norm(input, act=None, **kw):
    return L.batch_norm(input, act=act_name(act), **kw)


def dropout(input, dropout_rate=0.5):
    return L.dropout(input, dropout_prob=dropout_rate)


def concat(input, axis=-1):
    return L.concat(list(input), axis=axis)


def pooling(input, pooling_type=None):
    """Sequence pooling over the time axis (v2 `layer.pooling`)."""
    ptype = pool_name(pooling_type)
    return L.sequence_pool(input, pool_type=ptype)


def first_seq(input):
    return L.sequence_first_step(input)


def last_seq(input):
    return L.sequence_last_step(input)


def classification_cost(input, label, name=None):
    return L.mean(L.cross_entropy(input, label))


cross_entropy_cost = classification_cost


def square_error_cost(input, label):
    return L.mean(L.square_error_cost(input, label))


mse_cost = square_error_cost


def accuracy(input, label, k=1):
    return L.accuracy(input, label, k=k)


# ---- elementwise / math composition layers ----

def addto(input, act=None, bias_attr=None, name=None):
    """Sum of N same-shaped layers (+ optional bias) — reference
    AddtoLayer."""
    inputs = input if isinstance(input, (list, tuple)) else [input]
    out = inputs[0]
    for v in inputs[1:]:
        out = L.elementwise_add(out, v)
    if bias_attr not in (None, False):
        from paddle_tpu_torch.layers import tensor as T
        b = T.create_parameter([int(out.shape[-1])], "float32",
                               attr=None if bias_attr is True else bias_attr,
                               is_bias=True)
        out = L.elementwise_add(out, b)
    act = act_name(act)
    if act:
        out = getattr(L, act)(out)
    _register_name(name, out)
    return out


def cos_sim(a, b, scale=1.0, name=None):
    out = L.cos_sim(a, b)
    if scale != 1.0:
        out = L.scale(out, scale=scale)
    return _register_name(name, out)


def trans(input, name=None):
    return _register_name(name, L.transpose(input, perm=[1, 0]))


def scaling(input, weight, name=None):
    """Row-wise scaling by a per-example weight (ScalingLayer)."""
    return _register_name(name, L.elementwise_mul(input, weight, axis=0))


def slope_intercept(input, slope=1.0, intercept=0.0, name=None):
    return _register_name(name, L.scale(input, scale=slope,
                                        bias=intercept))


def power(input, exponent, name=None):
    from paddle_tpu_torch.layer_helper import LayerHelper

    helper = LayerHelper("v2_power", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("pow", {"X": [input]}, {"Out": [out]},
                     {"factor": float(exponent)})
    return _register_name(name, out)


def interpolation(input, weight, name=None):
    """out = w * in[0] + (1 - w) * in[1] (InterpolationLayer)."""
    a, b = input
    wa = L.elementwise_mul(a, weight, axis=0)
    one = L.fill_constant(shape=[1], dtype="float32", value=1.0)
    wb = L.elementwise_mul(b, L.elementwise_sub(one, weight), axis=0)
    return _register_name(name, L.elementwise_add(wa, wb))


def sum_to_one_norm(input, name=None):
    s = L.reduce_sum(input, dim=[-1], keep_dim=True)
    return _register_name(name, L.elementwise_div(input, s))


def img_cmrnorm(input, size=5, scale=0.0001, power=0.75, name=None):
    return _register_name(name, L.lrn(input, n=size, alpha=scale,
                                      beta=power))


def max_id(input, name=None):
    return _register_name(name, L.argmax(input, axis=-1))


def seq_concat(a, b, name=None):
    return _register_name(name, L.sequence_concat([a, b]))


def expand(input, expand_as, name=None):
    return _register_name(name, L.sequence_expand(input, expand_as))


# ---- cost layers ----

def rank_cost(left, right, label, name=None):
    return L.mean(L.rank_loss(label, left, right))


def huber_regression_cost(input, label, delta=1.0, name=None):
    return L.mean(L.huber_loss(input, label, delta=delta))


def smooth_l1_cost(input, label, name=None):
    return L.mean(L.smooth_l1(input, label))


def multi_binary_label_cross_entropy_cost(input, label, name=None):
    return L.mean(L.sigmoid_cross_entropy_with_logits(input, label))


def crf(input, label, param_attr=None, size=None, name=None):
    return L.linear_chain_crf(input, label, param_attr=param_attr)


def crf_decoding(input, param_attr=None, size=None, label=None, name=None):
    return L.crf_decoding(input, param_attr=param_attr)


def ctc(input, label, blank=0, norm_by_times=False, name=None):
    return L.warpctc(input, label, blank=blank,
                     norm_by_times=norm_by_times)


def nce(input, label, num_classes, param_attr=None, num_neg_samples=10,
        name=None):
    return L.nce(input, label, num_classes, param_attr=param_attr,
                 num_neg_samples=num_neg_samples)


# ---- mixed layer & projections (trainer_config_helpers mixed DSL) ----

class _Projection:
    def __init__(self, fn):
        self.fn = fn


def full_matrix_projection(input, size=0, param_attr=None):
    # fc() handles per-timestep projection for sequence inputs
    return _Projection(lambda s: fc(input, s or size,
                                    param_attr=param_attr,
                                    bias_attr=False))


def identity_projection(input, offset=None):
    if offset is not None:
        return _Projection(
            lambda s: L.slice(input, axes=[-1],
                              starts=[offset], ends=[offset + s]))
    return _Projection(lambda s: input)


def table_projection(input, size=0, param_attr=None):
    return _Projection(lambda s: L.embedding(
        input, size=[_vocab_of(input), s or size], param_attr=param_attr))


def dotmul_projection(input, param_attr=None):
    def build(s):
        from paddle_tpu_torch.layers import tensor as T
        w = T.create_parameter([int(input.shape[-1])], "float32",
                               attr=param_attr)
        return L.elementwise_mul(input, w)
    return _Projection(build)


def context_projection(input, context_len, context_start=None):
    return _Projection(
        lambda s: _context(input, context_len, context_start))


def _context(input, context_len, context_start):
    """Concatenate neighboring timesteps (reference ContextProjection)."""
    start = -(context_len // 2) if context_start is None else context_start
    outs = []
    for off in range(start, start + context_len):
        shifted = input if off == 0 else _shift(input, off)
        outs.append(shifted)
    return L.concat(outs, axis=-1)


def _shift(input, off):
    """shifted[t] = x[t + off] within the valid region, zero outside."""
    from paddle_tpu_torch.layer_helper import LayerHelper

    helper = LayerHelper("v2_ctx_shift")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("sequence_roll", {"X": [input]}, {"Out": [out]},
                     {"offset": off})
    return out


def mixed(size, input, act=None, bias_attr=None, name=None):
    """Sum of projections (trainer_config_helpers `mixed_layer`)."""
    projs = input if isinstance(input, (list, tuple)) else [input]
    outs = [p.fn(size) if isinstance(p, _Projection) else p for p in projs]
    out = addto(outs, act=act, bias_attr=bias_attr)
    _register_name(name, out)
    return out


# ---- recurrent_group / memory ----

_GROUP_STACK = []


class _GroupCtx:
    def __init__(self, rnn, batch_ref=None):
        self.rnn = rnn
        self.batch_ref = batch_ref   # outer seq var for memory batch size
        self.memories = {}   # name -> (mem_var, size)
        self.named = {}      # name -> produced var


def _register_name(name, var):
    if name and _GROUP_STACK:
        _GROUP_STACK[-1].named[name] = var
    return var


def memory(name, size, boot_layer=None):
    """Loop-carried state inside recurrent_group (reference
    `trainer_config_helpers` memory): refers by ``name`` to the layer that
    produces its next value in the same step."""
    if not _GROUP_STACK:
        raise ValueError("memory() is only valid inside recurrent_group")
    ctx = _GROUP_STACK[-1]
    if name in ctx.memories:
        return ctx.memories[name][0]
    if boot_layer is not None:
        mem = ctx.rnn.memory(init=boot_layer)
    else:
        if ctx.batch_ref is None:
            raise ValueError("memory(size=...) needs a sequence input "
                             "in the group for the batch reference")
        mem = ctx.rnn.memory(shape=[-1, size], batch_ref=ctx.batch_ref)
    ctx.memories[name] = (mem, size)
    return mem


def recurrent_group(step, input, reverse=False, name=None):
    """Run ``step`` per timestep over sequence input(s) (reference
    RecurrentGradientMachine / trainer_config_helpers recurrent_group).
    Memories declared with memory(name=N, ...) are updated from the layer
    registered under the same name (pass name=N to fc/mixed/addto). A step
    may return one layer or a tuple of layers."""
    inputs = input if isinstance(input, (list, tuple)) else [input]
    rnn = L.StaticRNN(is_reverse=reverse)
    ctx = _GroupCtx(rnn, batch_ref=inputs[0])
    _GROUP_STACK.append(ctx)
    try:
        with rnn.step():
            step_ins = [rnn.step_input(x) for x in inputs]
            out = step(*step_ins)
            for nm, (mem, size) in ctx.memories.items():
                upd = ctx.named.get(nm)
                if upd is None:
                    raise ValueError(
                        "memory(name=%r) has no producing layer: give "
                        "some layer in the step name=%r" % (nm, nm))
                rnn.update_memory(mem, upd)
            multi = isinstance(out, (list, tuple))
            for o in (out if multi else [out]):
                rnn.step_output(o)
    finally:
        _GROUP_STACK.pop()
    res = rnn()
    if multi:
        return res if isinstance(res, (list, tuple)) else (res,)
    return res if not isinstance(res, (list, tuple)) else res[0]


# ---- round-3 breadth: the remaining trainer_config_helpers layer set ----
# (reference python/paddle/trainer_config_helpers/layers.py; each wrapper
# lowers onto the fluid-style layer/op of the same capability)

def clip(input, min=-1e20, max=1e20, name=None):
    return _register_name(name, L.clip(input, min=min, max=max))


def pad(input, pad_c=None, pad_h=None, pad_w=None, name=None):
    """PadLayer: zero-pad NCHW images channel/height/width-wise."""
    p = [0, 0] + list(pad_c or [0, 0]) + list(pad_h or [0, 0]) + \
        list(pad_w or [0, 0])
    return _register_name(name, L.pad(input, p))


def maxout(input, groups, name=None):
    return _register_name(name, L.maxout(input, groups))


def prelu(input, param_attr=None, name=None):
    return _register_name(name, L.prelu(input, mode="all",
                                        param_attr=param_attr))


def multiplex(index, input, name=None):
    return _register_name(name, L.multiplex(inputs=list(input),
                                            index=index))


def row_conv(input, context_len, act=None, name=None):
    out = L.row_conv(input, context_len, act=act_name(act))
    return _register_name(name, out)


def block_expand(input, block_x=1, block_y=1, stride_x=1, stride_y=1,
                 padding_x=0, padding_y=0, name=None):
    """BlockExpandLayer == fluid im2sequence."""
    out = L.im2sequence(input, filter_size=[block_y, block_x],
                        stride=[stride_y, stride_x],
                        padding=[padding_y, padding_x, padding_y, padding_x])
    return _register_name(name, out)


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None):
    return _register_name(name, L.hsigmoid(input, label, num_classes,
                                           param_attr=param_attr,
                                           bias_attr=bias_attr))


def spp(input, pyramid_height, pool_type="max", name=None):
    return _register_name(name, L.spp(input, pyramid_height,
                                      pool_type=pool_type))


def conv_shift(a, b, name=None):
    return _register_name(name, L.conv_shift(a, b))


def sampling_id(input, name=None):
    return _register_name(name, L.sampling_id(input))


def eos(input, eos_id, name=None):
    """EosLayer: zero out everything after (and including) the first
    end-of-sequence token — the static-shape analogue of the reference's
    sequence truncation at <eos>."""
    dense, length = L.sequence_pad(input, 0)
    ind = L.cast(L.equal(dense, L.fill_constant([1], dense.dtype, eos_id)),
                 "float32")
    seen = L.cumsum(ind, axis=1)
    keep = L.cast(L.equal(seen, L.fill_constant([1], "float32", 0.0)),
                  dense.dtype)
    out = L.elementwise_mul(dense, keep)
    return _register_name(name, L.sequence_unpad(out, length))


def kmax_seq_score(input, beam_size=1, name=None):
    """Top-k timestep indices per sequence by score
    (KmaxSeqScoreLayer). ``input``: sequence of [*, 1] scores."""
    # pad with -1e9 so padded slots never enter the top-k
    dense, _length = L.sequence_pad(input, -1e9)     # [B, T, 1], [B]
    s = L.squeeze(dense, [2])
    _, idx = L.topk(s, k=beam_size)
    return _register_name(name, idx)


def seq_reshape(input, reshape_size, name=None):
    return _register_name(name, L.sequence_reshape(input, reshape_size))


def seq_slice(input, starts=None, ends=None, name=None):
    """[starts, ends) per sequence; sequence_slice takes (offset, LENGTH),
    so convert the exclusive end indices."""
    lengths = L.elementwise_sub(ends, starts)
    return _register_name(name, L.sequence_slice(input, starts, lengths))


def sub_seq(input, offsets, sizes, name=None):
    """SubSequenceLayer: per-sequence [offset, offset+size) slice."""
    return _register_name(name, L.sequence_slice(input, offsets, sizes))


def repeat(input, num_repeats, name=None):
    """RepeatLayer: interleaved column repeat [a,b] -> [a,a,b,b]."""
    d = int(input.shape[-1])
    out = L.reshape(L.expand(L.unsqueeze(input, [-1]),
                             [1] * len(input.shape) + [num_repeats]),
                    list(input.shape[:-1]) + [d * num_repeats])
    return _register_name(name, out)


def rotate(input, height=None, width=None, name=None):
    """RotateLayer: 90-degree CCW rotation of NCHW maps."""
    t = L.transpose(input, [0, 1, 3, 2])
    return _register_name(name, L.reverse(t, axis=[2]))


def switch_order(input, reshape_order, name=None):
    """SwitchOrderLayer: permute NCHW dims (e.g. to NHWC)."""
    return _register_name(name, L.transpose(input, list(reshape_order)))


def resize(input, size, name=None):
    return _register_name(name, L.reshape(input, [-1, size]))


def crop(input, shape=None, offsets=None, name=None):
    from paddle_tpu_torch.layer_helper import LayerHelper

    helper = LayerHelper("v2_crop", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("crop", {"X": [input]}, {"Out": [out]},
                     {"shape": list(shape or []),
                      "offsets": list(offsets or [])})
    return _register_name(name, out)


def bilinear_interp(input, out_size_x, out_size_y, name=None):
    return _register_name(
        name, L.resize_bilinear(input, out_shape=[out_size_y, out_size_x]))


def upsample(input, scale=2, name=None):
    return _register_name(
        name, L.image_resize(input, scale=scale, resample="NEAREST"))


def roi_pool(input, rois, pooled_width, pooled_height, spatial_scale,
             name=None):
    from paddle_tpu_torch.layer_helper import LayerHelper

    helper = LayerHelper("v2_roi_pool", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    argmax = helper.create_variable_for_type_inference("int32")
    helper.append_op("roi_pool", {"X": [input], "ROIs": [rois]},
                     {"Out": [out], "Argmax": [argmax]},
                     {"pooled_height": pooled_height,
                      "pooled_width": pooled_width,
                      "spatial_scale": spatial_scale})
    return _register_name(name, out)


def cross_channel_norm(input, param_attr=None, name=None):
    """CrossChannelNormLayer: L2-normalize across channels, per-channel
    learned scale."""
    from paddle_tpu_torch.layers import tensor as T

    normed = L.l2_normalize(input, axis=1)
    w = T.create_parameter([int(input.shape[1])], "float32",
                           attr=param_attr,
                           default_initializer=None)
    return _register_name(name, L.elementwise_mul(normed, w, axis=1))


def row_l2_norm(input, name=None):
    return _register_name(name, L.l2_normalize(input, axis=-1))


def scale_shift(input, param_attr=None, bias_attr=None, name=None):
    """ScaleShiftLayer: y = w * x + b with scalar learned w, b."""
    from paddle_tpu_torch.layers import tensor as T

    w = T.create_parameter([1], "float32", attr=param_attr)
    out = L.elementwise_mul(input, w)
    if bias_attr is not False:
        b = T.create_parameter([1], "float32", attr=bias_attr,
                               is_bias=True)
        out = L.elementwise_add(out, b)
    return _register_name(name, out)


def out_prod(a, b, name=None):
    """OuterProdLayer: per-row outer product -> [B, da*db]."""
    o = L.matmul(L.unsqueeze(a, [2]), L.unsqueeze(b, [1]))
    return _register_name(
        name, L.reshape(o, [-1, int(a.shape[-1]) * int(b.shape[-1])]))


def dot_prod(a, b, name=None):
    return _register_name(
        name, L.reduce_sum(L.elementwise_mul(a, b), dim=[-1],
                           keep_dim=True))


def l2_distance(a, b, name=None):
    d = L.elementwise_sub(a, b)
    return _register_name(
        name, L.sqrt(L.reduce_sum(L.square(d), dim=[-1], keep_dim=True)))


def linear_comb(weights, vectors, size, name=None):
    """LinearCombLayer: out = sum_k w[:,k] * v[:, k*size:(k+1)*size]."""
    k = int(weights.shape[-1])
    v = L.reshape(vectors, [-1, k, size])
    w = L.unsqueeze(weights, [2])
    return _register_name(
        name, L.reduce_sum(L.elementwise_mul(v, w), dim=[1]))


def tensor(a, b, size, param_attr=None, name=None):
    """TensorLayer == bilinear tensor product."""
    return _register_name(
        name, L.bilinear_tensor_product(a, b, size, param_attr=param_attr))


def factorization_machine(input, factor_size, param_attr=None, name=None):
    """FM second-order interactions: 0.5*sum((xV)^2 - (x^2)(V^2))."""
    from paddle_tpu_torch.layers import tensor as T

    d = int(input.shape[-1])
    v = T.create_parameter([d, factor_size], "float32", attr=param_attr)
    xv = L.matmul(input, v)
    x2v2 = L.matmul(L.square(input), L.square(v))
    out = L.scale(L.reduce_sum(L.elementwise_sub(L.square(xv), x2v2),
                               dim=[-1], keep_dim=True), scale=0.5)
    return _register_name(name, out)


def gated_unit(input, size, act=None, gate_param_attr=None,
               inproj_param_attr=None, name=None):
    """GatedUnitLayer: act(xW) * sigmoid(xWg)."""
    proj = fc(input, size, act=act, param_attr=inproj_param_attr)
    gate = L.sigmoid(fc(input, size, param_attr=gate_param_attr))
    return _register_name(name, L.elementwise_mul(proj, gate))


def get_output(input, arg_name=None, name=None):
    """GetOutputLayer: select one output of a multi-output layer."""
    if isinstance(input, dict):
        return _register_name(name, input[arg_name])
    if isinstance(input, (list, tuple)):
        return _register_name(name, input[int(arg_name or 0)])
    return _register_name(name, input)


def printer(input, name=None):
    """PrinterLayer: identity in the program (fetch the var to inspect
    it)."""
    return _register_name(name, input)


def cross_entropy(input, label, name=None):
    return L.mean(L.cross_entropy(input, label))


def cross_entropy_with_selfnorm(input, label, softmax_selfnorm_alpha=0.1,
                                name=None):
    """CE + alpha * log(Z)^2, pushing the softmax normalizer toward 1
    (reference SumOfSquaresOfLogZ). ``input`` must be UNNORMALIZED
    scores — from a normalized distribution Z is 1 by construction and
    the regularizer would vanish."""
    ce = L.softmax_with_cross_entropy(input, label)
    logz = L.log(L.reduce_sum(L.exp(input), dim=[-1], keep_dim=True))
    return L.mean(ce) if softmax_selfnorm_alpha == 0 else L.elementwise_add(
        L.mean(ce), L.scale(L.mean(L.square(logz)),
                            scale=softmax_selfnorm_alpha))


def multi_binary_label_cross_entropy(input, label, name=None, coeff=1.0):
    """Multi-binary-label CE (reference layers.py:6390,
    `gserver/layers/CostLayer.cpp` MultiBinaryLabelCrossEntropy): input
    holds per-class probabilities (sigmoid-activated), label is the
    multi-hot target; cost = -sum_j [y_j log p_j + (1-y_j) log(1-p_j)],
    averaged over the batch."""
    p = input
    y = L.cast(label, "float32")
    eps = 1e-8
    pos = L.elementwise_mul(y, L.log(L.scale(p, bias=eps)))
    neg = L.elementwise_mul(
        L.scale(y, scale=-1.0, bias=1.0),
        L.log(L.scale(p, scale=-1.0, bias=1.0 + eps)))
    per = L.scale(
        L.reduce_sum(L.elementwise_add(pos, neg), dim=[-1], keep_dim=True),
        scale=-1.0)
    out = L.scale(L.mean(per), scale=coeff)
    return _register_name(name, out)


def huber_classification_cost(input, label, delta=1.0, name=None):
    """Huber classification (reference HuberTwoClassification): with
    z = (2*label-1)*input, loss = 0 for z >= 1, (1-z)^2 for -1 <= z < 1,
    and the linear tail -4z for z < -1 (gradient never saturates on
    badly misclassified examples)."""
    flabel = L.cast(label, "float32")
    z = L.elementwise_mul(input, L.scale(flabel, scale=2.0, bias=-1.0))
    quad = L.square(L.relu(L.scale(z, scale=-1.0, bias=1.0)))
    lin = L.scale(z, scale=-4.0)
    in_quad = L.cast(L.greater_than(
        z, L.fill_constant([1], "float32", -1.0)), "float32")
    loss = L.elementwise_add(
        L.elementwise_mul(quad, in_quad),
        L.elementwise_mul(lin, L.scale(in_quad, scale=-1.0, bias=1.0)))
    return L.mean(loss)


def sum_cost(input, name=None):
    return L.reduce_sum(input)


def warp_ctc(input, label, blank=0, norm_by_times=False, name=None):
    return L.warpctc(input, label, blank=blank, norm_by_times=norm_by_times)


def img_conv3d(input, num_filters, filter_size, stride=1, padding=0,
               act=None, param_attr=None, bias_attr=None, name=None):
    out = L.conv3d(input, num_filters, filter_size, stride=stride,
                   padding=padding, act=act_name(act),
                   param_attr=param_attr, bias_attr=bias_attr)
    return _register_name(name, out)


def img_pool3d(input, pool_size, pool_type="max", stride=1, padding=0,
               name=None):
    out = L.pool3d(input, pool_size=pool_size,
                   pool_type=pool_name(pool_type)
                   if not isinstance(pool_type, str) else pool_type,
                   pool_stride=stride, pool_padding=padding)
    return _register_name(name, out)


# ---- mixed-DSL operators / remaining projections ----

def dotmul_operator(a, b, scale=1.0):
    return _Projection(lambda s: L.scale(L.elementwise_mul(a, b),
                                         scale=scale))


def conv_operator(img, filter, filter_size, num_filters, num_channels=None,
                  stride=1, padding=0):
    """conv_operator: filter comes from another layer; here the standard
    learned-filter conv covers the capability."""
    return _Projection(lambda s: L.conv2d(img, num_filters, filter_size,
                                          stride=stride, padding=padding,
                                          bias_attr=False))


def conv_projection(input, filter_size, num_filters, num_channels=None,
                    stride=1, padding=0, param_attr=None):
    return _Projection(lambda s: L.conv2d(input, num_filters, filter_size,
                                          stride=stride, padding=padding,
                                          param_attr=param_attr,
                                          bias_attr=False))


def scaling_projection(input, param_attr=None):
    def build(s):
        from paddle_tpu_torch.layers import tensor as T
        w = T.create_parameter([1], "float32", attr=param_attr)
        return L.elementwise_mul(input, w)
    return _Projection(build)


def slice_projection(input, slices):
    def build(s):
        outs = [L.slice(input, axes=[-1], starts=[a], ends=[b])
                for a, b in slices]
        return L.concat(outs, axis=-1)
    return _Projection(build)


def trans_full_matrix_projection(input, size=0, param_attr=None):
    """Projection through W^T: x @ W.T via matmul with transpose_y."""
    def build(s):
        from paddle_tpu_torch.layers import tensor as T
        w = T.create_parameter([s or size, int(input.shape[-1])],
                               "float32", attr=param_attr)
        return L.matmul(input, w, transpose_y=True)
    return _Projection(build)


def selective_fc(input, size, select=None, act=None, param_attr=None,
                 bias_attr=None, name=None):
    """SelectiveFcLayer: fc; a 0/1 select mask zeroes unselected outputs."""
    out = fc(input, size, act=act, param_attr=param_attr,
             bias_attr=bias_attr)
    if select is not None:
        out = L.elementwise_mul(out, L.cast(select, "float32"))
    return _register_name(name, out)


# ---- step-level recurrent units ----

def lstm_step(input, state, size=None, act=None, gate_act=None, name=None):
    """LstmStepLayer: one LSTM cell step. ``input`` is [B, 4H] projected
    gates (i, f, o, j order per the reference), ``state`` the previous
    cell; returns (hidden, cell)."""
    size = size or int(state.shape[-1])
    i = L.sigmoid(L.slice(input, axes=[-1], starts=[0], ends=[size]))
    f = L.sigmoid(L.slice(input, axes=[-1], starts=[size],
                          ends=[2 * size]))
    o = L.sigmoid(L.slice(input, axes=[-1], starts=[2 * size],
                          ends=[3 * size]))
    j = L.tanh(L.slice(input, axes=[-1], starts=[3 * size],
                       ends=[4 * size]))
    c = L.elementwise_add(L.elementwise_mul(f, state),
                          L.elementwise_mul(i, j))
    h = L.elementwise_mul(o, L.tanh(c))
    _register_name(name, h)
    return h, c


def gru_step(input, output_mem, size=None, act=None, gate_act=None,
             param_attr=None, name=None):
    """GruStepLayer: one GRU step over [B, 3H] projected input. v2
    ``size`` is the hidden dim H; gru_unit's size argument means 3H."""
    size3 = 3 * size if size else int(input.shape[-1])
    out = L.gru_unit(input, output_mem, size3, param_attr=param_attr)
    if isinstance(out, (list, tuple)):
        out = out[0]
    return _register_name(name, out)


gru_step_naive = gru_step


def recurrent(input, act=None, reverse=False, param_attr=None, name=None):
    """RecurrentLayer: h_t = act(x_t + h_{t-1} @ W) over a sequence."""
    size = int(input.shape[-1])

    def step(x):
        prev = memory(name=(name or "recurrent") + "_h", size=size)
        proj = L.fc(prev, size, bias_attr=False, param_attr=param_attr)
        h = L.elementwise_add(x, proj)
        h = getattr(L, act_name(act) or "tanh")(h)
        _register_name((name or "recurrent") + "_h", h)
        return h

    return recurrent_group(step, input, reverse=reverse)


# ---- detection family ----

def priorbox(input, image, min_size, max_size=None, aspect_ratio=(1.0,),
             variance=(0.1, 0.1, 0.2, 0.2), name=None):
    """Returns the (box, var) pair that detection_output/multibox_loss
    take as ``priorbox_var``."""
    from paddle_tpu_torch.layers import detection as D
    box, var = D.prior_box(input, image, list(min_size),
                           list(max_size) if max_size else None,
                           list(aspect_ratio), list(variance))
    _register_name(name, box)
    return box, var


def detection_output(loc, conf, priorbox_var, background_id=0,
                     nms_threshold=0.45, nms_top_k=400, keep_top_k=200,
                     confidence_threshold=0.01, name=None):
    """``priorbox_var`` is the (box, var) pair from priorbox()."""
    from paddle_tpu_torch.layers import detection as D
    box, var = priorbox_var
    out = D.detection_output(loc, L.softmax(conf), box, var,
                             background_label=background_id,
                             nms_threshold=nms_threshold,
                             nms_top_k=nms_top_k, keep_top_k=keep_top_k,
                             score_threshold=confidence_threshold)
    return _register_name(name, out)


def multibox_loss(loc, conf, gt_box, gt_label, priorbox_var,
                  background_id=0, name=None):
    from paddle_tpu_torch.layers import detection as D
    box, var = priorbox_var
    loss = D.ssd_loss(loc, conf, gt_box, gt_label, box, var,
                      background_label=background_id)
    return _register_name(name, L.mean(loss))


# ---- generation: beam search over a recurrent step (reference
# RecurrentGradientMachine::generateSequence / beamSearch,
# gradientmachines/RecurrentGradientMachine.h:307-309) ----

class StaticInput:
    """Non-sequence input visible at every generation step (the encoder
    context in seq2seq)."""

    def __init__(self, input, is_seq=False, size=None):
        self.input = input
        self.is_seq = is_seq
        self.size = size


class BaseGeneratedInput:
    """Base of generation-time inputs (reference layers.py
    BaseGeneratedInput) — exists for isinstance checks in user configs."""


class GeneratedInput(BaseGeneratedInput):
    """The feedback input: at each step the previously generated token is
    embedded and fed to the step function."""

    def __init__(self, size, embedding_name=None, embedding_size=None):
        self.size = size                      # vocabulary size
        self.embedding_name = embedding_name  # share with training embedding
        self.embedding_size = embedding_size


class _BeamRnnAdapter:
    """Routes v2 memory()/update into BeamSearchDecoder state slots so the
    same step function works for training (recurrent_group) and
    generation (beam_search)."""

    def __init__(self, dec):
        self.dec = dec

    def memory(self, init=None, shape=None, batch_ref=None):
        if init is None:
            init = L.fill_constant_batch_size_like(
                batch_ref, [-1] + [int(s) for s in shape[1:]],
                "float32", 0.0)
        return self.dec.state(init)

    def update_memory(self, mem, var):
        self.dec.update_state(mem, var)


def beam_search(step, input, bos_id, eos_id, beam_size=5, max_length=8,
                name=None):
    """v2 sequence generation: expand the decode ``step`` under beam
    search. ``input`` mixes StaticInput context with exactly one
    GeneratedInput; returns (ids, scores, lengths) — ids is [B, K, T]
    int64 with </s>-terminated rows.

    The reference runs this as RecurrentGradientMachine::generateSequence
    with per-sequence C++ beam bookkeeping; here the whole fixed-width
    search is one `beam_search_block` op."""
    from paddle_tpu_torch.layers.decoder import BeamSearchDecoder
    from paddle_tpu_torch.param_attr import ParamAttr

    inputs = input if isinstance(input, (list, tuple)) else [input]
    gens = [i for i in inputs if isinstance(i, GeneratedInput)]
    assert len(gens) == 1, "beam_search needs exactly one GeneratedInput"
    gen = gens[0]

    dec = BeamSearchDecoder(beam_size=beam_size, max_len=max_length,
                            bos_id=bos_id, eos_id=eos_id, name=name)
    statics = [i for i in inputs if not isinstance(i, GeneratedInput)]
    ctx = _GroupCtx(_BeamRnnAdapter(dec),
                    batch_ref=None)
    _GROUP_STACK.append(ctx)
    try:
        with dec.step():
            tok = dec.token()
            emb_attr = (ParamAttr(name=gen.embedding_name)
                        if gen.embedding_name else None)
            emb = L.embedding(
                tok, size=[gen.size, gen.embedding_size or gen.size],
                param_attr=emb_attr)
            step_ins = [emb]
            for s in statics:
                v = s.input if isinstance(s, StaticInput) else s
                step_ins.append(dec.batch_input(v))
            out = step(*step_ins)
            for nm, (mem, size) in ctx.memories.items():
                upd = ctx.named.get(nm)
                if upd is None:
                    raise ValueError("memory(name=%r) has no producing "
                                     "layer in the beam step" % nm)
                dec.update_state(mem, upd)
            # v2 steps emit a probability distribution; the decoder wants
            # (log-)scores — log keeps beam ordering identical
            dec.set_logits(L.log(L.clip(out, min=1e-20, max=1.0)))
    finally:
        _GROUP_STACK.pop()
    return dec()


class SubsequenceInput:
    """Marker for nested (2-level LoD) sequence input to recurrent_group
    (reference SubsequenceInput). The inner level is iterated per step."""

    def __init__(self, input):
        self.input = input


def scale_sub_region(input, indices, value, name=None):
    """ScaleSubRegionLayer: multiply a static [c1,c2,h1,h2,w1,w2] region
    (1-based inclusive, reference convention) of NCHW maps by ``value``."""
    c1, c2, h1, h2, w1, w2 = [int(v) for v in indices]
    n, c, h, w = [int(s) for s in input.shape]
    ones = L.fill_constant([1, c2 - c1 + 1, h2 - h1 + 1, w2 - w1 + 1],
                           "float32", value - 1.0)
    mask = L.pad(ones, [0, 0, c1 - 1, c - c2, h1 - 1, h - h2,
                        w1 - 1, w - w2])
    scale_map = L.scale(mask, scale=1.0, bias=1.0)
    return _register_name(name, L.elementwise_mul(input, scale_map))


def lambda_cost(input, score, NDCG_num=5, max_sort_size=-1, name=None):
    """LambdaRank cost (reference lambda_cost): pairwise logistic loss
    over items of each query sequence, weighted by the relevance gap.
    ``input``: sequence of model scores [*, 1]; ``score``: sequence of
    relevance labels [*, 1]."""
    s, _len = L.sequence_pad(input, -1e9)           # [B, T, 1]
    r, _ = L.sequence_pad(score, -1e9)              # [B, T, 1]
    st = L.transpose(s, [0, 2, 1])                  # [B, 1, T]
    rt = L.transpose(r, [0, 2, 1])
    sd = L.elementwise_sub(s, st)                   # [B, T, T] broadcast
    rd = L.elementwise_sub(r, rt)
    valid = L.cast(L.elementwise_mul(
        L.cast(L.greater_than(r, L.fill_constant([1], "float32", -1e8)),
               "float32"),
        L.cast(L.greater_than(rt, L.fill_constant([1], "float32", -1e8)),
               "float32")), "float32")
    pos = L.cast(L.greater_than(rd, L.fill_constant([1], "float32", 0.0)),
                 "float32")
    pair_w = L.elementwise_mul(L.elementwise_mul(L.abs(rd), pos), valid)
    # clip the score gap before exp: padded pairs carry +-2e9 gaps that
    # would overflow to inf*0=NaN (their pair weight is already 0)
    loss = L.log(L.scale(L.exp(L.scale(L.clip(sd, min=-30.0, max=30.0),
                                       scale=-1.0)), bias=1.0))
    return L.reduce_sum(L.elementwise_mul(pair_w, loss))


# ---- round-4 tail: the last reference trainer_config_helpers names ----

from paddle_tpu_torch.core import ir as _ir

LayerOutput = _ir.Variable   # v2 layer calls return IR Variables


class AggregateLevel:
    """Reference `trainer_config_helpers.layers.AggregateLevel`."""
    TO_NO_SEQUENCE = "non-seq"
    TO_SEQUENCE = "seq"
    EACH_TIMESTEP = "non-seq"   # legacy alias
    EACH_SEQUENCE = "seq"


class ExpandLevel:
    """Reference `trainer_config_helpers.layers.ExpandLevel`."""
    FROM_NO_SEQUENCE = "non-seq"
    FROM_SEQUENCE = "seq"
    FROM_TIMESTEP = "non-seq"   # legacy alias


class LayerType:
    """Type-name constants (reference LayerType). Kept for API-shape
    parity; the IR records op types directly."""
    DATA = "data"
    FC_LAYER = "fc"
    COST = "cost"

    @staticmethod
    def is_layer_type(type_name):
        return isinstance(type_name, str)


def layer_support(*attrs):
    """Reference decorator declaring ExtraLayerAttribute support; the
    lowering needs no such declarations — identity passthrough."""
    def decorator(fn):
        return fn
    if len(attrs) == 1 and callable(attrs[0]):
        return attrs[0]
    return decorator


def grumemory(input, size=None, reverse=False, act=None, name=None):
    """Fused GRU over a sequence (reference GruLayer; input already
    projected to 3*hidden)."""
    hidden_dim = size or input.shape[-1] // 3
    if input.shape[-1] != hidden_dim * 3:
        input = L.fc(input, hidden_dim * 3, num_flatten_dims=2)
    return _register_name(
        name, L.dynamic_gru(input, hidden_dim, is_reverse=reverse,
                            candidate_activation=act_name(act) or "tanh"))


def regression_cost(input, label, weight=None, name=None):
    """Reference regression_cost: mean squared error."""
    cost = L.square_error_cost(input, label)
    if weight is not None:
        cost = L.elementwise_mul(cost, weight)
    return _register_name(name, L.mean(cost))


mse_cost = regression_cost


def maxid_layer(input, name=None):
    return max_id(input, name=name)


def convex_comb_layer(input, size, name=None):
    """Legacy alias of linear_comb (reference marks it deprecated)."""
    weights, vectors = input
    return linear_comb(weights, vectors, size, name=name)


def print_layer(input, name=None):
    return printer(input, name=name)


def sub_nested_seq_layer(input, selected_indices, name=None):
    """Trim a nested sequence to the sub-sequences named by
    ``selected_indices`` (reference SubNestedSequenceLayer,
    `gserver/layers/SubNestedSequenceLayer.cpp` — used in beam
    training). On the packed representation the outer-sequence axis is
    the leading dim, so selection is a gather of whole rows."""
    idx = L.cast(selected_indices, "int64")
    if len(idx.shape) > 1:
        idx = L.reshape(idx, [-1])
    return _register_name(name, L.gather(input, idx))


class BeamInput:
    """One beam for cross_entropy_over_beam: (candidate_scores,
    selected_candidates, gold) — reference layers.BeamInput."""

    def __init__(self, candidate_scores, selected_candidates, gold):
        self.candidate_scores = candidate_scores
        self.selected_candidates = selected_candidates
        self.gold = gold


def cross_entropy_over_beam(input, name=None):
    """Beam-search training cost (reference CrossEntropyOverBeam,
    `gserver/layers/CrossEntropyOverBeam.cpp`): for every beam, softmax
    the candidate scores and take the negative log-probability of the
    gold candidate; beams whose gold fell off the beam contribute their
    full normalizer. Sum over beams."""
    if isinstance(input, BeamInput):
        input = [input]
    costs = []
    for beam in input:
        scores = beam.candidate_scores
        if len(scores.shape) > 2 or scores.shape[-1] == 1:
            # flatten trailing dims into the beam width; the batch dim is
            # dynamic (-1), so the width must be computed from the static
            # trailing dims — [shape[0], -1] would emit two -1 dims
            width = 1
            for d in scores.shape[1:]:
                if int(d) < 0:
                    raise ValueError(
                        "cross_entropy_over_beam: candidate_scores needs "
                        "static trailing dims, got %r" % (scores.shape,))
                width *= int(d)
            scores = L.reshape(scores, [-1, width])
        gold = L.cast(beam.gold, "int64")
        if len(gold.shape) < 2:
            gold = L.reshape(gold, [-1, 1])
        width = int(scores.shape[-1])
        ce = L.cross_entropy(L.softmax(scores), gold)       # [B, 1]
        # gold off the beam (index >= width): its probability under the
        # beam is 0, so the sample contributes the full normalizer
        # -log(sum exp / sum exp) ... i.e. -log(p_gold) with p_gold -> 0
        # is unbounded; the reference caps it at the normalizer term
        # log(sum_j exp(s_j)) (CrossEntropyOverBeam.cpp gold-off-beam
        # branch). take_along_axis would silently clamp instead.
        lse = L.log(L.reduce_sum(L.exp(scores), dim=-1, keep_dim=True))
        in_beam = L.cast(
            L.less_than(gold, L.fill_constant([1], "int64", width)),
            "float32")
        per = L.elementwise_add(
            L.elementwise_mul(in_beam, ce),
            L.elementwise_mul(
                L.elementwise_sub(L.fill_constant([1], "float32", 1.0),
                                  in_beam), lse))
        costs.append(L.mean(per))
    out = costs[0]
    for c in costs[1:]:
        out = L.elementwise_add(out, c)
    return _register_name(name, out)
