"""Neural-network layers DSL.

Capability parity: `python/paddle/fluid/layers/nn.py`. Each function
appends ops to the current program block; shapes propagate by meta-tensor
inference so downstream layers can size parameters. These are the
layers of the transformer LM and its KV-cached serving forwards, of
the stacked-LSTM classifier and the MNIST MLP with their training
losses and metric, of the attention seq2seq model's training graph, of
the CRF sequence tagger (``linear_chain_crf``, ``crf_decoding``,
``chunk_eval``), the single LSTM step and the projected LSTM, of
the convnets (conv2d, pool2d, batch_norm, relu, lrn, dropout: LeNet,
ResNet, VGG, AlexNet, GoogLeNet and SmallNet), the activations, and
the dense op library's layers (products, reductions, shape and index
manipulation, the sequence convolution, the losses of the book's
regression and recommender programs, and the random draws), of the
vision family (3-D and transposed convolutions, the other pools,
unpooling, spatial pyramids, image-to-sequence, grid sampling and
resizing), four of the layers over ops already ported (group norm,
the 1-D batch norm, the last step of a sequence, the dice loss), the
sequence family's layers (softmax, expand, reshape, reverse, concat,
slice and unpad over sequences, and re-segmenting them) and the CTC
layers (the loss, the greedy decoder, the edit distance), the loss
family's layers (the pointwise and ranking losses, the ``nce`` and
``hsigmoid`` heads, the NTM's ``conv_shift``) and the streaming
metrics (``auc``, ``mean_iou``); the JAX package's other layers
(concurrency, pipeline, mixture of experts) arrive with later slices.
"""

from paddle_tpu_torch.core import ir
from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.initializer import Constant, Normal

__all__ = [
    "fc", "embedding", "conv2d", "pool2d", "batch_norm", "relu", "lrn",
    "dropout",
    "dynamic_lstm", "dynamic_lstmp", "dynamic_gru", "gru_unit",
    "lstm_unit", "linear_chain_crf", "crf_decoding", "chunk_eval",
    "sequence_pool", "sequence_first_step", "sequence_pad",
    "sequence_mask", "cross_entropy", "softmax_with_cross_entropy",
    "layer_norm", "elementwise_add",
    "elementwise_sub", "elementwise_mul", "mean", "scale", "softmax",
    "tanh", "topk", "accuracy", "reduce_sum", "reshape", "transpose",
    "squeeze", "unsqueeze", "flash_attention", "multi_head_attention",
    "elementwise_div", "exp", "floor", "sign", "pow", "clip",
    "clip_by_norm", "where", "autoincreased_step_counter",
    "sigmoid", "sqrt", "log", "square", "abs", "ceil", "prelu",
    "leaky_relu", "elu", "relu6", "swish", "brelu", "soft_relu", "maxout",
    "mul", "matmul", "reduce_mean", "reduce_max", "reduce_min",
    "reduce_prod", "split", "stack", "unstack", "expand", "flatten",
    "gather", "gather_nd", "scatter", "slice", "strided_slice", "shape",
    "one_hot", "pad", "pad2d", "cumsum", "l2_normalize", "label_smooth",
    "multiplex", "cos_sim", "square_error_cost", "sequence_conv",
    "bilinear_tensor_product", "hash", "sampling_id", "similarity_focus",
    "argsort", "unique_with_counts", "random_crop", "row_conv",
    "gaussian_random", "uniform_random_batch_size_like",
    "gaussian_random_batch_size_like",
    "conv3d", "conv2d_transpose", "pool3d", "max_pool3d_with_index",
    "conv3d_transpose", "unpool", "spp", "im2sequence", "grid_sampler",
    "image_resize", "resize_bilinear", "resize_nearest", "group_norm",
    "batch_norm_1d", "sequence_last_step", "dice_loss",
    "lod_reset", "sequence_softmax", "sequence_expand", "sequence_reshape",
    "sequence_reverse", "sequence_concat", "sequence_slice",
    "sequence_unpad", "warpctc", "ctc_greedy_decoder", "edit_distance",
    "conv_shift", "smooth_l1", "sigmoid_cross_entropy_with_logits",
    "log_loss", "huber_loss", "kldiv_loss", "rank_loss", "margin_rank_loss",
    "bpr_loss", "hinge_loss", "nce", "hsigmoid", "auc", "mean_iou",
]


def _single_op(type_name, x, attrs=None, dtype=None, name=None):
    helper = LayerHelper(type_name, name=name)
    out = helper.create_variable_for_type_inference(dtype or x.dtype)
    helper.append_op(type_name, {"X": [x]}, {"Out": [out]}, attrs or {})
    return out


def _two_in_op(type_name, x, y, attrs=None, name=None):
    helper = LayerHelper(type_name, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type_name, {"X": [x], "Y": [y]}, {"Out": [out]},
                     attrs or {})
    return out


def _reduce_layer(type_name, input, dim, keep_dim, name):
    helper = LayerHelper(type_name, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    if dim is None:
        attrs = {"reduce_all": True, "keep_dim": keep_dim}
    else:
        attrs = {"dim": dim if isinstance(dim, (list, tuple)) else [dim],
                 "keep_dim": keep_dim, "reduce_all": False}
    helper.append_op(type_name, {"X": [input]}, {"Out": [out]}, attrs)
    return out


# ---- core layers ----

def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, is_test=False, name=None):
    """Fully-connected (reference nn.py fc): y = act(sum_i(x_i @ w_i) + b)."""
    helper = LayerHelper("fc", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = helper.input_dtype()
    inputs = helper.input()
    param_attrs = helper.multiple_param_attr(len(inputs))
    mul_results = []
    for x, pa in zip(inputs, param_attrs):
        in_dim = 1
        for d in x.shape[num_flatten_dims:]:
            in_dim *= int(d) if d != -1 else 1
        w = helper.create_parameter(pa, [in_dim, size], dtype)
        out = helper.create_variable_for_type_inference(dtype)
        helper.append_op("mul", {"X": [x], "Y": [w]}, {"Out": [out]},
                         {"x_num_col_dims": num_flatten_dims,
                          "y_num_col_dims": 1})
        mul_results.append(out)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(dtype)
        helper.append_op("sum", {"X": mul_results}, {"Out": [pre_bias]})
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    helper = LayerHelper("embedding", param_attr=param_attr)
    w = helper.create_parameter(helper.param_attr, size, dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("lookup_table", {"W": [w], "Ids": [input]},
                     {"Out": [out]},
                     {"padding_idx": -1 if padding_idx is None else padding_idx,
                      "is_sparse": is_sparse})
    return out


# ---- convolutional ----

def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return [int(x) for x in v]
    return [int(v)] * n


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None):
    helper = LayerHelper("conv2d", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    groups = groups or 1
    num_channels = int(input.shape[1])
    fsize = filter_size if isinstance(filter_size, (list, tuple)) \
        else [filter_size, filter_size]
    filter_shape = [num_filters, num_channels // groups] + list(fsize)
    std = (2.0 / (fsize[0] * fsize[1] * num_channels)) ** 0.5
    w = helper.create_parameter(helper.param_attr, filter_shape, dtype,
                                default_initializer=Normal(0.0, std))
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "conv2d", {"Input": [input], "Filter": [w]}, {"Output": [pre_bias]},
        {"strides": _pair(stride), "paddings": _pair(padding),
         "dilations": _pair(dilation), "groups": groups})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, name=None, exclusive=True):
    helper = LayerHelper("pool2d", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "pool2d", {"X": [input]}, {"Out": [out]},
        {"pooling_type": pool_type, "ksize": _pair(pool_size),
         "strides": _pair(pool_stride), "paddings": _pair(pool_padding),
         "global_pooling": global_pooling, "ceil_mode": ceil_mode,
         "exclusive": exclusive})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None, do_model_average_for_mean_and_var=False):
    helper = LayerHelper("batch_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    caxis = 1 if data_layout == "NCHW" else len(input.shape) - 1
    c = int(input.shape[caxis])
    scale = helper.create_parameter(helper.param_attr, [c], dtype,
                                    default_initializer=Constant(1.0))
    bias = helper.create_parameter(helper.bias_attr, [c], dtype, is_bias=True)
    mean = helper.create_global_variable(
        persistable=True, shape=[c], dtype=dtype,
        name=moving_mean_name or helper.name + ".mean")
    helper.set_variable_initializer(mean, Constant(0.0))
    mean.stop_gradient = True
    variance = helper.create_global_variable(
        persistable=True, shape=[c], dtype=dtype,
        name=moving_variance_name or helper.name + ".variance")
    helper.set_variable_initializer(variance, Constant(1.0))
    variance.stop_gradient = True

    saved_mean = helper.create_variable_for_type_inference(dtype)
    saved_var = helper.create_variable_for_type_inference(dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "batch_norm",
        {"X": [input], "Scale": [scale], "Bias": [bias],
         "Mean": [mean], "Variance": [variance]},
        {"Y": [out], "MeanOut": [mean], "VarianceOut": [variance],
         "SavedMean": [saved_mean], "SavedVariance": [saved_var]},
        {"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
         "data_layout": data_layout})
    return helper.append_activation(out)


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    mask = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("dropout", {"X": [x]}, {"Out": [out], "Mask": [mask]},
                     {"dropout_prob": dropout_prob, "is_test": is_test,
                      "seed": seed or 0,
                      "dropout_implementation": dropout_implementation})
    return out


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    helper = LayerHelper("lrn", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    mid = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("lrn", {"X": [input]}, {"Out": [out], "MidOut": [mid]},
                     {"n": n, "k": k, "alpha": alpha, "beta": beta})
    return out


# ---- recurrent and sequence ----

def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=True, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", name=None):
    """input: PackedSeq [B, T, 4H] (pre-projected); size = 4H."""
    helper = LayerHelper("dynamic_lstm", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    h = size // 4
    w = helper.create_parameter(helper.param_attr, [h, 4 * h], dtype)
    bias_size = [1, 7 * h if use_peepholes else 4 * h]
    b = helper.create_parameter(helper.bias_attr, bias_size, dtype,
                                is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": [input], "Weight": [w], "Bias": [b]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    if c_0 is not None:
        inputs["C0"] = [c_0]
    helper.append_op(
        "lstm", inputs, {"Hidden": [hidden], "Cell": [cell]},
        {"use_peepholes": use_peepholes, "is_reverse": is_reverse,
         "gate_activation": gate_activation, "cell_activation": cell_activation,
         "candidate_activation": candidate_activation})
    return hidden, cell


def dynamic_lstmp(input, size, proj_size, param_attr=None, bias_attr=None,
                  use_peepholes=True, is_reverse=False,
                  gate_activation="sigmoid", cell_activation="tanh",
                  candidate_activation="tanh", proj_activation="tanh",
                  dtype="float32", name=None):
    """input: PackedSeq [B, T, 4H] (pre-projected); size = 4H; the
    hidden state is projected to ``proj_size``. Returns ``(projection,
    cell)``."""
    helper = LayerHelper("dynamic_lstmp", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    h = size // 4
    w = helper.create_parameter(helper.param_attr, [proj_size, 4 * h], dtype)
    proj_w = helper.create_parameter(
        helper.param_attr if helper.kwargs.get("param_attr") else None,
        [h, proj_size], dtype)
    b = helper.create_parameter(helper.bias_attr, [1, 4 * h], dtype,
                                is_bias=True)
    proj = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "lstmp",
        {"Input": [input], "Weight": [w], "ProjWeight": [proj_w], "Bias": [b]},
        {"Projection": [proj], "Cell": [cell]},
        {"use_peepholes": use_peepholes, "is_reverse": is_reverse,
         "gate_activation": gate_activation, "cell_activation": cell_activation,
         "candidate_activation": candidate_activation,
         "proj_activation": proj_activation})
    return proj, cell


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", h_0=None, name=None):
    """input: PackedSeq [B, T, 3H] (pre-projected); size = H."""
    helper = LayerHelper("dynamic_gru", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    dtype = "float32"
    w = helper.create_parameter(helper.param_attr, [size, 3 * size], dtype)
    b = helper.create_parameter(helper.bias_attr, [1, 3 * size], dtype,
                                is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": [input], "Weight": [w], "Bias": [b]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    helper.append_op("gru", inputs, {"Hidden": [hidden]},
                     {"is_reverse": is_reverse,
                      "activation": candidate_activation,
                      "gate_activation": gate_activation})
    return hidden


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid"):
    """One GRU step: input [B, 3H] preactivations, hidden [B, H]; size =
    3H. Returns ``(hidden, reset_hidden_prev, gate)``."""
    helper = LayerHelper("gru_unit", param_attr=param_attr,
                         bias_attr=bias_attr)
    dtype = input.dtype
    h = size // 3
    w = helper.create_parameter(helper.param_attr, [h, 3 * h], dtype)
    b = helper.create_parameter(helper.bias_attr, [1, 3 * h], dtype,
                                is_bias=True)
    out = helper.create_variable_for_type_inference(dtype)
    gate = helper.create_variable_for_type_inference(dtype)
    reset = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": [input], "HiddenPrev": [hidden], "Weight": [w]}
    if b is not None:
        inputs["Bias"] = [b]
    helper.append_op("gru_unit", inputs,
                     {"Hidden": [out], "Gate": [gate],
                      "ResetHiddenPrev": [reset]},
                     {"activation": activation,
                      "gate_activation": gate_activation})
    return out, reset, gate


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """One LSTM step: ``fc`` of [x_t, hidden_t_prev] to the 4H gates,
    then the ``lstm_unit`` op. Returns ``(hidden, cell)``."""
    from paddle_tpu_torch.layers.tensor import concat

    helper = LayerHelper("lstm_unit", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    size = int(cell_t_prev.shape[1])
    concat_in = concat([x_t, hidden_t_prev], axis=1)
    fc_out = fc(concat_in, 4 * size, param_attr=helper.kwargs.get("param_attr"),
                bias_attr=helper.kwargs.get("bias_attr"))
    c = helper.create_variable_for_type_inference(x_t.dtype)
    h = helper.create_variable_for_type_inference(x_t.dtype)
    helper.append_op("lstm_unit", {"X": [fc_out], "C_prev": [cell_t_prev]},
                     {"C": [c], "H": [h]}, {"forget_bias": forget_bias})
    return h, c


def sequence_pool(input, pool_type):
    helper = LayerHelper("sequence_pool")
    out = helper.create_variable_for_type_inference(input.dtype)
    idx = helper.create_variable_for_type_inference("int32")
    helper.append_op("sequence_pool", {"X": [input]},
                     {"Out": [out], "MaxIndex": [idx]},
                     {"pooltype": pool_type.upper()})
    return out


def sequence_first_step(input):
    return sequence_pool(input, "first")


def sequence_pad(x, pad_value=None, maxlen=None, name=None):
    """PackedSeq -> ``(dense [B, T, ...], lengths [B])``. ``pad_value``
    must be a Python scalar."""
    helper = LayerHelper("sequence_pad", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    length = helper.create_variable_for_type_inference("int64")
    attrs = {}
    if isinstance(pad_value, ir.Variable):
        raise TypeError(
            "sequence_pad: pad_value must be a Python scalar (a PackedSeq "
            "is padded when it is built; a run-time Variable pad cannot "
            "be honoured)")
    if pad_value is not None:
        attrs["pad_value"] = float(pad_value)
    helper.append_op("sequence_pad", {"X": [x]},
                     {"Out": [out], "Length": [length]}, attrs)
    return out, length


def sequence_unpad(x, length, name=None):
    """A dense [B, T, ...] tensor and its lengths [B] as a sequence."""
    helper = LayerHelper("sequence_unpad", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("sequence_unpad", {"X": [x], "Length": [length]},
                     {"Out": [out]})
    return out


def sequence_softmax(input, use_cudnn=False, name=None):
    """Softmax over each sequence's steps; ``use_cudnn`` is accepted and
    unused."""
    return _single_op("sequence_softmax", input, name=name)


def sequence_expand(x, y, ref_level=-1, name=None):
    helper = LayerHelper("sequence_expand", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("sequence_expand", {"X": [x], "Y": [y]}, {"Out": [out]},
                     {"ref_level": ref_level})
    return out


def sequence_reshape(input, new_dim):
    helper = LayerHelper("sequence_reshape")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("sequence_reshape", {"X": [input]}, {"Out": [out]},
                     {"new_dim": new_dim})
    return out


def sequence_reverse(x, name=None):
    helper = LayerHelper("sequence_reverse", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("sequence_reverse", {"X": [x]}, {"Y": [out]})
    return out


def sequence_concat(input, name=None):
    """Concatenate a list of sequences example by example along time."""
    helper = LayerHelper("sequence_concat", name=name)
    out = helper.create_variable_for_type_inference(helper.input_dtype())
    helper.append_op("sequence_concat", {"X": input}, {"Out": [out]})
    return out


def sequence_slice(input, offset, length, name=None):
    helper = LayerHelper("sequence_slice", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("sequence_slice",
                     {"X": [input], "Offset": [offset], "Length": [length]},
                     {"Out": [out]})
    return out


def lod_reset(x, y=None, target_lod=None, name=None):
    """Re-segment sequences: keep the flat tokens, change the boundaries
    (reference `lod_reset_op.cc`) to ``y``'s lengths or the offsets
    ``target_lod``."""
    helper = LayerHelper("lod_reset", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.lod_level = 1
    ins = {"X": [x]}
    if y is not None:
        ins["Y"] = [y]
    helper.append_op("lod_reset", ins, {"Out": [out]},
                     {"target_lod": list(target_lod) if target_lod else []})
    return out


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    helper = LayerHelper("sequence_mask", name=name)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("sequence_mask", {"X": [x]}, {"Y": [out]},
                     {"maxlen": maxlen if maxlen is not None else -1,
                      "out_dtype": dtype})
    return out


# ---- losses / scoring ----

def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    helper = LayerHelper("cross_entropy")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("cross_entropy", {"X": [input], "Label": [label]},
                     {"Y": [out]}, {"soft_label": soft_label})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               return_softmax=False):
    helper = LayerHelper("softmax_with_cross_entropy")
    loss = helper.create_variable_for_type_inference(logits.dtype)
    softmax_out = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op("softmax_with_cross_entropy",
                     {"Logits": [logits], "Label": [label]},
                     {"Loss": [loss], "Softmax": [softmax_out]},
                     {"soft_label": soft_label})
    if return_softmax:
        return loss, softmax_out
    return loss


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper("layer_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    norm_shape = [int(s) for s in input.shape[begin_norm_axis:]]
    n = 1
    for s in norm_shape:
        n *= s
    inputs = {"X": [input]}
    if scale:
        s_p = helper.create_parameter(helper.param_attr, [n], dtype,
                                      default_initializer=Constant(1.0))
        inputs["Scale"] = [s_p]
    if shift:
        b_p = helper.create_parameter(helper.bias_attr, [n], dtype,
                                      is_bias=True)
        if b_p is not None:
            inputs["Bias"] = [b_p]
    out = helper.create_variable_for_type_inference(dtype)
    mean_out = helper.create_variable_for_type_inference(dtype)
    var_out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("layer_norm", inputs,
                     {"Y": [out], "Mean": [mean_out], "Variance": [var_out]},
                     {"epsilon": epsilon, "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(out)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    helper = LayerHelper("elementwise_add", act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("elementwise_add", {"X": [x], "Y": [y]}, {"Out": [out]},
                     {"axis": axis})
    return helper.append_activation(out)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    helper = LayerHelper("elementwise_sub", act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("elementwise_sub", {"X": [x], "Y": [y]}, {"Out": [out]},
                     {"axis": axis})
    return helper.append_activation(out)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    helper = LayerHelper("elementwise_mul", act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("elementwise_mul", {"X": [x], "Y": [y]}, {"Out": [out]},
                     {"axis": axis})
    return helper.append_activation(out)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    helper = LayerHelper("elementwise_div", act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("elementwise_div", {"X": [x], "Y": [y]}, {"Out": [out]},
                     {"axis": axis})
    return helper.append_activation(out)


def mean(x, name=None):
    return _single_op("mean", x, name=name)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    helper = LayerHelper("scale", act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("scale", {"X": [x]}, {"Out": [out]},
                     {"scale": scale, "bias": bias,
                      "bias_after_scale": bias_after_scale})
    return helper.append_activation(out)


def softmax(input, use_cudnn=True, name=None, axis=-1):
    return _single_op("softmax", input, {"axis": axis}, name=name)


def relu(x, name=None):
    return _single_op("relu", x, name=name)


def tanh(x, name=None):
    return _single_op("tanh", x, name=name)


def topk(input, k, name=None):
    helper = LayerHelper("top_k", name=name)
    values = helper.create_variable_for_type_inference(input.dtype)
    indices = helper.create_variable_for_type_inference("int64")
    helper.append_op("top_k", {"X": [input]},
                     {"Out": [values], "Indices": [indices]}, {"k": k})
    return values, indices


def accuracy(input, label, k=1, correct=None, total=None):
    """Classification accuracy (reference layers/metric.py accuracy)."""
    helper = LayerHelper("accuracy")
    topk_out, topk_indices = topk(input, k=k)
    acc_out = helper.create_variable_for_type_inference("float32")
    correct = correct or helper.create_variable_for_type_inference("int32")
    total = total or helper.create_variable_for_type_inference("int32")
    helper.append_op("accuracy",
                     {"Out": [topk_out], "Indices": [topk_indices],
                      "Label": [label]},
                     {"Accuracy": [acc_out], "Correct": [correct],
                      "Total": [total]})
    return acc_out


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_sum", input, dim, keep_dim, name)


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_mean", input, dim, keep_dim, name)


def reduce_max(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_max", input, dim, keep_dim, name)


def reduce_min(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_min", input, dim, keep_dim, name)


def reduce_prod(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_prod", input, dim, keep_dim, name)


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    helper = LayerHelper("reshape", act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("reshape", {"X": [x]}, {"Out": [out]},
                     {"shape": [int(s) for s in shape]})
    return helper.append_activation(out)


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("transpose", {"X": [x]}, {"Out": [out]}, {"axis": list(perm)})
    return out


def squeeze(input, axes, name=None):
    return _single_op("squeeze", input, {"axes": axes}, name=name)


def unsqueeze(input, axes, name=None):
    return _single_op("unsqueeze", input, {"axes": axes}, name=name)


def flash_attention(q, k, v, causal=False, scale=None, q_segments=None,
                    k_segments=None, seq_axis=None, batch_axis=None,
                    cache=None, pos=None, slot=None, cache_mode=None,
                    name=None):
    """Fused (flash) attention over [batch, heads, seq, head_dim] tensors.

    Backed by the CUDA kernels of paddle_tpu_torch/kernels/flash_attention.py.
    ``q_segments``/``k_segments`` carry packed-sequence ids for
    intra-segment masking. ``seq_axis`` (ring attention over a
    sequence-parallel mesh axis) is recorded in the program as the JAX
    package records it; running it raises until the context-parallel
    slice lands.

    KV-cache modes (autoregressive decode serving): pass
    ``cache=(k_cache, v_cache)`` vars shaped [slots, heads, max_len,
    head_dim] plus ``cache_mode="prefill"`` (with ``slot``, a [1] int32
    var naming the cache row the prompt fills) or ``cache_mode="decode"``
    (with ``pos``, a [slots] int32 var of per-row write positions; q/k/v
    carry ONE new token per slot). The layer then returns
    ``(out, k_cache_out, v_cache_out)`` — the updated buffers.
    """
    helper = LayerHelper("fused_attention", name=name)
    out = helper.create_variable_for_type_inference(q.dtype)
    inputs = {"Q": [q], "K": [k], "V": [v]}
    outputs = {"Out": [out]}
    attrs = {"causal": causal, "scale": scale,
             "seq_axis": seq_axis, "batch_axis": batch_axis}
    if q_segments is not None:
        inputs["QSeg"] = [q_segments]
        inputs["KSeg"] = [k_segments if k_segments is not None else q_segments]
    if cache is not None:
        if cache_mode not in ("prefill", "decode"):
            raise ValueError(
                "cache= needs cache_mode='prefill' or 'decode', got %r"
                % (cache_mode,))
        if q_segments is not None or k_segments is not None:
            raise ValueError(
                "cache_mode=%r does not compose with packed-sequence "
                "segments: the cache path serves one generation per "
                "slot row (prefill is whole-prompt causal, decode is "
                "single-query) and would silently ignore the segment "
                "mask" % (cache_mode,))
        k_cache, v_cache = cache
        inputs["KCache"], inputs["VCache"] = [k_cache], [v_cache]
        if cache_mode == "decode":
            if pos is None:
                raise ValueError("cache_mode='decode' needs pos= (per-"
                                 "slot write positions, [slots] int32)")
            inputs["Pos"] = [pos]
        else:
            if slot is None:
                raise ValueError("cache_mode='prefill' needs slot= (the "
                                 "cache row this prompt fills, [1] int32)")
            inputs["Slot"] = [slot]
        kc_out = helper.create_variable_for_type_inference(k_cache.dtype)
        vc_out = helper.create_variable_for_type_inference(v_cache.dtype)
        outputs["KCacheOut"], outputs["VCacheOut"] = [kc_out], [vc_out]
        attrs["cache_mode"] = cache_mode
        # shape inference can't model the slot/batch asymmetry (cache
        # rows are slots, q rows are the call's batch), so declare the
        # shapes it would fail to derive: attention preserves q's shape,
        # the cache outs mirror the cache feeds
        out.shape = list(q.shape)
        kc_out.shape = list(k_cache.shape)
        vc_out.shape = list(v_cache.shape)
    elif cache_mode is not None:
        raise ValueError("cache_mode=%r needs cache=(k_cache, v_cache)"
                         % (cache_mode,))
    helper.append_op("fused_attention", inputs, outputs, attrs)
    return (out, kc_out, vc_out) if cache is not None else out


def multi_head_attention(queries, keys, values, num_heads, causal=False,
                         dropout_rate=0.0, param_attr=None, seq_axis=None,
                         cache=None, pos=None, slot=None, cache_mode=None,
                         mp=False, name=None):
    """Full multi-head attention block over [batch, seq, d_model] tensors:
    qkv projections -> flash attention -> output projection.

    With ``cache=``/``cache_mode=`` (and ``pos=`` or ``slot=``, see
    ``flash_attention``), runs in KV-cached mode and returns
    ``(out, k_cache_out, v_cache_out)``. ``dropout_rate`` drops the
    attention context before the output projection. The Megatron
    tensor-parallel layout (``mp=True``) arrives with a later slice."""
    if mp:
        raise NotImplementedError("multi_head_attention(mp=True): tensor "
                                  "parallelism arrives with a later slice")
    d_model = int(queries.shape[-1])
    if d_model % num_heads:
        raise ValueError("d_model %d not divisible by num_heads %d"
                         % (d_model, num_heads))

    def proj_attr(suffix):
        # a shared named ParamAttr would alias all four projection weights
        # to one parameter; derive a distinct name per projection
        from paddle_tpu_torch.param_attr import ParamAttr
        if param_attr is None:
            return None
        pa = ParamAttr.to_attr(param_attr)
        if suffix is not None and pa.name is not None:
            pa = pa.clone_with_name(pa.name + "_" + suffix)
        return pa

    q = fc(queries, d_model, num_flatten_dims=2, param_attr=proj_attr("q"),
           bias_attr=False)
    k = fc(keys, d_model, num_flatten_dims=2, param_attr=proj_attr("k"),
           bias_attr=False)
    v = fc(values, d_model, num_flatten_dims=2, param_attr=proj_attr("v"),
           bias_attr=False)

    def split_heads(x):
        r = reshape(x, [0, 0, num_heads, d_model // num_heads])
        return transpose(r, [0, 2, 1, 3])

    kc_out = vc_out = None
    if cache is not None:
        ctx, kc_out, vc_out = flash_attention(
            split_heads(q), split_heads(k), split_heads(v), causal=causal,
            seq_axis=seq_axis, cache=cache, pos=pos, slot=slot,
            cache_mode=cache_mode)
    else:
        ctx = flash_attention(split_heads(q), split_heads(k),
                              split_heads(v), causal=causal,
                              seq_axis=seq_axis)
    ctx = transpose(ctx, [0, 2, 1, 3])
    ctx = reshape(ctx, [0, 0, d_model])
    if dropout_rate:
        ctx = dropout(ctx, dropout_prob=dropout_rate)
    out = fc(ctx, d_model, num_flatten_dims=2, param_attr=param_attr,
             bias_attr=False)
    return (out, kc_out, vc_out) if cache is not None else out


# ---- unary math, activations, clipping and selection ----

def sigmoid(x, name=None):
    return _single_op("sigmoid", x, name=name)


def sqrt(x, name=None):
    return _single_op("sqrt", x, name=name)


def exp(x, name=None):
    return _single_op("exp", x, name=name)


def log(x, name=None):
    return _single_op("log", x, name=name)


def square(x, name=None):
    return _single_op("square", x, name=name)


def abs(x, name=None):
    return _single_op("abs", x, name=name)


def ceil(x, name=None):
    return _single_op("ceil", x, name=name)


def floor(x, name=None):
    return _single_op("floor", x, name=name)


def sign(x, name=None):
    return _single_op("sign", x, name=name)


def pow(x, factor=1.0, name=None):
    return _single_op("pow", x, {"factor": factor}, name=name)


def prelu(x, mode="all", param_attr=None, name=None):
    helper = LayerHelper("prelu", param_attr=param_attr, name=name)
    if mode == "all":
        alpha_shape = [1]
    elif mode == "channel":
        alpha_shape = [int(x.shape[1])]
    else:
        alpha_shape = [int(s) for s in x.shape[1:]]
    alpha = helper.create_parameter(helper.param_attr, alpha_shape, x.dtype,
                                    default_initializer=Constant(0.25))
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("prelu", {"X": [x], "Alpha": [alpha]}, {"Out": [out]},
                     {"mode": mode})
    return out


def leaky_relu(x, alpha=0.02, name=None):
    return _single_op("leaky_relu", x, {"alpha": alpha}, name=name)


def elu(x, alpha=1.0, name=None):
    return _single_op("elu", x, {"alpha": alpha}, name=name)


def relu6(x, threshold=6.0, name=None):
    return _single_op("relu6", x, {"threshold": threshold}, name=name)


def swish(x, beta=1.0, name=None):
    return _single_op("swish", x, {"beta": beta}, name=name)


def brelu(x, t_min=0.0, t_max=24.0, name=None):
    return _single_op("brelu", x, {"t_min": t_min, "t_max": t_max}, name=name)


def soft_relu(x, threshold=40.0, name=None):
    return _single_op("soft_relu", x, {"threshold": threshold}, name=name)


def maxout(x, groups, name=None):
    return _single_op("maxout", x, {"groups": groups}, name=name)


def clip(x, min, max, name=None):
    return _single_op("clip", x, {"min": min, "max": max}, name=name)


def clip_by_norm(x, max_norm, name=None):
    return _single_op("clip_by_norm", x, {"max_norm": max_norm}, name=name)


def where(condition, x, y, name=None):
    helper = LayerHelper("where", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("where", {"Condition": [condition], "X": [x], "Y": [y]},
                     {"Out": [out]})
    return out


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """A persistable int64 counter that one in-program ``increment`` op
    advances by ``step`` each run, starting at ``begin``."""
    from paddle_tpu_torch.layers.tensor import create_global_var
    counter = create_global_var([1], begin - step, "int64", persistable=True,
                                name=counter_name or "@STEP_COUNTER@")
    helper = LayerHelper("step_counter")
    helper.append_op("increment", {"X": [counter]}, {"Out": [counter]},
                     {"step": float(step)})
    counter.stop_gradient = True
    return counter


def linear_chain_crf(input, label, param_attr=None, name=None):
    """CRF training loss (reference layers/nn.py linear_chain_crf ->
    operators/linear_chain_crf_op.cc). Returns each sequence's negative
    log likelihood [batch, 1]; the transition parameter's rows are
    start, end, then [tag x tag]."""
    helper = LayerHelper("linear_chain_crf", param_attr=param_attr,
                         name=name)
    size = int(input.shape[-1])
    transition = helper.create_parameter(helper.param_attr,
                                         [size + 2, size], input.dtype)
    ll = helper.create_variable_for_type_inference(input.dtype)
    alpha = helper.create_variable_for_type_inference(input.dtype)
    e_exps = helper.create_variable_for_type_inference(input.dtype)
    t_exps = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("linear_chain_crf",
                     {"Emission": [input], "Transition": [transition],
                      "Label": [label]},
                     {"LogLikelihood": [ll], "Alpha": [alpha],
                      "EmissionExps": [e_exps], "TransitionExps": [t_exps]},
                     {})
    return ll


def crf_decoding(input, param_attr, label=None, name=None):
    """Viterbi decode with the transition ``linear_chain_crf`` learned
    (reference operators/crf_decoding_op.cc); pass the same
    param_attr."""
    helper = LayerHelper("crf_decoding", param_attr=param_attr, name=name)
    size = int(input.shape[-1])
    transition = helper.create_parameter(helper.param_attr,
                                         [size + 2, size], input.dtype)
    path = helper.create_variable_for_type_inference("int64")
    ins = {"Emission": [input], "Transition": [transition]}
    if label is not None:
        ins["Label"] = [label]
    helper.append_op("crf_decoding", ins, {"ViterbiPath": [path]}, {})
    return path


def warpctc(input, label, blank=0, norm_by_times=False, name=None):
    """CTC loss (reference operators/warpctc_op.cc): input = sequence of
    unnormalised logits [B, T, V], label = sequence of ids."""
    helper = LayerHelper("warpctc", name=name)
    loss = helper.create_variable_for_type_inference(input.dtype)
    grad = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("warpctc", {"Logits": [input], "Label": [label]},
                     {"Loss": [loss], "WarpCTCGrad": [grad]},
                     {"blank": blank, "norm_by_times": norm_by_times})
    return loss


def ctc_greedy_decoder(input, blank, name=None):
    """Greedy CTC decode: argmax per frame, merge repeats, drop blanks
    (reference operators/ctc_align_op.cc)."""
    helper = LayerHelper("ctc_align", name=name)
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op("ctc_align", {"Input": [input]}, {"Output": [out]},
                     {"blank": blank})
    return out


def edit_distance(input, label, normalized=True, name=None):
    """Levenshtein distance between sequences of ids, row by row
    (reference operators/edit_distance_op.cc). Returns ``(distances [B,
    1], sequence count [1])``."""
    helper = LayerHelper("edit_distance", name=name)
    out = helper.create_variable_for_type_inference("float32")
    seq_num = helper.create_variable_for_type_inference("int64")
    helper.append_op("edit_distance",
                     {"Hyps": [input], "Refs": [label]},
                     {"Out": [out], "SequenceNum": [seq_num]},
                     {"normalized": normalized})
    return out, seq_num


def chunk_eval(input, label, chunk_scheme="IOB", num_chunk_types=1,
               excluded_chunk_types=None, name=None):
    """Chunking precision/recall/F1 over packed tag sequences (reference
    operators/chunk_eval_op.cc, fluid.layers.chunk_eval). Returns
    ``(precision, recall, f1, num_infer_chunks, num_label_chunks,
    num_correct_chunks)``."""
    helper = LayerHelper("chunk_eval", name=name)
    prec = helper.create_variable_for_type_inference("float32")
    rec = helper.create_variable_for_type_inference("float32")
    f1 = helper.create_variable_for_type_inference("float32")
    n_inf = helper.create_variable_for_type_inference("int64")
    n_lab = helper.create_variable_for_type_inference("int64")
    n_cor = helper.create_variable_for_type_inference("int64")
    helper.append_op("chunk_eval",
                     {"Inference": [input], "Label": [label]},
                     {"Precision": [prec], "Recall": [rec],
                      "F1-Score": [f1], "NumInferChunks": [n_inf],
                      "NumLabelChunks": [n_lab],
                      "NumCorrectChunks": [n_cor]},
                     {"chunk_scheme": chunk_scheme,
                      "num_chunk_types": num_chunk_types,
                      "excluded_chunk_types": excluded_chunk_types or []})
    return prec, rec, f1, n_inf, n_lab, n_cor


# ---- the dense op library ----

def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    return _two_in_op("mul", x, y, {"x_num_col_dims": x_num_col_dims,
                                    "y_num_col_dims": y_num_col_dims},
                      name=name)


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    return _two_in_op("matmul", x, y,
                      {"transpose_X": transpose_x, "transpose_Y": transpose_y,
                       "alpha": alpha}, name=name)


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", name=name)
    dim = dim if dim >= 0 else dim + len(input.shape)
    if isinstance(num_or_sections, int):
        num, sections = num_or_sections, []
    else:
        num, sections = 0, list(num_or_sections)
    outs = [helper.create_variable_for_type_inference(input.dtype)
            for _ in range(num if num else len(sections))]
    helper.append_op("split", {"X": [input]}, {"Out": outs},
                     {"axis": dim, "num": num, "sections": sections})
    return outs


def stack(x, axis=0):
    helper = LayerHelper("stack")
    out = helper.create_variable_for_type_inference(x[0].dtype)
    helper.append_op("stack", {"X": x}, {"Y": [out]}, {"axis": axis})
    return out


def unstack(x, axis=0, num=None):
    helper = LayerHelper("unstack")
    if num is None:
        num = int(x.shape[axis])
    outs = [helper.create_variable_for_type_inference(x.dtype)
            for _ in range(num)]
    helper.append_op("unstack", {"X": [x]}, {"Y": outs},
                     {"axis": axis, "num": num})
    return outs


def expand(x, expand_times, name=None):
    return _single_op("expand", x, {"expand_times": list(expand_times)},
                      name=name)


def flatten(x, axis=1, name=None):
    return _single_op("flatten", x, {"axis": axis}, name=name)


def gather(input, index, axis=0):
    helper = LayerHelper("gather")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("gather", {"X": [input], "Index": [index]},
                     {"Out": [out]}, {"axis": axis})
    return out


def gather_nd(input, index, name=None):
    helper = LayerHelper("gather_nd", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("gather_nd", {"X": [input], "Index": [index]},
                     {"Out": [out]})
    return out


def scatter(input, index, updates, overwrite=True, name=None):
    helper = LayerHelper("scatter", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("scatter",
                     {"X": [input], "Ids": [index], "Updates": [updates]},
                     {"Out": [out]}, {"overwrite": overwrite})
    return out


def slice(input, axes, starts, ends, name=None):
    return _single_op("slice", input,
                      {"axes": list(axes), "starts": list(starts),
                       "ends": list(ends)}, name=name)


def strided_slice(input, axes, starts, ends, strides, name=None):
    return _single_op("strided_slice", input,
                      {"axes": list(axes), "starts": list(starts),
                       "ends": list(ends), "strides": list(strides)},
                      name=name)


def shape(input):
    helper = LayerHelper("shape")
    out = helper.create_variable_for_type_inference("int32")
    helper.append_op("shape", {"Input": [input]}, {"Out": [out]})
    return out


def one_hot(input, depth):
    helper = LayerHelper("one_hot")
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op("one_hot", {"X": [input]}, {"Out": [out]},
                     {"depth": depth})
    return out


def pad(x, paddings, pad_value=0.0, name=None):
    return _single_op("pad", x, {"paddings": list(paddings),
                                 "pad_value": pad_value}, name=name)


def pad2d(input, paddings=(0, 0, 0, 0), mode="constant", pad_value=0.0,
          data_format="NCHW", name=None):
    return _single_op("pad2d", input,
                      {"paddings": list(paddings), "mode": mode,
                       "pad_value": pad_value}, name=name)


def cumsum(x, axis=-1, exclusive=False, reverse=False, name=None):
    return _single_op("cumsum", x, {"axis": axis, "exclusive": exclusive,
                                    "reverse": reverse}, name=name)


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    helper = LayerHelper("l2_normalize", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    norm = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("norm", {"X": [x]}, {"Out": [out], "Norm": [norm]},
                     {"axis": axis, "epsilon": epsilon})
    return out


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32",
                 name=None):
    helper = LayerHelper("label_smooth", name=name)
    out = helper.create_variable_for_type_inference(dtype)
    ins = {"X": [label]}
    if prior_dist is not None:
        ins["PriorDist"] = [prior_dist]
    helper.append_op("label_smooth", ins, {"Out": [out]},
                     {"epsilon": epsilon})
    return out


def multiplex(inputs, index):
    helper = LayerHelper("multiplex")
    out = helper.create_variable_for_type_inference(inputs[0].dtype)
    helper.append_op("multiplex", {"X": inputs, "Ids": [index]},
                     {"Out": [out]})
    return out


def cos_sim(X, Y):
    helper = LayerHelper("cos_sim")
    out, xn, yn = (helper.create_variable_for_type_inference(X.dtype)
                   for _ in range(3))
    helper.append_op("cos_sim", {"X": [X], "Y": [Y]},
                     {"Out": [out], "XNorm": [xn], "YNorm": [yn]})
    return out


def square_error_cost(input, label):
    helper = LayerHelper("square_error_cost")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("square_error_cost", {"X": [input], "Y": [label]},
                     {"Out": [out]})
    return out


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=None, bias_attr=None, param_attr=None, act=None,
                  name=None):
    helper = LayerHelper("sequence_conv", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    w = helper.create_parameter(
        helper.param_attr, [filter_size * int(input.shape[-1]), num_filters],
        dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("sequence_conv", {"X": [input], "Filter": [w]},
                     {"Out": [out]},
                     {"contextLength": filter_size,
                      "contextStart": -(filter_size // 2),
                      "contextStride": filter_stride})
    pre_act = helper.append_bias_op(out, dim_start=2)
    return helper.append_activation(pre_act)


def bilinear_tensor_product(x, y, size, act=None, name=None, param_attr=None,
                            bias_attr=None):
    helper = LayerHelper("bilinear_tensor_product", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    w = helper.create_parameter(
        helper.param_attr, [size, int(x.shape[1]), int(y.shape[1])], x.dtype)
    b = helper.create_parameter(helper.bias_attr, [1, size], x.dtype,
                                is_bias=True)
    out = helper.create_variable_for_type_inference(x.dtype)
    ins = {"X": [x], "Y": [y], "Weight": [w]}
    if b is not None:
        ins["Bias"] = [b]
    helper.append_op("bilinear_tensor_product", ins, {"Out": [out]})
    return helper.append_activation(out)


def hash(input, hash_size, num_hash=1, name=None):
    return _single_op("hash", input,
                      {"hash_size": hash_size, "num_hash": num_hash},
                      dtype="int64", name=name)


def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="float32"):
    helper = LayerHelper("sampling_id")
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op("sampling_id", {"X": [x]}, {"Out": [out]},
                     {"min": min, "max": max, "seed": seed})
    return out


def similarity_focus(input, axis, indexes, name=None):
    return _single_op("similarity_focus", input,
                      {"axis": axis, "indexes": list(indexes)}, name=name)


def argsort(input, axis=-1, name=None):
    from paddle_tpu_torch.layers.tensor import argsort as _argsort
    return _argsort(input, axis, name)


def unique_with_counts(x, dtype="int32"):
    helper = LayerHelper("unique_with_counts")
    out = helper.create_variable_for_type_inference(x.dtype)
    index = helper.create_variable_for_type_inference(dtype)
    count = helper.create_variable_for_type_inference(dtype)
    helper.append_op("unique_with_counts", {"X": [x]},
                     {"Out": [out], "Index": [index], "Count": [count]})
    return out, index, count


def random_crop(x, shape, seed=None):
    helper = LayerHelper("random_crop")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("random_crop", {"X": [x]}, {"Out": [out]},
                     {"shape": list(shape), "seed": seed or 0})
    return out


def row_conv(input, future_context_size, param_attr=None, act=None):
    helper = LayerHelper("row_conv", param_attr=param_attr, act=act)
    w = helper.create_parameter(
        helper.param_attr, [future_context_size + 1, int(input.shape[-1])],
        input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("row_conv", {"X": [input], "Filter": [w]},
                     {"Out": [out]})
    return helper.append_activation(out)


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32"):
    helper = LayerHelper("gaussian_random")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("gaussian_random", {}, {"Out": [out]},
                     {"shape": [int(s) for s in shape], "mean": mean,
                      "std": std, "seed": seed, "dtype": dtype})
    return out


def uniform_random_batch_size_like(input, shape, dtype="float32",
                                   input_dim_idx=0, output_dim_idx=0,
                                   min=-1.0, max=1.0, seed=0):
    helper = LayerHelper("uniform_random_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("uniform_random_batch_size_like", {"Input": [input]},
                     {"Out": [out]},
                     {"shape": [int(s) for s in shape], "dtype": dtype,
                      "input_dim_idx": input_dim_idx,
                      "output_dim_idx": output_dim_idx,
                      "min": min, "max": max, "seed": seed})
    return out


def gaussian_random_batch_size_like(input, shape, input_dim_idx=0,
                                    output_dim_idx=0, mean=0.0, std=1.0,
                                    seed=0, dtype="float32"):
    """Emits a ``uniform_random_batch_size_like`` op drawing in mean +/- 3
    std, as the JAX package's layer does, so both packages' programs
    serialize alike (a uniform draw, not a Gaussian one: ROADMAP.md
    Queue 3)."""
    helper = LayerHelper("gaussian_random_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("uniform_random_batch_size_like", {"Input": [input]},
                     {"Out": [out]},
                     {"shape": [int(s) for s in shape], "dtype": dtype,
                      "input_dim_idx": input_dim_idx,
                      "output_dim_idx": output_dim_idx,
                      "min": mean - 3 * std, "max": mean + 3 * std,
                      "seed": seed})
    return out


# ---- the vision family ----

def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, act=None, name=None):
    helper = LayerHelper("conv3d", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    groups = groups or 1
    num_channels = int(input.shape[1])
    fsize = filter_size if isinstance(filter_size, (list, tuple)) \
        else [filter_size] * 3
    filter_shape = [num_filters, num_channels // groups] + list(fsize)
    w = helper.create_parameter(helper.param_attr, filter_shape, dtype)
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "conv3d", {"Input": [input], "Filter": [w]}, {"Output": [pre_bias]},
        {"strides": _pair(stride, 3), "paddings": _pair(padding, 3),
         "dilations": _pair(dilation, 3), "groups": groups})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=None,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None):
    helper = LayerHelper("conv2d_transpose", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    num_channels = int(input.shape[1])
    if filter_size is None:
        # from output_size (reference nn.py:1845): invert
        # out = (in-1)*stride - 2*pad + dilation*(filter-1) + 1
        if output_size is None:
            raise ValueError(
                "conv2d_transpose needs filter_size or output_size")
        osz = output_size if isinstance(output_size, (list, tuple)) \
            else [output_size, output_size]
        strides, pads = _pair(stride), _pair(padding)
        dils = _pair(dilation)
        filter_size = [
            (int(osz[i]) - (int(input.shape[2 + i]) - 1) * strides[i]
             + 2 * pads[i] - 1) // dils[i] + 1
            for i in range(2)]
    fsize = filter_size if isinstance(filter_size, (list, tuple)) \
        else [filter_size, filter_size]
    filter_shape = [num_channels, num_filters // (groups or 1)] + list(fsize)
    w = helper.create_parameter(helper.param_attr, filter_shape, dtype)
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "conv2d_transpose", {"Input": [input], "Filter": [w]},
        {"Output": [pre_bias]},
        {"strides": _pair(stride), "paddings": _pair(padding),
         "dilations": _pair(dilation), "groups": groups or 1})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def pool3d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, name=None, exclusive=True):
    """3-D pooling over NCDHW (reference `pool_op.cc` Pool3D)."""
    helper = LayerHelper("pool3d", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "pool3d", {"X": [input]}, {"Out": [out]},
        {"pooling_type": pool_type, "ksize": _pair(pool_size, 3),
         "strides": _pair(pool_stride, 3), "paddings": _pair(pool_padding, 3),
         "global_pooling": global_pooling, "ceil_mode": ceil_mode,
         "exclusive": exclusive})
    return out


def max_pool3d_with_index(input, pool_size, pool_stride=1, pool_padding=0,
                          name=None):
    """3-D max pool returning (Out, Mask) (reference
    `pool_with_index_op.cc`)."""
    helper = LayerHelper("max_pool3d_with_index", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    mask = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        "max_pool3d_with_index", {"X": [input]},
        {"Out": [out], "Mask": [mask]},
        {"ksize": _pair(pool_size, 3), "strides": _pair(pool_stride, 3),
         "paddings": _pair(pool_padding, 3)})
    return out, mask


def conv3d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=None,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None):
    """Transposed 3-D convolution (reference `conv_transpose_op.cc`)."""
    helper = LayerHelper("conv3d_transpose", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    num_channels = int(input.shape[1])
    if filter_size is None:
        raise ValueError("filter_size required")
    fsize = list(filter_size) if isinstance(filter_size, (list, tuple)) \
        else [filter_size] * 3
    filter_shape = [num_channels, num_filters // (groups or 1)] + fsize
    w = helper.create_parameter(helper.param_attr, filter_shape, dtype)
    pre_bias = helper.create_variable_for_type_inference(dtype)
    attrs = {"strides": _pair(stride, 3), "paddings": _pair(padding, 3),
             "dilations": _pair(dilation, 3), "groups": groups or 1}
    if output_size is not None:
        attrs["output_size"] = (list(output_size)
                                if isinstance(output_size, (list, tuple))
                                else [output_size] * 3)
    helper.append_op(
        "conv3d_transpose", {"Input": [input], "Filter": [w]},
        {"Output": [pre_bias]}, attrs)
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def unpool(input, indices, ksize, strides=1, paddings=0, name=None):
    """Max-unpooling from max_pool2d_with_index's Mask (reference
    `unpool_op.cc`)."""
    helper = LayerHelper("unpool", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "unpool", {"X": [input], "Indices": [indices]}, {"Out": [out]},
        {"ksize": _pair(ksize), "strides": _pair(strides),
         "paddings": _pair(paddings), "unpooling_type": "max"})
    return out


def spp(input, pyramid_height, pool_type="max", name=None):
    """Spatial pyramid pooling (reference `spp_op.cc`)."""
    helper = LayerHelper("spp", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "spp", {"X": [input]}, {"Out": [out]},
        {"pyramid_height": pyramid_height, "pooling_type": pool_type})
    return out


def im2sequence(input, filter_size=1, stride=1, padding=0, name=None):
    helper = LayerHelper("im2sequence", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("im2sequence", {"X": [input]}, {"Out": [out]},
                     {"kernels": _pair(filter_size), "strides": _pair(stride),
                      "paddings": _pair(padding)})
    return out


def grid_sampler(x, grid, name=None):
    helper = LayerHelper("grid_sampler", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("grid_sampler", {"X": [x], "Grid": [grid]},
                     {"Output": [out]})
    return out


def image_resize(input, out_shape=None, scale=None, name=None,
                 resample="BILINEAR"):
    helper = LayerHelper("image_resize", name=name)
    if out_shape is None:
        h = int(int(input.shape[2]) * scale)
        w = int(int(input.shape[3]) * scale)
        out_shape = [h, w]
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("resize_bilinear" if resample == "BILINEAR"
                     else "resize_nearest",
                     {"X": [input]}, {"Out": [out]},
                     {"out_h": int(out_shape[0]), "out_w": int(out_shape[1])})
    return out


def resize_bilinear(input, out_shape=None, scale=None, name=None):
    return image_resize(input, out_shape, scale, name, "BILINEAR")


def resize_nearest(input, out_shape=None, scale=None, name=None):
    return image_resize(input, out_shape, scale, name, "NEAREST")


# ---- layers over ops already ported ----

def group_norm(input, groups, epsilon=1e-5, param_attr=None, bias_attr=None,
               act=None, name=None):
    helper = LayerHelper("group_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    c = int(input.shape[1])
    reshaped = reshape(input, [0, groups, -1])
    normed = layer_norm(reshaped, scale=False, shift=False, begin_norm_axis=2,
                        epsilon=epsilon)
    out = reshape(normed, [0, c] + [int(s) for s in input.shape[2:]])
    scale_p = helper.create_parameter(helper.param_attr, [c], input.dtype,
                                      default_initializer=Constant(1.0))
    bias = helper.create_parameter(helper.bias_attr, [c], input.dtype,
                                   is_bias=True)
    bshape = [1, c] + [1] * (len(input.shape) - 2)
    out = elementwise_mul(out, reshape(scale_p, bshape))
    if bias is not None:
        out = elementwise_add(out, reshape(bias, bshape))
    return helper.append_activation(out)


batch_norm_1d = batch_norm


def sequence_last_step(input):
    return sequence_pool(input, "last")


def dice_loss(input, label, epsilon=1e-5):
    label = one_hot(label, depth=int(input.shape[-1]))
    reduce_dims = list(range(1, len(input.shape)))
    inse = reduce_sum(elementwise_mul(input, label), dim=reduce_dims)
    dice_denominator = elementwise_add(reduce_sum(input, dim=reduce_dims),
                                       reduce_sum(label, dim=reduce_dims))
    dice_score = scale(elementwise_div(
        scale(inse, scale=2.0),
        scale(dice_denominator, scale=1.0, bias=epsilon)),
        scale=-1.0, bias=1.0)
    return reduce_mean(dice_score)


# ---- the loss family's layers, the sampled and tree-structured
# softmax heads, the NTM shift and the streaming metrics ----

def conv_shift(x, y, name=None):
    """Circular convolution, the NTM attention shift (reference
    `conv_shift_op.cc`)."""
    helper = LayerHelper("conv_shift", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("conv_shift", {"X": [x], "Y": [y]}, {"Out": [out]}, {})
    return out


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    helper = LayerHelper("smooth_l1")
    loss = helper.create_variable_for_type_inference(x.dtype)
    diff = helper.create_variable_for_type_inference(x.dtype)
    ins = {"X": [x], "Y": [y]}
    if inside_weight is not None:
        ins["InsideWeight"] = [inside_weight]
    if outside_weight is not None:
        ins["OutsideWeight"] = [outside_weight]
    helper.append_op("smooth_l1_loss", ins, {"Out": [loss], "Diff": [diff]},
                     {"sigma": sigma or 1.0})
    return loss


def sigmoid_cross_entropy_with_logits(x, label, name=None):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("sigmoid_cross_entropy_with_logits",
                     {"X": [x], "Label": [label]}, {"Out": [out]}, {})
    return out


def log_loss(input, label, epsilon=1e-4, name=None):
    helper = LayerHelper("log_loss", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("log_loss", {"Predicted": [input], "Labels": [label]},
                     {"Loss": [out]}, {"epsilon": epsilon})
    return out


def huber_loss(input, label, delta):
    helper = LayerHelper("huber_loss")
    out = helper.create_variable_for_type_inference(input.dtype)
    resid = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("huber_loss", {"X": [input], "Y": [label]},
                     {"Out": [out], "Residual": [resid]}, {"delta": delta})
    return out


def kldiv_loss(x, target, reduction="mean", name=None):
    """As in the JAX package, the op's result goes to its "Loss" slot,
    which this layer does not name: ``out`` is never written (ROADMAP.md
    Queue 3)."""
    helper = LayerHelper("kldiv_loss", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("kldiv_loss", {"X": [x], "Target": [target]},
                     {"Out": [out]}, {"reduction": reduction})
    return out


def rank_loss(label, left, right, name=None):
    helper = LayerHelper("rank_loss", name=name)
    out = helper.create_variable_for_type_inference(left.dtype)
    helper.append_op("rank_loss",
                     {"Label": [label], "Left": [left], "Right": [right]},
                     {"Out": [out]})
    return out


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    helper = LayerHelper("margin_rank_loss", name=name)
    out = helper.create_variable_for_type_inference(left.dtype)
    act = helper.create_variable_for_type_inference(left.dtype)
    helper.append_op("margin_rank_loss",
                     {"Label": [label], "X1": [left], "X2": [right]},
                     {"Out": [out], "Activated": [act]}, {"margin": margin})
    return out


def bpr_loss(input, label, name=None):
    helper = LayerHelper("bpr_loss", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("bpr_loss", {"X": [input], "Label": [label]},
                     {"Y": [out]})
    return out


def hinge_loss(input, label, name=None):
    helper = LayerHelper("hinge_loss", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("hinge_loss", {"Logits": [input], "Labels": [label]},
                     {"Loss": [out]})
    return out


def nce(input, label, num_total_classes, sample_weight=None, param_attr=None,
        bias_attr=None, num_neg_samples=None, name=None):
    """Noise-contrastive estimation: W [V, D], bias [V, 1], 10 negatives
    a row unless ``num_neg_samples`` says otherwise. ``sample_weight`` is
    accepted and not passed on, as in the JAX package (ROADMAP.md Queue
    3)."""
    helper = LayerHelper("nce", param_attr=param_attr, bias_attr=bias_attr,
                         name=name)
    dim = int(input.shape[1])
    w = helper.create_parameter(helper.param_attr, [num_total_classes, dim],
                                input.dtype)
    b = helper.create_parameter(helper.bias_attr, [num_total_classes, 1],
                                input.dtype, is_bias=True)
    cost = helper.create_variable_for_type_inference(input.dtype)
    sample_logits = helper.create_variable_for_type_inference(input.dtype)
    sample_labels = helper.create_variable_for_type_inference("int64")
    ins = {"Input": [input], "Label": [label], "Weight": [w]}
    if b is not None:
        ins["Bias"] = [b]
    helper.append_op("nce", ins,
                     {"Cost": [cost], "SampleLogits": [sample_logits],
                      "SampleLabels": [sample_labels]},
                     {"num_total_classes": num_total_classes,
                      "num_neg_samples": num_neg_samples or 10})
    return cost


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None):
    """The hierarchical sigmoid over a complete binary tree of
    ``num_classes`` leaves: W [C - 1, D], bias [1, C - 1]."""
    helper = LayerHelper("hierarchical_sigmoid", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    dim = int(input.shape[1])
    w = helper.create_parameter(helper.param_attr, [num_classes - 1, dim],
                                input.dtype)
    b = helper.create_parameter(helper.bias_attr, [1, num_classes - 1],
                                input.dtype, is_bias=True)
    out = helper.create_variable_for_type_inference(input.dtype)
    pre = helper.create_variable_for_type_inference(input.dtype)
    ins = {"X": [input], "W": [w], "Label": [label]}
    if b is not None:
        ins["Bias"] = [b]
    helper.append_op("hierarchical_sigmoid", ins,
                     {"Out": [out], "PreOut": [pre]},
                     {"num_classes": num_classes})
    return out


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1):
    """Streaming AUC: persistable histograms ``<name>.stat_pos`` and
    ``.stat_neg`` of ``num_thresholds + 1`` bins, zeroed by the startup
    program and carried from batch to batch. Returns (auc, auc,
    [stat_pos, stat_neg])."""
    helper = LayerHelper("auc")
    auc_out = helper.create_variable_for_type_inference("float32")
    stat_pos = helper.create_global_variable(
        persistable=True, shape=[num_thresholds + 1], dtype="float32",
        name=helper.name + ".stat_pos")
    stat_neg = helper.create_global_variable(
        persistable=True, shape=[num_thresholds + 1], dtype="float32",
        name=helper.name + ".stat_neg")
    helper.set_variable_initializer(stat_pos, Constant(0.0))
    helper.set_variable_initializer(stat_neg, Constant(0.0))
    helper.append_op("auc",
                     {"Predict": [input], "Label": [label],
                      "StatPos": [stat_pos], "StatNeg": [stat_neg]},
                     {"AUC": [auc_out], "StatPosOut": [stat_pos],
                      "StatNegOut": [stat_neg]},
                     {"num_thresholds": num_thresholds})
    return auc_out, auc_out, [stat_pos, stat_neg]


def mean_iou(input, label, num_classes):
    helper = LayerHelper("mean_iou")
    out = helper.create_variable_for_type_inference("float32")
    wrong = helper.create_variable_for_type_inference("float32")
    correct = helper.create_variable_for_type_inference("float32")
    helper.append_op("mean_iou",
                     {"Predictions": [input], "Labels": [label]},
                     {"OutMeanIou": [out], "OutWrong": [wrong],
                      "OutCorrect": [correct]},
                     {"num_classes": num_classes})
    return out, wrong, correct
