"""Neural-network layers DSL.

Capability parity: `python/paddle/fluid/layers/nn.py`. Each function
appends ops to the current program block; shapes propagate by meta-tensor
inference so downstream layers can size parameters. These are the
layers of the transformer LM and its KV-cached serving forwards, of
the stacked-LSTM classifier and the MNIST MLP with their training
losses and metric, of the attention seq2seq model's training graph, and
of the convnets (conv2d, pool2d, batch_norm, relu, lrn, dropout: LeNet,
ResNet, VGG, AlexNet, GoogLeNet and SmallNet), and the activations;
the JAX package's other layers arrive with later slices.
"""

from paddle_tpu_torch.core import ir
from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.initializer import Constant, Normal

__all__ = [
    "fc", "embedding", "conv2d", "pool2d", "batch_norm", "relu", "lrn",
    "dropout",
    "dynamic_lstm", "dynamic_gru", "gru_unit",
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
]


def _single_op(type_name, x, attrs=None, dtype=None, name=None):
    helper = LayerHelper(type_name, name=name)
    out = helper.create_variable_for_type_inference(dtype or x.dtype)
    helper.append_op(type_name, {"X": [x]}, {"Out": [out]}, attrs or {})
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
    helper = LayerHelper("reduce_sum", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    if dim is None:
        attrs = {"reduce_all": True, "keep_dim": keep_dim}
    else:
        attrs = {"dim": dim if isinstance(dim, (list, tuple)) else [dim],
                 "keep_dim": keep_dim, "reduce_all": False}
    helper.append_op("reduce_sum", {"X": [input]}, {"Out": [out]}, attrs)
    return out


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
