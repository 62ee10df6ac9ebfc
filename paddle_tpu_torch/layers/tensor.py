"""Tensor layers.

Capability parity: `python/paddle/fluid/layers/tensor.py`: every layer
of the JAX package's ``layers/tensor.py``.
"""

import numpy as np

from paddle_tpu_torch.core import ir
from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["create_tensor", "create_parameter", "create_global_var", "cast",
           "concat", "sums", "assign", "fill_constant",
           "fill_constant_batch_size_like", "ones", "zeros", "ones_like",
           "zeros_like", "argmin", "argmax", "argsort", "reverse",
           "linspace", "range", "position_ids"]


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper("create_tensor", name=name)
    return helper.create_variable(name=helper.name, dtype=dtype,
                                  persistable=persistable)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    helper = LayerHelper("create_parameter", param_attr=attr, name=name)
    return helper.create_parameter(helper.param_attr, shape, dtype, is_bias,
                                   default_initializer)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    from paddle_tpu_torch.initializer import Constant
    helper = LayerHelper("global_var", name=name)
    var = helper.create_global_variable(shape=shape, dtype=dtype,
                                        persistable=persistable)
    helper.set_variable_initializer(var, Constant(value))
    return var


def cast(x, dtype):
    dtype = np.dtype(dtype).name
    helper = LayerHelper("cast")
    out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op("cast", {"X": [x]}, {"Out": [out]}, {"out_dtype": dtype})
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    out = helper.create_variable_for_type_inference(helper.input_dtype())
    helper.append_op("concat", {"X": input}, {"Out": [out]}, {"axis": axis})
    return out


def sums(input, out=None):
    helper = LayerHelper("sum")
    if out is None:
        out = helper.create_variable_for_type_inference(helper.input_dtype())
    helper.append_op("sum", {"X": input}, {"Out": [out]})
    return out


def assign(input, output=None):
    """``output`` (a new variable if None) takes ``input``'s value: a
    Variable through an ``assign`` op, a numpy array or list through an
    ``assign_value`` op that holds its values."""
    helper = LayerHelper("assign")
    if output is None:
        output = helper.create_variable_for_type_inference("float32")
    if isinstance(input, ir.Variable):
        helper.append_op("assign", {"X": [input]}, {"Out": [output]})
    else:
        arr = np.asarray(input)
        helper.append_op("assign_value", {}, {"Out": [output]},
                         {"shape": list(arr.shape), "dtype": arr.dtype.name,
                          "values": arr.reshape(-1).tolist()})
    return output


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op("fill_constant", {}, {"Out": [out]},
                     {"shape": [int(s) for s in shape],
                      "dtype": np.dtype(dtype).name, "value": float(value)})
    out.stop_gradient = True
    return out


def ones(shape, dtype, force_cpu=False):
    return fill_constant(shape, dtype, 1.0)


def zeros(shape, dtype, force_cpu=False):
    return fill_constant(shape, dtype, 0.0)


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    helper = LayerHelper("fill_constant_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op("fill_constant_batch_size_like", {"Input": [input]},
                     {"Out": [out]},
                     {"shape": [int(s) for s in shape],
                      "dtype": np.dtype(dtype).name, "value": float(value),
                      "input_dim_idx": input_dim_idx,
                      "output_dim_idx": output_dim_idx})
    out.stop_gradient = True
    return out


def position_ids(x, name=None):
    """[batch, seq] position indices (0..seq-1) matching x's batch/seq dims."""
    helper = LayerHelper("position_ids", name=name)
    out = helper.create_variable_for_type_inference("int32")
    helper.append_op("position_ids", {"X": [x]}, {"Out": [out]})
    return out


def ones_like(x, out=None):
    helper = LayerHelper("ones_like")
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("scale", {"X": [x]}, {"Out": [out]},
                     {"scale": 0.0, "bias": 1.0})
    return out


def zeros_like(x, out=None):
    helper = LayerHelper("zeros_like")
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("fill_zeros_like", {"X": [x]}, {"Out": [out]})
    return out


def argmin(x, axis=0):
    helper = LayerHelper("arg_min")
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op("arg_min", {"X": [x]}, {"Out": [out]}, {"axis": axis})
    return out


def argmax(x, axis=0):
    helper = LayerHelper("arg_max")
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op("arg_max", {"X": [x]}, {"Out": [out]}, {"axis": axis})
    return out


def argsort(x, axis=-1, name=None):
    helper = LayerHelper("argsort", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    ids = helper.create_variable_for_type_inference("int64")
    helper.append_op("argsort", {"X": [x]}, {"Out": [out], "Indices": [ids]},
                     {"axis": axis})
    return out, ids


def reverse(x, axis):
    helper = LayerHelper("reverse")
    out = helper.create_variable_for_type_inference(x.dtype)
    if isinstance(axis, int):
        axis = [axis]
    helper.append_op("reverse", {"X": [x]}, {"Out": [out]}, {"axis": axis})
    return out


def linspace(start, stop, num, dtype="float32"):
    helper = LayerHelper("linspace")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("linspace", {}, {"Out": [out]},
                     {"start": float(start), "stop": float(stop),
                      "num": int(num), "dtype": dtype})
    return out


def range(start, end, step=1, dtype="float32"):
    helper = LayerHelper("range")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("range", {}, {"Out": [out]},
                     {"start": start, "end": end, "step": step, "dtype": dtype})
    return out
