"""Tensor layers.

Capability parity: `python/paddle/fluid/layers/tensor.py`. The port
carries ``create_global_var``, ``cast``, ``concat``, ``fill_constant``,
``fill_constant_batch_size_like``, ``ones_like`` and ``position_ids``;
the rest of the module's layers
arrive with later slices.
"""

import numpy as np

from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["create_global_var", "cast", "concat", "fill_constant",
           "fill_constant_batch_size_like", "ones_like", "position_ids"]


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


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op("fill_constant", {}, {"Out": [out]},
                     {"shape": [int(s) for s in shape],
                      "dtype": np.dtype(dtype).name, "value": float(value)})
    out.stop_gradient = True
    return out


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
