"""Tensor layers.

Capability parity: `python/paddle/fluid/layers/tensor.py`. This slice
carries ``concat`` and ``position_ids``; the rest of the module's
layers arrive with later slices.
"""

from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["concat", "position_ids"]


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    out = helper.create_variable_for_type_inference(helper.input_dtype())
    helper.append_op("concat", {"X": input}, {"Out": [out]}, {"axis": axis})
    return out


def position_ids(x, name=None):
    """[batch, seq] position indices (0..seq-1) matching x's batch/seq dims."""
    helper = LayerHelper("position_ids", name=name)
    out = helper.create_variable_for_type_inference("int32")
    helper.append_op("position_ids", {"X": [x]}, {"Out": [out]})
    return out
