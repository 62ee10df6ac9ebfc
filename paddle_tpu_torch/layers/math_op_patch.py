"""Operator overloading on Variable (reference layers/math_op_patch.py),
as the JAX package installs it: ``a + b``, ``a * 2.0``, ``a < b``,
``-a`` and ``a.astype(dtype)`` append the elementwise, comparison,
scale and cast ops, so a cell written with operators builds the same
program in both packages. A Python scalar becomes a ``[1]``
``fill_constant`` of the other operand's dtype. ``layers`` installs the
operators when it is imported."""

from paddle_tpu_torch.core import ir
from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["monkey_patch_variable"]

_patched = False


def monkey_patch_variable():
    global _patched
    if _patched:
        return
    _patched = True

    def _elementwise(op_type, reverse=False):
        def impl(self, other):
            if not isinstance(other, ir.Variable):
                other = _scalar_to_var(self, other)
            lhs, rhs = (other, self) if reverse else (self, other)
            helper = LayerHelper(op_type)
            out = helper.create_variable_for_type_inference(lhs.dtype)
            helper.append_op(op_type, {"X": [lhs], "Y": [rhs]},
                             {"Out": [out]}, {"axis": -1})
            return out
        return impl

    def _scalar_to_var(ref, value):
        helper = LayerHelper("scalar")
        out = helper.create_variable_for_type_inference(ref.dtype)
        helper.append_op("fill_constant", {}, {"Out": [out]},
                         {"shape": [1], "dtype": ref.dtype,
                          "value": float(value)})
        return out

    ir.Variable.__add__ = _elementwise("elementwise_add")
    ir.Variable.__radd__ = _elementwise("elementwise_add", reverse=True)
    ir.Variable.__sub__ = _elementwise("elementwise_sub")
    ir.Variable.__rsub__ = _elementwise("elementwise_sub", reverse=True)
    ir.Variable.__mul__ = _elementwise("elementwise_mul")
    ir.Variable.__rmul__ = _elementwise("elementwise_mul", reverse=True)
    ir.Variable.__div__ = _elementwise("elementwise_div")
    ir.Variable.__truediv__ = _elementwise("elementwise_div")
    ir.Variable.__rtruediv__ = _elementwise("elementwise_div", reverse=True)
    ir.Variable.__pow__ = _elementwise("elementwise_pow")
    ir.Variable.__lt__ = _elementwise("less_than")
    ir.Variable.__le__ = _elementwise("less_equal")
    ir.Variable.__gt__ = _elementwise("greater_than")
    ir.Variable.__ge__ = _elementwise("greater_equal")

    def _neg(self):
        from paddle_tpu_torch.layers.nn import scale
        return scale(self, scale=-1.0)

    def _astype(self, dtype):
        from paddle_tpu_torch.layers import tensor
        return tensor.cast(self, dtype)

    ir.Variable.__neg__ = _neg
    ir.Variable.astype = _astype
