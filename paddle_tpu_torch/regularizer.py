"""Weight-decay regularizers appended as gradient-transform ops.

Capability parity: `python/paddle/fluid/regularizer.py`
(append_regularization_ops :25, L1 :101, L2 :155), as the JAX
package's ``regularizer.py`` builds them: the decay term is a ``scale``
(L2) or ``sign`` + ``scale`` (L1) of the parameter, summed into the
gradient.
"""

from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["L1Decay", "L2Decay", "L1DecayRegularizer", "L2DecayRegularizer",
           "append_regularization_ops"]


class WeightDecayRegularizer:
    def __call__(self, param, grad, block):
        raise NotImplementedError


class L2Decay(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        helper = LayerHelper("l2_decay")
        decay = helper.create_variable_for_type_inference(param.dtype)
        block.append_op("scale", {"X": [param.name]}, {"Out": [decay.name]},
                        {"scale": self._coeff})
        return decay


class L1Decay(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        helper = LayerHelper("l1_decay")
        sign = helper.create_variable_for_type_inference(param.dtype)
        decay = helper.create_variable_for_type_inference(param.dtype)
        block.append_op("sign", {"X": [param.name]}, {"Out": [sign.name]})
        block.append_op("scale", {"X": [sign.name]}, {"Out": [decay.name]},
                        {"scale": self._coeff})
        return decay


def append_regularization_ops(params_grads, regularization=None):
    out = []
    for param, grad in params_grads:
        reg = getattr(param, "regularizer", None) or regularization
        if grad is None or reg is None:
            out.append((param, grad))
            continue
        block = grad.block
        decay = reg(param, grad, block)
        new_grad = block.create_var(
            name=grad.name + "@REG", shape=grad.shape, dtype=grad.dtype)
        block.append_op("sum", {"X": [grad.name, decay.name]},
                        {"Out": [new_grad.name]})
        out.append((param, new_grad))
    return out


L1DecayRegularizer = L1Decay
L2DecayRegularizer = L2Decay
