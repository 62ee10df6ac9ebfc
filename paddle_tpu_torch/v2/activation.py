"""v2 activation objects (reference trainer_config_helpers/activations.py)."""

__all__ = ["Tanh", "Sigmoid", "Softmax", "Relu", "BRelu", "SoftRelu",
           "Linear", "Identity", "Exp", "Log", "Square", "Sqrt", "Abs",
           "LeakyRelu"]


class BaseActivation:
    name = None

    def __repr__(self):
        return "activation.%s" % type(self).__name__


def _make(cls_name, act_name):
    cls = type(cls_name, (BaseActivation,), {"name": act_name})
    return cls


Tanh = _make("Tanh", "tanh")
Sigmoid = _make("Sigmoid", "sigmoid")
Softmax = _make("Softmax", "softmax")
Relu = _make("Relu", "relu")
BRelu = _make("BRelu", "brelu")
SoftRelu = _make("SoftRelu", "soft_relu")
Linear = _make("Linear", None)
Identity = Linear
Exp = _make("Exp", "exp")
Log = _make("Log", "log")
Square = _make("Square", "square")
Sqrt = _make("Sqrt", "sqrt")
Abs = _make("Abs", "abs")
LeakyRelu = _make("LeakyRelu", "leaky_relu")


def act_name(act):
    """None | activation instance/class -> fluid act string or None."""
    if act is None:
        return None
    if isinstance(act, type) and issubclass(act, BaseActivation):
        return act.name
    if isinstance(act, BaseActivation):
        return act.name
    return str(act)
