"""Weight-decay regularization of gradients.

Capability parity: `python/paddle/fluid/regularizer.py`
(append_regularization_ops :25). This slice carries what the optimizer
calls: with no regularizer set (the training path's case) the pass
leaves every gradient as it is. The L1/L2 decay classes and their
``scale``/``sign`` ops arrive with a later slice; a set regularizer
raises instead of being ignored.
"""

__all__ = ["append_regularization_ops"]


def append_regularization_ops(params_grads, regularization=None):
    out = []
    for param, grad in params_grads:
        reg = getattr(param, "regularizer", None) or regularization
        if grad is not None and reg is not None:
            raise NotImplementedError(
                "regularizer %r on %r: weight decay arrives with a later "
                "slice" % (reg, param.name))
        out.append((param, grad))
    return out
