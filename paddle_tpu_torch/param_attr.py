"""ParamAttr: per-parameter configuration.

Capability parity: `python/paddle/fluid/param_attr.py`. The ``sharding``
field (mesh axes per parameter dim) is kept so layer code reads as the
JAX package's; this package runs on one device and does not read it.
``WeightNormParamAttr`` carries the reference's weight-norm ``dim``; as
in the JAX package, a layer builds the same parameter from it as from a
``ParamAttr``, so the program and the weights ``interop`` carries are
those of a ``ParamAttr``.
"""

__all__ = ["ParamAttr", "WeightNormParamAttr"]


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, gradient_clip=None,
                 sharding=None):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip
        self.sharding = sharding

    def clone_with_name(self, name):
        import copy
        pa = copy.copy(self)
        pa.name = name
        return pa

    @staticmethod
    def to_attr(arg):
        if arg is None:
            return ParamAttr()
        if isinstance(arg, (list, tuple)):
            return [ParamAttr.to_attr(a) for a in arg]
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, bool):
            return ParamAttr() if arg else False
        # an Initializer instance
        return ParamAttr(initializer=arg)


class WeightNormParamAttr(ParamAttr):
    def __init__(self, dim=None, **kwargs):
        super().__init__(**kwargs)
        self.dim = dim
