"""v2 optimizers (reference python/paddle/v2/optimizer.py) — thin wrappers
that surface the v2 constructor signatures and produce fluid optimizers."""

from paddle_tpu_torch import optimizer as fluid_opt
from paddle_tpu_torch import regularizer as fluid_reg

__all__ = ["Momentum", "Adam", "Adamax", "AdaGrad", "DecayedAdaGrad",
           "AdaDelta", "RMSProp", "Optimizer"]


class Optimizer:
    def __init__(self, learning_rate=1e-3, regularization=None,
                 gradient_clipping_threshold=None, model_average=None,
                 learning_rate_decay_a=None, learning_rate_decay_b=None,
                 **kw):
        self.learning_rate = learning_rate
        self.regularization = regularization
        self.gradient_clipping_threshold = gradient_clipping_threshold
        self.model_average = model_average
        self.kw = kw

    def _regularization(self):
        if self.regularization is None:
            return None
        if isinstance(self.regularization, (int, float)):
            return fluid_reg.L2Decay(self.regularization)
        return self.regularization

    def to_fluid(self):
        raise NotImplementedError

    def _common(self):
        return {"regularization": self._regularization()}


class Momentum(Optimizer):
    def __init__(self, momentum=0.9, sparse=False, **kw):
        super().__init__(**kw)
        self.momentum = momentum

    def to_fluid(self):
        return fluid_opt.Momentum(self.learning_rate, self.momentum,
                                  **self._common())


class Adam(Optimizer):
    def __init__(self, beta1=0.9, beta2=0.999, epsilon=1e-8, **kw):
        super().__init__(**kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def to_fluid(self):
        return fluid_opt.Adam(self.learning_rate, beta1=self.beta1,
                              beta2=self.beta2, epsilon=self.epsilon,
                              **self._common())


class Adamax(Optimizer):
    def __init__(self, beta1=0.9, beta2=0.999, **kw):
        super().__init__(**kw)
        self.beta1, self.beta2 = beta1, beta2

    def to_fluid(self):
        return fluid_opt.Adamax(self.learning_rate, beta1=self.beta1,
                                beta2=self.beta2, **self._common())


class AdaGrad(Optimizer):
    def to_fluid(self):
        return fluid_opt.Adagrad(self.learning_rate, **self._common())


class DecayedAdaGrad(Optimizer):
    def __init__(self, rho=0.95, epsilon=1e-6, **kw):
        super().__init__(**kw)
        self.rho, self.epsilon = rho, epsilon

    def to_fluid(self):
        return fluid_opt.DecayedAdagrad(self.learning_rate, decay=self.rho,
                                        epsilon=self.epsilon,
                                        **self._common())


class AdaDelta(Optimizer):
    def __init__(self, rho=0.95, epsilon=1e-6, **kw):
        super().__init__(**kw)
        self.rho, self.epsilon = rho, epsilon

    def to_fluid(self):
        return fluid_opt.Adadelta(self.learning_rate, epsilon=self.epsilon,
                                  rho=self.rho, **self._common())


class RMSProp(Optimizer):
    def __init__(self, rho=0.95, epsilon=1e-6, **kw):
        super().__init__(**kw)
        self.rho, self.epsilon = rho, epsilon

    def to_fluid(self):
        return fluid_opt.RMSProp(self.learning_rate, rho=self.rho,
                                 epsilon=self.epsilon, **self._common())
