"""Optimizers: build update ops from params_grads.

Capability parity: `python/paddle/fluid/optimizer.py` (Optimizer base
:34, SGD :117, Momentum :126, Adam :361). ``minimize`` = append_backward + clip + regularization
+ one update op per parameter; a parameter's own learning rate
(``ParamAttr(learning_rate=...)``) is a ``scale`` of the shared rate. The learning-rate variable and the
accumulators are created exactly as the JAX package creates them (same
names, shapes, initializers), so a training program and its startup
serialize identically in both packages. The other optimizers arrive
with later slices.
"""

from paddle_tpu_torch import unique_name
from paddle_tpu_torch.clip import append_gradient_clip_ops
from paddle_tpu_torch.core import ir
from paddle_tpu_torch.core.backward import append_backward
from paddle_tpu_torch.initializer import Constant
from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.regularizer import append_regularization_ops

__all__ = ["SGD", "Momentum", "Adam", "SGDOptimizer", "MomentumOptimizer",
           "AdamOptimizer", "Optimizer"]


class Optimizer:
    def __init__(self, learning_rate, regularization=None, name=None):
        self._learning_rate = learning_rate
        self.regularization = regularization
        self._name = name
        self._accumulators = {}   # name -> {param_name: var}
        self._lr_var = None

    # ---- learning rate ----

    def _create_lr_var(self, program):
        if isinstance(self._learning_rate, ir.Variable):
            self._lr_var = self._learning_rate
            return
        block = program.global_block()
        name = unique_name.generate("learning_rate")
        self._lr_var = block.create_var(
            name=name, shape=(1,), dtype="float32", persistable=True,
            stop_gradient=True)
        helper = LayerHelper("lr")
        helper.set_variable_initializer(
            self._lr_var, Constant(float(self._learning_rate)))

    def _lr(self, param=None):
        if param is not None and param.optimize_attr:
            plr = param.optimize_attr.get("learning_rate", 1.0)
            if plr != 1.0:
                from paddle_tpu_torch.layers.nn import scale
                return scale(self._lr_var, scale=plr)
        return self._lr_var

    # ---- accumulators ----

    def _add_accumulator(self, name, param, dtype=None, fill_value=0.0,
                         shape=None):
        if name in self._accumulators and \
                param.name in self._accumulators[name]:
            return self._accumulators[name][param.name]
        block = param.block.program.global_block()
        var = block.create_var(
            name=unique_name.generate("%s_%s" % (param.name, name)),
            shape=shape or param.shape, dtype=dtype or param.dtype,
            persistable=True, stop_gradient=True)
        # optimizer state owned by `param`
        var.optimizer_state_for = param.name
        helper = LayerHelper("accum")
        helper.set_variable_initializer(var, Constant(fill_value))
        self._accumulators.setdefault(name, {})[param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    # ---- main entrypoints ----

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = append_backward(loss, parameter_list, no_grad_set)
        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        optimize_ops = self.apply_gradients(loss.block.program, params_grads)
        return optimize_ops, params_grads

    def apply_gradients(self, program, params_grads):
        self._create_lr_var(program)
        self._create_accumulators(program, [p for p, _ in params_grads])
        ops = []
        for p, g in params_grads:
            if g is None:
                continue
            ops.append(self._append_optimize_op(program.current_block(), p, g))
        return ops

    def _create_accumulators(self, program, params):
        pass

    def _append_optimize_op(self, block, param, grad):
        raise NotImplementedError


class SGD(Optimizer):
    def _append_optimize_op(self, block, param, grad):
        return block.append_op(
            "sgd",
            {"Param": [param.name], "Grad": [grad.name],
             "LearningRate": [self._lr(param).name]},
            {"ParamOut": [param.name]})


class Momentum(Optimizer):
    def __init__(self, learning_rate, momentum, use_nesterov=False, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, program, params):
        for p in params:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param, grad):
        v = self._get_accumulator("velocity", param)
        return block.append_op(
            "momentum",
            {"Param": [param.name], "Grad": [grad.name],
             "Velocity": [v.name], "LearningRate": [self._lr(param).name]},
            {"ParamOut": [param.name], "VelocityOut": [v.name]},
            {"mu": self._momentum, "use_nesterov": self._use_nesterov})


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, program, params):
        for p in params:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow", p, shape=[1],
                                  fill_value=self._beta1)
            self._add_accumulator("beta2_pow", p, shape=[1],
                                  fill_value=self._beta2)

    def _append_optimize_op(self, block, param, grad):
        m1 = self._get_accumulator("moment1", param)
        m2 = self._get_accumulator("moment2", param)
        b1p = self._get_accumulator("beta1_pow", param)
        b2p = self._get_accumulator("beta2_pow", param)
        return block.append_op(
            "adam",
            {"Param": [param.name], "Grad": [grad.name],
             "Moment1": [m1.name], "Moment2": [m2.name],
             "Beta1Pow": [b1p.name], "Beta2Pow": [b2p.name],
             "LearningRate": [self._lr(param).name]},
            {"ParamOut": [param.name], "Moment1Out": [m1.name],
             "Moment2Out": [m2.name], "Beta1PowOut": [b1p.name],
             "Beta2PowOut": [b2p.name]},
            {"beta1": self._beta1, "beta2": self._beta2,
             "epsilon": self._epsilon})


# reference-compatible aliases
SGDOptimizer = SGD
MomentumOptimizer = Momentum
AdamOptimizer = Adam
