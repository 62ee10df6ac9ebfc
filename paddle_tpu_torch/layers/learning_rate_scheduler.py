"""Learning-rate schedulers as in-program ops.

Capability parity: `python/paddle/fluid/layers/learning_rate_scheduler.py`
(exponential/natural_exp/inverse_time/polynomial/piecewise decay +
noam), as the JAX package's ``layers/learning_rate_scheduler.py``
builds them. Each returns a Variable recomputed every step from the
global step counter, a persistable that an ``increment`` op in the
program advances: the schedule is device work inside the step, so a
replayed CUDA graph (``Executor.run_chunk``) reads a new rate at every
replay.
"""

import math

from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.layers import control_flow, nn, tensor

__all__ = ["exponential_decay", "natural_exp_decay", "inverse_time_decay",
           "polynomial_decay", "piecewise_decay", "noam_decay",
           "cosine_decay", "linear_lr_warmup"]


def _global_step():
    counter = nn.autoincreased_step_counter(
        counter_name="@LR_DECAY_COUNTER@", begin=0, step=1)
    return tensor.cast(counter, "float32")


def noam_decay(d_model, warmup_steps):
    step = _global_step()
    a = nn.pow(step, -0.5)
    b = nn.scale(step, scale=warmup_steps ** -1.5)
    helper = LayerHelper("noam_min")
    lr = helper.create_variable_for_type_inference("float32")
    helper.append_op("elementwise_min", {"X": [a], "Y": [b]},
                     {"Out": [lr]}, {"axis": -1})
    return nn.scale(lr, scale=d_model ** -0.5)


def _pow_const(base, exponent_var):
    """base ** x = exp(x * ln(base)) as program ops."""
    return nn.exp(nn.scale(exponent_var, scale=math.log(base)))


def _decay_steps(step, decay_steps, staircase):
    div = nn.scale(step, scale=1.0 / decay_steps)
    return nn.floor(div) if staircase else div


def exponential_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    div = _decay_steps(_global_step(), decay_steps, staircase)
    return nn.scale(_pow_const(decay_rate, div), scale=learning_rate)


def natural_exp_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    div = _decay_steps(_global_step(), decay_steps, staircase)
    return nn.scale(nn.exp(nn.scale(div, scale=-decay_rate)),
                    scale=learning_rate)


def inverse_time_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    div = _decay_steps(_global_step(), decay_steps, staircase)
    denom = nn.scale(div, scale=decay_rate, bias=1.0)
    lr = tensor.fill_constant([1], "float32", learning_rate)
    return nn.elementwise_div(lr, denom)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    step = _global_step()
    frac = nn.clip(nn.scale(step, scale=1.0 / decay_steps), 0.0, 1.0)
    return nn.scale(
        nn.pow(nn.scale(frac, scale=-1.0, bias=1.0), factor=power),
        scale=learning_rate - end_learning_rate, bias=end_learning_rate)


def piecewise_decay(boundaries, values):
    """lr = values[i] for step in [boundaries[i-1], boundaries[i])."""
    step = _global_step()
    lr = tensor.fill_constant([1], "float32", values[-1])
    # built from the last interval backwards with where-selects
    for b, v in zip(reversed(boundaries), reversed(values[:-1])):
        bound = tensor.fill_constant([1], "float32", float(b))
        cond = control_flow.less_than(step, bound)
        vv = tensor.fill_constant([1], "float32", v)
        lr = nn.where(cond, vv, lr)
    return lr


def cosine_decay(learning_rate, step_each_epoch, epochs):
    step = _global_step()
    frac = nn.clip(nn.scale(step, scale=1.0 / (step_each_epoch * epochs)),
                   0.0, 1.0)
    # 0.5 * lr * (1 + cos(pi * frac))
    helper = LayerHelper("cos")
    c = helper.create_variable_for_type_inference("float32")
    helper.append_op("cos", {"X": [nn.scale(frac, scale=math.pi)]},
                     {"Out": [c]})
    return nn.scale(c, scale=0.5 * learning_rate, bias=0.5 * learning_rate,
                    bias_after_scale=True)


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    step = _global_step()
    frac = nn.clip(nn.scale(step, scale=1.0 / warmup_steps), 0.0, 1.0)
    warm = nn.scale(frac, scale=end_lr - start_lr, bias=start_lr)
    bound = tensor.fill_constant([1], "float32", float(warmup_steps))
    cond = control_flow.less_than(step, bound)
    if not isinstance(learning_rate, type(warm)):
        learning_rate = tensor.fill_constant([1], "float32",
                                             float(learning_rate))
    return nn.where(cond, warm, learning_rate)
