"""Gradient clipping as program transforms.

Capability parity: `python/paddle/fluid/clip.py` (ErrorClipByValue :40,
GradientClipByValue :101, ByNorm :122, ByGlobalNorm :137,
append_gradient_clip_ops :215), as the JAX package's ``clip.py`` builds
it: ``clip`` and ``clip_by_norm`` per gradient, and one fused
``global_norm_clip`` op over a global-norm group.
"""

__all__ = ["GradientClipByValue", "GradientClipByNorm",
           "GradientClipByGlobalNorm", "ErrorClipByValue",
           "append_gradient_clip_ops", "set_gradient_clip"]

_global_clip = None


def set_gradient_clip(clip, param_list=None, program=None):
    global _global_clip
    _global_clip = clip
    if param_list:
        for p in param_list:
            p.gradient_clip_attr = clip


class BaseGradientClip:
    def create_operators(self, param, grad):
        raise NotImplementedError


class ErrorClipByValue:
    def __init__(self, max, min=None):
        self.max = max
        self.min = min if min is not None else -max


class GradientClipByValue(BaseGradientClip):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def create_operators(self, param, grad):
        block = grad.block
        out = block.create_var(name=grad.name + "@CLIP", shape=grad.shape,
                               dtype=grad.dtype)
        block.append_op("clip", {"X": [grad.name]}, {"Out": [out.name]},
                        {"min": self.min, "max": self.max})
        return param, out


class GradientClipByNorm(BaseGradientClip):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def create_operators(self, param, grad):
        block = grad.block
        out = block.create_var(name=grad.name + "@CLIP", shape=grad.shape,
                               dtype=grad.dtype)
        block.append_op("clip_by_norm", {"X": [grad.name]},
                        {"Out": [out.name]}, {"max_norm": self.clip_norm})
        return param, out


class GradientClipByGlobalNorm(BaseGradientClip):
    """Scale all grads by clip_norm / max(global_norm, clip_norm), as ONE
    fused ``global_norm_clip`` op over the whole gradient group: a
    single float32 sum-of-squares reduction instead of the reference's
    per-grad squared_l2_norm + sum + sqrt + div + per-grad mul chain.
    ``param_names`` records which parameters the norm covers (grad names
    change downstream, @CLIP and @REG; a parameter's name does not)."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def apply(self, params_grads):
        if not params_grads:
            return params_grads
        block = params_grads[0][1].block
        outs = []
        for _, g in params_grads:
            outs.append(block.create_var(name=g.name + "@CLIP",
                                         shape=g.shape, dtype=g.dtype))
        block.append_op("global_norm_clip",
                        {"X": [g.name for _, g in params_grads]},
                        {"Out": [v.name for v in outs]},
                        {"clip_norm": self.clip_norm,
                         "param_names": [p.name for p, _ in params_grads]})
        return [(p, v) for (p, _), v in zip(params_grads, outs)]


def append_gradient_clip_ops(params_grads):
    global_norm_clips = {}
    out = []
    for p, g in params_grads:
        clip = getattr(p, "gradient_clip_attr", None) or _global_clip
        if g is None or clip is None:
            out.append((p, g))
        elif isinstance(clip, GradientClipByGlobalNorm):
            global_norm_clips.setdefault(id(clip), (clip, []))[1].append((p, g))
        else:
            out.append(clip.create_operators(p, g))
    for clip, pgs in global_norm_clips.values():
        out.extend(clip.apply(pgs))
    return out
