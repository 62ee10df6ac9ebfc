"""Gradient clipping as a program transform.

Capability parity: `python/paddle/fluid/clip.py`
(append_gradient_clip_ops :215). This slice carries what the optimizer
calls: with no clip on any parameter (the training path's case) the
pass leaves every gradient as it is. The clip classes, their ops and
``set_gradient_clip`` arrive with a later slice; a clip set through a
ParamAttr raises instead of being ignored.
"""

__all__ = ["append_gradient_clip_ops"]


def append_gradient_clip_ops(params_grads):
    for p, g in params_grads:
        clip = getattr(p, "gradient_clip_attr", None)
        if g is not None and clip is not None:
            raise NotImplementedError(
                "gradient clip %r on %r: clipping arrives with a later "
                "slice" % (clip, p.name))
    return list(params_grads)
