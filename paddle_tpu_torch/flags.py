"""Global flag registry with environment bootstrap.

Capability parity: the reference's gflags-based configuration
(`paddle/utils/Flags.cpp:18-88`), as the JAX package's ``flags.py``
keeps it. Flags are read from the environment ONCE at import (variables
named ``FLAGS_*``, e.g. ``FLAGS_fused_conv1x1_bwd=1``) and can be
changed at runtime with ``fluid.flags.set_flags({...})``. This package
holds only the flags it reads; ``FLAGS_check_nan_inf`` is routed to
``core/debug.py`` as the JAX package routes it, the others live in the
registry alone.
"""

import os

__all__ = ["set_flags", "get_flags", "set_check_nan_inf"]

_DEFAULTS = {
    # the per-op NaN/Inf guard (core/debug.py): every float output of
    # every op is checked on the device, and the executor raises after
    # the step naming the first op that made a NaN or an Inf. Part of
    # the executor's plan key (a flip is one named plan miss)
    "FLAGS_check_nan_inf": False,
    # static IR verification + shape/dtype inference
    # (paddle_tpu_torch/analysis) on every plan MISS: after each
    # pipeline pass, and on the final program (with the feed signature)
    # in Executor._plan. Default ON, as in the JAX package: the cost is
    # pure-Python O(ops) per plan, zero on plan hits, and the flag is
    # deliberately NEVER part of a plan key or recompile-detector
    # signature (flipping it cannot build a plan or capture a graph)
    "FLAGS_verify_ir": True,
    # fused dx+dw backward for 1x1 convolutions: one CUDA kernel that
    # shares the dy read between both outputs (kernels/conv1x1_bwd.py).
    # Off by default, as in the JAX package: conv2d then differentiates
    # through the library's two backward convolutions.
    "FLAGS_fused_conv1x1_bwd": False,
}

_flags = dict(_DEFAULTS)


def _coerce(default, raw):
    if isinstance(default, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    return type(default)(raw)


def _bootstrap():
    for name, default in _DEFAULTS.items():
        raw = os.environ.get(name)
        if raw is not None:
            _apply(name, _coerce(default, raw))


def _apply(name, value):
    _flags[name] = value
    if name == "FLAGS_check_nan_inf":
        from paddle_tpu_torch.core import debug
        debug.set_check_nan_inf(value)


def set_check_nan_inf(enabled):
    """Convenience for the most-used flag; keeps the registry and the
    debug module in sync (single source of truth is the registry)."""
    set_flags({"FLAGS_check_nan_inf": bool(enabled)})


def set_flags(flags):
    """``set_flags({"FLAGS_fused_conv1x1_bwd": True})``"""
    for name, value in flags.items():
        if name not in _flags:
            raise KeyError("unknown flag %r (known: %s)"
                           % (name, sorted(_flags)))
        _apply(name, value)


def get_flags(names=None):
    if names is None:
        return dict(_flags)
    if isinstance(names, str):
        names = [names]
    return {n: _flags[n] for n in names}


_bootstrap()
