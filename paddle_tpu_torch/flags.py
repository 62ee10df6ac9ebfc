"""Global flag registry with environment bootstrap.

Capability parity: the reference's gflags-based configuration
(`paddle/utils/Flags.cpp:18-88`), as the JAX package's ``flags.py``
keeps it. Flags are read from the environment ONCE at import (variables
named ``FLAGS_*``, e.g. ``FLAGS_fused_conv1x1_bwd=1``) and can be
changed at runtime with ``fluid.flags.set_flags({...})``. This package
holds only the flags it reads; setting one has no side effect beyond the
registry.
"""

import os

__all__ = ["set_flags", "get_flags"]

_DEFAULTS = {
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
            _flags[name] = _coerce(default, raw)


def set_flags(flags):
    """``set_flags({"FLAGS_fused_conv1x1_bwd": True})``"""
    for name, value in flags.items():
        if name not in _flags:
            raise KeyError("unknown flag %r (known: %s)"
                           % (name, sorted(_flags)))
        _flags[name] = value


def get_flags(names=None):
    if names is None:
        return dict(_flags)
    if isinstance(names, str):
        names = [names]
    return {n: _flags[n] for n in names}


_bootstrap()
