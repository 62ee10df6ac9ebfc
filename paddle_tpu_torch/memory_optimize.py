"""DEPRECATED: the graph-transpile memory optimizer is dead code.

Capability history: the reference reused dead activation buffers at
graph-transpile time (`python/paddle/fluid/memory_optimization_transpiler
.py:43`). In the port, PyTorch's caching allocator reuses a freed
activation's memory as soon as its last reader is done, and
rematerialization belongs to the IR optimization-pass pipeline
(``paddle_tpu_torch/passes/``, ``passes.enable(program, remat=...)``),
where it composes with the layout and fusion rewrites. Recomputation is
also opted into at model-build time with ``layers.RecomputeRegion``.

Both entry points are no-op stubs, as in the JAX package: they warn,
touch nothing (no program mutation, no version bump, so no plan is
rebuilt), and return the program unchanged.
"""

import warnings

__all__ = ["memory_optimize", "release_memory"]


def memory_optimize(input_program, skip_opt_set=None, print_log=False,
                    level=0):
    """Deprecated no-op. Use ``layers.RecomputeRegion`` to mark
    recompute scopes, or the remat pass in ``paddle_tpu_torch/passes/``."""
    warnings.warn(
        "memory_optimize() is deprecated and does nothing: the caching "
        "allocator owns buffer reuse, and rematerialization lives in the "
        "paddle_tpu_torch/passes/ pipeline — mark recompute scopes with "
        "layers.RecomputeRegion instead", DeprecationWarning,
        stacklevel=2)
    return input_program


def release_memory(input_program, skip_opt_set=None):
    """Deprecated no-op: the caching allocator's reuse of freed
    activations subsumes the reference's buffer-reuse transpile."""
    warnings.warn(
        "release_memory() is deprecated and does nothing (the caching "
        "allocator's reuse of freed buffers subsumes it)",
        DeprecationWarning, stacklevel=2)
    return input_program
