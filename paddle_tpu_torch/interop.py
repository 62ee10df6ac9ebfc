"""Carry weights from the JAX package into this one.

The two packages build the same programs with the same parameter names,
but draw different random numbers from the same seed. To compare them
on the same weights, read the JAX package's scope into numpy arrays
(``{n: np.asarray(jax_scope.find_var(n))}``) and load them here with
:func:`load_reference_state`. Every persistable variable goes across
under its own name: parameters (convolution filters stay OIHW under
either layout), batch-norm running means and variances, optimizer
accumulators (Adam moments and beta powers, Momentum velocities) and
the learning-rate variable.
"""

import numpy as np
import torch

from paddle_tpu_torch.core.infer import torch_dtype

__all__ = ["load_reference_state"]


def load_reference_state(arrays, scope, place, programs):
    """Fill ``scope`` with ``arrays`` ({name: numpy array}) as tensors on
    ``place``.

    Every persistable variable of ``programs`` (one Program or a list)
    must be in ``arrays`` with the shape and dtype the program declares,
    and every array must name one of them; anything else raises before
    the scope is touched. Returns the list of names loaded."""
    if not isinstance(programs, (list, tuple)):
        programs = [programs]
    want = {}
    for prog in programs:
        for v in prog.list_vars():
            if v.persistable:
                want[v.name] = v
    unknown = sorted(set(arrays) - set(want))
    missing = sorted(set(want) - set(arrays))
    if unknown or missing:
        raise ValueError("reference state does not match the programs: "
                         "unknown %s, missing %s" % (unknown, missing))
    tensors = {}
    for n, var in want.items():
        a = np.asarray(arrays[n])
        if tuple(a.shape) != tuple(var.shape):
            raise ValueError("%r: array shape %s, program declares %s"
                             % (n, tuple(a.shape), tuple(var.shape)))
        if a.dtype.name != var.dtype:
            raise ValueError("%r: array dtype %s, program declares %s"
                             % (n, a.dtype.name, var.dtype))
        tensors[n] = torch.tensor(a, dtype=torch_dtype(var.dtype))
    device = place.torch_device()
    for n, t in tensors.items():
        scope.set_var(n, t.to(device))
    return sorted(tensors)
