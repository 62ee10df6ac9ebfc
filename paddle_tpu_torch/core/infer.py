"""Construction-time shape/dtype inference on meta tensors.

The JAX package derives each op's output shapes by running its lowering
under ``jax.eval_shape``. This package runs the same lowering on
``torch.device("meta")`` tensors, which carry shape and dtype and no
data, so inference and execution share one source of truth.

Unknown (batch/time) dims are encoded as -1 in ``Variable.shape`` and
substituted with prime sentinels during the meta run, then mapped back
(the sentinels and the mapping are the JAX package's).

Output dtypes are recorded as JAX records them with 64-bit types off:
int64 becomes int32 and float64 becomes float32. So a program built by
either package serializes to the same JSON (e.g. ``position_ids`` out is
int32, an int64 ``tokens`` feed stays int64 because data vars are
declared, not inferred).
"""

import logging

import torch

from paddle_tpu_torch.core import registry
from paddle_tpu_torch.core.ir import VarType
from paddle_tpu_torch.core.lower import PackedSeq, TraceContext

log = logging.getLogger(__name__)

_BATCH = 1223   # sentinel for unknown batch dim
_TIME = 1031    # sentinel for unknown time (sequence) dim
_META = torch.device("meta")

# JAX with x64 off records 64-bit results as their 32-bit types
_CANONICAL = {"int64": "int32", "uint64": "uint32", "float64": "float32",
              "complex128": "complex64"}


def _sub(shape):
    out = []
    unknowns = iter((_BATCH, _TIME, 919, 883, 857))
    for d in shape:
        out.append(next(unknowns, 811) if d == -1 else int(d))
    return tuple(out)


def _unsub(shape):
    sentinels = (_BATCH, _TIME, 919, 883, 857, 811)
    out = []
    for d in shape:
        d = int(d)
        if d in sentinels or any(s != 1 and d % s == 0 and d // s < 64
                                 for s in sentinels[:2] if d >= s):
            out.append(-1)
        else:
            out.append(d)
    return tuple(out)


def torch_dtype(name):
    """numpy dtype name (as ``Variable.dtype`` stores it) -> torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise TypeError("no torch dtype for %r" % name)
    return dt


def dtype_name(dtype):
    """torch dtype -> the numpy name ``Variable.dtype`` stores."""
    return str(dtype).replace("torch.", "")


def abstract_value(var):
    if var.shape is None:
        raise ValueError("variable %r has no shape for inference" % var.name)
    shape = _sub(var.shape)
    data = torch.empty(shape, dtype=torch_dtype(var.dtype), device=_META)
    if var.type == VarType.PACKED_SEQ or var.lod_level > 0:
        return PackedSeq(data, torch.empty((shape[0],), dtype=torch.int32,
                                           device=_META))
    return data


def infer_op_shapes(block, op):
    """Set shapes/dtypes of op's output Variables by running its lowering
    on meta tensors. Best-effort: ops whose lowering cannot run on
    shapes alone raise, and the declared shapes are kept."""
    spec = registry.REGISTRY.get(op.type)
    if spec is None:
        return
    try:
        ins = {slot: [abstract_value(block.var(n)) for n in names]
               for slot, names in op.inputs.items()}
    except (KeyError, ValueError, TypeError, NotImplementedError):
        return
    ctx = TraceContext(device=_META, training=True)
    try:
        out = registry.normalize_outputs(
            spec.lower(ctx.for_op(op), ins, op.attrs, op))
    except Exception as e:  # any lowering error: keep the declared shapes
        log.debug("shape inference failed for op %s: %s", op.type, e)
        return

    for slot, names in op.outputs.items():
        if slot not in out:
            continue
        for n, val in zip(names, out[slot]):
            if not n:
                continue
            var = block.var(n)
            if isinstance(val, PackedSeq):
                var.type = VarType.PACKED_SEQ
                var.lod_level = max(var.lod_level, 1)
                val = val.data
            elif not isinstance(val, torch.Tensor):
                continue
            var.shape = _unsub(val.shape)
            name = dtype_name(val.dtype)
            var.dtype = _CANONICAL.get(name, name)
