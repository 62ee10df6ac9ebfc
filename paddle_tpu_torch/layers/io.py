"""IO layers: data declaration.

Capability parity: `python/paddle/fluid/layers/io.py` (data). A
``lod_level > 0`` var is a packed sequence, [batch, time, ...]; feed it
a ragged list (one array per sequence) or a ``PackedSeq``. ``type`` is
accepted and unused, as in the JAX package.
"""

from paddle_tpu_torch.core import ir

__all__ = ["data"]


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         stop_gradient=True, type=None):
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    if lod_level > 0:
        # packed sequence: [batch, time, ...]; a bare feature shape gets the
        # time axis inserted after batch
        if len(shape) < 2 or shape[1] != -1:
            shape = [shape[0], -1] + shape[1:]
    block = ir.default_main_program().current_block()
    return block.create_var(
        name=name, shape=shape, dtype=dtype, lod_level=lod_level,
        is_data=True, stop_gradient=stop_gradient,
        type=ir.VarType.PACKED_SEQ if lod_level > 0 else ir.VarType.DENSE)
