"""Kernel-parameter pass: pin tuned kernel knobs as op attrs.

The JAX package's ``passes/kernels.py``: ``PassConfig.kernel_params``
(canonical ``(op_type, param, value)`` triples, part of the config's
key) land as attrs on the matching ops, and the lowerings consult the
attrs:

* ``("batch_norm_grad", "tile", T)``: the batch-norm backward's row
  tile (``pallas_tile`` attr, the name the JAX package serializes);
  applied only to ops the reduction pass TAGGED
  (``use_pallas_reduction``). The CUDA kernel picks its own blocking
  and ignores the value; the plain version blocks its rows by it.

This is the one knob a lowering of this package reads. Unknown
(op_type, param) pairs are no-ops by design: a record tuned for a
richer kernel set stays APPLICABLE (0 rewrites, not an error).
"""

__all__ = ["run"]

# the knobs each op type accepts (and the attr each one lands on)
_KNOBS = {
    "batch_norm_grad": {"tile": "pallas_tile"},
}


def run(program, cfg, protected=()):
    by_type = {}
    for op_type, param, value in cfg.kernel_params:
        by_type.setdefault(op_type, []).append((param, value))
    applied = 0
    for op in program.global_block().ops:
        todo = by_type.get(op.type)
        if not todo:
            continue
        known = _KNOBS.get(op.type, {})
        for param, value in todo:
            attr = known.get(param)
            if attr is None:
                continue
            # a tile only matters on an op the reduction pass tagged
            if not op.attrs.get("use_pallas_reduction"):
                continue
            op.attrs[attr] = int(value)
            applied += 1
    if applied:
        program._bump_version()
    return applied
