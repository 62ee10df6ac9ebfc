"""Cascaded-reduction rewrite: tag batch-norm backward ops for the kernel.

The JAX package's ``passes/reductions.py``. The training-mode batch-norm
backward needs four channel sums over the same ``[rows, C]`` activation
pair and then an elementwise dx over the pair again;
``kernels/bn_grad.py`` does all of it in one launch of a hand-written
CUDA kernel. This pass only TAGS the ops (``use_pallas_reduction`` /
``pallas_interpret`` attrs on ``batch_norm_grad``, the attr names the
JAX package serializes); the
lowering consults the attrs and keeps the plain two-pass form whenever
the kernel's preconditions fail.

``pallas_interpret`` records ``cfg.interpret``. With ``interpret=None``
the JAX package asks its backend; this package has no interpreter, the
kernel or its plain version is chosen by the tensor's device, so None
records False.

Ordering: runs AFTER the layout pass. The kernel reads the activation
as [rows, C] with channels minor, so only NHWC ops are tagged (an NCHW
program tags nothing).
"""

__all__ = ["run"]


def run(program, cfg, protected=()):
    interpret = bool(cfg.interpret)
    tagged = 0
    block = program.global_block()
    for op in block.ops:
        if op.type != "batch_norm_grad":
            continue
        if op.attrs.get("data_layout", "NCHW") != "NHWC":
            continue
        if op.attrs.get("is_test", False):
            continue
        names = op.inputs.get("X", [])
        v = block._find_var_recursive(names[0]) if names else None
        if v is None or v.shape is None or len(v.shape) != 4:
            continue
        op.attrs["use_pallas_reduction"] = True
        op.attrs["pallas_interpret"] = bool(interpret)
        tagged += 1
    if tagged:
        program._bump_version()
    return tagged
