"""NHWC layout mode: rewrite an image program's data layout in place.

The whole-program machinery lives in ``passes/layout.py`` as a pass of
the IR pipeline (``passes.enable(program, layout="NHWC")``), which
covers the backward program too and runs transpose elimination. This
module keeps the user-invoked form, as the JAX package's
``layout_transpiler.py`` does: rewrite a program (forward, or with its
backward) in place, at build time, through the same pass — the
reference's `data_layout_transform.cc` stage, where kernels declare an
expected layout and the framework inserts NCHW<->NHWC transposes
between them.

Filters stay logically OIHW in either form (optimizer state,
checkpoints and the save/load format are unchanged).
"""

from paddle_tpu_torch.passes import layout as _layout_pass

__all__ = ["LayoutTranspiler"]


class LayoutTranspiler:
    """Rewrite a program to NHWC in place (build-time form).

    Works on forward programs (the classic pre-``append_backward`` use:
    grads then inherit the layout through the generic grad) and on full
    programs (grad ops are mirrored like the pipeline's pass does).
    """

    def transpile(self, program, feed_layout="NHWC"):
        if feed_layout == "NHWC":
            _layout_pass.redeclare_feeds(program)

        class _Cfg:
            pass

        cfg = _Cfg()
        cfg.feed_layout = feed_layout
        # Build-time form has no fetch list: any pre-existing var may be
        # fetched later, so protect them all from the dead-transpose
        # sweep (pass-inserted vars stay eligible for cancellation).
        protected = set()
        for blk in program.blocks:
            protected.update(blk.vars)
        _layout_pass.run(program, cfg, protected=frozenset(protected))
        return program
