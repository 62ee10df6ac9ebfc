"""IR optimization-pass pipeline: program -> program rewrites.

The JAX package's ``passes`` package, with its config, its fixed order
and its rewrites, so a transformed program serializes to the same JSON
in both packages. The executor applies the pipeline to a CLONE of the
program and keeps the clone (``core.executor``), never on every step:

* ``layout``: whole-program NHWC conversion with transpose elimination,
  forward AND backward ops (``passes/layout.py``).
* ``reductions``: tags every NHWC training-mode ``batch_norm_grad`` for
  the hand-written batch-norm backward kernel (``kernels/bn_grad.py``).
* ``kernels``: pins ``kernel_params`` knobs as op attrs.

``epilogue_fusion`` (the ``conv2d_bn_act`` fold) and ``remat`` are part
of the config and its key, as in the JAX package, but their passes
arrive with later slices: :func:`apply` raises ``NotImplementedError``
for a config that asks for them. The JAX package's telemetry and
IR-verifier hooks around each pass arrive with those modules.

The pipeline is configured per program (``passes.enable(program, ...)``)
and never mutates the user's program: flipping the config selects
another kept clone. With no config a program runs as it is.
"""

from paddle_tpu_torch.passes import kernels as _kernels
from paddle_tpu_torch.passes import layout as _layout
from paddle_tpu_torch.passes import reductions as _reductions

__all__ = ["PassConfig", "enable", "disable", "plan_for", "apply",
           "PIPELINE"]


class PassConfig:
    """Which passes run for a program, in the pipeline's fixed order.

    ``layout``: ``"NHWC"`` or None. ``feed_layout``: the layout the
    feeder supplies 4-D data vars in (``"NHWC"`` re-declares them at
    enable time, so there is no input transpose; ``"NCHW"`` keeps the
    feed contract and the pass inserts one head transpose per image
    input). ``epilogue_fusion`` / ``pallas_reductions``: booleans.
    ``remat``: None (off), ``"blocks"``, ``"sqrt"`` or an int segment
    count. ``interpret``: recorded on tagged ops as the JAX package
    records it; this package picks a kernel or its plain version by the
    tensor's device, not by this flag.
    """

    __slots__ = ("layout", "feed_layout", "epilogue_fusion",
                 "pallas_reductions", "remat", "interpret",
                 "kernel_params")

    def __init__(self, layout=None, feed_layout="NHWC",
                 epilogue_fusion=False, pallas_reductions=False,
                 remat=None, interpret=None, kernel_params=None):
        if layout not in (None, "NHWC"):
            raise ValueError("PassConfig.layout must be None or 'NHWC', "
                             "got %r" % (layout,))
        if feed_layout not in ("NHWC", "NCHW"):
            raise ValueError("feed_layout must be 'NHWC' or 'NCHW'")
        if not (remat is None or remat in (True, "auto", "blocks", "sqrt")
                or (isinstance(remat, int) and not isinstance(remat, bool)
                    and remat >= 1)):
            raise ValueError(
                "PassConfig.remat must be None, 'blocks', 'sqrt', or a "
                "segment count >= 1, got %r" % (remat,))
        self.layout = layout
        self.feed_layout = feed_layout
        self.epilogue_fusion = bool(epilogue_fusion)
        self.pallas_reductions = bool(pallas_reductions)
        self.remat = remat
        self.interpret = interpret
        self.kernel_params = _canon_kernel_params(kernel_params)

    @property
    def key(self):
        """Hashable identity: part of the key under which the executor
        keeps a transformed clone."""
        return (self.layout, self.feed_layout, self.epilogue_fusion,
                self.pallas_reductions, self.remat, self.interpret,
                self.kernel_params)

    def __repr__(self):
        extra = ", kernel_params=%r" % (self.kernel_params,) \
            if self.kernel_params else ""
        return "PassConfig(layout=%r, epilogue_fusion=%r, " \
               "pallas_reductions=%r, remat=%r%s)" % (
                   self.layout, self.epilogue_fusion,
                   self.pallas_reductions, self.remat, extra)


def _canon_kernel_params(params):
    """Canonical kernel-parameter form: a sorted tuple of
    ``(op_type, param, value)`` triples (per-kernel tile/block knobs,
    applied as op attrs by passes/kernels.py)."""
    if not params:
        return ()
    out = []
    for item in params:
        if (not isinstance(item, (tuple, list)) or len(item) != 3
                or not isinstance(item[0], str)
                or not isinstance(item[1], str)
                or not isinstance(item[2], int)
                or isinstance(item[2], bool)):
            raise ValueError(
                "kernel_params must be (op_type, param, value) triples "
                "with an integer value (tiles/blocks are counts), "
                "got %r" % (item,))
        out.append((item[0], item[1], int(item[2])))
    return tuple(sorted(out))


# the ordered pipeline: (name, enabled_fn, module or None). Order matters
# and is fixed: the reduction pass only tags NHWC ops, so layout must
# have run first; kernel parameters land only on tagged ops. A None
# module is a pass of the JAX package that this package does not carry
# yet.
PIPELINE = (
    ("layout", lambda c: c.layout == "NHWC", _layout),
    ("epilogue", lambda c: c.epilogue_fusion, None),
    ("reductions", lambda c: c.pallas_reductions, _reductions),
    ("kernels", lambda c: bool(c.kernel_params), _kernels),
    ("remat", lambda c: bool(c.remat), None),
)


def enable(program, layout=None, feed_layout="NHWC", epilogue_fusion=False,
           pallas_reductions=False, remat=None, interpret=None,
           kernel_params=None):
    """Attach a pass-pipeline config to ``program``.

    Build-time effect is limited to the feed contract: under
    ``layout="NHWC"`` with ``feed_layout="NHWC"`` every 4-D data var is
    re-declared NHWC immediately (the user then supplies channels-last
    batches). All op rewriting happens on a clone when the executor
    first runs the program; the program itself stays inspectable and
    serializable in its original form.
    """
    cfg = PassConfig(layout=layout, feed_layout=feed_layout,
                     epilogue_fusion=epilogue_fusion,
                     pallas_reductions=pallas_reductions,
                     remat=remat, interpret=interpret,
                     kernel_params=kernel_params)
    if cfg.layout == "NHWC" and cfg.feed_layout == "NHWC":
        _layout.redeclare_feeds(program)
    program.passes = cfg
    return program


def disable(program):
    program.passes = None
    return program


def plan_for(program):
    """The program's PassConfig, or None (passes off)."""
    cfg = getattr(program, "passes", None)
    if cfg is not None and not isinstance(cfg, PassConfig):
        raise TypeError("program.passes must be a PassConfig, got %r"
                        % (cfg,))
    return cfg


def apply(program, protected=()):
    """Run the configured pipeline over a clone of ``program``; returns
    ``(transformed_program, report)``.

    ``protected`` names (the executor's fetch list) are never removed or
    re-bound by a rewrite. ``report`` maps pass name -> rewrite count
    for every pass that ran (0 = ran, found nothing).
    """
    cfg = plan_for(program)
    if cfg is None:
        return program, {}
    for name, enabled, mod in PIPELINE:
        if mod is None and enabled(cfg):
            raise NotImplementedError(
                "the %r pass arrives with a later slice; %r asks for it"
                % (name, cfg))
    out = program.clone()
    out.passes = cfg
    protected = frozenset(protected)
    report = {}
    for name, enabled, mod in PIPELINE:
        if enabled(cfg):
            report[name] = int(mod.run(out, cfg, protected))
    return out, report
