"""RecomputeRegion: mark an op range for backward-pass recomputation.

The user-facing half of the remat policy, as the JAX package builds it
(the reference's memory_optimization_transpiler.py:43 reuses buffers at
transpile time; the lever here is trading FLOPs for activation memory).
The region becomes one ``recompute`` op over a sub-block
(``ops/control_flow_ops.py``): its forward keeps none of the region's
intermediate activations, and its grad re-runs the region from its
inputs under autograd. Typical use: wrap each transformer block so the
backward pass re-runs the block from its input instead of storing every
intermediate activation:

    rr = layers.RecomputeRegion()
    with rr.scope():
        h = decoder_block(rr.input(x), ...)
        rr.output(h)
    x = rr()
"""

import contextlib

from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["RecomputeRegion"]


class RecomputeRegion:
    def __init__(self, name=None):
        self.helper = LayerHelper("recompute", name=name)
        self.sub_block = None
        self.parent_block = None
        self._ins = []    # (outer var, inner var)
        self._outs = []   # inner vars
        self.out_vars = []

    @contextlib.contextmanager
    def scope(self):
        prog = self.helper.main_program
        self.parent_block = prog.current_block()
        self.sub_block = prog.create_block()
        try:
            yield
        except BaseException:
            prog.rollback()
            raise
        prog.rollback()
        self._complete()

    def input(self, x):
        """Bind an outer var as a region input; returns the inner view."""
        inner = self.sub_block.create_var(
            name=self.helper.name + ".in_%d" % len(self._ins),
            shape=x.shape, dtype=x.dtype, lod_level=x.lod_level)
        self._ins.append((x, inner))
        return inner

    def output(self, *outs):
        self._outs.extend(outs)

    def _complete(self):
        assert self._outs, "RecomputeRegion needs at least one output"
        sub, parent = self.sub_block, self.parent_block
        in_names = {i.name for _, i in self._ins}
        # free reads (params etc.) become explicit inputs so the vjp
        # reaches them
        free, produced = [], set()
        for op_ in sub.ops:
            for n in op_.input_arg_names:
                if (n in in_names or n in produced or n in free
                        or sub.has_var_local(n)):
                    continue
                free.append(n)
            produced.update(op_.output_arg_names)

        # stateful writes to OUTER persistable vars (batch_norm running
        # mean/variance etc.) must surface as op outputs: the executor's
        # write-back set only sees block-0 op outputs, so without this
        # the region would silently freeze BN stats at their init values
        def _outer_persistable(n):
            b = parent
            while b is not None:
                if b.has_var_local(n):
                    return b.vars[n].persistable
                b = b.parent_block
            return False

        stateful = []
        for op_ in sub.ops:
            for n in op_.output_arg_names:
                if (n not in stateful and not sub.has_var_local(n)
                        and _outer_persistable(n)):
                    stateful.append(n)

        outs = [parent.create_var(
            name=self.helper.name + ".out_%d" % i, shape=o.shape,
            dtype=o.dtype, lod_level=o.lod_level)
            for i, o in enumerate(self._outs)]
        self.helper.append_op(
            "recompute",
            {"X": [x.name for x, _ in self._ins], "Params": free},
            {"Out": [o.name for o in outs], "StatefulOut": stateful},
            {"sub_block_id": sub.idx,
             "in_names": [i.name for _, i in self._ins],
             "out_names": [o.name for o in self._outs],
             "param_names": free,
             "stateful_names": stateful})
        self.out_vars = outs

    def __call__(self):
        return self.out_vars[0] if len(self.out_vars) == 1 \
            else self.out_vars
