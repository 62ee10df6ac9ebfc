"""Pipeline DSL: declare a repeated stage once, train it as a pipeline.

Capability parity: the reference's per-layer device placement
(`ParallelNeuralNetwork.h:34`) and the JAX package's
``layers/pipeline.py``. The stage body is a sub-block (like StaticRNN's
step); every parameter created inside it becomes an [S]-stacked array
sharded over the 'pp' mesh axis, so under ``ParallelExecutor`` each rank
holds exactly 1/S of the pipeline's parameters and runs one stage of the
schedule (``parallel.pipeline``: GPipe or 1F1B). Under the serial
``Executor`` the same program runs the stages as a loop — identical
math.

    pipe = layers.Pipeline(num_stages=4, num_micro=8)
    with pipe.stage():
        h = pipe.input(x)            # boundary activation in
        h = layers.fc(h, 256, act="relu")   # params auto-stacked [4, ...]
        pipe.output(h)               # boundary activation out
    y = pipe()                       # [B, ...] from the last stage
"""

import contextlib

from paddle_tpu_torch import layer_helper
from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["Pipeline"]


class Pipeline:
    def __init__(self, num_stages, num_micro=None, name=None,
                 schedule=None):
        self.helper = LayerHelper("pipeline", name=name)
        self.num_stages = int(num_stages)
        self.num_micro = int(num_micro or num_stages)
        assert self.num_micro % self.num_stages == 0, (
            "num_micro must be a multiple of num_stages",
            self.num_micro, self.num_stages)
        self.schedule = schedule or "gpipe"
        if self.schedule not in ("gpipe", "1f1b"):
            raise ValueError(
                "pipeline schedule must be 'gpipe' or '1f1b', got %r"
                % (schedule,))
        self.sub_block = None
        self.parent_block = None
        self._ctx = None
        self._in = None       # (outer var, inner var)
        self._out = None      # inner var
        self.out_var = None

    @contextlib.contextmanager
    def stage(self):
        prog = self.helper.main_program
        self.parent_block = prog.current_block()
        self.sub_block = prog.create_block()
        self._ctx = {"stages": self.num_stages, "sub_block": self.sub_block,
                     "params": []}
        layer_helper.PIPELINE_PARAM_CTX.append(self._ctx)
        try:
            yield
        except BaseException:
            # surface the stage body's own error; don't append a pipeline
            # op to a half-built program
            layer_helper.PIPELINE_PARAM_CTX.pop()
            prog.rollback()
            raise
        layer_helper.PIPELINE_PARAM_CTX.pop()
        prog.rollback()
        self._complete()

    def input(self, x):
        """Bind the pipeline's boundary input; returns the stage-local
        view. The stage body must map it to a SAME-shaped output."""
        assert self._in is None, "pipeline takes exactly one input"
        inner = self.sub_block.create_var(
            name=self.helper.name + ".act_in", shape=x.shape, dtype=x.dtype)
        self._in = (x, inner)
        return inner

    def output(self, o):
        assert self._out is None, "pipeline emits exactly one output"
        assert tuple(o.shape) == tuple(self._in[1].shape), (
            "stage output shape %s must match input shape %s (uniform "
            "boundary activation)" % (o.shape, self._in[1].shape))
        self._out = o

    def _complete(self):
        assert self._in is not None and self._out is not None
        sub, parent = self.sub_block, self.parent_block
        pnames = self._ctx["params"]
        # non-param outer values read by the body (e.g. constants built
        # outside the region)
        skip = set(pnames) | {self._in[1].name}
        produced, cnames = set(), []
        for op_ in sub.ops:
            for n in op_.input_arg_names:
                if (n in skip or n in produced or n in cnames
                        or sub.has_var_local(n)):
                    continue
                cnames.append(n)
            produced.update(op_.output_arg_names)

        out = parent.create_var(
            name=self.helper.name + ".out",
            shape=self._in[0].shape, dtype=self._out.dtype)
        self.helper.append_op(
            "pipeline",
            {"X": [self._in[0].name], "Params": list(pnames),
             "Consts": cnames},
            {"Out": [out.name]},
            {"sub_block_id": sub.idx,
             "in_name": self._in[1].name,
             "out_name": self._out.name,
             "num_stages": self.num_stages,
             "num_micro": self.num_micro,
             "schedule": self.schedule,
             "param_names": list(pnames),
             "const_names": cnames})
        self.out_var = out

    def __call__(self):
        return self.out_var
