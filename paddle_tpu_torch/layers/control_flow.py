"""Control-flow DSL: StaticRNN.

Capability parity: `python/paddle/fluid/layers/control_flow.py`
(StaticRNN :382), as the JAX package builds it: the step body is a
sub-block, and the RNN is one differentiable ``scan_block`` op in the
parent block (``ops/control_flow_ops.py``) instead of the reference's
recurrent op and its hand-written grad. ``increment`` and
``less_than`` are here for the learning-rate schedulers. ``While``,
``DynamicRNN`` and the tensor-array layers arrive with the decode
slice.
"""

import contextlib

from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["StaticRNN", "increment", "less_than"]


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("increment", {"X": [x]}, {"Out": [out]}, {"step": value})
    return out


def less_than(x, y, cond=None):
    helper = LayerHelper("less_than")
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool")
    helper.append_op("less_than", {"X": [x], "Y": [y]}, {"Out": [cond]})
    return cond


class StaticRNN:
    """Step-wise RNN over aligned sequences; compiles to one scan_block
    op whose sub-block is the step body."""

    def __init__(self, name=None, is_reverse=False):
        self.helper = LayerHelper("static_rnn", name=name)
        self.is_reverse = is_reverse
        self.seq_inputs = []      # (outer var, inner var)
        self.memories = []        # dicts: init (outer), pre (inner), post name
        self.outputs = []         # inner vars
        self.out_vars = []        # outer result vars
        self.sub_block = None
        self.parent_block = None
        self.status = "init"

    @contextlib.contextmanager
    def step(self):
        prog = self.helper.main_program
        self.parent_block = prog.current_block()
        self.sub_block = prog.create_block()
        self.status = "in_step"
        try:
            yield
        finally:
            self.status = "done"
            prog.rollback()
            self._complete()

    def _in_step(self, what):
        if self.status != "in_step":
            raise ValueError("StaticRNN.%s is only valid inside "
                             "`with rnn.step():`" % what)

    def step_input(self, x):
        self._in_step("step_input")
        inner = self.sub_block.create_var(
            name=self.helper.name + ".x_%d" % len(self.seq_inputs),
            shape=(x.shape[0],) + tuple(x.shape[2:]) if x.shape else None,
            dtype=x.dtype)
        self.seq_inputs.append((x, inner))
        return inner

    def memory(self, init=None, shape=None, batch_ref=None, init_value=0.0,
               init_batch_dim_idx=0, ref_batch_dim_idx=0):
        self._in_step("memory")
        if init is None:
            raise NotImplementedError(
                "StaticRNN.memory(init=None): a memory filled from "
                "batch_ref (fill_constant_batch_size_like) arrives with a "
                "later slice; pass init=")
        pre = self.sub_block.create_var(
            name=self.helper.name + ".mem_%d" % len(self.memories),
            shape=init.shape, dtype=init.dtype)
        self.memories.append({"init": init, "pre": pre, "post": None})
        return pre

    def update_memory(self, mem, var):
        for m in self.memories:
            if m["pre"].name == mem.name:
                m["post"] = var.name
                return
        raise ValueError("unknown memory %r" % mem.name)

    def step_output(self, o):
        self._in_step("step_output")
        self.outputs.append(o)

    def _complete(self):
        sub = self.sub_block
        parent = self.parent_block
        x_names = [i.name for _, i in self.seq_inputs]
        state_in = [m["pre"].name for m in self.memories]
        # params: outer vars read by sub-block ops
        param_names = []
        seen = set(x_names) | set(state_in)
        produced = set()
        for op in sub.ops:
            for n in op.input_arg_names:
                if n in seen or n in produced or n in param_names:
                    continue
                if not sub.has_var_local(n):
                    param_names.append(n)
            produced.update(op.output_arg_names)

        name = self.helper.name
        outs = [parent.create_var(
            name=name + ".out_%d" % i,
            dtype=o.dtype,
            # stacked per-step outputs: [batch, time] + per-step dims
            shape=([-1, -1] + [int(d) for d in o.shape[1:]]
                   if o.shape is not None else None),
            lod_level=1 if self.seq_inputs and self.seq_inputs[0][0].lod_level
            else 0) for i, o in enumerate(self.outputs)]
        final_states = [parent.create_var(
            name=name + ".state_%d" % i, dtype=m["init"].dtype,
            shape=m["init"].shape) for i, m in enumerate(self.memories)]
        parent.append_op(
            "scan_block",
            {"X": [x.name for x, _ in self.seq_inputs],
             "Init": [m["init"].name for m in self.memories],
             "Params": param_names},
            {"Out": [o.name for o in outs],
             "StepState": [s.name for s in final_states]},
            {"sub_block_id": sub.idx,
             "x_names": x_names,
             "state_in_names": state_in,
             "state_out_names": [m["post"] for m in self.memories],
             "out_names": [o.name for o in self.outputs],
             "param_names": param_names,
             "is_reverse": self.is_reverse})
        self.out_vars = outs
        self.final_states = final_states

    def __call__(self):
        if len(self.out_vars) == 1:
            return self.out_vars[0]
        return self.out_vars
