"""Control-flow DSL: StaticRNN, DynamicRNN, While, Switch, the tensor
arrays, comparisons and logicals.

Capability parity: `python/paddle/fluid/layers/control_flow.py`
(StaticRNN :382, While :607, DynamicRNN, Switch, the array layers), as
the JAX package builds them: a step body or loop body is a sub-block,
and the RNN is one differentiable ``scan_block`` op in the parent block
(``ops/control_flow_ops.py``) instead of the reference's recurrent op
and its hand-written grad. ``While`` and ``Switch`` make their dataflow
explicit at build time (:func:`_loop_dataflow`): the outer variables
the body writes are carried (``Init`` -> ``Out`` under the same names,
read from SSA snapshots of their values before the op), the ones it only
reads are ``Params``. A memory without ``init`` is filled in the parent
block by ``fill_constant_batch_size_like``. ``ParallelDo`` and
``get_places`` arrive with a later slice.
"""

import contextlib

from paddle_tpu_torch import unique_name
from paddle_tpu_torch.core import ir
from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.layers import tensor as tensor_layers

__all__ = ["StaticRNN", "DynamicRNN", "While", "Switch", "ParallelDo",
           "get_places", "increment",
           "array_write", "array_read", "array_length", "less_than",
           "equal", "greater_than", "logical_and", "logical_or",
           "logical_not", "max_sequence_len", "is_empty"]


def get_places(device_count=0, device_type=None):
    """The places in-graph data parallelism splits over (reference
    layers/device.py get_places). As in the JAX package the program sees
    ONE logical place: the same program runs over a mesh of ranks under
    ``ParallelExecutor``, so ``device_count > 1`` is a mesh property,
    not a program property."""
    from paddle_tpu_torch.core.place import CUDAPlace

    return [CUDAPlace(0)]


class ParallelDo:
    """In-graph data parallelism DSL (reference layers/control_flow.py
    ParallelDo: split the batch over places, replicate the sub-net,
    concat outputs). With one logical place the body IS the program:
    ``read_input`` is the identity, ``write_output`` collects the
    outputs and ``pd()`` returns them. Data parallelism over ranks runs
    the SAME program under ``ParallelExecutor``, so a config written
    against this DSL scales without rewriting."""

    def __init__(self, places, use_nccl=False, name=None):
        self.places = places
        self._outs = []

    @contextlib.contextmanager
    def do(self):
        yield

    def read_input(self, var):
        return var

    def write_output(self, var):
        self._outs.append(var)

    def __call__(self):
        if len(self._outs) == 1:
            return self._outs[0]
        return list(self._outs)


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("increment", {"X": [x]}, {"Out": [out]}, {"step": value})
    return out


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
            if shape is None or batch_ref is None:
                raise ValueError("memory needs init var or (shape, batch_ref)")
            # the fill goes in the parent block
            prog = self.helper.main_program
            cur = prog.current_block_idx
            prog.current_block_idx = self.parent_block.idx
            init = tensor_layers.fill_constant_batch_size_like(
                batch_ref, [1] + [int(s) for s in shape[1:]] if shape[0] == -1
                else [int(s) for s in shape],
                "float32", init_value, ref_batch_dim_idx, init_batch_dim_idx)
            prog.current_block_idx = cur
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

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

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

    def __call__(self, *args):
        if len(self.out_vars) == 1:
            return self.out_vars[0]
        return self.out_vars


class DynamicRNN(StaticRNN):
    """Variable-length RNN over PackedSeq inputs on the same
    ``scan_block`` engine: a finished row keeps its memories (the scan
    masks it), which replaces the reference's lod_rank_table /
    shrink_rnn_memory batch tapering (`layers/control_flow.py:1316`)."""

    def block(self):
        return self.step()

    def memory(self, init=None, shape=None, batch_ref=None, init_value=0.0,
               init_batch_dim_idx=0, ref_batch_dim_idx=0, value=None,
               need_reorder=False, dtype="float32"):
        """``memory(value=, shape=)`` takes its batch dim from the first
        step input (the reference derives it from the input's LoD).
        ``need_reorder`` has nothing to do: the scan masks finished rows
        instead of reordering the batch by length."""
        if value is not None:
            init_value = value
        if init is None and batch_ref is None:
            if not self.seq_inputs:
                raise ValueError(
                    "DynamicRNN.memory(value=, shape=) must come after "
                    "step_input so the batch dim is known")
            batch_ref = self.seq_inputs[0][0]
            if shape is not None and (not shape or shape[0] != -1):
                shape = [-1] + [int(s) for s in shape]
        return super().memory(
            init=init, shape=shape, batch_ref=batch_ref,
            init_value=init_value, init_batch_dim_idx=init_batch_dim_idx,
            ref_batch_dim_idx=ref_batch_dim_idx)

    def static_input(self, x):
        """A non-stepped input visible inside the step block. The step
        body's reads of outer variables are captured as scan params and
        the batch order never changes, so the variable is the answer."""
        self._in_step("static_input")
        return x


def _loop_dataflow(sub, parent, extra_carried=()):
    """(carried, params): outer vars the sub-block writes (loop-carried,
    updated in place) and outer vars it only reads (weights and
    constants). Explicit dataflow is what lets the generic grad
    differentiate through the loop; the reference reconstructs it inside
    WhileGradOp at run time (`operators/while_op.cc:35`)."""
    writes, reads = [], []
    wset = set()
    for o2 in sub.ops:
        for n in o2.input_arg_names:
            if n and n not in wset and n not in reads:
                reads.append(n)
        for n in o2.output_arg_names:
            if n and n not in wset:
                wset.add(n)
                writes.append(n)
    carried = list(extra_carried)
    for n in writes:
        if n not in carried and parent.has_var(n):
            carried.append(n)
    cset = set(carried)
    params = [n for n in reads
              if n not in cset and not sub.has_var_local(n)
              and parent.has_var(n)]
    return carried, params


def _snapshot_pre_values(parent, carried):
    """SSA snapshots of the carried vars' values before the op (an
    ``assign`` each). The op reads them as Init while writing back the
    original names, so its grad op re-runs the loop from the true entry
    values, not from the values the op left under those names."""
    pre_names = []
    for nm in carried:
        v = parent.var(nm)
        pre = unique_name.generate(nm + "@PRE")
        parent.create_var(name=pre, shape=v.shape, dtype=v.dtype,
                          lod_level=v.lod_level, type=v.type)
        parent.append_op("assign", {"X": [nm]}, {"Out": [pre]})
        pre_names.append(pre)
    return pre_names


class While:
    """While loop over a condition variable (reference
    control_flow.py:607). The loop-carried vars (the outer vars the body
    writes, the condition included) are updated in place when the loop
    ends. ``max_iters`` gives the loop a static trip bound: training
    through the loop needs it, and so does a CUDA graph of a program
    that runs it (``ops/control_flow_ops.py``)."""

    def __init__(self, cond, max_iters=0, name=None):
        self.helper = LayerHelper("while", name=name)
        self.cond_var = cond
        self.max_iters = max_iters
        self.sub_block = None

    @contextlib.contextmanager
    def block(self):
        prog = self.helper.main_program
        parent = prog.current_block()
        self.sub_block = prog.create_block()
        try:
            yield
        finally:
            prog.rollback()
            carried, params = _loop_dataflow(
                self.sub_block, parent, extra_carried=[self.cond_var.name])
            pre = _snapshot_pre_values(parent, carried)
            parent.append_op(
                "while",
                {"Condition": [pre[0]], "Init": pre, "Params": params},
                {"Out": list(carried)},
                {"sub_block_id": self.sub_block.idx,
                 "carry_names": carried, "param_names": params,
                 "cond_name": self.cond_var.name,
                 "max_iters": self.max_iters})


class Switch:
    """Switch/case on scalar conditions (reference layers/control_flow.py
    Switch): each case body runs under a conditional_block whose
    condition is the case's and none of the earlier ones'."""

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self.pre_not_conditions = []

    @contextlib.contextmanager
    def case(self, condition):
        prog = self.helper.main_program
        parent = prog.current_block()
        if self.pre_not_conditions:
            cond = logical_and(self.pre_not_conditions[-1], condition)
        else:
            cond = condition
        not_cond = logical_not(condition) if not self.pre_not_conditions \
            else logical_and(self.pre_not_conditions[-1],
                             logical_not(condition))
        self.pre_not_conditions.append(not_cond)
        sub = prog.create_block()
        try:
            yield
        finally:
            prog.rollback()
            carried, params = _loop_dataflow(sub, parent)
            pre = _snapshot_pre_values(parent, carried)
            parent.append_op("conditional_block",
                             {"Cond": [cond.name], "Init": pre,
                              "Params": params},
                             {"Out": list(carried)},
                             {"sub_block_id": sub.idx,
                              "carry_names": carried,
                              "param_names": params})

    @contextlib.contextmanager
    def default(self):
        if not self.pre_not_conditions:
            raise ValueError("default() must follow at least one case()")
        # case() ANDs with the last "none so far" again: x AND x == x
        with self.case(self.pre_not_conditions[-1]):
            yield


def array_write(x, i, array=None):
    helper = LayerHelper("array_write")
    if array is None:
        array = helper.create_variable(
            name=helper.name + ".array", type=ir.VarType.TENSOR_ARRAY,
            dtype=x.dtype)
    helper.append_op("write_to_array",
                     {"X": [x], "I": [i], "Array": [array]},
                     {"Out": [array]})
    return array


def array_read(array, i):
    helper = LayerHelper("array_read")
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op("read_from_array", {"X": [array], "I": [i]},
                     {"Out": [out]})
    return out


def array_length(array):
    helper = LayerHelper("array_length")
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op("array_length", {"X": [array]}, {"Out": [out]})
    return out


def _cmp_layer(type_name, x, y, cond=None):
    helper = LayerHelper(type_name)
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool")
    helper.append_op(type_name, {"X": [x], "Y": [y]}, {"Out": [cond]})
    return cond


def less_than(x, y, cond=None):
    return _cmp_layer("less_than", x, y, cond)


def equal(x, y, cond=None):
    return _cmp_layer("equal", x, y, cond)


def greater_than(x, y, cond=None):
    return _cmp_layer("greater_than", x, y, cond)


def logical_and(x, y, out=None):
    return _cmp_layer("logical_and", x, y, out)


def logical_or(x, y, out=None):
    return _cmp_layer("logical_or", x, y, out)


def logical_not(x, out=None):
    helper = LayerHelper("logical_not")
    if out is None:
        out = helper.create_variable_for_type_inference("bool")
    helper.append_op("logical_not", {"X": [x]}, {"Out": [out]})
    return out


def max_sequence_len(rank_table):
    helper = LayerHelper("max_sequence_len")
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op("max_sequence_len", {"RankTable": [rank_table]},
                     {"Out": [out]})
    return out


def is_empty(x, cond=None):
    helper = LayerHelper("is_empty")
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool")
    helper.append_op("is_empty", {"X": [x]}, {"Out": [cond]})
    return cond
