"""Program IR: the central data structure of the framework.

A ``Program`` is a list of ``Block``s; each block holds ``Variable``s and
``Operator``s. Python code (the layers DSL) only *builds* this IR; execution
happens when an :class:`~paddle_tpu_torch.core.executor.Executor` runs a
block's ops eagerly as PyTorch calls on one device.

The IR is the JAX package's, unchanged: the same classes, the same
JSON serialization (so a program built by either package serializes to
the same bytes) and the same op uids.
"""

import contextlib
import copy
import json

import numpy as np

from paddle_tpu_torch import unique_name

__all__ = [
    "Variable",
    "Operator",
    "Block",
    "Program",
    "Parameter",
    "default_main_program",
    "default_startup_program",
    "switch_main_program",
    "switch_startup_program",
    "program_guard",
    "grad_var_name",
]

GRAD_SUFFIX = "@GRAD"

# Variable "types" (reference VarType enum, framework.proto:94), kept as
# the JAX package names them so serialized programs agree. This package
# runs DENSE variables only so far.
class VarType:
    DENSE = "dense"            # LOD_TENSOR with lod_level == 0
    PACKED_SEQ = "packed_seq"  # LOD_TENSOR with lod_level > 0 -> (data, lengths)
    TENSOR_ARRAY = "tensor_array"  # LOD_TENSOR_ARRAY -> stacked dense + size
    RAW = "raw"


def grad_var_name(name):
    return name + GRAD_SUFFIX


class Variable:
    """A named value in a Block. Doubles as the VarDesc (compile-time metadata)
    and the user-facing handle returned by layers (reference framework.py:117).

    ``shape`` may contain -1 (unknown / batch dims); concrete shapes are bound
    at trace time from the feed. ``stop_gradient`` gates append_backward.
    """

    def __init__(self, block, name, shape=None, dtype="float32",
                 lod_level=0, persistable=False, stop_gradient=False,
                 is_data=False, type=VarType.DENSE, initializer=None,
                 trainable=True, **kwargs):
        self.block = block
        self.name = name
        self.shape = tuple(int(s) for s in shape) if shape is not None else None
        self.dtype = np.dtype(dtype).name if dtype is not None else None
        self.lod_level = lod_level
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.type = type
        self.trainable = trainable
        # set by optimizers (e.g. learning-rate schedulers mark themselves)
        self.optimize_attr = kwargs.get("optimize_attr", None)

    @property
    def is_parameter(self):
        return isinstance(self, Parameter)

    def to_dict(self):
        return {
            "name": self.name,
            "shape": list(self.shape) if self.shape is not None else None,
            "dtype": self.dtype,
            "lod_level": self.lod_level,
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "is_data": self.is_data,
            "type": self.type,
            "is_parameter": self.is_parameter,
            "trainable": self.trainable,
        }

    def __repr__(self):
        return "Variable(%s, shape=%s, dtype=%s%s)" % (
            self.name, self.shape, self.dtype,
            ", persistable" if self.persistable else "")

    __str__ = __repr__


class Parameter(Variable):
    """A persistable, trainable Variable with optimization metadata
    (reference framework.py:1164)."""

    def __init__(self, block, name, shape, dtype, **kwargs):
        kwargs.setdefault("persistable", True)
        super().__init__(block, name, shape=shape, dtype=dtype, **kwargs)
        self.regularizer = kwargs.get("regularizer", None)
        self.gradient_clip_attr = kwargs.get("gradient_clip_attr", None)
        self.sharding = kwargs.get("sharding", None)  # PartitionSpec-like tuple


class Operator:
    """An op invocation: type + named input/output slots (each a list of var
    names) + attrs (reference OpDesc, framework.proto:34).

    ``uid`` is program-unique and feeds the deterministic per-op random
    stream (``core.lower.TraceContext.rng``).
    """

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        self.inputs = {k: list(v) for k, v in (inputs or {}).items()}
        self.outputs = {k: list(v) for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})
        self.uid = block.program._next_op_uid() if block is not None else -1

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    @property
    def input_arg_names(self):
        return [n for v in self.inputs.values() for n in v]

    @property
    def output_arg_names(self):
        return [n for v in self.outputs.values() for n in v]

    def has_attr(self, name):
        return name in self.attrs

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def set_attr(self, name, val):
        self.attrs[name] = val
        if self.block is not None:
            self.block.program._bump_version()

    def to_dict(self):
        return {
            "type": self.type,
            "inputs": self.inputs,
            "outputs": self.outputs,
            "attrs": _jsonable_attrs(self.attrs),
            "uid": self.uid,
        }

    def __repr__(self):
        return "Op(%s: %s -> %s)" % (self.type, self.inputs, self.outputs)


def _jsonable_attrs(attrs):
    out = {}
    for k, v in attrs.items():
        if isinstance(v, np.ndarray):
            out[k] = {"__ndarray__": v.tolist(), "dtype": v.dtype.name}
        elif isinstance(v, (np.integer,)):
            out[k] = int(v)
        elif isinstance(v, (np.floating,)):
            out[k] = float(v)
        else:
            out[k] = v
    return out


def _attrs_from_json(attrs):
    out = {}
    for k, v in attrs.items():
        if isinstance(v, dict) and "__ndarray__" in v:
            out[k] = np.asarray(v["__ndarray__"], dtype=v["dtype"])
        else:
            out[k] = v
    return out


class Block:
    """An ordered op list + a var scope (reference BlockDesc,
    framework.py:658). Sub-blocks (control flow bodies) chain to a parent for
    name resolution."""

    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars = {}       # name -> Variable
        self.ops = []        # [Operator]

    @property
    def parent_block(self):
        if self.parent_idx < 0:
            return None
        return self.program.block(self.parent_idx)

    # ---- variables ----

    def create_var(self, name=None, **kwargs):
        if name is None:
            name = unique_name.generate("tmp")
        if name in self.vars:
            return self.vars[name]
        v = Variable(self, name, **kwargs)
        self.vars[name] = v
        self.program._bump_version()
        return v

    def create_parameter(self, name, shape, dtype, **kwargs):
        # parameters always live in the global block (reference
        # layer_helper creates them there so every sub-block can see them)
        gb = self.program.global_block()
        if name in gb.vars:
            return gb.vars[name]
        p = Parameter(gb, name, shape, dtype, **kwargs)
        gb.vars[name] = p
        self.program._bump_version()
        return p

    def var(self, name):
        v = self._find_var_recursive(name)
        if v is None:
            raise KeyError("Variable %r not found in block %d" % (name, self.idx))
        return v

    def has_var(self, name):
        return self._find_var_recursive(name) is not None

    def has_var_local(self, name):
        return name in self.vars

    def _find_var_recursive(self, name):
        b = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = b.parent_block
        return None

    def all_parameters(self):
        return [v for v in self.program.global_block().vars.values()
                if isinstance(v, Parameter)]

    # ---- ops ----

    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        self.program._bump_version()
        return op

    def prepend_op(self, type, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(0, op)
        self.program._bump_version()
        return op

    def insert_op(self, index, type, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(index, op)
        self.program._bump_version()
        return op

    def remove_op(self, index):
        del self.ops[index]
        self.program._bump_version()

    def to_dict(self):
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "vars": {n: v.to_dict() for n, v in self.vars.items()},
            "ops": [op.to_dict() for op in self.ops],
        }


class Program:
    """The unit of compilation and execution (reference ProgramDesc +
    framework.py:1004). A program has a startup half (initializer ops) built
    separately; ``clone(for_test=True)`` flips training-only ops (dropout,
    batch_norm) into inference mode."""

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self._op_uid = 0
        self._version = 0
        self.random_seed = 0
        # mixed-precision compute dtype ("bfloat16" or None); serialized
        # for parity with the JAX package, never set by this package yet
        self.amp_dtype = None
        # training-health guard and IR pass configs: later slices
        self.guard = None
        self.passes = None
        # populated by append_backward / optimizer for introspection
        self._op_role_vars = []

    # ---- identity / caching ----

    def _next_op_uid(self):
        self._op_uid += 1
        return self._op_uid

    def _bump_version(self):
        self._version += 1

    @property
    def fingerprint(self):
        return (id(self), self._version, self.amp_dtype)

    # ---- blocks ----

    def global_block(self):
        return self.blocks[0]

    def block(self, idx):
        return self.blocks[idx]

    def current_block(self):
        return self.blocks[self.current_block_idx]

    def create_block(self, parent_idx=None):
        new_idx = len(self.blocks)
        parent = self.current_block_idx if parent_idx is None else parent_idx
        self.blocks.append(Block(self, new_idx, parent))
        self.current_block_idx = new_idx
        self._bump_version()
        return self.blocks[new_idx]

    def rollback(self):
        self.current_block_idx = self.blocks[self.current_block_idx].parent_idx

    # ---- transforms ----

    def clone(self, for_test=False):
        p = Program.__new__(Program)
        p.blocks = []
        p.current_block_idx = 0
        p._op_uid = self._op_uid
        p._version = 0
        p.random_seed = self.random_seed
        p.amp_dtype = self.amp_dtype
        p.guard = getattr(self, "guard", None)
        p.passes = getattr(self, "passes", None)
        p._op_role_vars = list(self._op_role_vars)
        for b in self.blocks:
            nb = Block(p, b.idx, b.parent_idx)
            for name, v in b.vars.items():
                nv = copy.copy(v)
                nv.block = nb
                nb.vars[name] = nv
            for op in b.ops:
                nop = Operator.__new__(Operator)
                nop.block = nb
                nop.type = op.type
                nop.inputs = {k: list(v) for k, v in op.inputs.items()}
                nop.outputs = {k: list(v) for k, v in op.outputs.items()}
                nop.attrs = copy.deepcopy(op.attrs)
                nop.uid = op.uid
                nb.ops.append(nop)
            p.blocks.append(nb)
        if for_test:
            for b in p.blocks:
                for op in b.ops:
                    if "is_test" in op.attrs:
                        op.attrs["is_test"] = True
        return p

    def list_vars(self):
        for b in self.blocks:
            for v in b.vars.values():
                yield v

    def verify(self, fetch_names=(), scope_names=None):
        """Static IR verification + shape/dtype inference over this
        program (paddle_tpu_torch.analysis): raises a typed
        ``VerifyError`` naming the check class, op, block, and var on
        the first provable defect; returns the inferred {name: Info}
        env. The executor runs this automatically on every plan miss
        behind ``FLAGS_verify_ir`` — call it directly to vet a
        hand-built or hand-rewritten program before execution."""
        from paddle_tpu_torch import analysis

        return analysis.verify(self, fetch_names=fetch_names,
                               scope_names=scope_names)

    # ---- serialization (JSON stands in for the reference's protobuf) ----

    def to_dict(self):
        d = {
            "version": 1,
            "random_seed": self.random_seed,
            "blocks": [b.to_dict() for b in self.blocks],
        }
        # program-level fields, serialized as the JAX package does so a
        # JSON round trip is byte-identical in both packages
        if self.amp_dtype is not None:
            d["amp_dtype"] = str(self.amp_dtype)
        if self._op_role_vars:
            d["op_role_vars"] = [list(p) for p in self._op_role_vars]
        return d

    def to_json(self):
        return json.dumps(self.to_dict())

    @staticmethod
    def from_dict(d):
        p = Program()
        p.random_seed = d.get("random_seed", 0)
        p.amp_dtype = d.get("amp_dtype")
        p._op_role_vars = [tuple(pair)
                           for pair in d.get("op_role_vars", [])]
        p.blocks = []
        for bd in d["blocks"]:
            b = Block(p, bd["idx"], bd["parent_idx"])
            for name, vd in bd["vars"].items():
                vd = dict(vd)  # don't mutate the caller's dict
                cls = Parameter if vd.pop("is_parameter", False) else Variable
                shape = vd.pop("shape")
                dtype = vd.pop("dtype")
                vname = vd.pop("name")
                if cls is Parameter:
                    v = Parameter(b, vname, shape, dtype, **vd)
                else:
                    v = Variable(b, vname, shape=shape, dtype=dtype, **vd)
                b.vars[name] = v
            for od in bd["ops"]:
                op = Operator.__new__(Operator)
                op.block = b
                op.type = od["type"]
                op.inputs = {k: list(v) for k, v in od["inputs"].items()}
                op.outputs = {k: list(v) for k, v in od["outputs"].items()}
                op.attrs = _attrs_from_json(od["attrs"])
                op.uid = od.get("uid", p._next_op_uid())
                b.ops.append(op)
            p.blocks.append(b)
        p._op_uid = max([op.uid for b in p.blocks for op in b.ops], default=0) + 1
        return p

    @staticmethod
    def from_json(s):
        return Program.from_dict(json.loads(s))

    def __repr__(self):
        lines = []
        for b in self.blocks:
            lines.append("block %d (parent %d):" % (b.idx, b.parent_idx))
            for op in b.ops:
                lines.append("  " + repr(op))
        return "\n".join(lines)


# ---- default programs & guards (reference framework.py:1224-1300) ----

_main_program = Program()
_startup_program = Program()


def default_main_program():
    return _main_program


def default_startup_program():
    return _startup_program


def switch_main_program(program):
    global _main_program
    prev, _main_program = _main_program, program
    return prev


def switch_startup_program(program):
    global _startup_program
    prev, _startup_program = _startup_program, program
    return prev


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    prev_main = switch_main_program(main_program)
    prev_startup = None
    if startup_program is not None:
        prev_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(prev_main)
        if prev_startup is not None:
            switch_startup_program(prev_startup)
