"""Operator registry: maps op type -> OpSpec {lowering fn, grad policy}.

Capability parity with the reference's OpRegistry / OpInfo / kernel maps
(`paddle/fluid/framework/op_registry.h:129-167`, `op_info.h`). An op's
"kernel" here is a *lowering function* over torch tensors: the executor
calls it eagerly on the program's device, and construction-time shape
inference calls the same function on meta tensors (``core.infer``).

Gradients: an op either

* relies on the **generic grad** (default): ``append_backward`` emits an
  ``<type>_grad`` op whose lowering recomputes the forward lowering on
  detached inputs under ``torch.enable_grad()`` and differentiates it
  with ``torch.autograd.grad`` (:func:`generic_grad`); or
* registers ``grad_lower`` for a hand-written backward; or
* is marked ``no_grad`` (optimizer ops, metrics, fills).

The flags are the JAX package's, op for op, so ``append_backward``
emits the same grad ops in both packages.
"""

import torch

__all__ = ["OpSpec", "register", "op", "get", "has", "REGISTRY",
           "attr_schema", "set_attr_schema", "normalize_outputs",
           "generic_grad"]

REGISTRY = {}


class OpSpec:
    def __init__(self, type, lower, grad_lower=None, no_grad=False,
                 stateful_outputs=(), nondiff_inputs=(), seq_map=False):
        if seq_map:
            lower = _seq_mapped(lower)
        self.type = type
        self.lower = lower              # fn(ctx, ins, attrs, op) -> {slot: [vals]}
        self.grad_lower = grad_lower    # fn(ctx, ins, out_grads, attrs, op) -> {slot: [grads]}
        self.no_grad = no_grad
        # input slots that are never differentiated (indices, labels)
        self.nondiff_inputs = tuple(nondiff_inputs)
        # output slots aliasing an input var (in-place updates: optimizer
        # ops). Purely informational.
        self.stateful_outputs = tuple(stateful_outputs)
        # {attr name: type | tuple-of-types | set enumeration | predicate}
        # consulted by the IR verifier (paddle_tpu_torch/analysis);
        # installed after registration via set_attr_schema — grad ops
        # inherit the forward's schema
        self.attr_schema = {}


def _seq_mapped(lower):
    """Make a dense-tensor lowering transparent over PackedSeq inputs: the
    op computes on the padded [batch, time, ...] buffer and any output that
    preserves the leading [batch, time] dims is rewrapped with the input's
    lengths (pointwise/feature ops applied per timestep to a
    variable-length batch)."""

    def wrapped(ctx, ins, attrs, op):
        from paddle_tpu_torch.core.lower import PackedSeq  # late: avoid cycle

        lengths = None
        bt = None
        new_ins = {}
        for slot, vals in ins.items():
            nv = []
            for v in vals:
                if isinstance(v, PackedSeq):
                    if lengths is None:
                        lengths = v.lengths
                        bt = tuple(v.data.shape[:2])
                    nv.append(v.data)
                else:
                    nv.append(v)
            new_ins[slot] = nv
        result = lower(ctx, new_ins, attrs, op)
        if lengths is None:
            return result
        out = {}
        for slot, vals in normalize_outputs(result).items():
            out[slot] = [
                PackedSeq(v, lengths)
                if isinstance(v, torch.Tensor) and v.dim() >= 2
                and tuple(v.shape[:2]) == bt else v
                for v in vals]
        return out

    return wrapped


def register(type, lower, **kwargs):
    if type in REGISTRY:
        raise ValueError("op %r already registered" % type)
    REGISTRY[type] = OpSpec(type, lower, **kwargs)
    return REGISTRY[type]


def op(type, **kwargs):
    """Decorator form.

    The lowering function signature is ``f(ctx, ins, attrs, op)`` where
    ``ins`` is ``{slot: [tensors]}`` and the return is
    ``{slot: [tensors]}`` (or a bare tensor meaning ``{"Out": [t]}``).
    """
    def deco(fn):
        register(type, fn, **kwargs)
        return fn
    return deco


def get(type):
    spec = REGISTRY.get(type)
    if spec is not None:
        return spec
    raise KeyError("no lowering registered for op type %r" % type)


def has(type):
    return type in REGISTRY


def set_attr_schema(type, schema):
    """Attach (merge) an attr schema onto a registered op — the IR
    verifier validates any PRESENT attr of that name against its rule
    (a type, a tuple of types, a set enumeration, or a predicate).
    Absent attrs always pass: lowerings default them."""
    spec = REGISTRY.get(type)
    if spec is None:
        raise KeyError("cannot attach attr schema: op %r is not "
                       "registered" % type)
    spec.attr_schema.update(schema)
    return spec


def attr_schema(type):
    """The registered attr schema for ``type`` ({} when none / unknown
    op). Grad types resolve through their forward spec."""
    spec = REGISTRY.get(type)
    if spec is None and type.endswith("_grad"):
        spec = REGISTRY.get(type[:-len("_grad")])
    return spec.attr_schema if spec is not None else {}


def normalize_outputs(result):
    """Allow lowerings to return a bare tensor or {slot: value-or-list}."""
    if not isinstance(result, dict):
        result = {"Out": result}
    out = {}
    for k, v in result.items():
        out[k] = v if isinstance(v, (list, tuple)) else [v]
    return out


def _leaf(v):
    """A detached copy of a float forward input that autograd tracks; a
    PackedSeq (a TensorArray) differentiates through its data only."""
    from paddle_tpu_torch.core.lower import PackedSeq, TensorArray

    if isinstance(v, PackedSeq):
        return PackedSeq(_leaf(v.data), v.lengths)
    if isinstance(v, TensorArray):
        return TensorArray(_leaf(v.data), v.size)
    if isinstance(v, torch.Tensor) and v.is_floating_point():
        return v.detach().requires_grad_()
    return v


def _data(v):
    from paddle_tpu_torch.core.lower import PackedSeq, TensorArray

    return v.data if isinstance(v, (PackedSeq, TensorArray)) else v


def generic_grad(ctx, spec, fwd_op, ins, out_grads):
    """Differentiate a forward lowering by recomputing it under autograd.

    ``ins``: {slot: [vals]} forward inputs; ``out_grads``: {slot: [grad
    or None]} cotangents for each forward output (a missing cotangent is
    zero). Returns {slot: [grad or None]} for the differentiable inputs;
    None where no gradient flows. A PackedSeq input's gradient is a
    PackedSeq with the same lengths, a TensorArray's a TensorArray of the
    same size.
    """
    from paddle_tpu_torch.core.lower import PackedSeq, TensorArray

    leaves = {s: [_leaf(v) for v in vals] for s, vals in ins.items()
              if s not in spec.nondiff_inputs}
    full = dict(ins)
    full.update(leaves)
    with torch.enable_grad():
        if ctx.amp_dtype is not None:
            # cast INSIDE the differentiated function: cotangents flow
            # back through the cast, so float32 master parameters get
            # float32 gradients
            from paddle_tpu_torch import amp
            full = amp.cast_ins(spec, full, ctx.amp_dtype)
        result = normalize_outputs(
            spec.lower(ctx.for_op(fwd_op), full, fwd_op.attrs, fwd_op))
        outs, cots = [], []
        for slot, vals in result.items():
            gs = out_grads.get(slot) or []
            for i, v in enumerate(vals):
                g = gs[i] if i < len(gs) else None
                v = _data(v)
                if g is None or not isinstance(v, torch.Tensor) \
                        or not v.requires_grad:
                    continue
                outs.append(v)
                cots.append(_data(g).to(v.dtype).reshape(v.shape))
        flat = [(s, i, _data(v)) for s, vals in leaves.items()
                for i, v in enumerate(vals)
                if isinstance(_data(v), torch.Tensor)
                and _data(v).requires_grad]
        grads = torch.autograd.grad(
            outs, [t for _, _, t in flat], cots,
            allow_unused=True) if outs and flat else [None] * len(flat)
    out = {s: [None] * len(vals) for s, vals in leaves.items()}
    for (s, i, _), g in zip(flat, grads):
        if g is not None:
            v = ins[s][i]
            if isinstance(v, PackedSeq):
                g = PackedSeq(g, v.lengths)
            elif isinstance(v, TensorArray):
                g = TensorArray(g, v.size)
            out[s][i] = g
    return out
