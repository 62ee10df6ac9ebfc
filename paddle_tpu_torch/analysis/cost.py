"""A step's cost: flops and bytes accessed, from each op's shapes.

No JAX counterpart: the JAX package's ``Executor.cost_analysis`` returns
XLA's cost model of the compiled step. The port has no compiler between
the program and the card, so this module counts the work from the
program itself, for one step of a plan's final program:

* **Shapes.** The step's ops run once on ``torch.device("meta")``
  (``core/lower.run_op`` over meta copies of the feeds and the scope's
  state): every op's inputs and outputs get their concrete shapes and
  dtypes, ``PackedSeq`` payloads included, and nothing runs on the card
  or moves in the scope. Ops inside a control-flow op's sub-block are
  not counted (their trip count is data); the control-flow op's own
  inputs and outputs are.
* **Flops.** 2·M·N·K for ``mul``, ``matmul``, ``conv2d`` (and
  ``depthwise_conv2d``, ``conv2d_transpose``, the fused
  ``conv2d_bn_act``); the recurrent products of ``lstm`` (B3, 2·B·T·4H·H)
  and ``gru`` (B5, 2·B·T·3H·H) and the two attention products of
  ``fused_attention`` (B1, 4·B·H·pairs·D, pairs counting only the
  unmasked query/key pairs of a causal mask). A grad op reads its
  forward op's shapes through ``fwd_op_uid`` (``generic_grad`` ops and
  ``conv2d_bn_act_grad`` have none of their own, as in
  ``analysis/shapes``): a product's grad costs one forward product per
  operand whose gradient it makes; ``fused_attention_grad`` five
  products (the recomputed scores, dV, dP, dQ, dK); ``lstm_grad`` and
  ``gru_grad`` three times the forward (the recomputed forward, the
  recurrent dh product and dW). Elementwise ops (``elementwise_*``,
  activations, ``scale``, ``sum``, ``dropout``) and their grads count
  one flop an output element. Everything else (normalisations,
  reductions, softmax, the optimizer updates) counts none: XLA would
  count some of them, so a small program's figure lies a few percent
  under XLA's. These products are the hand-written kernels' work that
  ``torch.utils.flop_counter.FlopCounterMode`` does not see.
* **Bytes.** The sum of each op's input and output bytes: what the
  port's eager plan reads and writes, op by op. It is not XLA's
  post-fusion figure, which counts a fused region's inputs and outputs
  once.

``flops by op`` splits the flops by op type (B1's ``fused_attention``
and its grad, B3-B6's ``lstm``/``gru`` and their grads apart from the
library's products).
"""

import math

import torch

from paddle_tpu_torch.core.lower import (PackedSeq, RowSparse, TensorArray,
                                         TraceContext, run_op)

__all__ = ["step_cost", "to_meta"]

META = torch.device("meta")

_PRODUCTS = ("mul", "matmul", "conv2d", "depthwise_conv2d",
             "conv2d_transpose", "conv2d_bn_act", "fused_attention",
             "lstm", "gru")

# the operand slots whose gradients each cost one forward product
_OPERANDS = {"mul": ("X", "Y"), "matmul": ("X", "Y"),
             "conv2d": ("Input", "Filter"),
             "depthwise_conv2d": ("Input", "Filter"),
             "conv2d_transpose": ("Input", "Filter"),
             "conv2d_bn_act": ("Input", "Filter")}

# grad cost in forward products for the recurrent and attention ops
_GRAD_FACTOR = {"fused_attention": 2.5, "lstm": 3.0, "gru": 3.0}

_ELEMENTWISE = frozenset((
    "relu", "relu6", "sigmoid", "tanh", "sqrt", "abs", "square", "exp",
    "log", "reciprocal", "softplus", "softsign", "brelu", "leaky_relu",
    "soft_relu", "elu", "pow", "stanh", "hard_shrink", "thresholded_relu",
    "hard_sigmoid", "swish", "gelu", "scale", "clip", "sum", "dropout",
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow"))


def to_meta(v):
    """A shape-and-dtype copy of a value on the meta device."""
    if isinstance(v, PackedSeq):
        return PackedSeq(to_meta(v.data), to_meta(v.lengths))
    if isinstance(v, TensorArray):
        return TensorArray(to_meta(v.data), to_meta(v.size))
    if isinstance(v, RowSparse):
        return RowSparse(to_meta(v.rows), to_meta(v.values), v.height)
    if isinstance(v, torch.Tensor):
        return torch.empty_like(v, device=META)
    return v


def _tensors(v):
    if isinstance(v, PackedSeq):
        return [v.data, v.lengths]
    if isinstance(v, TensorArray):
        return [v.data, v.size]
    if isinstance(v, RowSparse):
        return [v.rows, v.values]
    return [v] if isinstance(v, torch.Tensor) else []


def _data(v):
    return v.data if isinstance(v, (PackedSeq, TensorArray)) else \
        v.values if isinstance(v, RowSparse) else v


def _nbytes(v):
    return sum(t.numel() * t.element_size() for t in _tensors(v))


def _first(vals, slot):
    v = (vals.get(slot) or [None])[0]
    return _data(v) if v is not None else None


def _pairs(sq, sk, causal):
    """Unmasked (query, key) pairs of one head: every pair, or under a
    causal mask (queries aligned to the last keys) those at or before
    each query's position."""
    if not causal:
        return sq * sk
    off = sk - sq
    return sum(max(0, min(sk, i + off + 1)) for i in range(sq))


def _product_flops(op_type, attrs, ins, outs):
    """One forward product of a product op from its tensors."""
    if op_type == "mul":
        y, out = _first(ins, "Y"), _first(outs, "Out")
        yd = int(attrs.get("y_num_col_dims", 1))
        return 2 * out.numel() * math.prod(y.shape[:yd])
    if op_type == "matmul":
        x, out = _first(ins, "X"), _first(outs, "Out")
        k = x.shape[0] if x.dim() == 1 else \
            x.shape[-2] if attrs.get("transpose_X", False) else x.shape[-1]
        return 2 * out.numel() * k
    if op_type == "conv2d_transpose":
        x, w = _first(ins, "Input"), _first(ins, "Filter")
        return 2 * x.numel() * math.prod(w.shape[1:])
    if op_type in ("conv2d", "depthwise_conv2d", "conv2d_bn_act"):
        w = _first(ins, "Filter")
        out = _first(outs, "Output" if "Output" in outs else "Out")
        return 2 * out.numel() * math.prod(w.shape[1:])
    if op_type == "fused_attention":
        q, k = _first(ins, "Q"), _first(ins, "K")
        if attrs.get("cache_mode") == "decode":
            k = _first(ins, "KCache")
        b, h, sq, d = q.shape
        causal = bool(attrs.get("causal", False)) \
            or attrs.get("cache_mode") is not None
        return 4 * b * h * _pairs(sq, k.shape[2], causal) * d
    if op_type in ("lstm", "gru"):
        x, w = _first(ins, "Input"), _first(ins, "Weight")
        return 2 * x.numel() * w.shape[0]
    raise KeyError(op_type)


def _op_flops(op, ins, outs, fwd):
    t = op.type
    if t in _PRODUCTS:
        return _product_flops(t, op.attrs, ins, outs)
    if t in _ELEMENTWISE:
        return sum(_data(v).numel() for vals in outs.values()
                   for v in vals if v is not None)
    if not t.endswith("_grad"):
        return 0
    base = t[:-len("_grad")]
    grads = sum(_data(v).numel() for s, vals in outs.items()
                if s.startswith("GRAD@") for v in vals if v is not None)
    if base in _ELEMENTWISE:
        return grads
    rec = fwd.get(op.attrs.get("fwd_op_uid"))
    if base not in _PRODUCTS or rec is None:
        return 0
    one = _product_flops(base, op.attrs, *rec)
    if base in _GRAD_FACTOR:
        return int(one * _GRAD_FACTOR[base])
    made = sum(1 for s in _OPERANDS[base]
               if any(op.outputs.get("GRAD@" + s, ())))
    return one * made


def step_cost(program, values):
    """Flops and bytes of one step of ``program`` (module docstring).
    ``values``: {name: value} of the feeds and the scope state the step
    reads (any device: the run uses meta copies)."""
    env = {n: to_meta(v) for n, v in values.items()}
    block = program.global_block()
    ctx = TraceContext(key=0, training=True, program=program, device=META)
    fwd, by_type = {}, {}
    flops = nbytes = 0
    with torch.no_grad():
        for op in block.ops:
            ins = {s: [env.get(n) if n else None for n in names]
                   for s, names in op.inputs.items()}
            run_op(ctx, block, op, env)
            outs = {s: [env.get(n) if n else None for n in names]
                    for s, names in op.outputs.items()}
            if not op.type.endswith("_grad"):
                fwd[op.uid] = (ins, outs)
            f = _op_flops(op, ins, outs, fwd)
            if f:
                by_type[op.type] = by_type.get(op.type, 0) + f
            flops += f
            nbytes += sum(_nbytes(v) for vals in (*ins.values(),
                                                  *outs.values())
                          for v in vals if v is not None)
    return {"flops": float(flops), "bytes accessed": float(nbytes),
            "flops by op": {k: float(v) for k, v in sorted(by_type.items())}}
