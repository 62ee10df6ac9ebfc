"""Control-flow op lowerings: ``while``, ``conditional_block``,
``scan_block`` (the engine of StaticRNN and DynamicRNN), the tensor
arrays, and ``recompute``, the op of ``layers.RecomputeRegion``.

Capability parity: reference `operators/while_op.cc:35`,
`conditional_block_op.cc`, `recurrent_op.cc` (the static RNN unroll),
`tensor_array_read_write_op`, `is_empty_op`, `print_op`, as the JAX
package's ``ops/control_flow_ops.py`` lowers them. Every one is an
ordinary differentiable op over explicit ``Init``/``Params`` inputs, so
the generic grad (autograd of the recomputed loop) is its grad; the
JAX package runs the loops under ``lax.while_loop`` / ``lax.cond`` /
``lax.scan``, here they are Python loops over the sub-block.

The eager forms read the host: a ``while`` reads its predicate once an
iteration (one synchronisation on the card), a ``conditional_block``
reads ``Cond``, ``print`` reads its input. A CUDA graph cannot hold a
host read, so under capture (``core/graphs.py``) they take their bounded
device forms or refuse:

* ``while`` with ``max_iters`` runs exactly ``max_iters`` masked steps,
  the form the JAX package differentiates (``lax.scan`` at
  ``differentiable``): a finished loop keeps its values through
  ``torch.where``, bit for bit, so the values equal the eager loop's.
  A training program's ``while`` (stamped ``differentiable`` by
  ``append_backward``) runs that form eagerly too. Without
  ``max_iters`` the capture raises.
* ``conditional_block`` runs its branch and selects on the device, as
  an autograd function (``_SelectedBranch``) whose backward selects the
  branch's gradients the same way, so an inf or NaN in the branch not
  taken never reaches a gradient: the branch not taken contributes
  zero, as under ``lax.cond``, at the top level and nested in a loop.
* ``print`` raises.
"""

import numpy as np
import torch

from paddle_tpu_torch.core.lower import PackedSeq, TensorArray, run_block
from paddle_tpu_torch.core.registry import op

__all__ = ["TensorArray", "capturing"]


def capturing(ctx):
    """Whether this run is being captured into a CUDA graph."""
    return ctx.device.type == "cuda" and \
        torch.cuda.is_current_stream_capturing()


def _host_bool(t):
    """A 0-d or one-element predicate read on the host."""
    return bool(t.reshape(()))


def _pred(t):
    """A 0-d or one-element predicate as a 0-d bool tensor."""
    return t.reshape(()).to(torch.bool)


def _select(pred, new, old):
    """``torch.where(pred, new, old)`` over a carried value (a tensor,
    PackedSeq or TensorArray)."""
    if isinstance(new, PackedSeq):
        return PackedSeq(_select(pred, new.data, old.data),
                         _select(pred, new.lengths, old.lengths))
    if isinstance(new, TensorArray):
        return TensorArray(_select(pred, new.data, old.data),
                           _select(pred, new.size, old.size))
    return torch.where(pred, new, old)


def _sub_runner(ctx, o, attrs, ins):
    """``run(values)``: the op's sub-block over its ``Params`` and the
    carried values bound to ``carry_names``, returning the carried
    names' values after it."""
    sub = o.block.program.block(attrs["sub_block_id"])
    carry_names = list(attrs.get("carry_names", []))
    base = dict(zip(attrs.get("param_names", []), ins.get("Params", [])))

    def run(vals):
        env = dict(base)
        env.update(zip(carry_names, vals))
        run_block(ctx, sub, env)
        return [env[n] for n in carry_names]

    return run


@op("while", nondiff_inputs=("Condition",))
def _while(ctx, ins, attrs, o):
    """Structured while loop (reference `operators/while_op.cc:35`).

    inputs  Condition -- the entry predicate (also one of the carries)
            Init      -- the loop-carried values; ``Out`` writes them
                         back under ``carry_names`` (in place)
            Params    -- outer values the body only reads
    attrs   carry_names / param_names / cond_name / sub_block_id;
            max_iters -- a static trip bound (required for training and
                         for a CUDA graph);
            differentiable -- set by append_backward: exactly max_iters
                         masked steps, which autograd differentiates.
    Eagerly the loop reads its predicate on the host each iteration and
    stops at ``max_iters`` when one is given; under capture it runs the
    masked form (the module docstring)."""
    carry_names = list(attrs["carry_names"])
    cond_idx = carry_names.index(attrs["cond_name"])
    max_iters = int(attrs.get("max_iters", 0) or 0)
    inits = list(ins.get("Init", []))
    body = _sub_runner(ctx, o, attrs, ins)

    if ctx.device.type == "meta":
        return {"Out": body(inits)}      # shapes: every step has the same
    if attrs.get("differentiable", False):
        if max_iters <= 0:
            raise ValueError(
                "differentiating a While requires a static trip bound: "
                "pass max_iters=N to layers.While(cond, max_iters=N) "
                "(reverse mode needs a bounded loop)")
        return {"Out": _masked_loop(body, inits, cond_idx, max_iters)}
    if capturing(ctx):
        if max_iters <= 0:
            raise RuntimeError(
                "a While without max_iters cannot be captured into a CUDA "
                "graph: its eager form reads the loop predicate on the "
                "host every iteration. Pass max_iters=N to layers.While("
                "cond, max_iters=N) (the captured loop runs N masked "
                "steps), or run the program with Executor.run()")
        return {"Out": _masked_loop(body, inits, cond_idx, max_iters)}
    vals, it = inits, 0
    while _host_bool(vals[cond_idx]) and (not max_iters or it < max_iters):
        vals = body(vals)
        it += 1
    return {"Out": vals}


def _masked_loop(body, vals, cond_idx, max_iters):
    """``max_iters`` steps of ``body``; once the predicate is false every
    carried value keeps its value (the JAX package's masked scan)."""
    alive = _pred(vals[cond_idx])
    for _ in range(max_iters):
        vals = [_select(alive, nv, pv) for nv, pv in zip(body(vals), vals)]
        alive = torch.logical_and(alive, _pred(vals[cond_idx]))
    return vals


def _taken_branch(ctx, ins, attrs, o):
    """The sub-block over ``Init`` and ``Params``: the branch taken."""
    return {"Out": _sub_runner(ctx, o, attrs, ins)(list(ins.get("Init",
                                                                [])))}


def _flatten(vals):
    """The tensors of ``vals`` (tensors, PackedSeqs, TensorArrays) in
    order, and ``rebuild(tensors)`` that puts them back in their kinds."""
    kinds, flat = [], []
    for v in vals:
        if isinstance(v, PackedSeq):
            kinds.append(PackedSeq)
            flat += [v.data, v.lengths]
        elif isinstance(v, TensorArray):
            kinds.append(TensorArray)
            flat += [v.data, v.size]
        else:
            kinds.append(None)
            flat.append(v)

    def rebuild(ts):
        out, k = [], 0
        for kind in kinds:
            if kind is None:
                out.append(ts[k])
                k += 1
            else:
                out.append(kind(ts[k], ts[k + 1]))
                k += 2
        return out

    return flat, rebuild


class _SelectedBranch(torch.autograd.Function):
    """The captured ``conditional_block``: the branch runs and its results
    are selected on the device. The backward re-runs the branch under
    autograd and selects its gradients the same way, so the branch not
    taken contributes zero to every gradient, an inf or NaN inside it
    included, as under ``lax.cond``; ``Init``'s cotangents then pass
    straight through. Autograd takes this backward wherever the block
    sits: at the top level, or inside a While, StaticRNN or DynamicRNN.

    ``branch(flat)`` maps the flattened ``Init`` + ``Params`` tensors to
    the flattened results, laid out as ``Init``'s first ``n_init``."""

    @staticmethod
    def forward(fctx, branch, n_init, pred, *flat):
        fctx.branch, fctx.n_init = branch, n_init
        fctx.save_for_backward(pred, *flat)
        return tuple(torch.where(pred, t, i)
                     for t, i in zip(branch(list(flat)), flat[:n_init]))

    @staticmethod
    def backward(fctx, *cots):
        pred, *flat = fctx.saved_tensors
        needs = fctx.needs_input_grad[3:]
        leaves = [t.detach().requires_grad_() if need else t
                  for t, need in zip(flat, needs)]
        wrt = [t for t, need in zip(leaves, needs) if need]
        with torch.enable_grad():
            pairs = [(t, c) for t, c in zip(fctx.branch(leaves), cots)
                     if c is not None and t.requires_grad]
            gs = torch.autograd.grad(
                [t for t, _ in pairs], wrt, [c for _, c in pairs],
                allow_unused=True) if pairs and wrt else [None] * len(wrt)
        gs = iter(gs)
        out = []
        for k, (t, need) in enumerate(zip(flat, needs)):
            if not need:
                out.append(None)
                continue
            g = next(gs)
            c = cots[k] if k < fctx.n_init else None
            out.append(torch.where(
                pred, torch.zeros_like(t) if g is None else g,
                torch.zeros_like(t) if c is None else c))
        return (None, None, None) + tuple(out)


@op("conditional_block", nondiff_inputs=("Cond",))
def _conditional_block(ctx, ins, attrs, o):
    """Structured conditional (reference `conditional_block_op.cc`): runs
    the sub-block when Cond is true, else passes Init through. Eagerly
    ``Cond`` is read on the host, so the generic grad differentiates the
    branch taken only; under capture it is ``_SelectedBranch``."""
    inits = list(ins.get("Init", []))
    if ctx.device.type == "meta":
        return _taken_branch(ctx, ins, attrs, o)
    if capturing(ctx):
        flat, rebuild = _flatten(inits + list(ins.get("Params", [])))
        flat_init, rebuild_init = _flatten(inits)
        n = len(inits)

        def branch(ts):
            vals = rebuild(ts)
            run = _sub_runner(ctx, o, attrs, {"Params": vals[n:]})
            return _flatten(run(vals[:n]))[0]

        out = _SelectedBranch.apply(branch, len(flat_init),
                                    _pred(ins["Cond"][0]), *flat)
        return {"Out": rebuild_init(list(out))}
    if _host_bool(ins["Cond"][0]):
        return _taken_branch(ctx, ins, attrs, o)
    return {"Out": inits}


@op("scan_block")
def _scan_block(ctx, ins, attrs, o):
    """Run a sub-block once per timestep.

    inputs:  X      -- sequences scanned over time (dense [B, T, ...] or
                       PackedSeq); step t's slice is bound to the
                       sub-block var attrs['x_names']
             Init   -- initial carries -> attrs['state_in_names']
             Params -- outer values the body reads -> attrs['param_names']
    outputs: Out       -- per-step stacks [B, T, ...] of the sub-block
                          vars attrs['out_names'] (a PackedSeq with X's
                          lengths when X is packed), unmasked
             StepState -- final carries (attrs['state_out_names'])
    A row whose step t is past its length keeps its carry. With
    ``is_reverse`` the steps run from T-1 down and the stacks come back
    in positional order.
    """
    sub = o.block.program.block(attrs["sub_block_id"])
    x_names = attrs.get("x_names", [])
    state_in = attrs.get("state_in_names", [])
    state_out = attrs.get("state_out_names", [])
    out_names = attrs.get("out_names", [])
    reverse = attrs.get("is_reverse", False)

    seq_lens = None
    xs = []
    for v in ins.get("X", []):
        if isinstance(v, PackedSeq):
            seq_lens = v.lengths
            v = v.data
        xs.append(v)
    t_len = xs[0].shape[1]
    if seq_lens is not None:
        valid = torch.arange(t_len, device=seq_lens.device)[None, :] \
            < seq_lens[:, None]
    else:
        valid = None
    base = dict(zip(attrs.get("param_names", []), ins.get("Params", [])))

    # shape inference runs one step: every step has the same shapes
    steps = [0] if ctx.device.type == "meta" else range(t_len)
    if reverse:
        steps = steps[::-1]
    carry = list(ins.get("Init", []))
    stacks = [[] for _ in out_names]
    for t in steps:
        env = dict(base)
        env.update((n, x[:, t]) for n, x in zip(x_names, xs))
        env.update(zip(state_in, carry))
        run_block(ctx, sub, env)
        carry = [env[n] if valid is None else _keep_finished(env[n], prev,
                                                             valid[:, t])
                 for n, prev in zip(state_out, carry)]
        for stack, n in zip(stacks, out_names):
            stack.append(env[n])
    outs = []
    for stack in stacks:
        if ctx.device.type == "meta":
            y = stack[0].unsqueeze(1).expand(
                (stack[0].shape[0], t_len) + tuple(stack[0].shape[1:]))
        else:
            y = torch.stack(stack[::-1] if reverse else stack, 1)
        outs.append(PackedSeq(y, seq_lens) if seq_lens is not None else y)
    return {"Out": outs, "StepState": carry}


def _keep_finished(new, prev, m):
    """``new`` where step t is valid for the row, else ``prev``."""
    return torch.where(m.reshape((-1,) + (1,) * (new.dim() - 1)), new, prev)


@op("recompute")
def _recompute(ctx, ins, attrs, o):
    """Run a sub-block over a local environment (``layers.
    RecomputeRegion``): the executor's forward keeps none of the
    region's intermediate activations, and the generic grad re-runs the
    region from its inputs under autograd, which is ``jax.checkpoint``'s
    semantics in the JAX package's op.

    inputs:  X      -- the region's inputs -> attrs['in_names']
             Params -- outer values the body reads -> attrs['param_names']
    outputs: Out         -- attrs['out_names'] after the body
             StatefulOut -- the outer persistables the body writes
                            (batch-norm running statistics),
                            attrs['stateful_names']"""
    sub = o.block.program.block(attrs["sub_block_id"])
    env = dict(zip(attrs.get("param_names", []), ins.get("Params", [])))
    env.update(zip(attrs.get("in_names", []), ins.get("X", [])))
    run_block(ctx, sub, env)
    stateful = attrs.get("stateful_names", [])
    # every stateful name was collected from sub-block op outputs at
    # build time, so it MUST be bound here; a silent skip would
    # misalign values with the StatefulOut names
    missing = [n for n in stateful if n not in env]
    if missing:
        raise RuntimeError("recompute: stateful outputs not bound by the "
                           "sub-block: %s" % missing)
    return {"Out": [env[n] for n in attrs.get("out_names", [])],
            "StatefulOut": [env[n] for n in stateful]}


# ---- tensor arrays and the small ops ----

@op("write_to_array", no_grad=True)
def _write_to_array(ctx, ins, attrs, o):
    """``Array`` with X written at index I (a new array of ``capacity``,
    128 by default, when ``Array`` has no value yet); the size becomes
    max(size, I + 1). The index stays on the device: the write is an
    ``index_copy`` at I clamped into the buffer, as
    ``lax.dynamic_update_index_in_dim`` clamps it."""
    arr = ins["Array"][0] if ins.get("Array") else None
    x = ins["X"][0]
    i = ins["I"][0].reshape(()).to(torch.int64)
    if arr is None:
        cap = attrs.get("capacity", 128)
        arr = TensorArray(
            torch.zeros((cap,) + tuple(x.shape), dtype=x.dtype,
                        device=x.device),
            torch.zeros((), dtype=torch.int32, device=x.device))
    at = i.clamp(0, arr.data.shape[0] - 1).reshape(1)
    data = arr.data.index_copy(0, at, x.unsqueeze(0).to(arr.data.dtype))
    return {"Out": TensorArray(
        data, torch.maximum(arr.size, (i + 1).to(torch.int32)))}


@op("read_from_array", no_grad=True)
def _read_from_array(ctx, ins, attrs, o):
    arr = ins["X"][0]
    i = ins["I"][0].reshape(()).to(torch.int64)
    at = i.clamp(0, arr.data.shape[0] - 1).reshape(1)
    return arr.data.index_select(0, at)[0]


@op("array_length", no_grad=True)
def _array_length(ctx, ins, attrs, o):
    return ins["X"][0].size.to(torch.int64)


@op("array_to_lod_tensor", no_grad=True)
def _array_to_lod_tensor(ctx, ins, attrs, o):
    """The array's buffer as a ``[B, capacity, ...]`` sequence batch whose
    every row has the array's size as its length."""
    arr = ins["X"][0]
    data = arr.data.transpose(0, 1)
    return PackedSeq(data, arr.size.to(torch.int32).expand(
        data.shape[0]).contiguous())


@op("lod_tensor_to_array", no_grad=True)
def _lod_tensor_to_array(ctx, ins, attrs, o):
    """A sequence batch as an array of its ``T`` time steps ``[B, ...]``."""
    s = ins["X"][0]
    data = s.data.transpose(0, 1)
    return TensorArray(data, torch.full((), data.shape[0], dtype=torch.int32,
                                        device=data.device))


@op("max_sequence_len", no_grad=True)
def _max_sequence_len(ctx, ins, attrs, o):
    s = ins["RankTable"][0]
    lens = s.lengths if isinstance(s, PackedSeq) else s
    return torch.amax(lens).to(torch.int64)


@op("is_empty", no_grad=True)
def _is_empty(ctx, ins, attrs, o):
    x = ins["X"][0]
    n = x.data.numel() if isinstance(x, (PackedSeq, TensorArray)) \
        else x.numel()
    return torch.full((), n == 0, dtype=torch.bool, device=ctx.device)


@op("print", no_grad=True)
def _print(ctx, ins, attrs, o):
    """Prints ``message`` and the value on the host (``jax.debug.print``'s
    job in the JAX package); a CUDA graph cannot hold that read, so
    under capture it raises."""
    x = ins["In"][0]
    if capturing(ctx):
        raise RuntimeError(
            "a print op cannot be captured into a CUDA graph: it reads its "
            "input on the host. Remove it, or run the program with "
            "Executor.run()")
    if ctx.device.type != "meta":
        v = (x.data if isinstance(x, PackedSeq) else x).detach().cpu()
        if v.dtype == torch.bfloat16:
            v = v.float()
        print(attrs.get("message", "") + str(np.asarray(v)))
    return {"Out": x}
