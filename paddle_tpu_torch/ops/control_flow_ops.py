"""Control-flow op lowerings: ``scan_block``, the engine of StaticRNN,
and ``recompute``, the op of ``layers.RecomputeRegion``.

Capability parity: reference `operators/recurrent_op.cc` (the static RNN
unroll), as the JAX package's ``ops/control_flow_ops.py`` lowers
``scan_block``: the sub-block runs once per timestep and the op is an
ordinary differentiable op, so the generic grad (autograd of the
recomputed loop) is its ``scan_block_grad``. The JAX package runs the
loop under ``lax.scan``; here it is a Python loop over T. ``while``,
``conditional_block`` and the tensor arrays arrive with the decode
slice.
"""

import torch

from paddle_tpu_torch.core.lower import PackedSeq, run_block
from paddle_tpu_torch.core.registry import op


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
