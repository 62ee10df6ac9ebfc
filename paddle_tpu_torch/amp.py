"""Automatic mixed precision: a bf16 compute policy over the run.

The JAX package's ``amp.py``: the dtype policy is applied where each
op's inputs enter its lowering, not by inserting cast ops. Master
parameters stay float32 in the Scope; an op's float32 inputs are cast to
bfloat16 as they enter its lowering, and losses, statistics and the
optimizer's update math stay float32. Convolutions and matmuls run
bf16 in, bf16 out (the card's tensor cores and the CPU's kernels
accumulate in float32 inside the call).

``core.lower.run_op`` casts before a forward lowering and before a
hand-written ``grad_lower``; ``registry.generic_grad`` casts INSIDE the
recomputed forward that autograd differentiates, so the cotangents flow
back through the cast and float32 master parameters get float32
gradients.

Enable per program: ``program.amp_dtype = "bfloat16"`` or
``amp.enable(program)``; the Executor picks it up.

Dynamic loss scaling (``dynamic_loss_scale=True``) arms the
training-health guard (``guard.py``) as the JAX package's ``amp.enable``
does.
"""

import torch

from paddle_tpu_torch.core.infer import torch_dtype

__all__ = ["enable", "disable", "cast_ins", "FP32_OPS"]

# Ops that must see float32 inputs: losses, probability/statistics ops,
# and ops whose numerics degrade badly in half precision.
FP32_OPS = {
    "cross_entropy", "softmax_with_cross_entropy",
    "sigmoid_cross_entropy_with_logits", "softmax", "log_softmax",
    "mean", "accuracy", "auc", "precision_recall",
    "linear_chain_crf", "crf_decoding", "warpctc", "ctc_align",
    "nce", "cos_sim", "edit_distance",
    "uniform_random", "gaussian_random", "fill_constant",
    "cast",  # explicit casts are the user's business
    "clip_by_norm", "squared_l2_norm", "l1_norm",
}

# Ops whose inputs are left alone (indices, state carries, and the
# grad-accumulation sum/assign emitted by append_backward: casting there
# would round float32 master gradients at the accumulation point).
_SKIP = {"feed", "fetch", "read", "increment", "assign", "shape",
         "lod_rank_table", "is_empty", "print", "sum"}

# Per-op slots that keep float32: these lowerings compute in float32
# inside, so rounding the small per-channel affine parameters to bf16
# would only lose master precision.
_FP32_SLOTS = {
    "batch_norm": ("Scale", "Bias"),
    "conv2d_bn_act": ("Scale", "Bias"),
    "layer_norm": ("Scale", "Bias"),
}


def enable(program, dtype="bfloat16", loss=None, dynamic_loss_scale=False,
           **guard_opts):
    """Mark ``program`` for mixed-precision lowering.

    ``dynamic_loss_scale=True`` also arms the training-health guard
    (``guard.py``) with dynamic loss scaling: the backward's seed is
    multiplied by a scale kept in the scope, parameter gradients are
    unscaled (to their true magnitude, float32 for float32 masters)
    before clipping, regularization and the optimizer, the scale halves
    when a step overflows and grows after ``growth_interval`` clean
    steps, and the overflowing step applies no state update. It needs
    ``loss=`` (the loss Variable); the other ``guard_opts`` go to
    ``guard.GuardConfig`` (init_loss_scale, growth_interval, ...).
    Without ``dynamic_loss_scale=True``, ``loss=`` or a guard option
    raises ``ValueError`` (a typo'd option must not pass silently)."""
    if not dynamic_loss_scale and (loss is not None or guard_opts):
        raise ValueError(
            "amp.enable: loss=/%s have no effect without "
            "dynamic_loss_scale=True" % (sorted(guard_opts) or "guard "
                                         "options"))
    program.amp_dtype = dtype
    if dynamic_loss_scale:
        if loss is None:
            raise ValueError(
                "amp.enable(dynamic_loss_scale=True) needs loss= (the "
                "loss Variable the scale seeds)")
        from paddle_tpu_torch import guard
        guard.enable(program, loss, dynamic_loss_scale=True, **guard_opts)
    return program


def disable(program):
    program.amp_dtype = None
    return program


def _cast_val(v, src, dst):
    """Cast ``v`` (tensor or PackedSeq) from dtype ``src`` to ``dst``."""
    from paddle_tpu_torch.core.lower import PackedSeq

    if isinstance(v, PackedSeq):
        if v.data.dtype == src:
            return PackedSeq(v.data.to(dst), v.lengths)
        return v
    if isinstance(v, torch.Tensor) and v.dtype == src:
        return v.to(dst)
    return v


def cast_ins(spec, ins, amp_dtype):
    """Apply the policy to one op's input slots. Returns possibly-new
    ins."""
    if amp_dtype is None:
        return ins
    dt = torch_dtype(amp_dtype)
    if spec.no_grad:
        # optimizer/metric ops: master math stays float32, so a half
        # gradient is widened to its parameter's dtype
        if "Grad" in ins and "Param" in ins and ins["Param"]:
            p = ins["Param"][0]
            if isinstance(p, torch.Tensor):
                ins = dict(ins)
                ins["Grad"] = [
                    g.to(p.dtype) if isinstance(g, torch.Tensor)
                    and g.dtype == dt else g for g in ins["Grad"]]
        return ins
    if spec.type in FP32_OPS:
        return {slot: [_cast_val(v, dt, torch.float32) for v in vals]
                for slot, vals in ins.items()}
    if spec.type in _SKIP:
        return ins
    # nondiff inputs (labels, indices, batch_norm's running Mean and
    # Variance) keep their dtype: they are state or metadata, and the
    # write-back must not round float32 scope state to bf16
    keep = set(spec.nondiff_inputs) | set(_FP32_SLOTS.get(spec.type, ()))
    return {slot: vals if slot in keep
            else [_cast_val(v, torch.float32, dt) for v in vals]
            for slot, vals in ins.items()}
