"""Conv epilogue fusion: conv2d -> batch_norm [-> elementwise_add] [-> relu]
collapses to ONE ``conv2d_bn_act`` op, forward and backward.

The JAX package's ``passes/epilogue.py``, rule for rule, so a fused
program serializes to the same JSON in both packages. Depthwise convs
(``depthwise_conv2d``) fuse through the same matcher; the fused op
records the conv flavor (``conv_type``) and its lowering re-derives the
channel grouping.

The fused lowering (``ops/nn_ops.py`` ``conv2d_bn_act``) re-runs the
arithmetic of the unfused chain (the same conv call, the same float32
statistics and casts), so the rewrite is bitwise against the unfused
program on the CPU; its hand-written backward chains the same pieces
(autograd through the act/add tail, the hand-written batch-norm
backward, autograd through the conv) in the order the per-op grads run
them. That backward is one op whose batch-norm part the reduction pass
can tag for the batch-norm backward kernel, and whose 1x1 stride-1 NCHW
conv takes the fused 1x1 backward under ``FLAGS_fused_conv1x1_bwd``.

Matching is conservative: every fused-away intermediate must have
exactly one consumer, must not be fetched (protected) or persistable,
and the backward group (located by ``fwd_op_uid``) must chain directly
-- any mismatch leaves the pattern unfused. Inference programs (no grad
ops) fuse forward-only.
"""

from paddle_tpu_torch.core import ir

__all__ = ["run"]

_BN_STATE = ("MeanOut", "VarianceOut", "SavedMean", "SavedVariance")


def run(program, cfg, protected=()):
    block = program.global_block()
    protected = frozenset(protected)
    fused = 0

    while True:
        match = _find_pattern(block, protected)
        if match is None:
            break
        _apply(block, match)
        fused += 1
    if fused:
        program._bump_version()
    return fused


def _consumers(block):
    cons = {}
    for op in block.ops:
        for ns in op.inputs.values():
            for n in ns:
                if n:
                    cons.setdefault(n, []).append(op)
    return cons


def _single_fwd_consumer(cons, name, protected, block):
    """The unique FORWARD consumer of ``name`` (grad ops re-read
    forward intermediates — they join the fused grad, so they don't
    break the pattern; the final all-consumers check below still
    verifies every reader lands inside the fused group)."""
    if name in protected:
        return None
    v = block._find_var_recursive(name)
    if v is not None and getattr(v, "persistable", False):
        return None
    ops = [op for op in cons.get(name, [])
           if not op.type.endswith("_grad")]
    return ops[0] if len(ops) == 1 else None


def _grad_map(block):
    """fwd uid -> its grad op (None when absent / ambiguous)."""
    m = {}
    for op in block.ops:
        if op.type.endswith("_grad"):
            u = op.attrs.get("fwd_op_uid")
            m[u] = None if u in m else op
    return m


_FUSABLE_CONVS = ("conv2d", "depthwise_conv2d")


def _find_pattern(block, protected):
    cons = _consumers(block)
    grads = _grad_map(block)
    for conv in block.ops:
        if conv.type not in _FUSABLE_CONVS:
            continue
        m = _match_from(block, cons, grads, protected, conv)
        if m is not None:
            return m
    return None


def _match_from(block, cons, grads, protected, conv):
    conv_out = conv.outputs.get("Output", [None])[0]
    if not conv_out:
        return None
    bn = _single_fwd_consumer(cons, conv_out, protected, block)
    if bn is None or bn.type != "batch_norm" \
            or bn.inputs.get("X", [None])[0] != conv_out \
            or bn.attrs.get("data_layout", "NCHW") \
            != conv.attrs.get("data_layout", "NCHW"):
        return None
    bn_y = bn.outputs.get("Y", [None])[0]
    if not bn_y:
        return None

    add = relu = None
    residual = None
    tail = bn
    nxt = _single_fwd_consumer(cons, bn_y, protected, block)
    if nxt is not None and nxt.type == "elementwise_add" \
            and nxt.attrs.get("axis", -1) == -1:
        xs = nxt.inputs.get("X", [None])[0]
        ys = nxt.inputs.get("Y", [None])[0]
        if xs and ys and xs != ys and bn_y in (xs, ys):
            residual = ys if xs == bn_y else xs
            rv = block._find_var_recursive(residual)
            bv = block._find_var_recursive(bn_y)
            if rv is not None and bv is not None \
                    and rv.shape == bv.shape:
                add, tail = nxt, nxt
    out = tail.outputs.get("Out", [bn_y])[0] if tail is not bn else bn_y
    nxt = _single_fwd_consumer(cons, out, protected, block)
    if nxt is not None and nxt.type == "relu":
        relu, tail = nxt, nxt

    if add is None and relu is None:
        # conv+bn alone: fusing buys nothing the bn lowering doesn't
        # already do — leave it (keeps the rewrite count meaningful)
        return None

    group = [op for op in (conv, bn, add, relu) if op is not None]
    # backward group: all-or-nothing, chained directly
    gops = [grads.get(op.uid) for op in group]
    if any(g is not None for g in gops) and any(g is None for g in gops):
        return None
    has_grads = gops[0] is not None
    if has_grads and not _chain_ok(group, gops):
        return None

    # every reader of a fused-away name must live inside the group:
    # the forward intermediates (grad ops re-read them) and, when
    # grads exist, the intermediate cotangents
    member = set(id(op) for op in group)
    if has_grads:
        member.update(id(g) for g in gops)
    removed = [conv_out]
    if tail is not bn:
        removed.append(bn_y)
    if add is not None and relu is not None:
        removed.append(add.outputs["Out"][0])
    if has_grads:
        by_fwd = dict(zip((op.uid for op in group), gops))
        removed.append(_grad_in(by_fwd[bn.uid], "Y"))
        if add is not None and relu is not None:
            # gadd's GRAD@Out is intermediate only when relu follows;
            # without relu it IS the kept final cotangent
            removed.append(_grad_in(by_fwd[add.uid], "Out"))
        removed.append(_grad_out(by_fwd[bn.uid], "X"))
    for n in removed:
        if not n or n in protected:
            return None
        if any(id(c) not in member for c in cons.get(n, [])):
            return None
    return {"conv": conv, "bn": bn, "add": add, "relu": relu,
            "residual": residual, "group": group,
            "grads": gops if has_grads else []}


def _grad_out(gop, slot):
    return gop.outputs.get("GRAD@" + slot, [None])[0]


def _grad_in(gop, slot):
    return gop.inputs.get("GRAD@" + slot, [None])[0]


def _chain_ok(group, gops):
    """Cotangents must flow op-to-op with no interposed accumulation."""
    by_fwd = dict(zip((op.uid for op in group), gops))
    conv, bn = group[0], group[1]
    add = next((op for op in group if op.type == "elementwise_add"), None)
    relu = next((op for op in group if op.type == "relu"), None)
    gconv, gbn = by_fwd[conv.uid], by_fwd[bn.uid]
    # bn -> conv link
    if _grad_in(gconv, "Output") != _grad_out(gbn, "X") \
            or not _grad_out(gbn, "X"):
        return False
    cursor_out_grad = _grad_in(gbn, "Y")
    if not cursor_out_grad:
        return False
    if add is not None:
        gadd = by_fwd[add.uid]
        bn_side = "X" if add.inputs["X"][0] == bn.outputs["Y"][0] else "Y"
        if _grad_out(gadd, bn_side) != cursor_out_grad:
            return False
        cursor_out_grad = _grad_in(gadd, "Out")
        if not cursor_out_grad:
            return False
    if relu is not None:
        grelu = by_fwd[relu.uid]
        if _grad_out(grelu, "X") != cursor_out_grad:
            return False
        if not _grad_in(grelu, "Out"):
            return False
    return True


def _apply(block, m):
    conv, bn, add, relu = m["conv"], m["bn"], m["add"], m["relu"]
    group, gops = m["group"], m["grads"]
    tail = group[-1]
    final_out = tail.outputs["Out"][0] if tail is not bn \
        else bn.outputs["Y"][0]

    attrs = {
        "strides": conv.attrs.get("strides", [1, 1]),
        "paddings": conv.attrs.get("paddings", [0, 0]),
        "dilations": conv.attrs.get("dilations", [1, 1]),
        "groups": conv.attrs.get("groups", 1),
        # the lowering re-derives depthwise grouping from the input's
        # channel dim, exactly as the unfused op does
        "conv_type": conv.type,
        "data_layout": conv.attrs.get("data_layout", "NCHW"),
        "epsilon": bn.attrs.get("epsilon", 1e-5),
        "momentum": bn.attrs.get("momentum", 0.9),
        "is_test": bn.attrs.get("is_test", False),
        "act": "relu" if relu is not None else None,
        "with_residual": add is not None,
    }
    inputs = {
        "Input": list(conv.inputs["Input"]),
        "Filter": list(conv.inputs["Filter"]),
        "Scale": list(bn.inputs["Scale"]),
        "Bias": list(bn.inputs["Bias"]),
        "Mean": list(bn.inputs["Mean"]),
        "Variance": list(bn.inputs["Variance"]),
    }
    if add is not None:
        inputs["Residual"] = [m["residual"]]
    outputs = {"Out": [final_out]}
    for slot in _BN_STATE:
        n = bn.outputs.get(slot, [None])[0]
        if n:
            outputs[slot] = [n]

    fop = ir.Operator(block, "conv2d_bn_act", inputs, outputs, attrs)
    # RNG/uid stability: the fused op carries no randomness, so a fresh
    # uid is safe; grad ops reference it via fwd_op_uid below.
    # Placement: at the TAIL's index — the residual operand (e.g. the
    # main branch when the matched conv is the shortcut) may only be
    # defined just before the add, and no interloper reads the fused
    # intermediates (verified in _match_from).
    tail_idx = block.ops.index(tail)
    drop = set(id(op) for op in group)
    block.ops[tail_idx] = fop
    block.ops[:] = [op for op in block.ops
                    if id(op) not in drop or op is fop]

    if gops:
        by_fwd = dict(zip((op.uid for op in group), gops))
        gconv, gbn = by_fwd[conv.uid], by_fwd[bn.uid]
        tail_grad = by_fwd[tail.uid]
        gin = {slot: list(ns) for slot, ns in inputs.items()}
        gin["GRAD@Out"] = [_grad_in(tail_grad, "Out" if tail is not bn
                                    else "Y")]
        gout = {
            "GRAD@Input": [_grad_out(gconv, "Input") or ""],
            "GRAD@Filter": [_grad_out(gconv, "Filter") or ""],
            "GRAD@Scale": [_grad_out(gbn, "Scale") or ""],
            "GRAD@Bias": [_grad_out(gbn, "Bias") or ""],
        }
        if add is not None:
            gadd = by_fwd[add.uid]
            res_side = "Y" if add.inputs["X"][0] == bn.outputs["Y"][0] \
                else "X"
            gout["GRAD@Residual"] = [_grad_out(gadd, res_side) or ""]
        gattrs = dict(attrs)
        gattrs["fwd_op_uid"] = fop.uid
        ggop = ir.Operator(block, "conv2d_bn_act_grad", gin, gout,
                           gattrs)
        gfirst = min(block.ops.index(g) for g in gops)
        gdrop = set(id(g) for g in gops)
        block.ops[gfirst] = ggop
        block.ops[:] = [op for op in block.ops
                        if id(op) not in gdrop or op is ggop]
