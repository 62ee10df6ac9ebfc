"""Autodiff as a program transform.

Capability parity: `python/paddle/fluid/backward.py:425` (append_backward) —
walk ops in reverse, emit per-op grad ops, accumulate repeated gradients,
respect stop_gradient / no_grad_set. A grad op's lowering defaults to
autograd of the forward lowering (``registry.generic_grad``), so this
transform covers every registered op. It is the JAX package's transform,
op for op, so both packages emit the same program.

Grad op encoding (consumed by ``lower._run_generic_grad_op``):
  type    = "<fwd_type>_grad"
  inputs  = forward inputs under their original slots
            + "GRAD@<out_slot>" cotangent slots ('' name = no grad flows)
  outputs = "GRAD@<in_slot>" per differentiable forward input
            ('' name = gradient not needed)
  attrs   = forward attrs + fwd_op_uid (the same random draws on recompute)

After an op's grad consumes the cotangent of an output name, the
accumulator for that name is reset, so an in-place output (a name that
is also an input) accumulates its pre-update gradient separately.

Control-flow ops (``scan_block``, ``while``, ``conditional_block``)
are functional, as in the JAX package: their ``X``/``Init``/``Params``
are ordinary differentiable inputs and their sub-block is not walked
here; their grad ops differentiate the whole loop or branch. A
``while`` that gets a grad op is stamped ``differentiable=True`` here,
so its forward and its grad run the same bounded masked loop.
"""

from paddle_tpu_torch.core import ir, registry
from paddle_tpu_torch.core.ir import grad_var_name

__all__ = ["append_backward", "calc_gradient"]


def _collect_relevant_ops(block, loss_name, stop_vars):
    """Indices of ops on a path from some differentiable source to the loss."""
    needed = {loss_name}
    relevant = []
    for i in range(len(block.ops) - 1, -1, -1):
        op = block.ops[i]
        spec = registry.REGISTRY.get(op.type)
        if spec is not None and spec.no_grad:
            continue
        if any(n in needed for n in op.output_arg_names):
            relevant.append(i)
            for n in op.input_arg_names:
                if n not in stop_vars:
                    needed.add(n)
    return list(reversed(relevant)), needed


def _stop_var_set(block, no_grad_set):
    stop = set(no_grad_set or ())
    for v in block.program.list_vars():
        if v.stop_gradient or (v.is_data and v.lod_level == 0 and
                               not _is_float(v.dtype)):
            stop.add(v.name)
    # outputs of no_grad ops are gradient barriers (masks, metrics):
    # nothing upstream of them receives gradient through them
    for op in block.ops:
        spec = registry.REGISTRY.get(op.type)
        if spec is not None and spec.no_grad:
            stop.update(n for n in op.output_arg_names if n)
    return stop


def _is_float(dtype):
    return str(dtype).startswith(("float", "bfloat"))


def append_backward(loss, parameter_list=None, no_grad_set=None):
    """Append gradient ops computing d(loss)/d(param) for every trainable
    parameter; returns [(param_var, grad_var)]."""
    block = loss.block
    stop = _stop_var_set(block, no_grad_set)

    relevant, needed = _collect_relevant_ops(block, loss.name, stop)
    relevant_set = set(relevant)

    # all names ever produced by an op in this block, kept current as grad
    # ops are appended
    used_names = set()
    for op in block.ops:
        used_names.update(op.output_arg_names)

    # grad contributions: var name -> list of grad var names to be summed
    contribs = {}
    # var name -> its grad var, once materialized: an activation's
    # gradient is consumed (its contributions reset) by its producer's
    # grad op, and calc_gradient may still ask for it
    materialized = {}

    def add_contrib(var_name, grad_name):
        contribs.setdefault(var_name, []).append(grad_name)

    def materialize_grad(var_name):
        """Combine accumulated contributions into THE grad var for var_name
        (reference _addup_repetitive_outputs_, backward.py:117)."""
        c = contribs.get(var_name, [])
        if not c:
            return None
        gname = grad_var_name(var_name)
        materialized[var_name] = gname
        if len(c) == 1:
            if c[0] != gname:
                block.append_op("assign", {"X": [c[0]]}, {"Out": [gname]})
                used_names.add(gname)
                _mk_grad_var(block, gname, var_name)
            return gname
        block.append_op("sum", {"X": list(c)}, {"Out": [gname]})
        used_names.add(gname)
        _mk_grad_var(block, gname, var_name)
        contribs[var_name] = [gname]
        return gname

    # seed: d loss / d loss = 1
    loss_grad = grad_var_name(loss.name)
    block.append_op(
        "fill_constant",
        {},
        {"Out": [loss_grad]},
        {"shape": list(loss.shape or ()), "dtype": loss.dtype, "value": 1.0},
    )
    _mk_grad_var(block, loss_grad, loss.name)
    add_contrib(loss.name, loss_grad)

    n_fwd_ops = len(block.ops)
    for i in range(n_fwd_ops - 1, -1, -1):
        if i not in relevant_set:
            continue
        op = block.ops[i]
        spec = registry.REGISTRY.get(op.type)
        if spec is None or spec.no_grad:
            continue

        # cotangents for this op's outputs
        grad_in = {}
        any_out_grad = False
        for slot, names in op.outputs.items():
            gs = []
            for n in names:
                g = materialize_grad(n)
                gs.append(g if g is not None else "")
                any_out_grad = any_out_grad or g is not None
            grad_in["GRAD@" + slot] = gs
        if not any_out_grad:
            continue
        # the cotangents are consumed by this grad op; reset the
        # accumulators so an in-place output starts a fresh accumulation
        for names in op.outputs.values():
            for n in names:
                if n:
                    contribs[n] = []

        # which input grads do we need?
        grad_out = {}
        produced = []
        handed_out = set()
        for slot, names in op.inputs.items():
            if slot in spec.nondiff_inputs:
                continue
            outs = []
            want_any = False
            for n in names:
                if n in stop or n not in needed:
                    outs.append("")
                else:
                    tmp = _unique_grad_name(block, n,
                                            used_names | handed_out)
                    handed_out.add(tmp)
                    used_names.add(tmp)
                    outs.append(tmp)
                    produced.append((n, tmp))
                    want_any = True
            if want_any:
                grad_out["GRAD@" + slot] = outs
        if not grad_out:
            continue

        if op.type == "while":
            # both directions run the bounded masked loop: reverse mode
            # needs it (ops/control_flow_ops.py)
            op.attrs["differentiable"] = True
        ins = {slot: list(names) for slot, names in op.inputs.items()}
        ins.update(grad_in)
        attrs = dict(op.attrs)
        attrs["fwd_op_uid"] = op.uid
        block.append_op(op.type + "_grad", ins, grad_out, attrs)
        for var_name, gname in produced:
            _mk_grad_var(block, gname, var_name)
            add_contrib(var_name, gname)

    # finalize parameter grads
    params = (parameter_list if parameter_list is not None
              else [p.name for p in block.all_parameters() if p.trainable])
    params_grads = []
    for pname in params:
        if isinstance(pname, ir.Variable):
            pname = pname.name
        # an activation's gradient (calc_gradient) was materialized when
        # its producer's grad op consumed it; the JAX package raises
        # here (ROADMAP Queue 3)
        g = materialize_grad(pname) or materialized.get(pname)
        if g is None:
            if pname in needed and pname not in stop:
                raise RuntimeError(
                    "append_backward: parameter %r is consumed on the path "
                    "to the loss but received no gradient — a "
                    "non-differentiable (no_grad) op is in the way, or a "
                    "While loop lacks max_iters. Add the parameter to "
                    "no_grad_set to silence intentionally." % pname)
            continue
        params_grads.append((block.program.global_block().var(pname),
                             block.var(g)))
    block.program._op_role_vars = [(p.name, g.name) for p, g in params_grads]
    return params_grads


def calc_gradient(targets, inputs, target_gradients=None, no_grad_set=None):
    """Gradients of `targets` w.r.t. arbitrary `inputs`
    (reference backward.py:555), as the JAX package writes it: one
    target, whose ``append_backward`` takes ``inputs`` as its parameter
    list. Returns the grad variables (``<input>@GRAD``), None for an
    input that gets no gradient. An input an op produces (an activation)
    gets its gradient here; the JAX package's ``append_backward``
    raises for one (ROADMAP Queue 3), so its programs are compared on
    inputs no op produces."""
    targets = targets if isinstance(targets, (list, tuple)) else [targets]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    assert len(targets) == 1, "calc_gradient currently supports one target"
    loss = targets[0]
    block = loss.block
    names = [v.name if isinstance(v, ir.Variable) else v for v in inputs]
    append_backward(loss, parameter_list=names, no_grad_set=no_grad_set)
    outs = []
    for n in names:
        g = grad_var_name(n)
        outs.append(block.var(g) if block.has_var(g) else None)
    return outs


def _unique_grad_name(block, var_name, used):
    """Deterministic per-program rename suffix (probing the block and the
    used set, not a process-global counter), so generated programs are
    reproducible across build order."""
    base = grad_var_name(var_name)
    if not block.has_var(base) and base not in used:
        return base
    i = 1
    while True:
        cand = "%s@RENAME@%d" % (base, i)
        if not block.has_var(cand) and cand not in used:
            return cand
        i += 1


def _mk_grad_var(block, gname, fwd_name):
    if block.has_var(gname):
        return block.var(gname)
    fwd = block.var(fwd_name) if block.has_var(fwd_name) else None
    return block.create_var(
        name=gname,
        shape=fwd.shape if fwd is not None else None,
        dtype=fwd.dtype if fwd is not None else "float32",
        lod_level=fwd.lod_level if fwd is not None else 0,
        type=fwd.type if fwd is not None else ir.VarType.DENSE,
    )
