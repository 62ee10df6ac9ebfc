"""NHWC layout pass: whole-program (forward + backward) conversion.

The JAX package's ``passes/layout.py``, rule for rule, so both packages
rewrite a program to the same JSON. The pass runs over the FULL program,
grad ops included, when the executor prepares a transformed clone.
Channels-minor is the layout the batch-norm backward kernel
(``kernels/bn_grad.py``) reads as ``[rows, C]``.

Domain propagation: 4-D image vars enter the NHWC domain at data vars
(``feed_layout="NHWC"``) or at the first convertible op; layout-agnostic
ops extend the domain (a transpose never materializes inside the domain,
it rides the frontier outward); ops with no NHWC story are boundaries
and read NCHW twins. Gradient ops mirror their forward op exactly: the
same attr/input rewrites, with boundary grads re-emitted in the primal's
own domain (a grad produced in a foreign layout is renamed to a twin and
transposed back), so grad accumulation (`sum`) always adds same-layout
contributions. A final elimination sweep cancels inverse transpose
pairs and drops dead ones.

The flatten-equivalence rule makes ResNet-50 fully closed: ``mul`` (fc)
consuming a 4-D input whose spatial dims are 1 flattens [N,1,1,C] and
[N,C,1,1] to the same [N,C] row order, so the global-avg-pool -> fc
head needs NO boundary transpose and a ResNet-50 step carries no layout
copy, forward or backward. A conv->fc flatten at larger spatial size
(LeNet's, at 4x4) is a GENUINE boundary (element order differs per
layout) and keeps exactly one transpose per direction.
"""

from paddle_tpu_torch.core import ir

__all__ = ["run", "redeclare_feeds", "eliminate_transposes",
           "CONVERTIBLE", "AGNOSTIC", "ELEMENTWISE", "DIM_REMAP"]

# ops with a native data_layout=NHWC lowering: type -> (image in slot,
# image out slot)
CONVERTIBLE = {
    "conv2d": ("Input", "Output"),
    "depthwise_conv2d": ("Input", "Output"),
    "batch_norm": ("X", "Y"),
    "pool2d": ("X", "Out"),
}

# image-shape-agnostic ops: outputs follow whatever layout the inputs
# are in; no attr rewrite needed beyond elementwise broadcast-axis and
# reduction-dim fixes. `sum`/`assign` cover append_backward's grad
# accumulation so the backward domain propagates through it.
AGNOSTIC = {
    "relu", "relu6", "sigmoid", "tanh", "sqrt", "abs", "square", "exp",
    "log", "floor", "ceil", "round", "reciprocal", "softplus", "softsign",
    "brelu", "leaky_relu", "soft_relu", "elu", "pow", "stanh", "hard_shrink",
    "thresholded_relu", "hard_sigmoid", "swish", "cast", "scale", "dropout",
    "sum", "assign", "fill_zeros_like", "clip", "pad",
}

ELEMENTWISE = {"elementwise_add", "elementwise_sub", "elementwise_mul",
               "elementwise_div", "elementwise_max", "elementwise_min",
               "elementwise_pow"}

# agnostic ops whose integer dim/axis attrs address NCHW positions and
# must be remapped to NHWC (coverage for the pad / spatial-reduce ops
# the image programs hit): type -> attr name holding dims
DIM_REMAP = {
    "reduce_sum": "dim", "reduce_mean": "dim", "reduce_max": "dim",
    "reduce_min": "dim", "concat": "axis", "split": "axis",
    "squeeze": "axes", "unsqueeze": "axes",
}

_TO_NHWC = (0, 2, 3, 1)
_TO_NCHW = (0, 3, 1, 2)
# NCHW dim index -> NHWC dim index
_DIM_TO_NHWC = {0: 0, 1: 3, 2: 1, 3: 2}


def _perm_shape(shape, to_nhwc=True):
    n, c, h, w = shape if to_nhwc else (shape[0], shape[3], shape[1],
                                        shape[2])
    return tuple([n, h, w, c] if to_nhwc else [n, c, h, w])


def _is4d(var):
    return var is not None and var.shape is not None and len(var.shape) == 4


def redeclare_feeds(program):
    """Re-declare every 4-D data var NHWC (the feed contract under
    ``feed_layout="NHWC"``): the feeder then supplies channels-last
    batches and steady-state steps contain no input transpose."""
    n = 0
    for block in program.blocks:
        for var in block.vars.values():
            if getattr(var, "is_data", False) and _is4d(var) \
                    and not getattr(var, "_nhwc_declared", False):
                var.shape = _perm_shape(var.shape)
                var._nhwc_declared = True
                n += 1
    return n


def run(program, cfg, protected=()):
    """Pipeline entry: rewrite block 0 to NHWC. Returns the rewrite
    count.

    Sub-blocks (control-flow bodies) are left untouched — they read
    block-0 vars by NAME through the traced env, so converting a 4-D
    var they consume would silently hand them channels-last data. When
    that aliasing is possible the pass refuses the whole program
    (warning, zero rewrites) rather than guessing."""
    import warnings

    if len(program.blocks) > 1:
        for b in program.blocks[1:]:
            for op in b.ops:
                for n in op.input_arg_names:
                    v = b._find_var_recursive(n) if n else None
                    if _is4d(v):
                        warnings.warn(
                            "layout pass skipped: sub-block %d reads "
                            "4-D var %r — control-flow bodies are not "
                            "layout-converted" % (b.idx, n),
                            RuntimeWarning)
                        return 0
    if cfg.feed_layout == "NHWC":
        # normally a no-op: passes.enable() re-declared the data vars
        # NHWC at build time (idempotent via the _nhwc_declared flag).
        # A config attached DIRECTLY (program.passes = PassConfig(...))
        # skips enable(), leaving the clone's feed declarations stale
        # NCHW against the NHWC feed contract — the IR verifier flags
        # exactly that as a channel conflict, so fix it here.
        redeclare_feeds(program)
    block = program.global_block()
    rw = _Rewriter(block, cfg.feed_layout)
    n = rw.rewrite()
    n += eliminate_transposes(block, protected=protected)
    program._bump_version()
    return n


class _Rewriter:
    def __init__(self, block, feed_layout):
        self.block = block
        self.feed_layout = feed_layout
        self.nhwc = set()        # var names currently NHWC
        self.flipped = set()     # var names whose DECLARED shape was permuted
        self.twin_cache = {}     # (name, to_nhwc) -> twin name
        # fwd uid -> {(slot, idx): (orig_name, twin_name, twin_is_nhwc)}
        self.subs = {}
        self.rewrites = 0
        self.new_ops = []
        self.post_ops = []  # ops to append right AFTER the current one

    # ---- var bookkeeping ----

    def _mark_nhwc(self, name):
        if name in self.nhwc:
            return
        self.nhwc.add(name)
        v = self.block._find_var_recursive(name)
        if _is4d(v) and name not in self.flipped \
                and not getattr(v, "_nhwc_declared", False):
            v.shape = _perm_shape(v.shape)
            self.flipped.add(name)

    def _transposed(self, name, to_nhwc):
        """NHWC (or NCHW) twin of ``name``, inserting the transpose op
        once (cached — a var crossing the same boundary twice reuses
        its twin)."""
        key = (name, to_nhwc)
        if key in self.twin_cache:
            return self.twin_cache[key]
        src = self.block.var(name)
        tname = name + ("@NHWC" if to_nhwc else "@NCHW")
        self.block.create_var(name=tname,
                              shape=_perm_shape(src.shape, to_nhwc),
                              dtype=src.dtype)
        perm = list(_TO_NHWC if to_nhwc else _TO_NCHW)
        self.new_ops.append(ir.Operator(
            self.block, "transpose", {"X": [name]}, {"Out": [tname]},
            {"axis": perm}))
        self.twin_cache[key] = tname
        if to_nhwc:
            self.nhwc.add(tname)
        self.rewrites += 1
        return tname

    def _substitute(self, op, slot, idx, to_nhwc):
        """Swap op.inputs[slot][idx] for its twin; record it so the
        matching grad op mirrors the substitution."""
        name = op.inputs[slot][idx]
        twin = self._transposed(name, to_nhwc)
        op.inputs[slot][idx] = twin
        self.subs.setdefault(op.uid, {})[(slot, idx)] = (name, twin,
                                                         to_nhwc)

    # ---- main walk ----

    def rewrite(self):
        if self.feed_layout == "NHWC":
            for var in self.block.vars.values():
                if getattr(var, "is_data", False) and _is4d(var):
                    # enable() re-declared the var NHWC at build time
                    self.nhwc.add(var.name)

        for op in self.block.ops:
            base = op.type[:-len("_grad")] if op.type.endswith("_grad") \
                else op.type
            if op.type.endswith("_grad") and (
                    base in CONVERTIBLE or base in AGNOSTIC
                    or base in ELEMENTWISE or base in DIM_REMAP
                    or base == "mul" or op.attrs.get("fwd_op_uid")
                    in self.subs):
                self._rewrite_grad(op, base)
            elif op.type in CONVERTIBLE:
                self._rewrite_convertible(op)
            elif op.type in AGNOSTIC or op.type in ELEMENTWISE \
                    or op.type in DIM_REMAP:
                self._rewrite_agnostic(op)
            elif self._flatten_equivalent(op):
                pass  # consumes [N,1,1,C] == [N,C,1,1] rows; no rewrite
            else:
                self._rewrite_boundary(op)
            self.new_ops.append(op)
            if self.post_ops:
                self.new_ops.extend(self.post_ops)
                del self.post_ops[:]
        self.block.ops[:] = self.new_ops
        return self.rewrites

    def _image_input(self, op, slot):
        names = op.inputs.get(slot, [])
        if not names:
            return None
        v = self.block._find_var_recursive(names[0])
        return names[0] if _is4d(v) else None

    def _rewrite_convertible(self, op):
        slot, out_slot = CONVERTIBLE[op.type]
        x = self._image_input(op, slot)
        if x is None:
            return  # not an image tensor (e.g. batch_norm over fc out)
        if x not in self.nhwc:
            self._substitute(op, slot, 0, to_nhwc=True)
        op.attrs["data_layout"] = "NHWC"
        self.rewrites += 1
        for n in op.outputs.get(out_slot, [])[:1]:
            self._mark_nhwc(n)

    def _rewrite_agnostic(self, op):
        ins = [n for ns in op.inputs.values() for n in ns if n]
        if not any(n in self.nhwc for n in ins):
            return
        for s, ns in op.inputs.items():
            for i, n in enumerate(ns):
                if not n or n in self.nhwc:
                    continue
                v = self.block._find_var_recursive(n)
                if _is4d(v):
                    # pull same-rank stragglers into the domain
                    self._substitute(op, s, i, to_nhwc=True)
                elif op.type in ELEMENTWISE \
                        and op.attrs.get("axis", -1) == 1:
                    # per-channel broadcast operand: C moved 1 -> 3
                    op.attrs["axis"] = 3
                    self.rewrites += 1
        if op.type in DIM_REMAP:
            self._remap_dims(op)
        elif op.type == "pad":
            self._remap_pad(op)
        for ns in op.outputs.values():
            for n in ns:
                if n and _is4d(self.block._find_var_recursive(n)):
                    self._mark_nhwc(n)

    def _remap_dims(self, op, base=None):
        attr = DIM_REMAP[base or op.type]
        dims = op.attrs.get(attr, None)
        if dims is None:
            return
        if isinstance(dims, (list, tuple)):
            op.attrs[attr] = [_DIM_TO_NHWC.get(int(d) % 4, int(d))
                              for d in dims]
        else:
            op.attrs[attr] = _DIM_TO_NHWC.get(int(dims) % 4, int(dims))
        self.rewrites += 1

    def _remap_pad(self, op):
        """``pad``'s flat [lo0, hi0, lo1, hi1, ...] paddings address
        NCHW dims; reorder the pairs to NHWC."""
        p = op.attrs.get("paddings")
        if p is None or len(p) != 8:
            return
        pairs = [p[2 * i:2 * i + 2] for i in range(4)]  # n, c, h, w
        op.attrs["paddings"] = list(pairs[0] + pairs[2] + pairs[3]
                                    + pairs[1])
        self.rewrites += 1

    def _flatten_equivalent(self, op):
        """``mul`` (fc) over a 4-D NHWC input with spatial dims 1:
        [N,1,1,C] and [N,C,1,1] flatten to the same [N,C] rows, so the
        op is layout-transparent — the rule that closes ResNet's
        global-pool -> fc head without a boundary transpose."""
        if op.type != "mul" or op.attrs.get("x_num_col_dims", 1) != 1:
            return False
        x = self._image_input(op, "X")
        if x is None or x not in self.nhwc:
            return False
        shape = self.block.var(x).shape  # NHWC-declared by now
        return shape[1] == 1 and shape[2] == 1

    def _rewrite_boundary(self, op):
        for s, ns in op.inputs.items():
            for i, n in enumerate(ns):
                if n and n in self.nhwc:
                    self._substitute(op, s, i, to_nhwc=False)

    # ---- gradient mirror ----

    def _rewrite_grad(self, op, base):
        fuid = op.attrs.get("fwd_op_uid")
        subs = self.subs.get(fuid, {})

        # 1) forward-input slots mirror the forward op's substitutions
        for (slot, idx), (orig, twin, _) in subs.items():
            names = op.inputs.get(slot)
            if names and idx < len(names) and names[idx] == orig:
                names[idx] = twin

        # 2) attr rewrites mirror the forward class (grad attrs are
        #    independent copies made by append_backward)
        if base in CONVERTIBLE:
            x = self._image_input(op, CONVERTIBLE[base][0])
            if x is None:
                return
            op.attrs["data_layout"] = "NHWC"
            self.rewrites += 1
        elif base in ELEMENTWISE and op.attrs.get("axis", -1) == 1 \
                and self._grad_in_domain(op):
            op.attrs["axis"] = 3
            self.rewrites += 1
        elif base in DIM_REMAP and self._grad_in_domain(op):
            self._remap_dims(op, base)
        elif base == "pad" and self._grad_in_domain(op):
            self._remap_pad(op)

        # 3) cotangent inputs must arrive in the (possibly substituted)
        #    forward OUTPUT's domain; the walk is in block order, so the
        #    producing grad ops upstream have already fixed domains
        for s, ns in op.inputs.items():
            if not s.startswith("GRAD@"):
                continue
            for i, n in enumerate(ns):
                if not n:
                    continue
                v = self.block._find_var_recursive(n)
                if not _is4d(v):
                    continue
                want_nhwc = self._fwd_output_nhwc(op, s[len("GRAD@"):], i)
                have_nhwc = n in self.nhwc
                if want_nhwc != have_nhwc:
                    self._substitute(op, s, i, to_nhwc=want_nhwc)

        # 4) produced grads land in the (substituted) primal's domain;
        #    a grad computed against a twin is renamed and transposed
        #    back so downstream accumulation sees the primal's layout
        for s, ns in list(op.outputs.items()):
            if not s.startswith("GRAD@"):
                continue
            fwd_slot = s[len("GRAD@"):]
            fwd_names = op.inputs.get(fwd_slot, [])
            for i, g in enumerate(ns):
                if not g or i >= len(fwd_names) or not fwd_names[i]:
                    continue
                primal = fwd_names[i]  # already substituted if twinned
                sub = subs.get((fwd_slot, i))
                if sub is not None:
                    # grad materializes in the twin's layout; mirror it
                    # back into the original primal's domain
                    orig, twin, twin_is_nhwc = sub
                    self._mirror_grad_output(op, s, i, g, twin,
                                             twin_is_nhwc)
                elif primal in self.nhwc:
                    self._mark_nhwc(g)

    def _grad_in_domain(self, op):
        return any(n in self.nhwc
                   for ns in op.inputs.values() for n in ns if n)

    def _fwd_output_nhwc(self, op, fwd_slot, idx):
        """Is the forward op's output (whose cotangent this is) NHWC?
        Inferred from the grad op's own class: convertible/agnostic
        forwards produce NHWC outputs iff their image input is NHWC —
        which, after step 1's substitution, is what the forward-slot
        names say."""
        base = op.type[:-len("_grad")]
        if base in CONVERTIBLE:
            x = self._image_input(op, CONVERTIBLE[base][0])
            return x is not None  # convertible fwd was rewritten NHWC
        if base == "mul":
            return False  # fc output is 2-D; cotangent is 2-D too
        # agnostic/elementwise: output follows the image inputs
        for ns in op.inputs.values():
            for n in ns:
                if n and n in self.nhwc:
                    return True
        return False

    def _mirror_grad_output(self, op, slot, idx, gname, twin,
                            twin_is_nhwc):
        """The grad op computes d(twin) (the layout its forward was fed
        in); downstream consumers want d(orig). Rename the output to a
        twin grad and transpose it back right after the op."""
        tgrad = twin + "@GRAD"
        tvar = self.block.var(twin)
        self.block.create_var(name=tgrad, shape=tvar.shape,
                              dtype=tvar.dtype)
        op.outputs[slot][idx] = tgrad
        # back into the primal's domain: invert the forward twin's perm
        perm = list(_TO_NCHW if twin_is_nhwc else _TO_NHWC)
        self.post_ops.append(ir.Operator(
            self.block, "transpose", {"X": [tgrad]}, {"Out": [gname]},
            {"axis": perm}))
        self.rewrites += 1
        if not twin_is_nhwc:
            # primal was NHWC (we fed the op an NCHW twin): the restored
            # grad is NHWC again
            self._mark_nhwc(gname)


def eliminate_transposes(block, protected=()):
    """Cancel inverse transpose pairs and drop dead transposes.

    Pair rule: ``t2 = transpose(t1 = transpose(x, p), q)`` with ``q∘p``
    the identity re-binds every consumer of ``t2`` to ``x`` directly.
    Dead rule: a transpose whose output nothing reads (and which is not
    fetched/persistable) is removed. Returns ops eliminated."""
    protected = frozenset(protected)
    producer = {}
    for op in block.ops:
        for ns in op.outputs.values():
            for n in ns:
                if n:
                    producer[n] = op

    def _perm(op):
        return tuple(int(a) for a in op.attrs.get("axis", ()))

    # cancel inverse pairs
    for op in block.ops:
        if op.type != "transpose":
            continue
        src = op.inputs["X"][0]
        up = producer.get(src)
        if up is None or up.type != "transpose":
            continue
        p, q = _perm(up), _perm(op)
        if len(p) != len(q):
            continue
        if all(q[p[i]] == i for i in range(len(p))):
            orig = up.inputs["X"][0]
            out = op.outputs["Out"][0]
            if out in protected:
                continue
            for c in block.ops:
                if c is op:
                    continue
                for ns in c.inputs.values():
                    for i, n in enumerate(ns):
                        if n == out:
                            ns[i] = orig
            # re-bind: nothing reads `out` now; the dead sweep drops it

    # dead sweep (iterate to fixpoint: removing t2 may strand t1)
    removed = 0
    while True:
        read = set()
        for op in block.ops:
            for ns in op.inputs.values():
                read.update(n for n in ns if n)
        dead = [op for op in block.ops
                if op.type == "transpose"
                and op.outputs["Out"][0] not in read
                and op.outputs["Out"][0] not in protected
                and not getattr(
                    block._find_var_recursive(op.outputs["Out"][0]),
                    "persistable", False)]
        if not dead:
            break
        dead_set = set(id(op) for op in dead)
        block.ops[:] = [op for op in block.ops
                        if id(op) not in dead_set]
        removed += len(dead)
    return removed
