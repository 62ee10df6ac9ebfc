"""Structural IR verification: prove a Program well-formed before it runs.

The JAX package's verifier, copied over the port's IR. The pass
pipeline (layout, epilogue, reductions, kernels, remat) rewrites
programs between build time and the eager run; a bad rewrite would
surface as a torch error deep in a lowering at best and a silent
miscompile at worst. Every check raises a typed :class:`VerifyError`
naming the check class, the op (type + uid), the block, and the
offending var, with the JAX package's slugs and messages.

Two rules differ from the JAX package's, both for ``write_to_array``,
which writes INTO its tensor array (``Out`` is its ``Array`` input):

* the first write of an array reads its ``Array`` input before anything
  defines it, and the port's run allocates the array there
  (``core/lower.py`` reads an unwritten tensor array as None). The JAX
  verifier refuses that program as ``def-before-use``; this one accepts
  that one read.
* a write into a FED tensor array updates the array the step carries
  to its fetches (the port donates no feed buffer). The JAX verifier
  refuses it as ``feed-overwrite``; this one accepts it. Any other op
  that writes a fed data var is still refused.

Check classes:

* ``undeclared-var`` — an op references a name no reachable block
  declares (a rewrite renamed a var and forgot the declaration).
* ``def-before-use`` — block-0 op reads a name produced only later (a
  rewrite reordered or deleted the producer). Sub-blocks get the
  relaxed form (control-flow lowerings bind loop carries into the env
  themselves): only never-defined names are flagged.
* ``op-registry`` — the op type has no registered lowering (and is not
  a generic ``*_grad`` of one).
* ``attr-schema`` — an op attr fails its registered schema (type /
  enum; ``core.registry.attr_schema``).
* ``grad-link`` — ``fwd_op_uid`` names no op in the program, names an
  op of the wrong type, or a grad op's ``GRAD@<slot>`` wiring doesn't
  match its forward op's slots.
* ``sub-block`` — a control-flow op's ``*block_id`` attr names a block
  the program does not have (a rewrite dropped the sub-block).
* ``uid-unique`` — two ops share a uid (breaks RNG streams and every
  fwd/grad link).
* ``persistable-decl`` — a persistable var declared outside the global
  block (it would miss the donated state carry).
* ``feed-overwrite`` — an op writes a ``is_data`` var (the write would
  alias a donated feed buffer and silently vanish).
* ``fetch-reachability`` — a fetch name nothing produces or declares.
* ``remat-plan`` — an attached RematPlan references ops outside its
  segment range or internal vars the segment never produces (the
  "segment referencing a freed var" class).
"""

import numpy as np

from paddle_tpu_torch.core import registry
from paddle_tpu_torch.core.ir import VarType

__all__ = ["VerifyError", "verify_structure", "verify_remat_plan"]


class VerifyError(Exception):
    """Typed verification failure. ``check`` is the check-class slug;
    ``op_type``/``op_uid``/``block_idx``/``var`` locate the defect;
    ``pass_name`` is set by the pipeline post-condition hook when the
    failing program came out of a specific pass."""

    def __init__(self, check, message, op=None, block=None, var=None,
                 pass_name=None):
        self.check = check
        self.message = message
        self.op_type = getattr(op, "type", None)
        self.op_uid = getattr(op, "uid", None)
        self.block_idx = getattr(block, "idx", None)
        self.var = var
        self.pass_name = pass_name
        super().__init__(self._format(message))

    def set_pass(self, pass_name):
        """Attribute this failure to the pipeline stage that produced
        the program (the post-condition hook calls this)."""
        self.pass_name = pass_name
        self.args = (self._format(self.message),)
        return self

    def _format(self, message):
        where = []
        if self.op_type is not None:
            where.append("op '%s' (uid %s)" % (self.op_type, self.op_uid))
        if self.block_idx is not None:
            where.append("block %d" % self.block_idx)
        if self.var is not None:
            where.append("var %r" % self.var)
        head = "[%s]" % self.check
        if self.pass_name:
            head += " after pass '%s'" % self.pass_name
        if where:
            head += " " + ", ".join(where)
        return "%s: %s" % (head, message)


def _sub_block_ids(op):
    """Sub-block indices an op's attrs reference (the executor's
    convention: attrs ending ``block_id`` / ``block_ids``)."""
    ids = []
    for k, v in op.attrs.items():
        if k.endswith("block_id") and isinstance(v, int):
            ids.append(v)
        if k.endswith("block_ids") and isinstance(v, (list, tuple)):
            ids.extend(int(x) for x in v)
    return ids


def _declared(block, name):
    return block._find_var_recursive(name)


def _is_known_type(op_type):
    if registry.has(op_type):
        return True
    return (op_type.endswith("_grad")
            and registry.has(op_type[:-len("_grad")]))


def verify_structure(program, fetch_names=(), scope_names=None,
                     feed_names=()):
    """Structural verification of every block. ``scope_names`` (a set,
    or None = unknown) widens the read-before-write set with
    state the executor would resolve from the scope; ``feed_names``
    are additionally available and write-protected."""
    scope_names = set(scope_names or ())
    feed_names = set(feed_names or ())

    # ---- program-wide indices ----
    ops_by_uid = {}
    for b in program.blocks:
        for op in b.ops:
            if op.uid in ops_by_uid:
                raise VerifyError(
                    "uid-unique",
                    "uid %d is shared with op '%s' in block %d — op uids "
                    "must be program-unique (RNG streams and fwd/grad "
                    "links key on them)"
                    % (op.uid, ops_by_uid[op.uid][0].type,
                       ops_by_uid[op.uid][1].idx),
                    op=op, block=b)
            ops_by_uid[op.uid] = (op, b)

    # persistables live in the global block (the executor's donated
    # state carry enumerates block-0 vars only)
    gb = program.global_block()
    for b in program.blocks[1:]:
        for v in b.vars.values():
            if getattr(v, "persistable", False) and \
                    not gb.has_var_local(v.name):
                raise VerifyError(
                    "persistable-decl",
                    "persistable var is declared only in sub-block %d — "
                    "it would miss the executor's donated state carry; "
                    "declare it in the global block" % b.idx,
                    block=b, var=v.name)

    # sub-block ownership: block idx -> index of the owning op in its
    # parent block (for def-before-use positioning)
    owner_pos = {}
    for b in program.blocks:
        for i, op in enumerate(b.ops):
            for sid in _sub_block_ids(op):
                if sid < 0 or sid >= len(program.blocks):
                    raise VerifyError(
                        "sub-block",
                        "references sub-block %d but the program has "
                        "only %d blocks" % (sid, len(program.blocks)),
                        op=op, block=b)
                owner_pos.setdefault(sid, (b.idx, i))

    # ---- per-block checks ----
    for b in program.blocks:
        _verify_block(program, b, ops_by_uid, owner_pos, scope_names,
                      feed_names)

    # ---- fetch reachability ----
    b0_produced = set()
    for op in gb.ops:
        b0_produced.update(n for ns in op.outputs.values() for n in ns
                           if n)
    for name in fetch_names:
        if name in b0_produced or name in feed_names \
                or name in scope_names:
            continue
        v = _declared(gb, name)
        if v is not None and (getattr(v, "persistable", False)
                              or getattr(v, "is_data", False)):
            continue
        raise VerifyError(
            "fetch-reachability",
            "fetch target is never produced by a global-block op and "
            "is neither a feed, a persistable, nor in scope",
            block=gb, var=name)

    verify_remat_plan(program)


def _base_available(program, block, scope_names, feed_names):
    """Names available to a block before any of its ops run: feeds,
    data vars, persistables, and scope-resident state — resolved over
    the block's parent chain."""
    avail = set(feed_names) | set(scope_names)
    bb = block
    while bb is not None:
        for name, v in bb.vars.items():
            if getattr(v, "is_data", False) \
                    or getattr(v, "persistable", False):
                avail.add(name)
        bb = bb.parent_block
    return avail


def _verify_block(program, block, ops_by_uid, owner_pos, scope_names,
                  feed_names):
    strict = block.idx == 0
    avail = _base_available(program, block, scope_names, feed_names)
    # names the parent chain produces BEFORE this block's owning op
    # (sub-block reads resolve against the env at the owner's position)
    if not strict and block.idx in owner_pos:
        pidx, pos = owner_pos[block.idx]
        parent = program.block(pidx)
        for op in parent.ops[:pos]:
            avail.update(n for ns in op.outputs.values() for n in ns
                         if n)

    for op in block.ops:
        if not _is_known_type(op.type):
            raise VerifyError(
                "op-registry",
                "no lowering is registered for this op type (and it is "
                "not a *_grad of a registered forward)",
                op=op, block=block)
        _verify_attrs(op, block)
        _verify_grad_link(op, block, ops_by_uid)

        for slot, names in op.inputs.items():
            for n in names:
                if not n:
                    continue
                if _declared(block, n) is None:
                    raise VerifyError(
                        "undeclared-var",
                        "input slot %r reads a name no reachable block "
                        "declares" % slot, op=op, block=block, var=n)
                if n in avail:
                    continue
                if strict and not _allocating_read(op, slot, block, n):
                    raise VerifyError(
                        "def-before-use",
                        "input slot %r is read before any definition — "
                        "not a feed, not persistable, not in scope, and "
                        "no earlier op produces it" % slot,
                        op=op, block=block, var=n)
                # sub-blocks are exempt from ordering: control-flow
                # lowerings (scan/while/recurrent) bind loop carries,
                # memories, and step slices into the env themselves, so
                # a declared-but-never-produced name is legal there —
                # the undeclared-var check above still applies

        for slot, names in op.outputs.items():
            for n in names:
                if not n:
                    continue
                v = _declared(block, n)
                if v is None:
                    raise VerifyError(
                        "undeclared-var",
                        "output slot %r writes a name no reachable "
                        "block declares" % slot,
                        op=op, block=block, var=n)
                if getattr(v, "is_data", False) and n in feed_names \
                        and not _array_write_in_place(op, slot, n):
                    raise VerifyError(
                        "feed-overwrite",
                        "output slot %r overwrites fed data var — the "
                        "write aliases a donated feed buffer and is "
                        "silently dropped by the state carry" % slot,
                        op=op, block=block, var=n)
                avail.add(n)


def _allocating_read(op, slot, block, name):
    """The one read the port allows before a definition: the ``Array``
    input of a ``write_to_array`` on a tensor array no op has written
    yet, which that write allocates (module docstring)."""
    if op.type != "write_to_array" or slot != "Array":
        return False
    v = _declared(block, name)
    return v is not None and v.type == VarType.TENSOR_ARRAY


def _array_write_in_place(op, slot, name):
    """A ``write_to_array`` writing into its own ``Array`` input (module
    docstring: the port accepts it on a fed tensor array)."""
    return (op.type == "write_to_array" and slot == "Out"
            and name in op.inputs.get("Array", ()))


def _verify_attrs(op, block):
    """Validate op attrs against the registry-held schema (types and
    enumerations of attrs that are PRESENT; absent attrs default in the
    lowering and are never required here). Grad types resolve through
    their forward's schema inside ``registry.attr_schema``."""
    schema = registry.attr_schema(op.type)
    if not schema:
        return
    for name, rule in schema.items():
        if name not in op.attrs:
            continue
        val = op.attrs[name]
        ok, want = _attr_ok(val, rule)
        if not ok:
            raise VerifyError(
                "attr-schema",
                "attr %r = %r fails its schema (expected %s)"
                % (name, val, want), op=op, block=block)


def _attr_ok(val, rule):
    """(ok, expected-description) for one attr against one schema rule:
    a type, a tuple of types, a set/frozenset enumeration, or a
    predicate callable."""
    if val is None:
        return True, ""  # None = "unset" everywhere in the lowerings
    if isinstance(rule, (set, frozenset)):
        return val in rule, "one of %s" % sorted(rule, key=str)
    if isinstance(rule, tuple) and all(isinstance(t, type) for t in rule):
        want = " or ".join(t.__name__ for t in rule)
        if isinstance(val, bool) and bool not in rule:
            return False, want  # bool passes isinstance(int) but an
            # int-typed attr fed True is almost always a slot mix-up
        return isinstance(val, rule), want
    if isinstance(rule, type):
        if rule is int:
            # bools are ints in python; an int-typed attr fed True is
            # almost always a slot mix-up. numpy integers count as int.
            return (isinstance(val, (int, np.integer))
                    and not isinstance(val, bool)), "int"
        if rule is float:
            return isinstance(val, (int, float, np.floating,
                                    np.integer)) \
                and not isinstance(val, bool), "float"
        return isinstance(val, rule), rule.__name__
    if callable(rule):
        try:
            return bool(rule(val)), getattr(rule, "__doc__", "") \
                or "predicate"
        except Exception:
            return False, "predicate"
    return True, ""


def _verify_grad_link(op, block, ops_by_uid):
    fuid = op.attrs.get("fwd_op_uid")
    if fuid is None:
        return
    if not isinstance(fuid, int) or fuid not in ops_by_uid:
        raise VerifyError(
            "grad-link",
            "fwd_op_uid=%r names no op in the program — the grad op's "
            "forward was removed or renumbered by a rewrite" % (fuid,),
            op=op, block=block)
    fwd, _fb = ops_by_uid[fuid]
    if op.type.endswith("_grad"):
        base = op.type[:-len("_grad")]
        if fwd.type != base:
            raise VerifyError(
                "grad-link",
                "fwd_op_uid=%d resolves to op '%s', not the expected "
                "forward '%s'" % (fuid, fwd.type, base),
                op=op, block=block)
        # GRAD@<slot> wiring must match the forward op's slots
        for slot in op.inputs:
            if slot.startswith("GRAD@") \
                    and slot[len("GRAD@"):] not in fwd.outputs:
                raise VerifyError(
                    "grad-link",
                    "cotangent slot %r names no output slot of its "
                    "forward op" % slot, op=op, block=block)
        for slot in op.outputs:
            if slot.startswith("GRAD@") \
                    and slot[len("GRAD@"):] not in fwd.inputs:
                raise VerifyError(
                    "grad-link",
                    "grad output slot %r names no input slot of its "
                    "forward op" % slot, op=op, block=block)


def verify_remat_plan(program):
    """Validate an attached RematPlan (passes/remat.py): segments must
    reference real op ranges, their triggers must be grad ops that
    still exist, and every internal (re-materialized) name must be
    produced INSIDE its segment — an internal produced elsewhere means
    the replay would rebind a var from the wrong (freed) value."""
    plan = getattr(program, "_remat_plan", None)
    if plan is None:
        return
    block = program.global_block()
    ops = block.ops
    uids = {op.uid for op in ops}
    for seg in plan.segments:
        if not (0 <= seg.start < seg.end <= len(ops)):
            raise VerifyError(
                "remat-plan",
                "segment %d spans ops [%d, %d) but the block has %d "
                "ops" % (seg.idx, seg.start, seg.end, len(ops)),
                block=block)
        if seg.trigger_uid not in uids:
            raise VerifyError(
                "remat-plan",
                "segment %d's trigger uid %d names no op in the block"
                % (seg.idx, seg.trigger_uid), block=block)
        produced = set()
        for i in range(seg.start, seg.end):
            produced.update(n for ns in ops[i].outputs.values()
                            for n in ns if n)
        for n in seg.internal:
            if n not in produced:
                raise VerifyError(
                    "remat-plan",
                    "segment %d re-materializes a var its forward ops "
                    "[%d, %d) never produce — the replay would read a "
                    "freed value" % (seg.idx, seg.start, seg.end),
                    block=block, var=n)
        for n in seg.boundary_in:
            v = block._find_var_recursive(n)
            if v is None:
                raise VerifyError(
                    "remat-plan",
                    "segment %d fences a boundary var no block "
                    "declares" % seg.idx, block=block, var=n)
