"""Rematerialization pass: trade backward-pass activation residency for
recompute.

The JAX package's ``passes/remat.py``, analysis for analysis: the pass
reads the built program (forward ops, the ``append_backward``-emitted
grad ops tagged with ``fwd_op_uid``, the optimizer tail) and selects
checkpoint boundaries at the narrow points of the forward dataflow
(between decoder blocks / conv stages exactly one residual-stream
activation is live, so those minima ARE the natural units). Everything
produced inside a segment and consumed only by that segment's forward
and grad ops is re-materialized at backward time from the segment's
boundary instead of being stored across the whole forward->backward
gap: O(layers) activation residency becomes O(segments +
layers/segments) at the cost of ~one extra forward over the segment.

Mechanism (``core/lower.py`` ``run_block``): the pass ships a
:class:`RematPlan` on the transformed program. When ``run_block``
reaches a segment's FIRST grad op it re-runs the segment's forward ops
through the same ``run_op`` with the same TraceContext and rebinds the
internal activations, so dropout draws the same per-(step, uid) mask
and every re-materialized value is bitwise the stored one. Where the
JAX package fences the replay with ``optimization_barrier`` so that XLA
keeps the internals dead across the gap, the eager executor has no
compiler to free them: the plan's ``release`` table names, for each op
uid, the segment-internal values to drop from the environment once that
op has run (after their last forward reader, and after the replay
their last grad reader). Protected (fetched) and persistable names are
never internal, so never dropped.

Policy knob (``PassConfig.remat``): ``"blocks"`` cuts at every minimal
frontier (one segment per decoder block / conv stage), ``"sqrt"`` keeps
~sqrt(k) of those cuts (the classic O(sqrt(n)) memory schedule), an int
asks for that many segments. The activation-bytes ledger
(:func:`activation_ledger`) is pure IR arithmetic and gives the JAX
package's figures for the same program.
"""

import math

import numpy as np

__all__ = ["run", "RematPlan", "Segment", "plan_program", "plan_cuts",
           "activation_ledger"]


class Segment:
    """One checkpoint unit: forward ops ``block.ops[start:end]``."""

    __slots__ = ("idx", "start", "end", "boundary_in", "internal",
                 "trigger_uid", "internal_bytes")

    def __init__(self, idx, start, end):
        self.idx = idx
        self.start = start
        self.end = end              # exclusive
        self.boundary_in = ()       # activation names the barrier fences
        self.internal = ()          # names re-materialized at backward
        self.trigger_uid = -1       # first grad op of this segment
        self.internal_bytes = 0     # ledger: bytes NOT stored fwd->bwd


class RematPlan:
    """What the lowering needs: segments keyed by their backward
    trigger op, the values to drop after each op, plus the byte ledger
    bench.py --memory reports."""

    __slots__ = ("segments", "by_trigger", "policy", "stored_bytes",
                 "saved_bytes", "release")

    def __init__(self, segments, policy, stored_bytes, saved_bytes,
                 release=None):
        self.segments = tuple(segments)
        self.by_trigger = {s.trigger_uid: s for s in segments}
        self.policy = policy
        # op uid -> segment-internal names dropped from the environment
        # once that op has run: the eager executor's counterpart of the
        # JAX replay's optimization barrier
        self.release = dict(release or {})
        # activation-bytes ledger (batch dim symbolic — ratios exact):
        # what still crosses the forward->backward boundary vs what
        # remat stopped storing
        self.stored_bytes = stored_bytes
        self.saved_bytes = saved_bytes

    def describe(self):
        return {"segments": len(self.segments),
                "policy": str(self.policy),
                "stored_activation_bytes": self.stored_bytes,
                "saved_activation_bytes": self.saved_bytes}


def _var_bytes(block, name):
    """Per-sample byte estimate of ``name`` (-1 batch dims count 1 —
    every activation shares the batch factor, so reduction RATIOS are
    exact)."""
    v = block._find_var_recursive(name)
    if v is None or v.shape is None:
        return 0
    n = 1
    for d in v.shape:
        n *= abs(int(d)) if int(d) != 0 else 1
    try:
        item = np.dtype(str(v.dtype)).itemsize
    except TypeError:
        item = 4
    return n * item


def _forward_region(program):
    """Ops of the global block before the first backward op (the
    loss-grad seed or the first ``*_grad``); None when the program has
    no backward (inference: nothing to rematerialize)."""
    from paddle_tpu_torch.core.ir import GRAD_SUFFIX

    ops = program.global_block().ops
    for i, op in enumerate(ops):
        if op.type.endswith("_grad") or "fwd_op_uid" in op.attrs or (
                op.type == "fill_constant"
                and any(n.endswith(GRAD_SUFFIX)
                        for ns in op.outputs.values() for n in ns)):
            return i
    return None


def _dataflow(ops, fwd_end):
    """(produced_at, fwd_writes, consumers) over the global block."""
    produced_at = {}    # name -> LAST producing forward index
    fwd_writes = {}     # name -> all forward write indices
    consumers = {}      # name -> consumer op indices over the whole block
    for i in range(fwd_end):
        for ns in ops[i].outputs.values():
            for n in ns:
                if n:
                    produced_at[n] = i
                    fwd_writes.setdefault(n, []).append(i)
    for i, op in enumerate(ops):
        for ns in op.inputs.values():
            for n in ns:
                if n:
                    consumers.setdefault(n, []).append(i)
    return produced_at, fwd_writes, consumers


def plan_cuts(program, policy, protected=()):
    """Checkpoint cut selection alone: ``([0, c1, ..., fwd_end],
    fwd_end)`` — the forward region's live-activation minima filtered
    by ``policy``, one segment per adjacent boundary pair — or None
    when the program has no usable forward region or no minima.

    Shared with ``parallel.placement.plan_stages``: pipeline stage
    boundaries ARE the same narrow points rematerialization cuts at
    (between decoder blocks / conv stages exactly one residual-stream
    activation is live — the cheapest tensor to store across the
    forward->backward gap, and equally the cheapest to ppermute across
    a stage boundary)."""
    block = program.global_block()
    ops = block.ops
    fwd_end = _forward_region(program)
    if fwd_end is None or fwd_end < 4:
        return None

    persistable = {v.name for v in program.list_vars() if v.persistable}
    keep_names = set(protected) | persistable
    produced_at, fwd_writes, consumers = _dataflow(ops, fwd_end)

    # frontier bytes after a cut between fwd ops i and i+1: op-produced
    # non-persistable names still consumed by a later FORWARD op. One
    # O(ops + names) sweep over per-name live intervals — a name
    # contributes its bytes to every cut position in
    # [produced_at, last_forward_consumer - 1]
    delta = [0] * fwd_end
    for n, p in produced_at.items():
        if n in keep_names:
            continue
        last = max((c for c in consumers.get(n, ()) if c < fwd_end),
                   default=-1)
        if last <= p:
            continue
        b = _var_bytes(block, n)
        delta[p] += b
        delta[last] -= b
    fr, acc = [], 0
    for i in range(fwd_end - 1):
        acc += delta[i]
        fr.append(acc)
    # natural unit boundaries = LOCAL minima of the live-set curve (the
    # last position of a flat/descending run before it rises again):
    # between decoder blocks / conv stages only the residual stream is
    # live, inside them the qkv/ffn intermediates stack up. A median
    # filter drops shallow minima inside wide plateaus (a "minimum"
    # 4x the typical boundary saves little and fences a lot).
    minima = [
        i for i, f in enumerate(fr)
        if f > 0 and (i == 0 or fr[i - 1] >= f)
        and (i == len(fr) - 1 or f < fr[i + 1])]
    if not minima:
        return None
    med = sorted(fr[i] for i in minima)[len(minima) // 2]
    cuts = [i for i in minima if fr[i] <= 2 * med]
    if not cuts:
        return None

    if policy in (True, "auto", "blocks"):
        keep = cuts
    else:
        if policy == "sqrt":
            n_seg = max(2, int(round(math.sqrt(len(cuts) + 1))))
        else:
            n_seg = max(1, int(policy))
        k = n_seg - 1           # cuts wanted
        if k <= 0:
            return None
        if k >= len(cuts):
            keep = cuts
        else:
            stride = len(cuts) / float(k + 1)
            keep = sorted({cuts[min(len(cuts) - 1,
                                    int(round(stride * (j + 1))) - 1)]
                           for j in range(k)})

    return [0] + [c + 1 for c in keep] + [fwd_end], fwd_end


def plan_program(program, policy, protected=()):
    """Segment the global block's forward region. Returns a
    :class:`RematPlan` or None (nothing worth rematerializing)."""
    planned = plan_cuts(program, policy, protected)
    if planned is None:
        return None
    bounds, fwd_end = planned

    block = program.global_block()
    ops = block.ops
    persistable = {v.name for v in program.list_vars() if v.persistable}
    keep_names = set(protected) | persistable
    _, fwd_writes, consumers = _dataflow(ops, fwd_end)

    grad_idx_of = {}    # fwd uid -> grad op block indices
    for i in range(fwd_end, len(ops)):
        u = ops[i].attrs.get("fwd_op_uid")
        if u is not None:
            grad_idx_of.setdefault(u, []).append(i)

    segments, stored, saved = [], 0, 0
    for s in range(len(bounds) - 1):
        seg = Segment(len(segments), bounds[s], bounds[s + 1])
        seg_idx = set(range(seg.start, seg.end))
        gidx = sorted(j for i in seg_idx
                      for j in grad_idx_of.get(ops[i].uid, ()))
        grad_set = set(gidx)

        # boundary reads (read before any within-segment def) and the
        # replay-safety check: a boundary name a LATER forward op
        # overwrites would replay from the wrong (post-write) value.
        # A same-op in-place write (batch-norm's running-stat update
        # reading Mean and writing the same name) is exempt: the
        # overwritten name is persistable, never rebound by the replay
        boundary, produced, unsafe = set(), set(), False
        for i in range(seg.start, seg.end):
            for ns in ops[i].inputs.values():
                for n in ns:
                    if n and n not in produced and n not in boundary:
                        boundary.add(n)
                        if any(w > i for w in fwd_writes.get(n, ())):
                            unsafe = True
            for ns in ops[i].outputs.values():
                produced.update(n for n in ns if n)

        internal, ib, kept = [], 0, 0
        for n in produced:
            cons = consumers.get(n, ())
            needed_bwd = any(c >= fwd_end for c in cons)
            escapes = n in keep_names or any(
                c not in seg_idx and c not in grad_set for c in cons)
            if needed_bwd and any(c in grad_set for c in cons) \
                    and not escapes:
                internal.append(n)
                ib += _var_bytes(block, n)
            elif needed_bwd and n not in persistable:
                kept += _var_bytes(block, n)

        if not internal or not gidx or unsafe:
            stored += kept + ib     # segment stays fully stored
            continue
        seg.internal = tuple(sorted(internal))
        seg.internal_bytes = ib
        seg.boundary_in = tuple(sorted(
            n for n in boundary if n not in persistable))
        seg.trigger_uid = ops[gidx[0]].uid
        stored += kept
        saved += ib
        segments.append(seg)

    if not segments:
        return None
    return RematPlan(segments, policy, stored, saved,
                     _release(ops, fwd_end, segments, consumers))


def _release(ops, fwd_end, segments, consumers):
    """op uid -> the segment-internal names to drop once it has run:
    each internal name after its last forward reader (its producer where
    only grad ops read it) and, once the replay has rebound it, after
    its last reader of all (a grad op of its segment)."""
    last_write = {}
    for i in range(fwd_end):
        for ns in ops[i].outputs.values():
            for n in ns:
                if n:
                    last_write[n] = i
    release = {}
    for seg in segments:
        for n in seg.internal:
            cons = consumers.get(n, ())
            fwd = max([c for c in cons if c < fwd_end] + [last_write[n]])
            for i in (fwd, max(cons)):
                release.setdefault(ops[i].uid, []).append(n)
    return {u: tuple(ns) for u, ns in release.items()}


def activation_ledger(program):
    """(stored_bytes, saved_bytes) the program's CURRENT remat config
    yields — ``(everything, 0)`` when remat is off: the structural
    figure bench.py --memory reports, computed from the IR alone."""
    plan = getattr(program, "_remat_plan", None)
    if plan is not None:
        return plan.stored_bytes, plan.saved_bytes
    probe = plan_program(program, "blocks")
    if probe is None:
        return 0, 0
    return probe.stored_bytes + probe.saved_bytes, 0


def run(program, cfg, protected=()):
    """Pass-pipeline entry: attach the RematPlan to the (cloned)
    program; returns the number of segments planned (the pipeline's
    rewrite count)."""
    policy = getattr(cfg, "remat", None)
    if not policy:
        program._remat_plan = None
        return 0
    plan = plan_program(program, policy, protected)
    program._remat_plan = plan
    return 0 if plan is None else len(plan.segments)
