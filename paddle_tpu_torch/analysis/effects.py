"""Effect analysis: state write-back legality and comm-plan coverage.

Copied from the JAX package. Its executor donates the mutable state
carry end-to-end and its comm layer rewires gradient reductions; both
are effect systems the structural verifier cannot see from one op at a
time. The port writes state back to the scope instead of donating it,
and the same contracts hold there. The comm-plan, 'mp' and stage
checks have no caller in the port until its parallel executor lands
(ROADMAP Queue 1 item 4). This module checks the whole-program
contracts:

* fed-and-written aliasing is the structural pass's ``feed-overwrite``
  check (verifier.py): the executor classifies such a name as a feed,
  so the write never reaches the state write-back and silently
  vanishes with the donated buffer.
* ``persistable-decl`` (shared with the structural pass) — persistables
  outside the global block miss the carry.
* write-only persistables under a guard: :func:`check_write_set`
  mirrors ``guard.prepare_carry``'s promotion rule — a written-never-
  read persistable with no scope value cannot be gated by the skip
  decision (surfaced as the same RuntimeWarning, not an error, because
  the startup program usually runs later in the same session).
* ``comm-plan`` — bucket coverage: every parameter gradient in exactly
  one bucket, every bucket member a real (param, grad) pair of the
  program; under ZeRO-1, every bucketed parameter's optimizer op has a
  shard plan whose accumulators are scope-backed ``optimizer_state_for``
  vars and whose shard geometry is self-consistent.
* ``mp-collective`` / ``mp-consumer`` — tensor-parallel placement
  legality (:func:`check_mp_placement`): every 'mp'-sharded weight is
  consumed by the mul/matmul Megatron pair that places its closing
  collective, and the static weight-locality walk (the compile-time
  mirror of ``TraceComm._mp_after_op``) proves no op outside the safe
  set ever reads an 'mp'-local shard.
* ``pp-stage-gap`` — pipeline stage boundaries
  (:func:`check_stage_plan`) cover the forward region contiguously:
  no op orphaned between stages, no empty stage.
"""

import warnings

from paddle_tpu_torch.analysis.verifier import VerifyError

__all__ = ["check_write_set", "check_comm_plan", "check_mp_placement",
           "check_stage_plan"]


def _reads_writes(program):
    reads, writes = set(), set()
    for b in program.blocks:
        for op in b.ops:
            reads.update(n for n in op.input_arg_names if n)
            writes.update(n for n in op.output_arg_names if n)
    return reads, writes


def check_write_set(program, feed_names=(), scope_names=None):
    """Write-set effect checks (fed-and-written aliasing is the
    structural pass's ``feed-overwrite`` — it runs first and covers a
    superset of that condition)."""
    reads, writes = _reads_writes(program)
    b0 = program.global_block()

    if getattr(program, "guard", None) is not None \
            and scope_names is not None:
        scope_names = set(scope_names)
        for n in writes - reads:
            v = b0.vars.get(n)
            if v is not None and getattr(v, "persistable", False) \
                    and n not in scope_names:
                warnings.warn(
                    "analysis: write-only persistable %r has no value "
                    "in scope — the guard's skip decision cannot gate "
                    "it (guard.prepare_carry will warn again at "
                    "compile); initialize it via the startup program"
                    % n, RuntimeWarning)


def check_comm_plan(plan, program):
    """Comm-plan legality against the program it was built from.
    (A grad-less program can never reach here through ``plan_for`` —
    ``CommPlan.__init__`` already raises its own typed ValueError for
    that, so there is no duplicate guard.)"""
    grads = {g: p for p, g in getattr(program, "_op_role_vars", ())}
    seen = {}
    for b in plan.buckets:
        for p, g in b.grads:
            if g in seen:
                raise VerifyError(
                    "comm-plan",
                    "gradient is a member of buckets %d and %d — each "
                    "grad must be reduced exactly once"
                    % (seen[g], b.idx), var=g)
            seen[g] = b.idx
            if grads.get(g) != p:
                raise VerifyError(
                    "comm-plan",
                    "bucket %d pairs gradient with parameter %r but "
                    "the program's grad map says %r"
                    % (b.idx, p, grads.get(g)), var=g)
    missing = sorted(set(grads) - set(seen))
    if missing:
        raise VerifyError(
            "comm-plan",
            "parameter gradients %s are covered by no bucket — their "
            "reduction would silently never happen" % missing,
            var=missing[0])

    if plan.config.zero_stage:
        _check_zero(plan, program)


# ops that preserve 'mp' shard layout (the static twin of
# TraceComm._MP_SAFE — keep the two in sync)
_MP_SAFE = frozenset((
    "elementwise_add", "elementwise_mul", "elementwise_sub",
    "relu", "gelu", "tanh", "sigmoid", "square", "dropout", "scale",
    "cast", "sum", "reshape", "reshape2", "transpose", "transpose2",
    "concat", "split", "fused_attention"))


def check_mp_placement(plan, program):
    """Tensor-parallel placement legality: a static walk of the program
    mirroring the trace-time weight-locality analysis. Two check
    classes, each a typed VerifyError naming the 'mp' axis:

    * ``mp-collective`` — an 'mp'-sharded col/row weight never reaches
      a mul/matmul as its weight operand, so the Megatron pair that
      places (or elides) its closing collective never runs; the shard
      would leak out un-reduced.
    * ``mp-consumer`` — an op outside the shard-preserving safe set
      reads an 'mp'-local value (e.g. layer_norm over a split hidden
      dim); its math would silently mix per-device shards.
    """
    local = set(plan.mp_params) | set(plan.mp_state)
    closed_by = set()   # col/row params seen as a matmul weight
    for block in program.blocks:
        for op in block.ops:
            t = op.type
            grad = t.endswith("_grad")
            base = t[: -len("_grad")] if grad else t
            if base in ("mul", "matmul"):
                y = (op.inputs.get("Y") or (None,))[0]
                kind = plan.mp_params.get(y)
                if kind == "row":
                    closed_by.add(y)
                    if not grad:
                        # the fwd all-reduce closes the split here
                        local.difference_update(op.outputs.get("Out", ()))
                    else:
                        for slot in ("GRAD@X", "GRAD@Y"):
                            local.update(
                                n for n in op.outputs.get(slot, ()) if n)
                    continue
                if kind == "col":
                    closed_by.add(y)
                    if not grad:
                        local.update(n for n in op.outputs.get("Out", ())
                                     if n)
                    else:
                        # GRAD@X is all-reduced at trace time; GRAD@Y
                        # stays the exact column shard
                        local.update(n for n in op.outputs.get(
                            "GRAD@Y", ()) if n)
                    continue
            reads = sorted({n for names in op.inputs.values()
                            for n in names if n and n in local})
            if not reads:
                continue
            pnames = op.inputs.get("Param")
            if pnames and pnames[0] in plan.mp_params:
                # sharded optimizer update: param/moment outputs alias
                # names already local; scalar beta-pow carries stay
                # replicated
                continue
            if base in _MP_SAFE:
                for names in op.outputs.values():
                    local.update(n for n in names if n)
                continue
            raise VerifyError(
                "mp-consumer",
                "op consumes 'mp'-axis local value(s) %s but is outside "
                "the shard-preserving safe set — its math would mix "
                "per-device shards; close the split with a row-split "
                "projection first" % reads[:4], op=op, var=reads[0])
    for p, kind in sorted(plan.mp_params.items()):
        if kind in ("col", "row") and p not in closed_by:
            raise VerifyError(
                "mp-collective",
                "'mp'-sharded %s-split parameter %r never reaches a "
                "mul/matmul weight operand — the Megatron pair that "
                "places its closing 'mp' collective never runs, so its "
                "shards would leak un-reduced" % (kind, p), var=p)


def check_stage_plan(bounds, fwd_end, program=None):
    """Pipeline stage coverage: ``bounds`` (the remat-derived cut
    points, ``len == num_stages + 1``) must tile the forward region
    ``[0, fwd_end)`` exactly — monotone, gap-free, no empty stage."""
    bounds = list(bounds)
    if not bounds or bounds[0] != 0:
        raise VerifyError(
            "pp-stage-gap",
            "stage boundaries %r do not start at op 0 — ops [0, %d) "
            "belong to no stage" % (bounds, bounds[0] if bounds else 0))
    if bounds[-1] != fwd_end:
        raise VerifyError(
            "pp-stage-gap",
            "stage boundaries %r end at op %d but the forward region "
            "ends at %d — ops [%d, %d) are orphaned between the last "
            "stage and the backward"
            % (bounds, bounds[-1], fwd_end, min(bounds[-1], fwd_end),
               max(bounds[-1], fwd_end)))
    for i in range(1, len(bounds)):
        if bounds[i] <= bounds[i - 1]:
            raise VerifyError(
                "pp-stage-gap",
                "stage %d is empty or inverted: boundaries %r must be "
                "strictly increasing" % (i - 1, bounds))


def _check_zero(plan, program):
    block = program.global_block()
    updates_by_param = {}
    for uid, zu in plan.zero_updates.items():
        updates_by_param[zu.param] = zu
        if not (0 <= zu.bucket < len(plan.buckets)):
            raise VerifyError(
                "comm-plan",
                "ZeRO update for parameter %r names bucket %d but the "
                "plan has %d" % (zu.param, zu.bucket,
                                 len(plan.buckets)), var=zu.param)
        b = plan.buckets[zu.bucket]
        if zu.off + zu.rows > b.shard_len:
            raise VerifyError(
                "comm-plan",
                "ZeRO shard [%d, %d) of parameter %r overruns bucket "
                "%d's shard length %d"
                % (zu.off, zu.off + zu.rows, zu.param, b.idx,
                   b.shard_len), var=zu.param)
        for slot, name in zu.shard_ins.items():
            v = block._find_var_recursive(name)
            if v is None or getattr(v, "optimizer_state_for", None) \
                    != zu.param:
                raise VerifyError(
                    "comm-plan",
                    "ZeRO shard accumulator (slot %r) is not an "
                    "optimizer_state_for-tagged var of parameter %r — "
                    "the sharded update would touch foreign state"
                    % (slot, zu.param), var=name)
    for b in plan.buckets:
        for p, g in b.grads:
            if p not in updates_by_param:
                raise VerifyError(
                    "comm-plan",
                    "ZeRO-1 plan has no sharded optimizer update for "
                    "bucketed parameter %r — its shard would be "
                    "reduce-scattered and then never applied" % p,
                    var=p)
        if b.rows and sum(b.rows) != b.shard_len:
            raise VerifyError(
                "comm-plan",
                "bucket %d's per-param rows sum to %d but shard_len is "
                "%d" % (b.idx, sum(b.rows), b.shard_len))
