"""Static program analysis: IR verifier + shape/dtype inference.

The JAX package's ``analysis`` package, copied: pure Python over the
port's IR (``core/ir.py``), registry and remat plan. The pass pipeline
rewrites hot programs between build time and the eager run; this
package proves each rewritten program well-formed BEFORE it runs, so a
pass-pipeline bug is a loud, typed :class:`VerifyError` naming the
op/block/var (and the pass, when the pipeline's post-condition hook
caught it) instead of a torch error deep in a lowering, or a silent
miscompile. The check slugs and messages are the JAX package's, word
for word.

Wiring:

* ``passes.apply`` re-verifies after EACH pipeline stage;
* ``Executor._plan`` verifies the final program on every plan MISS,
  with the feed signature, and again the first time a plan meets a new
  (feed signature, fetch names, scope): a plan hit with a call it has
  seen pays nothing;
* ``cost.py`` (no JAX counterpart) counts a step's flops and bytes from
  the shapes this package infers (``Executor.cost_analysis``).

All of it sits behind ``FLAGS_verify_ir`` (default ON). The flag is
deliberately NOT part of any plan key or recompile-detector signature:
flipping it never builds a plan or captures a graph (tested).

Every verification is counted: :func:`stats` keeps the runs, failures
and host seconds for the process (``reset_stats`` zeroes them), and
with ``telemetry.enable()`` the same figures go to the telemetry
counters the JAX package keeps.
"""

import time

from paddle_tpu_torch import flags as _flags
from paddle_tpu_torch import telemetry
from paddle_tpu_torch.analysis import effects, schemas, shapes, verifier
from paddle_tpu_torch.analysis.shapes import Info, Sym, infer_program
from paddle_tpu_torch.analysis.verifier import VerifyError

__all__ = ["VerifyError", "verify", "verify_prepared", "enabled",
           "feed_info", "Info", "Sym", "infer_program", "stats",
           "reset_stats"]

# runs, failures, host seconds of every verification in the process
_STATS = {"runs": 0, "failures": 0, "seconds": 0.0}


def stats():
    """{"runs", "failures", "seconds"}: every verification since import
    (or :func:`reset_stats`), whether or not telemetry is on."""
    return dict(_STATS)


def reset_stats():
    _STATS.update(runs=0, failures=0, seconds=0.0)


def enabled():
    """One dict lookup: is static verification armed?"""
    return _flags._flags.get("FLAGS_verify_ir", False)


def feed_info(value, chunk=None):
    """:class:`Info` of one concrete feed value; ``chunk`` strips the
    leading [K, ...] super-batch axis ``run_chunk`` stacks. PackedSeq
    and unshaped values return None (opaque to static checking)."""
    shape = getattr(value, "shape", None)
    if shape is None or hasattr(value, "lengths"):
        return None
    shape = tuple(int(d) for d in shape)
    if chunk is not None and shape:
        shape = shape[1:]
    dtype = getattr(value, "dtype", None)
    # a torch dtype prints as "torch.float32": keep the numpy name the
    # dtype rules read
    return Info(shape, str(dtype).replace("torch.", "")
                if dtype is not None else None)


def _check_feed_signature(program, feed_infos):
    """Feed values against the declared data-var contract: ranks must
    agree and every concrete declared dim must match — the check that
    turns an NHWC/NCHW feed mix-up into a typed error naming the var
    instead of a shape error deep in a lowering."""
    for name, info in feed_infos.items():
        if info is None:
            continue
        var = None
        for b in program.blocks:
            if b.has_var_local(name):
                var = b.vars[name]
                break
        if var is None or var.shape is None \
                or getattr(var, "lod_level", 0):
            continue
        decl = tuple(int(d) for d in var.shape)
        fed = info.shape
        if len(fed) == len(decl):
            for i, (d, f) in enumerate(zip(decl, fed)):
                if d != -1 and int(d) != int(f):
                    raise VerifyError(
                        "feed-signature",
                        "fed shape %s does not match the declared %s "
                        "at dim %d — a channels-last/channels-first "
                        "mix-up looks exactly like this"
                        % (list(fed), list(decl), i), var=name)
            continue
        # rank mismatch: legal when the element count still lines up
        # (reference LoD feeding tolerates un-flattened batches — the
        # consuming op reshapes; e.g. a [B,1,28,28] image fed to a
        # [-1,784] mlp input). Only a provable count conflict fails.
        if any(d == -1 for d in decl[1:]):
            continue
        want = 1
        for d in decl[1:]:
            want *= d
        got_batchless = got = 1
        for i, f in enumerate(fed):
            got *= int(f)
            if i:
                got_batchless *= int(f)
        if got_batchless != want and got != want:
            raise VerifyError(
                "feed-signature",
                "fed shape %s (rank %d) carries %d elements per row "
                "but the data var declares %s (%d per row) — neither "
                "batch alignment reconciles the ranks"
                % (list(fed), len(fed), got_batchless, list(decl),
                   want), var=name)


def verify(program, fetch_names=(), scope_names=None, feed_infos=None,
           pass_name=None):
    """Full static verification of ``program``: structure, effects,
    shape/dtype inference, and (when ``feed_infos`` is given) the feed
    signature. Raises :class:`VerifyError`; returns the inferred
    {name: Info} env on success. Every run and failure is counted
    with its host seconds (:func:`stats`, and telemetry when it is on),
    whatever the outcome."""
    t0 = time.perf_counter()
    schemas.install()
    try:
        verifier.verify_structure(
            program, fetch_names=fetch_names, scope_names=scope_names,
            feed_names=tuple(feed_infos or ()))
        effects.check_write_set(program,
                                feed_names=tuple(feed_infos or ()),
                                scope_names=scope_names)
        if feed_infos:
            _check_feed_signature(program, feed_infos)
        env = shapes.infer_program(program, feed_infos=feed_infos)
    except VerifyError as e:
        if pass_name is not None and e.pass_name is None:
            e.set_pass(pass_name)
        _record(t0, failed=True)
        raise
    _record(t0, failed=False)
    return env


def verify_prepared(program, feed_vals=None, fetch_names=(), scope=None,
                    chunk=None):
    """The executor's plan-miss hook: verify the FINAL (post-pass)
    program against the concrete call — scope-resident state widens the
    def-before-use set, feed values pin the feed signature."""
    scope_names = _scope_names(scope) if scope is not None else None
    feed_infos = {n: feed_info(v, chunk=chunk)
                  for n, v in (feed_vals or {}).items()}
    return verify(program, fetch_names=fetch_names,
                  scope_names=scope_names, feed_infos=feed_infos)


def _scope_names(scope):
    names = set()
    s = scope
    while s is not None:
        names.update(n for n, v in s.vars.items() if v is not None)
        s = getattr(s, "parent", None)
    return names


def _record(t0, failed):
    seconds = time.perf_counter() - t0
    _STATS["runs"] += 1
    _STATS["failures"] += int(failed)
    _STATS["seconds"] += seconds
    if not telemetry.enabled():
        return
    telemetry.counter(
        "paddle_tpu_analysis_verify_runs_total",
        "IR verifier runs (plan misses, new feed signatures and "
        "pipeline stages only — steady-state plan hits never "
        "verify)").inc()
    if failed:
        telemetry.counter(
            "paddle_tpu_analysis_verify_failures_total",
            "IR verifications that raised a typed VerifyError").inc()
    telemetry.histogram(
        "paddle_tpu_analysis_verify_seconds",
        "walltime of one full verification (structure + effects + "
        "shape inference)").observe(seconds)
