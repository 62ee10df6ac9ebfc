"""Numeric debug guard: ``FLAGS_check_nan_inf`` as a device-side check.

Capability parity: the reference executor scans every op's outputs
after it runs and throws on NaN/Inf (`framework/executor.cc:27,341-349`).
The JAX package traces ``checkify`` checks into its compiled step and
throws after it. The port's design keeps that contract without a host
read per op:

* **On the device.** With the guard on, the lowering (``core/lower.py``
  ``run_op``) hands every float output of every op (the float tensors
  inside a ``PackedSeq``, ``TensorArray`` or ``RowSparse`` too) to the
  step's :class:`NanCheck`, which records ``(output name, op type,
  uid)`` on the host and keeps ``isfinite(t).all()``: a 0-d device
  bool, two small kernels and no synchronisation. Ops inside sub-blocks
  (``While``, ``conditional_block``, ``DynamicRNN``, a remat replay)
  run through the same ``run_op`` and are checked in the order they
  run, every iteration; generic grad outputs are not checked, as in the
  JAX package's lowering.
* **One slot a step.** At the end of the step :meth:`NanCheck.slot`
  folds the flags into one 0-d int64 on the device: the index of the
  first record in execution order whose tensor holds a NaN or an Inf
  (``argmin`` of the stacked flags, the first minimum), or -1. The slot
  is the step's trailing result, after a guarded plan's health row.
* **Capturable.** All of it is device work with no host read, so it
  runs inside ``run_chunk``'s CUDA graphs (``core/graphs.py``): each
  replay writes its own step's slot, stacked ``[K]`` with the other
  results, and the capture keeps its records.
* **The raise comes after the step.** The executor reads the slots once
  a run or a chunk, only with the guard on, after the state is written
  back to the scope and a guarded plan's health rows are queued. It
  raises :class:`NanInfError`, whose text is the JAX package's
  (``"NaN/Inf in output %r of op '%s' (uid %d)"``; a chunk adds its
  failing step).
* **Read only.** The check never changes a value, so a clean step's
  results are bitwise those of the same step with the guard off.

The flag is part of the executor's plan key (``nan_guard`` in the miss
signature): a flip builds one named plan, and flipping back finds the
old one.

This is the opt-in DEBUG tier (per-op attribution, step-fatal). The
always-on PRODUCTION tier is ``guard.py``: one health summary per step,
non-finite steps skipped on the device instead of killing the run.
"""

import torch

from paddle_tpu_torch import telemetry

__all__ = ["set_check_nan_inf", "check_nan_inf_enabled", "guard_outputs",
           "NanCheck", "NanInfError", "first_failure"]

_CHECK_NAN_INF = False


def set_check_nan_inf(enabled):
    """Enable/disable the per-op NaN/Inf guard for subsequently PLANNED
    programs (the executor's plans are keyed on this flag)."""
    global _CHECK_NAN_INF
    _CHECK_NAN_INF = bool(enabled)


def check_nan_inf_enabled():
    return _CHECK_NAN_INF


class NanInfError(RuntimeError):
    """The first op of a step whose output held a NaN or an Inf.
    ``step``: the step index of a ``run_chunk`` dispatch's failing step
    (None for ``run``)."""

    def __init__(self, name, op_type, uid, step=None, chunk_step=None):
        self.var, self.op_type, self.op_uid = name, op_type, uid
        self.step = step
        msg = "NaN/Inf in output %r of op '%s' (uid %d)" % (
            name, op_type, uid)
        if step is not None:
            msg += " at step %d (step %d of the chunk)" % (step, chunk_step)
        super().__init__(msg)


def _float_tensors(v):
    """The float tensors of one bound value: a tensor, or the payload of
    a PackedSeq / TensorArray (``data``) or a RowSparse (``values``)."""
    for t in (v, getattr(v, "data", None), getattr(v, "values", None)):
        if isinstance(t, torch.Tensor):
            return [t] if t.is_floating_point() else []
    return None


class NanCheck:
    """One step's NaN/Inf checks (module docstring). ``records`` is the
    host's list of (output name, op type, uid), one entry per checked
    tensor in execution order; the device flags follow it."""

    def __init__(self):
        self.records = []
        self._ok = []

    def check(self, op, updates):
        """Check each float tensor of ``updates`` ([(name, value)]),
        the outputs ``op`` just bound."""
        guard_outputs(op, updates, self)

    def slot(self, device):
        """0-d int64 on ``device``: the index into ``records`` of the
        first tensor that held a NaN or an Inf, or -1."""
        if not self._ok:
            return torch.full((), -1, dtype=torch.int64, device=device)
        ok = torch.stack(self._ok)
        return torch.where(ok.all(), -1, torch.argmin(ok.to(torch.uint8)))


def guard_outputs(op, env_updates, check):
    """Record a device-side finiteness flag for each float output of
    ``op`` (``env_updates``: [(name, value)]) into ``check``, the step's
    :class:`NanCheck` (the JAX package's emits ``checkify`` checks into
    the traced step instead)."""
    for name, v in env_updates:
        ts = _float_tensors(v)
        if ts is None:
            # a value with no tensor the guard can read: count the
            # skip, as the JAX package counts an unflattenable output
            if telemetry.enabled():
                telemetry.record_debug_unflattenable(op.type)
            continue
        for t in ts:
            check._ok.append(torch.isfinite(t).all())
            check.records.append((name, op.type, op.uid))


def first_failure(slots, records):
    """``(step, record)`` of the first step whose slot names a failing
    record, or None. ``slots``: the dispatch's slot tensor (0-d for a
    run, ``[K]`` for a chunk); ``records``: each step's record list.
    This is the one host read of the guard a dispatch."""
    for i, v in enumerate(slots.reshape(-1).tolist()):
        if v >= 0:
            return i, records[i][v]
    return None
