"""Divergence-safe training: the step guard, dynamic loss scaling, and
the host-side divergence detector.

The JAX package's ``guard.py`` on PyTorch, in the same three layers:

* **The step guard.** The executor's step gains a health summary — the
  loss's finiteness and the global gradient norm — and every state
  tensor the step writes (parameters, optimizer accumulators, batch-norm
  statistics) is chosen between its candidate and its old value by one
  ``torch.where`` on the device (the JAX package's ``lax.cond``): a
  non-finite step applies **no** update, bit for bit, and bumps a skip
  counter. The decision is a device tensor, never read on the host, so
  the same step runs eagerly and inside a captured CUDA graph
  (``core/graphs.py``); the counters and the scale are scope tensors the
  graph updates in place.
* **Dynamic loss scaling** for the ``amp.py`` bf16 policy. The seed of
  the backward (``<loss>@GRAD``) is multiplied by the scale in float32;
  each parameter gradient is unscaled at its final producer (before
  clipping, regularization and the optimizer); the scale halves on
  overflow and grows after ``growth_interval`` clean steps.
* **The divergence detector**: an EMA spike test over the per-step loss
  and gradient norm plus a consecutive-skip counter, run on the host
  over the health rows after a dispatch; sustained divergence raises
  :class:`Divergence`. (The recovery loop that rolls back on it arrives
  with the distributed tier.)

Chaos-testability: ``fault.inject("guard.nonfinite", crash_on_nth=n,
times=t)`` poisons the optimizer-input gradients of logical steps
``n .. n+t-1`` (1-based over the executor's step counter). The window
is read from the fault rules when the executor builds its plan; the step
index it is compared with is a device tensor (set before each replay of
a graph), so the poison fires inside the graph too.

The counters are int64 tensors where the JAX package keeps uint32
(PyTorch has few uint32 ops); their values are the same.

Metrics (``telemetry``): ``paddle_tpu_guard_skipped_steps_total``,
``paddle_tpu_guard_nonfinite_total{location}``,
``paddle_tpu_guard_loss_scale_ratio``,
``paddle_tpu_guard_divergence_total{reason}``.
"""

import fnmatch
import itertools
import warnings

import numpy as np
import torch

from paddle_tpu_torch import fault
from paddle_tpu_torch import telemetry
from paddle_tpu_torch.core.lower import RowSparse, TensorArray

__all__ = ["GuardConfig", "Divergence", "DivergenceDetector",
           "HealthTracker", "enable", "disable", "reset_state",
           "STATE_NAMES", "FAULT_SITE"]

# reserved scope var names of the guard state ("@" keeps them out of
# any layer-generated namespace)
K_SCALE = "guard@loss_scale"
K_GOOD = "guard@good_steps"
K_SKIPPED = "guard@skipped_steps"
STATE_NAMES = (K_SCALE, K_GOOD, K_SKIPPED)

FAULT_SITE = "guard.nonfinite"

# the health row of one step: [K, _H_WIDTH] float32 under run_chunk
_H_LOSS, _H_GNORM, _H_SKIPPED, _H_NF_LOSS, _H_NF_GRAD, _H_SCALE = range(6)
_H_WIDTH = 6

_COUNTER = torch.int64


class Divergence(Exception):
    """The run is diverging (sustained non-finite steps, or a loss /
    grad-norm spike that outlived the detector's patience).
    ``onset_step`` is the detector's estimate of where the divergence
    began: state saved at or after it is diverged even where it reads
    clean by skip count."""

    def __init__(self, reason, step=None, detector=None, stats=None,
                 onset_step=None):
        super().__init__(
            "divergence detected (%s) at step %s%s"
            % (reason, step, ": %s" % (stats,) if stats else ""))
        self.reason = reason
        self.step = step
        self.detector = detector
        self.stats = stats or {}
        self.onset_step = onset_step


class DivergenceDetector:
    """EMA/window spike test over the per-step loss and grad-norm
    series, plus a consecutive-skip counter for sustained non-finite
    steps. Host-side: it consumes the health rows the guard fetches."""

    def __init__(self, spike_factor=10.0, patience=3, warmup=8,
                 ema_alpha=0.1, max_consecutive_skips=8):
        self.spike_factor = float(spike_factor)
        self.patience = int(patience)
        self.warmup = int(warmup)
        self.ema_alpha = float(ema_alpha)
        self.max_consecutive_skips = int(max_consecutive_skips)
        self.reset()

    def reset(self):
        """Forget all history (after a rollback the restored trajectory
        starts clean)."""
        self._ema = {"loss": None, "grad_norm": None}
        self._seen = 0
        self._strikes = {"loss": 0, "grad_norm": 0}
        self._skips = 0

    def observe(self, step, loss, gnorm, skipped):
        """Feed one logical step's health row; raises :class:`Divergence`
        when a spike outlives ``patience`` or ``max_consecutive_skips``
        non-finite steps arrive back-to-back."""
        if skipped:
            self._skips += 1
            if self._skips >= self.max_consecutive_skips:
                self._trip("nonfinite_steps", step,
                           {"consecutive_skips": self._skips},
                           span=self._skips)
            return
        self._skips = 0
        self._seen += 1
        for which, v in (("loss", float(loss)), ("grad_norm", float(gnorm))):
            ema = self._ema[which]
            if (ema is not None and self._seen > self.warmup
                    and np.isfinite(v) and v > self.spike_factor
                    * max(abs(ema), 1e-12)):
                # a striking value is not folded into the EMA: a
                # sustained spike must not drag the baseline up under it
                self._strikes[which] += 1
                if self._strikes[which] >= self.patience:
                    self._trip("%s_spike" % which, step,
                               {"value": v, "ema": ema,
                                "strikes": self._strikes[which]},
                               span=self._strikes[which])
                continue
            self._strikes[which] = 0
            self._ema[which] = v if ema is None else (
                ema + self.ema_alpha * (v - ema))

    def _trip(self, reason, step, stats, span):
        if telemetry.enabled():
            telemetry.record_guard_divergence(reason)
        raise Divergence(reason, step=step, detector=self, stats=stats,
                         onset_step=max(0, step - span + 1))


class GuardConfig:
    """Per-program guard policy, attached as ``program.guard`` by
    :func:`enable`. Its numbers are part of the executor's plan key (via
    :class:`GuardPlan`); the detector is host-side state."""

    _tokens = itertools.count(1)

    def __init__(self, loss, dynamic_loss_scale=False,
                 init_loss_scale=2.0 ** 15, growth_interval=2000,
                 scale_backoff=0.5, scale_growth=2.0, min_loss_scale=1.0,
                 max_loss_scale=2.0 ** 24, divergence=True,
                 spike_factor=10.0, patience=3, warmup=8, ema_alpha=0.1,
                 max_consecutive_skips=8):
        # every enable() is a new config and so a new plan key: a cached
        # plan never keeps consulting a stale detector
        self.token = next(GuardConfig._tokens)
        self.loss_name = loss.name if hasattr(loss, "name") else str(loss)
        self.dynamic_loss_scale = bool(dynamic_loss_scale)
        self.init_loss_scale = float(init_loss_scale)
        self.growth_interval = int(growth_interval)
        self.scale_backoff = float(scale_backoff)
        self.scale_growth = float(scale_growth)
        self.min_loss_scale = float(min_loss_scale)
        self.max_loss_scale = float(max_loss_scale)
        self.detector = DivergenceDetector(
            spike_factor=spike_factor, patience=patience, warmup=warmup,
            ema_alpha=ema_alpha,
            max_consecutive_skips=max_consecutive_skips,
        ) if divergence else None


def enable(program, loss, **kwargs):
    """Arm the training-health guard on ``program``. ``loss`` is the
    loss Variable (or its name) whose finiteness gates every state
    update. Returns the :class:`GuardConfig`."""
    program.guard = GuardConfig(loss, **kwargs)
    return program.guard


def disable(program):
    program.guard = None
    return program


# ---- the plan (consulted when the executor builds a plan) ----


class GuardPlan:
    """The config's numeric policy plus the poison window armed from the
    fault rules. ``key`` is part of the executor's plan key: toggling
    the guard, or arming ``guard.nonfinite``, is a named rebuild, and
    clearing the rule returns to the cached plan."""

    __slots__ = ("config", "poison", "rule")

    def __init__(self, config, poison, rule):
        self.config = config
        self.poison = poison          # (first, last) 1-based inclusive
        self.rule = rule              # the fault.Rule armed, for accounting

    @property
    def state_names(self):
        return STATE_NAMES

    @property
    def key(self):
        c = self.config
        scaling = (c.init_loss_scale, c.growth_interval, c.scale_backoff,
                   c.scale_growth, c.min_loss_scale,
                   c.max_loss_scale) if c.dynamic_loss_scale else None
        # a cleared-and-re-armed rule with the same window must not
        # inherit the old rule's accounting through a cached plan
        return ("guard", c.token, c.loss_name, scaling, self.poison,
                self.rule.uid if self.rule is not None else None)


def plan_for(program):
    """The guard plan of one run, or None when the program is unguarded:
    a few attribute reads, plus a scan of the fault rules while fault
    injection is active."""
    config = getattr(program, "guard", None)
    if config is None:
        return None
    poison, rule = None, None
    if fault.active():
        for r in fault.rules():
            if (r.crash_on_nth is not None and not r._exhausted()
                    and fnmatch.fnmatch(FAULT_SITE, r.pattern)):
                first = int(r.crash_on_nth)
                last = first + int(r.times) - 1 if r.times else 0  # 0=open
                poison, rule = (first, last), r
                break
    return GuardPlan(config, poison, rule)


def prepare_carry(scope, plan, mut_state, extra_writes, device=None):
    """Seed the guard state, add its names to the state the step reads
    (``mut_state``, extended in place), and promote write-only
    persistables that already have a value in ``scope`` into it: the
    skip needs their old value, or a skipped step would still commit
    their update. Returns the rest (which cannot be gated), with a
    warning."""
    ensure_state(scope, plan, device)
    mut_state.extend(n for n in plan.state_names if n not in mut_state)
    promote = [n for n in extra_writes if scope.find_var(n) is not None]
    mut_state.extend(promote)
    rest = [n for n in extra_writes if n not in promote]
    if rest:
        warnings.warn(
            "guard: write-only persistable(s) %s have no value in "
            "scope and CANNOT be gated by the skip decision — initialize "
            "them via the startup program to protect them" % (rest,),
            RuntimeWarning)
    return rest


def _scalar(value, dtype, device):
    return torch.full((), value, dtype=dtype, device=device)


def ensure_state(scope, plan, device=None):
    """Create the guard state in ``scope`` on ``device`` if missing (the
    loss scale starts at ``init_loss_scale`` with dynamic scaling, else
    at a bitwise-inert 1.0).

    The scale is not re-seeded when someone else set it (backed off by
    the guard, restored from a checkpoint), but a change of the config's
    initial scale (scaling armed on a scope that ran the guard without
    it, where the scale sat at 1.0) re-seeds it: the init value each
    scope last saw is remembered on the scope."""
    cfg = plan.config
    init = cfg.init_loss_scale if cfg.dynamic_loss_scale else 1.0
    seen = getattr(scope, "_guard_scale_init", None)
    dev = _device_of(scope, device)
    if scope.find_var(K_SCALE) is None:
        scope.set_var(K_SCALE, _scalar(init, torch.float32, dev))
        scope._guard_scale_init = init
    elif seen is None:
        # external provenance (a restore into a fresh scope): keep the
        # value, track the config from here
        scope._guard_scale_init = init
    elif seen != init:
        scope.set_var(K_SCALE, _scalar(init, torch.float32, dev))
        scope.set_var(K_GOOD, _scalar(0, _COUNTER, dev))
        scope._guard_scale_init = init
    for name in (K_GOOD, K_SKIPPED):
        if scope.find_var(name) is None:
            scope.set_var(name, _scalar(0, _COUNTER, dev))


def _device_of(scope, device):
    if device is not None:
        return torch.device(device)
    v = scope.find_var(K_SCALE)
    return v.device if v is not None else torch.device("cpu")


def reset_state(scope, program=None, device=None):
    """Reset the guard state. With ``program`` (carrying a guard
    config) the values are re-seeded at their initial values, in place
    where the tensors exist (a captured graph keeps reading them).
    Without it, the names are erased; the next guarded step makes them
    again."""
    cfg = getattr(program, "guard", None) if program is not None else None
    if cfg is None:
        for name in STATE_NAMES:
            scope.erase(name)
        scope._guard_scale_init = None
        return
    init = cfg.init_loss_scale if cfg.dynamic_loss_scale else 1.0
    dev = _device_of(scope, device)
    for name, value, dtype in ((K_SCALE, init, torch.float32),
                               (K_GOOD, 0, _COUNTER),
                               (K_SKIPPED, 0, _COUNTER)):
        cur = scope.find_var(name)
        if cur is not None and cur.dtype == dtype and cur.device == dev:
            cur.fill_(value)
        else:
            scope.set_var(name, _scalar(value, dtype, dev))
    scope._guard_scale_init = init


# ---- run-time hooks (carried on TraceContext as ctx.guard) ----


def _grad_final_uids(program):
    """Parameter-gradient name -> uid of its LAST producing op. A shared
    parameter's gradient is accumulated (the first partial takes the
    base ``<p>@GRAD`` name and a later sum re-binds it), so a rewrite at
    every binding would unscale the first partial twice."""
    pg = {g for _, g in getattr(program, "_op_role_vars", ())}
    final = {}
    for op in program.global_block().ops:
        for names in op.outputs.values():
            for n in names:
                if n in pg:
                    final[n] = op.uid
    return final


class TraceGuard:
    """One step's guard: made by the executor, carried through the
    block run as ``TraceContext.guard``. The lowering hooks feed it the
    optimizer-input gradients and the shared clip norm; the executor
    calls :func:`finalize` after the block.

    ``state``: the guard's scope tensors; ``step_idx``: the step index,
    a 0-d int64 tensor on the device (read only when a poison window is
    armed)."""

    __slots__ = ("plan", "state", "step_idx", "scale", "_grads",
                 "_clip_sq", "_clip_covered", "_poisoned",
                 "_seed_name", "_grad_final_uid", "sq_across", "line_sq")

    def __init__(self, plan, state, step_idx, program):
        self.plan = plan
        self.state = state
        self.step_idx = step_idx
        self.scale = state[K_SCALE]
        self._grads = []        # (param name, grad) at optimizer input
        self._clip_sq = None    # global_norm_clip's shared sum of squares
        self._clip_covered = frozenset()
        self._seed_name = plan.config.loss_name + "@GRAD"
        self._grad_final_uid = _grad_final_uids(program)
        # None, or the sum over data-parallel ranks of the recorded
        # gradients' sum of squares: set by the comm layer when each
        # rank records only its rows of the gradients (global-view ZeRO)
        self.sq_across = None
        # None, or the comm layer's sum of squares over whole parameters
        # when the mesh holds some 1/n a rank (the stage and expert axes:
        # ``collectives.TraceComm.line_sq``)
        self.line_sq = None
        if plan.poison is not None:
            first, last = plan.poison
            one_based = step_idx + 1
            p = one_based >= first
            if last:
                p = p & (one_based <= last)
            self._poisoned = p
        else:
            self._poisoned = None

    # -- hooks called from core.lower --

    def before_op(self, op, spec, ins):
        """Ops consuming a ``Grad`` slot against a ``Param`` apply the
        step's gradients: the health summary records them here, after
        the clip, keyed by parameter name (the gradient's own name
        changes through ``@CLIP``/``@REG``)."""
        if not (spec.no_grad and "Grad" in ins and "Param" in ins
                and ins.get("Param")):
            return ins
        pnames = op.inputs.get("Param", ())
        for i, g in enumerate(ins["Grad"]):
            if g is not None:
                self._grads.append(
                    (pnames[i] if i < len(pnames) else "", g))
        return ins

    def rewrite_output(self, name, value, op_uid):
        """The backward's seed (``<loss>@GRAD``) is multiplied by the
        scale; each parameter gradient, at its final producing op (after
        accumulation, before clipping, regularization and the optimizer),
        is poisoned (``guard.nonfinite`` armed) and unscaled."""
        if value is None:
            return value
        scaling = self.plan.config.dynamic_loss_scale
        if scaling and name == self._seed_name:
            return value * self.scale.to(value.dtype)
        if self._grad_final_uid.get(name) == op_uid:
            if self._poisoned is not None:
                value = self._poison(value)
            if scaling:
                value = self._unscale(value)
        return value

    def note_clip_norm(self, sq_norm, param_names):
        """``global_norm_clip`` shares its sum of squares: the health
        norm reuses it and leaves the covered parameters' gradients out
        of its own sum. Accumulates across clip ops."""
        self._clip_sq = sq_norm if self._clip_sq is None \
            else self._clip_sq + sq_norm
        self._clip_covered = self._clip_covered | frozenset(
            n for n in param_names if n)

    # -- internals --

    def _poison(self, g):
        bad = torch.where(self._poisoned, float("nan"), 0.0)
        if isinstance(g, RowSparse):
            return RowSparse(g.rows, g.values + bad.to(g.values.dtype),
                             g.height)
        return g + bad.to(g.dtype)

    def _unscale(self, g):
        inv = 1.0 / self.scale
        if isinstance(g, RowSparse):
            return RowSparse(g.rows, g.values * inv.to(g.values.dtype),
                             g.height)
        return g * inv.to(g.dtype)


def _float_leaves(g):
    """The float tensors of a gradient, as the JAX package's
    ``_float_leaves`` takes a pytree's: a ``RowSparse`` gives its
    values (its int32 rows are not float)."""
    if isinstance(g, RowSparse):
        g = g.values
    return [g] if isinstance(g, torch.Tensor) and g.is_floating_point() \
        else []


def _choose(healthy, cand, old):
    """``torch.where(healthy, cand, old)`` over a state value: a tensor,
    or each tensor of a ``TensorArray``."""
    if isinstance(cand, TensorArray):
        return TensorArray(torch.where(healthy, cand.data, old.data),
                           torch.where(healthy, cand.size, old.size))
    return torch.where(healthy, cand, old)


def finalize(tg, env, old_mut, cand_mut):
    """Close one step: the health summary, the skip (every state tensor
    in both ``old_mut`` and ``cand_mut`` becomes ``torch.where(healthy,
    candidate, old)``: an unhealthy step keeps the old values bit for
    bit) and the guard state's update. Returns ``(new_mut, health)``:
    ``health`` is the step's [6] float32 row on the device."""
    plan = tg.plan
    cfg = plan.config
    if cfg.loss_name not in env:
        raise KeyError(
            "guard.enable() named loss %r but the block never produced "
            "it — pass the loss variable of THIS program" % cfg.loss_name)
    loss = torch.mean(env[cfg.loss_name].to(torch.float32))
    loss_ok = torch.isfinite(loss)

    # one reduction serves the global norm (with global_norm_clip's
    # shared sum of squares) and the finiteness test: a NaN/Inf in any
    # gradient reaches the float32 sum, and a sum that overflows reads
    # as unhealthy too
    pairs = [(name, leaf) for name, g in tg._grads
             if name not in tg._clip_covered for leaf in _float_leaves(g)]
    extra_sq = None
    if tg.line_sq is not None:
        extra_sq = tg.line_sq(pairs)
    elif pairs:
        leaves = [leaf.to(torch.float32).reshape(-1) for _, leaf in pairs]
        flat = leaves[0] if len(leaves) == 1 else torch.cat(leaves)
        extra_sq = torch.dot(flat, flat)
    if extra_sq is None:
        extra_sq = torch.zeros((), dtype=torch.float32, device=loss.device)
    if tg.sq_across is not None:
        extra_sq = tg.sq_across(extra_sq.reshape(1)).reshape(())
    gnorm_sq = extra_sq if tg._clip_sq is None else extra_sq + tg._clip_sq
    gnorm = torch.sqrt(gnorm_sq)
    grads_ok = torch.isfinite(gnorm_sq)
    healthy = loss_ok & grads_ok

    out = dict(cand_mut)
    for n, cand in cand_mut.items():
        old = old_mut.get(n)
        if old is not None and n not in STATE_NAMES and old is not cand:
            out[n] = _choose(healthy, cand, old)

    skipped = (~healthy).to(_COUNTER)
    out[K_SKIPPED] = tg.state[K_SKIPPED] + skipped
    scale, good = tg.state[K_SCALE], tg.state[K_GOOD]
    if cfg.dynamic_loss_scale:
        down = torch.clamp(scale * cfg.scale_backoff,
                           min=cfg.min_loss_scale)
        scale = torch.where(healthy, scale, down)
        good = torch.where(healthy, good + 1, 0)
        grow = healthy & (good >= cfg.growth_interval)
        scale = torch.where(
            grow, torch.clamp(scale * cfg.scale_growth,
                              max=cfg.max_loss_scale), scale)
        good = torch.where(grow, 0, good)
    out[K_SCALE], out[K_GOOD] = scale, good

    f32 = torch.float32
    health = torch.stack([
        loss, gnorm.to(f32), skipped.to(f32), (~loss_ok).to(f32),
        (~grads_ok).to(f32), scale.to(f32)])
    return out, health


# ---- host side: per-dispatch accounting + divergence detection ----


def after_dispatch(plan, program, health, base_step):
    """Consume one dispatch's health rows on the host: the guard
    metrics, the accounting of trace-armed ``guard.nonfinite`` fires
    against their rule, and the divergence detector (which raises
    :class:`Divergence` after the dispatch's state was written back)."""
    h = np.asarray(health, np.float64)
    if h.ndim == 1:
        h = h[None, :]
    skipped = int(np.sum(h[:, _H_SKIPPED] > 0.5))
    if telemetry.enabled():
        telemetry.record_guard_health(
            program, skipped,
            int(np.sum(h[:, _H_NF_LOSS] > 0.5)),
            int(np.sum(h[:, _H_NF_GRAD] > 0.5)),
            float(h[-1, _H_SCALE]))
    if plan.poison is not None and plan.rule is not None:
        first, last = plan.poison
        lo = max(first, base_step + 1)
        hi = base_step + h.shape[0]
        if last:
            hi = min(hi, last)
        fired = max(0, hi - lo + 1)
        if fired:
            fault.note_injected(plan.rule, FAULT_SITE, "nonfinite", fired)
    det = plan.config.detector
    if det is not None:
        for i, row in enumerate(h):
            det.observe(base_step + i, row[_H_LOSS], row[_H_GNORM],
                        row[_H_SKIPPED] > 0.5)


class HealthTracker:
    """The health block of a checkpoint manifest: a generation is CLEAN
    when no step was skipped since the previous :meth:`block`. Reading
    the counter costs one scalar copy to the host."""

    def __init__(self, program, scope):
        self.program = program
        self.scope = scope
        self._base = self._skipped()

    def _skipped(self):
        v = self.scope.find_var(K_SKIPPED)
        return int(v) if v is not None else 0

    def _scale(self):
        v = self.scope.find_var(K_SCALE)
        return float(v) if v is not None else 1.0

    def block(self):
        """{"health": {...}} for the next save; marks the interval since
        the previous call."""
        s = self._skipped()
        clean = s == self._base
        self._base = s
        return {"health": {"clean": bool(clean),
                           "skipped_steps_total": s,
                           "loss_scale": self._scale()}}

    def peek(self):
        """The current health block without advancing the baseline."""
        s = self._skipped()
        return {"health": {"clean": bool(s == self._base),
                           "skipped_steps_total": s,
                           "loss_scale": self._scale()}}

    def resync(self):
        """Re-baseline after a restore (the counter is monotonic and
        survives rollback; only the delta defines cleanliness)."""
        self._base = self._skipped()
