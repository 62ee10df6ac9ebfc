"""Preemption-safe training loop: catch, restore, resume.

The JAX package's ``distributed/recovery.py`` on the port: the same
loops, exception classes, forensics records and metrics, over the
port's sharded checkpoints, guard and ``ParallelExecutor``. Where it
differs (one process a rank, over ``torch.distributed``):

* every live rank of the world runs the loop (its ``process_index`` and
  ``num_processes`` default to the default process group's rank and
  size); a restore waits at a barrier until every rank's last save is
  merged, so all ranks resume from one generation;
* the elastic rebuild (``make_mesh`` makes process groups, a call every
  rank of the default group must issue in the same order) runs after the
  state snapshot, not beside it on a thread, and the in-memory reshard
  exchanges the ranks' pieces over the default group; a rank the new
  mesh leaves out joins every rebuild and reshard and runs no step;
* a rank that died cannot rejoin in-process (gloo and NCCL abort the
  communicator): the job ends, and a new one at the new world
  (``init_multihost``) restores the sharded generation onto its mesh.

The reference's fluid trainer survived pod churn because the Go master
re-leased its tasks and the pserver reloaded CRC-verified checkpoints
(go/pserver/service.go:175 LoadCheckpoint); the trainer process itself
was disposable. On a cluster the unit of failure is often the whole job —
a maintenance preemption kills every host at once — so the equivalent
contract is a *training-loop wrapper*: run the step function, checkpoint
on an interval, and when a preemption lands (a real SIGTERM, or an
injected ``fault.FaultInjected`` from the chaos harness), restore the
newest checkpoint generation that passes verification and resume with
the step counter intact.

What counts as a preemption is deliberately narrow: ``Preemption`` (the
signal-driven kind) and ``fault.FaultInjected`` (the test-driven kind).
A genuine bug in the step function — shape error, NaN guard, OOM — must
propagate, not loop forever against a checkpoint that will never get
past it. ``max_restarts`` bounds even legitimate churn.

``guard.Divergence`` is the third survivable class, with DIFFERENT
restore semantics: a diverged run has been dutifully checkpointing its
own garbage, and those generations verify clean (CRC sees bits, not
math). The loop therefore restores the newest generation whose manifest
``health`` block is clean and that predates ``Divergence.onset_step`` —
quarantining the newer diverged ones (reason ``diverged``) and writing
a ``divergence-*.json`` forensics record — bounded by
``max_rollbacks``. Manifest health blocks come from ``health_fn``
(defaulting to the guard's ``HealthTracker`` whenever the program
carries a guard config). ``onset_step`` is expressed in the executor's
logical-step domain: drive the executor with the loop's step numbers
(``run_chunk(step0=step)`` / ``run(step0=step)``, and the startup
program on a separate executor) — the same alignment RNG-stable resume
already requires — or the onset bound will compare skewed step numbers
against manifest steps.

Recovery semantics (see RELIABILITY.md):

* Steps are numbered from 0; ``step_fn(step)`` runs, THEN the manager
  checkpoints that step (subject to its save interval). A generation
  with ``manifest["step"] == s`` therefore proves step ``s`` completed,
  and restore resumes at ``s + 1``.
* Restore delegates corruption handling to the sharded-checkpoint tier:
  a torn/bit-rotted generation is quarantined and the previous complete
  one is used (``latest_sharded_checkpoint``). No usable generation ⇒
  resume from ``start_step`` — the cold-start the job began with.
* Each preemption increments ``paddle_tpu_recovery_preemptions_total``;
  each restore sets ``paddle_tpu_recovery_resume_step_count``.
"""

import contextlib
import json
import os
import signal
import threading
import time
import warnings

import numpy as np
import torch.distributed as dist

from paddle_tpu_torch import fault
from paddle_tpu_torch import guard as guard_lib
from paddle_tpu_torch import telemetry
from paddle_tpu_torch import tracing
from paddle_tpu_torch.distributed.sharded_checkpoint import (
    ShardedCheckpointManager, _persistable_names, _world,
    latest_sharded_checkpoint, load_sharded_checkpoint, reshard_state,
    save_sharded_checkpoint, snapshot_state)

__all__ = ["Preemption", "Reshard", "RecoveryLoop", "ElasticRecoveryLoop",
           "train_with_recovery", "raise_on_sigterm"]


class Preemption(Exception):
    """The scheduler is taking the slice back (SIGTERM on Borg/GKE,
    maintenance events). Raise it from a step function or
    let ``raise_on_sigterm`` convert the signal."""


class Reshard(Exception):
    """The worker set changed and the program must be re-lowered for a
    new device count. The third survivable control-flow class next to
    ``Preemption`` and ``Divergence`` — raise it from a step function
    when a mid-chunk signal (a collective failing with a peer gone, an
    RPC to a lost worker) makes finishing the chunk on the old world
    impossible. ``ElasticRecoveryLoop`` catches it, rebuilds for the
    new membership, restores the newest checkpoint generation ONTO the
    new layout, and resumes at the last chunk boundary — losing at most
    the interrupted chunk. A plain ``RecoveryLoop`` re-raises it (a
    fixed-world loop cannot reshard).

    The cooperative path — membership epoch moved, nothing broken —
    never raises: the elastic loop notices between chunks and hands the
    state over in memory, losing nothing."""

    def __init__(self, reason="membership changed", epoch=None,
                 members=None):
        super().__init__("reshard required (%s): epoch=%s" % (reason,
                                                              epoch))
        self.reason = reason
        self.epoch = epoch
        self.members = members


#: exception classes the loop treats as survivable preemptions
PREEMPTION_ERRORS = (Preemption, fault.FaultInjected)

#: exception classes the loop treats as divergence — recovered by
#: rolling back to the newest generation whose health block was CLEAN
#: (not merely the newest verified one), bounded by ``max_rollbacks``
ROLLBACK_ERRORS = (guard_lib.Divergence,)

#: exception classes the elastic loop treats as a mid-chunk reshard
#: demand (a plain RecoveryLoop re-raises them)
RESHARD_ERRORS = (Reshard,)


@contextlib.contextmanager
def raise_on_sigterm():
    """Convert SIGTERM into ``Preemption`` in the main thread for the
    duration of the block (no-op off the main thread, where signal
    handlers cannot be installed)."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return
    prev = signal.getsignal(signal.SIGTERM)

    def handler(signum, frame):
        raise Preemption("SIGTERM")

    signal.signal(signal.SIGTERM, handler)
    try:
        yield
    finally:
        signal.signal(signal.SIGTERM, prev)


def _barrier():
    """Every rank of a world of more than one waits here (a shared
    directory's generation is merged by rank 0 after the others'
    partials)."""
    if _world()[1] > 1:
        dist.barrier()


def _raise_if_any(err):
    """Raise ``err``, or, across a world of more than one rank, an error
    naming the rank that failed when any did (every rank calls it)."""
    world = _world()[1]
    if world > 1:
        flags = [None] * world
        dist.all_gather_object(flags, None if err is None
                               else "%s: %s" % (type(err).__name__, err))
        bad = [(r, f) for r, f in enumerate(flags) if f is not None]
        if bad and err is None:
            err = RuntimeError("rank %d failed: %s" % bad[0])
    if err is not None:
        raise err


class RecoveryLoop:
    """Drives ``step_fn`` under checkpoint/restore supervision.

    ``target_shardings`` maps var name -> ``mesh.Sharding`` for the
    restoring mesh (``ParallelExecutor.state_shardings``); ``{}``
    restores whole values. A caller-provided ``manager`` overrides
    ``dirname`` / ``save_interval_steps`` (e.g. to share one manager with
    manual saves). ``num_processes`` None: the default process group's
    size, and then its rank is the ``process_index`` (one rank alone
    without one). ``place``: where a restored value goes when the scope
    does not hold it yet (default ``CUDAPlace(0)``; values the scope
    holds stay on their device)."""

    def __init__(self, dirname, scope, program, target_shardings=None,
                 manager=None, save_interval_steps=1, max_restarts=8,
                 process_index=0, overlap_writes=False, max_rollbacks=2,
                 health_fn=None, num_processes=None, place=None):
        self.scope = scope
        self.program = program
        self.target_shardings = target_shardings or {}
        if num_processes is None:
            rank, num_processes = _world()
            if num_processes > 1:
                process_index = rank
        self.manager = manager or ShardedCheckpointManager(
            dirname, save_interval_steps=save_interval_steps,
            process_index=process_index, num_processes=num_processes,
            place=place)
        self.max_restarts = max_restarts
        self.restarts = 0
        # divergence rollbacks (guard.Divergence): restore the newest
        # generation whose health block was CLEAN, at most max_rollbacks
        # times — a run that keeps diverging from every healthy restore
        # point has a bug, not bad luck
        self.max_rollbacks = max_rollbacks
        self.rollbacks = 0
        self.last_divergence = None
        # health_fn() -> extra_meta dict merged into each generation's
        # manifest ({"health": {...}}); defaults to the guard's tracker
        # when the program carries a guard config, so manifests record
        # whether the checkpointed interval skipped any step
        self._tracker = None
        if health_fn is None and getattr(program, "guard", None) is not None:
            self._tracker = guard_lib.HealthTracker(program, scope)
            health_fn = self._tracker.block
        self.health_fn = health_fn
        # False (default): join each save before advancing — a completed
        # step is durably checkpointed, so where recovery resumes is a
        # deterministic function of the step counter. True: overlap
        # write N with step N+1 (manager.poll() still surfaces failures,
        # at most one step late) — higher throughput, but the committed
        # generation at a preemption depends on IO timing.
        self.overlap_writes = overlap_writes
        # flight-recorder dumps land next to this loop's forensics
        # records (divergence-*.json live in the same directory)
        tracing.flight_recorder.set_dump_dir(self.manager.dirname)

    def _resume_step(self, start_step, steps_per_call=1, clean_only=False,
                     before_step=None):
        """Newest verified generation + 1, else ``start_step``. Corrupt
        generations are quarantined by the restore itself. Under chunked
        execution (``steps_per_call`` K > 1) the manifest step is
        verified against the chunk size: every save lands on a chunk
        boundary (manifest step = last step OF a chunk), so a resume
        point off the K-grid means the directory was written with a
        different K or save cadence — restored state plus a misaligned
        counter would re-apply or skip part of a chunk, so it raises
        instead of resuming wrong."""
        try:
            self.manager.wait()
        except PREEMPTION_ERRORS:
            pass  # the aborted save's stashed error — already handled
        _barrier()
        manifest = self.manager.restore(self.scope, self.target_shardings,
                                        require_clean_health=clean_only,
                                        before_step=before_step)
        if clean_only and manifest is None:
            # every generation was unclean or post-onset (now
            # quarantined): the scope still holds the DIVERGED state,
            # and "resume from start_step" would re-train on it and
            # re-checkpoint it behind clean health blocks — the exact
            # garbage-checkpointing failure this layer exists to stop
            raise RuntimeError(
                "divergence rollback found no generation with clean "
                "recorded health (before_step=%s): no safe restore "
                "point exists and the in-memory state is diverged — "
                "restart from a known-good checkpoint or an explicit "
                "cold start" % (before_step,))
        if self._tracker is not None:
            # the skip counter survives the restore (it is scope state
            # outside the program's persistables); only the delta since
            # the last save defines cleanliness, so re-baseline
            self._tracker.resync()
        step = start_step if manifest is None else manifest["step"] + 1
        if steps_per_call > 1 and (step - start_step) % steps_per_call:
            raise ValueError(
                "checkpoint manifest step %d does not land on a chunk "
                "boundary (start_step=%d, steps_per_call=%d): this "
                "directory was checkpointed under a different chunk "
                "size/cadence — resume with the matching steps_per_call "
                "or from a boundary-aligned generation"
                % (step - 1, start_step, steps_per_call))
        if telemetry.enabled():
            telemetry.set_resume_step(step)
        return step

    def run(self, step_fn, max_steps, start_step=0, restore_first=True,
            steps_per_call=1):
        """Run ``step_fn(step)`` for ``step`` in ``[start_step,
        max_steps)``, checkpointing each completed step through the
        manager. Returns the number of preemptions survived.

        ``restore_first=True`` makes a fresh process adopt whatever the
        checkpoint directory already holds — the replacement-trainer
        path after a whole-slice preemption.

        ``steps_per_call`` K > 1 drives chunked execution
        (``Executor.run_chunk``): ``step_fn(step)`` is expected to run
        the K steps ``[step, step+K)`` in one dispatch, the counter
        advances by K per call, and checkpoints commit at chunk
        boundaries (manifest step = ``step+K-1``, proving the whole
        chunk completed). A preemption mid-chunk therefore resumes at
        the last completed chunk boundary: the restore replaces every
        state value the interrupted chunk may have updated in place, so
        no torn optimizer state is resumed from. ``max_steps -
        start_step`` must divide evenly into chunks."""
        if steps_per_call < 1:
            raise ValueError("steps_per_call must be >= 1")
        if (max_steps - start_step) % steps_per_call:
            raise ValueError(
                "max_steps - start_step = %d is not a multiple of "
                "steps_per_call=%d — chunked runs checkpoint and resume "
                "at chunk boundaries only"
                % (max_steps - start_step, steps_per_call))
        step = (self._resume_step(start_step, steps_per_call)
                if restore_first else start_step)
        while True:
            try:
                while step < max_steps:
                    # one trace per training chunk: the executor's
                    # stage/dispatch/health spans and the checkpoint/
                    # reshard work all nest under this root
                    with tracing.span("paddle_tpu.recovery.chunk",
                                      step=step):
                        # chunk-boundary pause point: the elastic
                        # subclass reshards HERE when the cluster epoch
                        # moved — the in-graph carry is between
                        # dispatches, so the hand-off sees a complete,
                        # consistent state
                        self._before_chunk(step)
                        step_fn(step)
                        commit = step + steps_per_call - 1
                        # health_fn() is delta-stateful (clean = no
                        # skips since the LAST recorded block), so
                        # consult it only for steps the manager will
                        # actually commit
                        meta = (self.health_fn()
                                if self.health_fn is not None and
                                commit % self.manager.save_interval_steps
                                == 0 else None)
                        with tracing.child_span(
                                "paddle_tpu.recovery.checkpoint",
                                step=commit):
                            self.manager.save(commit, self.scope,
                                              self.program,
                                              extra_meta=meta)
                            if self.overlap_writes:
                                self.manager.poll()
                            else:
                                self.manager.wait()
                    step += steps_per_call
                # the final drain must sit INSIDE the recovery scope: an
                # overlapped last write can tear too, and that preemption
                # deserves the same restore-and-resume as any other
                self.manager.wait()
                return self.restarts
            except RESHARD_ERRORS as e:
                # mid-chunk worker loss: only the elastic subclass can
                # rebuild the world; here the contract is fail-fast
                step = self._on_reshard(e, step, start_step,
                                        steps_per_call)
            except ROLLBACK_ERRORS as e:
                # divergence: the newest checkpoints hold poisoned-or-
                # diverging state that VERIFIES clean (CRC sees bits,
                # not math). Roll back to the newest generation whose
                # recorded health was clean; the skipped-over diverged
                # generations are quarantined (reason "diverged") with
                # the offending chunk recorded for forensics.
                self.rollbacks += 1
                self.last_divergence = e
                if self.rollbacks > self.max_rollbacks:
                    raise
                self._record_divergence(e, step, steps_per_call,
                                        start_step)
                detector = getattr(e, "detector", None)
                if detector is not None:
                    detector.reset()
                # onset bound: a SPIKE's generations are finite and read
                # clean by skip count — reject everything checkpointed
                # at or after the detector's onset estimate too
                step = self._resume_step(
                    start_step, steps_per_call, clean_only=True,
                    before_step=getattr(e, "onset_step", None))
                # counted after the budget check AND a successful
                # restore: the metric is rollbacks PERFORMED, not
                # divergences caught
                if telemetry.enabled():
                    telemetry.record_guard_rollback()
            except PREEMPTION_ERRORS as e:
                self.restarts += 1
                if telemetry.enabled():
                    telemetry.record_preemption()
                if self.restarts > self.max_restarts:
                    raise Preemption(
                        "gave up after %d restarts (last: %s)"
                        % (self.restarts - 1, e)) from e
                step = self._resume_step(start_step, steps_per_call)

    def _before_chunk(self, step):
        """Chunk-boundary hook (no-op here): ``ElasticRecoveryLoop``
        checks the membership epoch and live-reshards."""

    def _on_reshard(self, e, step, start_step, steps_per_call):
        """A ``Reshard`` escaped the step function: a fixed-world loop
        cannot satisfy it."""
        raise e

    def _record_divergence(self, e, step, steps_per_call, start_step):
        """Forensics record for the offending chunk, next to the
        checkpoints it invalidated (the diverged generations themselves
        land in ``quarantine/``). The offending chunk is derived from
        the detector's step, NOT from the loop's current step: health
        rows are processed one dispatch behind, so the Divergence
        surfaces from the NEXT chunk's step_fn."""
        bad = getattr(e, "step", None)
        if bad is not None:
            lo = bad - ((bad - start_step) % steps_per_call)
        else:
            lo = step
        rec = {
            "kind": "divergence",
            "reason": getattr(e, "reason", str(e)),
            "step": bad,
            "chunk": [lo, lo + steps_per_call],
            "caught_at": step,
            "stats": getattr(e, "stats", {}),
            "rollback": self.rollbacks,
            "timestamp": time.time(),
        }
        try:
            os.makedirs(self.manager.dirname, exist_ok=True)
            # step + wall-clock nanos: unique across process restarts
            # (a per-loop counter would overwrite a previous run's
            # record after a preemption reset it)
            fault.atomic_write(
                os.path.join(
                    self.manager.dirname,
                    "divergence-%012d-%d.json" % (step, time.time_ns())),
                json.dumps(rec).encode())
        except OSError:
            pass  # forensics are best-effort; the rollback itself is not
        if tracing.enabled():
            # the seconds BEFORE the divergence, beside the forensics
            # record: the last spans (which chunks dispatched, how long
            # the health fetches ran) + telemetry events/deltas
            tracing.flight_recorder.on_crash(
                "divergence", path=os.path.join(
                    self.manager.dirname,
                    "flightrec-divergence-%012d-%d.json"
                    % (step, time.time_ns())))
        telemetry.emit("divergence_rollback", **{
            k: v for k, v in rec.items() if k != "kind"})


class ElasticRecoveryLoop(RecoveryLoop):
    """Membership-driven live reshard: scale the mesh up or down
    MID-RUN, without a process restart.

    ``watcher`` is an object exposing ``snapshot() -> (epoch, members)``
    without blocking (``membership.EpochWatcher``, fed by the server's
    ``rpc_epoch`` long-poll). The loop does not own the watcher's
    lifecycle — acquire it through ``EpochWatcher.shared()`` when other
    consumers (the serving router drives replica add/drain off the same
    epoch) watch the same endpoint, and release it after ``run``
    returns; the refcounted registry makes the teardown order safe.
    Between chunk dispatches the loop compares
    the watcher's epoch with the one it is training under; when it
    moved, the loop pauses AT THE CHUNK BOUNDARY and reshards:

    1. drain the async checkpoint writer, snapshot the sharded state to
       host (the same consistent cut a save takes);
    2. call ``rebuild(members, epoch)`` — the caller re-lowers for the
       new world (``ParallelExecutor.set_mesh`` on a mesh sized to the
       live members) and returns the new ``state_shardings`` (or None
       to keep the current targets);
    3. redistribute parameter/optimizer/guard state through the
       sharded-checkpoint reshard assembly — in memory
       (``reshard_state``) when every piece is locally addressable,
       spilling the snapshot to ``<dirname>/reshard-spill`` and
       restoring it through the normal manifest path when not;
    4. resume at the SAME step: the boundary pause loses nothing, and
       the step counter stays on the K-grid.

    A ``Reshard`` raised from inside the step function (mid-chunk
    worker loss — a collective died under the dispatch) takes the
    harder path: rebuild for the new world, then restore the newest
    verified generation onto the NEW layout and resume at the last
    chunk boundary — at most the interrupted chunk re-runs.

    ``max_reshards`` bounds flapping membership (a control plane
    bouncing a worker in a tight loop must surface as an error, not an
    infinite recompile storm); ``settle_seconds`` debounces it — after
    noticing a bump the loop waits until the epoch holds still that
    long, so a remove-then-readd flap costs one reshard, not two.

    Determinism: per-step RNG keys fold the ABSOLUTE step index and the
    grad all-reduce is the only device-count-dependent math, so a run
    resharded N times converges bitwise-equal to a fixed-world run
    modulo float reduction order across device counts (RELIABILITY.md
    §Elastic training); equal-count reshards (worker swap) are exactly
    bitwise."""

    #: fault-injection site fired at the start of every live reshard
    #: (a crash rule forces the spill fallback; a delay rule inflates
    #: downtime for budget tests)
    FAULT_SITE = "elastic.reshard"

    def __init__(self, dirname, scope, program, watcher=None,
                 rebuild=None, max_reshards=64, settle_seconds=0.0,
                 shard_plan=None, shard_rank=None, sample_index=None,
                 **kw):
        super().__init__(dirname, scope, program, **kw)
        self.watcher = watcher
        self.rebuild = rebuild
        self.max_reshards = max_reshards
        self.settle_seconds = settle_seconds
        # data-pipeline reshard: an ElasticShardPlan shared with this
        # worker's reader, re-keyed to the new worker set at every
        # membership epoch. shard_rank(members, epoch) -> (num_shards,
        # shard_id) maps the membership to THIS worker's new key
        # (default: sorted-name position of process_index).
        # sample_index() -> next global sample index = the rekey
        # boundary, so no example is dropped or double-read across the
        # reshard (parity test in tests/test_deploy.py).
        self.shard_plan = shard_plan
        self.shard_rank = shard_rank
        self.sample_index = sample_index
        if shard_plan is not None and sample_index is None:
            raise ValueError(
                "shard_plan needs sample_index (a zero-arg callable "
                "returning the next global sample index) to place the "
                "rekey boundary")
        self.reshards = 0
        self.last_reshard = None
        self.cluster_epoch = (watcher.snapshot()[0]
                              if watcher is not None else 0)

    # ---- the cooperative (boundary) path ----

    def _before_chunk(self, step):
        if self.watcher is None:
            return
        epoch, members = self.watcher.snapshot()
        if epoch != self.cluster_epoch and self.settle_seconds > 0.0:
            # flapping debounce: reshard once the epoch holds still
            epoch, members = self._settle(epoch, members)
        epoch, members = self._agree(epoch, members)
        if epoch == self.cluster_epoch:
            return
        self._live_reshard(step, epoch, members)

    @staticmethod
    def _agree(epoch, members):
        """Across a world of more than one rank every rank adopts the
        newest ``(epoch, members)`` any rank's watcher saw (one
        ``all_gather_object`` a boundary): the ranks' watchers see a
        bump at different moments, and a reshard is a sequence of
        collectives they must all start at the same boundary."""
        world = _world()[1]
        if world == 1:
            return epoch, members
        views = [None] * world
        dist.all_gather_object(views, (epoch, tuple(members or ())))
        return max(views, key=lambda v: v[0])

    def _settle(self, epoch, members):
        # BOUNDED: a flap that never quiets must fall through to the
        # reshard path after ~10 settle windows, where _charge_reshard's
        # budget turns the storm into a hard error — an unbounded wait
        # here would hang training silently instead
        deadline = time.monotonic() + max(10.0 * self.settle_seconds,
                                          self.settle_seconds + 1.0)
        while time.monotonic() < deadline:
            time.sleep(self.settle_seconds)
            nxt, nmembers = self.watcher.snapshot()
            if nxt == epoch:
                return epoch, nmembers
            epoch, members = nxt, nmembers
        return epoch, members

    def _charge_reshard(self):
        self.reshards += 1
        if self.reshards > self.max_reshards:
            raise RuntimeError(
                "elastic loop exceeded max_reshards=%d — flapping "
                "membership (a worker bouncing in a register/expire "
                "loop?); fix the cluster or raise the budget"
                % self.max_reshards)

    def _live_reshard(self, step, epoch, members):
        self._charge_reshard()
        t0 = time.perf_counter()
        with tracing.span("paddle_tpu.elastic.reshard", step=step,
                          epoch=epoch):
            # drain the async writer first: it may still be serializing
            # the previous boundary's host snapshot, and a stashed
            # write error must surface before we commit to the new
            # world
            self.manager.wait()
            # the state snapshot reads the OLD layout (its pieces name
            # the old groups' ranks), then the rebuild makes the new
            # world's process groups: each is a sequence of collectives
            # every rank issues in the same order, so they run one after
            # the other (the JAX package overlaps them on a thread)
            state = snapshot_state(self.scope, self.program)
            self._rebuild_world(members, epoch)
            overlap_saved = 0.0
            self._rekey_reader(members, epoch)
            path, moved = "memory", 0
            try:
                # the ranks agree on each stage's outcome before the
                # next (a rank that failed alone would leave the others
                # in a collective it never joins): one failure sends
                # every rank down the spill path
                err = None
                try:
                    if fault._active:
                        fault.fire(self.FAULT_SITE)
                except Exception as e:
                    err = e
                _raise_if_any(err)
                try:
                    moved = reshard_state(self.scope, self.program,
                                          self.target_shardings,
                                          state=state,
                                          place=self.manager.place)
                except Exception as e:
                    err = e
                _raise_if_any(err)
            except Exception as e:
                # in-memory hand-off failed (pieces on other processes,
                # an injected fault, a mid-assembly device error):
                # spill the SAME host snapshot through the checkpoint
                # directory — the manifest/CRC machinery then owns
                # integrity. The flight recorder dumps the run-up to
                # the failure beside the spill before the fallback runs
                if tracing.enabled():
                    tracing.flight_recorder.on_crash(
                        "reshard", path=os.path.join(
                            self.manager.dirname,
                            "flightrec-reshard-%012d-%d.json"
                            % (step, time.time_ns())))
                warnings.warn(
                    "in-memory reshard failed (%s: %s); spilling state "
                    "through %s" % (type(e).__name__, e,
                                    self._spill_dir()), RuntimeWarning)
                path = "spill"
                moved = self._spill_reshard(state, step)
        self.cluster_epoch = epoch
        self._note_reshard(path, time.perf_counter() - t0, moved, epoch,
                           step, overlap_saved_s=overlap_saved)

    def _spill_dir(self):
        return os.path.join(self.manager.dirname, "reshard-spill")

    def _spill_reshard(self, state, step):
        spill = self._spill_dir()
        save_sharded_checkpoint(
            spill, step, state=state,
            process_index=self.manager.process_index,
            num_processes=self.manager.num_processes,
            compressor=self.manager.compressor)
        _barrier()   # rank 0's merged manifest exists
        load_sharded_checkpoint(spill, self.scope,
                                self.target_shardings, step=step,
                                place=self.manager.place)
        return _state_bytes(state)

    # ---- the mid-chunk (Reshard raised) path ----

    def _on_reshard(self, e, step, start_step, steps_per_call):
        self._charge_reshard()
        t0 = time.perf_counter()
        epoch, members = e.epoch, e.members
        if (epoch is None or members is None) and self.watcher is not None:
            wepoch, wmembers = self.watcher.snapshot()
            epoch = wepoch if epoch is None else epoch
            members = wmembers if members is None else members
        self._rebuild_world(members, epoch)
        self._rekey_reader(members, epoch)
        self.cluster_epoch = epoch if epoch is not None \
            else self.cluster_epoch
        # the interrupted chunk's dispatch may have died half-way
        # through its in-place updates: the in-memory state is not
        # trustworthy, so
        # restore the newest verified generation ONTO the new layout —
        # at most the interrupted chunk is lost. NO generation at all
        # (the very first chunk died) must raise, not silently resume
        # on the possibly-corrupt scope — same contract as the
        # divergence path's unsatisfiable clean restore
        try:
            self.manager.wait()
        except PREEMPTION_ERRORS:
            pass  # the aborted save's stashed error — already handled
        _barrier()   # every rank's last save merged before the scan
        if latest_sharded_checkpoint(self.manager.dirname,
                                     quarantine=False) is None:
            raise RuntimeError(
                "mid-chunk reshard found no checkpoint generation to "
                "restore (the interrupted dispatch may have invalidated "
                "the in-memory state and there is no safe "
                "restore point): cold-start the job on the new world "
                "instead") from e
        step = self._resume_step(start_step, steps_per_call)
        self._note_reshard("restore", time.perf_counter() - t0,
                           _scope_state_bytes(self.scope, self.program),
                           epoch, step)
        return step

    # ---- shared ----

    def _rebuild_world(self, members, epoch):
        if self.rebuild is None:
            return
        shardings = self.rebuild(tuple(members or ()), epoch)
        if shardings is not None:
            self.target_shardings = shardings

    def _rekey_reader(self, members, epoch):
        """Re-key this worker's reader shard to the new worker set at
        the next unconsumed global sample index: examples before the
        boundary keep the old keying everywhere, examples at/after it
        use the new one — no drop, no double-read."""
        if self.shard_plan is None:
            return
        if self.shard_rank is not None:
            num_shards, shard_id = self.shard_rank(
                tuple(members or ()), epoch)
        else:
            num_shards = max(1, len(members or ()))
            shard_id = min(self.manager.process_index, num_shards - 1)
        self.shard_plan.rekey(num_shards, shard_id,
                              int(self.sample_index()))

    def _world_devices(self):
        for sh in (self.target_shardings or {}).values():
            mesh = getattr(sh, "mesh", None)
            if mesh is not None:
                return int(mesh.size)
        return None

    def _note_reshard(self, path, downtime_s, moved, epoch, step,
                      overlap_saved_s=0.0):
        devices = self._world_devices()
        self.last_reshard = {"path": path, "downtime_s": downtime_s,
                             "bytes_moved": moved, "epoch": epoch,
                             "devices": devices, "step": step,
                             "overlap_saved_s": overlap_saved_s}
        if telemetry.enabled():
            telemetry.record_reshard(path, downtime_s, moved,
                                     epoch=epoch, devices=devices)


def _state_bytes(state):
    """Total logical bytes of a ``snapshot_state`` cut (per-var global
    volume — the payload a reshard redistributes)."""
    from paddle_tpu_torch.recordio_writer import host_dtype

    total = 0
    for _name, (shape, dtype, _pieces) in state.items():
        total += (int(np.prod(shape, dtype=np.int64))
                  * host_dtype(dtype).itemsize)
    return int(total)


def _scope_state_bytes(scope, program):
    """Logical bytes of the scope's persistable state, from tensor
    METADATA only (no device sync, no host copy): the state-moved
    accounting for the restore reshard path, where the checkpoint tier
    already materialized the data."""
    total = 0
    for n in _persistable_names(scope, program):
        v = scope.find_var(n)
        if hasattr(v, "element_size"):
            total += int(v.numel()) * int(v.element_size())
    return total


def train_with_recovery(step_fn, dirname, scope, program, max_steps,
                        target_shardings=None, start_step=0,
                        save_interval_steps=1, max_restarts=8,
                        process_index=0, num_processes=None, place=None):
    """One-call form of ``RecoveryLoop`` with SIGTERM conversion: the
    fluid ``trainer.train()`` shape, preemption-safe. Returns the loop
    (``.restarts`` tells how many preemptions were survived)."""
    loop = RecoveryLoop(dirname, scope, program,
                        target_shardings=target_shardings,
                        save_interval_steps=save_interval_steps,
                        max_restarts=max_restarts,
                        process_index=process_index,
                        num_processes=num_processes, place=place)
    with raise_on_sigterm():
        loop.run(step_fn, max_steps, start_step=start_step)
    return loop
