"""Deterministic fault injection: seeded, rule-based failure points.

A copy of the JAX package's ``fault.py`` (which imports no JAX), over
this package's ``telemetry``: the same rules, sites and counters. The
training-health guard (``guard.py``) reads its ``guard.nonfinite`` rules
when the executor builds a plan; the serving and distributed sites below
arrive with the modules that call them.

The distributed tier (master, pserver, membership, sharded checkpoints)
routes every network send/recv and every snapshot/manifest write through
the hooks in this module, so its failure paths — connection drops,
stalls, partial socket writes, torn file writes, preemption — can be
exercised *deterministically* in tests instead of waiting for a pod to
misbehave. The reference's Go master/pserver stack was fault-tolerant by
construction (etcd leases, task retries, CRC'd checkpoints); this is the
harness that proves the TPU-native re-expression actually survives the
same faults (see RELIABILITY.md for the failure model).

Design rules:

* **Off by default at one branch per call.** ``_active`` is a module
  bool, flipped only while at least one rule is registered. Every hook
  site guards on it (``if fault._active: fault.fire(site)``), so the
  disabled hot path pays a single predicted branch and zero behavior
  change.
* **Deterministic.** Each rule owns a ``random.Random(seed)``; given the
  same seed and the same sequence of matching calls, the same calls are
  faulted. No global RNG, no wall-clock decisions.
* **Rule-based.** ``inject("pserver.send_grad", drop=0.1)`` registers a
  rule against an ``fnmatch`` site pattern (``"pserver.*"`` works).
  Actions: probabilistic connection drops, fixed/jittered delays,
  crash-on-nth-call, partial socket writes, torn file writes, arbitrary
  exception types, bounded fire counts. Injections are counted through
  the telemetry registry (``paddle_tpu_fault_injected_total``).

Sites follow ``<service>.<method>`` for RPC calls (plus ``.send`` /
``.recv`` / ``.connect`` sub-sites for the transport halves) and
``<subsystem>.<operation>`` for file IO (``master.snapshot``,
``checkpoint.shard_write``, ``checkpoint.manifest_write``).

Elastic-training seams (RELIABILITY.md §Elastic training):

* ``membership.lease.<kind>.<name>`` — fired in the membership server's
  heartbeat handler before the lease renews. A ``drop=1.0`` rule on one
  member's site is an injected **worker loss** (its lease expires, the
  sweep bumps the cluster epoch); registering and clearing it in a loop
  is **flapping membership** (the elastic loop's ``max_reshards`` /
  ``settle_seconds`` exist for exactly that storm).
* ``elastic.reshard`` — fired at the start of every live reshard: a
  crash rule forces the spill-to-checkpoint fallback, a delay rule
  inflates the measured reshard downtime for budget tests.

Serving-cluster seams (SERVING.md §Cluster):

* ``router.pick`` — fired before every routing decision; a delay rule
  injects router-side latency, a crash rule is a router-tier failure.
* ``router.failover`` — fired on every failover hop; a crash rule
  turns a failover storm into a hard error for budget tests.
* ``serving.aot_cache`` — the persistent AOT executable cache's
  torn-write seam (rides ``fault.atomic_write`` like the snapshot
  writers); a replica's kill/hang/drain chaos rides the per-replica
  ``<service>.reply`` / ``<service>.handler`` / ``<service>.drain``
  transport seams, and ``membership.lease.replica.<name>`` is its
  injected death.

Fleet-observability seams (OBSERVABILITY.md §Fleet layer):

* ``fleet.scrape.<proc>`` — fired in the FleetCollector before each
  ``rpc_metrics`` pull of ``<proc>``; an error/drop rule is a torn
  scrape (the proc must go stale, the rollup must stay uncorrupted),
  a delay rule models a slow scrape against the per-scrape deadline.
* ``fleet.breach.<rule>`` — fired before a ``SloBreach`` transition
  is recorded; a crash rule proves a failing alert sink cannot take
  the scrape loop down with it.

Serving-fleet seams (SERVING.md §Multi-host fleet, RELIABILITY.md):

* ``router.hedge`` — fired when the hedge threshold elapses, before
  the backup request launches; a drop rule suppresses hedging (the
  primary must still answer), a delay rule models a slow backup path.
* ``supervisor.restart`` — fired in the supervisor's tick before a
  replica restart is scheduled; a drop rule delays the restart one
  tick (the loop must survive and retry), a crash rule models the
  supervisor dying mid-restart (the replacement-adoption path).
* ``supervisor.scale`` — fired at the top of every ``scale_to``; a
  crash rule proves a failing autoscale decision cannot take the
  supervision loop down, a drop rule skips one scale application.
"""

import contextlib
import fnmatch
import itertools
import os
import random
import threading
import time

from paddle_tpu_torch import telemetry

__all__ = ["FaultInjected", "Rule", "inject", "clear", "rules", "active",
           "fire", "sendall", "write_bytes", "atomic_write", "scope",
           "note_injected"]


class FaultInjected(Exception):
    """An injected fault. RPC channels treat it like a connection error;
    the recovery wrapper treats it like a preemption."""

    def __init__(self, site, action):
        super().__init__("injected %s at %s" % (action, site))
        self.site = site
        self.action = action


_lock = threading.RLock()
_rules = []
_active = False  # the ONE branch hot paths pay when injection is off


def active():
    return _active


_rule_uids = itertools.count(1)


class Rule:
    """One injection rule. Fields are fixed at creation; ``calls`` and
    ``fires`` count matching calls / performed injections (telemetry for
    the test itself). ``uid`` is a monotonic identity — trace-armed
    sites (guard.nonfinite) key compiled artifacts on it so a
    re-registered rule never inherits a stale rule's accounting."""

    def __init__(self, pattern, drop=0.0, delay_ms=0.0, error=None,
                 crash_on_nth=None, partial_bytes=None, torn_bytes=None,
                 times=None, seed=0):
        self.uid = next(_rule_uids)
        self.pattern = pattern
        self.drop = float(drop)
        self.delay_ms = delay_ms          # scalar, or (lo, hi) jittered
        self.error = error                # exception class or instance
        self.crash_on_nth = crash_on_nth  # 1-based matching-call index
        self.partial_bytes = partial_bytes  # socket writes: send N then die
        self.torn_bytes = torn_bytes      # file writes: write N then die
        self.times = times                # max injections; None = unlimited
        self.seed = seed
        self.calls = 0
        self.fires = 0
        self._rng = random.Random(seed)

    def _exhausted(self):
        return self.times is not None and self.fires >= self.times

    def __repr__(self):
        return ("Rule(%r, drop=%r, delay_ms=%r, crash_on_nth=%r, "
                "partial_bytes=%r, torn_bytes=%r, times=%r, seed=%r, "
                "calls=%d, fires=%d)"
                % (self.pattern, self.drop, self.delay_ms,
                   self.crash_on_nth, self.partial_bytes, self.torn_bytes,
                   self.times, self.seed, self.calls, self.fires))


def inject(site_pattern, **kw):
    """Register an injection rule; returns it (for ``.calls``/``.fires``
    inspection). ``fault.inject("pserver.send_grad", drop=1.0, times=2,
    seed=7)`` drops the first two matching sends, deterministically."""
    rule = Rule(site_pattern, **kw)
    global _active
    with _lock:
        _rules.append(rule)
        _active = True
    return rule


def clear():
    """Remove every rule and drop back to the zero-overhead disabled
    state."""
    global _active
    with _lock:
        del _rules[:]
        _active = False


def rules():
    with _lock:
        return list(_rules)


@contextlib.contextmanager
def scope(site_pattern, **kw):
    """``with fault.scope("master.*", drop=1.0):`` — rule lives for the
    block only. Other concurrently-registered rules are untouched."""
    rule = inject(site_pattern, **kw)
    try:
        yield rule
    finally:
        global _active
        with _lock:
            try:
                _rules.remove(rule)
            except ValueError:
                pass  # a clear() inside the block already removed it
            _active = bool(_rules)


def _record(site, action):
    if telemetry.enabled():
        telemetry.record_fault(site, action)


def _raise(rule, site, action):
    _record(site, action)
    err = rule.error
    if err is not None:
        raise err(site, action) if isinstance(err, type) else err
    raise FaultInjected(site, action)


def _decide(site, io_attr=None):
    """Advance every matching rule's counters and RNG stream under the
    module lock — determinism requires the ``calls`` increments and RNG
    draws to be atomic across the servers' handler threads — and return
    ``(delays, action)``: seconds to sleep and the fault to perform,
    both outside the lock. ``io_attr`` names the byte-level action
    (``partial_bytes`` / ``torn_bytes``) the calling hook supports; the
    scan stops at the first faulting rule, like the raise would have."""
    delays, action = [], None
    with _lock:
        for rule in _rules:
            if rule._exhausted() or not fnmatch.fnmatch(site, rule.pattern):
                continue
            rule.calls += 1
            d = rule.delay_ms
            if d:
                if isinstance(d, (tuple, list)):
                    d = d[0] + rule._rng.random() * (d[1] - d[0])
                rule.fires += 1
                delays.append(d / 1000.0)
            if io_attr is not None and getattr(rule, io_attr) is not None:
                rule.fires += 1
                action = (io_attr, rule, getattr(rule, io_attr))
            elif (rule.crash_on_nth is not None
                  and rule.calls == rule.crash_on_nth):
                rule.fires += 1
                action = ("crash", rule, None)
            elif rule.drop and rule._rng.random() < rule.drop:
                rule.fires += 1
                action = ("drop", rule, None)
            if action is not None:
                break
    for _ in delays:
        _record(site, "delay")
    for s in delays:
        time.sleep(s)
    return action


def fire(site, path=None):
    """The call-level injection point. Applies every matching rule:
    delays sleep, drops/crashes raise (``FaultInjected`` unless the rule
    carries ``error=``). ``path`` lets torn-write rules truncate an
    already-written file (simulating a crash mid-write *after* the
    writer streamed its data). Callers MUST guard with ``fault._active``
    so the disabled path stays one branch."""
    action = _decide(site, "torn_bytes" if path is not None else None)
    if action is None:
        return
    kind, rule, value = action
    if kind == "torn_bytes":
        _tear_file(value, path)
        _raise(rule, site, "torn_write")
    _raise(rule, site, kind)


def note_injected(rule, site, action, count=1):
    """Host-side accounting for TRACE-ARMED faults. Some sites (the
    training guard's ``guard.nonfinite``) bake the rule into a compiled
    graph at prepare time — the injection then happens on-device, once
    per matching step, with no host call to intercept. The owner of the
    compiled artifact calls this after each dispatch with how many
    in-graph injections actually fired, so ``rule.fires``/``times``
    bookkeeping and the ``paddle_tpu_fault_injected_total`` counter stay
    truthful. Returns the number of fires actually credited (capped at
    the rule's remaining ``times`` budget)."""
    with _lock:
        rule.calls += count
        n = count if rule.times is None else max(
            0, min(count, rule.times - rule.fires))
        rule.fires += n
    for _ in range(n):
        _record(site, action)
    return n


def _tear_file(keep, path):
    """Truncate ``path`` to ``keep`` bytes (absolute, or a fraction of
    the current size when < 1.0) — a crash mid-write."""
    try:
        size = os.path.getsize(path)
    except OSError:
        size = 0
    if isinstance(keep, float) and keep < 1.0:
        keep = int(size * keep)
    with open(path, "r+b") as f:
        f.truncate(int(min(keep, size)))


def sendall(sock, data, site):
    """``sock.sendall(data)`` with partial-write/drop injection. A
    matching ``partial_bytes=N`` rule sends only the first N bytes then
    raises — the peer observes a partial line, the caller observes a
    failed send. Callers guard with ``fault._active``."""
    action = _decide(site, "partial_bytes")
    if action is not None:
        kind, rule, value = action
        if kind == "partial_bytes":
            _record(site, "partial_write")
            sock.sendall(data[: int(value)])
            raise FaultInjected(site, "partial_write")
        _raise(rule, site, kind)
    sock.sendall(data)


def write_bytes(f, data, site):
    """``f.write(data)`` with torn-write injection: a matching
    ``torn_bytes=N`` rule writes the first N bytes (or fraction of
    ``len(data)``), flushes, and raises — the on-disk file is torn
    exactly where a preemption mid-write would tear it. Callers guard
    with ``fault._active``."""
    action = _decide(site, "torn_bytes")
    if action is not None:
        kind, rule, value = action
        if kind == "torn_bytes":
            if isinstance(value, float) and value < 1.0:
                value = int(len(data) * value)
            _record(site, "torn_write")
            f.write(data[: int(value)])
            f.flush()
            raise FaultInjected(site, "torn_write")
        _raise(rule, site, kind)
    f.write(data)


def atomic_write(path, data, site=None, backup=False, fsync=True):
    """Crash-safe file write: temp file + fsync + ``os.replace``. With
    ``backup=True`` the previous generation survives as ``path + ".bak"``
    (rotated atomically), so a reader can fall back when ``path`` itself
    is later found corrupt. This is the single write path for master /
    membership snapshots and checkpoint manifests — and therefore the
    torn-write injection seam (``site=``)."""
    tmp = "%s.tmp.%d" % (path, os.getpid())
    try:
        with open(tmp, "wb") as f:
            if _active and site is not None:
                write_bytes(f, data, site)
            else:
                f.write(data)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        if backup and os.path.exists(path):
            os.replace(path, path + ".bak")
        os.replace(tmp, path)
    finally:
        try:
            os.remove(tmp)  # left behind only on failure
        except OSError:
            pass
