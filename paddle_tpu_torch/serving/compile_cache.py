"""Shared capture bookkeeping of the serving engines.

Capability parity: the JAX package's ``serving/compile_cache.py``. There
an entry is one compiled XLA executable; in the port it is one captured
bucket: a ``core/graphs.CapturedRun`` over fixed buffers on the card,
or the eager plan of the bucket on the CPU. The cache keeps them behind
one lock, keyed by ``(program.fingerprint, *key)`` (a program whose
version moved never serves a stale entry), counts them lock-free for
readiness probes, and records each build as a jit miss
(``paddle_tpu_executor_jit_cache_misses_total``) and a
``paddle_tpu_serving_bucket_compiles_total``, as a compile is recorded
in the JAX package.

Costs: the JAX package reads XLA's ``cost_analysis()`` (flops and bytes
accessed). The port's bucket build reports the flops that
``torch.utils.flop_counter.FlopCounterMode`` counted over the bucket's
eager run: the aten matmuls and convolutions, not the work of a
hand-written kernel (the LSTM cell's recurrent products, attention).
No byte count is reported. The persistent AOT cache (``aot_cache``) is
not ported: ``aot_cache`` must be None.
"""

import threading
import time

from paddle_tpu_torch import telemetry

__all__ = ["CompiledCache"]


class CompiledCache:
    """get(): in-memory hit -> build, under one lock; counters are
    written under the lock but READ lock-free (readiness probes must
    answer while a bucket's capture holds it)."""

    def __init__(self, aot_cache=None, service="serving"):
        if aot_cache is not None:
            raise NotImplementedError(
                "the persistent AOT cache is not ported: pass "
                "aot_cache=None")
        self._aot = None
        self.service = service
        self._lock = threading.Lock()
        self._cache = {}        # (program.fingerprint, *key) -> entry
        self._costs = {}        # cost_key -> {"flops": ...}
        self.compile_seconds = 0.0
        self._count = 0

    @property
    def count(self):
        """Entries built so far. Lock-free."""
        return self._count

    def costs(self):
        """{cost_key: cost dict} snapshot (entries are write-once)."""
        return dict(self._costs)

    def lookup(self, program, key):
        """In-memory probe only; records the jit HIT. Lock-free (a dict
        probe is GIL-atomic; writers only ever ADD entries). Returns
        None on a miss without building."""
        hit = self._cache.get((program.fingerprint,) + tuple(key))
        if hit is not None and telemetry.enabled():
            telemetry.record_jit_hit(program)
        return hit

    def get(self, program, key, lower, *, cost_key, bucket=0,
            aot_key=None, miss_sig=None):
        """The build path. ``lower`` is a zero-arg callable returning
        ``(entry, cost)`` (called under the lock, at most once per key);
        ``miss_sig`` (a dict, or a zero-arg callable returning one)
        feeds the recompile detector. ``aot_key`` is accepted for the
        JAX package's callers and unused."""
        hit = self.lookup(program, key)
        if hit is not None:
            return hit
        full_key = (program.fingerprint,) + tuple(key)
        with self._lock:
            # a concurrent caller may have built this key meanwhile
            hit = self._cache.get(full_key)
            if hit is not None:
                return hit
            t0 = time.perf_counter()
            entry, cost = lower()
            dt = time.perf_counter() - t0
            self.compile_seconds += dt
            self._costs[cost_key] = dict(cost)
            self._cache[full_key] = entry
            self._count = len(self._cache)
        if telemetry.enabled():
            if callable(miss_sig):
                miss_sig = miss_sig()
            telemetry.record_jit_miss(program, miss_sig or {})
            telemetry.record_serving_compile(self.service, bucket, dt,
                                             cost.get("flops", 0.0))
        return entry
