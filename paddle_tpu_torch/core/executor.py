"""Executor: run a program's global block eagerly on one device.

Capability parity: `paddle/fluid/framework/executor.cc:133` (Run) and the
Python wrapper `python/paddle/fluid/executor.py:181`. The JAX package
traces a block once into a jitted function; PyTorch runs eagerly, so
``run`` interprets the block op by op on the executor's device (see
``core.lower.run_block``) with no compile step and no program cache.

* Persistable variables (parameters) live in a Scope as tensors on the
  executor's device. A program that writes one (the startup program's
  initializers) stores the new tensor back into the scope.
* feed/fetch need no feed/fetch ops: feeds enter the environment before
  the block runs, fetches are read from it afterwards. A ``lod_level >
  0`` var takes a ragged list (one array per sequence), packed here into
  a ``PackedSeq``, or a ``PackedSeq``; a fetched sequence comes back as
  a ``PackedSeq`` of numpy arrays.
* An op that updates a persistable in place (``adam``'s ParamOut and
  moments, names equal to its inputs') is written back to the scope
  with the other persistables the block wrote.
* A program with a pass config (``passes.enable``) runs as its
  transformed clone. The JAX executor applies the pipeline when it
  compiles a variant; there is no compile step here, so the executor
  keeps one clone per (program identity and version, config key) and
  rewrites nothing on later steps. The fetch names only protect
  variables from removal by a rewrite, so the pipeline runs again only
  for a fetch the clone does not protect yet, and the new clone (which
  protects the old names too) takes the old one's place. The passes
  rename no persistable, so what the clone writes lands in the scope
  under the user's names.
"""

import numpy as np
import torch

from paddle_tpu_torch import passes as passes_lib
from paddle_tpu_torch.core import ir
from paddle_tpu_torch.core.infer import torch_dtype
from paddle_tpu_torch.core.lower import (PackedSeq, TraceContext, run_block,
                                         step_key)
from paddle_tpu_torch.core.place import default_place
from paddle_tpu_torch.core.scope import global_scope

__all__ = ["Executor", "external_reads_and_writes"]

# plans an executor keeps; the oldest goes first (a dropped plan is made
# again when its program next runs)
MAX_PLANS = 16


def external_reads_and_writes(program):
    """Names read before written in block 0, and names written by
    block-0 ops. A sub-block reads only what its control-flow op lists
    as inputs in block 0, so block 0 holds every outside read."""
    written = set()
    reads = []
    seen_reads = set()
    for op in program.global_block().ops:
        for n in op.input_arg_names:
            if n and n not in written and n not in seen_reads:
                seen_reads.add(n)
                reads.append(n)
        written.update(n for n in op.output_arg_names if n)
    return reads, written


class Executor:
    """``Executor(place).run(program, feed={...}, fetch_list=[...])``.

    ``place`` defaults to ``CUDAPlace(0)`` and raises when there is no
    CUDA device: running on the CPU is asked for with ``CPUPlace()``.
    """

    def __init__(self, place=None):
        self.device = default_place(place)
        self._step = 0
        # (program fingerprint, pass config key) -> (user program,
        # program to run, its outside reads, its writes, the names the
        # clone protects); holding the user program keeps its id() from
        # being reused
        self._plans = {}

    def _plan(self, program, fetch_names):
        cfg = passes_lib.plan_for(program)
        key = (program.fingerprint, cfg.key if cfg else None)
        plan = self._plans.get(key)
        if plan is None or (cfg is not None
                            and not plan[4].issuperset(fetch_names)):
            run, protected = program, frozenset()
            if cfg is not None:
                # the fetches are protected from removal by a rewrite
                protected = frozenset(fetch_names).union(
                    plan[4] if plan else ())
                run, _ = passes_lib.apply(program, protected=protected)
            plan = (program, run) + external_reads_and_writes(run) \
                + (protected,)
            self._plans.pop(key, None)
            self._plans[key] = plan
            while len(self._plans) > MAX_PLANS:
                del self._plans[next(iter(self._plans))]
        return plan[1:4]

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True):
        program = program if program is not None \
            else ir.default_main_program()
        scope = scope if scope is not None else global_scope()
        fetch_names = [v.name if isinstance(v, ir.Variable) else str(v)
                       for v in (fetch_list or [])]
        program, reads, written = self._plan(program, fetch_names)
        feed = {n: self._to_device(program, n, v)
                for n, v in (feed or {}).items()}
        env = {}
        for n in reads:
            if n in feed:
                continue
            v = scope.find_var(n)
            if v is not None:
                if v.device != self.device:
                    raise ValueError(
                        "scope variable %r lives on %s but this executor "
                        "runs on %s" % (n, v.device, self.device))
                env[n] = v
        env.update(feed)

        ctx = TraceContext(key=step_key(program.random_seed, self._step),
                           training=True, program=program,
                           device=self.device)
        self._step += 1
        with torch.no_grad():
            run_block(ctx, program.global_block(), env)

        # write back state: persistables this block wrote (startup
        # initializers, in-place updates)
        b0 = program.global_block()
        for n in written:
            v = b0.vars.get(n)
            if v is not None and v.persistable and n in env:
                scope.set_var(n, env[n])

        missing = [n for n in fetch_names if n not in env]
        if missing:
            raise KeyError("fetch %s: not computed by the program"
                           % missing)
        fetches = [env[n] for n in fetch_names]
        if return_numpy:
            return [_to_numpy(f) for f in fetches]
        return fetches

    def _to_device(self, program, name, v):
        if isinstance(v, PackedSeq):
            return PackedSeq(self._to_device(program, name, v.data),
                             torch.as_tensor(v.lengths).to(self.device,
                                                           torch.int32))
        if isinstance(v, torch.Tensor):
            return v.to(self.device)
        if isinstance(v, (list, tuple)):
            var = _find_var(program, name)
            if var is not None and var.lod_level > 0:
                return self._to_device(program, name,
                                       _pack_ragged(v, var.dtype))
        return torch.as_tensor(np.asarray(v), device=self.device)


def _find_var(program, name):
    for b in program.blocks:
        if b.has_var_local(name):
            return b.vars[name]
    return None


def _to_numpy(v):
    if isinstance(v, PackedSeq):
        return PackedSeq(v.data.cpu().numpy(), v.lengths.cpu().numpy())
    return v.cpu().numpy()


def _pack_ragged(seqs, dtype):
    """list of per-example sequences (list/array [len_i, ...]) ->
    PackedSeq of numpy arrays, zero-padded to the longest."""
    np_dtype = np.dtype(dtype)
    arrs = [np.asarray(s, dtype=np_dtype) for s in seqs]
    lengths = np.asarray([a.shape[0] for a in arrs], dtype=np.int32)
    max_len = max(1, int(lengths.max()) if len(arrs) else 1)
    tail = arrs[0].shape[1:] if arrs else ()
    out = np.zeros((len(arrs), max_len) + tail, dtype=np_dtype)
    for i, a in enumerate(arrs):
        out[i, : a.shape[0]] = a
    return PackedSeq(torch.as_tensor(out, dtype=torch_dtype(np_dtype.name)),
                     torch.as_tensor(lengths))
