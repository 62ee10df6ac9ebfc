"""Fault-tolerant checkpointing: CRC-verified, atomic, keep-last-N, async.

Capability parity with the Go pserver checkpoints (go/pserver/service.go:346
checkpoint(): periodic, CRC32-verified, meta alongside; LoadCheckpoint :175
verifies before restoring), the fluid save/load_persistables resume flow
(SURVEY §5.4) and the JAX package's ``distributed/checkpoint.py``, whose
files these are byte for byte: tensors stream through the native chunked
recordio (per-chunk CRC32, ``native.py``) with a whole-file CRC in the
JSON meta; writes are atomic (tmp + rename); a background thread makes
saves async so the train loop never blocks on storage.

The port updates state tensors in place (``Executor``), where the JAX
package donates and replaces them: a save therefore copies every value
to the host on the caller's thread before it returns (a blocking copy),
and the writer thread holds no device reference. bfloat16 values go as
their 2-byte words under the JAX package's dtype string
(``recordio_writer``); the guard's counters, int64 in the port, go as the
JAX package's uint32. A restore puts each value on the device of the
value the scope already holds under that name, else on ``place``
(default ``CUDAPlace(0)``, which raises with no card: pass ``CPUPlace()``
to restore onto the CPU).
"""

import json
import os
import threading
import time
import zlib

import numpy as np
import torch

from paddle_tpu_torch import fault
from paddle_tpu_torch import native
from paddle_tpu_torch import recordio_writer as rw
from paddle_tpu_torch.core.lower import PackedSeq
from paddle_tpu_torch.core.place import default_place
from paddle_tpu_torch.core.scope import global_scope

__all__ = ["CheckpointManager", "save_checkpoint", "load_checkpoint",
           "latest_checkpoint"]

_META_SUFFIX = ".meta.json"

# the guard's counters (guard.K_GOOD, guard.K_SKIPPED): int64 in the
# port, uint32 in the JAX package, whose layout checkpoints keep
_UINT32_STATE = ("guard@good_steps", "guard@skipped_steps")


def host_value(name, val):
    """``(numpy array, dtype name)`` of one state value, copied to the
    host: a ``ShardedState`` whole (a collective, as ``np.asarray`` of it
    is), bfloat16 as its words (``recordio_writer.host_array``), the
    guard's counters as uint32."""
    from paddle_tpu_torch.parallel.collectives import ShardedState

    if isinstance(val, ShardedState):
        val = val.full()
    arr, dt = rw.host_array(val)
    if name in _UINT32_STATE and arr.dtype == np.int64:
        arr, dt = arr.astype(np.uint32), "uint32"
    return arr, dt


def restore_tensor(scope, name, arr, dtype_name=None, place=None):
    """A tensor of the host array ``arr`` for scope var ``name``: on the
    device of the value the scope holds under that name, else on
    ``place``; an integer value takes the integer dtype of the value it
    replaces (the JAX package keeps int64 as int32)."""
    cur = scope.find_var(name)
    if isinstance(cur, PackedSeq):
        cur = cur.data
    if isinstance(cur, torch.Tensor):
        device = cur.device
    else:
        device = default_place(place)
    t = rw.to_tensor(arr, dtype_name, device)
    if isinstance(cur, torch.Tensor) and cur.dtype != t.dtype \
            and not cur.dtype.is_floating_point \
            and not t.dtype.is_floating_point:
        t = t.to(cur.dtype)
    return t


def _gather_state(scope, program=None, names=None):
    """name -> numpy array(s) for the checkpointable vars.

    Selection precedence: explicit ``names`` > ``program``'s persistable
    vars (the Go-pserver/fluid parity set: parameters, optimizer state, BN
    running stats). With NEITHER given, the WHOLE scope is snapshotted —
    including fetch buffers and temporaries — which inflates checkpoints
    and, on restore, clobbers non-parameter scope state; pass ``program``
    for anything but throwaway scopes."""
    if names is None:
        if program is not None:
            names = [v.name for v in program.list_vars() if v.persistable]
        else:
            names = scope.local_var_names()
    state = {}
    for n in names:
        val = scope.find_var(n)
        if val is None:
            continue
        if isinstance(val, PackedSeq):
            state[n + "@DATA"] = host_value(n, val.data)[0]
            state[n + "@LEN"] = host_value(n, val.lengths)[0]
        else:
            state[n] = host_value(n, val)[0]
    return state


def _ckpt_file(dirname, step):
    return os.path.join(dirname, "ckpt-%012d.rio" % step)


def save_checkpoint(dirname, step, scope=None, program=None, names=None,
                    extra_meta=None, state=None, compressor="zlib"):
    """Synchronous checkpoint of scope state (or a pre-gathered ``state``
    dict of name -> numpy array). Returns the data file path.
    ``compressor``: the record chunks', "zlib" (the JAX package's bytes)
    or "none"; either package reads both. zlib shrinks float32 state by
    about a quarter and writes it at ~18 MB/s a thread (a 708.7 MB
    transformer generation in ~40 s on an H100's host, where a chunk of
    four steps takes 0.2 s: chip_smoke.py's phase 6o)."""
    if state is None:
        scope = scope if scope is not None else global_scope()
        state = _gather_state(scope, program, names)
    os.makedirs(dirname, exist_ok=True)
    path = _ckpt_file(dirname, step)
    tmp = path + ".tmp"
    with native.RecordIOWriter(tmp, compressor=compressor) as w:
        for name in sorted(state):
            w.write(rw.serialize_sample(
                (np.frombuffer(name.encode(), dtype=np.uint8), state[name])))
    if fault._active:
        # a torn-write rule truncates the STAGED file and raises; the
        # rename below never commits it
        fault.fire("checkpoint.data_write", path=tmp)
    with open(tmp, "rb") as f:
        blob = f.read()
    crc = zlib.crc32(blob)
    os.replace(tmp, path)
    meta = {"step": int(step), "file": os.path.basename(path),
            "crc32": crc, "bytes": len(blob), "timestamp": time.time(),
            "num_vars": len(state)}
    meta.update(extra_meta or {})
    fault.atomic_write(path + _META_SUFFIX, json.dumps(meta).encode(),
                       site="checkpoint.meta_write")
    return path


def _verify(dirname, meta):
    path = os.path.join(dirname, meta["file"])
    if not os.path.exists(path):
        return False
    with open(path, "rb") as f:
        blob = f.read()
    return len(blob) == meta["bytes"] and zlib.crc32(blob) == meta["crc32"]


def _read_metas(dirname):
    metas = []
    for fn in os.listdir(dirname):
        if fn.endswith(_META_SUFFIX):
            try:
                with open(os.path.join(dirname, fn)) as f:
                    metas.append(json.load(f))
            except (ValueError, OSError):
                continue
    return sorted(metas, key=lambda m: -m["step"])


def latest_checkpoint(dirname):
    """Newest step whose data file passes CRC verification, or None.
    Corrupt/partial checkpoints (e.g. preempted mid-write) are skipped —
    the LoadCheckpoint semantics of the Go pserver."""
    if not os.path.isdir(dirname):
        return None
    for meta in _read_metas(dirname):
        if _verify(dirname, meta):
            return meta
    return None


def load_checkpoint(dirname, scope=None, step=None, place=None):
    """Restores the latest (or given-step) verified checkpoint into scope.
    Returns the meta dict, or None when no valid checkpoint exists.
    ``place``: where a value the scope does not hold yet goes (default
    ``CUDAPlace(0)``)."""
    scope = scope if scope is not None else global_scope()
    if step is not None:
        meta_path = _ckpt_file(dirname, step) + _META_SUFFIX
        if not os.path.exists(meta_path):
            return None
        with open(meta_path) as f:
            meta = json.load(f)
        if not _verify(dirname, meta):
            raise IOError("checkpoint step %d failed CRC verification" % step)
    else:
        meta = latest_checkpoint(dirname)
        if meta is None:
            return None
    state = {}
    for blob in native.RecordIOScanner(os.path.join(dirname, meta["file"])):
        name_arr, val = rw.deserialize_sample(blob)
        state[bytes(name_arr).decode()] = val
    packed = {n[: -len("@DATA")] for n in state if n.endswith("@DATA")}
    for n, v in state.items():
        if n.endswith("@DATA") or n.endswith("@LEN"):
            continue
        scope.set_var(n, restore_tensor(scope, n, v, place=place))
    for base in packed:
        cur = scope.find_var(base)
        ref = cur if isinstance(cur, PackedSeq) else None
        device = ref.data.device if ref is not None \
            else default_place(place)
        scope.set_var(base, PackedSeq(
            rw.to_tensor(state[base + "@DATA"], device=device),
            rw.to_tensor(state[base + "@LEN"], device=device)))
    return meta


class CheckpointManager:
    """Periodic / async checkpointing with retention.

    ``mgr = CheckpointManager(dir, keep_max=3, save_interval_steps=100)``;
    call ``mgr.save(step)`` every step — it no-ops between intervals, and
    with ``async_save=True`` copies state to the host on the caller's
    thread, then writes in the background. ``mgr.restore()`` resumes from
    the newest verified checkpoint, onto ``place`` for values the scope
    does not hold yet. ``compressor``: as ``save_checkpoint``'s."""

    def __init__(self, dirname, keep_max=5, save_interval_steps=1,
                 async_save=False, program=None, scope=None, place=None,
                 compressor="zlib"):
        self.dirname = dirname
        self.keep_max = keep_max
        self.save_interval_steps = save_interval_steps
        self.async_save = async_save
        self.program = program
        self.scope = scope
        self.place = place
        self.compressor = compressor
        self._last_saved = None
        self._pending = None  # in-flight async thread
        self._error = None    # exception raised by an async write
        self._lock = threading.Lock()

    def save(self, step, force=False, extra_meta=None):
        if not force and self._last_saved is not None and \
                step - self._last_saved < self.save_interval_steps:
            return None
        self._last_saved = step
        scope = self.scope or global_scope()
        # every value on the host before the next step writes it in place
        state = _gather_state(scope, self.program)

        def write():
            path = save_checkpoint(self.dirname, step, state=state,
                                   extra_meta=extra_meta,
                                   compressor=self.compressor)
            self._retain()
            return path

        if self.async_save:
            self.wait()  # also surfaces a previous write's failure

            def write_capture():
                try:
                    write()
                except BaseException as e:
                    self._error = e

            with self._lock:
                self._pending = threading.Thread(target=write_capture,
                                                 daemon=True)
                self._pending.start()
            return _ckpt_file(self.dirname, step)
        return write()

    def wait(self):
        with self._lock:
            t, self._pending = self._pending, None
        if t is not None:
            t.join()
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def restore(self, step=None):
        self.wait()
        return load_checkpoint(self.dirname, scope=self.scope, step=step,
                               place=self.place)

    def _retain(self):
        for meta in _read_metas(self.dirname)[self.keep_max:]:
            for suffix in ("", _META_SUFFIX):
                try:
                    os.remove(os.path.join(self.dirname,
                                           meta["file"] + suffix))
                except OSError:
                    pass
