"""Sharded checkpoints: save the pieces each rank holds, restore onto ANY
mesh.

Capability parity: the Go pserver checkpoints *sharded* optimizer state
per server and resumes from it (`go/pserver/service.go:346` checkpoint
with per-shard meta, `:175` LoadCheckpoint), and the JAX package's
``distributed/sharded_checkpoint.py``, whose manifests and shard files
these are: either package restores the other's generations.

* **The pieces a rank holds.** The JAX package walks each array's
  ``addressable_shards``; the port runs one process a rank, and a rank's
  pieces are what its scope holds. A ``collectives.ShardedState`` (a
  ZeRO-1 accumulator, an error-feedback residual, a 'pp' stage's or an
  'ep' rank's slice) is this rank's stretch of the value's flat
  elements, written as the boxes of the global shape that stretch
  covers (a leading-dim slice is one box). Any other value is the whole
  value. Across a world of more than one rank the pieces' indices are
  exchanged (one ``all_gather_object``), and a piece that a lower rank
  holds too is left to it: each piece is written once (a replicated
  value by rank 0).
* **Files.** Each rank writes its own ``.p{rank}`` shard file (the
  ``process_index``); rank 0 merges the partial manifests once every
  peer's exists for this attempt (the same nonce rule as the JAX
  package), so any rank reads any piece from the shared directory.
* **Restore** is reshard-on-restore: each rank assembles its target
  slice of every value from the saved pieces that overlap it. Targets
  come from ``ParallelExecutor.state_shardings`` (``{}``: the plain
  ``Executor``'s whole values). A 'pp'/'ep'-cut value becomes this
  rank's leading-dim slice (a ``ShardedState`` over its line); every
  other value is restored whole, and the executor's next step brings
  it to its layout (``collectives.ensure_zero_state`` keeps a ZeRO
  accumulator's rows and folds an old world's ``[world, rows]`` layout,
  ``ensure_state`` folds an error-feedback residual). A rank outside
  the target mesh keeps nothing of it (the value leaves its scope).
* **Live reshard** (``reshard_state``) runs the same assembly from an
  in-memory ``snapshot_state`` cut; across ranks the cut is exchanged
  over the default process group, which every live rank takes part in.

Values are copied to the host on the caller's thread (the port updates
state tensors in place): an async writer never holds a device tensor.
"""

import json
import os
import threading
import time
import warnings
import zlib

import numpy as np
import torch
import torch.distributed as dist

from paddle_tpu_torch import fault
from paddle_tpu_torch import native
from paddle_tpu_torch import recordio_writer as rw
from paddle_tpu_torch import telemetry
from paddle_tpu_torch.distributed.checkpoint import host_value, \
    restore_tensor

__all__ = ["save_sharded_checkpoint", "load_sharded_checkpoint",
           "latest_sharded_checkpoint", "quarantine_step",
           "snapshot_state", "reshard_state", "ShardedCheckpointManager"]

_MANIFEST = "sharded-%012d.manifest.json"
_SHARDS = "sharded-%012d.p%03d.rio"
_QUARANTINE_DIR = "quarantine"


def _world():
    """(rank, world size) of the default process group; (0, 1) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _persistable_names(scope, program):
    names = [v.name for v in program.list_vars() if v.persistable]
    if getattr(program, "guard", None) is not None:
        # the guard's state (loss scale, clean streak, skip counter) is
        # scope-only, not a program var, but survives restarts with the
        # params: a rollback restores the PRE-divergence scale too
        from paddle_tpu_torch import guard

        names.extend(guard.STATE_NAMES)
    # the error-feedback residuals are scope-only too: exactly the
    # gradient signal not yet transmitted
    from paddle_tpu_torch.parallel.collectives import state_names

    names.extend(n for n in state_names(scope) if n not in names)
    return [n for n in names if scope.find_var(n) is not None]


def _flat_boxes(shape, lo, hi):
    """[(box, start, stop)]: boxes of a row-major array of ``shape`` that
    together cover its flat elements ``[lo, hi)``, each one a contiguous
    flat stretch ``[start, stop)`` (a box: one ``(start, stop)`` a
    dimension)."""
    if lo >= hi:
        return []
    if not shape:
        return [((), lo, hi)]
    inner = int(np.prod(shape[1:], dtype=np.int64))

    def row(r, a, b):
        return [(((r, r + 1),) + sub, s + r * inner, e + r * inner)
                for sub, s, e in _flat_boxes(shape[1:], a, b)]

    first, last = lo // inner, (hi - 1) // inner
    if first == last:
        return row(first, lo - first * inner, hi - first * inner)
    out, tail = [], []
    r0, r1 = first, last + 1
    if lo % inner:
        out += row(first, lo % inner, inner)
        r0 = first + 1
    if hi % inner:
        tail = row(last, 0, hi % inner)
        r1 = last
    if r0 < r1:
        out.append((((r0, r1),) + tuple((0, int(d)) for d in shape[1:]),
                    r0 * inner, r1 * inner))
    return out + tail


def _held_pieces(name, val):
    """(global shape, dtype name, [(index, numpy piece)]) of what this
    rank holds of ``val``, on the host."""
    from paddle_tpu_torch.parallel.collectives import ShardedState

    if not isinstance(val, ShardedState):
        arr, dt = host_value(name, val)
        return (list(arr.shape), dt,
                [(tuple((0, int(d)) for d in arr.shape), arr)])
    shape = val.full_shape
    local = val.as_subclass(torch.Tensor)
    arr, dt = host_value(name, local)
    flat = arr.reshape(-1)
    nelem = int(np.prod(shape, dtype=np.int64))
    pos = val.ranks.index(dist.get_rank()) if dist.is_initialized() else 0
    lo = pos * flat.size
    hi = min(lo + flat.size, nelem)
    pieces = [(box, flat[a - lo:b - lo].reshape(
        tuple(e - s for s, e in box)))
        for box, a, b in _flat_boxes(shape, lo, hi)]
    return list(shape), dt, pieces


def snapshot_state(scope, program, names=None):
    """Consistent host-side cut of the sharded state:
    {name: (shape, dtype, [(index, numpy piece), ...])}: the pieces this
    rank writes, copied to the host HERE, on the training thread (the
    next step updates the device tensors in place). Across a world of
    more than one rank every rank must call it (the pieces' indices are
    exchanged, and a piece a lower rank holds too is dropped)."""
    names = names if names is not None else _persistable_names(scope,
                                                               program)
    snap = {}
    for name in sorted(names):
        val = scope.find_var(name)
        if val is None:
            continue
        snap[name] = _held_pieces(name, val)
    rank, world = _world()
    if world > 1:
        mine = [(n, idx) for n, (_s, _d, ps) in snap.items()
                for idx, _p in ps]
        held = [None] * world
        dist.all_gather_object(held, mine)
        lower = set()
        for r in range(rank):
            lower.update((n, tuple(tuple(i) for i in idx))
                         for n, idx in held[r])
        snap = {n: (s, d, [(idx, p) for idx, p in ps
                           if (n, idx) not in lower])
                for n, (s, d, ps) in snap.items()}
    return snap


class _SnapshotReader:
    """The restore-path piece reader over an IN-MEMORY ``snapshot_state``
    cut instead of shard files: ``read`` indexes a flat piece list, so
    ``_assemble`` serves a live reshard exactly as it serves a disk
    restore — same overlap math, same coverage check."""

    def __init__(self, pieces):
        self._pieces = pieces  # flat [numpy piece]

    def read(self, fname, record):
        return self._pieces[record]


def _target(sharding, shape):
    """What this rank holds of a value of ``shape`` under ``sharding``:
    ("whole", None), ("none", None) for a rank outside the sharding's
    mesh, or ("rows", (axis, box, group)) for a 'pp'/'ep'-cut value."""
    if sharding is None or not shape:
        return "whole", None
    mesh = sharding.mesh
    rank, _world_size = _world()
    if rank not in mesh.ranks:
        return "none", None
    spec = tuple(sharding.spec)
    if spec and spec[0] in ("pp", "ep") and spec[0] in mesh.shape:
        axis = spec[0]
        n = mesh.shape[axis]
        rows = shape[0] // n
        i = mesh.axis_rank(axis)
        box = ((i * rows, (i + 1) * rows),) + tuple((0, d)
                                                    for d in shape[1:])
        return "rows", (axis, box, mesh.axis_group(axis))
    return "whole", None


def _place(scope, name, shape, dtype_name, sharding, fill, place):
    """Set scope var ``name`` to this rank's target of the value
    (``fill(box)`` assembles a box on the host). Returns the bytes
    placed."""
    from paddle_tpu_torch.parallel.collectives import ShardedState

    kind, info = _target(sharding, shape)
    if kind == "none":
        scope.erase(name)
        return 0
    if kind == "rows":
        axis, box, group = info
        t = restore_tensor(scope, name, fill(box), dtype_name, place)
        scope.set_var(name, ShardedState.wrap(t, shape, group))
        return t.numel() * t.element_size()
    full = fill(tuple((0, d) for d in shape)).reshape(shape)
    t = restore_tensor(scope, name, full, dtype_name, place)
    scope.set_var(name, t)
    return t.numel() * t.element_size()


def reshard_state(scope, program, target_shardings, names=None,
                  state=None, place=None):
    """Live reshard WITHOUT a disk round-trip: re-materialize every
    persistable var from a host-side ``snapshot_state`` cut onto the
    shardings of a NEW mesh (``ParallelExecutor.state_shardings`` after
    ``set_mesh``). This is the elastic scale-up/down hand-off path —
    the same reshard-on-restore assembly as ``load_sharded_checkpoint``
    with the recordio tier cut out.

    ``state`` defaults to a fresh snapshot of ``scope``. Across a world
    of more than one rank the cuts are exchanged over the default process
    group (every live rank calls this, also one the new mesh leaves
    out), so each rank assembles its target from pieces any rank held.
    A cut that does not cover a value fails the coverage check with
    ``IOError`` (the caller then spills through the checkpoint
    directory). Returns the bytes placed onto the new layout."""
    if state is None:
        state = snapshot_state(scope, program, names)
    t0 = time.perf_counter()
    _rank, world = _world()
    if world > 1:
        cuts = [None] * world
        dist.all_gather_object(cuts, state)
        merged = {}
        for cut in cuts:
            for name, (shape, dtype, pieces) in cut.items():
                merged.setdefault(name, (shape, dtype, []))[2].extend(
                    pieces)
        state = merged
    moved = 0
    for name in sorted(state):
        if names is not None and name not in names:
            continue
        shape, dtype, pieces = state[name]
        shape = tuple(shape)
        reader = _SnapshotReader([p for _idx, p in pieces])
        plist = [{"index": [list(i) for i in idx], "file": None,
                  "record": rec}
                 for rec, (idx, _p) in enumerate(pieces)]

        def fill(box, _plist=plist, _reader=reader, _dtype=dtype):
            return _assemble(box, _plist, _reader, rw.host_dtype(_dtype))

        _place(scope, name, shape, dtype, target_shardings.get(name), fill,
               place)
        moved += int(np.prod(shape, dtype=np.int64)) \
            * rw.host_dtype(dtype).itemsize
    if telemetry.enabled():
        telemetry.record_checkpoint("reshard",
                                    time.perf_counter() - t0, moved)
    return moved


def save_sharded_checkpoint(dirname, step, scope=None, program=None,
                            process_index=0, num_processes=1, names=None,
                            extra_meta=None, state=None,
                            barrier_timeout=120.0, nonce=None,
                            compressor="zlib"):
    """Write this process's shards + (from process 0, once every
    process's partial manifest exists) the merged manifest. Returns the
    manifest path. Atomic: tmp + rename, CRC per file.

    Every partial manifest is stamped with an attempt ``nonce`` that the
    merged manifest records, so a crashed PRIOR save at the same step
    cannot leak stale piece tables into a merged manifest: with an
    explicit shared ``nonce`` (e.g. the job incarnation id, passed
    identically by every process) process 0 accepts only partials of
    THIS attempt; without one, each partial must CRC-verify against the
    shard files currently on disk — a partial referencing a prior
    attempt's (since-replaced or torn) shard contents is treated as
    missing until its writer re-saves. ``compressor``: the shard
    file's chunks (``checkpoint.save_checkpoint``'s)."""
    if state is None:
        state = snapshot_state(scope, program, names)
    t_save = time.perf_counter()
    os.makedirs(dirname, exist_ok=True)
    attempt = (str(nonce) if nonce is not None
               else "%x.%d" % (time.time_ns(), os.getpid()))
    fname = _SHARDS % (step, process_index)
    tmp = os.path.join(dirname, fname + ".tmp")
    pieces_meta = []
    with native.RecordIOWriter(tmp, compressor=compressor) as w:
        rec = 0
        for name in sorted(state):
            _shape, dtype, pieces = state[name]
            for idx, piece in pieces:
                w.write(rw.serialize_sample(
                    (np.frombuffer(name.encode(), dtype=np.uint8), piece)))
                pieces_meta.append({
                    "var": name, "index": [list(p) for p in idx],
                    "file": fname, "record": rec, "dtype": dtype,
                })
                rec += 1
    if fault._active:
        # torn-write rules truncate the STAGED file and raise — the crash
        # window of a preemption mid-shard-write; the generation is never
        # committed because the rename below never runs
        fault.fire("checkpoint.shard_write", path=tmp)
    with open(tmp, "rb") as f:
        crc = zlib.crc32(f.read())
    os.replace(tmp, os.path.join(dirname, fname))

    manifest = {
        "step": int(step),
        "timestamp": time.time(),
        "files": {fname: {"crc32": crc}},
        "vars": {name: {"shape": shape, "dtype": dtype}
                 for name, (shape, dtype, _p) in state.items()},
        "pieces": pieces_meta,
    }
    manifest.update(extra_meta or {})
    mpath = os.path.join(dirname, _MANIFEST % step)
    if process_index != 0:
        ppath = os.path.join(
            dirname, "sharded-%012d.manifest.p%03d" % (step, process_index))
        fault.atomic_write(
            ppath,
            json.dumps({"nonce": attempt, "pieces": pieces_meta,
                        "files": manifest["files"],
                        "vars": manifest["vars"]}).encode(),
            site="checkpoint.manifest_write")
        if telemetry.enabled():
            telemetry.record_checkpoint(
                "save", time.perf_counter() - t_save,
                os.path.getsize(os.path.join(dirname, fname)))
        return ppath

    # process 0 merges — but only after EVERY peer's partial manifest
    # exists *for this attempt*: a manifest missing a peer's pieces would
    # verify clean yet be unrestorable, and a STALE partial from a
    # crashed prior save would verify clean yet reference dead contents
    expect = ["sharded-%012d.manifest.p%03d" % (step, i)
              for i in range(1, num_processes)]
    deadline = time.time() + barrier_timeout
    parts = {}
    crc_cache = {}  # avoid re-reading unchanged shards at poll rate
    while True:
        missing = []
        for fn in expect:
            if fn in parts:
                continue
            try:
                with open(os.path.join(dirname, fn)) as f:
                    part = json.load(f)
            except (OSError, ValueError):
                missing.append(fn)  # absent, or a peer mid-write
                continue
            if nonce is not None and part.get("nonce") != attempt:
                missing.append(fn)  # a prior attempt's partial
                continue
            if nonce is None and _verify_files(dirname, part,
                                               crc_cache) is not None:
                # the partial's piece table references shard contents no
                # longer on disk: wait for its writer to finish THIS
                # attempt
                missing.append(fn)
                continue
            parts[fn] = part
        if not missing:
            # TOCTOU guard: a peer may have re-saved its shard AFTER its
            # partial was accepted; re-verify the accepted set against
            # the disk just before merging
            stale = [fn for fn, part in parts.items()
                     if nonce is None
                     and _verify_files(dirname, part,
                                       crc_cache) is not None]
            if not stale:
                break
            for fn in stale:
                del parts[fn]
            missing = stale
        if time.time() > deadline:
            raise TimeoutError(
                "sharded save step %d: peer manifests missing or stale "
                "(prior attempt / shard mismatch): %s" % (step, missing))
        time.sleep(0.05)
    for fn in expect:
        part = parts[fn]
        manifest["pieces"].extend(part["pieces"])
        manifest["files"].update(part["files"])
        for name, vm in part.get("vars", {}).items():
            manifest["vars"].setdefault(name, vm)
    manifest["nonce"] = attempt
    manifest["peer_nonces"] = {fn: parts[fn].get("nonce")
                               for fn in expect}
    # fsync'd temp + rename: the manifest is the generation's commit
    # record, so it must never exist half-written under its final name
    fault.atomic_write(mpath, json.dumps(manifest).encode(),
                       site="checkpoint.manifest_write")
    if telemetry.enabled():
        telemetry.record_checkpoint(
            "save", time.perf_counter() - t_save,
            os.path.getsize(os.path.join(dirname, fname)))
    return mpath


def _verify_files(dirname, manifest, crc_cache=None):
    """None when every shard file passes CRC, else the failure reason.
    ``crc_cache`` ({path: (size, mtime_ns, crc)}) lets a polling caller
    (the save barrier) avoid re-reading unchanged shards."""
    for fname, meta in manifest["files"].items():
        path = os.path.join(dirname, fname)
        try:
            st = os.stat(path)
        except OSError:
            return "missing_shard"
        cached = crc_cache.get(path) if crc_cache is not None else None
        if cached is not None and cached[:2] == (st.st_size,
                                                st.st_mtime_ns):
            crc = cached[2]
        else:
            with open(path, "rb") as f:
                crc = zlib.crc32(f.read())
            if crc_cache is not None:
                crc_cache[path] = (st.st_size, st.st_mtime_ns, crc)
        if crc != meta["crc32"]:
            return "crc_mismatch"
    return None


def quarantine_step(dirname, step, reason):
    """Move every file of generation ``step`` into ``quarantine/`` —
    preserved for forensics, never rescanned as a restore candidate.
    Returns the file names moved."""
    qdir = os.path.join(dirname, _QUARANTINE_DIR)
    os.makedirs(qdir, exist_ok=True)
    moved = []
    for fn in sorted(os.listdir(dirname)):
        if fn.startswith("sharded-%012d." % step):
            try:
                os.replace(os.path.join(dirname, fn),
                           os.path.join(qdir, fn))
                moved.append(fn)
            except OSError:
                pass
    if telemetry.enabled():
        telemetry.record_quarantine(reason)
    warnings.warn(
        "sharded checkpoint step %d failed verification (%s); %d file(s) "
        "quarantined under %s" % (step, reason, len(moved), qdir),
        RuntimeWarning)
    return moved


def _manifest_steps(dirname, newest_first=True):
    return sorted(
        (int(fn.split("-")[1].split(".")[0])
         for fn in os.listdir(dirname)
         if fn.startswith("sharded-") and fn.endswith(".manifest.json")),
        reverse=newest_first)


def latest_sharded_checkpoint(dirname, quarantine=True,
                              require_clean_health=False,
                              before_step=None):
    """Newest step whose manifest parses and every shard file passes
    CRC, or None. Generations that fail verification are quarantined
    (``quarantine=False`` leaves them in place) and the scan falls back
    to the previous complete generation.

    ``require_clean_health=True`` is the rollback-to-last-good scan
    (recovery after a ``guard.Divergence``): generations whose manifest
    carries ``health.clean == False`` are additionally quarantined
    (reason ``diverged``) and the scan falls through to the newest
    generation recorded healthy; manifests without a health block count
    as clean. ``before_step`` additionally rejects generations at or
    past the estimated divergence onset."""
    if not os.path.isdir(dirname):
        return None
    for step in _manifest_steps(dirname):
        try:
            with open(os.path.join(dirname, _MANIFEST % step)) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            bad = "manifest_corrupt"
        else:
            bad = _verify_files(dirname, manifest)
            if bad is None:
                if require_clean_health and (
                        not manifest.get("health", {}).get("clean", True)
                        or (before_step is not None
                            and manifest["step"] >= before_step)):
                    bad = "diverged"
                else:
                    return manifest
        if quarantine:
            quarantine_step(dirname, step, bad)
    return None


class _PieceReader:
    """Lazy per-file record access (reads a shard file once, on demand)."""

    def __init__(self, dirname):
        self.dirname = dirname
        self._files = {}

    def read(self, fname, record):
        if fname not in self._files:
            self._files[fname] = list(native.RecordIOScanner(
                os.path.join(self.dirname, fname)))
        _name, piece = rw.deserialize_sample(self._files[fname][record])
        return piece


def _assemble(requested, pieces, reader, dtype):
    """Fill the requested global slice from overlapping saved pieces.
    ``requested``: tuple of (start, stop); ``pieces``: manifest entries.
    Coverage is tracked with a boolean mask, not summed volumes, so an
    index saved twice cannot mask a genuinely missing region."""
    shape = tuple(b - a for a, b in requested)
    out = np.zeros(shape, dtype=dtype)
    covered = np.zeros(shape, dtype=bool)
    for p in pieces:
        pidx = [tuple(x) for x in p["index"]]
        ov = []
        for (ra, rb), (pa, pb) in zip(requested, pidx):
            a, b = max(ra, pa), min(rb, pb)
            if a >= b:
                ov = None
                break
            ov.append((a, b))
        if ov is None:
            continue
        src = reader.read(p["file"], p["record"])
        src_sl = tuple(slice(a - pa, b - pa)
                       for (a, b), (pa, pb) in zip(ov, pidx))
        dst_sl = tuple(slice(a - ra, b - ra)
                       for (a, b), (ra, rb) in zip(ov, requested))
        out[dst_sl] = src[src_sl]
        covered[dst_sl] = True
    if not covered.all():
        raise IOError(
            "sharded checkpoint is missing data for slice %r "
            "(%d of %d elements found)"
            % (requested, int(covered.sum()), int(np.prod(shape))))
    return out


def load_sharded_checkpoint(dirname, scope, target_shardings,
                            step=None, names=None, quarantine=True,
                            require_clean_health=False, before_step=None,
                            place=None):
    """Restore onto the CURRENT mesh: each rank sets every var to its
    target slice under ``target_shardings[name]`` (from
    ``ParallelExecutor.state_shardings`` of the restoring run — its mesh
    may be a different shape than the saving run's), assembled from the
    saved pieces that overlap it; vars without a target are restored
    whole. Values go onto the device of the value the scope holds, else
    onto ``place`` (default ``CUDAPlace(0)``). Returns the manifest.

    With ``step=None`` the newest generation passing verification is
    restored; corrupt generations are quarantined and skipped. With an
    explicit ``step``, verification failure quarantines (unless
    ``quarantine=False``) and raises ``IOError``."""
    t_restore = time.perf_counter()
    if step is None:
        manifest = latest_sharded_checkpoint(
            dirname, quarantine=quarantine,
            require_clean_health=require_clean_health,
            before_step=before_step)
        if manifest is None:
            return None
    else:
        try:
            with open(os.path.join(dirname, _MANIFEST % step)) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            # a torn/missing manifest is the same failure class as a bad
            # CRC: quarantine and raise the documented IOError
            if quarantine:
                quarantine_step(dirname, step, "manifest_corrupt")
            raise IOError("sharded checkpoint step %s failed "
                          "verification (manifest_corrupt)" % step)
        bad = _verify_files(dirname, manifest)
        if bad is not None:
            if quarantine:
                quarantine_step(dirname, step, bad)
            raise IOError("sharded checkpoint step %s failed "
                          "verification (%s)" % (step, bad))

    by_var = {}
    for p in manifest["pieces"]:
        by_var.setdefault(p["var"], []).append(p)
    reader = _PieceReader(dirname)

    for name, meta in manifest["vars"].items():
        if names is not None and name not in names:
            continue
        pieces = by_var.get(name, [])
        if not pieces:
            continue
        shape = tuple(meta["shape"])
        dtype = rw.host_dtype(meta["dtype"])

        def fill(box, _pieces=pieces, _dtype=dtype):
            return _assemble(box, _pieces, reader, _dtype)

        _place(scope, name, shape, meta["dtype"],
               target_shardings.get(name), fill, place)
    if telemetry.enabled():
        telemetry.record_checkpoint(
            "restore", time.perf_counter() - t_restore,
            sum(os.path.getsize(os.path.join(dirname, fn))
                for fn in manifest["files"]
                if os.path.exists(os.path.join(dirname, fn))))
    return manifest


class ShardedCheckpointManager:
    """Async periodic sharded checkpointing with keep-last-N retention
    (the CheckpointManager contract over the sharded writer). Across
    ranks every rank runs one, with its rank as ``process_index`` and
    the world as ``num_processes``; rank 0 merges and prunes."""

    def __init__(self, dirname, keep_max=5, save_interval_steps=1,
                 process_index=0, num_processes=1, place=None,
                 compressor="zlib"):
        self.dirname = dirname
        self.keep_max = keep_max
        self.save_interval_steps = save_interval_steps
        self.process_index = process_index
        # threaded through to save_sharded_checkpoint so process 0 waits
        # on the peer-manifest barrier in multi-process runs
        self.num_processes = num_processes
        self.place = place
        #: the shard files' chunks (``save_sharded_checkpoint``'s), also
        #: of the elastic loop's spill generations
        self.compressor = compressor
        self._thread = None
        self._error = None

    def save(self, step, scope, program, force=False, extra_meta=None):
        """``extra_meta`` merges into the generation's manifest — the
        recovery loop records the guard's ``health`` block here, which
        is what rollback-to-last-good later restores by."""
        if not force and step % self.save_interval_steps != 0:
            return None
        self.wait()
        # every piece on the HOST before the next step updates the
        # tensors in place; serialization/IO happens on the worker thread
        state = snapshot_state(scope, program)

        def write():
            try:
                save_sharded_checkpoint(self.dirname, step, state=state,
                                        process_index=self.process_index,
                                        num_processes=self.num_processes,
                                        extra_meta=extra_meta,
                                        compressor=self.compressor)
                self._retain()
            except BaseException as e:
                # surfaces on the training thread at the next wait()/
                # save()/restore()
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()
        return step

    def restore_last_healthy(self, scope, target_shardings,
                             before_step=None):
        """Rollback-to-last-good: restore the newest generation whose
        manifest ``health`` block is clean (and that predates
        ``before_step``), quarantining the newer diverged generations
        (reason ``diverged``) for forensics."""
        return self.restore(scope, target_shardings,
                            require_clean_health=True,
                            before_step=before_step)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def poll(self):
        """Re-raise a stashed async write failure WITHOUT joining the
        in-flight writer."""
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore(self, scope, target_shardings, step=None,
                require_clean_health=False, before_step=None):
        self.wait()
        return load_sharded_checkpoint(
            self.dirname, scope, target_shardings, step=step,
            require_clean_health=require_clean_health,
            before_step=before_step, place=self.place)

    def _retain(self):
        if self.process_index != 0 or not os.path.isdir(self.dirname):
            return
        steps = _manifest_steps(self.dirname, newest_first=False)
        for step in steps[:-self.keep_max] if self.keep_max else []:
            for fn in os.listdir(self.dirname):
                if fn.startswith("sharded-%012d." % step):
                    try:
                        os.remove(os.path.join(self.dirname, fn))
                    except OSError:
                        pass
