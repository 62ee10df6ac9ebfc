"""ctypes binding to the repository's host runtime (``native/src``).

The port's own binding to the C++ host runtime the JAX package binds in
its ``native.py``, with the same names:

  * RecordIOWriter / RecordIOScanner — chunked CRC-checked record storage
    (capability of paddle/fluid/recordio/{writer.h:22,scanner.h:26}).
  * BufferPool — pooled host staging allocator
    (capability of memory/detail/buddy_allocator.h:33).
  * RecordLoader — multithreaded shard prefetch queue
    (capability of operators/reader/* double-buffer/threaded readers).
  * stat_* / timer() — native scoped timers + chrome-trace events
    (capability of utils/Stat.h:230 + platform/profiler).
  * TaskQueue — elastic task lease/timeout/snapshot state machine
    (capability of go/master/service.go).

The five sources of ``native/Makefile``'s ``SRCS`` link neither Python
nor JAX. They are built here, at first use (nothing is built when the
module is imported), with one ``g++ -O2 -std=c++17 -fPIC -shared ...
-lz`` into ``build/torch_native/libptnative.so`` at the repository root
(gitignored), keyed by a hash of the sources, the flags and the
compiler's version (a library another toolchain built is rebuilt);
``native/build/`` is never written. A failed build raises with the
compiler's output: there is no pure-Python fallback. Files written here
are byte for byte the JAX package's (the same C++ writes them).
"""

import ctypes
import hashlib
import os
import subprocess
import threading

__all__ = ["lib", "RecordIOWriter", "RecordIOScanner", "write_recordio",
           "read_recordio", "num_records", "BufferPool", "RecordLoader",
           "TaskQueue", "stat_begin", "stat_end", "stat_report",
           "stat_reset", "timer", "evt_enable", "evt_record",
           "evt_dump_json"]

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(_ROOT, "native", "src")
BUILD_DIR = os.path.join(_ROOT, "build", "torch_native")
SO = os.path.join(BUILD_DIR, "libptnative.so")
#: the sources of native/Makefile's SRCS, in its order
SOURCES = ("recordio.cc", "bufpool.cc", "loader.cc", "stat.cc",
           "taskqueue.cc")
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-pthread")
_build_lock = threading.Lock()
_lib = None


def _digest():
    h = hashlib.sha256()
    for f in SOURCES + ("ptnative.h",):
        with open(os.path.join(_SRC_DIR, f), "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(CXX_FLAGS).encode())
    try:
        h.update(subprocess.run(["g++", "--version"], capture_output=True,
                                check=True).stdout)
    except (OSError, subprocess.CalledProcessError) as e:
        raise RuntimeError("building libptnative.so needs g++ on PATH: "
                           "%s" % e) from e
    return h.hexdigest()[:16]


def _build():
    """Compile the library unless the one on disk was built from these
    sources and flags by this compiler (its hash sits beside it).
    Returns its path."""
    stamp = SO + ".sha"
    digest = _digest()
    if os.path.exists(SO) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == digest:
                return SO
    os.makedirs(BUILD_DIR, exist_ok=True)
    # per-process names: concurrent first uses never read half a library
    tmp = "%s.%d.tmp" % (SO, os.getpid())
    cmd = ["g++", *CXX_FLAGS,
           *[os.path.join(_SRC_DIR, f) for f in SOURCES], "-lz", "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except subprocess.CalledProcessError as e:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(
            "building libptnative.so failed (%s):\n%s"
            % (" ".join(cmd), (e.stderr or b"").decode(errors="replace"))
        ) from e
    os.replace(tmp, SO)
    with open(stamp + ".%d.tmp" % os.getpid(), "w") as f:
        f.write(digest)
    os.replace(stamp + ".%d.tmp" % os.getpid(), stamp)
    return SO


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _build_lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            _declare(lib)
            _lib = lib
    return _lib


def _declare(lib):
    i64, i32, dbl = ctypes.c_int64, ctypes.c_int, ctypes.c_double
    cp, vp, u64 = ctypes.c_char_p, ctypes.c_void_p, ctypes.c_uint64
    pi64 = ctypes.POINTER(ctypes.c_int64)
    sig = {
        "rio_writer_open": (i64, [cp, i32, i32, i32]),
        "rio_writer_write": (i32, [i64, cp, i64]),
        "rio_writer_close": (i32, [i64]),
        "rio_scanner_open": (i64, [cp]),
        "rio_scanner_next": (i64, [i64]),
        "rio_scanner_fetch": (i32, [i64, vp]),
        "rio_scanner_close": (i32, [i64]),
        "rio_num_records": (i64, [cp]),
        "bp_create": (i64, [i64]),
        "bp_alloc": (vp, [i64, i64]),
        "bp_free": (i32, [i64, vp]),
        "bp_stats": (i32, [i64, pi64, pi64]),
        "bp_destroy": (i32, [i64]),
        "loader_create": (i64, [cp, i32, i32, i32, i32, u64]),
        "loader_next": (i64, [i64]),
        "loader_fetch": (i32, [i64, vp]),
        "loader_destroy": (i32, [i64]),
        "stat_begin": (i32, [cp]),
        "stat_end": (i32, []),
        "stat_report": (i64, [vp, i64]),
        "stat_reset": (i32, []),
        "evt_enable": (i32, [i32]),
        "evt_record": (i32, [cp, dbl, dbl, i64]),
        "evt_dump_json": (i64, [cp]),
        "tq_create": (i64, [i32]),
        "tq_add_task": (i32, [i64, cp, i64]),
        "tq_get_task": (i64, [i64, dbl, vp, i64, pi64]),
        "tq_task_finished": (i32, [i64, i64]),
        "tq_task_failed": (i32, [i64, i64]),
        "tq_check_timeouts": (i32, [i64]),
        "tq_counts": (i32, [i64, pi64, pi64, pi64, pi64]),
        "tq_all_done": (i32, [i64]),
        "tq_snapshot": (i64, [i64, vp, i64]),
        "tq_restore": (i32, [i64, cp, i64]),
        "tq_destroy": (i32, [i64]),
    }
    for name, (res, args) in sig.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args


class _LibProxy:
    def __getattr__(self, name):
        return getattr(_load(), name)


lib = _LibProxy()


class RecordIOWriter:
    """Chunked record writer (compressor: 'none' or 'zlib')."""

    def __init__(self, path, compressor="zlib", max_chunk_records=1000,
                 max_chunk_bytes=1 << 20):
        comp = {"none": 0, "zlib": 1}[compressor]
        self._h = lib.rio_writer_open(path.encode(), comp,
                                      max_chunk_records, max_chunk_bytes)
        if self._h < 0:
            raise IOError("cannot open %s for writing" % path)

    def write(self, record: bytes):
        if lib.rio_writer_write(self._h, record, len(record)) != 0:
            raise IOError("recordio write failed")

    def close(self):
        if self._h is not None:
            if lib.rio_writer_close(self._h) != 0:
                raise IOError("recordio flush failed")
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RecordIOScanner:
    def __init__(self, path):
        self._h = lib.rio_scanner_open(path.encode())
        if self._h < 0:
            raise IOError("cannot open %s" % path)

    def __iter__(self):
        return self

    def __next__(self):
        n = lib.rio_scanner_next(self._h)
        if n == -1:
            raise StopIteration
        if n < 0:
            raise IOError("corrupt recordio chunk (CRC mismatch)")
        buf = ctypes.create_string_buffer(int(n))
        lib.rio_scanner_fetch(self._h, buf)
        return buf.raw

    def close(self):
        if self._h is not None:
            lib.rio_scanner_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_recordio(path, records, **kw):
    with RecordIOWriter(path, **kw) as w:
        for r in records:
            w.write(r)


def read_recordio(path):
    with RecordIOScanner(path) as s:
        return list(s)


def num_records(path):
    n = lib.rio_num_records(path.encode())
    if n < 0:
        raise IOError("cannot count records in %s" % path)
    return int(n)


class BufferPool:
    """Pooled, 64-byte-aligned host staging allocator."""

    def __init__(self, max_cached_bytes=256 << 20):
        self._h = lib.bp_create(max_cached_bytes)

    def alloc(self, size):
        p = lib.bp_alloc(self._h, size)
        if not p:
            raise MemoryError("bufpool alloc(%d) failed" % size)
        return p

    def free(self, ptr):
        if lib.bp_free(self._h, ptr) != 0:
            raise ValueError("pointer not from this pool")

    def stats(self):
        in_use, cached = ctypes.c_int64(), ctypes.c_int64()
        lib.bp_stats(self._h, ctypes.byref(in_use), ctypes.byref(cached))
        return {"in_use": in_use.value, "cached": cached.value}

    def destroy(self):
        if self._h is not None:
            lib.bp_destroy(self._h)
            self._h = None


class RecordLoader:
    """Background multithreaded recordio prefetcher; iterate for records."""

    def __init__(self, files, num_threads=2, queue_capacity=256,
                 num_epochs=1, shuffle=False, seed=0):
        if isinstance(files, str):
            files = [files]
        self._h = lib.loader_create(";".join(files).encode(), num_threads,
                                    queue_capacity, num_epochs,
                                    1 if shuffle else 0, seed)
        if self._h < 0:
            raise IOError("loader_create failed (no files?)")

    def __iter__(self):
        return self

    def __next__(self):
        n = lib.loader_next(self._h)
        if n == -1:
            raise StopIteration
        if n < 0:
            raise IOError("loader read error")
        buf = ctypes.create_string_buffer(int(n))
        lib.loader_fetch(self._h, buf)
        return buf.raw

    def close(self):
        if self._h is not None:
            lib.loader_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def stat_begin(name):
    lib.stat_begin(name.encode())


def stat_end():
    lib.stat_end()


class timer:
    """``with native.timer("fwd"):`` — native scoped timer
    (REGISTER_TIMER equivalent)."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        stat_begin(self.name)

    def __exit__(self, *exc):
        stat_end()


def stat_report():
    n = lib.stat_report(None, 0)
    buf = ctypes.create_string_buffer(int(n) + 1)
    lib.stat_report(buf, n + 1)
    return buf.value.decode()


def stat_reset():
    lib.stat_reset()


def evt_enable(on=True):
    lib.evt_enable(1 if on else 0)


def evt_record(name, ts_us, dur_us, tid=0):
    lib.evt_record(name.encode(), ts_us, dur_us, tid)


def evt_dump_json(path):
    return int(lib.evt_dump_json(path.encode()))


class TaskQueue:
    """Elastic task queue: lease w/ timeout, failure retirement, snapshot."""

    def __init__(self, failure_max=3):
        self._h = lib.tq_create(failure_max)

    def add_task(self, payload: bytes):
        lib.tq_add_task(self._h, payload, len(payload))

    def get_task(self, timeout_s=60.0):
        """Returns (task_id, payload) or None if nothing available.
        Atomic under the native lock — safe for concurrent workers."""
        cap = 1 << 16
        while True:
            buf = ctypes.create_string_buffer(cap)
            n = ctypes.c_int64()
            tid = lib.tq_get_task(self._h, timeout_s, buf, cap,
                                  ctypes.byref(n))
            if tid == -1:
                return None
            if tid == -3:  # payload larger than buffer: retry sized
                cap = int(n.value)
                continue
            if tid < 0:
                raise RuntimeError("tq_get_task failed")
            return int(tid), buf.raw[: int(n.value)]

    def task_finished(self, task_id):
        return lib.tq_task_finished(self._h, task_id) == 0

    def task_failed(self, task_id):
        return lib.tq_task_failed(self._h, task_id) == 0

    def check_timeouts(self):
        return int(lib.tq_check_timeouts(self._h))

    def counts(self):
        vals = [ctypes.c_int64() for _ in range(4)]
        lib.tq_counts(self._h, *[ctypes.byref(v) for v in vals])
        return {"todo": vals[0].value, "pending": vals[1].value,
                "done": vals[2].value, "discarded": vals[3].value}

    def all_done(self):
        return lib.tq_all_done(self._h) == 1

    def snapshot(self) -> bytes:
        n = int(lib.tq_snapshot(self._h, None, 0))
        while True:  # the queue may grow between sizing and filling
            buf = ctypes.create_string_buffer(n)
            got = int(lib.tq_snapshot(self._h, buf, n))
            if got <= n:
                return buf.raw[:got]
            n = got

    def restore(self, blob: bytes):
        if lib.tq_restore(self._h, blob, len(blob)) != 0:
            raise ValueError("corrupt task-queue snapshot")

    def destroy(self):
        if self._h is not None:
            lib.tq_destroy(self._h)
            self._h = None
