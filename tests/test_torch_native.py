"""The port's host runtime (``paddle_tpu_torch/native.py``) and sample
serialization (``recordio_writer.py``) against the JAX package's.

Both bind the same C++ sources of ``native/src``; the port builds its own
library into ``build/torch_native/`` (never ``native/build/``). The same
records give the same file bytes from either package, each package's
scanner reads the other's files and finds the same corruption (the
cases of ``tests/test_native.py``), the same ``TaskQueue`` call sequence
gives the same states and snapshots, ``serialize_sample`` gives the same
bytes for float32, int64, 0-d and bfloat16 values (the port writes a
bfloat16 tensor as its 2-byte words under the JAX package's ``'<V2'``),
and ``convert_reader_to_recordio_file(s)`` write the same files.
"""

import json
import os
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu import native as jnative
from paddle_tpu import recordio_writer as jrw
from paddle_tpu_torch import native as tnative
from paddle_tpu_torch import recordio_writer as trw

PACKAGES = {"jax": jnative, "port": tnative}


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_the_port_builds_its_own_library():
    """The library the port loads is its own build, from native/src's
    five SRCS, under build/torch_native/ (the JAX package's native/build/
    is not the port's)."""
    tnative._load()
    assert tnative._lib._name == tnative.SO
    assert os.path.dirname(tnative.SO).endswith(
        os.path.join("build", "torch_native"))
    assert tnative.SOURCES == ("recordio.cc", "bufpool.cc", "loader.cc",
                               "stat.cc", "taskqueue.cc")
    with open(tnative.SO + ".sha") as f:
        assert f.read().strip() == tnative._digest()


@pytest.mark.parametrize("kw", [
    dict(compressor="zlib", max_chunk_records=2),
    dict(compressor="none", max_chunk_bytes=512)])
def test_same_records_same_bytes_both_ways(tmp_path, kw):
    recs = [b"hello", b"", b"x" * 10000, "unicode é".encode()] + [
        bytes([i]) * (i * 17 + 1) for i in range(50)]
    for name, nat in PACKAGES.items():
        nat.write_recordio(str(tmp_path / name), recs, **kw)
    assert _bytes(tmp_path / "jax") == _bytes(tmp_path / "port")
    for writer in PACKAGES:
        for name, nat in PACKAGES.items():
            assert nat.read_recordio(str(tmp_path / writer)) == recs
            assert nat.num_records(str(tmp_path / writer)) == len(recs)


@pytest.mark.parametrize("damage", ["payload_bit", "length_header"])
def test_corruption_found_by_both_scanners(tmp_path, damage):
    """A flipped payload bit (CRC) and a compressed-length header set to
    ~4 GiB (no huge allocation) raise IOError in either package's
    scanner, on either package's file."""
    for writer, nat in PACKAGES.items():
        path = str(tmp_path / writer)
        if damage == "payload_bit":
            nat.write_recordio(path, [b"a" * 1000], compressor="none")
            blob = bytearray(_bytes(path))
            blob[len(blob) // 2] ^= 0xFF
        else:
            nat.write_recordio(path, [b"x" * 100], compressor="none")
            blob = bytearray(_bytes(path))
            blob[12:16] = (0xFFFFFFF0).to_bytes(4, "little")
        with open(path, "wb") as f:
            f.write(bytes(blob))
        for reader in PACKAGES.values():
            with pytest.raises(IOError):
                reader.read_recordio(path)


def test_loader_reads_the_other_packages_shards(tmp_path):
    for writer, nat in PACKAGES.items():
        for i in range(3):
            nat.write_recordio(str(tmp_path / ("%s%d" % (writer, i))),
                               [("f%d-r%d" % (i, j)).encode()
                                for j in range(5)])
    for writer in PACKAGES:
        files = [str(tmp_path / ("%s%d" % (writer, i))) for i in range(3)]
        got = {}
        for name, nat in PACKAGES.items():
            with nat.RecordLoader(files, num_threads=2, num_epochs=2) as ld:
                got[name] = sorted(ld)
        assert got["jax"] == got["port"]
        assert len(got["port"]) == 30 and got["port"].count(b"f1-r3") == 2


def test_bufpool_stats_and_timers(tmp_path):
    """The allocator's size classes and the scoped timers and trace
    events behave alike."""
    out = {}
    for name, nat in PACKAGES.items():
        pool = nat.BufferPool(max_cached_bytes=1 << 20)
        p1 = pool.alloc(1000)
        pool.free(p1)
        p2 = pool.alloc(900)
        s1 = pool.stats()
        pool.free(p2)
        with pytest.raises(ValueError):
            pool.free(12345)
        out[name] = (p1 % 64, p2 == p1, s1, pool.stats())
        pool.destroy()
        nat.stat_reset()
        nat.evt_enable(True)
        with nat.timer("outer_" + name):
            with nat.timer("inner"):
                time.sleep(0.005)
        nat.evt_record("manual", 100.0, 5.0, tid=7)
        rep = nat.stat_report()
        trace = str(tmp_path / (name + ".json"))
        n = nat.evt_dump_json(trace)
        nat.evt_enable(False)
        nat.stat_reset()
        assert "outer_" + name in rep and "inner" in rep and n >= 2
        with open(trace) as f:
            names = [e["name"] for e in json.load(f)["traceEvents"]]
        assert "outer_" + name in names and "manual" in names
    assert out["jax"] == out["port"] == (
        0, True, {"in_use": 1024, "cached": 0}, {"in_use": 0, "cached": 1024})


def _queue_story(nat):
    """tests/test_native.py's lease cycle, timeout and snapshot: every
    answer and snapshot along the way."""
    log = []
    q = nat.TaskQueue(failure_max=2)
    for i in range(4):
        q.add_task(b"task-%d" % i)
    log.append(q.get_task(timeout_s=60))
    log += [q.task_finished(0), q.task_finished(0)]
    tid, _ = q.get_task()
    log.append(q.task_failed(tid))
    log.append(q.get_task()[0])
    log.append(q.snapshot())
    q.task_finished(2)
    q.get_task()
    q.task_finished(3)
    log.append(q.get_task()[0])
    q.task_failed(1)
    log += [q.counts(), q.all_done(), q.snapshot()]
    q.destroy()
    q = nat.TaskQueue(failure_max=5)
    q.add_task(b"slow")
    tid, _ = q.get_task(timeout_s=0.05)
    log.append(q.get_task())
    time.sleep(0.08)
    log.append(q.check_timeouts())
    log.append(q.get_task(timeout_s=60))
    q.task_finished(tid)
    log.append(q.counts())
    q.destroy()
    q = nat.TaskQueue(failure_max=3)
    for i in range(3):
        q.add_task(b"p%d" % i)
    q.get_task()
    snap = q.snapshot()
    log.append(snap)
    q.destroy()
    return log, snap


def test_taskqueue_same_states_and_snapshots():
    """The same call sequence: the same answers, counts and snapshot
    bytes; each package restores the other's snapshot (a leased task
    goes back to todo) and refuses garbage."""
    jlog, jsnap = _queue_story(jnative)
    tlog, tsnap = _queue_story(tnative)
    assert tlog == jlog
    for snap in (jsnap, tsnap):
        for nat in PACKAGES.values():
            q = nat.TaskQueue()
            q.restore(snap)
            c = q.counts()
            assert c["todo"] == 3 and c["pending"] == 0
            assert sorted(q.get_task()[0] for _ in range(3)) == [0, 1, 2]
            with pytest.raises(ValueError):
                q.restore(b"garbage")
            q.destroy()


_SAMPLES = [
    ("float32", lambda: np.arange(6, dtype=np.float32).reshape(2, 3)),
    ("int64", lambda: np.array([[3], [-7]], dtype=np.int64)),
    ("scalar_0d", lambda: np.float32(2.5)),
    ("python_int", lambda: 7),
    ("tuple", lambda: (np.ones((2, 2), np.float32), np.int64(4))),
]


@pytest.mark.parametrize("name,make", _SAMPLES, ids=[s[0] for s in _SAMPLES])
def test_serialize_sample_same_bytes(name, make):
    """numpy fields and the same values as tensors give the JAX
    package's bytes; each package deserializes the other's."""
    sample = make()
    blob = jrw.serialize_sample(sample)
    assert trw.serialize_sample(sample) == blob

    def as_tensor(v):
        return torch.from_numpy(np.asarray(v)) if isinstance(
            v, np.ndarray) else v

    tsample = tuple(as_tensor(v) for v in sample) \
        if isinstance(sample, tuple) else as_tensor(sample)
    assert trw.serialize_sample(tsample) == blob
    for a, b in zip(jrw.deserialize_sample(blob),
                    trw.deserialize_sample(blob)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_serialize_bfloat16_same_bytes_bitwise():
    """A bfloat16 tensor goes as the JAX package's bfloat16 array: the
    same 2-byte words under ``'<V2'``; read back, the port's tensor has
    the same bits (no ml_dtypes in the port)."""
    x = np.array([[1.5, -2.0, 3.140625], [0.0, 1e-3, -65504.0]],
                 dtype=np.float32)
    jb = jrw.serialize_sample(x.astype(ml_dtypes.bfloat16))
    t = torch.from_numpy(x).bfloat16()
    assert trw.serialize_sample(t) == jb
    assert b"<V2" in jb
    (back,) = trw.deserialize_sample(jb)
    got = trw.to_tensor(back)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), t.view(torch.int16))
    # a host bfloat16 array (the port's V2 words) writes the same record
    assert trw.serialize_sample(trw.host_array(t)[0]) == jb


def test_convert_reader_same_files(tmp_path):
    def reader():
        for i in range(7):
            yield (np.arange(3, dtype=np.float32) + i, np.int64(i))

    for name, rw in (("jax", jrw), ("port", trw)):
        n = rw.convert_reader_to_recordio_file(str(tmp_path / name),
                                               reader, max_num_records=3)
        assert n == 7
        paths = rw.convert_reader_to_recordio_files(
            str(tmp_path / (name + "_s")), 3, reader)
        assert [os.path.basename(p) for p in paths] == [
            "%s_s-%05d" % (name, i) for i in range(3)]
    assert _bytes(tmp_path / "jax") == _bytes(tmp_path / "port")
    for i in range(3):
        assert _bytes(tmp_path / ("jax_s-%05d" % i)) == \
            _bytes(tmp_path / ("port_s-%05d" % i))
    got = sorted(int(s[1]) for s in trw.recordio_sample_reader(
        [str(tmp_path / ("jax_s-%05d" % i)) for i in range(3)])())
    assert got == list(range(7))
