"""Reader-decorator combinators.

Capability parity: `python/paddle/reader/decorator.py:15-236` (map_readers,
shuffle, chain, compose, buffered, firstn, xmap_readers). A reader is a
zero-arg callable returning an iterable of samples. Everything but the
two staging readers (``device_chunks``, ``double_buffer``, which copy to
the card) is plain Python.
"""

import itertools
import queue
import random
import threading

import numpy as np
import torch

from paddle_tpu_torch import telemetry
from paddle_tpu_torch.core.lower import PackedSeq
from paddle_tpu_torch.core.place import default_place

__all__ = ["map_readers", "buffered", "compose", "chain", "shuffle",
           "firstn", "xmap_readers", "cache", "double_buffer",
           "super_batch", "device_chunks", "ElasticShardPlan",
           "elastic_shard"]


def map_readers(func, *readers):
    def reader():
        rs = [r() for r in readers]
        for items in zip(*rs):
            yield func(*items)
    return reader


def shuffle(reader, buf_size):
    def data_reader():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                random.shuffle(buf)
                for b in buf:
                    yield b
                buf = []
        if buf:
            random.shuffle(buf)
            for b in buf:
                yield b
    return data_reader


def chain(*readers):
    def reader():
        for r in readers:
            for e in r():
                yield e
    return reader


def compose(*readers, **kwargs):
    check_alignment = kwargs.pop("check_alignment", True)

    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def reader():
        rs = [r() for r in readers]
        if check_alignment:
            for outputs in zip(*rs):
                yield sum(map(make_tuple, outputs), ())
        else:
            for outputs in itertools.zip_longest(*rs):
                yield sum((make_tuple(o) for o in outputs if o is not None), ())
    return reader


def buffered(reader, size):
    """Prefetch up to `size` samples in a background thread (the host-side
    equivalent of the reference's double-buffer reader op).

    Every queue entry is a tagged ("item"|"end"|"error", payload) tuple:
    a worker exception travels through the SAME ordered channel as the
    data and re-raises in the consumer after the samples that preceded
    it — and a sample that happens to BE an exception instance is plain
    data, not a control signal. (The untagged scheme could confuse the
    two and strand the consumer on ``q.get()``.)"""

    def data_reader():
        r = reader()
        q = queue.Queue(maxsize=size)

        def worker():
            try:
                for d in r:
                    q.put(("item", d))
            except BaseException as e:  # propagate to the consumer
                q.put(("error", e))
            else:
                q.put(("end", None))

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            # timed_get also records producer-starved time: the consumer
            # blocking on an empty prefetch queue means the pipeline,
            # not the device, is the bottleneck
            kind, payload = (telemetry.timed_get(q, "buffered")
                             if telemetry.enabled() else q.get())
            if kind == "end":
                break
            if kind == "error":
                raise payload
            yield payload
    return data_reader


def firstn(reader, n):
    def data_reader():
        for i, item in enumerate(reader()):
            if i == n:
                break
            yield item
    return data_reader


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Parallel map over a reader with worker threads."""
    def data_reader():
        in_q = queue.Queue(buffer_size)
        out_q = queue.Queue(buffer_size)
        end = object()

        def feed():
            for i, sample in enumerate(reader()):
                in_q.put((i, sample))
            for _ in range(process_num):
                in_q.put(end)

        def work():
            while True:
                item = in_q.get()
                if item is end:
                    out_q.put(end)
                    return
                i, sample = item
                out_q.put((i, mapper(sample)))

        threading.Thread(target=feed, daemon=True).start()
        for _ in range(process_num):
            threading.Thread(target=work, daemon=True).start()

        finished = 0
        pending = {}
        next_idx = 0
        while finished < process_num:
            item = (telemetry.timed_get(out_q, "xmap")
                    if telemetry.enabled() else out_q.get())
            if item is end:
                finished += 1
                continue
            i, mapped = item
            if not order:
                yield mapped
            else:
                pending[i] = mapped
                while next_idx in pending:
                    yield pending.pop(next_idx)
                    next_idx += 1
        for i in sorted(pending):
            yield pending[i]
    return data_reader


def cache(reader):
    all_data = []

    def data_reader():
        if not all_data:
            all_data.extend(reader())
        return iter(all_data)
    return data_reader


def super_batch(reader, k, drop_last=True):
    """Stack K consecutive batches into one ``[K, ...]`` super-batch —
    the staging unit of ``Executor.run_chunk`` (K training steps per
    dispatch). Works on tuple/list batches (stacks per field) and on
    feed-dict batches (stacks per key; PackedSeq values pad to the
    chunk's common max time dim via ``data_feeder.stack_feeds``).
    ``drop_last=False`` emits a final short chunk (its leading dim is
    the remainder — a second captured graph, so the default drops it)."""
    def stack(buf):
        if isinstance(buf[0], dict):
            from paddle_tpu_torch.data_feeder import stack_feeds

            return stack_feeds(buf)
        if isinstance(buf[0], (tuple, list)):
            return type(buf[0])(
                np.stack([np.asarray(b[i]) for b in buf])
                for i in range(len(buf[0])))
        return np.stack([np.asarray(b) for b in buf])

    def data_reader():
        buf = []
        for b in reader():
            buf.append(b)
            if len(buf) == k:
                yield stack(buf)
                buf = []
        if buf and not drop_last:
            yield stack(buf)
    return data_reader


def _cuda_device(place, who):
    """The CUDA device a staging reader copies to: ``place`` None means
    ``CUDAPlace(0)``, as ``Executor()``'s default. Raises where torch
    finds no card, or when ``place`` names no CUDA device: a staging
    reader never hands back host arrays."""
    if not torch.cuda.is_available():
        raise RuntimeError("%s: no CUDA device is available; it stages "
                           "batches on the card and has no CPU form" % who)
    dev = default_place(place)
    if dev.type != "cuda":
        raise ValueError("%s stages batches on a CUDA device; %r is not "
                         "one" % (who, place))
    return dev


def _field_to(x, dev):
    """One field on ``dev``: a PackedSeq's data and int32 lengths, a
    tensor, or anything numpy takes. Host values go through pinned
    memory with a non-blocking copy on the current stream; the copy's
    pinned buffer is held by PyTorch's caching host allocator until the
    copy is done."""
    if isinstance(x, PackedSeq):
        lengths = x.lengths.to(torch.int32) \
            if isinstance(x.lengths, torch.Tensor) \
            else np.asarray(x.lengths, np.int32)
        return PackedSeq(_field_to(x.data, dev), _field_to(lengths, dev))
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
    if x.device.type == "cpu":
        x = x.pin_memory()
    return x.to(dev, non_blocking=True)


def _batch_to(batch, dev):
    """A batch on ``dev``, field by field: a feed dict by key, a tuple or
    list by position, else the batch as one field."""
    if isinstance(batch, dict):
        return {n: _field_to(v, dev) for n, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(_field_to(v, dev) for v in batch)
    return _field_to(batch, dev)


def _tensors(value):
    """The tensors of a staged batch (``_batch_to``'s output)."""
    vals = value.values() if isinstance(value, dict) else \
        value if isinstance(value, (tuple, list)) else [value]
    for v in vals:
        if isinstance(v, PackedSeq):
            yield v.data
            yield v.lengths
        elif isinstance(v, torch.Tensor):
            yield v


def device_chunks(reader, place=None):
    """Chunked device staging: stages super-batch N+1 on the consumer's
    thread and stream once chunk N has been handed over. Each field goes
    from pinned host memory by a non-blocking copy on the current stream,
    so the steps queued after it on that stream read it in order; a
    PackedSeq's data and lengths stay a PackedSeq. What overlaps chunk
    N's queued steps is the host side only (collation, pinning, queueing
    the copy): the copy itself is ordered after chunk N's kernels on the
    same stream, so the transfer does not run under compute
    (``double_buffer`` copies on a side stream). Compose as
    ``device_chunks(super_batch(buffered(r, 2), k))`` for
    ``Executor.run_chunk``: disk IO and collation still prefetch in the
    background; only the host-to-device copy runs on the consumer's
    thread. ``place`` None means ``CUDAPlace(0)``; with no card this
    raises (it never hands back host arrays)."""
    dev = _cuda_device(place, "device_chunks")

    def data_reader():
        it = reader()
        try:
            cur = _batch_to(next(it), dev)
        except StopIteration:
            return
        for nxt in it:
            yield cur                    # the consumer queues the chunk
            cur = _batch_to(nxt, dev)    # queued behind chunk N's steps
        yield cur
    return data_reader


def double_buffer(reader, place=None, size=2):
    """Overlap host-to-device copies with compute (the device half of the
    reference's create_double_buffer_reader op, operators/reader/
    create_double_buffer_reader_op.cc): a background thread copies up to
    ``size`` upcoming batches to the card on a side CUDA stream of its
    own and records an event after each. Before a batch is handed over,
    the consumer's current stream waits on that event, and every tensor
    of the batch is marked as used on that stream (``record_stream``),
    so the caching allocator does not reuse its memory while the
    consumer's work on it is queued. Batches come back with the same
    structure (a tuple or list by position, a feed dict by key), as CUDA
    tensors. ``place`` None means ``CUDAPlace(0)``; with no card this
    raises (it never hands back host arrays)."""
    dev = _cuda_device(place, "double_buffer")

    def staged():
        stream = torch.cuda.Stream(device=dev)
        for batch in reader():
            with torch.cuda.device(dev), torch.cuda.stream(stream):
                value = _batch_to(batch, dev)
                done = torch.cuda.Event()
                done.record(stream)
            yield value, done

    def data_reader():
        for value, done in buffered(staged, size)():
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(done)
            for t in _tensors(value):
                t.record_stream(consumer)
            yield value
    return data_reader


class ElasticShardPlan:
    """Re-keyable modulo sharding of one global sample stream.

    Every worker walks the SAME deterministic source reader and owns
    the global indices where ``index % num_shards == shard_id``. On an
    elastic membership change the recovery loop calls
    ``rekey(num_shards, shard_id, at_index)`` on every survivor with
    the SAME boundary index: indices before the boundary keep the old
    keying, indices at/after it use the new one — so across the
    reshard no example is dropped and none is read twice (the parity
    test in tests/test_deploy.py walks both sides of the boundary).

    The segment list is monotone in ``at_index``; ``assigned`` is
    thread-safe against a concurrent ``rekey`` from the recovery
    thread."""

    def __init__(self, num_shards=1, shard_id=0, start_index=0):
        if not (0 <= int(shard_id) < int(num_shards)):
            raise ValueError("shard_id %r outside [0, %r)"
                             % (shard_id, num_shards))
        self._lock = threading.Lock()
        # (first global index, num_shards, shard_id), ascending; a
        # JOINING worker passes start_index = the reshard boundary and
        # owns nothing before it (those indices belong to the old world)
        self._segments = [(int(start_index), int(num_shards),
                           int(shard_id))]

    def rekey(self, num_shards, shard_id, at_index):
        """All indices >= ``at_index`` switch to the new keying."""
        if not (0 <= int(shard_id) < int(num_shards)):
            raise ValueError("shard_id %r outside [0, %r)"
                             % (shard_id, num_shards))
        at_index = int(at_index)
        with self._lock:
            last = self._segments[-1]
            if at_index < last[0]:
                raise ValueError(
                    "rekey boundary %d precedes the current segment "
                    "start %d (boundaries must not move backwards)"
                    % (at_index, last[0]))
            seg = (at_index, int(num_shards), int(shard_id))
            if at_index == last[0]:
                self._segments[-1] = seg
            else:
                self._segments.append(seg)

    def segment_for(self, index):
        """The ``(at_index, num_shards, shard_id)`` keying ``index``
        falls under."""
        index = int(index)
        with self._lock:
            segs = self._segments
            # segments are few (one per membership epoch); reverse
            # linear scan beats bisect bookkeeping
            for seg in reversed(segs):
                if index >= seg[0]:
                    return seg
            return None   # before this worker joined the stream

    def assigned(self, index):
        seg = self.segment_for(index)
        if seg is None:
            return False
        _, n, s = seg
        return int(index) % n == s

    def snapshot(self):
        with self._lock:
            return list(self._segments)


def elastic_shard(reader, plan):
    """Shard ``reader`` by a live :class:`ElasticShardPlan`: yield only
    the global indices the plan assigns to this worker, re-evaluating
    per sample so a mid-stream ``rekey`` takes effect at exactly its
    boundary index."""

    def data_reader():
        for i, sample in enumerate(reader()):
            if plan.assigned(i):
                yield sample

    return data_reader
