"""DataFeeder: python minibatch -> feed dict of numpy arrays.

Capability parity: `python/paddle/fluid/data_feeder.py:69` (DataFeeder,
DataToLoDTensorConverter), as the JAX package's ``data_feeder.py``
builds it. Dense features stack into one array; lod_level>0 features
pack into a ``PackedSeq`` of numpy arrays (padded + lengths), the pad
length rounded up to a multiple (``pad_multiple``) so that a chunk's
feeds keep few distinct shapes. The executor moves the arrays to its
device.
"""

import numpy as np

from paddle_tpu_torch.core import ir
from paddle_tpu_torch.core.lower import PackedSeq

__all__ = ["DataFeeder", "stack_feeds"]


def stack_feeds(feeds):
    """K per-step feed dicts -> ONE super-batch feed for
    ``Executor.run_chunk``: dense values stack to ``[K, ...]``;
    PackedSeq values pad to the chunk's common max time dim (the
    per-sequence lengths keep the truth, same contract as the LoD
    batch-concat) and stack to data ``[K, batch, maxT, ...]`` /
    lengths ``[K, batch]``."""
    if not feeds:
        raise ValueError("stack_feeds needs at least one feed dict")
    names = set(feeds[0])
    for f in feeds[1:]:
        if set(f) != names:
            raise ValueError(
                "feed dicts disagree on keys: %s vs %s"
                % (sorted(names), sorted(f)))
    out = {}
    for name in feeds[0]:
        vals = [f[name] for f in feeds]
        if isinstance(vals[0], PackedSeq):
            maxt = max(v.data.shape[1] for v in vals)
            datas = [np.asarray(v.data) for v in vals]
            datas = [
                np.pad(d, [(0, 0), (0, maxt - d.shape[1])]
                       + [(0, 0)] * (d.ndim - 2)) if d.shape[1] < maxt
                else d for d in datas]
            out[name] = PackedSeq(
                np.stack(datas),
                np.stack([np.asarray(v.lengths) for v in vals]))
        else:
            out[name] = np.stack([np.asarray(v) for v in vals])
    return out


def _round_up(n, mult):
    return ((n + mult - 1) // mult) * mult


class DataFeeder:
    def __init__(self, feed_list, place=None, program=None, pad_multiple=32):
        self.feed_vars = [
            v if isinstance(v, ir.Variable)
            else (program or ir.default_main_program()).global_block().var(v)
            for v in feed_list]
        self.place = place
        # pad sequence lengths up to a multiple: fewer distinct shapes
        self.pad_multiple = pad_multiple

    def feed(self, iterable):
        rows = list(iterable)
        out = {}
        for i, var in enumerate(self.feed_vars):
            col = [r[i] for r in rows]
            if var.lod_level > 0:
                out[var.name] = self._pack(col, var)
            else:
                arr = np.asarray(col, dtype=var.dtype)
                shape = var.shape
                if shape is not None:
                    feat = [int(s) for s in shape[1:]]
                    if feat and all(s > 0 for s in feat):
                        # the reference's DataToLoDTensorConverter reshapes
                        # each sample to the DECLARED shape: readers yield
                        # flat rows (784 floats for a [1,28,28] var,
                        # scalars for a [1] label) — data_feeder.py:29
                        want = int(np.prod(feat))
                        have = int(np.prod(arr.shape[1:])) if arr.ndim else 0
                        if arr.ndim >= 1 and have == want and \
                                list(arr.shape[1:]) != feat:
                            arr = arr.reshape((arr.shape[0],) + tuple(feat))
                out[var.name] = arr
        return out

    def feed_chunk(self, minibatches):
        """K minibatches (each an iterable of rows, all the same batch
        size) -> one stacked super-batch feed dict whose every value
        carries a leading ``[K, ...]`` axis — the staging unit of
        ``Executor.run_chunk(feed_chunk, k)``: one host->device copy
        covers K training steps."""
        feeds = [self.feed(b) for b in minibatches]
        batch_sizes = {next(iter(f.values())).shape[0] if f else 0
                       for f in feeds}
        if len(batch_sizes) > 1:
            raise ValueError(
                "feed_chunk minibatches must share one batch size, got %s"
                % sorted(batch_sizes))
        return stack_feeds(feeds)

    def _pack(self, col, var):
        arrs = [np.asarray(s, dtype=var.dtype) for s in col]
        arrs = [a.reshape(-1) if a.ndim == 0 else a for a in arrs]
        lengths = np.asarray([a.shape[0] for a in arrs], dtype=np.int32)
        max_len = max(1, int(lengths.max()))
        max_len = _round_up(max_len, self.pad_multiple)
        tail = arrs[0].shape[1:]
        buf = np.zeros((len(arrs), max_len) + tail, dtype=var.dtype)
        for i, a in enumerate(arrs):
            buf[i, : a.shape[0]] = a
        return PackedSeq(buf, lengths)
