"""LoDTensor: the reference's user-facing variable-length tensor handle.

Capability parity: `paddle/fluid/framework/lod_tensor.h` plus its pybind
surface (`set`, `set_lod`, `lod`, `get_dims`, `get_float_element`) —
the object reference benchmark scripts construct by hand to feed ragged
batches (`benchmark/fluid/machine_translation.py to_lodtensor`).

Copied from the JAX package (it imports numpy only). Internally the
framework computes on PackedSeq (padded dense + lengths,
``core/lower.py``); LoDTensor is the host-side offset-vector view. The
Executor converts on feed: a LoDTensor fed to a ``lod_level > 0``
variable becomes a PackedSeq on the executor's device, one fed to a
``lod_level == 0`` variable its dense array. ``from_packed`` and
``from_value`` build one from a fetched value.
"""

import numpy as np

__all__ = ["LoDTensor"]


def _host(v):
    """numpy of a numpy array or of a torch tensor on any device (the
    port's fetches with ``return_numpy=False`` are device tensors)."""
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


class LoDTensor:
    def __init__(self, data=None, lod=None):
        self._data = None if data is None else np.asarray(data)
        self._lod = [list(l) for l in lod] if lod else []

    # -- reference pybind surface --

    def set(self, array, place=None):
        """Set the flattened payload. ``place`` is accepted for parity;
        the copy to the device is deferred to the Executor feed path."""
        self._data = np.asarray(array)

    def set_lod(self, lod):
        self._lod = [list(l) for l in lod]

    def lod(self):
        return [list(l) for l in self._lod]

    def get_dims(self):
        if self._data is None:
            return []
        return list(self._data.shape)

    def get_float_element(self, i):
        return float(np.asarray(self._data).ravel()[i])

    def __array__(self, dtype=None):
        a = np.asarray(self._data)
        return a if dtype is None else a.astype(dtype)

    def numpy(self):
        return np.asarray(self._data)

    # -- conversion helpers used by the Executor --

    def to_ragged(self):
        """Split the flattened payload by the last LoD level into the
        per-sequence list the PackedSeq packer consumes."""
        if not self._lod:
            return None
        offsets = self._lod[-1]
        data = np.asarray(self._data)
        return [data[offsets[i]:offsets[i + 1]]
                for i in range(len(offsets) - 1)]

    @classmethod
    def from_packed(cls, pseq):
        """PackedSeq -> LoDTensor (flattened valid rows + offsets)."""
        data = _host(pseq.data)
        lengths = _host(pseq.lengths).astype(np.int64)
        rows = [data[i, :lengths[i]] for i in range(data.shape[0])]
        flat = (np.concatenate(rows, axis=0) if rows
                else data.reshape((0,) + data.shape[2:]))
        offsets = [0]
        for n in lengths:
            offsets.append(offsets[-1] + int(n))
        return cls(flat, [offsets])

    @classmethod
    def from_value(cls, value):
        t = cls()
        value = _host(value)
        if value.ndim == 0:
            # reference fetches are rank>=1 (mean_op emits [1]); callers
            # index the fetched handle (machine_translation.py:317)
            value = value.reshape(1)
        t.set(value)
        return t

    def __repr__(self):
        return "LoDTensor(shape=%s, lod=%s)" % (self.get_dims(), self._lod)
