"""Sample serialization + reader->recordio conversion.

Capability parity: `python/paddle/fluid/recordio_writer.py`
(convert_reader_to_recordio_file) over the native chunked recordio
(``native.py``; reference format paddle/fluid/recordio/header.h), and
the JAX package's ``recordio_writer.py``: the same records, byte for
byte.

A sample is a tuple of fields; each field is serialized self-describingly
(dtype, shape, raw bytes) — no pickle, so records are language-neutral and
safe to load. A field may be a numpy array, a scalar or a tensor (copied
to the host). bfloat16, which numpy lacks, goes as its 2-byte words under
the dtype string ``'<V2'``, the string the JAX package's bfloat16 arrays
write; :func:`deserialize_sample` gives such a field back as a numpy
``V2`` array, and :func:`to_tensor` turns it into a bfloat16 tensor with
the same bits.
"""

import struct

import numpy as np
import torch

from paddle_tpu_torch import native

__all__ = ["serialize_sample", "deserialize_sample",
           "convert_reader_to_recordio_file",
           "convert_reader_to_recordio_files", "recordio_sample_reader"]

#: numpy's stand-in for bfloat16: its 2-byte words as a void dtype
BF16_HOST = np.dtype("V2")


def host_array(value):
    """``(numpy array, dtype name)`` of a field: a tensor is copied to
    the host (bfloat16 as :data:`BF16_HOST` words, named ``"bfloat16"``,
    as the JAX package names its bfloat16); anything else goes through
    ``np.asarray``."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        if t.dtype == torch.bfloat16:
            a = t.contiguous().view(torch.int16).cpu().numpy()
            return a.view(BF16_HOST), "bfloat16"
        a = t.cpu().numpy()
        return a, str(a.dtype)
    a = np.asarray(value)
    return a, "bfloat16" if a.dtype == BF16_HOST else str(a.dtype)


def host_dtype(name):
    """The numpy dtype an array of dtype name ``name`` is held in on the
    host (bfloat16: :data:`BF16_HOST`)."""
    return BF16_HOST if name == "bfloat16" else np.dtype(name)


def to_tensor(arr, dtype_name=None, device="cpu"):
    """A tensor of the host array ``arr`` on ``device``: a ``V2`` array
    (or ``dtype_name == "bfloat16"``) becomes bfloat16 with the same
    bits; unsigned 32-bit values (the JAX package's guard counters)
    become int64, which the port keeps them in."""
    arr = np.asarray(arr)
    if arr.dtype == BF16_HOST or dtype_name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                             .copy()).view(torch.bfloat16)
    elif arr.dtype == np.uint32:
        t = torch.from_numpy(arr.astype(np.int64))
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device)


def serialize_sample(sample) -> bytes:
    if not isinstance(sample, (tuple, list)):
        sample = (sample,)
    out = [struct.pack("<I", len(sample))]
    for field in sample:
        arr, _ = host_array(field)
        if arr.dtype.kind == "O":
            raise TypeError(
                "cannot serialize object-dtype field %r — samples must be "
                "numeric/string arrays or scalars" % (field,))
        # numpy spells a 2-byte void '|V2'; the JAX package's bfloat16
        # writes '<V2'
        dt = b"<V2" if arr.dtype == BF16_HOST else arr.dtype.str.encode()
        raw = arr.tobytes()
        out.append(struct.pack("<I", len(dt)))
        out.append(dt)
        out.append(struct.pack("<I", arr.ndim))
        out.append(struct.pack("<%dq" % arr.ndim, *arr.shape))
        out.append(struct.pack("<Q", len(raw)))
        out.append(raw)
    return b"".join(out)


def deserialize_sample(blob: bytes):
    off = 0

    def take(fmt):
        nonlocal off
        size = struct.calcsize(fmt)
        vals = struct.unpack_from(fmt, blob, off)
        off += size
        return vals

    (nfields,) = take("<I")
    fields = []
    for _ in range(nfields):
        (dtlen,) = take("<I")
        dt = blob[off:off + dtlen].decode()
        off += dtlen
        (ndim,) = take("<I")
        shape = take("<%dq" % ndim) if ndim else ()
        (rawlen,) = take("<Q")
        count = int(np.prod(shape, dtype=np.int64)) if ndim else 1
        # copy: frombuffer views are read-only and pin the whole blob alive
        arr = np.frombuffer(blob, dtype=np.dtype(dt), count=count,
                            offset=off).copy()
        off += rawlen
        arr = arr.reshape(shape) if ndim else arr[0]
        fields.append(arr)
    return tuple(fields)


def convert_reader_to_recordio_file(filename, reader_creator,
                                    compressor="zlib",
                                    max_num_records=1000, feeder=None):
    """Writes every sample of the reader into one recordio file."""
    n = 0
    with native.RecordIOWriter(filename, compressor=compressor,
                               max_chunk_records=max_num_records) as w:
        for sample in reader_creator():
            w.write(serialize_sample(sample))
            n += 1
    return n


def convert_reader_to_recordio_files(filename, batch_per_file,
                                     reader_creator, compressor="zlib",
                                     max_num_records=1000):
    """Shards the reader into files `filename-00000`, `filename-00001`, ..."""
    paths, writer, n, shard = [], None, 0, 0
    for sample in reader_creator():
        if writer is None:
            path = "%s-%05d" % (filename, shard)
            paths.append(path)
            writer = native.RecordIOWriter(path, compressor=compressor,
                                           max_chunk_records=max_num_records)
        writer.write(serialize_sample(sample))
        n += 1
        if n % batch_per_file == 0:
            writer.close()
            writer = None
            shard += 1
    if writer is not None:
        writer.close()
    return paths


def recordio_sample_reader(files, num_threads=2, queue_capacity=256,
                           num_epochs=1, shuffle=False, seed=0):
    """Reader creator over recordio shards via the native prefetch loader."""
    if isinstance(files, str):
        files = [files]

    def reader():
        with native.RecordLoader(list(files), num_threads=num_threads,
                                 queue_capacity=queue_capacity,
                                 num_epochs=num_epochs, shuffle=shuffle,
                                 seed=seed) as ld:
            for blob in ld:
                yield deserialize_sample(blob)

    return reader
