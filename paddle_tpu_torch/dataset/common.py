"""Dataset plumbing: cache paths, checksums, sharding.

Capability parity: `python/paddle/dataset/common.py` (download with md5
verification, `split`, `cluster_files_reader`, `convert` to recordio).
The loaders never need the network: ``download`` hands back a cached
file that passes its checksum, or raises, and the loaders fall back to
their synthetic generators when nothing is cached. ``DATA_HOME`` is the
directory paddle_tpu's loaders read, so one cached file serves both
packages.
"""

import glob
import hashlib
import os
import pickle

__all__ = ["DATA_HOME", "data_path", "has_cached", "md5file", "download",
           "split", "cluster_files_reader", "convert"]

DATA_HOME = os.path.expanduser("~/.cache/paddle_tpu/dataset")


def data_path(*parts):
    return os.path.join(DATA_HOME, *parts)


def has_cached(*parts):
    return os.path.exists(data_path(*parts))


def md5file(fname):
    h = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 16), b""):
            h.update(chunk)
    return h.hexdigest()


def download(url, module_name, md5sum=None, save_name=None,
             retry_limit=3):
    """The cached copy of ``url`` in the module's cache dir, verified
    against ``md5sum`` (reference common.py:65 semantics for a cached
    file). This package never fetches: with no cached copy that passes
    the checksum it raises RuntimeError, and the dataset loaders catch
    that and fall back to synthetic data. ``retry_limit`` is taken for
    the reference's signature."""
    dirname = os.path.join(DATA_HOME, module_name)
    filename = os.path.join(
        dirname, save_name if save_name else url.split("/")[-1])
    if os.path.exists(filename) and (
            md5sum is None or md5file(filename) == md5sum):
        return filename
    raise RuntimeError(
        "Cannot download %s: no cached copy at %s passes the checksum, "
        "and paddle_tpu_torch.dataset never fetches" % (url, filename))


def split(reader, line_count, suffix="%05d.pickle", dumper=None):
    """Shard a reader's samples into pickle files of ``line_count``
    each (reference common.py:140)."""
    dumper = dumper or pickle.dump
    if not callable(dumper):
        raise TypeError("dumper should be callable.")
    lines, idx = [], 0
    for d in reader():
        lines.append(d)
        if len(lines) == line_count:
            with open(suffix % idx, "wb") as f:
                dumper(lines, f)
            lines, idx = [], idx + 1
    if lines:
        with open(suffix % idx, "wb") as f:
            dumper(lines, f)
    return idx + (1 if lines else 0)


def cluster_files_reader(files_pattern, trainer_count, trainer_id,
                         loader=None):
    """Reader over this trainer's shard of the files matched by
    ``files_pattern`` (reference common.py:170): file i belongs to
    trainer ``i % trainer_count``."""
    loader = loader or pickle.load

    def reader():
        files = sorted(glob.glob(files_pattern))
        if not files:
            raise RuntimeError("no file matches %s" % files_pattern)
        for i, path in enumerate(files):
            if i % trainer_count != trainer_id:
                continue
            with open(path, "rb") as f:
                for sample in loader(f):
                    yield sample
    return reader


def convert(output_path, reader, line_count, name_prefix):
    """Convert a reader to sharded recordio files (reference
    common.py:199 — there via the recordio python bindings; here via
    the native chunked writer): ``line_count`` samples a file, named
    ``<name_prefix>-00000``, ... under ``output_path``, the same bytes
    as the JAX package's. Returns the written paths."""
    from paddle_tpu_torch import recordio_writer

    def batched():
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) == line_count:
                yield buf
                buf = []
        if buf:
            yield buf

    prefix = os.path.join(output_path, name_prefix)
    os.makedirs(output_path, exist_ok=True)
    paths = []
    for i, batch in enumerate(batched()):
        path = "%s-%05d" % (prefix, i)
        recordio_writer.convert_reader_to_recordio_file(
            path, lambda b=batch: iter(b))
        paths.append(path)
    return paths
