"""``paddle_tpu_torch.reader`` and ``paddle_tpu_torch.dataset`` against
paddle_tpu's, on the CPU:

* every reader decorator gives paddle_tpu's samples in paddle_tpu's
  order, with ``random`` seeded the same for ``shuffle``; ``buffered``
  re-raises a worker's error after the samples before it;
* every loader's first samples are paddle_tpu's bit for bit, values and
  dtypes, with ``DATA_HOME`` an empty directory (the synthetic
  generators), and ``conll05.get_embedding``'s file is paddle_tpu's;
* ``common``'s ``md5file``, ``download`` from a verified cache, its
  error with no cached copy, ``split`` and ``cluster_files_reader`` as
  ``tests/test_dataset_plumbing.py`` holds them; ``convert`` raises
  ``NotImplementedError`` until ``recordio_writer`` is ported.

The staging readers ``device_chunks`` and ``double_buffer`` copy to the
card: here only that they raise with no card;
``tests/test_torch_v2_cuda.py`` holds them on the card."""

import os
import pickle
import random

import numpy as np
import pytest
import torch

import paddle_tpu.dataset as jdata
import paddle_tpu.reader as jreader
import paddle_tpu_torch as tfluid
import paddle_tpu_torch.dataset as tdata
import paddle_tpu_torch.reader as treader
from paddle_tpu_torch.dataset import common


def same(got, want, where="sample"):
    """Recursive bit-for-bit equality: containers by type and length,
    arrays by dtype, shape and bytes, scalars by type and value."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), where
        for k in want:
            same(got[k], want[k], "%s[%r]" % (where, k))
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, "%s[%d]" % (where, i))
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), where
        assert got.dtype == want.dtype and got.shape == want.shape, where
        assert got.tobytes() == want.tobytes(), where
    elif hasattr(want, "data") and hasattr(want, "lengths"):
        same(np.asarray(got.data), np.asarray(want.data), where + ".data")
        same(np.asarray(got.lengths), np.asarray(want.lengths),
             where + ".lengths")
    elif hasattr(want, "__dict__") and not isinstance(want, type):
        same(vars(got), vars(want), where)
    else:
        assert type(got) is type(want) and got == want, (where, got, want)


def rows(n=10):
    def reader():
        for i in range(n):
            yield (np.arange(3, dtype=np.float32) + i, i)
    return reader


def both(make):
    """``make(reader_module)``'s samples from each package, ``random``
    seeded the same before each."""
    out = []
    for mod in (jreader, treader):
        random.seed(11)
        out.append(list(make(mod)()))
    return out


READERS = {
    "map_readers": lambda m: m.map_readers(lambda a, b: (a[1] + b[1],),
                                           rows(), rows(7)),
    "shuffle": lambda m: m.shuffle(rows(23), buf_size=5),
    "shuffle_whole": lambda m: m.shuffle(rows(9), buf_size=100),
    "chain": lambda m: m.chain(rows(3), rows(4)),
    "compose": lambda m: m.compose(rows(4), rows(4)),
    "compose_unaligned": lambda m: m.compose(rows(4), rows(2),
                                             check_alignment=False),
    "buffered": lambda m: m.buffered(rows(17), 3),
    "firstn": lambda m: m.firstn(rows(), 4),
    "xmap_ordered": lambda m: m.xmap_readers(
        lambda s: (s[1] * 2,), rows(12), 3, 4, order=True),
    "cache": lambda m: m.cache(rows(5)),
    "batch": lambda m: m.batch(rows(10), 3),
    "batch_tail": lambda m: m.batch(rows(10), 3, drop_last=False),
    "super_batch": lambda m: m.super_batch(rows(12), 3),
    "super_batch_tail": lambda m: m.super_batch(rows(7), 3,
                                                drop_last=False),
    "elastic_shard": lambda m: m.elastic_shard(
        rows(12), m.ElasticShardPlan(3, 1)),
}


@pytest.mark.parametrize("which", sorted(READERS))
def test_reader_decorators_match_the_jax_package(which):
    j, t = both(READERS[which])
    assert j, which
    same(t, j)


def test_xmap_unordered_and_rekeyed_shards_match():
    j, t = both(lambda m: m.xmap_readers(lambda s: s[1], rows(20), 4, 2))
    assert sorted(t) == sorted(j) == list(range(20))
    got = []
    for mod in (jreader, treader):
        plan = mod.ElasticShardPlan(2, 0)
        seen = []
        for i, s in enumerate(mod.elastic_shard(rows(12), plan)()):
            seen.append(s[1])
            if s[1] == 4:
                plan.rekey(3, 2, at_index=6)
        got.append((seen, plan.snapshot()))
    assert got[1] == got[0]
    with pytest.raises(ValueError, match="precedes"):
        treader.ElasticShardPlan(2, 0, start_index=5).rekey(2, 1, 3)


def test_super_batch_of_feed_dicts_pads_packed_sequences():
    from paddle_tpu.core.lower import PackedSeq

    def feeds():
        rng = np.random.RandomState(0)
        for n in (3, 5, 2, 4):
            lens = rng.randint(1, n + 1, 2)
            data = np.zeros((2, n, 1), np.int64)
            yield {"words": tfluid.PackedSeq(data + n,
                                             lens.astype(np.int32)),
                   "label": rng.randint(0, 2, (2, 1)).astype(np.int64)}

    jf = [{"words": PackedSeq(v["words"].data, v["words"].lengths),
           "label": v["label"]} for v in feeds()]
    j = list(jreader.super_batch(lambda: iter(jf), 2)())
    t = list(treader.super_batch(feeds, 2)())
    same(t, j)
    assert np.asarray(t[0]["words"].data).shape == (2, 2, 5, 1)


def test_buffered_reraises_after_the_samples_before_it():
    def failing():
        yield 1
        yield 2
        raise KeyError("boom")
    got = []
    with pytest.raises(KeyError, match="boom"):
        for s in treader.buffered(failing, 1)():
            got.append(s)
    assert got == [1, 2]


def test_staging_readers_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: tests/test_torch_v2_cuda.py")
    r = treader.batch(rows(4), 2)
    for fn in (treader.device_chunks, treader.double_buffer):
        for place in (None, tfluid.CUDAPlace(0), tfluid.CPUPlace()):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                fn(r, place=place)


# (module, function, positional arguments)
LOADERS = [
    ("mnist", "train", ()), ("mnist", "test", ()),
    ("cifar", "train10", ()), ("cifar", "test10", ()),
    ("cifar", "train100", ()), ("cifar", "test100", ()),
    ("imdb", "train", (None,)), ("imdb", "test", (None,)),
    ("imikolov", "train", (None, 5)), ("imikolov", "test", (None, 5)),
    ("uci_housing", "train", ()), ("uci_housing", "test", ()),
    ("movielens", "train", ()), ("movielens", "test", ()),
    ("conll05", "train", ()), ("conll05", "test", ()),
    ("wmt14", "train", ()), ("wmt14", "test", ()),
    ("wmt16", "train", ()), ("wmt16", "test", ()),
    ("wmt16", "validation", ()),
    ("flowers", "train", ()), ("flowers", "test", ()),
    ("flowers", "valid", ()),
    ("voc2012", "train", ()), ("voc2012", "test", ()),
    ("voc2012", "val", ()),
    ("mq2007", "train", ()), ("mq2007", "test", ()),
    ("mq2007", "test", ("pointwise",)), ("mq2007", "train", ("listwise",)),
    ("sentiment", "train", ()), ("sentiment", "test", ()),
]


@pytest.fixture
def empty_data_home(tmp_path, monkeypatch):
    from paddle_tpu.dataset import common as jcommon

    monkeypatch.setattr(jcommon, "DATA_HOME", str(tmp_path / "jax"))
    monkeypatch.setattr(common, "DATA_HOME", str(tmp_path / "port"))
    return tmp_path


@pytest.mark.parametrize("mod,fn,args", LOADERS,
                         ids=["%s.%s%s" % (m, f, "".join(
                             "-%s" % a for a in args if a is not None))
                              for m, f, args in LOADERS])
def test_loader_samples_are_the_jax_packages(mod, fn, args,
                                             empty_data_home):
    readers = [getattr(getattr(pkg, mod), fn)(*args)
               for pkg in (jdata, tdata)]
    firsts = []
    for r in readers:
        it = iter(r())
        firsts.append([next(it) for _ in range(5)])
    same(firsts[1], firsts[0])


def test_loader_dictionaries_and_tables_are_the_jax_packages(
        empty_data_home):
    for mod, fn, args in (
            ("imdb", "word_dict", ()), ("imikolov", "build_dict", ()),
            ("conll05", "get_dict", ()), ("wmt14", "get_dict", (30,)),
            ("wmt16", "get_dict", ("en", 30)),
            ("sentiment", "get_word_dict", ()),
            ("movielens", "get_movie_title_dict", ()),
            ("movielens", "movie_categories", ()),
            ("movielens", "max_movie_id", ()), ("movielens", "max_user_id",
                                                ()),
            ("movielens", "max_job_id", ())):
        same(getattr(getattr(tdata, mod), fn)(*args),
             getattr(getattr(jdata, mod), fn)(*args), "%s.%s" % (mod, fn))
    assert len(tdata.imdb.word_dict()) == 5149
    for fn in ("movie_info", "user_info"):
        t, j = (getattr(pkg.movielens, fn)() for pkg in (tdata, jdata))
        assert sorted(t) == sorted(j)
        for k in (1, 17, max(j)):
            same(t[k], j[k], "movielens.%s[%d]" % (fn, k))
    same(tdata.movielens.age_table, jdata.movielens.age_table)
    with open(tdata.conll05.get_embedding(), "rb") as f:
        port = f.read()
    with open(jdata.conll05.get_embedding(), "rb") as f:
        assert port == f.read()


def test_data_home_is_the_jax_packages():
    from paddle_tpu.dataset import common as jcommon

    assert common.DATA_HOME == jcommon.DATA_HOME


def test_md5file(tmp_path):
    p = tmp_path / "f.bin"
    p.write_bytes(b"hello world")
    assert common.md5file(str(p)) == "5eb63bbbe01eeed093cb22bb8f5acdc3"


def test_download_uses_verified_cache_without_network(tmp_path,
                                                      monkeypatch):
    monkeypatch.setattr(common, "DATA_HOME", str(tmp_path))
    cached = tmp_path / "mod" / "data.bin"
    cached.parent.mkdir(parents=True)
    cached.write_bytes(b"payload")
    got = common.download("http://127.0.0.1:9/never/data.bin", "mod",
                          md5sum=common.md5file(str(cached)))
    assert got == str(cached)
    got = common.download("http://127.0.0.1:9/never/x", "mod",
                          save_name="data.bin")
    assert got == str(cached)


def test_download_without_a_verified_copy_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(common, "DATA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="Cannot download"):
        common.download("http://127.0.0.1:9/never/x.bin", "mod",
                        md5sum="0" * 32, retry_limit=1)
    bad = tmp_path / "mod" / "data.bin"
    bad.parent.mkdir(parents=True)
    bad.write_bytes(b"other payload")
    with pytest.raises(RuntimeError, match="Cannot download"):
        common.download("http://127.0.0.1:9/never/data.bin", "mod",
                        md5sum="0" * 32)


def test_split_and_cluster_files_reader(tmp_path):
    def reader():
        for i in range(10):
            yield (i, i * i)

    n = common.split(reader, 3, suffix=str(tmp_path / "part-%05d.pickle"))
    assert n == 4
    r0 = common.cluster_files_reader(
        str(tmp_path / "part-*.pickle"), trainer_count=2, trainer_id=0)
    r1 = common.cluster_files_reader(
        str(tmp_path / "part-*.pickle"), trainer_count=2, trainer_id=1)
    got = sorted(list(r0()) + list(r1()))
    assert got == [(i, i * i) for i in range(10)]
    with open(tmp_path / "part-00003.pickle", "rb") as f:
        assert pickle.load(f) == [(9, 81)]
    with pytest.raises(TypeError, match="callable"):
        common.split(reader, 3, dumper="not callable")
    with pytest.raises(RuntimeError, match="no file matches"):
        list(common.cluster_files_reader(str(tmp_path / "none-*"), 1, 0)())


def test_convert_waits_for_recordio_writer(tmp_path):
    """``convert`` (ported with ``recordio_writer``) writes the same files
    as the JAX package's: 10 samples at 3 a file are 4 shards, each the
    same bytes, read back by the port's native loader."""
    from paddle_tpu_torch import recordio_writer

    got = common.convert(str(tmp_path / "t"), rows(), 3, "ds")
    want = jdata.common.convert(str(tmp_path / "j"), rows(), 3, "ds")
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want] == \
        ["ds-%05d" % i for i in range(4)]
    for a, b in zip(got, want):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    back = list(recordio_writer.recordio_sample_reader(got,
                                                       num_threads=1)())
    assert sorted(int(s[1]) for s in back) == list(range(10))
