"""The port's flash-attention kernels against the JAX package's.

On the CPU the port's wrappers run their plain versions, which follow
the CUDA kernels' blocking (key tiles, tiles past the diagonal or past
cache_len skipped, the l == 0 guard); those are held against the JAX
functions on the same numpy inputs, run as the JAX package's own tests
run them on the CPU (the Pallas kernels in interpret mode, or their
plain references). Tolerance 2e-5 for O and for the log-sum-exp: the
same fp32 math in another summation order.

The backward (``flash_attention_bwd``, and autograd through the
``FlashAttention`` Function that ``flash_attention`` returns through) is
held against ``jax.vjp`` of the JAX package's ``flash_attention`` at
1e-5: the same float32 blockwise math. The bfloat16 plain forward is
held against the JAX blockwise forward on the same bfloat16 inputs at
the bf16 bound (rtol 1e-2 plus 4e-3 of the largest magnitude): both
round P to bfloat16 before P V, relative to running maxima of other
key blocks, and round O to bfloat16.

Over a bfloat16 KV cache the decode's single walk is held against the
JAX kernel in interpret mode at TOL (both round p against the same
running maxima), and the chunked plain version against the JAX
``decode_reference`` at the bf16 bound (it rounds the normalized
probabilities instead).

The CUDA kernels themselves are held against the plain versions on the
card by tests/test_torch_kernels_cuda.py.
"""

import os

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu_torch.kernels import flash_attention as tfa

# Under pytest-xdist each worker takes its share of the cores for
# torch's intra-op threads: six workers at torch's default thread count
# oversubscribe the cores, and a test of seconds then takes minutes.
_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, os.cpu_count() // int(_WORKERS)))

# the module (paddle_tpu.kernels re-exports a function of the same name)
jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")

TOL = 2e-5


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _segments(rng, b, s):
    return np.sort(rng.randint(0, 3, (b, s)), axis=1).astype(np.int32)


def _jax_fwd(q, k, v, causal, segs):
    """The JAX forward with its lse: the Pallas kernel in interpret mode
    where the shape tiles evenly, its blockwise path otherwise."""
    b, _, s, _ = q.shape
    have = segs is not None
    qs = jnp.asarray(segs[0] if have else np.zeros((b, s), np.int32))
    ks = jnp.asarray(segs[1] if have else np.zeros((b, s), np.int32))
    out, res = jfa._flash_fwd(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), qs, ks, q.shape[-1] ** -0.5,
                              causal, have, 128, 128, True)
    return np.asarray(out), np.asarray(res[-1])


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("seg", [False, True])
@pytest.mark.parametrize("shape", [(2, 2, 16, 8), (1, 3, 13, 16),
                                   (2, 2, 40, 8), (1, 2, 90, 16)])
def test_forward_plain_matches_jax(shape, seg, causal):
    rng = np.random.RandomState(sum(shape) + 2 * seg + causal)
    q, k, v = (_rand(rng, *shape) for _ in range(3))
    segs = None
    if seg:
        s = _segments(rng, shape[0], shape[2])
        segs = (s, s)
    jo, jl = _jax_fwd(q, k, v, causal, segs)
    to, tl = tfa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, return_lse=True,
        segment_ids=None if segs is None else tuple(
            torch.from_numpy(x) for x in segs))
    np.testing.assert_allclose(to.numpy(), jo, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=TOL, atol=TOL)
    ref = jfa.mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal,
                            segment_ids=None if segs is None else tuple(
                                jnp.asarray(x) for x in segs))
    np.testing.assert_allclose(to.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


def test_forward_cross_attention_ragged_keys():
    """sq != sk, neither a multiple of the tiles."""
    rng = np.random.RandomState(3)
    q, k, v = _rand(rng, 1, 2, 7, 8), _rand(rng, 1, 2, 45, 8), \
        _rand(rng, 1, 2, 45, 8)
    ref = jfa.mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


def test_forward_fully_masked_rows_average_v_like_jax():
    """Segments that never meet: every score takes the mask value, so a
    row averages V (the JAX kernels' finite-mask semantics)."""
    rng = np.random.RandomState(4)
    q, k, v = (_rand(rng, 1, 2, 16, 8) for _ in range(3))
    qs = np.zeros((1, 16), np.int32)
    ks = np.ones((1, 16), np.int32)
    jo, jl = _jax_fwd(q, k, v, False, (qs, ks))
    to, tl = tfa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        segment_ids=(torch.from_numpy(qs), torch.from_numpy(ks)),
        return_lse=True)
    np.testing.assert_allclose(to.numpy(), jo, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(to.numpy()[0, 0, 0], v[0, 0].mean(0),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=TOL)


# A cache of 128 positions: decode_plan cuts each row's valid prefix into
# 4 chunks there, so lengths from 0 to past the cache cross chunk edges
# (L / 4 apart) and the edges of the warps' 8-key tiles inside them.
@pytest.mark.parametrize("lens", [[1, 32, 17], [0, 5, 32], [8, 9, 16],
                                  [3, 4, 5], [31, 33, 64], [65, 127, 128],
                                  [100, 2, 129]])
def test_decode_plain_matches_jax_kernel(lens):
    rng = np.random.RandomState(len(lens) + lens[0])
    b, h, s, d = 3, 2, 128, 8
    assert tfa.decode_plan(b, h, s, d)["blocks_per_row"] == 4
    q = _rand(rng, b, h, 1, d)
    kc, vc = _rand(rng, b, h, s, d), _rand(rng, b, h, s, d)
    ln = np.asarray(lens, np.int32)
    jout = np.asarray(jfa.flash_decode(jnp.asarray(q), jnp.asarray(kc),
                                       jnp.asarray(vc), jnp.asarray(ln),
                                       interpret=True, block_k=8))
    tout = tfa.flash_decode(torch.from_numpy(q), torch.from_numpy(kc),
                            torch.from_numpy(vc), torch.from_numpy(ln))
    np.testing.assert_allclose(tout.numpy(), jout, rtol=TOL, atol=TOL)
    for i, n in enumerate(lens):
        if n == 0:   # an empty row is 0 (the l == 0 guard)
            assert not tout[i].any()
        else:        # and matches the plain-XLA reference elsewhere
            ref = np.asarray(jfa.decode_reference(
                jnp.asarray(q[i:i + 1, :, 0]), jnp.asarray(kc[i:i + 1]),
                jnp.asarray(vc[i:i + 1]), jnp.asarray(ln[i:i + 1])))
            np.testing.assert_allclose(tout.numpy()[i:i + 1, :, 0], ref,
                                       rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape", [(3, 2, 128, 8), (2, 1, 512, 16),
                                   (16, 8, 64, 8)])
def test_decode_chunked_walk_equals_one_walk(shape):
    """The kernel's blocking (decode_plan's chunks, each walked by 4
    warps in 8-key tiles, merged in warp and then rank order) against one
    online softmax over the whole valid prefix (one block, one warp), to
    float32 rounding, at lengths that cross every kind of edge."""
    b, h, s, d = shape
    rng = np.random.RandomState(s + b)
    q = torch.from_numpy(_rand(rng, b, h, 1, d))
    kc, vc = (torch.from_numpy(_rand(rng, b, h, s, d)) for _ in range(2))
    n = tfa.decode_plan(b, h, s, d)["blocks_per_row"]
    assert n > 1
    picks = [0, 1, n - 1, n, n + 1, s // 2 - 1, s // 2 + 1, s - 1, s, s + 9]
    lens = torch.tensor([picks[i % len(picks)] for i in range(b)] if b > 3
                        else picks[s % 7:s % 7 + b], dtype=torch.int32)
    got = tfa.flash_decode_reference(q, kc, vc, lens)
    one = tfa._decode_walk(q, kc, vc, lens, None, blocks=1, warps=1,
                           block_k=tfa.DECODE_BLOCK_K)
    np.testing.assert_allclose(got.numpy(), one.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert got.shape == (b, h, 1, d)


# A bfloat16 cache (DecodeEngine(cache_dtype="bfloat16")): q float32, the
# output float32, the scores float32 from q against the widened keys, and
# p = exp(s - m) rounded to bfloat16 before the P V sum. At ragged
# lengths (0 and past the cache included), head_dim 64 and 13.
_BF16_LENS = [[0, 1, 77], [128, 40, 255], [256, 3, 300]]


def _bf16_cache(rng, b, h, s, d):
    """float32 q, and K/V rounded to bfloat16 (numpy and torch views)."""
    q = _rand(rng, b, h, 1, d)
    kv = [torch.from_numpy(_rand(rng, b, h, s, d)).to(torch.bfloat16)
          for _ in range(2)]
    return q, kv, [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                   for t in kv]


@pytest.mark.parametrize("d", [64, 13])
@pytest.mark.parametrize("lens", _BF16_LENS)
def test_decode_bf16_one_walk_matches_jax_kernel(d, lens):
    """The single walk (one block, one warp, 128-key tiles: the JAX
    kernel's blocking) against the JAX kernel in interpret mode on the
    same bf16 caches: both round p against the same running maxima, so
    they agree to float32 summation order (TOL), except where a score's
    last bits (q.k summed in another order) put p = exp(s - m) on the
    other side of a bf16 rounding boundary. Such a flip moves one
    weight of V by one bf16 ulp (2^-7 of p <= 1), the row's output by
    at most 2^-7 max|v| / l, where l >= 1 is the row's softmax sum: the
    tolerance is TOL plus that, row by row."""
    rng = np.random.RandomState(d + lens[1])
    b, h, s = 3, 2, 256
    q, (kc, vc), (jk, jv) = _bf16_cache(rng, b, h, s, d)
    ln = np.asarray(lens, np.int32)
    jout = np.asarray(jfa.flash_decode(jnp.asarray(q), jk, jv,
                                       jnp.asarray(ln), interpret=True,
                                       block_k=128))
    assert jout.dtype == np.float32
    one = tfa._decode_walk(torch.from_numpy(q), kc, vc, torch.from_numpy(ln),
                           None, blocks=1, warps=1, block_k=128)
    assert one.dtype == torch.float32
    err = np.abs(one.numpy() - jout)[:, :, 0]
    k64, v64 = kc.double().numpy(), vc.double().numpy()
    for i, n in enumerate(np.minimum(ln, s)):
        if n == 0:
            assert not err[i].any()
            continue
        sc = np.einsum("hd,hkd->hk", q[i, :, 0].astype(np.float64),
                       k64[i, :, :n]) * d ** -0.5
        l = np.exp(sc - sc.max(-1, keepdims=True)).sum(-1)
        flip = 2.0 ** -7 * np.abs(v64[i, :, :n]).max((-2, -1)) / l
        assert (err[i] <= TOL + TOL * np.abs(jout[i, :, 0])
                + flip[:, None]).all(), (i, float(err[i].max()))


@pytest.mark.parametrize("d", [64, 13])
@pytest.mark.parametrize("lens", _BF16_LENS)
def test_decode_bf16_plain_matches_jax_reference(d, lens):
    """The port's plain version (the CUDA kernel's chunked walk) against
    the JAX package's ``decode_reference`` on the same bf16 caches, at
    one bfloat16 rounding (rtol 1e-2 plus 4e-3 of the largest
    magnitude): the walk rounds p = exp(s - m) against each chunk's and
    warp's running max, the reference rounds the normalized
    probabilities, so each weight of V differs by up to a bf16 ulp."""
    rng = np.random.RandomState(2 * d + lens[0])
    b, h, s = 3, 2, 256
    q, (kc, vc), (jk, jv) = _bf16_cache(rng, b, h, s, d)
    ln = np.asarray(lens, np.int32)
    want = np.asarray(jfa.decode_reference(
        jnp.asarray(q[:, :, 0]), jk, jv,
        jnp.asarray(np.minimum(ln, s)))).astype(np.float32)
    got = tfa.flash_decode(torch.from_numpy(q), kc, vc, torch.from_numpy(ln))
    assert got.dtype == torch.float32 and got.shape == (b, h, 1, d)
    got = got.numpy()[:, :, 0]
    for i, n in enumerate(lens):
        if n == 0:
            assert not got[i].any()   # the l == 0 guard
            continue
        err = np.abs(got[i] - want[i])
        assert (err <= 1e-2 * np.abs(want[i])
                + 4e-3 * np.abs(want[i]).max()).all(), float(err.max())


def test_decode_bf16_rounds_p_where_the_kernel_does():
    """Over a bf16 cache the walk rounds p before P V: its result equals
    the float64 walk with the same roundings to float32 rounding, and
    differs from the float32 walk over the same (widened) values."""
    rng = np.random.RandomState(5)
    b, h, s, d = 2, 2, 64, 16
    q, (kc, vc), _ = _bf16_cache(rng, b, h, s, d)
    q = torch.from_numpy(q)
    lens = torch.tensor([64, 37], dtype=torch.int32)
    got = tfa.flash_decode_reference(q, kc, vc, lens)
    f64 = tfa.flash_decode_reference(q, kc, vc, lens, acc=torch.float64)
    assert f64.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), f64.numpy(), rtol=1e-5,
                               atol=1e-6)
    wide = tfa.flash_decode_reference(q, kc.float(), vc.float(), lens)
    assert not torch.equal(got, wide)
    np.testing.assert_allclose(got.numpy(), wide.numpy(), rtol=1e-2,
                               atol=4e-3 * float(wide.abs().max()))


def test_decode_plan_takes_the_element_size():
    """A bfloat16 cache halves the ring: at the serving shape 2 blocks a
    row either way, 34944 shared bytes a block in float32, 18560 in
    bfloat16 (the 4 warps' 2-stage rings of 8 keys x 64 columns, K and
    V, plus 2 x 4 merge slots of 68 floats)."""
    f32 = tfa.decode_plan(16, 8, 512, 64, sms=132)
    bf16 = tfa.decode_plan(16, 8, 512, 64, sms=132, itemsize=2)
    assert f32["smem_bytes"] == 34944 and bf16["smem_bytes"] == 18560
    assert {k: v for k, v in f32.items() if k != "smem_bytes"} == \
        {k: v for k, v in bf16.items() if k != "smem_bytes"}


def test_decode_refuses_mixed_or_half_caches():
    x = torch.randn(1, 2, 8, 8)
    lens = torch.tensor([3], dtype=torch.int32)
    with pytest.raises(ValueError, match="one dtype"):
        tfa.flash_decode(x[:, :, :1], x, x.bfloat16(), lens)
    with pytest.raises(ValueError, match="one dtype"):
        tfa.flash_decode(x[:, :, :1], x.half(), x.half(), lens)


def test_decode_plan_chunks_cover_the_valid_prefix():
    """For every length 0..S the chunks of a row are contiguous, in rank
    order, cover [0, L) with no gap or overlap, and none is empty while
    L >= n; at the serving path's shape ([16, 8, 512, 64] on an H100's
    132 SMs) the plan is 2 blocks a row, 256 in all, of 4 warps with 2
    ring stages of 8-key tiles (34944 bytes of shared memory)."""
    plan = tfa.decode_plan(16, 8, 512, 64, sms=132)
    assert plan == dict(blocks_per_row=2, blocks=256, threads=128,
                        stages=2, smem_bytes=34944, tile_keys=8)
    assert tfa.decode_plan(16, 8, 512, 128)["smem_bytes"] <= 227 * 1024
    for b, h, s, sms in ((16, 8, 512, 132), (1, 8, 512, 132),
                         (1, 1, 256, 132), (64, 8, 512, 132),
                         (2, 2, 100, 4)):
        n = tfa.decode_plan(b, h, s, 64, sms)["blocks_per_row"]
        assert n in (1, 2, 4, 8)
        lengths = torch.arange(s + 1)
        c0, c1 = tfa.decode_chunks(lengths, n)
        assert c0.shape == (n, s + 1)
        assert (c0[0] == 0).all() and torch.equal(c1[-1], lengths)
        assert torch.equal(c1[:-1], c0[1:])          # no gap, no overlap
        assert (c1[:, lengths >= n] > c0[:, lengths >= n]).all()
    # a single slot spreads over the portable cluster of 8; a grid that
    # fills the card alone is not split
    assert tfa.decode_plan(1, 8, 512, 64)["blocks_per_row"] == 8
    assert tfa.decode_plan(64, 8, 512, 64)["blocks_per_row"] == 1
    # a cache too short for two tiles a warp in a chunk is not split
    assert tfa.decode_plan(16, 8, 32, 64)["blocks_per_row"] == 1


def test_decode_reads_no_position_past_the_length():
    """Positions past cache_len hold NaN: the plain version never uses
    them (the kernel never reads them: chip_smoke.py)."""
    rng = np.random.RandomState(5)
    b, h, s, d = 4, 2, 128, 8
    q = torch.from_numpy(_rand(rng, b, h, 1, d))
    kc, vc = (torch.from_numpy(_rand(rng, b, h, s, d)) for _ in range(2))
    lens = torch.tensor([0, 1, 37, 128], dtype=torch.int32)
    want = tfa.flash_decode_reference(q, kc, vc, lens)
    for i, n in enumerate(lens.tolist()):
        kc[i, :, n:] = float("nan")
        vc[i, :, n:] = float("nan")
    got = tfa.flash_decode(q, kc, vc, lens)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)
    assert not got[0].any()


def test_decode_rank3_query_and_last_position_equals_causal():
    rng = np.random.RandomState(1)
    b, h, n, d = 2, 2, 9, 8
    q = _rand(rng, b, h, 1, d)
    kfull, vfull = _rand(rng, b, h, n, d), _rand(rng, b, h, n, d)
    kc = np.zeros((b, h, 16, d), np.float32)
    vc = np.zeros((b, h, 16, d), np.float32)
    kc[:, :, :n], vc[:, :, :n] = kfull, vfull
    lens = torch.full((b,), n, dtype=torch.int32)
    out3 = tfa.flash_decode(torch.from_numpy(q[:, :, 0]),
                            torch.from_numpy(kc), torch.from_numpy(vc), lens)
    assert out3.shape == (b, h, d)
    full = jfa.mha_reference(jnp.asarray(q), jnp.asarray(kfull),
                             jnp.asarray(vfull))
    np.testing.assert_allclose(out3.numpy(), np.asarray(full)[:, :, 0],
                               rtol=TOL, atol=TOL)


def test_meta_tensors_return_shapes_without_launching():
    before = dict(tfa.launches)
    meta = torch.device("meta")
    q = torch.empty(2, 4, 9, 8, device=meta)
    out, lse = tfa.flash_attention(q, q, q, causal=True, return_lse=True)
    assert out.shape == (2, 4, 9, 8) and lse.shape == (2, 4, 9)
    assert out.device.type == "meta"
    kc = torch.empty(2, 4, 32, 8, device=meta)
    lens = torch.empty(2, dtype=torch.int32, device=meta)
    dq = tfa.flash_decode(torch.empty(2, 4, 1, 8, device=meta), kc, kc,
                          lens)
    assert dq.shape == (2, 4, 1, 8)
    assert tfa.launches == before


def test_plain_versions_do_not_count_launches():
    tfa.reset_launches()
    x = torch.randn(1, 2, 8, 8)
    tfa.flash_attention(x, x, x, causal=True)
    tfa.flash_attention(x.bfloat16(), x.bfloat16(), x.bfloat16())
    tfa.flash_decode(x[:, :, :1], x, x, torch.tensor([3], dtype=torch.int32))
    tfa.flash_decode(x[:, :, :1], x.bfloat16(), x.bfloat16(),
                     torch.tensor([3], dtype=torch.int32))
    assert tfa.launches == {"flash_attention": 0, "flash_attention_bf16": 0,
                            "flash_decode": 0, "flash_decode_bf16": 0}


def test_wrappers_reject_bad_shapes():
    x = torch.randn(1, 2, 8, 8)
    with pytest.raises(ValueError):
        tfa.flash_attention(x, x[:, :, :, :4], x)
    with pytest.raises(ValueError):
        tfa.flash_decode(x, x, x, torch.tensor([3], dtype=torch.int32))


@pytest.mark.parametrize("q,k", [("float16", "float16"),
                                 ("float32", "bfloat16"),
                                 ("float64", "float64")])
def test_forward_takes_float32_or_bfloat16_of_one_dtype(q, k):
    x = torch.randn(1, 2, 8, 8)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tfa.flash_attention(x.to(getattr(torch, q)), x.to(getattr(torch, k)),
                            x.to(getattr(torch, k)))


# (b, h, sq, sk, d, causal, segments, block_k): causal, not, segments,
# keys ragged against the queries (cross attention), a block_k that does
# not divide sk (the backward then takes all keys as one block)
BWD_CASES = {
    "causal": (2, 2, 40, 40, 8, True, False, 16),
    "non_causal": (1, 3, 33, 33, 16, False, False, 128),
    "segments": (1, 2, 64, 64, 8, True, True, 32),
    "ragged_sk": (2, 1, 24, 56, 8, False, False, 16),
    "block_not_dividing": (1, 2, 20, 20, 8, True, False, 16),
}


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_backward_matches_jax_vjp(case):
    """``flash_attention_bwd`` on the port's forward outputs, and
    autograd through the Function, against ``jax.vjp`` of the JAX
    package's ``flash_attention`` (its Pallas forward in interpret mode,
    its ``_bwd_blockwise`` backward) at 1e-5. Self-attention segments
    are shared by queries and keys, so every causal row meets a key of
    its own segment (a row that meets none averages the keys of the
    tiles each kernel visits, which differ by design)."""
    b, h, sq, sk, d, causal, seg, bk = BWD_CASES[case]
    rng = np.random.RandomState(sq + sk + d)
    q, k, v = _rand(rng, b, h, sq, d), _rand(rng, b, h, sk, d), \
        _rand(rng, b, h, sk, d)
    do = _rand(rng, b, h, sq, d)
    segs = None
    if seg:
        s = _segments(rng, b, sq)
        segs = (s, s)

    def jf(q, k, v):
        return jfa.flash_attention(
            q, k, v, causal=causal, block_k=bk, interpret=True,
            segment_ids=None if segs is None else tuple(
                jnp.asarray(x) for x in segs))

    jout, vjp = jax.vjp(jf, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tsegs = None if segs is None else tuple(torch.from_numpy(x)
                                            for x in segs)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out, lse = tfa.flash_attention(*leaves, causal=causal,
                                   segment_ids=tsegs, return_lse=True,
                                   block_k=bk)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    through_function = torch.autograd.grad(out, leaves,
                                           torch.from_numpy(do))
    direct = tfa.flash_attention_bwd(
        *(t.detach() for t in leaves), out.detach(), lse,
        torch.from_numpy(do), causal, None, tsegs, bk)
    for name, g, f, w in zip("qkv", through_function, direct, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5,
                                   err_msg="d" + name)
        assert torch.equal(g, f), "d" + name
        assert g.dtype == torch.float32


def test_backward_returns_each_gradient_in_its_inputs_dtype():
    rng = np.random.RandomState(5)
    q, k, v = (torch.from_numpy(_rand(rng, 1, 2, 24, 8)).bfloat16()
               .requires_grad_() for _ in range(3))
    out = tfa.flash_attention(q, k, v, causal=True)
    assert out.dtype == torch.bfloat16
    grads = torch.autograd.grad(out.float().sum(), (q, k, v))
    assert all(g.dtype == torch.bfloat16 for g in grads)
    assert all(bool(torch.isfinite(g.float()).all()) for g in grads)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(1, 2, 40, 16), (2, 2, 33, 8),
                                   (1, 2, 160, 64)])
def test_bf16_plain_forward_matches_jax_blockwise(shape, causal):
    rng = np.random.RandomState(sum(shape) + causal)
    q, k, v = (_rand(rng, *shape) for _ in range(3))
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    jo, jl = jfa._fwd_blockwise(jq, jk, jv, shape[-1] ** -0.5, causal, None,
                                128)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    to, tl = tfa.flash_attention(tq, tk, tv, causal=causal, return_lse=True)
    assert to.dtype == torch.bfloat16 and tl.dtype == torch.float32
    want = np.asarray(jo.astype(jnp.float32))
    err = np.abs(to.float().numpy() - want)
    assert (err <= 1e-2 * np.abs(want) + 4e-3 * np.abs(want).max()).all(), \
        err.max()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)


def test_bf16_plain_forward_rounds_p_before_pv():
    """The plain version's bfloat16 path rounds P to bfloat16 before P V
    (the JAX kernel's ``p.astype(v.dtype)``): it differs from the same
    inputs in float32, where nothing is rounded, by more than O's own
    rounding alone."""
    rng = np.random.RandomState(9)
    q, k, v = (torch.from_numpy(_rand(rng, 1, 2, 64, 16)).bfloat16()
               for _ in range(3))
    half, _ = tfa.flash_attention_reference(q, k, v, True)
    full, _ = tfa.flash_attention_reference(q.float(), k.float(),
                                            v.float(), True)
    assert half.dtype == full.dtype == torch.float32
    assert float((half - full).abs().max()) > 1e-4


def test_forward_key_split_merges_like_one_walk():
    """The kernel's warps each walk every KEY_SPLIT-th key tile and merge;
    the plain version does the same, and agrees with one walk over all
    the tiles (key_split=1) to float32 rounding, causal or not, with rows
    whose tiles some warps never see."""
    rng = np.random.RandomState(7)
    q, k, v = (torch.from_numpy(_rand(rng, 1, 2, 150, 16)) for _ in range(3))
    seg = torch.from_numpy(_segments(rng, 1, 150))
    for causal in (False, True):
        for segs in (None, (seg, seg)):
            got = tfa.flash_attention_reference(q, k, v, causal, None, segs)
            one = tfa.flash_attention_reference(q, k, v, causal, None, segs,
                                                key_split=1)
            for a, b in zip(got, one):
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                           atol=1e-6)


def _tf32(x):
    """float32 cut to TF32's 10 mantissa bits through the int32 view: the
    kernel's split of a big part, and what the tensor core does with the
    rest of a float32 operand."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b from the kernel's operand split, big = tf32(v) and small =
    v - big (cut to TF32 by the tensor core): small*big + big*small +
    big*big, summed by an IEEE float32 matmul. This models the split of
    S = Q K^T and O = P V, not the tensor core's accumulation, which
    truncates: S's chain is at most 3 x 128 / 8 products deep (D = 128),
    O's 6 products for each key tile of a warp's quarter of them, and
    chip_smoke.py holds the kernel to its plain version on the card."""
    ab, bb = _tf32(a), _tf32(b)
    return _tf32(a - ab) @ bb + ab @ _tf32(b - bb) + ab @ bb


def test_3xtf32_attention_within_1e5_one_tf32_pass_is_not():
    """The served LM's one-shot forward, [1, 8, 160, 64] causal: both
    products in 3xTF32 stay within the kernel's 1e-5 of float64; one TF32
    pass does not."""
    rng = np.random.RandomState(8)
    q, k, v = (torch.from_numpy(_rand(rng, 1, 8, 160, 64)) for _ in range(3))
    causal = torch.ones(160, 160, dtype=torch.bool).tril()

    def attention(mm, q, k, v):
        s = mm(q, k.transpose(-1, -2).contiguous()) * 64 ** -0.5
        s = torch.where(causal, s, tfa.DEFAULT_MASK_VALUE)
        return mm(torch.softmax(s, -1), v)

    truth = attention(torch.matmul, q.double(), k.double(), v.double())
    err3 = (attention(_mm_3xtf32, q, k, v).double() - truth).abs().max()
    err1 = (attention(lambda a, b: _tf32(a) @ _tf32(b), q, k, v).double()
            - truth).abs().max()
    assert err3 < 1e-5 < err1


# ---- the bfloat16 forward's plan: which kernel, which blocking ----

@pytest.mark.parametrize("d,dmax,swizzle", [(8, 32, 64), (32, 32, 64),
                                            (40, 64, 128), (64, 64, 128),
                                            (96, 128, 128), (128, 128, 128)])
def test_fwd_plan_takes_the_wgmma_kernel_where_tma_addresses_the_rows(
        d, dmax, swizzle):
    """bfloat16 with head_dim a multiple of 8 (rows on 16-byte
    boundaries), up to 128, aligned tensors and keys to walk: the wgmma
    kernel fed by TMA, 128 query rows a block as two warpgroups of 64,
    64-key tiles through a 4-stage ring, 128-byte swizzled rows (64-byte
    rows where head_dim fits 32 columns), within one block's shared
    memory and two blocks an SM where head_dim <= 64."""
    p = tfa.fwd_plan(16, 8, 512, 512, d)
    assert p["loader"] == "tma"
    assert (p["dmax"], p["swizzle"]) == (dmax, swizzle)
    assert p["grid"] == (128, 4) and p["threads"] == 256
    assert (p["block_q"], p["walk_q"], p["block_k"], p["key_split"],
            p["stages"]) == (128, 64, 64, 1, 4)
    assert p["smem_bytes"] <= 227 * 1024
    if d <= 64:
        assert 2 * p["smem_bytes"] <= 228 * 1024
    # sq that no block divides: the last block's rows past sq are masked
    assert tfa.fwd_plan(2, 3, 200, 120, d)["grid"] == (6, 2)


@pytest.mark.parametrize("args,kw", [((1, 2, 17, 29, 13), {}),
                                     ((1, 2, 64, 64, 20), {}),
                                     ((1, 2, 64, 64, 64), {"aligned": False}),
                                     ((1, 2, 64, 0, 64), {}),
                                     ((1, 2, 64, 64, 64),
                                      {"dtype": torch.float32})])
def test_fwd_plan_keeps_the_mma_sync_kernel_where_tma_cannot_go(args, kw):
    """head_dim not a multiple of 8, tensors off 16-byte boundaries, no
    keys, and every float32 call: the mma.sync kernels, with their
    blocking (16 query rows, 16-key tiles split between 4 warps)."""
    p = tfa.fwd_plan(*args, **kw)
    assert p["loader"] == "mma_sync"
    assert (p["block_q"], p["block_k"], p["key_split"]) == (
        tfa.BLOCK_Q, tfa.BLOCK_K, tfa.KEY_SPLIT)
    b, h, sq = args[:3]
    assert p["grid"] == (b * h, -(-sq // tfa.BLOCK_Q))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 3, 200, 120, 64), (1, 2, 130, 130, 32),
                                   (1, 2, 64, 100, 40)])
def test_bf16_plain_forward_at_the_wgmma_blocking_within_one_rounding(
        shape, causal):
    """The plain version walking the keys as the wgmma kernel does
    (fwd_plan: 64-row walks, 64-key tiles, no split) and as the mma.sync
    kernel does (16, 16, 4 warps) agree to one bfloat16 rounding of O
    and to 1e-5 on the log-sum-exp: P is rounded against other running
    maxima, nothing else moves. Sq != Sk and head_dims that need zero
    columns included."""
    b, h, sq, sk, d = shape
    rng = np.random.RandomState(sq + d)
    q = torch.from_numpy(_rand(rng, b, h, sq, d)).bfloat16()
    k, v = (torch.from_numpy(_rand(rng, b, h, sk, d)).bfloat16()
            for _ in range(2))
    p = tfa.fwd_plan(b, h, sq, sk, d)
    wo, wl = tfa.flash_attention_reference(
        q, k, v, causal, block_q=p["walk_q"], block_k=p["block_k"],
        key_split=p["key_split"])
    mo, ml = tfa.flash_attention_reference(q, k, v, causal)
    err = (wo.bfloat16().float() - mo.bfloat16().float()).abs()
    want = mo.abs()
    assert bool((err <= 1e-2 * want + 4e-3 * want.max()).all()), \
        float(err.max())
    np.testing.assert_allclose(wl.numpy(), ml.numpy(), rtol=1e-5, atol=1e-5)
