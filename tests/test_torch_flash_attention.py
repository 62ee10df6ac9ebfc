"""The port's flash-attention kernels against the JAX package's.

On the CPU the port's wrappers run their plain versions, which follow
the CUDA kernels' blocking (key tiles, tiles past the diagonal or past
cache_len skipped, the l == 0 guard); those are held against the JAX
functions on the same numpy inputs, run as the JAX package's own tests
run them on the CPU (the Pallas kernels in interpret mode, or their
plain references). Tolerance 2e-5 for O and for the log-sum-exp: the
same fp32 math in another summation order.

The CUDA kernels themselves are held against the plain versions on the
card by tests/test_torch_kernels_cuda.py.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu_torch.kernels import flash_attention as tfa

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


@pytest.mark.parametrize("lens", [[1, 32, 17], [0, 5, 32], [8, 9, 16]])
def test_decode_plain_matches_jax_kernel(lens):
    rng = np.random.RandomState(len(lens) + lens[0])
    b, h, s, d = 3, 2, 32, 8
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
    tfa.flash_decode(x[:, :, :1], x, x, torch.tensor([3], dtype=torch.int32))
    assert tfa.launches == {"flash_attention": 0, "flash_decode": 0}


def test_wrappers_reject_bad_shapes():
    x = torch.randn(1, 2, 8, 8)
    with pytest.raises(ValueError):
        tfa.flash_attention(x, x[:, :, :, :4], x)
    with pytest.raises(ValueError):
        tfa.flash_decode(x, x, x, torch.tensor([3], dtype=torch.int32))


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
