"""The CUDA kernels on the card, held against their plain PyTorch
versions (tolerance 1e-5 absolute and relative: the same fp32 math in
another summation order; the LSTM's and the GRU's backward 1e-5
absolute and 1e-4 relative, their recurrences reorder sums over up to
80 steps). The batch-norm backward and the fused 1x1-conv backward are
also held against float64 plain versions, with the tolerances stated at
their tests; the bfloat16 kernels at one bfloat16 rounding (rtol 1e-2
plus 4e-3 of the largest magnitude).

Marked ``cuda``: each test skips inside itself where torch finds no
card. This file imports torch and the port only (the machine with the
card has no jax), so run it there without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import os

import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.kernels import bn_grad as kbn
from paddle_tpu_torch.kernels import conv1x1_bwd as k1
from paddle_tpu_torch.kernels import gru_cell, lstm_cell

# Under pytest-xdist each worker takes its share of the cores for
# torch's intra-op threads: six workers at torch's default thread count
# oversubscribe the cores, and a test of seconds then takes minutes.
_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, os.cpu_count() // int(_WORKERS)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(1, 8, 32, 64), (2, 3, 200, 64),
                                   (1, 2, 17, 40), (1, 2, 128, 128)])
def test_cuda_forward_matches_plain(cuda, shape, causal):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(*shape, generator=g).to(cuda) for _ in range(3))
    seg = torch.sort(torch.randint(0, 3, (shape[0], shape[2]),
                                   generator=g), dim=1)[0].int().to(cuda)
    for segs in (None, (seg, seg)):
        n0 = tfa.launches["flash_attention"]
        ko, kl = tfa.flash_attention(q, k, v, causal=causal,
                                     segment_ids=segs, return_lse=True)
        assert tfa.launches["flash_attention"] == n0 + 1
        ro, rl = tfa.flash_attention_reference(q, k, v, causal, None, segs)
        torch.cuda.synchronize()
        torch.testing.assert_close(ko, ro, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(kl, rl, rtol=1e-5, atol=1e-5)


# The tensor-core forward: query lengths below, at and across the 16-row
# tile (8, 13, 160), every head_dim instantiation, with segments, and a
# row whose keys are all masked (its segment meets no key's).
@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("sq", [8, 13, 160])
def test_cuda_forward_tiles_heads_and_masked_rows(cuda, sq, d):
    g = torch.Generator().manual_seed(sq + d)
    q, k, v = (torch.randn(2, 3, sq, d, generator=g).to(cuda)
               for _ in range(3))
    qseg = torch.sort(torch.randint(0, 3, (2, sq), generator=g),
                      dim=1)[0].int()
    kseg = qseg.clone()
    qseg[:, -1] = 7                        # meets no key: fully masked
    segs = (qseg.to(cuda), kseg.to(cuda))
    for causal in (False, True):
        for sg in (None, segs):
            ko, kl = tfa.flash_attention(q, k, v, causal=causal,
                                         segment_ids=sg, return_lse=True)
            ro, rl = tfa.flash_attention_reference(q, k, v, causal, None, sg)
            torch.cuda.synchronize()
            torch.testing.assert_close(ko, ro, rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(kl, rl, rtol=1e-5, atol=1e-5)
    # without the causal mask the masked row averages V over every key
    ko = tfa.flash_attention(q, k, v, causal=False, segment_ids=segs)
    torch.cuda.synchronize()
    torch.testing.assert_close(ko[:, :, -1], v.mean(2), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_forward_unaligned_rows_take_the_4_byte_copies(cuda):
    """head_dim 13 (rows on 4-byte boundaries) and a view that starts 4
    bytes into its storage."""
    g = torch.Generator().manual_seed(11)
    q, k, v = (torch.randn(1, 2, 37, 13, generator=g).to(cuda)
               for _ in range(3))
    ko, kl = tfa.flash_attention(q, k, v, causal=True, return_lse=True)
    ro, rl = tfa.flash_attention_reference(q, k, v, True)
    flat = torch.randn(1 + 2 * 37 * 16, generator=g).to(cuda)
    qo = flat[1:].view(1, 2, 37, 16)
    ko2 = tfa.flash_attention(qo, qo, qo, causal=True)
    ro2, _ = tfa.flash_attention_reference(qo, qo, qo, True)
    torch.cuda.synchronize()
    torch.testing.assert_close(ko, ro, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(kl, rl, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ko2, ro2, rtol=1e-5, atol=1e-5)


def _bf16_close(got, want):
    """One bfloat16 rounding: rtol 1e-2 plus 4e-3 of the largest
    magnitude."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    assert bool((err <= 1e-2 * want.abs() + 4e-3 * want.abs().max()).all()), \
        float(err.max())


# The bfloat16 forward: every head_dim instantiation, rows on 16-byte
# boundaries and (head_dim 13, 40 % 8 == 0 but 13 % 8 != 0) element-wise
# staging, the training path's [16, 8, 512, 64], keys ragged against
# the queries, with and without segments.
@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(1, 8, 32, 32, 64), (2, 3, 37, 37, 40),
                                   (1, 2, 17, 29, 13), (1, 2, 200, 200, 128),
                                   (2, 2, 50, 50, 32), (16, 8, 512, 512, 64)])
def test_cuda_bf16_forward_matches_plain(cuda, shape, causal):
    b, h, sq, sk, d = shape
    g = torch.Generator().manual_seed(sq + d)
    q = torch.randn(b, h, sq, d, generator=g).bfloat16().to(cuda)
    k, v = (torch.randn(b, h, sk, d, generator=g).bfloat16().to(cuda)
            for _ in range(2))
    seg = torch.sort(torch.randint(0, 3, (b, sq), generator=g),
                     dim=1)[0].int().to(cuda)
    for segs in (None, (seg, seg)) if sq == sk else (None,):
        n0 = tfa.launches["flash_attention_bf16"]
        f0 = tfa.launches["flash_attention"]
        ko, kl = tfa.flash_attention(q, k, v, causal=causal,
                                     segment_ids=segs, return_lse=True)
        assert tfa.launches["flash_attention_bf16"] == n0 + 1
        assert tfa.launches["flash_attention"] == f0
        assert ko.dtype == torch.bfloat16 and kl.dtype == torch.float32
        ro, rl = tfa.flash_attention_reference(q, k, v, causal, None, segs)
        torch.cuda.synchronize()
        _bf16_close(ko, ro.bfloat16())
        torch.testing.assert_close(kl, rl, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_fused_attention_grad_gives_qkv_gradients(cuda, dtype):
    """``fused_attention``'s generic grad on the card returns dQ, dK and
    dV equal to the CPU's: the forward kernel returns through the
    ``FlashAttention`` Function, whose backward autograd calls. (Before
    it did, the ctypes launch left no autograd graph, and the grad
    returned None for all three.) Card against CPU: 1e-4 of the largest
    magnitude in float32, one bfloat16 rounding in bfloat16."""
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.core.lower import TraceContext

    class FwdOp:
        type, uid, attrs = "fused_attention", 1, {"causal": True}

    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(3)
    q, k, v, do = (torch.randn(2, 4, 100, 64, generator=g)
                   for _ in range(4))
    spec = registry.get("fused_attention")
    got = {}
    for dev in (torch.device("cpu"), cuda):
        ins = {n: [t.to(dev, dt)] for n, t in zip("QKV", (q, k, v))}
        n0 = dict(tfa.launches)
        grads = registry.generic_grad(TraceContext(device=dev), spec, FwdOp,
                                      ins, {"Out": [do.to(dev, dt)]})
        if dev.type == "cuda":
            key = "flash_attention" if dtype == "float32" \
                else "flash_attention_bf16"
            assert tfa.launches[key] == n0[key] + 1
        assert all(grads[n][0] is not None for n in "QKV"), grads
        got[dev.type] = [grads[n][0] for n in "QKV"]
    torch.cuda.synchronize()
    for name, a, b in zip("QKV", got["cuda"], got["cpu"]):
        assert a.dtype == dt, name
        if dtype == "float32":
            torch.testing.assert_close(a.cpu(), b, rtol=0,
                                       atol=1e-4 * float(b.abs().max()))
        else:
            _bf16_close(a.cpu(), b)


@pytest.mark.cuda
def test_cuda_decode_matches_plain(cuda):
    g = torch.Generator().manual_seed(1)
    b, h, s, d = 16, 8, 512, 64
    q = torch.randn(b, h, 1, d, generator=g).to(cuda)
    kc, vc = (torch.randn(b, h, s, d, generator=g).to(cuda)
              for _ in range(2))
    lens = torch.tensor([0, 1, 127, 128, 129, 300, 512] * 3,
                        dtype=torch.int32)[:b].to(cuda)
    out = tfa.flash_decode(q, kc, vc, lens)
    ref = tfa.flash_decode_reference(q, kc, vc, lens)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    assert not out[0].any()


# B2 splits each row's valid prefix over a cluster: every head_dim
# instantiation, lengths at and around the chunk edges (L / 2 at the
# plan's 2 blocks a row) and the edges of the warps' 8-key tiles, past
# the cache (clamped), an empty row, and a cache that starts 4 bytes
# into its storage (the 4-byte copies).
@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128, 40, 13])
def test_cuda_decode_splits_rows_over_a_cluster(cuda, d):
    g = torch.Generator().manual_seed(d)
    b, h, s = 16, 8, 512
    q = torch.randn(b, h, 1, d, generator=g).to(cuda)
    kc, vc = (torch.randn(b, h, s, d, generator=g).to(cuda)
              for _ in range(2))
    lens = torch.tensor([0, 1, 2, 3, 4, 5, 159, 160, 161, 300, 303, 511,
                         512, 600, 127, 129], dtype=torch.int32).to(cuda)
    n0 = tfa.launches["flash_decode"]
    out = tfa.flash_decode(q, kc, vc, lens)
    again = tfa.flash_decode(q, kc, vc, lens)
    assert tfa.launches["flash_decode"] == n0 + 2
    ref = tfa.flash_decode_reference(q, kc, vc, lens)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    assert torch.equal(out, again)
    assert not out[0].any()
    flat = torch.randn(1 + b * h * s * d, generator=g).to(cuda)
    kv = flat[1:].view(b, h, s, d)
    out = tfa.flash_decode(q, kv, kv, lens)
    ref = tfa.flash_decode_reference(q, kv, kv, lens)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


# B2 over bfloat16 caches (DecodeEngine(cache_dtype="bfloat16")): q and
# the output float32, p rounded to bf16 before the P V sum. Held against
# its plain version (the same walk and roundings) and a float64 witness
# with the same roundings, at one bfloat16 rounding (_bf16_close: the
# rounding of p can flip by one bf16 ulp where the two compute p = exp(s
# - m) in another order), at every head_dim instantiation, head_dim 40
# and 13 (13 % 8 != 0: 2-byte loads) and a cache 2 bytes into its
# storage (no 16-byte rows); ragged lengths; twice to the same bits; and
# replayed in a CUDA graph to its eager bits.
@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128, 40, 13])
def test_cuda_decode_bf16_matches_plain_and_float64(cuda, d):
    g = torch.Generator().manual_seed(100 + d)
    b, h, s = 16, 8, 512
    q = torch.randn(b, h, 1, d, generator=g).to(cuda)
    kc, vc = (torch.randn(b, h, s, d, generator=g).to(torch.bfloat16)
              .to(cuda) for _ in range(2))
    lens = torch.tensor([0, 1, 2, 3, 4, 5, 159, 160, 161, 300, 303, 511,
                         512, 600, 127, 129], dtype=torch.int32).to(cuda)
    n0 = dict(tfa.launches)
    out = tfa.flash_decode(q, kc, vc, lens)
    again = tfa.flash_decode(q, kc, vc, lens)
    assert tfa.launches["flash_decode_bf16"] == n0["flash_decode_bf16"] + 2
    assert tfa.launches["flash_decode"] == n0["flash_decode"]
    assert out.dtype == torch.float32
    plain = tfa.flash_decode_reference(q, kc, vc, lens)
    witness = tfa.flash_decode_reference(q, kc, vc, lens,
                                         acc=torch.float64)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert not out[0].any()
    _bf16_close(out, plain)
    _bf16_close(out, witness)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tfa.flash_decode(q, kc, vc, lens)         # loaded before capture
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        captured = tfa.flash_decode(q, kc, vc, lens)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, out)
    flat = torch.randn(1 + b * h * s * d, generator=g).to(
        torch.bfloat16).to(cuda)
    kv = flat[1:].view(b, h, s, d)
    _bf16_close(tfa.flash_decode(q, kv, kv, lens),
                tfa.flash_decode_reference(q, kv, kv, lens))


@pytest.mark.cuda
def test_cuda_decode_never_reads_past_the_length(cuda):
    g = torch.Generator().manual_seed(3)
    b, h, s, d = 4, 8, 512, 64
    q = torch.randn(b, h, 1, d, generator=g).to(cuda)
    kc, vc = (torch.randn(b, h, s, d, generator=g).to(cuda)
              for _ in range(2))
    lens = torch.tensor([0, 1, 160, 511], dtype=torch.int32)
    want = tfa.flash_decode(q, kc, vc, lens.to(cuda))
    for i, n in enumerate(lens.tolist()):
        kc[i, :, n:] = float("nan")
        vc[i, :, n:] = float("nan")
    got = tfa.flash_decode(q, kc, vc, lens.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 8, 512, 64), (1, 8, 512, 64),
                                   (3, 2, 100, 13), (64, 8, 512, 128),
                                   (2, 1, 32, 32)])
def test_cuda_decode_plan_matches_the_kernels(cuda, shape):
    import ctypes

    from paddle_tpu_torch.kernels import _build

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for itemsize in (4, 2):     # float32 and bfloat16 caches
        out = (ctypes.c_int * 5)()
        rc = _build.load("flash_attention").decode_plan(
            *shape, sms, itemsize, ctypes.addressof(out))
        assert rc == 0
        plan = tfa.decode_plan(*shape, sms, itemsize)
        assert list(out) == [plan["blocks_per_row"], plan["threads"],
                             plan["stages"], plan["smem_bytes"],
                             plan["tile_keys"]]


@pytest.mark.cuda
def test_cuda_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x = torch.randn(1, 2, 8, 8, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        tfa.flash_attention(x.half(), x.half(), x.half())
    with pytest.raises(ValueError, match="contiguous"):
        t = x.transpose(1, 2)
        tfa.flash_attention(t, t, t)
    with pytest.raises(ValueError, match="int32"):
        tfa.flash_decode(x[:, :, :1].contiguous(), x, x,
                         torch.tensor([3], device=cuda))


# The bfloat16 forward redesigned for Hopper (wgmma fed by TMA) at its
# edges, held against the plain version walking the keys as the kernel
# does (fwd_plan) and against float64, twice to the same bits: sq not a
# multiple of its 128 rows, sq != sk both ways, not causal, head_dim 32,
# 40 (zero columns) and 128, segments, and head_dim 13, which the plan
# sends to the mma.sync kernel.
@pytest.mark.cuda
@pytest.mark.parametrize("case", [(2, 4, 200, 200, 64, True, False),
                                  (2, 3, 200, 120, 64, False, False),
                                  (2, 3, 120, 200, 64, True, False),
                                  (2, 4, 256, 256, 64, False, True),
                                  (2, 2, 130, 130, 32, True, False),
                                  (1, 2, 200, 200, 128, True, True),
                                  (1, 2, 64, 100, 40, True, False),
                                  (1, 2, 17, 29, 13, True, False)])
def test_cuda_bf16_forward_at_the_wgmma_kernels_edges(cuda, case):
    b, h, sq, sk, d, causal, seg = case
    g = torch.Generator().manual_seed(sq + sk + d)
    q = torch.randn(b, h, sq, d, generator=g).bfloat16().to(cuda)
    k, v = (torch.randn(b, h, sk, d, generator=g).bfloat16().to(cuda)
            for _ in range(2))
    segs = None
    if seg:
        ids = torch.sort(torch.randint(0, 3, (b, sq), generator=g),
                         dim=1)[0].int().to(cuda)
        segs = (ids, ids)
    plan = tfa.fwd_plan(b, h, sq, sk, d)
    assert plan["loader"] == ("tma" if d % 8 == 0 else "mma_sync")
    n0 = tfa.launches["flash_attention_bf16"]
    ko, kl = tfa.flash_attention(q, k, v, causal=causal, segment_ids=segs,
                                 return_lse=True)
    assert tfa.launches["flash_attention_bf16"] == n0 + 1
    ko2, kl2 = tfa.flash_attention(q, k, v, causal=causal, segment_ids=segs,
                                   return_lse=True)
    ro, rl = tfa.flash_attention_reference(
        q, k, v, causal, None, segs, block_q=plan["walk_q"],
        block_k=plan["block_k"], key_split=plan["key_split"])
    sc = torch.einsum("bhqd,bhkd->bhqk", q.double(), k.double()) * d ** -0.5
    ok = torch.ones(sq, sk, dtype=torch.bool, device=cuda)
    if causal:
        ok = torch.arange(sq, device=cuda)[:, None] >= \
            torch.arange(sk, device=cuda)[None, :]
    ok = ok[None, None]
    if segs is not None:
        ok = ok & (segs[0][:, None, :, None] == segs[1][:, None, None, :])
    truth = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(
        torch.where(ok, sc, tfa.DEFAULT_MASK_VALUE), -1), v.double())
    torch.cuda.synchronize()
    assert torch.equal(ko, ko2) and torch.equal(kl, kl2)
    _bf16_close(ko, ro.bfloat16())
    _bf16_close(ko, truth)
    torch.testing.assert_close(kl, rl, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_bf16_forward_refuses_tma_where_the_rows_do_not_allow(cuda):
    """The C entry checks the plan's choice and returns an error where
    TMA cannot address the rows (head_dim 13): no launch, no fallback."""
    import ctypes
    from paddle_tpu_torch.kernels import _build

    q = torch.randn(1, 2, 16, 13, device=cuda).bfloat16()
    o = torch.empty_like(q)
    lse = torch.empty(1, 2, 16, device=cuda)
    lib = _build.load("flash_attention")
    rc = lib.flash_attention_fwd_bf16(
        q.data_ptr(), q.data_ptr(), q.data_ptr(), None, None, o.data_ptr(),
        lse.data_ptr(), 1, 2, 16, 16, 13, ctypes.c_float(0.25), 1, 1,
        torch.cuda.current_stream().cuda_stream)
    assert rc != 0


def _lstm_inputs(B, T, H, peep, seed, device):
    g = torch.Generator().manual_seed(seed)
    xg = torch.randn(B, T, 4 * H, generator=g) * 0.5
    w = torch.randn(H, 4 * H, generator=g) * H ** -0.5
    h0 = torch.randn(B, H, generator=g) * 0.1
    c0 = torch.randn(B, H, generator=g) * 0.1
    lens = torch.randint(0, T + 1, (B,), generator=g)
    lens[0], lens[-1] = 0, T           # an empty row and a full one
    mask = (torch.arange(T)[None] < lens[:, None]).float()
    p = torch.randn(3, H, generator=g) * 0.1 if peep else torch.zeros(3, H)
    dhs = torch.randn(B, T, H, generator=g)
    dcs = torch.randn(B, T, H, generator=g)
    return [t.to(device) for t in (xg, w, h0, c0, mask, p, dhs, dcs)]


@pytest.mark.cuda
@pytest.mark.parametrize("peep", [True, False])
@pytest.mark.parametrize("shape", [(8, 5, 32), (64, 80, 512), (37, 17, 128),
                                   (70, 6, 40), (1, 7, 512), (128, 9, 512)])
def test_cuda_lstm_matches_plain(cuda, shape, peep):
    xg, w, h0, c0, mask, p, dhs, dcs = _lstm_inputs(*shape, peep, 2, cuda)
    n = dict(lstm_cell.launches)
    hs, cs, stash = lstm_cell.lstm_forward(xg, w, h0, c0, mask, p)
    rhs, rcs, rst = lstm_cell.lstm_forward_reference(xg, w, h0, c0, mask, p)
    torch.cuda.synchronize()
    for got, want in ((hs, rhs), (cs, rcs), (stash, rst)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    got = lstm_cell.lstm_backward(rst, rcs, w, p, c0, mask, dhs, dcs)
    want = lstm_cell.lstm_backward_reference(rst, rcs, w, p, c0, mask, dhs,
                                             dcs)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    assert lstm_cell.launches == dict(n, lstm_fwd=n["lstm_fwd"] + 1,
                                      lstm_bwd=n["lstm_bwd"] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 80, 512), (200, 4, 64)])
def test_cuda_lstm_two_runs_agree_to_the_bit(cuda, shape):
    """No float atomics: every sum of both kernels has a fixed order."""
    xg, w, h0, c0, mask, p, dhs, dcs = _lstm_inputs(*shape, True, 5, cuda)
    runs = []
    for _ in range(2):
        hs, cs, stash = lstm_cell.lstm_forward(xg, w, h0, c0, mask, p)
        runs.append((hs, cs, stash) + lstm_cell.lstm_backward(
            stash, cs, w, p, c0, mask, dhs, dcs))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_lstm_launch_plan(cuda):
    """At the path's shape both kernels run both row groups at once on
    128 resident blocks; B4's blocks pair up in clusters of two."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    fwd = lstm_cell.launch_plan("lstm_fwd", 64, 512, cuda)
    bwd = lstm_cell.launch_plan("lstm_bwd", 64, 512, cuda)
    assert (fwd["cluster"], fwd["blocks"], fwd["rounds"]) == (1, 128, 1)
    assert (bwd["cluster"], bwd["blocks"], bwd["rounds"]) == (2, 128, 1)
    assert fwd["blocks"] <= sms and bwd["blocks"] <= sms
    # each block reads its row group's h_{t-1} (32 x 512) and each block
    # of a pair half its row group's dgates_t (32 x 1024)
    assert fwd["exchange_bytes"] == 128 * 32 * 512 * 4
    assert bwd["exchange_bytes"] == 128 * 32 * 1024 * 4


@pytest.mark.cuda
def test_cuda_lstm_autograd_goes_through_both_kernels(cuda):
    xg, w, h0, c0, mask, p, dhs, dcs = _lstm_inputs(16, 9, 64, True, 3, cuda)
    leaves = [t.clone().requires_grad_() for t in (xg, w, h0, c0, p)]
    lstm_cell.reset_launches()
    hs, cs = lstm_cell.lstm_sequence(leaves[0], leaves[1], leaves[2],
                                     leaves[3], mask, leaves[4])
    got = torch.autograd.grad((hs, cs), leaves, (dhs, dcs))
    assert lstm_cell.launches == {"lstm_fwd": 1, "lstm_bwd": 1,
                                  "lstm_fwd_bf16": 0, "lstm_bwd_bf16": 0}
    cpu = [t.detach().cpu().requires_grad_() for t in leaves]
    rhs, rcs = lstm_cell.lstm_sequence(cpu[0], cpu[1], cpu[2], cpu[3],
                                       mask.cpu(), cpu[4])
    want = torch.autograd.grad((rhs, rcs), cpu, (dhs.cpu(), dcs.cpu()))
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_cuda_lstm_raises_on_what_the_kernels_do_not_take(cuda):
    xg, w, h0, c0, mask, p, _, _ = _lstm_inputs(4, 3, 8, True, 4, cuda)
    with pytest.raises(ValueError, match="float32"):
        lstm_cell.lstm_forward(xg.double(), w, h0, c0, mask, p)
    with pytest.raises(ValueError, match="contiguous"):
        lstm_cell.lstm_forward(xg, w.t().contiguous().t(), h0, c0, mask, p)


def _gru_inputs(B, T, H, seed, device):
    g = torch.Generator().manual_seed(seed)
    xg = torch.randn(B, T, 3 * H, generator=g) * 0.5
    w = torch.randn(H, 3 * H, generator=g) * H ** -0.5
    h0 = torch.randn(B, H, generator=g) * 0.1
    lens = torch.randint(0, T + 1, (B,), generator=g)
    lens[0], lens[-1] = 0, T           # an empty row and a full one
    mask = (torch.arange(T)[None] < lens[:, None]).float()
    dhs = torch.randn(B, T, H, generator=g)
    return [t.to(device) for t in (xg, w, h0, mask, dhs)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 5, 32), (64, 30, 512), (37, 17, 128),
                                   (70, 6, 40), (33, 11, 200)])
def test_cuda_gru_matches_plain(cuda, shape):
    """H 40 and 200 are no multiple of 16: the second block of B6's last
    pair has no unit; the masks are ragged, with an empty and a full
    row."""
    xg, w, h0, mask, dhs = _gru_inputs(*shape, 2, cuda)
    n = dict(gru_cell.launches)
    hs, stash = gru_cell.gru_forward(xg, w, h0, mask)
    rhs, rst = gru_cell.gru_forward_reference(xg, w, h0, mask)
    torch.cuda.synchronize()
    for got, want in ((hs, rhs), (stash, rst)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    got = gru_cell.gru_backward(rst, rhs, w, h0, mask, dhs)
    want = gru_cell.gru_backward_reference(rst, rhs, w, h0, mask, dhs)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    assert gru_cell.launches == dict(n, gru_fwd=n["gru_fwd"] + 1,
                                     gru_bwd=n["gru_bwd"] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 30, 512), (200, 4, 64)])
def test_cuda_gru_two_runs_agree_to_the_bit(cuda, shape):
    """No float atomics in B5 or B6: every sum has a fixed order."""
    xg, w, h0, mask, dhs = _gru_inputs(*shape, 5, cuda)
    runs = []
    for _ in range(2):
        hs, stash = gru_cell.gru_forward(xg, w, h0, mask)
        runs.append((hs, stash) + gru_cell.gru_backward(stash, hs, w, h0,
                                                        mask, dhs))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gru_fwd", "gru_bwd"])
@pytest.mark.parametrize("shape", [(64, 512), (200, 512), (3, 20),
                                   (64, 856), (64, 864)])
def test_cuda_gru_launch_plan_matches_the_kernels(cuda, shape, kind):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    if (kind, shape) == ("gru_bwd", (64, 864)):
        # past B6's shared memory: both plans refuse it
        with pytest.raises(ValueError, match="resident"):
            gru_cell.launch_plan(kind, *shape, sms=sms)
        with pytest.raises(RuntimeError, match="gru_plan"):
            gru_cell.card_plan(kind, *shape, cuda)
        return
    plan = gru_cell.launch_plan(kind, *shape, sms=sms)
    card = gru_cell.card_plan(kind, *shape, cuda)
    assert card == {k: plan[k] for k in card}
    if shape == (64, 512):
        assert (plan["blocks"], plan["rows_in_flight"]) == (128, 2)


@pytest.mark.cuda
def test_cuda_gru_autograd_goes_through_both_kernels(cuda):
    xg, w, h0, mask, dhs = _gru_inputs(16, 9, 64, 3, cuda)
    leaves = [t.clone().requires_grad_() for t in (xg, w, h0)]
    gru_cell.reset_launches()
    hs = gru_cell.gru_sequence(leaves[0], leaves[1], leaves[2], mask)
    got = torch.autograd.grad(hs, leaves, dhs)
    assert gru_cell.launches == {"gru_fwd": 1, "gru_bwd": 1,
                                 "gru_fwd_bf16": 0, "gru_bwd_bf16": 0}
    cpu = [t.detach().cpu().requires_grad_() for t in leaves]
    rhs = gru_cell.gru_sequence(cpu[0], cpu[1], cpu[2], mask.cpu())
    want = torch.autograd.grad(rhs, cpu, dhs.cpu())
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_cuda_gru_raises_on_what_the_kernels_do_not_take(cuda):
    xg, w, h0, mask, _ = _gru_inputs(4, 3, 8, 4, cuda)
    with pytest.raises(ValueError, match="float32"):
        gru_cell.gru_forward(xg.double(), w, h0, mask)
    with pytest.raises(ValueError, match="contiguous"):
        gru_cell.gru_forward(xg, w.t().contiguous().t(), h0, mask)
    # past one resident block of 8 units an SM (a row group wider than
    # the SMs; W's slice past 227 KB from H = 872) the cooperative grid
    # cannot launch: the wrapper raises, never runs the plain version
    big = 8 * torch.cuda.get_device_properties(cuda).multi_processor_count + 8
    xg, w, h0, mask, dhs = _gru_inputs(2, 2, big, 5, cuda)
    with pytest.raises(RuntimeError, match="gru_fwd launch failed"):
        gru_cell.gru_forward(xg, w, h0, mask)
    with pytest.raises(RuntimeError, match="gru_bwd launch failed"):
        gru_cell.gru_backward(xg, dhs, w, h0, mask, dhs)
    for kind in ("gru_fwd", "gru_bwd"):
        with pytest.raises(ValueError, match="resident"):
            gru_cell.launch_plan(kind, 2, big)
    xg, w, h0, mask, _ = _gru_inputs(2, 2, 872, 5, cuda)
    with pytest.raises(RuntimeError, match="gru_fwd launch failed"):
        gru_cell.gru_forward(xg, w, h0, mask)
    # B6's slices of W, its slots and the partner's sums pass 227 KB
    # from H = 864
    xg, w, h0, mask, dhs = _gru_inputs(2, 2, 864, 5, cuda)
    with pytest.raises(RuntimeError, match="gru_bwd launch failed"):
        gru_cell.gru_backward(xg, dhs, w, h0, mask, dhs)


def _close(got, want, rtol, atol_of_max):
    """|got - want| <= atol_of_max * max|want| + rtol * |want|."""
    want = want.to(torch.float64)
    atol = atol_of_max * float(want.abs().max())
    torch.testing.assert_close(got.to(torch.float64), want, rtol=rtol,
                               atol=atol)

# ---- the bfloat16 B3-B6 (the bf16 AMP path) ----
#
# Kernel and plain version take the same bf16 inputs and round at the
# same places (h_{t-1}, r h_{t-1}, dgates_t, da_c, da_ur before their
# products; the outputs as stored); their float32 sums differ in order,
# and a difference at a rounding boundary flips one bf16 ulp that the
# recurrence carries on: held at one bfloat16 rounding (rtol 1e-2 plus
# 4e-3 of the largest magnitude), as chip_smoke.py holds them.
BF16_RTOL, BF16_AMAX = 1e-2, 4e-3


def _bf16(ts, n):
    """The first n tensors (xg, w) in bfloat16, the rest as they are."""
    return [t.to(torch.bfloat16) if i < n else t for i, t in enumerate(ts)]


@pytest.mark.cuda
@pytest.mark.parametrize("peep", [True, False])
@pytest.mark.parametrize("shape", [(8, 5, 32), (64, 80, 512), (37, 17, 128),
                                   (70, 6, 40), (128, 9, 512), (200, 4, 64)])
def test_cuda_lstm_bf16_matches_plain(cuda, shape, peep):
    """(200, 4, 64) runs row groups past the two whose carries stay in
    registers."""
    xg, w, h0, c0, mask, p, dhs, dcs = _bf16(
        _lstm_inputs(*shape, peep, 2, cuda), 2)
    dhs, dcs = dhs.to(torch.bfloat16), dcs.to(torch.bfloat16)
    n = dict(lstm_cell.launches)
    hs, cs, stash = lstm_cell.lstm_forward(xg, w, h0, c0, mask, p)
    rhs, rcs, rst = lstm_cell.lstm_forward_reference(xg, w, h0, c0, mask, p)
    torch.cuda.synchronize()
    assert (hs.dtype, cs.dtype, stash.dtype) == (
        torch.bfloat16, torch.float32, torch.bfloat16)
    for got, want in ((hs, rhs), (cs, rcs), (stash, rst)):
        _close(got, want, BF16_RTOL, BF16_AMAX)
    got = lstm_cell.lstm_backward(rst, rcs, w, p, c0, mask, dhs, dcs)
    want = lstm_cell.lstm_backward_reference(rst, rcs, w, p, c0, mask, dhs,
                                             dcs)
    torch.cuda.synchronize()
    assert [t.dtype for t in got] == [t.dtype for t in want] == [
        torch.bfloat16] + [torch.float32] * 3
    for a, b in zip(got, want):
        _close(a, b, BF16_RTOL, BF16_AMAX)
    assert lstm_cell.launches == dict(
        n, lstm_fwd_bf16=n["lstm_fwd_bf16"] + 1,
        lstm_bwd_bf16=n["lstm_bwd_bf16"] + 1)


@pytest.mark.cuda
def test_cuda_lstm_bf16_two_runs_agree_and_plan_halves_the_exchange(cuda):
    xg, w, h0, c0, mask, p, dhs, dcs = _bf16(
        _lstm_inputs(64, 80, 512, True, 5, cuda), 2)
    dhs, dcs = dhs.to(torch.bfloat16), dcs.to(torch.bfloat16)
    runs = []
    for _ in range(2):
        hs, cs, stash = lstm_cell.lstm_forward(xg, w, h0, c0, mask, p)
        runs.append((hs, cs, stash) + lstm_cell.lstm_backward(
            stash, cs, w, p, c0, mask, dhs, dcs))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    for kind, cluster, k in (("lstm_fwd", 1, 512), ("lstm_bwd", 2, 1024)):
        plan = lstm_cell.launch_plan(kind, 64, 512, cuda, torch.bfloat16)
        assert (plan["cluster"], plan["blocks"], plan["rounds"]) == (
            cluster, 128, 1)
        assert plan["exchange_bytes"] == 128 * 32 * k * 2


@pytest.mark.cuda
def test_cuda_lstm_bf16_autograd_goes_through_both_bf16_kernels(cuda):
    xg, w, h0, c0, mask, p, dhs, dcs = _lstm_inputs(16, 9, 64, True, 3, cuda)
    leaves = [t.clone().to(torch.bfloat16).requires_grad_()
              for t in (xg, w, h0, c0)] + [p.clone().requires_grad_()]
    dhs, dcs = dhs.to(torch.bfloat16), dcs.to(torch.bfloat16)
    lstm_cell.reset_launches()
    hs, cs = lstm_cell.lstm_sequence(leaves[0], leaves[1], leaves[2],
                                     leaves[3], mask, leaves[4])
    got = torch.autograd.grad((hs, cs), leaves, (dhs, dcs))
    assert lstm_cell.launches == {"lstm_fwd": 0, "lstm_bwd": 0,
                                  "lstm_fwd_bf16": 1, "lstm_bwd_bf16": 1}
    assert [g.dtype for g in got] == [t.dtype for t in leaves]
    cpu = [t.detach().cpu().requires_grad_() for t in leaves]
    rhs, rcs = lstm_cell.lstm_sequence(cpu[0], cpu[1], cpu[2], cpu[3],
                                       mask.cpu(), cpu[4])
    want = torch.autograd.grad((rhs, rcs), cpu, (dhs.cpu(), dcs.cpu()))
    for a, b in zip(got, want):
        _close(a.cpu(), b, BF16_RTOL, BF16_AMAX)


# ---- the bfloat16 B3 and B4 as one thread-block cluster per row group
# (csrc/lstm_cluster.cu), wherever kernels.lstm_cell.cluster_plan takes
# the shape; lstm_cell.cu's bf16 kernels take the rest ----


@pytest.mark.cuda
def test_cuda_lstm_cluster_plan_is_the_cards(cuda):
    """The card's plan (lstm_cluster_plan) is cluster_plan's for both
    kernels: the path's [64, *, 512] in clusters of 16 blocks, 4 row
    groups of 16 rows, all at once; H 1024 and H 36 refused."""
    for b, h in ((64, 512), (8, 32), (5, 40), (200, 64), (16, 1024), (5, 36)):
        want = lstm_cell.cluster_plan(b, h)
        for kind in ("lstm_fwd", "lstm_bwd"):
            card = lstm_cell.card_cluster_plan(kind, b, h, cuda)
            assert {k: card[k] for k in want} == want, (kind, b, h)
            assert card["clusters_at_once"] >= (1 if want["take"] else 0)
    assert lstm_cell.cluster_plan(64, 512) == dict(
        take=True, blocks=16, rows=16, units=32, row_groups=4)
    for kind in ("lstm_fwd", "lstm_bwd"):
        assert lstm_cell.card_cluster_plan(kind, 64, 512,
                                           cuda)["clusters_at_once"] >= 4


@pytest.mark.cuda
@pytest.mark.parametrize("peep", [True, False])
@pytest.mark.parametrize("shape", [(8, 5, 32), (5, 7, 40), (64, 80, 512),
                                   (37, 17, 128), (200, 4, 64), (16, 6, 1024),
                                   (5, 7, 36)])
def test_cuda_lstm_cluster_matches_plain(cuda, shape, peep):
    """Each shape on the kernel its plan gives it (H 1024 and H 36 on
    lstm_cell.cu's), held against the plain version in the same blocking,
    the forward's stash read back by the backward, and counted under the
    bf16 kernels' names."""
    xg, w, h0, c0, mask, p, dhs, dcs = _bf16(
        _lstm_inputs(*shape, peep, 7, cuda), 2)
    dhs, dcs = dhs.to(torch.bfloat16), dcs.to(torch.bfloat16)
    n = dict(lstm_cell.launches)
    hs, cs, stash = lstm_cell.lstm_forward(xg, w, h0, c0, mask, p)
    rhs, rcs, rst = lstm_cell.lstm_forward_reference(xg, w, h0, c0, mask, p)
    got = lstm_cell.lstm_backward(stash, cs, w, p, c0, mask, dhs, dcs)
    want = lstm_cell.lstm_backward_reference(stash, cs, w, p, c0, mask, dhs,
                                             dcs)
    torch.cuda.synchronize()
    for a, b in ((hs, rhs), (cs, rcs), (stash, rst)) + tuple(zip(got, want)):
        assert a.dtype == b.dtype
        _close(a, b, BF16_RTOL, BF16_AMAX)
    assert lstm_cell.launches == dict(
        n, lstm_fwd_bf16=n["lstm_fwd_bf16"] + 1,
        lstm_bwd_bf16=n["lstm_bwd_bf16"] + 1)


@pytest.mark.cuda
def test_cuda_lstm_cluster_two_runs_agree_to_the_bit(cuda):
    assert lstm_cell.cluster_plan(64, 512)["take"]
    xg, w, h0, c0, mask, p, dhs, dcs = _bf16(
        _lstm_inputs(64, 80, 512, True, 8, cuda), 2)
    dhs, dcs = dhs.to(torch.bfloat16), dcs.to(torch.bfloat16)
    runs = []
    for _ in range(2):
        hs, cs, stash = lstm_cell.lstm_forward(xg, w, h0, c0, mask, p)
        runs.append((hs, cs, stash) + lstm_cell.lstm_backward(
            stash, cs, w, p, c0, mask, dhs, dcs))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_lstm_cluster_autograd_goes_through_both_kernels(cuda):
    """lstm_sequence on bf16 inputs at a shape the plan takes: one launch
    of each cluster kernel (under the bf16 kernels' counters), gradients
    of every input against the CPU's plain route."""
    assert lstm_cell.cluster_plan(21, 96)["take"]
    xg, w, h0, c0, mask, p, dhs, dcs = _lstm_inputs(21, 11, 96, True, 9,
                                                    cuda)
    leaves = [t.clone().to(torch.bfloat16).requires_grad_()
              for t in (xg, w, h0, c0)] + [p.clone().requires_grad_()]
    dhs, dcs = dhs.to(torch.bfloat16), dcs.to(torch.bfloat16)
    lstm_cell.reset_launches()
    hs, cs = lstm_cell.lstm_sequence(leaves[0], leaves[1], leaves[2],
                                     leaves[3], mask, leaves[4])
    got = torch.autograd.grad((hs, cs), leaves, (dhs, dcs))
    assert lstm_cell.launches == {"lstm_fwd": 0, "lstm_bwd": 0,
                                  "lstm_fwd_bf16": 1, "lstm_bwd_bf16": 1}
    cpu = [t.detach().cpu().requires_grad_() for t in leaves]
    rhs, rcs = lstm_cell.lstm_sequence(cpu[0], cpu[1], cpu[2], cpu[3],
                                       mask.cpu(), cpu[4])
    want = torch.autograd.grad((rhs, rcs), cpu, (dhs.cpu(), dcs.cpu()))
    for a, b in zip((hs, cs) + got, (rhs, rcs) + want):
        _close(a.detach().cpu(), b.detach(), BF16_RTOL, BF16_AMAX)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 5, 32), (64, 30, 512), (37, 17, 128),
                                   (70, 6, 40), (33, 11, 200), (200, 4, 64)])
def test_cuda_gru_bf16_matches_plain(cuda, shape):
    xg, w, h0, mask, dhs = _bf16(_gru_inputs(*shape, 2, cuda), 2)
    dhs = dhs.to(torch.bfloat16)
    n = dict(gru_cell.launches)
    hs, stash = gru_cell.gru_forward(xg, w, h0, mask)
    rhs, rst = gru_cell.gru_forward_reference(xg, w, h0, mask)
    torch.cuda.synchronize()
    assert hs.dtype == stash.dtype == torch.bfloat16
    for got, want in ((hs, rhs), (stash, rst)):
        _close(got, want, BF16_RTOL, BF16_AMAX)
    got = gru_cell.gru_backward(rst, rhs, w, h0, mask, dhs)
    want = gru_cell.gru_backward_reference(rst, rhs, w, h0, mask, dhs)
    torch.cuda.synchronize()
    assert (got[0].dtype, got[1].dtype) == (torch.bfloat16, torch.float32)
    for a, b in zip(got, want):
        _close(a, b, BF16_RTOL, BF16_AMAX)
    assert gru_cell.launches == dict(n, gru_fwd_bf16=n["gru_fwd_bf16"] + 1,
                                     gru_bwd_bf16=n["gru_bwd_bf16"] + 1)


@pytest.mark.cuda
def test_cuda_gru_bf16_two_runs_agree_and_plans_match(cuda):
    xg, w, h0, mask, dhs = _bf16(_gru_inputs(64, 30, 512, 5, cuda), 2)
    dhs = dhs.to(torch.bfloat16)
    runs = []
    for _ in range(2):
        hs, stash = gru_cell.gru_forward(xg, w, h0, mask)
        runs.append((hs, stash) + gru_cell.gru_backward(stash, hs, w, h0,
                                                        mask, dhs))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for kind in ("gru_fwd", "gru_bwd"):
        for shape in ((64, 512), (200, 512), (3, 20)):
            plan = gru_cell.launch_plan(kind, *shape, sms=sms,
                                        dtype=torch.bfloat16)
            card = gru_cell.card_plan(kind, *shape, cuda, torch.bfloat16)
            assert card == {k: plan[k] for k in card}


@pytest.mark.cuda
def test_cuda_gru_bf16_autograd_goes_through_both_bf16_kernels(cuda):
    xg, w, h0, mask, dhs = _gru_inputs(16, 9, 64, 3, cuda)
    leaves = [t.clone().to(torch.bfloat16).requires_grad_()
              for t in (xg, w, h0)]
    dhs = dhs.to(torch.bfloat16)
    gru_cell.reset_launches()
    hs = gru_cell.gru_sequence(leaves[0], leaves[1], leaves[2], mask)
    got = torch.autograd.grad(hs, leaves, dhs)
    assert gru_cell.launches == {"gru_fwd": 0, "gru_bwd": 0,
                                 "gru_fwd_bf16": 1, "gru_bwd_bf16": 1}
    assert [g.dtype for g in got] == [torch.bfloat16] * 3
    cpu = [t.detach().cpu().requires_grad_() for t in leaves]
    rhs = gru_cell.gru_sequence(cpu[0], cpu[1], cpu[2], mask.cpu())
    want = torch.autograd.grad(rhs, cpu, dhs.cpu())
    for a, b in zip(got, want):
        _close(a.cpu(), b, BF16_RTOL, BF16_AMAX)


# ---- the bfloat16 B5 and B6 as one thread-block cluster per row group
# (csrc/gru_cluster.cu), wherever kernels.gru_cell.cluster_plan takes the
# shape; gru_cell.cu's bf16 kernels take the rest ----


@pytest.mark.cuda
def test_cuda_gru_cluster_plan_is_the_cards(cuda):
    """The card's plan (gru_cluster_plan) is cluster_plan's for both
    kernels: the path's [64, *, 512] in clusters of 16 blocks, 4 row
    groups of 16 rows, all at once; H 1024 and H 36 refused."""
    for b, h in ((64, 512), (8, 32), (5, 40), (200, 64), (16, 1024), (5, 36)):
        want = gru_cell.cluster_plan(b, h)
        for kind in ("gru_fwd", "gru_bwd"):
            card = gru_cell.card_cluster_plan(kind, b, h, cuda)
            assert {k: card[k] for k in want} == want, (kind, b, h)
            assert card["clusters_at_once"] >= (1 if want["take"] else 0)
    assert gru_cell.cluster_plan(64, 512) == dict(
        take=True, blocks=16, rows=16, units=32, row_groups=4)
    for kind in ("gru_fwd", "gru_bwd"):
        assert gru_cell.card_cluster_plan(kind, 64, 512,
                                          cuda)["clusters_at_once"] >= 4


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 5, 32), (5, 7, 40), (64, 30, 512),
                                   (37, 17, 128), (18, 6, 288), (16, 6, 1024),
                                   (5, 7, 36)])
def test_cuda_gru_cluster_matches_plain(cuda, shape):
    """Each shape on the kernel its plan gives it (H 1024 and H 36 on
    gru_cell.cu's; H 288 fills both of the cluster forward's K halves),
    held against the plain version in the same blocking, the forward's
    stash and hs read back by the backward, and counted under the bf16
    kernels' names."""
    xg, w, h0, mask, dhs = _bf16(_gru_inputs(*shape, 7, cuda), 2)
    dhs = dhs.to(torch.bfloat16)
    n = dict(gru_cell.launches)
    hs, stash = gru_cell.gru_forward(xg, w, h0, mask)
    rhs, rst = gru_cell.gru_forward_reference(xg, w, h0, mask)
    got = gru_cell.gru_backward(stash, hs, w, h0, mask, dhs)
    want = gru_cell.gru_backward_reference(stash, hs, w, h0, mask, dhs)
    torch.cuda.synchronize()
    for a, b in ((hs, rhs), (stash, rst)) + tuple(zip(got, want)):
        assert a.dtype == b.dtype
        _close(a, b, BF16_RTOL, BF16_AMAX)
    assert gru_cell.launches == dict(n, gru_fwd_bf16=n["gru_fwd_bf16"] + 1,
                                     gru_bwd_bf16=n["gru_bwd_bf16"] + 1)


@pytest.mark.cuda
def test_cuda_gru_cluster_two_runs_agree_to_the_bit(cuda):
    assert gru_cell.cluster_plan(64, 512)["take"]
    xg, w, h0, mask, dhs = _bf16(_gru_inputs(64, 30, 512, 8, cuda), 2)
    dhs = dhs.to(torch.bfloat16)
    runs = []
    for _ in range(2):
        hs, stash = gru_cell.gru_forward(xg, w, h0, mask)
        runs.append((hs, stash) + gru_cell.gru_backward(stash, hs, w, h0,
                                                        mask, dhs))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_gru_cluster_autograd_goes_through_both_kernels(cuda):
    """gru_sequence on bf16 inputs at a shape the plan takes: one launch
    of each cluster kernel (under the bf16 kernels' counters), hs and the
    gradients of every input against the CPU's plain route."""
    assert gru_cell.cluster_plan(21, 96)["take"]
    xg, w, h0, mask, dhs = _gru_inputs(21, 11, 96, 9, cuda)
    leaves = [t.clone().to(torch.bfloat16).requires_grad_()
              for t in (xg, w, h0)]
    dhs = dhs.to(torch.bfloat16)
    gru_cell.reset_launches()
    hs = gru_cell.gru_sequence(leaves[0], leaves[1], leaves[2], mask)
    got = torch.autograd.grad(hs, leaves, dhs)
    assert gru_cell.launches == {"gru_fwd": 0, "gru_bwd": 0,
                                 "gru_fwd_bf16": 1, "gru_bwd_bf16": 1}
    cpu = [t.detach().cpu().requires_grad_() for t in leaves]
    rhs = gru_cell.gru_sequence(cpu[0], cpu[1], cpu[2], mask.cpu())
    want = torch.autograd.grad(rhs, cpu, dhs.cpu())
    for a, b in zip((hs,) + got, (rhs,) + want):
        _close(a.detach().cpu(), b.detach(), BF16_RTOL, BF16_AMAX)


@pytest.mark.cuda
def test_cuda_rnn_bf16_raises_on_what_the_kernels_do_not_take(cuda):
    """bf16 xg with a float32 w, or a bf16 h0 at the kernel's entry,
    raise: no launch, no plain version."""
    xg, w, h0, c0, mask, p, _, _ = _lstm_inputs(4, 3, 8, True, 4, cuda)
    with pytest.raises(ValueError, match="w must be torch.bfloat16"):
        lstm_cell.lstm_forward(xg.to(torch.bfloat16), w, h0, c0, mask, p)
    with pytest.raises(ValueError, match="h0 must be torch.float32"):
        lstm_cell.lstm_forward(xg.to(torch.bfloat16), w.to(torch.bfloat16),
                               h0.to(torch.bfloat16), c0, mask, p)
    xg, w, h0, mask, _ = _gru_inputs(4, 3, 8, 4, cuda)
    with pytest.raises(ValueError, match="no kernel for torch.float16"):
        gru_cell.gru_forward(xg.half(), w.half(), h0, mask)



# The stem of ResNet-50 at batch 64, its stage 4, a row count that no
# power of two divides, and a channel count that fills no float4.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(64, 112, 112, 64), (64, 7, 7, 2048),
                                   (5, 7, 9, 24), (3, 5, 7, 6)])
def test_cuda_bn_grad_matches_plain(cuda, shape, dtype):
    """Kernel vs the plain version on the card, and both vs the plain
    version in float64. The sums run over up to 802816 rows in another
    order than torch's, and sum(dy x) - mean sum(dy) cancels, so dscale
    and dbias are held to rtol 1e-4 plus 1e-5 of their largest
    magnitude; dx to rtol 1e-4 plus 1e-5 of its largest magnitude in
    float32, and to one bfloat16 rounding (rtol 1e-2) in bfloat16."""
    g = torch.Generator().manual_seed(5)
    x = (torch.randn(*shape, generator=g) * 1.5 + 0.7).to(dtype).to(cuda)
    dy = torch.randn(*shape, generator=g).to(dtype).to(cuda)
    scale = (torch.rand(shape[-1], generator=g) + 0.5).to(cuda)
    n0 = kbn.launches["bn_grad"]
    got = kbn.bn_grad(x, dy, scale, 1e-5)
    assert kbn.launches["bn_grad"] == n0 + 1
    plain = kbn.bn_grad_reference(x, dy, scale, 1e-5)
    truth = kbn.bn_grad_reference(x.double(), dy.double(), scale.double(),
                                  1e-5)
    torch.cuda.synchronize()
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    dx_rtol = 1e-4 if dtype == torch.float32 else 1e-2
    for ref in (plain, truth):
        _close(got[0], ref[0], dx_rtol, 1e-5 if dtype == torch.float32
               else 4e-3)
        _close(got[1], ref[1], 1e-4, 1e-5)
        _close(got[2], ref[2], 1e-4, 1e-5)
    # no float atomics: a second run gives the same bits
    again = kbn.bn_grad(x, dy, scale, 1e-5)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_bn_grad_tile_is_checked_and_ignored(cuda):
    g = torch.Generator().manual_seed(6)
    x = torch.randn(2, 3, 5, 8, generator=g).to(cuda)
    dy = torch.randn(2, 3, 5, 8, generator=g).to(cuda)
    scale = torch.ones(8, device=cuda)
    want = kbn.bn_grad(x, dy, scale, 1e-5)
    got = kbn.bn_grad(x, dy, scale, 1e-5, tile=6)
    with pytest.warns(RuntimeWarning, match="tile override"):
        bad = kbn.bn_grad(x, dy, scale, 1e-5, tile=7)
    torch.cuda.synchronize()
    for a, b, c in zip(want, got, bad):
        assert torch.equal(a, b) and torch.equal(a, c)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kbn.bn_grad(x.double(), dy.double(), scale, 1e-5)
    with pytest.raises(ValueError, match="dy must match"):
        kbn.bn_grad(x, dy[:1], scale, 1e-5)


# (B, Ci, H, W, Co): the path's largest and smallest maps, a shape the
# JAX package's kernel refuses for its size (Ci 256 -> Co 64 at 56x56),
# one where no dimension fills a tile (HW = 35: 4-byte copies, two dw
# chunks), stage 4's other 1x1 (HW = 49), 64 -> 64 (one dw tile, many
# chunks) and a stage-2 shape (128 x 128 tiles in both roles).
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(64, 64, 56, 56, 256),
                                   (64, 2048, 7, 7, 512),
                                   (64, 256, 56, 56, 64),
                                   (3, 24, 5, 7, 40),
                                   (64, 512, 7, 7, 2048),
                                   (8, 64, 56, 56, 64),
                                   (64, 128, 28, 28, 512)])
def test_cuda_conv1x1_bwd_matches_plain(cuda, shape, dtype):
    """Kernel vs the plain einsums on the card and vs float64. dw sums
    up to 200704 products in another order than the library's: rtol
    1e-4 plus 2e-5 of the output's largest magnitude in float32; one
    bfloat16 rounding (rtol 1e-2, 4e-3 of the largest) in bfloat16."""
    b, ci, h, w, co = shape
    g = torch.Generator().manual_seed(7)
    x = torch.randn(b, ci, h, w, generator=g).to(dtype).to(cuda)
    wt = (torch.randn(co, ci, 1, 1, generator=g) * ci ** -0.5).to(dtype) \
        .to(cuda)
    dy = torch.randn(b, co, h, w, generator=g).to(dtype).to(cuda)
    n0 = k1.launches["conv1x1_bwd"]
    dx, dw = k1.conv1x1_bwd(x, wt, dy)
    assert k1.launches["conv1x1_bwd"] == n0 + 1
    plain = k1.conv1x1_bwd_reference(x, wt, dy)
    truth = k1.conv1x1_bwd_reference(x.double(), wt.double(), dy.double())
    torch.cuda.synchronize()
    assert dx.dtype == dtype and dw.dtype == dtype
    assert dx.shape == x.shape and dw.shape == wt.shape
    rtol, amax = (1e-4, 2e-5) if dtype == torch.float32 else (1e-2, 4e-3)
    for ref in (plain, truth):
        _close(dx, ref[0], rtol, amax)
        _close(dw, ref[1], rtol, amax)
    dx2, dw2 = k1.conv1x1_bwd(x, wt, dy)
    torch.cuda.synchronize()
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)


@pytest.mark.cuda
def test_cuda_conv1x1_autograd_goes_through_the_kernel(cuda):
    g = torch.Generator().manual_seed(8)
    x = torch.randn(4, 32, 9, 9, generator=g).to(cuda).requires_grad_()
    w = torch.randn(48, 32, 1, 1, generator=g).to(cuda).requires_grad_()
    dy = torch.randn(4, 48, 9, 9, generator=g).to(cuda)
    k1.reset_launches()
    got = torch.autograd.grad(k1.conv1x1(x, w), (x, w), dy)
    assert k1.launches == {"conv1x1_bwd": 1}
    want = torch.autograd.grad(torch.nn.functional.conv2d(x, w), (x, w), dy)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        k1.conv1x1_bwd(x.double(), w.double(), dy.double())
    with pytest.raises(ValueError, match="dy must be"):
        k1.conv1x1_bwd(x.detach(), w.detach(), dy[:, :3])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_conv1x1_bwd_unaligned_views_take_the_4_byte_copies(cuda,
                                                                 dtype):
    """x, w and dy that start one element into their storage: HW = 64
    would allow 16-byte copies, the addresses do not, and the plan says
    so."""
    b, ci, h, w, co = 4, 64, 8, 8, 128
    g = torch.Generator().manual_seed(9)

    def offset(shape, scale=1.0):
        n = 1
        for s in shape:
            n *= s
        flat = (torch.randn(n + 1, generator=g) * scale).to(dtype).to(cuda)
        return flat[1:].view(*shape)

    x, dy = offset((b, ci, h, w)), offset((b, co, h, w))
    wt = offset((co, ci, 1, 1), ci ** -0.5)
    assert x.data_ptr() % 16 != 0
    assert not k1.plan(b, ci, co, h * w, x.element_size(), False).vec
    dx, dw = k1.conv1x1_bwd(x, wt, dy)
    truth = k1.conv1x1_bwd_reference(x.double(), wt.double(), dy.double())
    torch.cuda.synchronize()
    rtol, amax = (1e-4, 2e-5) if dtype == torch.float32 else (1e-2, 4e-3)
    _close(dx, truth[0], rtol, amax)
    _close(dw, truth[1], rtol, amax)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,loader", [((4, 64, 16, 16, 128), "tma"),
                                          ((2, 128, 28, 28, 64), "tma"),
                                          ((2, 40, 7, 7, 72), "bulk"),
                                          ((3, 24, 5, 7, 40), "bulk"),
                                          ((2, 72, 10, 10, 48), "cp.async"),
                                          ((2, 24, 9, 9, 40), "registers")])
def test_cuda_conv1x1_bwd_bf16_through_each_loader(cuda, shape, loader):
    """The bfloat16 kernel (wgmma) through each loader its plan chooses by
    shape, held against the plain version and float64 at one bfloat16
    rounding, and twice to the same bits."""
    b, ci, h, w, co = shape
    assert k1.plan(b, ci, co, h * w, 2).loader == loader
    g = torch.Generator().manual_seed(ci + co + h)
    x = torch.randn(b, ci, h, w, generator=g).bfloat16().to(cuda)
    wt = (torch.randn(co, ci, 1, 1, generator=g) * ci ** -0.5).bfloat16() \
        .to(cuda)
    dy = torch.randn(b, co, h, w, generator=g).bfloat16().to(cuda)
    n0 = k1.launches["conv1x1_bwd"]
    dx, dw = k1.conv1x1_bwd(x, wt, dy)
    assert k1.launches["conv1x1_bwd"] == n0 + 1
    dx2, dw2 = k1.conv1x1_bwd(x, wt, dy)
    plain = k1.conv1x1_bwd_reference(x, wt, dy)
    truth = k1.conv1x1_bwd_reference(x.double(), wt.double(), dy.double())
    torch.cuda.synchronize()
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
    for ref in (plain, truth):
        _close(dx, ref[0], 1e-2, 4e-3)
        _close(dw, ref[1], 1e-2, 4e-3)


@pytest.mark.cuda
def test_cuda_conv1x1_bwd_bf16_refuses_a_loader_the_rows_do_not_allow(cuda):
    """TMA asked for at 7x7 (98-byte rows): the C entry returns an error
    and launches nothing."""
    from paddle_tpu_torch.kernels import _build

    b, ci, hw, co = 2, 64, 49, 64
    x = torch.randn(b, ci, hw, device=cuda).bfloat16()
    wt = torch.randn(co, ci, device=cuda).bfloat16()
    dy = torch.randn(b, co, hw, device=cuda).bfloat16()
    dx, dw = torch.empty_like(x), torch.empty_like(wt)
    lib = _build.load("conv1x1_bwd")
    rc = lib.conv1x1_bwd_bf16(x.data_ptr(), wt.data_ptr(), dy.data_ptr(),
                              dx.data_ptr(), dw.data_ptr(), None, None, b,
                              ci, co, hw, 1, 128, 1, 1, 64, 64,
                              k1.LOADERS["tma"],
                              torch.cuda.current_stream().cuda_stream)
    assert rc != 0


# ---- the fused conv epilogue (conv2d_bn_act) on the card ----

def _fused_block_net(spatial=16, pointwise=False):
    """A conv + bn + residual add + relu block and a conv + bn + relu
    block, global pool, fc: both conv epilogues fuse."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import layers

    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        img = layers.data("img", [16, spatial, spatial])
        label = layers.data("label", [1], dtype="int64")
        k, pad = (1, 0) if pointwise else (3, 1)
        c = layers.conv2d(img, 16, k, padding=pad, bias_attr=False)
        x = layers.elementwise_add(img, layers.batch_norm(c), act="relu")
        c = layers.conv2d(x, 32, k, padding=pad, bias_attr=False)
        x = layers.batch_norm(c, act="relu")
        pool = layers.pool2d(x, pool_type="avg", global_pooling=True)
        fc = layers.fc(pool, size=10, act="softmax")
        loss = layers.mean(layers.cross_entropy(fc, label))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return prog, startup, loss


def _fused_run(cuda, cfg, amp, pointwise=False, nhwc=False, flag=False):
    """One step of the block net from seeded weights on the card:
    (loss, {param: grad}, bn_grad launches, conv1x1_bwd launches)."""
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import flags, unique_name

    with unique_name.guard():
        prog, startup, loss = _fused_block_net(pointwise=pointwise)
    if cfg is not None:
        fluid.passes.enable(prog, **cfg)
    if amp:
        fluid.amp.enable(prog)
    startup.random_seed = 3
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    x = rng.randn(8, 16, 16, 16).astype(np.float32)
    if nhwc:
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    feed = {"img": x, "label": rng.randint(0, 10, (8, 1)).astype(np.int64)}
    params = sorted(p.name for p in prog.global_block().all_parameters())
    kbn.reset_launches()
    k1.reset_launches()
    flags.set_flags({"FLAGS_fused_conv1x1_bwd": flag})
    try:
        out = exe.run(prog, feed=feed, fetch_list=[loss.name]
                      + [p + "@GRAD" for p in params], scope=scope)
    finally:
        flags.set_flags({"FLAGS_fused_conv1x1_bwd": False})
    torch.cuda.synchronize()
    return (float(out[0]), dict(zip(params, out[1:])),
            kbn.launches["bn_grad"], k1.launches["conv1x1_bwd"])


def _hold(got, want, each, together):
    import numpy as np

    num = den = 0.0
    for n, w in want.items():
        g = got[n].astype(np.float64)
        w = w.astype(np.float64)
        assert got[n].dtype == np.float32, n
        assert np.linalg.norm(g - w) <= each * np.linalg.norm(w), n
        num += float(((g - w) ** 2).sum())
        den += float((w ** 2).sum())
    assert (num / den) ** 0.5 <= together


@pytest.mark.cuda
@pytest.mark.parametrize("amp", [False, True])
def test_cuda_fused_nhwc_step_launches_b7_and_matches_unfused(cuda, amp):
    """NHWC + epilogue + reductions: each tagged conv2d_bn_act_grad
    launches the batch-norm backward kernel (bf16 under AMP) once a
    step. Fused against unfused from the same weights: cuDNN may choose
    other algorithms for the two programs, so not bitwise; in float32
    the A-vs-B bounds (loss rtol 1e-4, each gradient within 2e-2 of its
    L2 norm, all together 2e-3), under AMP the bf16 ones (loss rtol
    1e-2, each 0.5, all together 0.2; PERF.md section 2)."""
    base = dict(layout="NHWC", pallas_reductions=True)
    ref = _fused_run(cuda, base, amp, nhwc=True)
    got = _fused_run(cuda, dict(base, epilogue_fusion=True), amp, nhwc=True)
    assert ref[2] == got[2] == 2 and ref[3] == got[3] == 0
    loss_rtol, each, together = (1e-2, 0.5, 0.2) if amp else (1e-4, 2e-2,
                                                              2e-3)
    assert abs(got[0] - ref[0]) <= loss_rtol * abs(ref[0])
    _hold(got[1], ref[1], each, together)


@pytest.mark.cuda
@pytest.mark.parametrize("amp", [False, True])
def test_cuda_fused_1x1_step_launches_b8_inside_the_fused_grad(cuda, amp):
    """NCHW + epilogue with FLAGS_fused_conv1x1_bwd: both 1x1 convs sit
    inside conv2d_bn_act and launch the fused 1x1 backward (bf16 x, w
    and dy under AMP; the filter's gradient float32, its master's
    dtype) once a step each; against the unfused program with the flag
    on, at the bounds of the test above."""
    cfg = dict(epilogue_fusion=True)
    ref = _fused_run(cuda, None, amp, pointwise=True, flag=True)
    got = _fused_run(cuda, cfg, amp, pointwise=True, flag=True)
    assert ref[3] == got[3] == 2 and ref[2] == got[2] == 0
    loss_rtol, each, together = (1e-2, 0.5, 0.2) if amp else (1e-4, 2e-2,
                                                              2e-3)
    assert abs(got[0] - ref[0]) <= loss_rtol * abs(ref[0])
    _hold(got[1], ref[1], each, together)


@pytest.mark.cuda
def test_cuda_bn_grad_takes_a_permuted_nhwc_view(cuda):
    """The NHWC conv output the port hands over may be a permute of an
    NCHW result: the wrapper makes it contiguous and launches (no quiet
    plain path on the card)."""
    g = torch.Generator().manual_seed(10)
    x = torch.randn(8, 24, 9, 7, generator=g).to(torch.bfloat16).to(cuda)
    dy = torch.randn(8, 24, 9, 7, generator=g).to(torch.bfloat16).to(cuda)
    scale = (torch.rand(24, generator=g) + 0.5).to(cuda)
    xv, dyv = x.permute(0, 2, 3, 1), dy.permute(0, 2, 3, 1)
    assert not xv.is_contiguous()
    n0 = kbn.launches["bn_grad"]
    got = kbn.bn_grad(xv, dyv, scale, 1e-5)
    assert kbn.launches["bn_grad"] == n0 + 1
    want = kbn.bn_grad_reference(xv.contiguous(), dyv.contiguous(), scale,
                                 1e-5)
    torch.cuda.synchronize()
    _close(got[0], want[0], 1e-2, 4e-3)
    _close(got[1], want[1], 1e-4, 1e-5)
