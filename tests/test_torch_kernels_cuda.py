"""The CUDA kernels on the card, held against their plain PyTorch
versions (tolerance 1e-5 absolute and relative: the same fp32 math in
another summation order; the LSTM's and the GRU's backward 1e-5
absolute and 1e-4 relative, their recurrences reorder sums over up to
80 steps). The batch-norm backward and the fused 1x1-conv backward are
also held against float64 plain versions, with the tolerances stated at
their tests.

Marked ``cuda``: each test skips inside itself where torch finds no
card. This file imports torch and the port only (the machine with the
card has no jax), so run it there without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.kernels import bn_grad as kbn
from paddle_tpu_torch.kernels import conv1x1_bwd as k1
from paddle_tpu_torch.kernels import gru_cell, lstm_cell


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
                                   (70, 6, 40)])
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
    assert lstm_cell.launches == {"lstm_fwd": n["lstm_fwd"] + 1,
                                  "lstm_bwd": n["lstm_bwd"] + 1}


@pytest.mark.cuda
def test_cuda_lstm_autograd_goes_through_both_kernels(cuda):
    xg, w, h0, c0, mask, p, dhs, dcs = _lstm_inputs(16, 9, 64, True, 3, cuda)
    leaves = [t.clone().requires_grad_() for t in (xg, w, h0, c0, p)]
    lstm_cell.reset_launches()
    hs, cs = lstm_cell.lstm_sequence(leaves[0], leaves[1], leaves[2],
                                     leaves[3], mask, leaves[4])
    got = torch.autograd.grad((hs, cs), leaves, (dhs, dcs))
    assert lstm_cell.launches == {"lstm_fwd": 1, "lstm_bwd": 1}
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
                                   (70, 6, 40)])
def test_cuda_gru_matches_plain(cuda, shape):
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
    assert gru_cell.launches == {"gru_fwd": n["gru_fwd"] + 1,
                                 "gru_bwd": n["gru_bwd"] + 1}


@pytest.mark.cuda
def test_cuda_gru_autograd_goes_through_both_kernels(cuda):
    xg, w, h0, mask, dhs = _gru_inputs(16, 9, 64, 3, cuda)
    leaves = [t.clone().requires_grad_() for t in (xg, w, h0)]
    gru_cell.reset_launches()
    hs = gru_cell.gru_sequence(leaves[0], leaves[1], leaves[2], mask)
    got = torch.autograd.grad(hs, leaves, dhs)
    assert gru_cell.launches == {"gru_fwd": 1, "gru_bwd": 1}
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
    # past one resident block of 4 units per SM the cooperative grid
    # cannot launch: the wrapper raises, never runs the plain version
    big = 4 * torch.cuda.get_device_properties(cuda).multi_processor_count + 4
    xg, w, h0, mask, _ = _gru_inputs(2, 2, big, 5, cuda)
    with pytest.raises(RuntimeError, match="gru_fwd launch failed"):
        gru_cell.gru_forward(xg, w, h0, mask)


def _close(got, want, rtol, atol_of_max):
    """|got - want| <= atol_of_max * max|want| + rtol * |want|."""
    want = want.to(torch.float64)
    atol = atol_of_max * float(want.abs().max())
    torch.testing.assert_close(got.to(torch.float64), want, rtol=rtol,
                               atol=atol)


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
