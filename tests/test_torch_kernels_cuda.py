"""The CUDA kernels on the card, held against their plain PyTorch
versions (tolerance 1e-5 absolute and relative: the same fp32 math in
another summation order; the LSTM's and the GRU's backward 1e-5
absolute and 1e-4 relative, their recurrences reorder sums over up to
80 steps).

Marked ``cuda``: each test skips inside itself where torch finds no
card. This file imports torch and the port only (the machine with the
card has no jax), so run it there without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as tfa
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
