"""Whole-sequence LSTM: the forward (B3) and backward (B4) kernels.

The kernels are hand-written CUDA for Hopper (``csrc/lstm_cell.cu``) and
replace the JAX package's two Pallas kernels in
``paddle_tpu/kernels/lstm_cell.py``: the forward launch replaces
``_fwd_kernel`` and the backward launch replaces ``_bwd_kernel``.

Layout is the JAX package's public one, batch-major: ``xg`` [B, T, 4H]
pre-projected gate inputs (bias added), gate order (i, c~, f, o);
``w`` [H, 4H]; ``h0``, ``c0`` [B, H]; ``mask`` [B, T] (1.0 for a valid
step; a finished row carries h and c unchanged and gets no gate
gradient); ``peep`` [3, H] peephole weights (w_ic, w_fc, w_oc) or None.

:func:`lstm_sequence` is differentiable through a
``torch.autograd.Function`` and dispatches on the device of its inputs:

* a CUDA tensor launches the forward kernel, which also writes the
  stash of gate activations the backward kernel reads; the backward
  launches the backward kernel, and dW = sum_t h_{t-1}^T dgates_t is one
  GEMM outside it, as in the JAX package. float32 only; anything else
  raises, and a refused launch raises;
* a CPU tensor runs the plain versions beside the kernels: the step
  loop :func:`lstm_forward_reference` and :func:`lstm_backward_reference`,
  which writes the backward kernel's arithmetic out step by step (it is
  not autograd of the forward);
* a meta tensor returns outputs of the right shape.

``launches`` counts kernel launches per kernel; plain-version calls do
not count.
"""

import torch

__all__ = ["lstm_sequence", "lstm_sequence_reference",
           "lstm_forward_reference", "lstm_backward_reference",
           "launches", "reset_launches"]

#: kernel name -> launches since the last reset_launches()
launches = {"lstm_fwd": 0, "lstm_bwd": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def lstm_forward_reference(xg, w, h0, c0, mask, peep):
    """Plain version of the forward kernel: the step loop. ``peep`` is
    [3, H] (zeros for none). Returns ``(hs, cs, stash)``: [B, T, H],
    [B, T, H] and the gate activations [B, T, 4H] in gate order."""
    b, t_len, g4 = xg.shape
    h = g4 // 4
    h_prev, c_prev = h0, c0
    hs, cs, stash = [], [], []
    for t in range(t_len):
        g = xg[:, t] + h_prev @ w
        gi, gc, gf, go = g[:, :h], g[:, h:2 * h], g[:, 2 * h:3 * h], g[:, 3 * h:]
        gi = gi + c_prev * peep[0]
        gf = gf + c_prev * peep[1]
        i_t, f_t, g_t = torch.sigmoid(gi), torch.sigmoid(gf), torch.tanh(gc)
        c_t = f_t * c_prev + i_t * g_t
        o_t = torch.sigmoid(go + c_t * peep[2])
        h_t = o_t * torch.tanh(c_t)
        m = mask[:, t, None].to(xg.dtype)
        h_t = m * h_t + (1 - m) * h_prev
        c_t = m * c_t + (1 - m) * c_prev
        hs.append(h_t)
        cs.append(c_t)
        stash.append(torch.cat([i_t, g_t, f_t, o_t], dim=-1))
        h_prev, c_prev = h_t, c_t
    if not t_len:
        z = xg.new_zeros((b, 0, h))
        return z, z.clone(), xg.new_zeros((b, 0, g4))
    return (torch.stack(hs, 1), torch.stack(cs, 1), torch.stack(stash, 1))


def lstm_sequence_reference(xg, w, h0, c0, mask, peep=None):
    """Plain forward: ``(hs, cs)`` [B, T, H] each."""
    if peep is None:
        peep = xg.new_zeros((3, w.shape[0]))
    hs, cs, _ = lstm_forward_reference(xg, w, h0, c0, mask, peep)
    return hs, cs


def lstm_backward_reference(stash, cs, w, peep, c0, mask, dhs, dcs):
    """Plain version of the backward kernel, step by step from t = T-1
    down: the gate gradients from the stash, c_t, c_{t-1} and the dh/dc
    carries, then dh_{t-1} = dgates_t W^T + (1 - m) dh. Returns
    ``(dxg [B, T, 4H], dh0 [B, H], dc0 [B, H], dpeep [3, H])``."""
    b, t_len, g4 = stash.shape
    h = g4 // 4
    dh_c = stash.new_zeros((b, h))
    dc_c = stash.new_zeros((b, h))
    dp = stash.new_zeros((3, h))
    dxg = stash.new_zeros((b, t_len, g4))
    for t in range(t_len - 1, -1, -1):
        st = stash[:, t]
        i_t, g_t = st[:, :h], st[:, h:2 * h]
        f_t, o_t = st[:, 2 * h:3 * h], st[:, 3 * h:]
        c_t = cs[:, t]
        c_prev = cs[:, t - 1] if t else c0
        m = mask[:, t, None].to(stash.dtype)
        dh = dhs[:, t] + dh_c
        dc_in = dcs[:, t] + dc_c
        tanh_c = torch.tanh(c_t)
        dgo = dh * tanh_c * o_t * (1 - o_t)
        dct = dh * o_t * (1 - tanh_c * tanh_c) + dc_in + dgo * peep[2]
        dgi = dct * g_t * i_t * (1 - i_t)
        dgc = dct * i_t * (1 - g_t * g_t)
        dgf = dct * c_prev * f_t * (1 - f_t)
        dc_prev = dct * f_t + dgi * peep[0] + dgf * peep[1]
        dgi, dgc, dgf, dgo = m * dgi, m * dgc, m * dgf, m * dgo
        dgates = torch.cat([dgi, dgc, dgf, dgo], dim=-1)
        dxg[:, t] = dgates
        dh_c = dgates @ w.t() + (1 - m) * dh
        dc_c = m * dc_prev + (1 - m) * dc_in
        dp[0] += (dgi * c_prev).sum(0)
        dp[1] += (dgf * c_prev).sum(0)
        dp[2] += (dgo * c_t).sum(0)
    return dxg, dh_c, dc_c, dp


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(cond, msg, *args):
    if not cond:
        raise ValueError(msg % args)


def _check_float(name, t, shape, device):
    _check(t.device == device, "%s is on %s, expected %s", name, t.device,
           device)
    _check(t.dtype == torch.float32, "%s must be float32, got %s", name,
           t.dtype)
    _check(tuple(t.shape) == tuple(shape), "%s must be %s, got %s", name,
           tuple(shape), tuple(t.shape))
    _check(t.is_contiguous(), "%s must be contiguous", name)


def _raise_on(rc, fn):
    if rc != 0:
        raise RuntimeError("%s launch failed: cudaError_t %d" % (fn, rc))


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _fwd_cuda(xg, w, h0, c0, mask, peep):
    from paddle_tpu_torch.kernels import _build

    b, t_len, g4 = xg.shape
    h = g4 // 4
    dev = xg.device
    for name, t, shape in (("xg", xg, (b, t_len, g4)), ("w", w, (h, g4)),
                           ("h0", h0, (b, h)), ("c0", c0, (b, h)),
                           ("mask", mask, (b, t_len)),
                           ("peep", peep, (3, h))):
        _check_float(name, t, shape, dev)
    lib = _build.load("lstm_cell")
    hs = torch.empty((b, t_len, h), dtype=torch.float32, device=dev)
    cs = torch.empty_like(hs)
    stash = torch.empty_like(xg)
    # h_t, unit-major, batch rounded up to the kernel's 64-row tiles;
    # the padding rows stay zero
    bp = -(-b // 64) * 64
    hbuf = torch.zeros((2, h, bp), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.lstm_fwd(xg.data_ptr(), w.data_ptr(), peep.data_ptr(),
                          h0.data_ptr(), c0.data_ptr(), mask.data_ptr(),
                          hs.data_ptr(), cs.data_ptr(), stash.data_ptr(),
                          hbuf.data_ptr(), b, t_len, h, _stream(dev))
    _raise_on(rc, "lstm_fwd")
    launches["lstm_fwd"] += 1
    return hs, cs, stash


def _bwd_cuda(stash, cs, w, peep, c0, mask, dhs, dcs):
    from paddle_tpu_torch.kernels import _build

    b, t_len, g4 = stash.shape
    h = g4 // 4
    dev = stash.device
    for name, t, shape in (("stash", stash, (b, t_len, g4)),
                           ("cs", cs, (b, t_len, h)), ("w", w, (h, g4)),
                           ("peep", peep, (3, h)), ("c0", c0, (b, h)),
                           ("mask", mask, (b, t_len)),
                           ("dhs", dhs, (b, t_len, h)),
                           ("dcs", dcs, (b, t_len, h))):
        _check_float(name, t, shape, dev)
    lib = _build.load("lstm_cell")
    dxg = torch.empty_like(stash)
    # zero-filled: a sequence of no steps leaves them untouched
    dh0 = torch.zeros((b, h), dtype=torch.float32, device=dev)
    dc0 = torch.zeros_like(dh0)
    dpeep = torch.zeros((3, h), dtype=torch.float32, device=dev)
    scratch = torch.empty((3, b, h), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.lstm_bwd(stash.data_ptr(), cs.data_ptr(), w.data_ptr(),
                          peep.data_ptr(), c0.data_ptr(), mask.data_ptr(),
                          dhs.data_ptr(), dcs.data_ptr(), dxg.data_ptr(),
                          dh0.data_ptr(), dc0.data_ptr(), dpeep.data_ptr(),
                          scratch.data_ptr(), b, t_len, h, _stream(dev))
    _raise_on(rc, "lstm_bwd")
    launches["lstm_bwd"] += 1
    return dxg, dh0, dc0, dpeep


def lstm_forward(xg, w, h0, c0, mask, peep):
    """One forward: the kernel on a CUDA tensor, the step loop on a CPU
    one. Returns ``(hs, cs, stash)``."""
    dev = xg.device
    if dev.type == "cuda":
        return _fwd_cuda(xg, w, h0, c0, mask, peep)
    if dev.type == "cpu":
        return lstm_forward_reference(xg, w, h0, c0, mask, peep)
    raise ValueError("lstm_sequence: no kernel for device %s" % dev)


def lstm_backward(stash, cs, w, peep, c0, mask, dhs, dcs):
    """One backward: the kernel on a CUDA tensor, the plain version on a
    CPU one. Returns ``(dxg, dh0, dc0, dpeep)``."""
    if stash.device.type == "cuda":
        return _bwd_cuda(stash, cs, w, peep, c0, mask, dhs, dcs)
    return lstm_backward_reference(stash, cs, w, peep, c0, mask, dhs, dcs)


class _LSTMSequence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xg, w, h0, c0, mask, peep):
        hs, cs, stash = lstm_forward(xg, w, h0, c0, mask, peep)
        ctx.save_for_backward(stash, cs, hs, w, peep, h0, c0, mask)
        return hs, cs

    @staticmethod
    def backward(ctx, dhs, dcs):
        stash, cs, hs, w, peep, h0, c0, mask = ctx.saved_tensors
        dxg, dh0, dc0, dpeep = lstm_backward(
            stash, cs, w, peep, c0, mask, dhs.contiguous(),
            dcs.contiguous())
        # dW = sum_t h_{t-1}^T dgates_t: one GEMM outside the kernel
        h_prev = torch.cat([h0[:, None].to(hs.dtype), hs[:, :-1]], dim=1)
        dw = torch.einsum("bth,btg->hg", h_prev, dxg)
        return dxg, dw, dh0, dc0, None, dpeep


def lstm_sequence(xg, w, h0, c0, mask, peep=None):
    """Fused LSTM over a full sequence, batch-major.

    xg [B, T, 4H] pre-projected gate inputs (bias added); w [H, 4H];
    h0, c0 [B, H]; mask [B, T]; peep [3, H] or None. Returns
    ``(hs, cs)``, [B, T, H] each. Differentiable in xg, w, h0, c0 and
    peep."""
    _check(xg.dim() == 3 and xg.shape[-1] % 4 == 0,
           "xg must be [B, T, 4H], got %s", tuple(xg.shape))
    b, t_len, g4 = xg.shape
    h = g4 // 4
    _check(tuple(w.shape) == (h, g4), "w must be %s, got %s", (h, g4),
           tuple(w.shape))
    if xg.device.type == "meta":
        out = torch.empty((b, t_len, h), dtype=xg.dtype, device=xg.device)
        return out, torch.empty_like(out)
    if peep is None:
        peep = torch.zeros((3, h), dtype=xg.dtype, device=xg.device)
    return _LSTMSequence.apply(xg.contiguous(), w.contiguous(),
                               h0.contiguous(), c0.contiguous(),
                               mask.contiguous(), peep.contiguous())
