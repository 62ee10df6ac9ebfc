"""Flash attention: the forward and single-query decode kernels.

The kernels are hand-written CUDA for Hopper (``csrc/flash_attention.cu``)
and replace the JAX package's two Pallas kernels in
``paddle_tpu/kernels/flash_attention.py``: ``flash_attention`` replaces
``_fwd_kernel`` and ``flash_decode`` replaces ``_decode_kernel``.

Layout is the JAX package's: q, k, v are ``[batch, heads, seq,
head_dim]``; KV caches are ``[batch, heads, max_len, head_dim]``.

Each wrapper dispatches on the device of the tensors it is given:

* a CUDA tensor launches the kernel on the current stream, after
  checking device, dtype, shape and contiguity (it raises on anything
  the kernel does not take, and when the launch is refused);
* a CPU tensor runs the plain PyTorch version beside it, which follows
  the kernel's blocking (online softmax over key tiles, the forward's
  key tiles split between its warps and merged in order, tiles past the
  causal diagonal or past ``cache_len`` skipped, the ``l == 0`` guard),
  so the CPU tests exercise that logic;
* a meta tensor returns outputs of the right shape (construction-time
  shape inference).

``launches`` counts kernel launches per kernel; plain-version calls do
not count.
"""

import ctypes

import torch

__all__ = ["flash_attention", "flash_decode", "flash_attention_reference",
           "flash_decode_reference", "launches", "reset_launches",
           "DEFAULT_MASK_VALUE", "BLOCK_Q", "BLOCK_K", "KEY_SPLIT"]

#: the TPU kernels' mask value for masked (not excluded) scores
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

#: the CUDA kernels' tiles, which the plain versions follow: the forward
#: takes BLOCK_Q query rows a block and BLOCK_K keys a tile, and its
#: KEY_SPLIT warps take the key tiles in turn (warp w: tiles w, w +
#: KEY_SPLIT, ...) and merge in warp order; the decode kernel's plain
#: version walks DECODE_BLOCK_K keys a tile
BLOCK_Q = 16
BLOCK_K = 16
KEY_SPLIT = 4
DECODE_BLOCK_K = 32

#: kernel name -> launches since the last reset_launches()
launches = {"flash_attention": 0, "flash_decode": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def flash_attention_reference(q, k, v, causal=False, sm_scale=None,
                              segment_ids=None, block_q=BLOCK_Q,
                              block_k=BLOCK_K, key_split=KEY_SPLIT):
    """Plain version of the forward kernel. Returns ``(out, lse)``:
    ``out`` [b, h, sq, d] and the per-row log-sum-exp [b, h, sq].

    It follows the kernel's blocking: for each tile of ``block_q`` query
    rows, ``key_split`` online softmaxes each walk every ``key_split``-th
    tile of ``block_k`` keys (tiles wholly above the causal diagonal are
    skipped), and their (m, l, acc) merge in order."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    scale = d ** -0.5 if sm_scale is None else float(sm_scale)
    q, k, v = q.float(), k.float(), v.float()
    dev = q.device
    inf = float("inf")
    out = torch.empty((b, h, sq, d), dtype=torch.float32, device=dev)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    for q0 in range(0, sq, block_q):
        qt = q[:, :, q0:q0 + block_q]
        nq = qt.shape[2]
        qi = torch.arange(q0, q0 + nq, device=dev)[:, None]
        k_end = min(sk, q0 + block_q) if causal else sk
        n_kt = -(-k_end // block_k)
        parts = []
        for w in range(key_split):
            m = torch.full((b, h, nq, 1), -inf, device=dev)
            l = torch.zeros((b, h, nq, 1), device=dev)
            acc = torch.zeros((b, h, nq, d), device=dev)
            for k0 in range(w * block_k, n_kt * block_k, key_split * block_k):
                kt, vt = k[:, :, k0:k0 + block_k], v[:, :, k0:k0 + block_k]
                nk = kt.shape[2]
                s = torch.einsum("bhqd,bhkd->bhqk", qt, kt) * scale
                ki = torch.arange(k0, k0 + nk, device=dev)[None, :]
                if causal:
                    s = torch.where(qi >= ki, s, DEFAULT_MASK_VALUE)
                if segment_ids is not None:
                    ok = (segment_ids[0][:, None, q0:q0 + nq, None]
                          == segment_ids[1][:, None, None, k0:k0 + nk])
                    s = torch.where(ok, s, DEFAULT_MASK_VALUE)
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new)
                l = alpha * l + p.sum(-1, keepdim=True)
                acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, vt)
                m = m_new
            parts.append((m, l, acc))
        m_all = parts[0][0]
        for m, _, _ in parts[1:]:
            m_all = torch.maximum(m_all, m)
        l_all = torch.zeros_like(m_all)
        o = torch.zeros((b, h, nq, d), device=dev)
        for m, l, acc in parts:
            # a warp that saw no key has m = -inf and adds nothing
            c = torch.where(m == -inf, 0.0, torch.exp(m - m_all))
            l_all = l_all + l * c
            o = o + acc * c
        l_safe = torch.where(l_all == 0.0, 1.0, l_all)
        out[:, :, q0:q0 + nq] = o / l_safe
        lse[:, :, q0:q0 + nq] = (m_all + torch.log(l_safe))[..., 0]
    return out, lse


def flash_decode_reference(q, k_cache, v_cache, cache_len, sm_scale=None,
                           block_k=DECODE_BLOCK_K):
    """Plain version of the decode kernel. ``q`` [b, h, 1, d] or
    [b, h, d]; returns the same rank."""
    squeeze = q.dim() == 3
    q3 = (q if squeeze else q[:, :, 0, :]).float()
    b, h, s, d = k_cache.shape
    scale = d ** -0.5 if sm_scale is None else float(sm_scale)
    lens = cache_len.to(torch.int64).clamp(0, s)
    m = torch.full((b, h), -float("inf"), device=q.device)
    l = torch.zeros((b, h), device=q.device)
    acc = torch.zeros((b, h, d), device=q.device)
    # tiles past every row's valid prefix are never read
    for k0 in range(0, int(lens.max()) if b else 0, block_k):
        kt = k_cache[:, :, k0:k0 + block_k].float()
        vt = v_cache[:, :, k0:k0 + block_k].float()
        sc = torch.einsum("bhd,bhkd->bhk", q3, kt) * scale
        ki = torch.arange(k0, k0 + kt.shape[2], device=q.device)
        sc = torch.where(ki[None, None, :] < lens[:, None, None], sc,
                         -float("inf"))
        m_new = torch.maximum(m, sc.amax(-1))
        # a row with no valid key yet keeps alpha = p = 0
        m_safe = torch.where(m_new == -float("inf"), 0.0, m_new)
        alpha = torch.exp(m - m_safe)
        p = torch.exp(sc - m_safe[..., None])
        l = alpha * l + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhk,bhkd->bhd", p, vt)
        m = m_new
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = acc / l_safe[..., None]
    return out if squeeze else out[:, :, None, :]


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(cond, msg, *args):
    if not cond:
        raise ValueError(msg % args)


def _check_float(name, t, device):
    _check(t.device == device, "%s is on %s, expected %s", name, t.device,
           device)
    _check(t.dtype == torch.float32, "%s must be float32, got %s", name,
           t.dtype)
    _check(t.is_contiguous(), "%s must be contiguous", name)


def _check_int(name, t, shape, device):
    _check(t.device == device, "%s is on %s, expected %s", name, t.device,
           device)
    _check(t.dtype == torch.int32, "%s must be int32, got %s", name,
           t.dtype)
    _check(tuple(t.shape) == tuple(shape), "%s must be %s, got %s", name,
           tuple(shape), tuple(t.shape))
    _check(t.is_contiguous(), "%s must be contiguous", name)


def _raise_on(rc, fn):
    if rc != 0:
        raise RuntimeError("%s launch failed: cudaError_t %d" % (fn, rc))


def flash_attention(q, k, v, causal=False, sm_scale=None, segment_ids=None,
                    return_lse=False):
    """Fused attention. q [b, h, sq, d]; k, v [b, h, sk, d].

    ``segment_ids``: optional (q_segments [b, sq], k_segments [b, sk])
    int32 pair; tokens attend only within their own segment. Returns
    ``out`` [b, h, sq, d], or ``(out, lse)`` with ``return_lse``."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes 4-D [b, h, s, d] tensors")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    _check(tuple(k.shape) == (b, h, sk, d) and tuple(v.shape) == tuple(
        k.shape), "k/v shapes %s/%s do not match q %s", tuple(k.shape),
        tuple(v.shape), tuple(q.shape))
    scale = d ** -0.5 if sm_scale is None else float(sm_scale)
    dev = q.device
    if dev.type == "meta":
        out = torch.empty((b, h, sq, d), dtype=q.dtype, device=dev)
        lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    elif dev.type == "cpu":
        out, lse = flash_attention_reference(q, k, v, causal, scale,
                                             segment_ids)
        out = out.to(q.dtype)
    elif dev.type == "cuda":
        out, lse = _flash_attention_cuda(q, k, v, causal, scale,
                                         segment_ids)
    else:
        raise ValueError("flash_attention: no kernel for device %s" % dev)
    return (out, lse) if return_lse else out


def _flash_attention_cuda(q, k, v, causal, scale, segment_ids):
    from paddle_tpu_torch.kernels import _build

    b, h, sq, d = q.shape
    sk = k.shape[2]
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_float(name, t, dev)
    _check(1 <= d <= 128, "head_dim %d outside the kernel's 1..128", d)
    q_seg = k_seg = None
    if segment_ids is not None:
        q_seg, k_seg = segment_ids
        _check_int("q_segments", q_seg, (b, sq), dev)
        _check_int("k_segments", k_seg, (b, sk), dev)
    lib = _build.load("flash_attention")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            q_seg.data_ptr() if q_seg is not None else None,
            k_seg.data_ptr() if k_seg is not None else None,
            out.data_ptr(), lse.data_ptr(), b, h, sq, sk, d,
            ctypes.c_float(scale), int(bool(causal)),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "flash_attention_fwd")
    launches["flash_attention"] += 1
    return out, lse


def flash_decode(q, k_cache, v_cache, cache_len, sm_scale=None):
    """Single-query decode attention against a length-masked KV cache.

    ``q`` [b, h, 1, d] (or [b, h, d]); caches [b, h, max_len, d];
    ``cache_len`` [b] int32: row b attends to cache positions
    < cache_len[b]. Returns the same rank as ``q``."""
    squeeze = q.dim() == 3
    if k_cache.dim() != 4 or tuple(v_cache.shape) != tuple(k_cache.shape):
        raise ValueError("flash_decode caches must be equal 4-D "
                         "[b, h, max_len, d] tensors")
    b, h, s, d = k_cache.shape
    qshape = (b, h, d) if squeeze else (b, h, 1, d)
    _check(tuple(q.shape) == qshape, "q must be %s, got %s", qshape,
           tuple(q.shape))
    scale = d ** -0.5 if sm_scale is None else float(sm_scale)
    dev = q.device
    if dev.type == "meta":
        return torch.empty(qshape, dtype=q.dtype, device=dev)
    if dev.type == "cpu":
        return flash_decode_reference(q, k_cache, v_cache, cache_len,
                                      scale).to(q.dtype)
    if dev.type != "cuda":
        raise ValueError("flash_decode: no kernel for device %s" % dev)
    from paddle_tpu_torch.kernels import _build

    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        _check_float(name, t, dev)
    _check_int("cache_len", cache_len, (b,), dev)
    _check(1 <= d <= 128, "head_dim %d outside the kernel's 1..128", d)
    lib = _build.load("flash_attention")
    out = torch.empty(qshape, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.flash_decode(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            cache_len.data_ptr(), out.data_ptr(), b, h, s, d,
            ctypes.c_float(scale),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "flash_decode")
    launches["flash_decode"] += 1
    return out
