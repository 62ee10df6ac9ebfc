"""Flash attention: the forward and single-query decode kernels.

The kernels are hand-written CUDA for Hopper (``csrc/flash_attention.cu``)
and replace the JAX package's two Pallas kernels in
``paddle_tpu/kernels/flash_attention.py``: ``flash_attention`` replaces
``_fwd_kernel`` (a float32 kernel on 3xTF32 tensor cores and a bfloat16
one, picked by the inputs' dtype) and ``flash_decode`` replaces
``_decode_kernel`` (a float32 query against a float32 or a bfloat16
cache, picked by the caches' dtype; the output is float32, the query's
dtype, as the JAX kernel's).

``flash_attention`` is differentiable: it returns through the autograd
Function :class:`FlashAttention`, whose backward is
:func:`flash_attention_bwd`, the JAX package's ``_bwd_blockwise`` (plain
array code outside any kernel there, plain PyTorch here, on every
device): it walks key blocks, recomputes the probabilities from the
saved log-sum-exp and sums dq, dk and dv in float32.

Layout is the JAX package's: q, k, v are ``[batch, heads, seq,
head_dim]``; KV caches are ``[batch, heads, max_len, head_dim]``.

Each wrapper dispatches on the device of the tensors it is given:

* a CUDA tensor launches the kernel on the current stream, after
  checking device, dtype, shape and contiguity (it raises on anything
  the kernel does not take, and when the launch is refused);
* a CPU tensor runs the plain PyTorch version beside it, which follows
  the kernel's blocking (online softmax over key tiles, the forward's
  key tiles split between its warps and merged in order, tiles past the
  causal diagonal skipped; the decode kernel's split of each row's valid
  prefix into :func:`decode_plan`'s chunks, each walked by its warps in
  key tiles and merged, the chunks merged in rank order; the ``l == 0``
  guard; over a bfloat16 cache ``p`` rounded to bfloat16 before the
  P V sum), so the CPU tests exercise that logic;
* a meta tensor returns outputs of the right shape (construction-time
  shape inference).

``launches`` counts kernel launches per kernel (the forward's and the
decode's float32 and bfloat16 kernels apart); plain-version calls do not
count.
"""

import ctypes

import torch

from paddle_tpu_torch.kernels import H100_SMS, count_launch

__all__ = ["flash_attention", "flash_decode", "flash_attention_reference",
           "flash_attention_bwd", "FlashAttention",
           "flash_decode_reference", "fwd_plan", "decode_plan",
           "decode_chunks",
           "launches", "reset_launches", "DEFAULT_MASK_VALUE", "BLOCK_Q",
           "BLOCK_K", "KEY_SPLIT", "BWD_BLOCK_K", "DECODE_BLOCK_K",
           "DECODE_WARPS"]

#: the TPU kernels' mask value for masked (not excluded) scores
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

#: the CUDA kernels' tiles, which the plain versions follow: the forward
#: takes BLOCK_Q query rows a block and BLOCK_K keys a tile, and its
#: KEY_SPLIT warps take the key tiles in turn (warp w: tiles w, w +
#: KEY_SPLIT, ...) and merge in warp order. The decode kernel splits each
#: row's valid prefix into the chunks of decode_plan, one a block of a
#: cluster; each block's DECODE_WARPS warps take its chunk's tiles of
#: DECODE_BLOCK_K keys in turn, merge in warp order, and the chunks merge
#: in rank order
BLOCK_Q = 16
BLOCK_K = 16
KEY_SPLIT = 4
DECODE_BLOCK_K = 8
DECODE_WARPS = 4
#: the backward's key block: the JAX op's ``block_k`` default
BWD_BLOCK_K = 128
#: the decode kernel's ring stages a warp
DECODE_STAGES = 2
#: the bfloat16 forward on wgmma fed by TMA (fwd_plan): query rows a
#: block (two warpgroups of WG_ROWS), keys a tile, ring stages, threads
WG_BLOCK_Q = 128
WG_ROWS = 64
WG_BLOCK_K = 64
WG_STAGES = 4
WG_THREADS = 2 * 128
#: the decode plan's rule: a row's cluster doubles while the grid holds
#: fewer than DECODE_FILL blocks an SM and a chunk of a full row keeps
#: DECODE_MIN_TILES tiles a warp, up to the portable cluster size
DECODE_FILL = 1.5
DECODE_MIN_TILES = 2
DECODE_MAX_CLUSTER = 8


def decode_plan(b, h, s, d, sms=H100_SMS, itemsize=4):
    """The decode kernel's launch plan, a copy of ``dec_plan`` in
    ``csrc/flash_attention.cu`` that the CPU tests can call (the card
    test ``test_cuda_decode_plan_matches_the_kernels`` holds the two to
    the same numbers): ``blocks_per_row`` n, the cluster of blocks that
    splits each (batch, head) row, by the DECODE_FILL / DECODE_MIN_TILES
    / DECODE_MAX_CLUSTER rule; also the threads of a block, a warp's
    ring stages, a block's shared bytes (for cache elements of
    ``itemsize`` bytes: 4 float32, 2 bfloat16) and the keys of a warp's
    tile (the kernel takes ``d`` of 1..128)."""
    n = 1
    while (n < DECODE_MAX_CLUSTER
           and DECODE_MIN_TILES * n * DECODE_WARPS * DECODE_BLOCK_K <= s
           and b * h * n < DECODE_FILL * sms):
        n *= 2
    dmax = 32 if d <= 32 else 64 if d <= 64 else 128
    slot = dmax + 4                      # a warp's (m, l, acc) to merge
    stage = 2 * DECODE_BLOCK_K * dmax    # a tile of K, then one of V
    smem = (4 * n * DECODE_WARPS * slot
            + itemsize * DECODE_WARPS * DECODE_STAGES * stage)
    return dict(blocks_per_row=n, blocks=n * b * h,
                threads=32 * DECODE_WARPS, stages=DECODE_STAGES,
                smem_bytes=smem, tile_keys=DECODE_BLOCK_K)


def fwd_plan(b, h, sq, sk, d, dtype=torch.bfloat16, aligned=True):
    """The forward kernel a call of ``flash_attention`` takes and its
    blocking, a pure function of the shapes (the card tests hold the
    kernels to it):

    * bfloat16 with ``d`` a multiple of 8 (rows on 16-byte boundaries),
      ``d`` <= 128, ``sk`` >= 1 and q, k, v ``aligned`` to 16 bytes:
      ``loader="tma"``, the wgmma kernel. A block of WG_BLOCK_Q query
      rows, two warpgroups of WG_ROWS each; WG_BLOCK_K keys a tile
      through a WG_STAGES-stage ring; shared memory in the
      ``swizzle`` of 128-byte rows (64-byte rows for ``d`` <= 32), head_dim
      padded to ``dmax`` (32, 64 or 128);
    * any other bfloat16 call, and every float32 one: ``loader=
      "mma_sync"``, the earlier blocking (BLOCK_Q rows, BLOCK_K keys a
      tile, KEY_SPLIT warps each walking every KEY_SPLIT-th tile, cp.async
      copies: ``vec`` 16-byte ones where rows start on 16-byte
      boundaries).

    ``walk_q``, ``block_k`` and ``key_split`` are the arguments that make
    :func:`flash_attention_reference` walk the keys as the kernel does."""
    dmax = 32 if d <= 32 else 64 if d <= 64 else 128
    bf16 = dtype == torch.bfloat16
    if bf16 and d % 8 == 0 and 1 <= d <= 128 and sk >= 1 and aligned:
        sw = 64 if dmax == 32 else 128
        q_bytes = WG_BLOCK_Q * 2 * dmax
        stage = 2 * WG_BLOCK_K * 2 * dmax
        return dict(loader="tma", grid=(b * h, -(-sq // WG_BLOCK_Q)),
                    threads=WG_THREADS, block_q=WG_BLOCK_Q, walk_q=WG_ROWS,
                    block_k=WG_BLOCK_K, key_split=1, stages=WG_STAGES,
                    dmax=dmax, swizzle=sw,
                    smem_bytes=1024 + q_bytes + WG_STAGES * stage)
    size = 2 if bf16 else 4
    return dict(loader="mma_sync", grid=(b * h, -(-sq // BLOCK_Q)),
                threads=32 * KEY_SPLIT, block_q=BLOCK_Q, walk_q=BLOCK_Q,
                block_k=BLOCK_K, key_split=KEY_SPLIT, stages=2, dmax=dmax,
                swizzle=0,
                vec=bool(aligned and (d * size) % 16 == 0))


def decode_chunks(lengths, n):
    """The chunk [start, end) of each row's valid prefix [0, length) that
    rank r of its cluster of n blocks walks, as the kernel cuts it: two
    int64 tensors [n, rows] for ``lengths`` [rows]."""
    r = torch.arange(n, device=lengths.device)[:, None]
    lengths = lengths.to(torch.int64)[None, :]
    return r * lengths // n, (r + 1) * lengths // n


#: kernel name -> launches since the last reset_launches()
launches = {"flash_attention": 0, "flash_attention_bf16": 0,
            "flash_decode": 0, "flash_decode_bf16": 0}


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
    skipped), and their (m, l, acc) merge in order. The arithmetic is
    float32; bfloat16 inputs round P to bfloat16 before P V, as the JAX
    kernel does (``p.astype(v.dtype)``) and the bfloat16 kernel does,
    while l sums the unrounded P."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    scale = d ** -0.5 if sm_scale is None else float(sm_scale)
    pv_dtype = v.dtype
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
                acc = acc * alpha + torch.einsum(
                    "bhqk,bhkd->bhqd", p.to(pv_dtype).float(), vt)
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


def flash_attention_bwd(q, k, v, out, lse, do, causal=False, sm_scale=None,
                        segment_ids=None, block_k=BWD_BLOCK_K):
    """The forward's gradient, the JAX package's ``_bwd_blockwise``:
    returns ``(dq, dk, dv)``, each in its input's dtype.

    ``out`` and ``lse`` are the forward's outputs and ``do`` the
    cotangent of ``out``. It walks blocks of ``block_k`` keys (all ``sk``
    keys at once where ``block_k`` does not divide ``sk``), recomputes
    each block's masked scores as the forward does (causal and segment
    masks with the mask value) and the probabilities ``p = exp(s -
    lse)``, and sums in float32: ``delta = sum(dO O)`` by row, ``dv =
    p^T dO``, ``ds = p (dO V^T - delta) scale``, ``dq += ds K``, ``dk =
    ds^T Q``."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    scale = d ** -0.5 if sm_scale is None else float(sm_scale)
    block_k = min(block_k, sk)
    if sk % block_k:
        block_k = sk
    dev = q.device
    q32, k32, v32, do32 = q.float(), k.float(), v.float(), do.float()
    delta = torch.sum(do32 * out.float(), -1, keepdim=True)
    qi = torch.arange(sq, device=dev)[:, None]
    dq = torch.zeros((b, h, sq, d), dtype=torch.float32, device=dev)
    dks, dvs = [], []
    for k0 in range(0, sk, block_k):
        ks, vs = k32[:, :, k0:k0 + block_k], v32[:, :, k0:k0 + block_k]
        s = torch.einsum("bhqd,bhkd->bhqk", q32, ks) * scale
        if causal:
            ki = torch.arange(k0, k0 + block_k, device=dev)[None, :]
            s = torch.where(qi >= ki, s, DEFAULT_MASK_VALUE)
        if segment_ids is not None:
            ok = (segment_ids[0][:, None, :, None]
                  == segment_ids[1][:, None, None, k0:k0 + block_k])
            s = torch.where(ok, s, DEFAULT_MASK_VALUE)
        p = torch.exp(s - lse[..., None])
        dvs.append(torch.einsum("bhqk,bhqd->bhkd", p, do32))
        dp = torch.einsum("bhqd,bhkd->bhqk", do32, vs)
        ds = p * (dp - delta) * scale
        dq = dq + torch.einsum("bhqk,bhkd->bhqd", ds, ks)
        dks.append(torch.einsum("bhqk,bhqd->bhkd", ds, q32))
    return (dq.to(q.dtype), torch.cat(dks, 2).to(k.dtype),
            torch.cat(dvs, 2).to(v.dtype))


def _merge(parts):
    """(m, l, acc) of online softmaxes merged in order; one that saw no
    key has m = -inf and adds nothing."""
    m_all = parts[0][0]
    for m, _, _ in parts[1:]:
        m_all = torch.maximum(m_all, m)
    l_all = torch.zeros_like(m_all)
    acc_all = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        c = torch.where(m == -float("inf"), 0.0, torch.exp(m - m_all))
        l_all = l_all + l * c
        acc_all = acc_all + acc * c[..., None]
    return m_all, l_all, acc_all


def flash_decode_reference(q, k_cache, v_cache, cache_len, sm_scale=None,
                           block_k=DECODE_BLOCK_K, acc=torch.float32):
    """Plain version of the decode kernel. ``q`` [b, h, 1, d] or
    [b, h, d]; returns the same rank, in float32.

    It follows the kernel's blocking: each row's valid prefix is cut
    into decode_plan's chunks (decode_chunks; on the tensor's own card,
    or an H100), each chunk's tiles of ``block_k`` keys are walked in
    turn by DECODE_WARPS online softmaxes, merged in warp order, and the
    chunks merged in rank order. Positions past a row's length are never
    used. Scores are float32 (q against the widened keys); over a
    bfloat16 cache ``p = exp(s - m)`` is rounded to bfloat16 before the
    P V sum, against the walk's running max, as the JAX kernel rounds it
    (``p.astype(v_ref.dtype)``) and the CUDA kernel does; ``l`` sums the
    unrounded ``p``. ``acc=torch.float64`` does the arithmetic in
    float64 with the same roundings of ``p``: a witness of the kernel."""
    b, h, s, d = k_cache.shape
    dev = q.device
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else H100_SMS)
    n = decode_plan(b, h, s, d, sms)["blocks_per_row"]
    return _decode_walk(q, k_cache, v_cache, cache_len, sm_scale, n,
                        DECODE_WARPS, block_k, acc)


def _decode_walk(q, k_cache, v_cache, cache_len, sm_scale, blocks, warps,
                 block_k, acc_dtype=torch.float32):
    """Decode attention walked as ``blocks`` chunks of each row's valid
    prefix, each by ``warps`` online softmaxes over tiles of ``block_k``
    keys taken in turn; ``blocks = warps = 1`` is one walk, and with
    ``block_k=128`` it walks as the JAX kernel does."""
    squeeze = q.dim() == 3
    b, h, s, d = k_cache.shape
    scale = d ** -0.5 if sm_scale is None else float(sm_scale)
    dev = q.device
    pv_dtype = v_cache.dtype
    f = acc_dtype
    q2 = (q if squeeze else q[:, :, 0, :]).to(f).reshape(b * h, d)
    k2 = k_cache.reshape(b * h, s, d)
    v2 = v_cache.reshape(b * h, s, d)
    lens = cache_len.to(torch.int64).clamp(0, s).repeat_interleave(h)
    inf = float("inf")
    starts, ends = decode_chunks(lens, blocks)
    chunks = []
    for c0, c1 in zip(starts, ends):
        n_tiles = int(-(-(c1 - c0).max() // block_k)) if b * h else 0
        parts = []
        for w in range(warps):
            m = torch.full((b * h,), -inf, dtype=f, device=dev)
            l = torch.zeros((b * h,), dtype=f, device=dev)
            acc = torch.zeros((b * h, d), dtype=f, device=dev)
            for tile in range(w, n_tiles, warps):
                pos = c0[:, None] + tile * block_k + torch.arange(
                    block_k, device=dev)[None, :]
                ok = pos < c1[:, None]
                # a masked position reads nothing: its row is zeroed
                idx = torch.where(ok, pos, 0)[..., None].expand(-1, -1, d)
                kt = torch.where(ok[..., None], torch.gather(k2, 1, idx), 0.0)
                vt = torch.where(ok[..., None], torch.gather(v2, 1, idx), 0.0)
                sc = torch.einsum("nd,nkd->nk", q2, kt.to(f)) * scale
                sc = torch.where(ok, sc, -inf)
                m_new = torch.maximum(m, sc.amax(-1))
                # a row with no valid key yet keeps alpha = p = 0
                m_safe = torch.where(m_new == -inf, 0.0, m_new)
                alpha = torch.exp(m - m_safe)
                p = torch.exp(sc - m_safe[:, None])
                l = alpha * l + p.sum(-1)
                acc = acc * alpha[:, None] + torch.einsum(
                    "nk,nkd->nd", p.to(pv_dtype).to(f), vt.to(f))
                m = m_new
            parts.append((m, l, acc))
        chunks.append(_merge(parts))
    _, l, acc = _merge(chunks)
    out = torch.where(l[:, None] == 0.0, 0.0,
                      acc / torch.where(l == 0.0, 1.0, l)[:, None])
    out = out.reshape(b, h, d)
    return out if squeeze else out[:, :, None, :]


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(cond, msg, *args):
    if not cond:
        raise ValueError(msg % args)


def _check_float(name, t, device, dtype=torch.float32):
    _check(t.device == device, "%s is on %s, expected %s", name, t.device,
           device)
    _check(t.dtype == dtype, "%s must be %s, got %s", name,
           str(dtype).replace("torch.", ""), t.dtype)
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
                    return_lse=False, block_k=BWD_BLOCK_K):
    """Fused attention, differentiable in q, k and v. q [b, h, sq, d];
    k, v [b, h, sk, d], all float32 or all bfloat16.

    ``segment_ids``: optional (q_segments [b, sq], k_segments [b, sk])
    int32 pair; tokens attend only within their own segment.
    ``block_k``: the backward's key block (the JAX op's ``block_k``; the
    forward kernels' tiles are fixed). Returns ``out`` [b, h, sq, d] in
    the inputs' dtype, or ``(out, lse)`` with ``return_lse`` (``lse``
    float32, not differentiable)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes 4-D [b, h, s, d] tensors")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    _check(tuple(k.shape) == (b, h, sk, d) and tuple(v.shape) == tuple(
        k.shape), "k/v shapes %s/%s do not match q %s", tuple(k.shape),
        tuple(v.shape), tuple(q.shape))
    _check(q.dtype in (torch.float32, torch.bfloat16)
           and k.dtype == v.dtype == q.dtype,
           "flash_attention takes float32 or bfloat16 q, k, v of one "
           "dtype, got %s, %s, %s", q.dtype, k.dtype, v.dtype)
    scale = d ** -0.5 if sm_scale is None else float(sm_scale)
    q_seg, k_seg = segment_ids if segment_ids is not None else (None, None)
    out, lse = FlashAttention.apply(q, k, v, bool(causal), scale, q_seg,
                                    k_seg, int(block_k))
    return (out, lse) if return_lse else out


class FlashAttention(torch.autograd.Function):
    """The forward kernel (its plain version on the CPU, shapes on the
    meta device) with :func:`flash_attention_bwd` as its backward, as
    the JAX package ties ``_bwd_blockwise`` to the Pallas forward with a
    ``custom_vjp``. Returns ``(out, lse)``; ``lse`` has no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_seg, k_seg, block_k):
        seg = (q_seg, k_seg) if q_seg is not None else None
        dev = q.device
        if dev.type == "meta":
            b, h, sq, d = q.shape
            out = torch.empty((b, h, sq, d), dtype=q.dtype, device=dev)
            lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
        elif dev.type == "cpu":
            out, lse = flash_attention_reference(q, k, v, causal, scale,
                                                 seg)
            out = out.to(q.dtype)
        elif dev.type == "cuda":
            out, lse = _flash_attention_cuda(q, k, v, causal, scale, seg)
        else:
            raise ValueError("flash_attention: no kernel for device %s"
                             % dev)
        ctx.save_for_backward(q, k, v, out, lse, q_seg, k_seg)
        ctx.causal, ctx.scale, ctx.block_k = causal, scale, block_k
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse, q_seg, k_seg = ctx.saved_tensors
        seg = (q_seg, k_seg) if q_seg is not None else None
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         ctx.causal, ctx.scale, seg,
                                         ctx.block_k)
        return dq, dk, dv, None, None, None, None, None


def _flash_attention_cuda(q, k, v, causal, scale, segment_ids):
    from paddle_tpu_torch.kernels import _build

    b, h, sq, d = q.shape
    sk = k.shape[2]
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_float(name, t, dev, q.dtype)
    _check(1 <= d <= 128, "head_dim %d outside the kernel's 1..128", d)
    q_seg = k_seg = None
    if segment_ids is not None:
        q_seg, k_seg = segment_ids
        _check_int("q_segments", q_seg, (b, sq), dev)
        _check_int("k_segments", k_seg, (b, sk), dev)
    extra = ()
    if q.dtype == torch.bfloat16:
        fn, name = "flash_attention_fwd_bf16", "flash_attention_bf16"
        aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
        extra = (int(fwd_plan(b, h, sq, sk, d, q.dtype, aligned)["loader"]
                     == "tma"),)
    else:
        fn, name = "flash_attention_fwd", "flash_attention"
    lib = _build.load("flash_attention")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = getattr(lib, fn)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            q_seg.data_ptr() if q_seg is not None else None,
            k_seg.data_ptr() if k_seg is not None else None,
            out.data_ptr(), lse.data_ptr(), b, h, sq, sk, d,
            ctypes.c_float(scale), int(bool(causal)), *extra,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, fn)
    count_launch(launches, name)
    return out, lse


def flash_decode(q, k_cache, v_cache, cache_len, sm_scale=None):
    """Single-query decode attention against a length-masked KV cache.

    ``q`` [b, h, 1, d] (or [b, h, d]) float32; caches [b, h, max_len,
    d], both float32 or both bfloat16; ``cache_len`` [b] int32: row b
    attends to cache positions < cache_len[b]. Returns the same rank as
    ``q``, float32."""
    squeeze = q.dim() == 3
    if k_cache.dim() != 4 or tuple(v_cache.shape) != tuple(k_cache.shape):
        raise ValueError("flash_decode caches must be equal 4-D "
                         "[b, h, max_len, d] tensors")
    b, h, s, d = k_cache.shape
    qshape = (b, h, d) if squeeze else (b, h, 1, d)
    _check(tuple(q.shape) == qshape, "q must be %s, got %s", qshape,
           tuple(q.shape))
    cdt = k_cache.dtype
    _check(cdt in (torch.float32, torch.bfloat16) and v_cache.dtype == cdt,
           "flash_decode takes float32 or bfloat16 caches of one dtype, "
           "got %s, %s", k_cache.dtype, v_cache.dtype)
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

    _check_float("q", q, dev)
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        _check_float(name, t, dev, cdt)
    _check_int("cache_len", cache_len, (b,), dev)
    _check(1 <= d <= 128, "head_dim %d outside the kernel's 1..128", d)
    fn = "flash_decode_bf16" if cdt == torch.bfloat16 else "flash_decode"
    lib = _build.load("flash_attention")
    out = torch.empty(qshape, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = getattr(lib, fn)(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            cache_len.data_ptr(), out.data_ptr(), b, h, s, d,
            ctypes.c_float(scale),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, fn)
    count_launch(launches, fn)
    return out
