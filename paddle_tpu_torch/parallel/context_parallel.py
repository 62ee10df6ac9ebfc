"""Context (sequence) parallelism: ring attention over a mesh axis.

Capability parity: the JAX package's ``parallel/context_parallel.py``.
The sequence is cut over a mesh axis ('sp'): each rank holds one
contiguous time chunk of q, k and v, and attention runs as a ring. At
each step a rank computes one (q chunk x kv chunk) block and the kv
chunks move one rank along the axis' line (``batch_isend_irecv`` over
the line's process group: send to the next rank, receive from the
previous). The blocks merge by their log-sum-exp, so the result is full
attention's math.

Causal masking across the ring uses chunk provenance: at ring step s,
rank i holds the kv chunk of rank j = (i - s) mod n; the chunk is fully
visible when j < i, causal on the diagonal (j == i), and skipped when
j > i. Segment ids of the keys travel with their chunk.

Each block is the flash-attention forward, B1: ``flash_attention(...,
return_lse=True)``, the CUDA kernel on a card tensor (non-causal off the
diagonal, causal on it, with the segment ids) and its plain version on
the CPU; ``plain=True`` runs the plain version (``flash_attention_
reference``) on any device. B1 drops a masked key's weight by the mask
value, so a row that sees no key of its segment in a block has an
``lse`` near the mask value (or ``-inf`` where a walk saw no key at
all): :func:`merge_blocks` weighs such a block by ``exp(lse - max)``,
which is 0, and never forms ``-inf - -inf``. Every row sees its own
position on the diagonal block, so its merged ``lse`` is finite.

The backward is one ``torch.autograd.Function`` over the whole ring: a
second ring in which each block's dq, dk and dv come from
``flash_attention_bwd`` against the ring's GLOBAL output and lse (the
JAX package's ``_block_attn`` recomputes each block under
``jax.checkpoint`` for the same reason: no O(seq^2 / n) score matrix is
kept between the passes). dK and dV travel with their chunk, summed in
float32 in ring order, and one last step hands them to the chunk's
owner. At one rank the ring is one causal block: the output, lse and
gradients are B1's and ``flash_attention_bwd``'s bit for bit.

:func:`ring_in_process` and :func:`ring_in_process_bwd` run the same
blocks, merges and block backwards for all n ranks of a ring in one
process (the chunks indexed instead of sent), in the order the ranks
run them, so a card with one rank can check the ring's blocks.

The port runs one process a rank, as DDP does: the whole-array entry
:func:`context_parallel_attention` takes this rank's block of the global
arrays (its rows over ``batch_axis`` and its time chunk over ``axis``)
and returns its block of the output.
"""

import torch
import torch.distributed as dist

from paddle_tpu_torch.kernels import flash_attention as fa

__all__ = ["ring_attention", "context_parallel_attention",
           "block_forward", "merge_blocks", "block_backward",
           "ring_in_process", "ring_in_process_bwd"]

_INF = float("inf")


# ---- the ring's pieces ----

def block_forward(q, k, v, causal, sm_scale, segment_ids=None,
                  plain=False):
    """One ring block: ``(out, lse)`` of q against one kv chunk, out in
    q's dtype (B1's), lse float32. B1 on a card tensor, its plain
    version on the CPU or with ``plain``."""
    if plain:
        out, lse = fa.flash_attention_reference(q, k, v, causal, sm_scale,
                                                segment_ids)
        return out.to(q.dtype), lse
    return fa.flash_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                              segment_ids=segment_ids, return_lse=True)


def merge_blocks(acc, new):
    """Two blocks' ``(out, lse)`` merged by their log-sum-exp: the
    weights ``exp(lse - max)`` of a block that saw no key (lse -inf, or
    near the mask value) are 0, and two such blocks give out 0 and lse
    -inf. ``acc`` None: ``new`` alone. out float32."""
    if acc is None:
        return new[0].float(), new[1]
    oa, la = acc
    ob, lb = new
    m = torch.maximum(la, lb)
    m = torch.where(m == -_INF, 0.0, m)
    wa, wb = torch.exp(la - m), torch.exp(lb - m)
    l = wa + wb
    out = (oa * wa[..., None] + ob.float() * wb[..., None]) \
        / torch.where(l == 0.0, 1.0, l)[..., None]
    lse = torch.where(l == 0.0, -_INF, m + torch.log(l))
    return out, lse


def block_backward(q, k, v, out, lse, dout, causal, sm_scale,
                   segment_ids=None, block_k=fa.BWD_BLOCK_K):
    """One block's ``(dq, dk, dv)`` in float32 against the ring's global
    ``out`` and ``lse`` (``flash_attention_bwd``: p = exp(s - lse) is the
    block's share of the whole softmax)."""
    return fa.flash_attention_bwd(q.float(), k.float(), v.float(), out,
                                  lse, dout, causal, sm_scale, segment_ids,
                                  block_k)


def _visible(causal, j, i):
    return not (causal and j > i)


def _seg(q_seg, k_seg):
    return None if q_seg is None else (q_seg, k_seg)


# ---- the ring over a process group ----

class _Ring:
    """This rank's place on the ring: the line's process group, its size
    ``n``, this rank's index ``my`` on it and the global ranks after and
    before it. ``shift`` sends tensors one step along the ring and
    returns what arrives; ``comm`` (a ``collectives.TraceComm``) records
    each step in its census."""

    def __init__(self, group, line, my, comm=None, axis="sp"):
        self.group, self.n, self.my = group, len(line), int(my)
        self.next = line[(self.my + 1) % self.n]
        self.prev = line[(self.my - 1) % self.n]
        self.comm, self.axis = comm, axis

    def shift(self, tensors):
        sends = [t.contiguous() for t in tensors]
        recvs = [torch.empty_like(t) for t in sends]
        ops = []
        for i, (t, r) in enumerate(zip(sends, recvs)):
            ops.append(dist.P2POp(dist.isend, t, self.next, self.group, i))
            ops.append(dist.P2POp(dist.irecv, r, self.prev, self.group, i))
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        if self.comm is not None:
            for t in sends:
                self.comm.note_p2p(t, "ring", self.axis)
        return recvs


def _ring_forward(q, k, v, ring, causal, scale, q_seg, k_seg):
    acc = None
    ks, vs, kseg = k, v, k_seg
    for s in range(ring.n):
        if s:
            moved = ring.shift([ks, vs] + ([kseg] if kseg is not None
                                           else []))
            ks, vs = moved[0], moved[1]
            kseg = moved[2] if kseg is not None else None
        j = (ring.my - s) % ring.n
        if not _visible(causal, j, ring.my):
            continue
        acc = merge_blocks(acc, block_forward(
            q, ks, vs, causal and j == ring.my, scale, _seg(q_seg, kseg)))
    return acc[0].to(q.dtype), acc[1]


def _ring_backward(q, k, v, out, lse, dout, ring, causal, scale, q_seg,
                   k_seg, block_k):
    dq = dk = dv = None
    ks, vs, kseg = k, v, k_seg
    for s in range(ring.n):
        if s:
            # the chunk moves on with its gradients so far (its owner,
            # step 0's diagonal block, always gives the first)
            moved = ring.shift([ks, vs, dk, dv]
                               + ([kseg] if kseg is not None else []))
            ks, vs, dk, dv = moved[:4]
            kseg = moved[4] if kseg is not None else None
        j = (ring.my - s) % ring.n
        if not _visible(causal, j, ring.my):
            continue
        bq, bk, bv = block_backward(q, ks, vs, out, lse, dout,
                                    causal and j == ring.my, scale,
                                    _seg(q_seg, kseg), block_k)
        dq = bq if dq is None else dq + bq
        dk = bk if dk is None else dk + bk
        dv = bv if dv is None else dv + bv
    if ring.n > 1:
        # the held chunk is the next rank's: its gradients go home
        dk, dv = ring.shift([dk, dv])
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingAttention(torch.autograd.Function):
    """The ring forward with the second ring as its backward. Returns
    ``(out, lse)``; ``lse`` has no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, ring, causal, scale, q_seg, k_seg, block_k):
        out, lse = _ring_forward(q, k, v, ring, causal, scale, q_seg,
                                 k_seg)
        ctx.save_for_backward(q, k, v, out, lse, q_seg, k_seg)
        ctx.ring, ctx.causal, ctx.scale = ring, causal, scale
        ctx.block_k = block_k
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse, q_seg, k_seg = ctx.saved_tensors
        dq, dk, dv = _ring_backward(q, k, v, out, lse, dout, ctx.ring,
                                    ctx.causal, ctx.scale, q_seg, k_seg,
                                    ctx.block_k)
        return dq, dk, dv, None, None, None, None, None, None


def _run_ring(q, k, v, ring, causal, sm_scale, segment_ids, block_k):
    if q.dim() != 4:
        raise ValueError("ring attention takes 4-D [b, h, s, d] chunks")
    scale = q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)
    q_seg, k_seg = (None, None) if segment_ids is None else (
        segment_ids[0].to(torch.int32).contiguous(),
        segment_ids[1].to(torch.int32).contiguous())
    out, _ = _RingAttention.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), ring, bool(causal),
        scale, q_seg, k_seg, int(block_k))
    return out


def ring_attention(q, k, v, axis_name, causal=False, sm_scale=None,
                   segment_ids=None, axis_index=None, mesh=None):
    """Attention with k/v moving around the ring of ``axis_name``'s line
    through this rank (of ``mesh``, default the current ``mesh_guard``
    mesh); q, k, v are this rank's chunks [batch, heads, local_seq,
    head_dim], ``segment_ids`` the optional local (q_seg [b, sq], k_seg
    [b, sk]) pair (k_seg rides the ring with k and v). Returns this
    rank's output chunk. ``axis_index`` overrides this rank's position
    on the line for the chunks' provenance (the JAX package's override
    of ``lax.axis_index``)."""
    from paddle_tpu_torch.parallel import mesh as mesh_lib

    mesh = mesh if mesh is not None else mesh_lib.get_mesh()
    if mesh is None or axis_name not in mesh.axis_names:
        raise ValueError("ring_attention over %r needs a mesh with that "
                         "axis (mesh=, or mesh_guard)" % (axis_name,))
    my = mesh.axis_rank(axis_name) if axis_index is None \
        else int(axis_index)
    ring = _Ring(mesh.axis_group(axis_name), mesh.line(axis_name), my,
                 axis=axis_name)
    return _run_ring(q, k, v, ring, causal, sm_scale, segment_ids,
                     fa.BWD_BLOCK_K)


def context_parallel_attention(q, k, v, mesh, axis="sp", causal=False,
                               sm_scale=None, batch_axis=None,
                               segment_ids=None, block_k=fa.BWD_BLOCK_K,
                               comm=None):
    """The whole-array entry, one process a rank: q, k, v [batch, heads,
    seq, head_dim] are this rank's block of the global arrays — its rows
    over ``batch_axis`` (when the mesh has it; else every rank of a line
    holds the same rows) and its time chunk over ``axis`` — and the
    result is this rank's block of the output; ``segment_ids`` the
    (q_seg, k_seg) [batch, seq] of the same block. The ring runs over
    the rank's line along ``axis``. ``block_k``: the backward's key block
    (``fused_attention``'s); ``comm``: the executor step's comm layer,
    whose census records each ring step."""
    if axis not in mesh.axis_names:
        raise ValueError("context_parallel_attention: the mesh has no %r "
                         "axis" % (axis,))
    ring = _Ring(mesh.axis_group(axis), mesh.line(axis),
                 mesh.axis_rank(axis), comm=comm, axis=axis)
    return _run_ring(q, k, v, ring, causal, sm_scale, segment_ids, block_k)


# ---- the same ring for all its ranks in one process ----

def _chunks(t, n, dim=2):
    s = t.shape[dim]
    if s % n:
        raise ValueError("sequence %d does not split into %d chunks"
                         % (s, n))
    return [c.contiguous() for c in torch.chunk(t, n, dim)]


def ring_in_process(q, k, v, n, causal=False, sm_scale=None,
                    segment_ids=None, plain=False):
    """The ring of ``n`` ranks over whole q, k, v [b, h, seq, d] in one
    process: rank i's blocks (its q chunk against chunks i, i-1, ...,
    the skipped ones left out), merged in the ring's order, as
    :func:`ring_attention` on each rank computes them. Returns the whole
    ``(out, lse)``; B1 launches n(n+1)/2 times when causal, n^2 else."""
    scale = q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)
    qs, ks, vs = _chunks(q, n), _chunks(k, n), _chunks(v, n)
    qseg = kseg = [None] * n
    if segment_ids is not None:
        qseg = _chunks(segment_ids[0].to(torch.int32), n, 1)
        kseg = _chunks(segment_ids[1].to(torch.int32), n, 1)
    outs, lses = [], []
    for i in range(n):
        acc = None
        for s in range(n):
            j = (i - s) % n
            if not _visible(causal, j, i):
                continue
            acc = merge_blocks(acc, block_forward(
                qs[i], ks[j], vs[j], causal and j == i, scale,
                _seg(qseg[i], kseg[j]), plain))
        outs.append(acc[0].to(q.dtype))
        lses.append(acc[1])
    return torch.cat(outs, 2), torch.cat(lses, 2)


def ring_in_process_bwd(q, k, v, out, lse, dout, n, causal=False,
                        sm_scale=None, segment_ids=None,
                        block_k=fa.BWD_BLOCK_K):
    """The ring's backward for all ``n`` ranks in one process, against
    the whole ``out`` and ``lse`` of :func:`ring_in_process`: each
    rank's dq summed in its steps' order, each chunk's dk and dv summed
    in the order the chunk visits the ranks (its owner first), as the
    second ring sums them. Returns the whole ``(dq, dk, dv)``."""
    scale = q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)
    qs, ks, vs = _chunks(q, n), _chunks(k, n), _chunks(v, n)
    os_, dos = _chunks(out, n), _chunks(dout, n)
    ls = _chunks(lse, n)
    qseg = kseg = [None] * n
    if segment_ids is not None:
        qseg = _chunks(segment_ids[0].to(torch.int32), n, 1)
        kseg = _chunks(segment_ids[1].to(torch.int32), n, 1)
    blocks = {}
    for i in range(n):
        for j in range(n):
            if _visible(causal, j, i):
                blocks[i, j] = block_backward(
                    qs[i], ks[j], vs[j], os_[i], ls[i], dos[i],
                    causal and j == i, scale, _seg(qseg[i], kseg[j]),
                    block_k)
    dq, dk, dv = [], [], []
    for i in range(n):
        acc = None
        for s in range(n):
            j = (i - s) % n
            if (i, j) in blocks:
                b = blocks[i, j][0]
                acc = b if acc is None else acc + b
        dq.append(acc.to(q.dtype))
    for j in range(n):
        acc_k = acc_v = None
        for t in range(n):
            i = (j + t) % n
            if (i, j) in blocks:
                _, bk, bv = blocks[i, j]
                acc_k = bk if acc_k is None else acc_k + bk
                acc_v = bv if acc_v is None else acc_v + bv
        dk.append(acc_k.to(k.dtype))
        dv.append(acc_v.to(v.dtype))
    return torch.cat(dq, 2), torch.cat(dk, 2), torch.cat(dv, 2)
