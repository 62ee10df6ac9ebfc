"""Attention op lowering: the fused flash-attention kernels as an IR op.

``fused_attention`` runs the hand-written CUDA kernels of
``paddle_tpu_torch/kernels/flash_attention.py`` (their plain PyTorch
versions for CPU tensors), in the JAX package's three modes:

* no ``cache_mode``: one-shot attention over q/k/v (the forward kernel),
  with optional segment ids;
* ``"prefill"``: q/k/v are a full prompt (q_len == prompt bucket); the
  op writes the prompt's K/V into cache row ``Slot`` at positions
  0..L-1 and answers causal self-attention over the prompt itself (the
  forward kernel);
* ``"decode"``: q/k/v are one new token per slot; the op writes each
  row's K/V at its ``Pos`` and reads the cache through the single-query
  decode kernel, masked to positions <= pos.

In the cache modes the KCache/VCache inputs are updated IN PLACE and
re-emitted as KCacheOut/VCacheOut: where the JAX package donates the
buffers through the call and XLA aliases them, here the op writes into
the caller's tensors directly. The K/V writes are PyTorch indexing.

The one-shot branch is differentiable (``FlashAttention``, whose
backward walks the JAX op's ``block_k`` keys a block, 128 unless a pass
pinned it); the JAX op's ``block_q`` was tuned for the TPU kernel and is
not read here. Under mixed precision ``amp.cast_ins`` hands the op
bfloat16 Q/K/V, which launch the bfloat16 forward kernel.

With ``seq_axis`` naming an axis of the executor's mesh (the global view
of ``ParallelExecutor`` over a ``(dp, 'sp')`` mesh, whose comm layer
carries the mesh) the one-shot branch runs ring attention
(``parallel/context_parallel.py``) over the rank's line along that axis:
its blocks are the same forward kernel, merged by their log-sum-exp.
"""

import torch

from paddle_tpu_torch.core.registry import op
from paddle_tpu_torch.kernels.flash_attention import (BWD_BLOCK_K,
                                                      flash_attention,
                                                      flash_decode)


@op("fused_attention")
def _fused_attention(ctx, ins, attrs, o):
    q, k, v = ins["Q"][0], ins["K"][0], ins["V"][0]
    cache_mode = attrs.get("cache_mode", None)
    causal = bool(attrs.get("causal", False))
    sm_scale = attrs.get("scale", None)
    if cache_mode is not None:
        if attrs.get("seq_axis", None):
            raise ValueError(
                "fused_attention cache_mode=%r does not compose with "
                "ring (sequence-parallel) execution — decode serving "
                "is single-host per slot array" % cache_mode)
        if not causal:
            raise ValueError(
                "fused_attention cache_mode=%r requires causal=True — "
                "the prefill ladder and the decode cache read are "
                "causal by construction; a bidirectional prompt would "
                "be silently mis-masked" % cache_mode)
        k_cache, v_cache = ins["KCache"][0], ins["VCache"][0]
        if cache_mode == "decode":
            pos = ins["Pos"][0].reshape(-1).to(torch.int64)
            b = torch.arange(q.shape[0], device=q.device)
            # write this step's K/V at each row's position (in place);
            # rows of free slots write harmless finite values that the
            # length mask below never reads
            k_cache[b, :, pos] = k[:, :, 0, :].to(k_cache.dtype)
            v_cache[b, :, pos] = v[:, :, 0, :].to(v_cache.dtype)
            out = flash_decode(q.contiguous(), k_cache, v_cache,
                               (pos + 1).to(torch.int32), sm_scale=sm_scale)
        elif cache_mode == "prefill":
            n = k.shape[2]
            if n > k_cache.shape[2]:
                raise ValueError(
                    "prefill of %d positions exceeds the cache length %d"
                    % (n, k_cache.shape[2]))
            rows = ins["Slot"][0].reshape(-1)[:1].to(torch.int64) + \
                torch.arange(k.shape[0], device=k.device)
            # the prompt's K/V into cache rows slot.. at 0..L-1 (in place)
            k_cache[rows, :, :n] = k.to(k_cache.dtype)
            v_cache[rows, :, :n] = v.to(v_cache.dtype)
            # prompt self-attention needs only the prompt's own K/V
            # (causal within the prefix); the cache write is the side
            # output the decode steps read from
            out = flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=True,
                                  sm_scale=sm_scale)
        else:
            raise ValueError("unknown cache_mode %r" % (cache_mode,))
        return {"Out": out, "KCacheOut": k_cache, "VCacheOut": v_cache}
    seg = None
    if "QSeg" in ins and ins["QSeg"]:
        seg = (ins["QSeg"][0].to(torch.int32).contiguous(),
               ins["KSeg"][0].to(torch.int32).contiguous())
    seq_axis = attrs.get("seq_axis", None)
    mesh = getattr(ctx.comm, "mesh", None) if ctx is not None else None
    if mesh is not None and seq_axis and seq_axis in mesh.axis_names:
        from paddle_tpu_torch.parallel.context_parallel import (
            context_parallel_attention)
        return {"Out": context_parallel_attention(
            q, k, v, mesh, axis=seq_axis, causal=causal, sm_scale=sm_scale,
            batch_axis=attrs.get("batch_axis", None), segment_ids=seg,
            block_k=attrs.get("block_k", BWD_BLOCK_K), comm=ctx.comm)}
    return {"Out": flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=causal,
                                   sm_scale=sm_scale, segment_ids=seg,
                                   block_k=attrs.get("block_k",
                                                     BWD_BLOCK_K))}
