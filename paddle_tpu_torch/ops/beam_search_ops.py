"""Beam-search decoding as a higher-order block op.

Capability parity: reference `operators/beam_search_op.cc` +
`beam_search_decode_op.cc` composed inside a `while` loop by the
machine_translation book model, as the JAX package's
``ops/beam_search_ops.py`` redesigns it: the user's step sub-block
(token, states) -> (logits, new states) runs ``max_len`` times with a
fixed beam width, the top-K over [K*V] per batch row picks each step's
beams, parent back-pointers are recorded and backtracked at the end.
The JAX package runs the steps under one ``lax.scan``; here they are a
Python loop over the same fixed shapes, with no value read on the host
inside it, so a CUDA graph could capture the whole decode.

Top-K ties: ``lax.top_k`` puts the lower index first among equal
values, and ties are real here (at step 0 the K-1 dead beams all score
-1e9, and -1e9 + logp rounds to a few float32 values; a finished beam's
non-EOS candidates are all -1e9 below it). ``torch.topk`` promises no
order for ties on any device, so :func:`top_k_lower_index_first` ranks
by a 64-bit key of (value, -index), which has no ties. The final
ranking is a stable sort, as ``jnp.argsort`` is.
"""

import torch

from paddle_tpu_torch.core.lower import PackedSeq, run_block
from paddle_tpu_torch.core.registry import op

__all__ = ["top_k_lower_index_first"]

_NEG = -1e9


def top_k_lower_index_first(x, k):
    """``(values, indices)`` of the ``k`` largest entries along the last
    dim of ``x``, largest first, the lower index first among equal
    values (``lax.top_k``'s order). The key is the float32 value's bits
    mapped to an order-preserving int32 (negative floats flip their
    magnitude bits) above the index's complement, so no two keys tie."""
    n = x.shape[-1]
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    rank = (n - 1) - torch.arange(n, device=x.device, dtype=torch.int64)
    key = ordered.to(torch.int64) * (1 << 32) + rank
    idx = torch.topk(key, k, dim=-1).indices
    return torch.gather(x, -1, idx), idx


def _tile(v, k):
    """[B, ...] -> [B*K, ...] with each batch row's beams contiguous."""
    if isinstance(v, PackedSeq):
        return PackedSeq(torch.repeat_interleave(v.data, k, 0),
                         torch.repeat_interleave(v.lengths, k, 0))
    return torch.repeat_interleave(v, k, 0)


def _take_rows(v, idx):
    if isinstance(v, PackedSeq):
        return PackedSeq(v.data.index_select(0, idx),
                         v.lengths.index_select(0, idx))
    return v.index_select(0, idx)


def _data(v):
    return v.data if isinstance(v, PackedSeq) else v


@op("beam_search_block", no_grad=True)
def _beam_search_block(ctx, ins, attrs, o):
    """Run the step sub-block ``max_len`` times over B*K beams.

    inputs:  Init        -- the states' initial values [B, ...], tiled to
                            [B*K, ...] -> attrs['state_in_names']
             BatchInputs -- per-batch constants, tiled the same way ->
                            attrs['batch_input_names']
             Params      -- outer values the step reads ->
                            attrs['param_names']
    outputs: Ids [B,K,T] int64 (``eos`` past each beam's length),
             Scores [B,K] (length-normalized when
             attrs['length_normalize']), Lengths [B,K] int64, the beams
             best first.
    A finished beam extends with EOS only, at zero cost; each step's
    states are reordered by their parent beam."""
    sub = o.block.program.block(attrs["sub_block_id"])
    token_name = attrs["token_name"]
    logits_name = attrs["logits_name"]
    state_in = attrs.get("state_in_names", [])
    state_out = attrs.get("state_out_names", [])
    K, T = attrs["beam_size"], attrs["max_len"]
    bos, eos = attrs["bos_id"], attrs["eos_id"]
    dev = ctx.device

    inits = ins.get("Init", [])
    B = _data(inits[0]).shape[0] if inits else 1
    states = [_tile(v, K) for v in inits]
    base = dict(zip(attrs.get("param_names", []), ins.get("Params", [])))
    # per-batch constants are tiled once: reordering beams within a batch
    # row leaves them unchanged
    base.update(zip(attrs.get("batch_input_names", []),
                    [_tile(v, K) for v in ins.get("BatchInputs", [])]))

    beam = torch.arange(K, device=dev)
    scores = torch.where(beam == 0, 0.0, _NEG).expand(B, K)
    tokens = torch.full((B * K,), bos, dtype=torch.int64, device=dev)
    finished = torch.zeros((B, K), dtype=torch.bool, device=dev)
    lengths = torch.zeros((B, K), dtype=torch.int32, device=dev)
    row0 = (torch.arange(B, device=dev) * K)[:, None]
    eos_only = None
    toks, parents = [], []
    # shape inference runs one step: every step has the same shapes
    for t in range(1 if dev.type == "meta" else T):
        env = dict(base)
        env[token_name] = tokens[:, None]
        env.update(zip(state_in, states))
        run_block(ctx, sub, env)
        logits = _data(env[logits_name]).reshape(B, K, -1)
        V = logits.shape[-1]
        if eos_only is None:
            eos_only = torch.where(torch.arange(V, device=dev) == eos, 0.0,
                                   _NEG).to(logits.dtype)
        logp = torch.log_softmax(logits, dim=-1)
        logp = torch.where(finished[:, :, None], eos_only, logp)
        cand = (scores[:, :, None] + logp).reshape(B, K * V)
        new_scores, idx = top_k_lower_index_first(cand, K)
        parent = torch.div(idx, V, rounding_mode="floor")
        new_tok = idx - parent * V
        par_finished = torch.gather(finished, 1, parent)
        lengths = torch.where(par_finished, torch.gather(lengths, 1, parent),
                              t + 1)
        finished = par_finished | (new_tok == eos)
        # each state's post-step value (the carry where the step leaves
        # it alone), reordered by parent beam
        updated = [env.get(n, s) if n else s
                   for n, s in zip(state_out, states)]
        flat_parent = (row0 + parent).reshape(-1)
        states = [_take_rows(s, flat_parent) for s in updated]
        tokens, scores = new_tok.reshape(-1), new_scores
        toks.append(new_tok)
        parents.append(parent)
    if dev.type == "meta":
        toks, parents = toks * T, parents * T

    # backtrack: follow the parent pointers from the final beam order
    cur = beam.expand(B, K)
    ids = [None] * T
    for t in range(T - 1, -1, -1):
        ids[t] = torch.gather(toks[t], 1, cur)
        cur = torch.gather(parents[t], 1, cur)
    ids = torch.stack(ids, 2)                                   # [B,K,T]
    valid = torch.arange(T, device=dev)[None, None, :] < lengths[:, :, None]
    ids = torch.where(valid, ids, eos)
    norm = scores / torch.clamp(lengths.to(scores.dtype), min=1.0) \
        if attrs.get("length_normalize", True) else scores
    order = torch.argsort(-norm, dim=1, stable=True)
    ids = torch.gather(ids, 1, order[:, :, None].expand(B, K, T))
    return {"Ids": ids.to(torch.int64),
            "Scores": torch.gather(norm, 1, order),
            "Lengths": torch.gather(lengths, 1, order).to(torch.int64)}
