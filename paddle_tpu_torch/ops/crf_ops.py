"""Linear-chain CRF ops: the training loss and Viterbi decoding.

Capability parity: `operators/linear_chain_crf_op.{h,cc}` and
`operators/crf_decoding_op.{h,cc}` (the label_semantic_roles model's
core, reference book ch.7), as the JAX package's ``ops/crf_ops.py``
lowers them: the forward (log-partition) recursion and Viterbi run over
the padded time axis of a PackedSeq batch, batched over rows, with
per-row length masks. The JAX package runs them under ``lax.scan``;
here they are Python loops over T of small device ops, which a CUDA
graph captures (no host read). The loss's gradient is autograd's (the
generic grad), as the JAX package's is ``jax.vjp``'s; the reference
needed a hand-written backward.

Transition layout follows the reference: row 0 = start weights, row 1 =
end weights, rows 2.. = the [tag_num, tag_num] transition matrix.
"""

import torch

from paddle_tpu_torch.core.lower import PackedSeq
from paddle_tpu_torch.core.registry import op


def _steps(ctx, t_len):
    """Time steps 1..T-1 of a recursion; one on the meta device, where
    shape inference needs no more."""
    return range(1, min(t_len, 2) if ctx.device.type == "meta" else t_len)


def _crf_terms(ctx, emission, lengths, transition, labels):
    """emission [B,T,N]; lengths [B]; transition [N+2,N]; labels [B,T]
    int. Returns (log_z [B], gold path score [B])."""
    b, t_len, n = emission.shape
    start, end, trans = transition[0], transition[1], transition[2:]
    mask = torch.arange(t_len, device=emission.device)[None, :] \
        < lengths[:, None]

    # log partition by the forward recursion: a masked log-sum-exp over
    # the previous tag at every step
    alpha = start[None, :] + emission[:, 0, :]
    for t in _steps(ctx, t_len):
        scores = alpha[:, :, None] + trans[None, :, :]      # [B,prev,cur]
        new = torch.logsumexp(scores, dim=1) + emission[:, t, :]
        alpha = torch.where(mask[:, t, None], new, alpha)
    log_z = torch.logsumexp(alpha + end[None, :], dim=1)

    # the gold path's score
    lab = labels.to(torch.int64)
    fmask = mask.to(emission.dtype)
    emit_scores = torch.gather(emission, 2, lab[:, :, None])[:, :, 0]
    emit_sum = torch.sum(emit_scores * fmask, dim=1)
    trans_scores = trans[lab[:, :-1], lab[:, 1:]]            # [B,T-1]
    trans_sum = torch.sum(trans_scores * fmask[:, 1:], dim=1)
    last_idx = torch.clamp(lengths.to(torch.int64) - 1, min=0)
    last_tag = torch.gather(lab, 1, last_idx[:, None])[:, 0]
    path = start[lab[:, 0]] + emit_sum + trans_sum + end[last_tag]
    return log_z, path


@op("linear_chain_crf", nondiff_inputs=("Label",))
def _linear_chain_crf(ctx, ins, attrs, o):
    """The negative log likelihood of each row's label sequence,
    ``LogLikelihood`` [B, 1] (float32 for float32 emissions); the other
    outputs repeat it, as in the JAX package."""
    emission = ins["Emission"][0]
    transition = ins["Transition"][0]
    label = ins["Label"][0]
    if not isinstance(emission, PackedSeq):
        raise TypeError("linear_chain_crf expects a packed sequence of "
                        "emissions")
    lab = label.data if isinstance(label, PackedSeq) else label
    if lab.dim() == 3 and lab.shape[-1] == 1:
        lab = lab[:, :, 0]
    log_z, path = _crf_terms(ctx, emission.data, emission.lengths,
                             transition, lab)
    ll = (log_z - path)[:, None]
    return {"LogLikelihood": ll, "Alpha": ll,
            "EmissionExps": ll, "TransitionExps": ll}


@op("crf_decoding", no_grad=True)
def _crf_decoding(ctx, ins, attrs, o):
    """Viterbi tags ``ViterbiPath``, a PackedSeq [B, T, 1] int64. A tie
    goes to the lowest tag (``torch.argmax`` returns the first maximum,
    as ``jnp.argmax`` does); a padded step backtracks to itself and is
    written as tag 0."""
    emission = ins["Emission"][0]
    transition = ins["Transition"][0]
    if not isinstance(emission, PackedSeq):
        raise TypeError("crf_decoding expects a packed sequence of "
                        "emissions")
    em, lengths = emission.data, emission.lengths
    b, t_len, n = em.shape
    start, end, trans = transition[0], transition[1], transition[2:]
    mask = torch.arange(t_len, device=em.device)[None, :] < lengths[:, None]
    own = torch.arange(n, device=em.device)[None, :].expand(b, n)

    delta = start[None, :] + em[:, 0, :]
    bps = []
    for t in _steps(ctx, t_len):
        scores = delta[:, :, None] + trans[None, :, :]      # [B,prev,cur]
        best_prev = torch.argmax(scores, dim=1)             # [B,cur]
        new = torch.gather(scores, 1, best_prev[:, None, :])[:, 0, :] \
            + em[:, t, :]
        m = mask[:, t, None]
        delta = torch.where(m, new, delta)
        bps.append(torch.where(m, best_prev, own))
    tag = torch.argmax(delta + end[None, :], dim=1)         # [B]
    tags = [tag]
    for bp in reversed(bps):
        tag = torch.gather(bp, 1, tag[:, None])[:, 0]
        tags.append(tag)
    tags.reverse()
    if ctx.device.type == "meta":
        path = tags[0][:, None].expand(b, t_len)
    else:
        path = torch.stack(tags, 1)
    path = torch.where(mask, path, 0).to(torch.int64)
    return {"ViterbiPath": PackedSeq(path[:, :, None], lengths)}
