"""Decoder-only transformer language model and its KV-cached serving
forwards.

The JAX package's ``models/transformer.py``, built in this package's
layers DSL: pre-norm decoder blocks over the fused flash-attention op.
The programs it builds serialize to the same JSON as the JAX package's
(same layer sequence, same names, same op uids): the training build
(``build_transformer_lm``, next-token cross-entropy and Adam, as
``bench.py`` trains it) and the KV-cached serving pair. ``mp=True``
declares the Megatron tensor-parallel layout of every block, and
``seq_axis`` the sequence-parallel ring attention of every block, and
``pp_stages`` pipelines the decoder trunk (``layers.Pipeline``, GPipe or
1F1B), all run by ``parallel.ParallelExecutor``.
"""

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers

__all__ = ["transformer_lm", "decoder_block", "build_transformer_lm",
           "build_transformer_decode", "DecodeModelMeta"]


def _ffn(x, d_model, d_ff, param_attr=None, mp=False):
    from paddle_tpu_torch.param_attr import ParamAttr

    # Megatron layout: column-split the up-projection (its bias is a
    # per-column shard too), row-split the down-projection — the comm
    # layer places the single closing all-reduce after the row matmul
    col = dict(param_attr=ParamAttr(sharding=(None, "mp")),
               bias_attr=ParamAttr(sharding=("mp",))) if mp \
        else dict(param_attr=param_attr)
    row = dict(param_attr=ParamAttr(sharding=("mp", None))) if mp \
        else dict(param_attr=param_attr)
    h = layers.fc(x, d_ff, num_flatten_dims=2, act="gelu", **col)
    return layers.fc(h, d_model, num_flatten_dims=2, **row)


def decoder_block(x, num_heads, d_ff, seq_axis=None, dropout_rate=0.0,
                  cache=None, pos=None, slot=None, cache_mode=None,
                  mp=False):
    """One pre-norm decoder block. With ``cache=`` (the KV-cached
    serving forward) returns ``(x, k_cache_out, v_cache_out)``; the
    layer sequence is IDENTICAL to the one-shot block, so parameter
    names line up across the one-shot / prefill / decode builds.

    ``mp=True`` declares the Megatron tensor-parallel layout: head-split
    attention + column/row-split FFN, two 'mp' all-reduces per block
    forward (one after each row-split projection), placed by the comm
    layer."""
    d_model = int(x.shape[-1])
    a = layers.layer_norm(x, begin_norm_axis=2)
    if cache is not None:
        a, kc_out, vc_out = layers.multi_head_attention(
            a, a, a, num_heads, causal=True, seq_axis=seq_axis,
            cache=cache, pos=pos, slot=slot, cache_mode=cache_mode)
    else:
        a = layers.multi_head_attention(a, a, a, num_heads, causal=True,
                                        dropout_rate=dropout_rate,
                                        seq_axis=seq_axis, mp=mp)
    x = layers.elementwise_add(x, a)
    f = layers.layer_norm(x, begin_norm_axis=2)
    f = _ffn(f, d_model, d_ff, mp=mp)
    x = layers.elementwise_add(x, f)
    return (x, kc_out, vc_out) if cache is not None else x


def transformer_lm(tokens, vocab_size, d_model=256, num_layers=4,
                   num_heads=8, d_ff=None, max_len=2048, seq_axis=None,
                   dropout_rate=0.0, pp_stages=None, pp_micro=None,
                   pp_schedule=None, mp=False):
    """tokens: int64 [batch, seq]. Returns logits [batch, seq, vocab].

    ``pp_stages=S`` pipelines the decoder stack: the repeated stage (of
    num_layers/S blocks) is declared once inside a layers.Pipeline
    region, its parameters are [S]-stacked and sharded over the 'pp'
    mesh axis, and embeddings/head stay outside the pipeline (only the
    homogeneous trunk is pipelined). ``pp_micro`` microbatches (default
    S); ``pp_schedule='1f1b'`` swaps the GPipe schedule for the
    memory-steady 1F1B one (parallel/pipeline.py). Ring attention
    (``seq_axis``) inside a stage is refused, and so is ``mp`` with
    ``pp_stages``.

    ``mp=True`` declares the Megatron tensor-parallel layout on every
    block (embeddings and the vocab head stay replicated — by the time
    activations reach the head, every split has been closed)."""
    if pp_stages and seq_axis:
        raise ValueError(
            "transformer_lm(pp_stages=%r, seq_axis=%r): ring attention "
            "inside a pipeline stage is not supported (the stage body "
            "runs on one rank's microbatch); use one of the two axes"
            % (pp_stages, seq_axis))
    if pp_stages and mp:
        raise ValueError(
            "transformer_lm(pp_stages=%r, mp=True): tensor-parallel "
            "blocks inside a pipeline stage are not supported (the stage "
            "body runs with no 'mp' collectives); use one of the two axes"
            % (pp_stages,))
    d_ff = d_ff or 4 * d_model
    x = layers.embedding(tokens, (vocab_size, d_model))
    pos = layers.position_ids(tokens)
    pos_emb = layers.embedding(pos, (max_len, d_model))
    x = layers.elementwise_add(x, pos_emb)
    if pp_stages:
        assert num_layers % pp_stages == 0, (num_layers, pp_stages)
        pipe = layers.Pipeline(num_stages=pp_stages,
                               num_micro=pp_micro or pp_stages,
                               schedule=pp_schedule)
        with pipe.stage():
            h = pipe.input(x)
            for _ in range(num_layers // pp_stages):
                h = decoder_block(h, num_heads, d_ff, seq_axis=seq_axis,
                                  dropout_rate=dropout_rate, mp=mp)
            pipe.output(h)
        x = pipe()
    else:
        for _ in range(num_layers):
            x = decoder_block(x, num_heads, d_ff, seq_axis=seq_axis,
                              dropout_rate=dropout_rate, mp=mp)
    x = layers.layer_norm(x, begin_norm_axis=2)
    return layers.fc(x, vocab_size, num_flatten_dims=2)


def build_transformer_lm(vocab_size=1000, seq_len=128, d_model=128,
                         num_layers=2, num_heads=4, seq_axis=None,
                         lr=1e-3, pp_stages=None, pp_micro=None,
                         pp_schedule=None, mp=False):
    """Build train program: next-token cross-entropy. Returns
    (main, startup, feed names, [loss])."""
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        tokens = layers.data("tokens", [seq_len], dtype="int64")
        targets = layers.data("targets", [seq_len], dtype="int64")
        logits = transformer_lm(tokens, vocab_size, d_model=d_model,
                                num_layers=num_layers, num_heads=num_heads,
                                max_len=max(seq_len, 2048),
                                seq_axis=seq_axis, pp_stages=pp_stages,
                                pp_micro=pp_micro, pp_schedule=pp_schedule,
                                mp=mp)
        loss = layers.mean(layers.softmax_with_cross_entropy(
            logits, layers.unsqueeze(targets, [2])))
        fluid.optimizer.Adam(lr).minimize(loss)
    return prog, startup, ["tokens", "targets"], [loss]


# ---------------------------------------------------------------------------
# KV-cached serving forwards
# ---------------------------------------------------------------------------


class DecodeModelMeta:
    """Names + shapes the decode runtime (serving/decode.py) needs to
    drive the prefill/decode program pair: feed names, the per-layer
    cache feed names with their matching ``*_out`` fetch names, the
    logits fetch, and the cache geometry."""

    def __init__(self, vocab_size, d_model, num_layers, num_heads,
                 max_len, cache_names, cache_outs, logits_name):
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.head_dim = d_model // num_heads
        self.max_len = max_len
        #: flat list of cache feed names (k then v per layer)
        self.cache_names = tuple(cache_names)
        #: {cache feed name -> its updated-buffer fetch name}
        self.cache_outs = dict(cache_outs)
        self.logits_name = logits_name
        self.tokens_name = "tokens"
        self.pos_name = "pos"
        self.slot_name = "slot"


def _cached_trunk(tokens, pos_ids, num_layers, num_heads, d_model, d_ff,
                  vocab_size, max_len, cache_mode, pos=None, slot=None):
    """The transformer_lm forward with per-layer KV caches threaded
    through — the SAME layer call sequence as the one-shot build, so
    parameters created here alias its parameters by name."""
    caches = []
    for i in range(num_layers):
        kc = layers.data("kv_l%d_k" % i, [num_heads, max_len,
                                          d_model // num_heads])
        vc = layers.data("kv_l%d_v" % i, [num_heads, max_len,
                                          d_model // num_heads])
        caches.append((kc, vc))
    x = layers.embedding(tokens, (vocab_size, d_model))
    pos_emb = layers.embedding(pos_ids, (max_len, d_model))
    x = layers.elementwise_add(x, pos_emb)
    outs = {}
    for i, cache in enumerate(caches):
        x, kc_out, vc_out = decoder_block(
            x, num_heads, d_ff, cache=cache, pos=pos, slot=slot,
            cache_mode=cache_mode)
        outs[cache[0].name] = kc_out.name
        outs[cache[1].name] = vc_out.name
    x = layers.layer_norm(x, begin_norm_axis=2)
    logits = layers.fc(x, vocab_size, num_flatten_dims=2)
    return caches, outs, logits


def build_transformer_decode(vocab_size, d_model=256, num_layers=4,
                             num_heads=8, d_ff=None, max_len=256):
    """Build the (prefill, decode) program pair for KV-cached
    autoregressive serving. Returns ``(prefill_prog, decode_prog,
    meta)`` — both programs read the SAME parameters (create them with a
    ``transformer_lm`` program of the same architecture and
    ``max_len``, or carry them over with ``interop``); each build here
    runs under its own ``unique_name`` guard so the created names line
    up.

    * prefill: feeds ``tokens [1, L]`` (one prompt, host-padded to a
      prompt bucket) + ``slot [1]`` + every cache buffer; writes the
      prompt's K/V into cache row ``slot`` at positions 0..L-1 and
      fetches the full-prompt logits (the runtime reads position
      true_len-1 for the first generated token).
    * decode: feeds ``tokens [slots, 1, 1]`` + ``pos [slots]`` + caches;
      ONE token step over the whole slot array, logits ``[slots, 1,
      vocab]`` per step. The cache buffers are updated in place.
    """
    from paddle_tpu_torch import unique_name

    d_ff = d_ff or 4 * d_model
    meta = None

    with unique_name.guard():
        prefill, pre_start = fluid.Program(), fluid.Program()
        with fluid.program_guard(prefill, pre_start):
            tokens = layers.data("tokens", [-1], dtype="int64")
            slot = layers.data("slot", [], dtype="int32")
            pos_ids = layers.position_ids(tokens)
            caches, outs, logits = _cached_trunk(
                tokens, pos_ids, num_layers, num_heads, d_model, d_ff,
                vocab_size, max_len, "prefill", slot=slot)
            names = [n for kc, vc in caches for n in (kc.name, vc.name)]
            meta = DecodeModelMeta(vocab_size, d_model, num_layers,
                                   num_heads, max_len, names, outs,
                                   logits.name)

    with unique_name.guard():
        decode, dec_start = fluid.Program(), fluid.Program()
        with fluid.program_guard(decode, dec_start):
            # [slots, 1, 1]: lookup_table squeezes the trailing 1 (the
            # reference's [.., 1] id convention), leaving [slots, 1, d]
            tokens = layers.data("tokens", [1, 1], dtype="int64")
            pos = layers.data("pos", [], dtype="int32")
            pos_ids = layers.unsqueeze(pos, [1, 2])
            _, dec_outs, dec_logits = _cached_trunk(
                tokens, pos_ids, num_layers, num_heads, d_model, d_ff,
                vocab_size, max_len, "decode", pos=pos)
            if dec_outs != meta.cache_outs or \
                    dec_logits.name != meta.logits_name:
                raise RuntimeError(
                    "prefill/decode builds diverged — the two programs "
                    "must name their caches and logits identically")

    return prefill, decode, meta
