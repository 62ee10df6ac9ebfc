"""Attention seq2seq (NMT): the training graph.

Capability parity: the machine_translation book model (bi-GRU encoder,
Bahdanau-attention GRU decoder trained with teacher forcing) and
`benchmark/fluid/machine_translation.py`. The JAX package's
``models/seq2seq.py``, name for name: the train decoder is a StaticRNN
step (one ``scan_block`` op), attention is a dense masked softmax over
the padded encoder states, and the vocabulary projection runs once over
all steps outside the loop. The beam-search decode of the same model
arrives with a later slice.
"""

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers

__all__ = ["seq2seq_train", "build_seq2seq"]


def _encoder(src_ids, src_vocab, emb_dim, hidden_dim):
    emb = layers.embedding(src_ids, size=[src_vocab, emb_dim],
                           param_attr=fluid.ParamAttr(name="src_emb"))
    fwd_proj = layers.fc(emb, hidden_dim * 3, num_flatten_dims=2,
                         param_attr=fluid.ParamAttr(name="enc_fw_proj"),
                         bias_attr=False)
    fwd = layers.dynamic_gru(fwd_proj, hidden_dim,
                             param_attr=fluid.ParamAttr(name="enc_fw_gru"),
                             bias_attr=fluid.ParamAttr(name="enc_fw_gru_b"))
    bwd_proj = layers.fc(emb, hidden_dim * 3, num_flatten_dims=2,
                         param_attr=fluid.ParamAttr(name="enc_bw_proj"),
                         bias_attr=False)
    bwd = layers.dynamic_gru(bwd_proj, hidden_dim, is_reverse=True,
                             param_attr=fluid.ParamAttr(name="enc_bw_gru"),
                             bias_attr=fluid.ParamAttr(name="enc_bw_gru_b"))
    enc = layers.concat([fwd, bwd], axis=-1)  # [B,Ts,2H] packed
    # decoder init state: first step of the backward encoder
    enc_last = layers.sequence_first_step(bwd)  # [B,H]
    init_state = layers.fc(enc_last, hidden_dim, act="tanh",
                           param_attr=fluid.ParamAttr(name="dec_init_w"),
                           bias_attr=fluid.ParamAttr(name="dec_init_b"))
    return enc, init_state


def _attention(dec_state, enc_dense, enc_proj, enc_mask, hidden_dim):
    """Bahdanau: score = v . tanh(W_enc h_enc + W_dec h_dec)."""
    dec_proj = layers.fc(dec_state, hidden_dim,
                         param_attr=fluid.ParamAttr(name="att_dec_w"),
                         bias_attr=False)  # [B,H]
    mix = layers.tanh(
        layers.elementwise_add(enc_proj, layers.unsqueeze(dec_proj, [1]),
                               axis=0))  # [B,Ts,H]
    scores = layers.fc(mix, 1, num_flatten_dims=2,
                       param_attr=fluid.ParamAttr(name="att_v"),
                       bias_attr=False)  # [B,Ts,1]
    scores = layers.squeeze(scores, [2])  # [B,Ts]
    neg = layers.scale(layers.elementwise_sub(enc_mask,
                                              layers.ones_like(enc_mask)),
                       scale=1e9)
    scores = layers.elementwise_add(scores, neg)
    att = layers.softmax(scores)  # [B,Ts]
    ctx = layers.reduce_sum(
        layers.elementwise_mul(enc_dense, layers.unsqueeze(att, [2])),
        dim=[1])  # [B,2H]
    return ctx


def _decoder_cell(cur_emb, ctx, state, hidden_dim):
    inp = layers.concat([cur_emb, ctx], axis=-1)
    gate_in = layers.fc(inp, hidden_dim * 3,
                        param_attr=fluid.ParamAttr(name="dec_gru_in_w"),
                        bias_attr=fluid.ParamAttr(name="dec_gru_in_b"))
    new_state, _, _ = layers.gru_unit(
        gate_in, state, hidden_dim * 3,
        param_attr=fluid.ParamAttr(name="dec_gru_w"),
        bias_attr=fluid.ParamAttr(name="dec_gru_b"))
    return new_state


def _out_logits(state, ctx, vocab, num_flatten_dims=1):
    feat = layers.concat([state, ctx], axis=-1)
    return layers.fc(feat, vocab, num_flatten_dims=num_flatten_dims,
                     param_attr=fluid.ParamAttr(name="dec_out_w"),
                     bias_attr=fluid.ParamAttr(name="dec_out_b"))


def seq2seq_train(src_vocab, tgt_vocab, emb_dim=32, hidden_dim=32):
    """Builds the teacher-forced training graph; returns (feeds, avg_cost)."""
    src = layers.data("src_ids", [1], dtype="int64", lod_level=1)
    tgt = layers.data("tgt_ids", [1], dtype="int64", lod_level=1)
    tgt_next = layers.data("tgt_next_ids", [1], dtype="int64", lod_level=1)

    enc, init_state = _encoder(src, src_vocab, emb_dim, hidden_dim)
    enc_dense, _ = layers.sequence_pad(enc)           # [B,Ts,2H]
    enc_mask = layers.cast(layers.sequence_mask(enc), "float32")  # [B,Ts]
    enc_proj = layers.fc(enc_dense, hidden_dim, num_flatten_dims=2,
                         param_attr=fluid.ParamAttr(name="att_enc_w"),
                         bias_attr=False)             # [B,Ts,H]

    tgt_emb = layers.embedding(tgt, size=[tgt_vocab, emb_dim],
                               param_attr=fluid.ParamAttr(name="tgt_emb"))

    rnn = layers.StaticRNN()
    with rnn.step():
        cur_emb = rnn.step_input(tgt_emb)
        state = rnn.memory(init=init_state)
        ctx = _attention(state, enc_dense, enc_proj, enc_mask, hidden_dim)
        new_state = _decoder_cell(cur_emb, ctx, state, hidden_dim)
        rnn.update_memory(state, new_state)
        rnn.step_output(new_state)
        rnn.step_output(ctx)
    states, ctxs = rnn()  # PackedSeq [B,Tt,H], [B,Tt,2H]

    # the vocabulary projection and softmax run once over every step,
    # outside the per-step loop: one [B*Tt, 3H] x [3H, V] product
    logits = _out_logits(states, ctxs, tgt_vocab, num_flatten_dims=2)
    probs = layers.softmax(logits)

    cost = layers.cross_entropy(probs, tgt_next)  # packed [B,Tt,1]
    avg_cost = layers.mean(layers.sequence_pool(cost, pool_type="sum"))
    return [src.name, tgt.name, tgt_next.name], avg_cost


def build_seq2seq(src_vocab, tgt_vocab, emb_dim=32, hidden_dim=32,
                  mode="train", beam_size=4, max_len=16, bos_id=0, eos_id=1,
                  lr=1e-3):
    """(main_program, startup_program, feed_names, fetch_vars) for the
    NMT config (reference benchmark/fluid/machine_translation.py shape).
    ``mode`` "train" is the teacher-forced graph with Adam; "decode"
    (beam search) arrives with a later slice and raises."""
    if mode != "train":
        raise NotImplementedError(
            "build_seq2seq(mode=%r): the beam-search decode (while, "
            "beam_search) arrives with the beam-search decode slice; "
            "only mode='train' is ported" % (mode,))
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        feeds, avg_cost = seq2seq_train(src_vocab, tgt_vocab, emb_dim,
                                        hidden_dim)
        fluid.optimizer.Adam(lr).minimize(avg_cost)
    return prog, startup, feeds, (avg_cost,)
