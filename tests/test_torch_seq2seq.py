"""The seq2seq (NMT) training slice end to end on the CPU: the port's
attention seq2seq and a small StaticRNN, built by append_backward and
Adam in both packages, trained from the same weights (the JAX startup's
scope carried over by ``interop.load_reference_state``) on the same
seeded batches.

Tolerances: losses of 3 Adam steps within rtol 1e-5 and the first
step's gradients of all 19 parameters within rtol 1e-4, atol 1e-6 (fp32
math in another summation order; XLA fuses and reorders the JAX side).

Source rows are of equal length where the packages are compared: on a
shorter source row the JAX package's reverse GRU leaves position 0 at 0
(ROADMAP Queue 3), and position 0 of the reverse encoder is the
decoder's initial state. Ragged sources are held against a numpy step
reference instead."""

import os

import numpy as np
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import layers as jlayers
from paddle_tpu import unique_name as jnames
from paddle_tpu.models import seq2seq as jseq
from paddle_tpu_torch import interop
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import unique_name as tnames
from paddle_tpu_torch.kernels import gru_cell
from paddle_tpu_torch.models import seq2seq as tseq

# Under pytest-xdist each worker takes its share of the cores for
# torch's intra-op threads: six workers at torch's default thread count
# oversubscribe the cores, and a test of seconds then takes minutes.
_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, os.cpu_count() // int(_WORKERS)))

CPU = tfluid.CPUPlace()
# tools/goldens.py's size
SMALL = dict(src_vocab=50, tgt_vocab=50, emb_dim=16, hidden_dim=16)
B = 4


def _pair(jbuild, tbuild):
    """Both packages' programs, the JAX weights and a port scope holding
    the same state."""
    with jnames.guard():
        jprog, jstart, feeds, jfetch = jbuild(jfluid, jlayers)
    with tnames.guard():
        tprog, tstart, _, tfetch = tbuild(tfluid, tlayers)
    jscope = jfluid.Scope()
    jexe = jfluid.Executor()
    jexe.run(jstart, scope=jscope)
    arrays = {v.name: np.asarray(jscope.find_var(v.name))
              for v in jprog.list_vars() if v.persistable}
    tscope = tfluid.Scope()
    interop.load_reference_state(arrays, tscope, CPU, [tprog, tstart])
    return dict(jprog=jprog, jexe=jexe, jscope=jscope, jfetch=jfetch,
                tprog=tprog, texe=tfluid.Executor(CPU), tscope=tscope,
                tfetch=tfetch, feeds=feeds)


def _seq2seq(fluid, layers):
    mod = jseq if fluid is jfluid else tseq
    prog, startup, feeds, (loss,) = mod.build_seq2seq(**SMALL)
    return prog, startup, feeds, [loss]


def _batch(rng, src_lens, tgt_lens):
    src = [rng.randint(2, SMALL["src_vocab"], (n, 1)).astype(np.int64)
           for n in src_lens]
    tgt = [rng.randint(2, SMALL["tgt_vocab"], (n, 1)).astype(np.int64)
           for n in tgt_lens]
    # tgt_next is tgt shifted by one (tests/test_book.py)
    return {"src_ids": src, "tgt_ids": tgt,
            "tgt_next_ids": [np.roll(t, -1, axis=0) for t in tgt]}


def _train_and_compare(m, feed, steps=3):
    params = sorted(p.name for p in m["jprog"].global_block().all_parameters())
    grads = [p + "@GRAD" for p in params]
    jl, tl = [], []
    for step in range(steps):
        # the same fetch list every step: the JAX executor compiles once
        jout = m["jexe"].run(m["jprog"], feed=feed,
                             fetch_list=[v.name for v in m["jfetch"]] + grads,
                             scope=m["jscope"])
        tout = m["texe"].run(m["tprog"], feed=feed,
                             fetch_list=[v.name for v in m["tfetch"]] + grads,
                             scope=m["tscope"])
        jl.append(float(np.asarray(jout[0])))
        tl.append(float(tout[0]))
        if step:
            continue
        for name, jg, tg in zip(grads, jout[len(m["jfetch"]):],
                                tout[len(m["tfetch"]):]):
            np.testing.assert_allclose(tg, np.asarray(jg), rtol=1e-4,
                                       atol=1e-6, err_msg=name)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert np.isfinite(tl).all()
    return params, tl


def test_seq2seq_steps_match_jax():
    """Equal source lengths (both GRU directions, the bi-GRU encoder's
    every position compared), ragged targets with a row of one token
    (the StaticRNN decoder carries finished rows)."""
    m = _pair(_seq2seq, _seq2seq)
    feed = _batch(np.random.RandomState(7), [7] * B, [6, 3, 7, 1])
    params, losses = _train_and_compare(m, feed)
    assert len(params) == 19
    assert losses[-1] < losses[0]


def _np_reverse_gru_first(x, w, b, lens):
    """Position 0 of a reverse GRU over each row's valid prefix (numpy)."""
    H = w.shape[0]
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))
    out = np.zeros((len(lens), H))
    for row, n in enumerate(lens):
        h = np.zeros(H)
        for p in range(n - 1, -1, -1):
            g = x[row, p] + b[0]
            u = sig(g[:H] + h @ w[:, :H])
            r = sig(g[H:2 * H] + h @ w[:, H:2 * H])
            c = np.tanh(g[2 * H:] + (r * h) @ w[:, 2 * H:])
            h = u * h + (1 - u) * c
        out[row] = h
    return out


def test_ragged_sources_start_the_decoder_from_the_encoder():
    """With sources of lengths [7, 3, 5, 1] the port's decoder starts
    every row from tanh(fc(position 0 of the reverse encoder)), as a
    numpy step reference computes it; the JAX package starts the short
    rows from tanh(dec_init_b), and agrees on the full row."""
    m = _pair(_seq2seq, _seq2seq)
    lens = [7, 3, 5, 1]
    feed = _batch(np.random.RandomState(3), lens, [4, 2, 5, 3])
    # the weights before the step's Adam update
    s = {n: m["tscope"].find_var(n).numpy().astype(np.float64)
         for n in ("src_emb", "enc_bw_proj", "enc_bw_gru", "enc_bw_gru_b",
                   "dec_init_w", "dec_init_b")}
    init = [op for op in m["tprog"].global_block().ops
            if op.type == "tanh"][0].output("Out")[0]
    t_init, = m["texe"].run(m["tprog"], feed=feed, fetch_list=[init],
                            scope=m["tscope"])
    j_init, = m["jexe"].run(m["jprog"], feed=feed, fetch_list=[init],
                            scope=m["jscope"])
    x = np.zeros((B, max(lens), 3 * SMALL["hidden_dim"]))
    for row, ids in enumerate(feed["src_ids"]):
        x[row, :len(ids)] = s["src_emb"][ids[:, 0]] @ s["enc_bw_proj"]
    first = _np_reverse_gru_first(x, s["enc_bw_gru"], s["enc_bw_gru_b"], lens)
    want = np.tanh(first @ s["dec_init_w"] + s["dec_init_b"])
    np.testing.assert_allclose(t_init, want, rtol=1e-5, atol=1e-6)
    j_init = np.asarray(j_init)
    np.testing.assert_allclose(j_init[0], want[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(j_init[1:], np.tanh(np.broadcast_to(
        s["dec_init_b"], (B - 1, SMALL["hidden_dim"]))), rtol=1e-5,
        atol=1e-6)


def _static_rnn(fluid, layers):
    """A small StaticRNN over a ragged sequence: h = tanh(fc([x_t, h]))
    from an fc of a dense input; the loss reads the stacked outputs and
    the final state."""
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        seq = layers.data("seq", [3], lod_level=1)
        ctx = layers.data("ctx", [4])
        h0 = layers.fc(ctx, 5, act="tanh")
        rnn = layers.StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(seq)
            h = rnn.memory(init=h0)
            new_h = layers.fc(layers.concat([x_t, h], axis=-1), 5,
                              act="tanh")
            rnn.update_memory(h, new_h)
            rnn.step_output(new_h)
        out = rnn()
        last = rnn.final_states[0]
        loss = layers.elementwise_add(
            layers.mean(layers.sequence_pool(out, "sum")),
            layers.mean(layers.scale(last, scale=0.5)))
        fluid.optimizer.Adam(1e-2).minimize(loss)
    return prog, startup, ["seq", "ctx"], [loss, out, last]


def test_static_rnn_matches_jax():
    """The program serializes identically, and the stacked outputs, the
    final state (finished rows keep their carry) and every gradient
    agree over 3 Adam steps."""
    m = _pair(_static_rnn, _static_rnn)
    dump = lambda p: p.to_json()
    assert dump(m["tprog"]) == dump(m["jprog"])
    rng = np.random.RandomState(1)
    feed = {"seq": [rng.randn(n, 3).astype(np.float32) for n in (4, 1, 3)],
            "ctx": rng.randn(3, 4).astype(np.float32)}
    for step in range(3):
        jout = m["jexe"].run(m["jprog"], feed=feed,
                             fetch_list=[v.name for v in m["jfetch"]],
                             scope=m["jscope"])
        tout = m["texe"].run(m["tprog"], feed=feed,
                             fetch_list=[v.name for v in m["tfetch"]],
                             scope=m["tscope"])
        np.testing.assert_allclose(tout[0], np.asarray(jout[0]), rtol=1e-5)
        assert isinstance(tout[1], tfluid.PackedSeq)
        assert tout[1].lengths.tolist() == [4, 1, 3]
        np.testing.assert_allclose(tout[1].data, np.asarray(jout[1].data),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tout[2], np.asarray(jout[2]), rtol=1e-5,
                                   atol=1e-6)


def test_port_startup_trains_on_ragged_batches_without_launches_on_cpu():
    """The port's own startup (its own random weights), ragged sources
    and targets fed as lists: the loss falls, and on the CPU the GRU runs
    its plain versions, so no kernel launch is counted."""
    with tnames.guard():
        prog, startup, feeds, (loss,) = tseq.build_seq2seq(**SMALL)
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    feed = _batch(np.random.RandomState(0), [5, 2, 8, 1], [3, 6, 1, 4])
    gru_cell.reset_launches()
    out = [exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)[0]
           for _ in range(4)]
    assert np.isfinite(out).all() and out[-1] < out[0]
    assert gru_cell.launches == {"gru_fwd": 0, "gru_bwd": 0,
                                 "gru_fwd_bf16": 0, "gru_bwd_bf16": 0}
