"""Beam-search decoding in the port (``beam_search_block``,
``BeamSearchDecoder``, ``build_seq2seq(mode="decode")``) against the
JAX package, on the CPU.

The counting decoder of ``tests/test_beam_search.py`` at beam 1 and 4,
top-K ties (the lower index first, as ``lax.top_k``), a StaticRNN memory
filled from ``batch_ref``, and the attention seq2seq decode at
``tests/test_beam_search.py``'s size (emb 8, hid 8, vocabularies 20 and
17, beam 3, max_len 5) from the JAX startup's weights, before and after
training in one scope (``tests/test_book.py``'s machine translation).

Tolerances: ids and lengths exactly; scores at rtol 1e-5 (float32 in
another summation order over up to 5 steps of log-softmax). Source
rows are of equal length where the packages are compared: the JAX
reverse GRU leaves position 0 of a shorter row at 0 (ROADMAP Queue 3),
and that position starts the decoder (``sequence_first_step``).
:func:`test_ragged_sources_show_the_reverse_encoder_mismatch` shows the
difference instead of hiding it."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import layers as jlayers
from paddle_tpu import unique_name as jnames
from paddle_tpu.models import seq2seq as jseq
from paddle_tpu_torch import interop
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import unique_name as tnames
from paddle_tpu_torch.models import seq2seq as tseq
from paddle_tpu_torch.ops.beam_search_ops import top_k_lower_index_first

_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, os.cpu_count() // int(_WORKERS)))

CPU = tfluid.CPUPlace()
V = 6  # the counting decoder's vocabulary; token 0 is bos and eos
SMALL = dict(src_vocab=20, tgt_vocab=17, emb_dim=8, hidden_dim=8)
RTOL = 1e-5


def _dump(prog):
    return json.dumps(prog.to_dict(), sort_keys=True, indent=1)


def _counting(fluid, layers, beam_size, max_len):
    """tests/test_beam_search.py's decoder: h' = h + 1, logits_v =
    2 v h' - v^2 (greedy emits 1, 2, 3, ...)."""
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        init_h = layers.fill_constant(shape=[2, 1], dtype="float32",
                                      value=0.0)
        dec = layers.BeamSearchDecoder(beam_size=beam_size, max_len=max_len,
                                       bos_id=0, eos_id=0,
                                       length_normalize=False)
        with dec.step():
            dec.token()
            h = dec.state(init_h)
            new_h = layers.increment(h, value=1.0, in_place=False)
            logits = layers.fc(new_h, V,
                               param_attr=fluid.ParamAttr(name="bs_toy_w"),
                               bias_attr=fluid.ParamAttr(name="bs_toy_b"))
            dec.update_state(h, new_h)
            dec.set_logits(logits)
        outs = dec()
    return prog, startup, outs


def _decode_both(build, weights, feed=None):
    """Build with ``build(fluid, layers)`` under each package's name
    guard, set ``weights`` ({name: array}, or the JAX startup's state
    when None) and run: {"jax"/"port": [ids, scores, lengths]}."""
    with jnames.guard():
        jprog, jstart, jouts = build(jfluid, jlayers)
    with tnames.guard():
        tprog, tstart, touts = build(tfluid, tlayers)
    assert _dump(tprog) == _dump(jprog)
    jscope = jfluid.Scope()
    jexe = jfluid.Executor()
    jexe.run(jstart, scope=jscope)
    for n, a in (weights or {}).items():
        jscope.set_var(n, a)
    arrays = {v.name: np.asarray(jscope.find_var(v.name))
              for v in jprog.list_vars() if v.persistable}
    tscope = tfluid.Scope()
    interop.load_reference_state(arrays, tscope, CPU, [tprog, tstart])
    j = jexe.run(jprog, feed=feed, fetch_list=[v.name for v in jouts],
                 scope=jscope)
    t = tfluid.Executor(CPU).run(tprog, feed=feed,
                                 fetch_list=[v.name for v in touts],
                                 scope=tscope)
    return {"jax": [np.asarray(a) for a in j], "port": t}


def _same_beams(out, rtol=RTOL):
    (ji, js, jl), (ti, ts, tl) = out["jax"], out["port"]
    assert ti.dtype == tl.dtype == np.int64 and ts.dtype == np.float32
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(ts, js, rtol=rtol)


def _toy_weights():
    v = np.arange(V, dtype=np.float32)
    return {"bs_toy_w": (10.0 * v)[None, :], "bs_toy_b": -5.0 * (v * v)}


@pytest.mark.parametrize("beam_size", [1, 4])
def test_counting_decoder_matches_jax(beam_size):
    out = _decode_both(lambda f, l: _counting(f, l, beam_size, 4),
                       _toy_weights())
    _same_beams(out)
    ids, scores, lengths = out["port"]
    assert ids.shape == (2, beam_size, 4)
    # the state evolves (a frozen carry would emit 1, 1, 1, 1)
    np.testing.assert_array_equal(ids[:, 0, :], [[1, 2, 3, 4]] * 2)
    assert np.all(np.diff(scores, axis=1) <= 0)


@pytest.mark.parametrize("beam_size,max_len", [(3, 3), (6, 2)])
def test_tied_candidates_are_taken_as_lax_top_k_takes_them(beam_size,
                                                           max_len):
    """All logits 0: every token ties at every step, and the dead beams
    of step 0 tie at -1e9 + log(1/V). The beams, their parents and their
    tokens follow lax.top_k's order (the lower index first)."""
    w = {"bs_toy_w": np.zeros((1, V), np.float32),
         "bs_toy_b": np.zeros((V,), np.float32)}
    out = _decode_both(lambda f, l: _counting(f, l, beam_size, max_len), w)
    _same_beams(out)


@pytest.mark.parametrize("seed", range(4))
def test_top_k_lower_index_first_equals_lax_top_k(seed):
    rng = np.random.RandomState(seed)
    # few distinct values: ties everywhere, negatives, -1e9 + small
    x = rng.randint(-3, 3, (5, 40)).astype(np.float32)
    x[:, ::7] = -1e9 + rng.randint(0, 3, (5, 6)).astype(np.float32)
    x[0] = -0.5
    for k in (1, 4, 9):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = top_k_lower_index_first(torch.tensor(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _memory_rnn(fluid, layers):
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        x = layers.data("x", [5, 3], dtype="float32")    # [B, T=5, 3]
        rnn = layers.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            h = rnn.memory(shape=[-1, 4], batch_ref=x, init_value=0.5)
            nh = layers.fc(layers.concat([xt, h], axis=1), 4, act="tanh",
                           param_attr=fluid.ParamAttr(name="rnn_w"),
                           bias_attr=fluid.ParamAttr(name="rnn_b"))
            rnn.update_memory(h, nh)
            rnn.step_output(nh)
        out = rnn()
    return prog, startup, [out]


def test_static_rnn_memory_from_batch_ref_matches_jax():
    """``memory(init=None, shape=, batch_ref=, init_value=)`` fills the
    initial state in the parent block (fill_constant_batch_size_like):
    the same JSON, the same outputs."""
    feed = {"x": np.random.RandomState(0).randn(3, 5, 3).astype(np.float32)}
    out = _decode_both(_memory_rnn, None, feed)
    np.testing.assert_allclose(out["port"][0], out["jax"][0], rtol=RTOL,
                               atol=1e-6)
    with tnames.guard():
        prog = _memory_rnn(tfluid, tlayers)[0]
    fill = [op for op in prog.global_block().ops
            if op.type == "fill_constant_batch_size_like"]
    assert len(fill) == 1 and fill[0].attr("value") == 0.5
    assert fill[0].attr("shape") == [1, 4]


def _decode_prog(beam_size=3, max_len=5):
    def build(fluid, layers):
        mod = jseq if fluid is jfluid else tseq
        prog, startup, _, outs = mod.build_seq2seq(
            mode="decode", beam_size=beam_size, max_len=max_len, **SMALL)
        return prog, startup, outs
    return build


def _sources(rng, lens):
    return [rng.randint(2, SMALL["src_vocab"], (n, 1)).astype(np.int64)
            for n in lens]


@pytest.mark.parametrize("seed", [0, 1])
def test_seq2seq_decode_matches_jax(seed):
    """Equal source lengths, the JAX startup's weights: ids and lengths
    identical, scores at rtol 1e-5; beams best first, ids past a beam's
    length equal eos."""
    feed = {"src_ids": _sources(np.random.RandomState(seed), [6] * 4)}
    out = _decode_both(_decode_prog(), None, feed)
    _same_beams(out)
    ids, scores, lengths = out["port"]
    assert ids.shape == (4, 3, 5) and scores.shape == lengths.shape == (4, 3)
    assert np.all(np.diff(scores, axis=1) <= 0)
    assert np.all((lengths >= 1) & (lengths <= 5))
    past = np.arange(5)[None, None, :] >= lengths[:, :, None]
    assert np.all(ids[past] == 1)


def test_decode_after_training_in_one_scope_matches_jax():
    """tests/test_book.py's machine translation: train 3 Adam steps, then
    decode with the trained weights from the same scope, shared by
    parameter name. Both packages from the JAX startup's weights."""
    rng = np.random.RandomState(4)
    src = _sources(rng, [5, 5])
    tgt = [rng.randint(2, SMALL["tgt_vocab"], (n, 1)).astype(np.int64)
           for n in (6, 4)]
    feed = {"src_ids": src, "tgt_ids": tgt,
            "tgt_next_ids": [np.roll(t, -1, 0) for t in tgt]}
    with jnames.guard():
        jtrain, jstart, _, (jloss,) = jseq.build_seq2seq(lr=5e-3, **SMALL)
        jdec, _, _, jouts = jseq.build_seq2seq(
            mode="decode", beam_size=3, max_len=6, **SMALL)
    with tnames.guard():
        ttrain, tstart, _, (tloss,) = tseq.build_seq2seq(lr=5e-3, **SMALL)
        tdec, _, _, touts = tseq.build_seq2seq(
            mode="decode", beam_size=3, max_len=6, **SMALL)
    assert _dump(tdec) == _dump(jdec)
    jscope, jexe = jfluid.Scope(), jfluid.Executor()
    jexe.run(jstart, scope=jscope)
    arrays = {v.name: np.asarray(jscope.find_var(v.name))
              for v in jtrain.list_vars() if v.persistable}
    tscope, texe = tfluid.Scope(), tfluid.Executor(CPU)
    interop.load_reference_state(arrays, tscope, CPU, [ttrain, tstart])
    jl = [float(np.asarray(jexe.run(jtrain, feed=feed, fetch_list=[
        jloss.name], scope=jscope)[0])) for _ in range(3)]
    tl = [float(texe.run(ttrain, feed=feed, fetch_list=[tloss],
                         scope=tscope)[0]) for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    dfeed = {"src_ids": src}
    j = jexe.run(jdec, feed=dfeed, fetch_list=[v.name for v in jouts],
                 scope=jscope)
    t = texe.run(tdec, feed=dfeed, fetch_list=list(touts), scope=tscope)
    _same_beams({"jax": [np.asarray(a) for a in j], "port": t}, rtol=1e-4)
    # the decode program's parameters are the training program's
    tparams = {p.name for p in tdec.global_block().all_parameters()}
    assert tparams <= {p.name for p in ttrain.global_block()
                       .all_parameters()}


def test_decode_program_loads_the_reference_state_alone():
    """``interop.load_reference_state`` takes a decode program's own
    persistables (its parameters), and refuses an incomplete set."""
    with tnames.guard():
        prog, startup, _, _ = tseq.build_seq2seq(mode="decode", **SMALL)
    want = {v.name: v for v in prog.list_vars() if v.persistable}
    arrays = {n: np.zeros(v.shape, np.float32) for n, v in want.items()}
    scope = tfluid.Scope()
    assert interop.load_reference_state(arrays, scope, CPU,
                                        [prog, startup]) == sorted(want)
    arrays.pop("tgt_emb")
    with pytest.raises(ValueError, match="tgt_emb"):
        interop.load_reference_state(arrays, tfluid.Scope(), CPU, prog)


def test_ragged_sources_show_the_reverse_encoder_mismatch():
    """Ragged sources: each of the port's beams equals that row decoded
    alone (batch independence), and the full-length row equals the JAX
    package's; the JAX package's shorter rows differ from their own solo
    decodes, since its reverse GRU zeroes position 0 of a short row and
    that position starts the decoder (ROADMAP Queue 3). Shown, not
    hidden."""
    lens = [6, 3, 4]
    srcs = _sources(np.random.RandomState(2), lens)
    batched = _decode_both(_decode_prog(), None, {"src_ids": srcs})
    _, ts, _ = batched["port"]
    _, js, _ = batched["jax"]
    np.testing.assert_allclose(ts[0], js[0], rtol=RTOL)
    for i, s in enumerate(srcs):
        solo = _decode_both(_decode_prog(), None, {"src_ids": [s]})
        np.testing.assert_array_equal(batched["port"][0][i],
                                      solo["port"][0][0])
        np.testing.assert_allclose(ts[i], solo["port"][1][0], rtol=RTOL)
        if i == 0:
            np.testing.assert_allclose(js[0], solo["jax"][1][0], rtol=RTOL)
        else:
            # the JAX package's batched score of a short row is not its
            # solo score; the port's solo and batched scores agree
            assert np.max(np.abs(js[i] - solo["jax"][1][0])) > 1e-4
