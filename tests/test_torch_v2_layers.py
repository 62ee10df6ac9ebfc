"""The v2 layer DSL's breadth (``paddle_tpu_torch.v2.layer`` and
``networks``) against paddle_tpu's, on the CPU, case for case as
``tests/test_v2_breadth.py`` builds them: each case builds the same
program in both packages (byte-identical JSON, main and startup), runs
the startup in paddle_tpu, carries every persistable value to the port
(``interop.load_reference_state``), then runs the program in both from
the same feed: one forward, or, where the JAX test trains, as many
steps as it takes (each step's fetches compared). Floats agree within
rtol 1e-5 + 1e-6 of each output's largest magnitude, integers and
sequence lengths exactly.

Rows fed to a reverse LSTM are of equal length: paddle_tpu's reverse
LSTM loses position 0 of short reverse rows (ROADMAP.md Queue 3)."""

import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.v2 as jv2
import paddle_tpu_torch as tfluid
import paddle_tpu_torch.v2 as tv2
from paddle_tpu_torch import interop

_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, os.cpu_count() // int(_WORKERS)))

CPU = tfluid.CPUPlace()


class NS:
    """One package's names as the cases use them."""

    def __init__(self, fluid, v2):
        self.fluid, self.L = fluid, fluid.layers
        self.v2l, self.dt, self.act = v2.layer, v2.data_type, v2.activation
        self.nets, self.pool = v2.networks, v2.pooling


JAX, PORT = NS(jfluid, jv2), NS(tfluid, tv2)


def ids(vocab, lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, (n,)).astype(np.int64) for n in lens]


def rnn_with_memory(p):
    words = p.v2l.data("words", p.dt.integer_value_sequence(40))
    label = p.v2l.data("label", p.dt.integer_value(3))
    emb = p.v2l.embedding(words, size=8)

    def step(x):
        mem = p.v2l.memory(name="h", size=8)
        return p.v2l.fc([x, mem], size=8, act=p.act.Tanh(), name="h")

    out = p.v2l.recurrent_group(step=step, input=emb)
    pred = p.v2l.fc(p.v2l.last_seq(out), size=3, act=p.act.Softmax())
    cost = p.v2l.classification_cost(pred, label)
    p.fluid.optimizer.SGD(0.5).minimize(cost)
    return [cost]


def mixed_full_identity(p):
    x = p.v2l.data("x", p.dt.dense_vector(6))
    return [p.v2l.mixed(size=6, input=[
        p.v2l.full_matrix_projection(x, size=6),
        p.v2l.identity_projection(x)])]


def dotmul_context(p):
    x = p.v2l.data("x", p.dt.dense_vector(4))
    seq = p.v2l.data("seq", p.dt.dense_vector_sequence(4))
    return [p.v2l.mixed(size=4, input=[p.v2l.dotmul_projection(x)]),
            p.v2l.mixed(size=12, input=[p.v2l.context_projection(
                seq, context_len=3)])]


def conv_pool_bidi_lstm(p):
    words = p.v2l.data("words", p.dt.integer_value_sequence(30))
    emb = p.v2l.embedding(words, size=8)
    return [p.nets.sequence_conv_pool(emb, context_len=3, hidden_size=10),
            p.v2l.pooling(p.nets.bidirectional_lstm(emb, size=6)),
            p.nets.simple_gru(emb, size=5)]


def elementwise_and_costs(p):
    a = p.v2l.data("a", p.dt.dense_vector(5))
    b = p.v2l.data("b", p.dt.dense_vector(5))
    lab = p.v2l.data("lab", p.dt.dense_vector(1))
    return [p.v2l.addto([a, b]), p.v2l.cos_sim(a, b),
            p.v2l.slope_intercept(a, slope=2.0, intercept=1.0),
            p.v2l.sum_to_one_norm(p.v2l.slope_intercept(a, 0.0, 1.0)),
            p.v2l.rank_cost(p.v2l.fc(a, size=1), p.v2l.fc(b, size=1), lab)]


def math_family(p):
    a = p.v2l.data("a", p.dt.dense_vector(4))
    b = p.v2l.data("b", p.dt.dense_vector(4))
    return [p.v2l.clip(a, min=0.2, max=0.8), p.v2l.dot_prod(a, b),
            p.v2l.l2_distance(a, b), p.v2l.out_prod(a, b),
            p.v2l.row_l2_norm(a), p.v2l.repeat(a, 2), p.v2l.resize(a, 2)]


def learned_params(p):
    a = p.v2l.data("a", p.dt.dense_vector(6))
    h = p.v2l.gated_unit(p.v2l.scale_shift(a), 6)
    fm = p.v2l.factorization_machine(a, 3)
    t = p.v2l.tensor(a, a, 4)
    lc = p.v2l.linear_comb(p.v2l.fc(a, 2), p.v2l.fc(a, 6), 3)
    cost = p.v2l.sum_cost(p.v2l.square_error_cost(
        p.v2l.fc([h, fm, t, lc], 1), p.v2l.fc(a, 1)))
    p.fluid.optimizer.SGD(0.01).minimize(cost)
    return [cost]


def image_family(p):
    a = p.L.data("img", [3, 8, 8])
    return [p.v2l.maxout(p.v2l.prelu(a), 3), p.v2l.spp(a, 2),
            p.v2l.pad(a, pad_h=[1, 1], pad_w=[1, 1]),
            p.v2l.upsample(a, scale=2), p.v2l.bilinear_interp(a, 4, 4),
            p.v2l.switch_order(a, [0, 2, 3, 1]),
            p.v2l.cross_channel_norm(a),
            p.v2l.img_pool3d(p.L.reshape(a, [-1, 1, 3, 8, 8]), 2, stride=2)]


def seq_family(p):
    words = p.v2l.data("w", p.dt.integer_value_sequence(20))
    emb = p.v2l.embedding(words, size=4)
    return [p.v2l.seq_reshape(emb, 8),
            p.v2l.kmax_seq_score(p.v2l.fc(emb, 1), beam_size=2),
            p.v2l.eos(words, eos_id=19)]


def recurrent_layer(p):
    words = p.v2l.data("w", p.dt.integer_value_sequence(30))
    rec = p.v2l.recurrent(p.v2l.embedding(words, size=6), name="rl")
    pred = p.v2l.fc(p.v2l.last_seq(rec), size=2, act=p.act.Softmax())
    cost = p.v2l.classification_cost(
        pred, p.v2l.data("y", p.dt.integer_value(2)))
    p.fluid.optimizer.SGD(0.1).minimize(cost)
    return [cost]


def beam_search(p):
    vocab, dim = 12, 8
    src = p.v2l.data("src", p.dt.integer_value_sequence(vocab))
    enc = p.v2l.last_seq(p.v2l.embedding(src, size=dim))

    def step(cur_emb, context):
        prev = p.v2l.memory(name="dec_h", size=dim, boot_layer=enc)
        gates = p.v2l.fc([cur_emb, prev], size=3 * dim, bias_attr=True)
        h = p.v2l.gru_step(gates, prev, name="dec_h")
        p.v2l._register_name("dec_h", h)
        return p.v2l.fc(h, size=vocab, act=p.act.Softmax())

    return list(p.v2l.beam_search(
        step=step, input=[p.v2l.GeneratedInput(size=vocab,
                                               embedding_size=dim),
                          p.v2l.StaticInput(enc)],
        bos_id=0, eos_id=1, beam_size=4, max_length=6))


def sub_region_lambda(p):
    a = p.L.data("img", [3, 4, 4])
    scores = p.v2l.data("s", p.dt.dense_vector_sequence(1))
    rel = p.v2l.data("r", p.dt.dense_vector_sequence(1))
    return [p.v2l.scale_sub_region(a, [2, 3, 2, 3, 2, 3], 2.0),
            p.v2l.lambda_cost(scores, rel)]


def multi_binary_ce(p):
    return [p.v2l.multi_binary_label_cross_entropy(p.L.data("p", [6]),
                                                   p.L.data("y", [6]))]


def ssd_pipeline(p):
    L = p.L
    pv = p.v2l.priorbox(L.data("feat", [8, 4, 4]), L.data("im", [3, 32, 32]),
                        min_size=[8.0], max_size=[16.0],
                        aspect_ratio=[1.0, 2.0])
    loc = L.unsqueeze(L.data("loc", [-1, 4], append_batch_size=False), [0])
    conf = L.unsqueeze(L.data("conf", [-1, 5], append_batch_size=False),
                       [0])
    gtb = L.data("gtb", [2, 4], append_batch_size=False)
    gtl = L.data("gtl", [2, 1], dtype="int64", append_batch_size=False)
    return [p.v2l.multibox_loss(loc, conf, L.unsqueeze(gtb, [0]),
                                L.unsqueeze(gtl, [0]), pv),
            p.v2l.detection_output(loc, conf, pv)]


def lstm_step(p):
    h, c = p.v2l.lstm_step(p.L.data("g", [12]), p.L.data("c0", [3]), size=3)
    return [h, c]


def huber_classification(p):
    """The JAX test's ``calc_gradient`` is ``append_backward`` here: the
    port has no ``calc_gradient`` yet (ROADMAP.md Queue 1 item 3)."""
    x = p.L.data("x", [1])
    x.stop_gradient = False
    cost = p.v2l.huber_classification_cost(x, p.L.data("lab", [1]))
    p.fluid.append_backward(cost)
    return [cost, x.block.var("x@GRAD")]


def kmax_negative(p):
    return [p.v2l.kmax_seq_score(
        p.v2l.data("s", p.dt.dense_vector_sequence(1)), beam_size=2)]


def cross_entropy_over_beam(p):
    scores = p.v2l.data("scores", p.dt.dense_vector(5))
    gold = p.v2l.data("gold", p.dt.integer_value(5))
    seqs = p.v2l.data("seqs", p.dt.dense_vector(3))
    sel = p.v2l.data("sel", p.dt.integer_value(8))
    return [p.v2l.cross_entropy_over_beam(
                p.v2l.BeamInput(scores, scores, gold)),
            p.v2l.sub_nested_seq_layer(seqs, sel)]


def grumemory_regression(p):
    seq = p.v2l.data("seq", p.dt.dense_vector_sequence(6))
    g = p.v2l.grumemory(seq, size=4)
    pred = p.v2l.fc(p.v2l.pooling(g, pooling_type=p.pool.Max()), size=1)
    return [p.v2l.regression_cost(pred, p.v2l.data("tgt",
                                                   p.dt.dense_vector(1)))]


def _rand(seed):
    return np.random.RandomState(seed)


# name -> (build, feed, steps)
CASES = {
    "rnn_with_memory": (rnn_with_memory, lambda: {
        "words": ids(40, [5, 3, 6]),
        "label": np.array([[0], [1], [2]], np.int64)}, 5),
    "mixed_full_identity": (mixed_full_identity, lambda: {
        "x": _rand(0).rand(2, 6).astype(np.float32)}, 1),
    "dotmul_context": (dotmul_context, lambda: {
        "x": _rand(1).rand(2, 4).astype(np.float32),
        "seq": [_rand(1).rand(4, 4).astype(np.float32),
                _rand(2).rand(2, 4).astype(np.float32)]}, 1),
    "conv_pool_bidi_lstm": (conv_pool_bidi_lstm, lambda: {
        "words": ids(30, [6, 6])}, 1),
    "elementwise_and_costs": (elementwise_and_costs, lambda: {
        "a": _rand(2).rand(3, 5).astype(np.float32),
        "b": _rand(3).rand(3, 5).astype(np.float32),
        "lab": np.ones((3, 1), np.float32)}, 1),
    "math_family": (math_family, lambda: {
        "a": _rand(0).rand(3, 4).astype(np.float32),
        "b": _rand(1).rand(3, 4).astype(np.float32)}, 1),
    "learned_params": (learned_params, lambda: {
        "a": _rand(2).rand(4, 6).astype(np.float32)}, 2),
    "image_family": (image_family, lambda: {
        "img": _rand(3).rand(2, 3, 8, 8).astype(np.float32)}, 1),
    "seq_family": (seq_family, lambda: {
        "w": [np.array([3, 5, 19, 7], np.int64),
              ids(20, [6], seed=4)[0]]}, 1),
    "recurrent_layer": (recurrent_layer, lambda: {
        "w": ids(30, [3, 5], seed=5),
        "y": np.array([[0], [1]], np.int64)}, 2),
    "beam_search": (beam_search, lambda: {
        "src": ids(12, [3, 5], seed=6)}, 1),
    "sub_region_lambda": (sub_region_lambda, lambda: {
        "img": _rand(7).rand(2, 3, 4, 4).astype(np.float32),
        "s": [_rand(8).rand(4, 1).astype(np.float32),
              _rand(9).rand(3, 1).astype(np.float32)],
        "r": [_rand(10).randint(0, 3, (4, 1)).astype(np.float32),
              _rand(11).randint(0, 3, (3, 1)).astype(np.float32)]}, 1),
    "multi_binary_ce": (multi_binary_ce, lambda: {
        "p": _rand(11).uniform(0.05, 0.95, (4, 6)).astype(np.float32),
        "y": (_rand(12).rand(4, 6) > 0.5).astype(np.float32)}, 1),
    "ssd_pipeline": (ssd_pipeline, lambda: {
        "feat": _rand(9).rand(1, 8, 4, 4).astype(np.float32),
        "im": _rand(9).rand(1, 3, 32, 32).astype(np.float32),
        "loc": _rand(10).randn(48, 4).astype(np.float32) * 0.1,
        "conf": _rand(11).randn(48, 5).astype(np.float32),
        "gtb": np.array([[0.1, 0.1, 0.4, 0.4], [0.5, 0.5, 0.9, 0.9]],
                        np.float32),
        "gtl": np.array([[1], [3]], np.int64)}, 1),
    "lstm_step": (lstm_step, lambda: {
        "g": _rand(10).randn(2, 12).astype(np.float32),
        "c0": _rand(11).randn(2, 3).astype(np.float32)}, 1),
    "huber_classification": (huber_classification, lambda: {
        "x": np.array([[-5.0], [0.3], [2.0]], np.float32),
        "lab": np.array([[1.0], [0.0], [1.0]], np.float32)}, 1),
    "kmax_negative": (kmax_negative, lambda: {
        "s": [np.array([[-1.], [-2.], [-3.], [-4.]], np.float32),
              np.array([[-9.], [-8.]], np.float32)]}, 1),
    "cross_entropy_over_beam": (cross_entropy_over_beam, lambda: {
        "scores": _rand(0).rand(4, 5).astype(np.float32),
        "gold": _rand(1).randint(0, 5, (4, 1)).astype(np.int64),
        "seqs": _rand(2).rand(8, 3).astype(np.float32),
        "sel": np.array([[2], [0]], np.int64)}, 1),
    "grumemory_regression": (grumemory_regression, lambda: {
        "seq": [_rand(0).rand(5, 6).astype(np.float32),
                _rand(1).rand(3, 6).astype(np.float32)],
        "tgt": _rand(2).rand(2, 1).astype(np.float32)}, 1),
}


def build(p, fn):
    with p.fluid.unique_name.guard():
        prog, startup = p.fluid.Program(), p.fluid.Program()
        with p.fluid.program_guard(prog, startup):
            outs = fn(p)
    return prog, startup, outs


def dump(prog):
    return json.dumps(prog.to_dict(), sort_keys=True, indent=1)


def host(v):
    """A fetch as numpy: a PackedSeq as (data, lengths)."""
    if hasattr(v, "lengths"):
        return host(v.data), host(v.lengths)
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def agree(got, want, what):
    if isinstance(want, tuple):
        agree(got[0], want[0], what + " data")
        np.testing.assert_array_equal(got[1], want[1], err_msg=what)
        return
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    amax = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * amax,
                               err_msg=what)


@pytest.mark.parametrize("case", sorted(CASES))
def test_v2_layers_match_the_jax_package(case):
    fn, feed_fn, steps = CASES[case]
    jp, js, jo = build(JAX, fn)
    tp, ts, to = build(PORT, fn)
    assert dump(tp) == dump(jp)
    assert dump(ts) == dump(js)
    jscope, jexe = jfluid.Scope(), jfluid.Executor()
    jexe.run(js, scope=jscope)
    arrays = {v.name: np.asarray(jscope.find_var(v.name))
              for v in jp.list_vars() if v.persistable}
    tscope, texe = tfluid.Scope(), tfluid.Executor(CPU)
    interop.load_reference_state(arrays, tscope, CPU, [tp, ts])
    feed = feed_fn()
    names = [o.name for o in jo]
    for step in range(steps):
        j = jexe.run(jp, feed=feed, fetch_list=names, scope=jscope,
                     return_numpy=False)
        t = texe.run(tp, feed=feed, fetch_list=names, scope=tscope,
                     return_numpy=False)
        for n, a, b in zip(names, j, t):
            agree(host(b), host(a), "%s step %d %s" % (case, step, n))
    for n in arrays:
        agree(host(tscope.find_var(n)), host(jscope.find_var(n)),
              "%s state %s" % (case, n))


def test_memory_without_producer_errors():
    with tfluid.program_guard(tfluid.Program(), tfluid.Program()):
        emb = tv2.layer.embedding(tv2.layer.data(
            "w2", tv2.data_type.integer_value_sequence(10)), size=4)

        def step(x):
            tv2.layer.memory(name="nope", size=4)
            return tv2.layer.fc(x, size=4)

        with pytest.raises(ValueError, match="nope"):
            tv2.layer.recurrent_group(step=step, input=emb)
        with pytest.raises(ValueError, match="only valid inside"):
            tv2.layer.memory(name="h", size=4)


def test_base_generated_input_isinstance():
    assert isinstance(tv2.layer.GeneratedInput(size=10),
                      tv2.layer.BaseGeneratedInput)
    assert tv2.layer.LayerOutput is tfluid.Variable
