"""The port's program IR serializes exactly as the JAX package's: every
golden program round-trips byte-identically through the port's
``from_json``; the transformer builds, the stacked-LSTM and seq2seq
training programs (append_backward + Adam; seq2seq's StaticRNN
sub-block and scan_block_grad), the transformer LM's training program
(next-token softmax cross-entropy, Adam) at the golden's size and at
bench.py's width, the MNIST MLP and LeNet training programs and the
ResNet-50 training program (Momentum) give the same JSON in both
packages; LeNet under AMP, VGG-16, AlexNet, GoogLeNet, SmallNet and
the word-embedding model build their goldens; the seq2seq beam-search
decode and the counting decoder give the same JSON in both packages."""

import json
import os

import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import layers as jlayers
from paddle_tpu import unique_name as jnames
from paddle_tpu.models import lenet as jlenet
from paddle_tpu.models import seq2seq as jseq2seq
from paddle_tpu.models import stacked_lstm as jstacked
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import unique_name as tnames
from paddle_tpu_torch.core.infer import infer_op_shapes
from paddle_tpu_torch.core.ir import Program
from paddle_tpu_torch.models import alexnet as talexnet
from paddle_tpu_torch.models import googlenet as tgooglenet
from paddle_tpu_torch.models import lenet as tlenet
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.models import seq2seq as tseq2seq
from paddle_tpu_torch.models import stacked_lstm as tstacked
from paddle_tpu_torch.models import smallnet as tsmallnet
from paddle_tpu_torch.models import transformer as ttransformer
from paddle_tpu_torch.models import vgg as tvgg

# Under pytest-xdist each worker takes its share of the cores for
# torch's intra-op threads: six workers at torch's default thread count
# oversubscribe the cores, and a test of seconds then takes minutes.
_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, os.cpu_count() // int(_WORKERS)))

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "goldens")
GOLDENS = sorted(f for f in os.listdir(GOLDEN_DIR)
                 if f.endswith(".program.json"))

SIZE = dict(vocab_size=53, d_model=32, num_layers=2, num_heads=4,
            max_len=32)


def _dump(prog):
    return json.dumps(prog.to_dict(), sort_keys=True, indent=1)


@pytest.mark.parametrize("name", GOLDENS)
def test_golden_round_trips_byte_identical(name):
    with open(os.path.join(GOLDEN_DIR, name)) as f:
        want = f.read()
    assert _dump(Program.from_json(want)) == want


@pytest.mark.parametrize("which", ["prefill", "decode"])
def test_decode_pair_json_identical_to_jax(which):
    jpre, jdec, jmeta = jtransformer.build_transformer_decode(**SIZE)
    tpre, tdec, tmeta = ttransformer.build_transformer_decode(**SIZE)
    j, t = (jpre, tpre) if which == "prefill" else (jdec, tdec)
    assert _dump(t) == _dump(j)
    assert tmeta.cache_outs == jmeta.cache_outs
    assert tmeta.logits_name == jmeta.logits_name
    assert tmeta.cache_names == jmeta.cache_names


def _one_shot(fluid, layers, names, transformer):
    with names.guard():
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            tokens = layers.data("tokens", [-1], dtype="int64")
            transformer.transformer_lm(
                tokens, SIZE["vocab_size"], d_model=SIZE["d_model"],
                num_layers=SIZE["num_layers"],
                num_heads=SIZE["num_heads"], max_len=SIZE["max_len"])
    return prog, startup


@pytest.mark.parametrize("which", ["main", "startup"])
def test_one_shot_lm_json_identical_to_jax(which):
    j = _one_shot(jfluid, jlayers, jnames, jtransformer)
    t = _one_shot(tfluid, tlayers, tnames, ttransformer)
    i = 0 if which == "main" else 1
    assert _dump(t[i]) == _dump(j[i])


def test_one_shot_lm_with_attention_dropout_json_identical_to_jax():
    """``dropout_rate`` puts a ``dropout`` op on each block's attention
    context in both packages."""
    progs = []
    for fluid, layers, names, transformer in (
            (jfluid, jlayers, jnames, jtransformer),
            (tfluid, tlayers, tnames, ttransformer)):
        with names.guard():
            prog = fluid.Program()
            with fluid.program_guard(prog, fluid.Program()):
                tokens = layers.data("tokens", [-1], dtype="int64")
                transformer.transformer_lm(
                    tokens, SIZE["vocab_size"], d_model=SIZE["d_model"],
                    num_layers=SIZE["num_layers"],
                    num_heads=SIZE["num_heads"], max_len=SIZE["max_len"],
                    dropout_rate=0.1)
        progs.append(prog)
    assert _dump(progs[1]) == _dump(progs[0])
    assert [op.type for op in progs[1].global_block().ops].count(
        "dropout") == SIZE["num_layers"]


def test_inferred_dtypes_follow_jax_x64_off():
    """position_ids out is int32 (torch.arange would give int64); the
    declared int64 tokens feed stays int64."""
    prog, _ = _one_shot(tfluid, tlayers, tnames, ttransformer)
    b0 = prog.global_block()
    assert b0.var("tokens").dtype == "int64"
    pos = [op for op in b0.ops if op.type == "position_ids"][0]
    out = b0.var(pos.output("Out")[0])
    assert out.dtype == "int32" and out.shape == (-1, -1)
    logits = b0.ops[-1].output("Out")[0]
    assert b0.var(logits).shape == (-1, -1, SIZE["vocab_size"])


# the golden's size (tools/goldens.py) and the full width of bench.py
LSTM_SIZES = {"golden": dict(dict_dim=100, emb_dim=16, hid_dim=16,
                             stacked_num=3),
              "full": dict(dict_dim=30000, emb_dim=512, hid_dim=512,
                           stacked_num=3)}


@pytest.mark.parametrize("which", ["main", "startup"])
@pytest.mark.parametrize("size", sorted(LSTM_SIZES))
def test_stacked_lstm_train_json_identical_to_jax(size, which):
    with jnames.guard():
        j = jstacked.build_stacked_lstm_train(**LSTM_SIZES[size])
    with tnames.guard():
        t = tstacked.build_stacked_lstm_train(**LSTM_SIZES[size])
    i = 0 if which == "main" else 1
    assert _dump(t[i]) == _dump(j[i])


# the golden's size (tools/goldens.py) and the full width of bench.py
SEQ2SEQ_SIZES = {"golden": dict(src_vocab=50, tgt_vocab=50, emb_dim=16,
                                hidden_dim=16),
                 "full": dict(src_vocab=30000, tgt_vocab=30000, emb_dim=512,
                              hidden_dim=512)}


@pytest.mark.parametrize("which", ["main", "startup"])
@pytest.mark.parametrize("size", sorted(SEQ2SEQ_SIZES))
def test_seq2seq_train_json_identical_to_jax(size, which):
    with jnames.guard():
        j = jseq2seq.build_seq2seq(**SEQ2SEQ_SIZES[size])
    with tnames.guard():
        t = tseq2seq.build_seq2seq(**SEQ2SEQ_SIZES[size])
    i = 0 if which == "main" else 1
    assert _dump(t[i]) == _dump(j[i])


@pytest.mark.parametrize("which", ["main", "startup"])
@pytest.mark.parametrize("size", sorted(SEQ2SEQ_SIZES))
def test_seq2seq_decode_json_identical_to_jax(size, which):
    """``build_seq2seq(mode="decode")``: the beam_search_block op, its
    step sub-block and its Params in the JAX package's order."""
    kw = dict(SEQ2SEQ_SIZES[size], mode="decode", beam_size=4, max_len=16)
    with jnames.guard():
        j = jseq2seq.build_seq2seq(**kw)
    with tnames.guard():
        t = tseq2seq.build_seq2seq(**kw)
    i = 0 if which == "main" else 1
    assert _dump(t[i]) == _dump(j[i])
    assert [op.type for op in t[0].global_block().ops].count(
        "beam_search_block") == 1


def _counting_decoder(fluid, layers):
    """tests/test_beam_search.py's counting decoder."""
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        init_h = layers.fill_constant(shape=[2, 1], dtype="float32",
                                      value=0.0)
        dec = layers.BeamSearchDecoder(beam_size=4, max_len=4, bos_id=0,
                                       eos_id=0, length_normalize=False)
        with dec.step():
            dec.token()
            h = dec.state(init_h)
            new_h = layers.increment(h, value=1.0, in_place=False)
            logits = layers.fc(new_h, 6,
                               param_attr=fluid.ParamAttr(name="bs_toy_w"),
                               bias_attr=fluid.ParamAttr(name="bs_toy_b"))
            dec.update_state(h, new_h)
            dec.set_logits(logits)
        dec()
    return prog, startup


@pytest.mark.parametrize("which", ["main", "startup"])
def test_counting_decoder_json_identical_to_jax(which):
    with jnames.guard():
        j = _counting_decoder(jfluid, jlayers)
    with tnames.guard():
        t = _counting_decoder(tfluid, tlayers)
    i = 0 if which == "main" else 1
    assert _dump(t[i]) == _dump(j[i])


# the golden's size (tools/goldens.py) and bench.py's transformer run
LM_SIZES = {"golden": dict(vocab_size=50, seq_len=16, d_model=32,
                           num_layers=2, num_heads=2),
            "full": dict(vocab_size=32000, seq_len=512, d_model=512,
                         num_layers=8, num_heads=8)}


@pytest.mark.parametrize("which", ["main", "startup"])
@pytest.mark.parametrize("size", sorted(LM_SIZES))
def test_transformer_lm_train_json_identical_to_jax(size, which):
    with jnames.guard():
        j = jtransformer.build_transformer_lm(**LM_SIZES[size])
    with tnames.guard():
        t = ttransformer.build_transformer_lm(**LM_SIZES[size])
    i = 0 if which == "main" else 1
    assert _dump(t[i]) == _dump(j[i])
    assert t[2] == j[2] == ["tokens", "targets"]


def test_scan_block_shapes_infer_on_meta_tensors():
    """StaticRNN declares scan_block's outputs; running the op on meta
    tensors (one step of the sub-block) gives the same shapes and the
    packed type of the scanned input."""
    with tnames.guard():
        prog = tseq2seq.build_seq2seq(**SEQ2SEQ_SIZES["golden"])[0]
    b0 = prog.global_block()
    op = [o for o in b0.ops if o.type == "scan_block"][0]
    names = op.output("Out") + op.output("StepState")
    declared = [(b0.var(n).shape, b0.var(n).dtype, b0.var(n).lod_level)
                for n in names]
    for n in names:
        b0.var(n).shape = None
    infer_op_shapes(b0, op)
    assert [(b0.var(n).shape, b0.var(n).dtype, b0.var(n).lod_level)
            for n in names] == declared
    assert [b0.var(n).type for n in op.output("Out")] == ["packed_seq"] * 2


def _moe():
    """tools/goldens.py's moe: top-2 experts, the mean square plus 0.01
    aux, SGD."""
    layers = tfluid.layers
    prog, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(prog, startup):
        xm = layers.data("xm", [8, 16])
        out_m, aux_m = layers.moe(xm, num_experts=8, d_ff=32, top_k=2)
        cost = layers.elementwise_add(
            layers.mean(layers.square(out_m)),
            layers.scale(aux_m, scale=0.01))
        tfluid.optimizer.SGD(0.1).minimize(cost)
    return prog, startup


def _pipeline_programs(fluid, layers, names, schedule):
    with names.guard():
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            x = layers.data("x", [32])
            pipe = layers.Pipeline(num_stages=2, num_micro=4,
                                   schedule=schedule)
            with pipe.stage():
                h = pipe.input(x)
                h = layers.fc(h, 32, act="tanh")
                h = layers.layer_norm(h)
                pipe.output(h)
            loss = layers.mean(layers.square(pipe()))
            fluid.optimizer.Adam(1e-3).minimize(loss)
    return prog, startup


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
@pytest.mark.parametrize("which", ["main", "startup"])
def test_pipeline_program_json_identical_to_jax(schedule, which):
    """A ``layers.Pipeline`` program (stacked stage parameters, the
    ``pipeline`` op's attrs, its sub-block, Adam over the stacked
    parameters) in both schedules, and its startup (the stacked
    initializers' fans)."""
    i = 0 if which == "main" else 1
    j = _pipeline_programs(jfluid, jlayers, jnames, schedule)[i]
    t = _pipeline_programs(tfluid, tlayers, tnames, schedule)[i]
    assert _dump(t) == _dump(j)


@pytest.mark.parametrize("schedule", [None, "1f1b"])
def test_pp_transformer_json_identical_to_jax(schedule):
    kw = dict(vocab_size=53, seq_len=16, d_model=32, num_layers=4,
              num_heads=4, pp_stages=2, pp_micro=4, pp_schedule=schedule)
    with jnames.guard():
        j = jtransformer.build_transformer_lm(**kw)
    with tnames.guard():
        t = ttransformer.build_transformer_lm(**kw)
    assert _dump(t[0]) == _dump(j[0]) and _dump(t[1]) == _dump(j[1])


def _word_embedding():
    """tools/goldens.py's word_embedding: four lookups of one table,
    fc(act="sigmoid"), fc(act="softmax"), cross-entropy, SGD."""
    prog, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(prog, startup):
        words = [tlayers.data("w%d" % i, [1], dtype="int64")
                 for i in range(4)]
        embs = [tlayers.embedding(w, size=[100, 16],
                                  param_attr=tfluid.ParamAttr(name="shared"))
                for w in words]
        concat = tlayers.concat(embs, axis=1)
        hidden = tlayers.fc(concat, 32, act="sigmoid")
        predict = tlayers.fc(hidden, 100, act="softmax")
        label = tlayers.data("next", [1], dtype="int64")
        cost = tlayers.mean(tlayers.cross_entropy(predict, label))
        tfluid.optimizer.SGD(0.1).minimize(cost)
    return prog, startup


def _amp(built):
    tfluid.amp.enable(built[0])
    return built


@pytest.mark.parametrize("name,build", [
    ("stacked_lstm", lambda: tstacked.build_stacked_lstm_train(
        **LSTM_SIZES["golden"])),
    ("seq2seq_train", lambda: tseq2seq.build_seq2seq(
        **SEQ2SEQ_SIZES["golden"])),
    ("transformer_lm", lambda: ttransformer.build_transformer_lm(
        **LM_SIZES["golden"])),
    ("mnist_mlp", lambda: tlenet.build_mnist_train(model="mlp")),
    ("mnist_cnn", lambda: tlenet.build_mnist_train(model="cnn")),
    ("resnet_cifar", lambda: tresnet.build_resnet50_train(
        image_shape=(3, 32, 32), class_dim=10)),
    ("mnist_cnn_amp", lambda: _amp(tlenet.build_mnist_train(model="cnn"))),
    ("vgg_cifar", lambda: tvgg.build_vgg16_train(image_shape=(3, 32, 32),
                                                 class_dim=10)),
    ("alexnet", lambda: talexnet.build_alexnet_train(
        image_shape=(3, 67, 67), class_dim=10)),
    ("googlenet", lambda: tgooglenet.build_googlenet_train(
        image_shape=(3, 64, 64), class_dim=10)),
    ("smallnet", lambda: tsmallnet.build_smallnet_train()),
    ("word_embedding", _word_embedding),
    ("moe", _moe)])
def test_training_program_equals_golden(name, build):
    """The goldens' builders (tools/goldens.py), run in the port."""
    with tnames.guard():
        prog = build()[0]
    with open(os.path.join(GOLDEN_DIR, name + ".program.json")) as f:
        assert _dump(prog) == f.read()


@pytest.mark.parametrize("which", ["main", "startup"])
def test_mnist_mlp_train_json_identical_to_jax(which):
    with jnames.guard():
        j = jlenet.build_mnist_train(model="mlp")
    with tnames.guard():
        t = tlenet.build_mnist_train(model="mlp")
    i = 0 if which == "main" else 1
    assert _dump(t[i]) == _dump(j[i])


def test_stacked_lstm_program_has_the_goldens_ops():
    with tnames.guard():
        prog = tstacked.build_stacked_lstm_train(**LSTM_SIZES["golden"])[0]
    types = [op.type for op in prog.global_block().ops]
    fwd = {"lookup_table", "mul", "elementwise_add", "lstm", "concat",
           "sequence_pool", "softmax", "cross_entropy", "mean"}
    assert set(types) == fwd | {t + "_grad" for t in fwd} | {
        "top_k", "accuracy", "fill_constant", "sum", "adam"}
    assert types.count("lstm") == types.count("lstm_grad") == 3
    words = prog.global_block().var("words")
    assert words.lod_level == 1 and words.type == "packed_seq"


def test_seq2seq_program_has_the_goldens_ops():
    with tnames.guard():
        prog = tseq2seq.build_seq2seq(**SEQ2SEQ_SIZES["golden"])[0]
    types = [op.type for op in prog.global_block().ops]
    assert types.count("gru") == types.count("gru_grad") == 2
    assert types.count("scan_block") == types.count("scan_block_grad") == 1
    assert types.count("adam") == 19
    sub = prog.block(1)
    assert sub.parent_idx == 0
    assert [op.type for op in sub.ops] == [
        "mul", "unsqueeze", "elementwise_add", "tanh", "mul", "squeeze",
        "scale", "elementwise_sub", "scale", "elementwise_add", "softmax",
        "unsqueeze", "elementwise_mul", "reduce_sum", "concat", "mul",
        "elementwise_add", "gru_unit"]
