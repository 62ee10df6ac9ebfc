"""The training slice end to end on the CPU: the port's stacked-LSTM
classifier and MNIST MLP, built by append_backward and Adam in both
packages, trained from the same weights (the JAX startup's scope carried
over by ``interop.load_reference_state``, moments, beta powers and the
learning rate included) on the same seeded batches.

Tolerances: losses of 3 Adam steps within rtol 1e-5 and the first
step's parameter gradients within rtol 1e-4, atol 1e-6 (fp32 math in
another summation order; XLA fuses and reorders the JAX side)."""

import os

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import unique_name as jnames
from paddle_tpu.models import lenet as jlenet
from paddle_tpu.models import stacked_lstm as jlstm
from paddle_tpu_torch import interop
from paddle_tpu_torch import unique_name as tnames
from paddle_tpu_torch.kernels import lstm_cell
from paddle_tpu_torch.models import lenet as tlenet
from paddle_tpu_torch.models import stacked_lstm as tlstm

# Under pytest-xdist each worker takes its share of the cores for
# torch's intra-op threads: six workers at torch's default thread count
# oversubscribe the cores, and a test of seconds then takes minutes.
_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, os.cpu_count() // int(_WORKERS)))

CPU = tfluid.CPUPlace()
SMALL = dict(dict_dim=100, emb_dim=16, hid_dim=16)
B = 4


def _build(names, build, **kw):
    with names.guard():
        return build(**kw)


def _pair(jbuild, tbuild, **kw):
    """Both packages' programs, the JAX weights and a port scope holding
    the same state."""
    jprog, jstart, feeds, (jloss, jacc) = _build(jnames, jbuild, **kw)
    tprog, tstart, _, (tloss, tacc) = _build(tnames, tbuild, **kw)
    jscope = jfluid.Scope()
    jexe = jfluid.Executor()
    jexe.run(jstart, scope=jscope)
    arrays = {v.name: np.asarray(jscope.find_var(v.name))
              for v in jprog.list_vars() if v.persistable}
    tscope = tfluid.Scope()
    loaded = interop.load_reference_state(arrays, tscope, CPU,
                                          [tprog, tstart])
    return dict(jprog=jprog, jexe=jexe, jscope=jscope, jfetch=[jloss, jacc],
                tprog=tprog, texe=tfluid.Executor(CPU), tscope=tscope,
                tfetch=[tloss, tacc], feeds=feeds, loaded=loaded)


def _train_and_compare(m, feed, steps=3):
    params = sorted(p.name for p in m["jprog"].global_block().all_parameters())
    grads = [p + "@GRAD" for p in params]
    jl, tl = [], []
    for step in range(steps):
        extra = grads if step == 0 else []
        jout = m["jexe"].run(m["jprog"], feed=feed,
                             fetch_list=[v.name for v in m["jfetch"]] + extra,
                             scope=m["jscope"])
        tout = m["texe"].run(m["tprog"], feed=feed,
                             fetch_list=[v.name for v in m["tfetch"]] + extra,
                             scope=m["tscope"])
        jl.append(float(np.asarray(jout[0])))
        tl.append(float(tout[0]))
        assert float(np.asarray(jout[1])) == float(tout[1]), "accuracy"
        for name, jg, tg in zip(extra, jout[2:], tout[2:]):
            np.testing.assert_allclose(tg, np.asarray(jg), rtol=1e-4,
                                       atol=1e-6, err_msg=name)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert np.isfinite(tl).all()
    return tl


def _words(rng, lens, dict_dim):
    return [rng.randint(1, dict_dim, (int(n), 1)).astype(np.int64)
            for n in lens]


@pytest.mark.parametrize("case", ["equal_3_layers", "ragged_1_layer"])
def test_stacked_lstm_steps_match_jax(case):
    """Equal lengths run both LSTM directions (the second layer is
    reverse); ragged lengths run one forward layer, where the two
    packages agree everywhere (see test_torch_lstm for the reverse
    layer's position-0 difference)."""
    rng = np.random.RandomState(7)
    if case == "equal_3_layers":
        stacked, lens = 3, [6] * B
    else:
        stacked, lens = 1, [6, 2, 5, 1]
    m = _pair(jlstm.build_stacked_lstm_train, tlstm.build_stacked_lstm_train,
              stacked_num=stacked, **SMALL)
    feed = {"words": _words(rng, lens, SMALL["dict_dim"]),
            "label": rng.randint(0, 2, (B, 1)).astype(np.int64)}
    losses = _train_and_compare(m, feed)
    assert losses[-1] < losses[0]


def test_mnist_mlp_steps_match_jax():
    rng = np.random.RandomState(3)
    m = _pair(jlenet.build_mnist_train, tlenet.build_mnist_train,
              model="mlp", lr=1e-3)
    feed = {"img": rng.rand(8, 784).astype(np.float32),
            "label": rng.randint(0, 10, (8, 1)).astype(np.int64)}
    losses = _train_and_compare(m, feed)
    assert losses[-1] < losses[0]


def test_training_scope_carries_optimizer_state():
    """load_reference_state fills the Adam state too: moments, beta
    powers and the learning rate, with the JAX values."""
    m = _pair(jlstm.build_stacked_lstm_train, tlstm.build_stacked_lstm_train,
              stacked_num=1, **SMALL)
    names = set(m["loaded"])
    assert any(n.endswith("_moment1_0") for n in names)
    assert any(n.endswith("_beta2_pow_0") for n in names)
    lr = [n for n in names if n.startswith("learning_rate")]
    assert lr and float(m["tscope"].find_var(lr[0])[0]) == pytest.approx(1e-3)
    b1 = [n for n in names if n.endswith("_beta1_pow_0")][0]
    assert float(m["tscope"].find_var(b1)[0]) == pytest.approx(0.9)


def test_startup_on_the_port_trains_and_counts_no_launch_on_cpu():
    """The port's own startup (its own random weights), ragged ids fed
    as a list: the loss falls over a few steps, and on the CPU the LSTM
    runs its plain versions, so no kernel launch is counted."""
    prog, startup, feeds, (loss, acc) = _build(
        tnames, tlstm.build_stacked_lstm_train, stacked_num=3, **SMALL)
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    feed = {"words": _words(rng, [5, 3, 8, 1], SMALL["dict_dim"]),
            "label": rng.randint(0, 2, (B, 1)).astype(np.int64)}
    lstm_cell.reset_launches()
    out = [exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)[0]
           for _ in range(4)]
    assert np.isfinite(out).all() and out[-1] < out[0]
    assert lstm_cell.launches == {"lstm_fwd": 0, "lstm_bwd": 0,
                                  "lstm_fwd_bf16": 0, "lstm_bwd_bf16": 0}


def test_fetch_packed_sequence_comes_back_as_numpy_pair():
    prog, startup, feeds, _ = _build(
        tnames, tlstm.build_stacked_lstm_train, stacked_num=1, **SMALL)
    lstm_op = [op for op in prog.global_block().ops if op.type == "lstm"][0]
    hidden = lstm_op.output("Hidden")[0]
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(1)
    feed = {"words": _words(rng, [3, 1], SMALL["dict_dim"]),
            "label": np.zeros((2, 1), np.int64)}
    out, = exe.run(prog, feed=feed, fetch_list=[hidden], scope=scope)
    assert isinstance(out, tfluid.PackedSeq)
    assert out.data.shape == (2, 3, SMALL["hid_dim"])
    assert out.lengths.tolist() == [3, 1]
    assert not out.data[1, 1:].any()   # padding stays zero
