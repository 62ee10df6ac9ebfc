"""The executor and program tooling on the card, at reduced widths
(``chip_smoke.py``'s phase 6k paths): the NaN/Inf guard on the
transformer under bf16 AMP (bitwise silent on clean eager steps and
graph replays, its raise naming the program's op eagerly and inside a
``run_chunk`` graph, with the failing step), ``calc_gradient`` through
the stacked LSTM (B3/B4 launches the program's, the gradient the CPU's),
seq2seq fed through ``LoDTensor`` (bitwise the list-fed steps), the
batch-norm fold of ResNet-50's is_test clone, and that the guard costs
no host synchronisation per op: one step with the flag on synchronises
at most once more than the same step with it off (the read of its
slot).

Marked ``cuda``: each test that needs the card skips inside itself
where torch finds none. This file imports torch, the port and
``chip_smoke.py`` only (the machine with the card has no jax), so run it
there without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_tooling_cuda.py
"""

import os
import sys
import warnings

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
import paddle_tpu_torch as fluid  # noqa: E402

LM_SMALL = dict(vocab_size=1000, seq_len=64, d_model=128, num_layers=2,
                num_heads=2, lr=1e-3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the tooling runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    fluid.set_check_nan_inf(False)


@pytest.mark.cuda
def test_nan_guard_is_silent_and_raises_in_graphs(cuda):
    """chip_smoke.nan_guard_path at a reduced width: every check of (a)
    (it raises on any failure); the clean guarded run was bitwise."""
    out = chip_smoke.nan_guard_path(fluid, cuda, LM_SMALL, 4, 0)
    assert out["cost"]["flops by op"]["fused_attention"] > 0


@pytest.mark.cuda
def test_calc_gradient_through_the_lstm_kernels(cuda):
    nums, _ = chip_smoke.calc_gradient_path(
        fluid, cuda, dict(dict_dim=1000, emb_dim=128, hid_dim=128,
                          stacked_num=3), 16, 20, 4, 0)
    assert nums["launches"]["lstm_fwd"] == 6
    assert nums["launches"]["lstm_bwd"] == 3
    assert nums["rel_err"] <= 1e-4


@pytest.mark.cuda
def test_lodtensor_fed_seq2seq_is_the_list_fed_one(cuda):
    nums, _ = chip_smoke.lod_feed_path(
        fluid, cuda, dict(src_vocab=1000, tgt_vocab=1000, emb_dim=128,
                          hidden_dim=128), 16, 12, 3, 0)
    assert nums["launches"]["gru_fwd"] == 8
    assert nums["launches"]["gru_bwd"] == 4


@pytest.mark.cuda
def test_inference_transpiler_folds_resnet50_on_the_card(cuda):
    nums = chip_smoke.fold_path(
        fluid, cuda, dict(image_shape=(3, 32, 32), class_dim=10, depth=50,
                          lr=0.1), 8, 0)
    assert nums["folded"] == 53


def _mlp():
    from paddle_tpu_torch import layers, unique_name

    with unique_name.guard():
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            x = layers.data("x", [64])
            label = layers.data("label", [1], dtype="int64")
            h = layers.fc(x, 128, act="relu")
            pred = layers.fc(h, 10, act="softmax")
            loss = layers.mean(layers.cross_entropy(pred, label))
            fluid.optimizer.Adam(1e-3).minimize(loss)
    return prog, startup, loss


def _syncs(fn):
    """The synchronising CUDA calls one call of ``fn`` makes, as torch's
    sync debug mode reports them."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [str(w.message) for w in caught
            if "synchroniz" in str(w.message)]


@pytest.mark.cuda
def test_the_guard_syncs_once_a_step_not_once_an_op(cuda):
    """One Adam step of an MLP with device feeds, guarded and not: the
    guarded step's extra synchronisations are at most one (the read of
    its slot), however many ops it checks."""
    prog, startup, loss = _mlp()
    rng = np.random.RandomState(0)
    feed = {"x": torch.from_numpy(rng.rand(32, 64).astype(np.float32))
            .to(cuda),
            "label": torch.from_numpy(rng.randint(0, 10, (32, 1))).to(cuda)}
    counts = {}
    for flag in (False, True):
        fluid.set_check_nan_inf(flag)
        scope, exe = fluid.Scope(), fluid.Executor()
        exe.run(startup, scope=scope)
        # the first call builds and verifies the plan
        exe.run(prog, feed=feed, fetch_list=[loss], scope=scope,
                return_numpy=False)
        torch.cuda.synchronize()
        counts[flag] = _syncs(lambda: exe.run(
            prog, feed=feed, fetch_list=[loss], scope=scope,
            return_numpy=False))
        torch.cuda.synchronize()
    n_ops = len(prog.global_block().ops)
    assert n_ops > 20
    assert len(counts[True]) - len(counts[False]) <= 1, counts


@pytest.mark.cuda
def test_cost_analysis_runs_nothing_on_the_card(cuda):
    prog, startup, loss = _mlp()
    scope, exe = fluid.Scope(), fluid.Executor()
    exe.run(startup, scope=scope)
    state = chip_smoke.scope_state(scope)
    feed = {"x": np.zeros((32, 64), np.float32),
            "label": np.zeros((32, 1), np.int64)}
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    _busy, ops = chip_smoke.device_ops(lambda: exe.cost_analysis(
        prog, feed=feed, fetch_list=[loss], scope=scope))
    assert ops == 0
    assert torch.cuda.memory_allocated() == before
    for n, t in state.items():
        assert torch.equal(scope.find_var(n), t), n
