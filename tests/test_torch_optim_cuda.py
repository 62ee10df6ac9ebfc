"""The losses, the optimizers and the metrics on the card, at reduced
widths: each case of ``chip_smoke.py``'s phase 6i sweep (the loss,
optimizer and metric types, their outputs and the losses' autograd
gradients) on the card against the CPU from the same numpy inputs,
counts exact, and ``nce``'s draw and arithmetic (``optim_sweep``); the
stacked LSTM under each optimizer of the phase at dict 1000, emb and
hid 64, batch 16 through ``chip_smoke.optim_path`` (a falling loss, B3
and B4 launches exactly the program's, ModelAverage's sums, the eval
pass's AUC and accuracy against ``metrics`` and ``average``, graph
replays bitwise against eager steps, the card against the CPU with the
state held at the phase's bound); and word2vec with the ``hsigmoid``
and the ``nce`` head at its width (``w2v_head_path``).

Marked ``cuda``: each test skips inside itself where torch finds no
card. This file imports torch, the port and ``chip_smoke.py`` only (the
machine with the card has no jax), so run it there without the suite's
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_optim_cuda.py
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
import paddle_tpu_torch as fluid  # noqa: E402
from paddle_tpu_torch.core import registry  # noqa: E402

CASES = chip_smoke.optim_cases(np.random.RandomState(0))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the tests hold the card against "
                    "the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name,type,ins,attrs", CASES,
                         ids=[c[0] for c in CASES])
def test_type_on_the_card_matches_the_cpu(cuda, name, type, ins, attrs):
    cpu = torch.device("cpu")
    want, _ = chip_smoke._lower(type, ins, attrs, cpu)
    got, _ = chip_smoke._lower(type, ins, attrs, cuda)
    for k, (g, w) in enumerate(zip(got, want)):
        chip_smoke._dense_close("%s out %d" % (name, k), g, w)
        if np.issubdtype(w.dtype, np.floating) and \
                np.array_equal(w, np.round(w)):
            np.testing.assert_array_equal(g, w)
    if registry.get(type).no_grad:
        return
    rng = np.random.RandomState(1)
    cots = [np.asarray(rng.randn(*w.shape), np.float32) for w in want
            if np.issubdtype(w.dtype, np.floating)]
    _, gw = chip_smoke._lower(type, ins, attrs, cpu, grad_cots=cots)
    _, gg = chip_smoke._lower(type, ins, attrs, cuda, grad_cots=cots)
    for k, (g, w) in enumerate(zip(gg, gw)):
        chip_smoke._dense_close("%s grad %d" % (name, k), g, w)


@pytest.mark.cuda
def test_the_cases_and_nce_cover_the_26_types(cuda):
    assert len({c[1] for c in CASES} | {"nce"}) == \
        chip_smoke.OPTIM_TYPES == 26


@pytest.mark.cuda
def test_the_sweep_on_the_card(cuda):
    assert chip_smoke.optim_sweep(cuda, 0) >= 0.0


@pytest.fixture
def reduced(monkeypatch):
    for name, v in (("DICT", 1000), ("EMB", 64), ("HID", 64),
                    ("LSTM_B", 16), ("LSTM_T", 20), ("MIN_LEN", 4),
                    ("XCHECK_B", 4), ("XCHECK_T", 8)):
        monkeypatch.setattr(chip_smoke, name, v)
    monkeypatch.setitem(chip_smoke.XCHECK, "hid_dim", 32)
    monkeypatch.setitem(chip_smoke.XCHECK, "emb_dim", 32)


@pytest.mark.cuda
@pytest.mark.parametrize("tag,kind,kw", chip_smoke.OPTIMIZERS,
                         ids=[o[0] for o in chip_smoke.OPTIMIZERS])
def test_stacked_lstm_under_the_optimizer_at_a_reduced_width(
        cuda, reduced, tag, kind, kw):
    launched, nums = chip_smoke.optim_path(fluid, 0, cuda, tag, kind, kw)
    steps, batches = chip_smoke.OPTIM_STEPS, chip_smoke.OPTIM_EVAL_BATCHES
    assert launched == {"lstm_fwd": 6 * steps + 3 * batches,
                        "lstm_bwd": 3 * steps}
    assert nums["update_mb"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("head", chip_smoke.W2V_HEADS)
def test_word2vec_head_on_the_card(cuda, head):
    nums = chip_smoke.w2v_head_path(fluid, 0, cuda, head)
    assert nums["update_mb"] > 0
