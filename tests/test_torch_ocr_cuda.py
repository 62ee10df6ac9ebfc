"""The sequence and CTC families and the CRNN-CTC recognizer on the card,
at reduced widths: each case of ``chip_smoke.py``'s phase 6h sweep (the
16 op types, their outputs, lengths and autograd gradients) on the card
against the CPU from the same numpy inputs, sequence_scatter's duplicate
ids bitwise from run to run; B5 and B6 at the CRNN's shape [32, 64, 200]
against their plain versions and float64; and both CRNN variants (the
published relu candidate and tanh, which runs B5 and B6) at channels / 4
and batch 8 through ``chip_smoke.crnn_variant``: a falling loss, the GRU
kernels' launches exactly the program's eagerly and per graph replay,
graph replays bitwise against eager steps, the eval program's decodes,
and the card against the CPU at a narrower width.

Marked ``cuda``: each test skips inside itself where torch finds no
card. This file imports torch, the port and ``chip_smoke.py`` only (the
machine with the card has no jax), so run it there without the suite's
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_ocr_cuda.py
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

CASES = chip_smoke.seq_cases(np.random.RandomState(0))


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
def test_sequence_type_on_the_card_matches_the_cpu(cuda, name, type, ins,
                                                   attrs):
    cpu = torch.device("cpu")
    want, _ = chip_smoke._lower(type, ins, attrs, cpu, lengths=True)
    got, _ = chip_smoke._lower(type, ins, attrs, cuda, lengths=True)
    share = chip_smoke.seq_amax(name)
    for k, (g, w) in enumerate(zip(got, want)):
        chip_smoke._dense_close("%s out %d" % (name, k), g, w, share)
    floats = [w for w in want if np.issubdtype(w.dtype, np.floating)]
    if registry.get(type).no_grad or not floats:
        return
    rng = np.random.RandomState(1)
    cots = [np.asarray(rng.randn(*w.shape), np.float32) for w in floats]
    _, gw = chip_smoke._lower(type, ins, attrs, cpu, grad_cots=cots)
    _, gg = chip_smoke._lower(type, ins, attrs, cuda, grad_cots=cots)
    for k, (g, w) in enumerate(zip(gg, gw)):
        chip_smoke._dense_close("%s grad %d" % (name, k), g, w, share)


@pytest.mark.cuda
def test_the_sweep_covers_the_16_types(cuda):
    assert len({c[1] for c in CASES}) == chip_smoke.SEQ_TYPES == 16


@pytest.mark.cuda
def test_the_sweep_on_the_card(cuda):
    assert chip_smoke.seq_sweep(cuda, 0) >= 0.0


@pytest.mark.cuda
def test_gru_kernels_at_the_crnn_shape(cuda):
    from paddle_tpu_torch.kernels import gru_cell as gc

    g = torch.Generator(device="cpu").manual_seed(3)
    errs = chip_smoke.crnn_gru_kernels(gc, g, cuda)
    assert set(errs) == {"gru_fwd", "gru_bwd"}


@pytest.mark.cuda
@pytest.mark.parametrize("tag,act", chip_smoke.CRNN_ACTS)
def test_crnn_variant_at_a_reduced_width(cuda, monkeypatch, tag, act):
    monkeypatch.setitem(chip_smoke.CRNN, "channels", (4, 8, 16, 32))
    monkeypatch.setattr(chip_smoke, "CRNN_B", 8)
    monkeypatch.setitem(chip_smoke.CRNN_X, "channels", (2, 4, 4, 8))
    monkeypatch.setitem(chip_smoke.CRNN_X, "batch", 4)
    launched, res = chip_smoke.crnn_variant(fluid, 0, cuda, tag, act)
    if act == "tanh":
        assert launched == {"gru_fwd": 5 * 4, "gru_bwd": 5 * 2}
    else:
        assert launched == {}
    assert res["noisy"] >= 0
