"""The vision and detection families on the card, at reduced widths:
each case of ``chip_smoke.py``'s phase 6g sweep (the 21 op types, their
outputs and autograd gradients) on the card against the CPU from the
same numpy inputs; the duplicate-id scatter and the out-of-range labels
and ids on the card (the CPU's bits; NaN with no device-side assert);
the book's word2vec dense and row-sparse; and SSD300 at channels / 8 and
batch 4 with all six source maps (8732 priors) in config B: B8 at the
program's 1x1 shapes and its launches exactly the program's, eager and
through ``run_chunk``'s graphs (bitwise), the detections and mAP on the
trained weights, and the card against the CPU at the phase's reduced
width (channels / 8, batch 4).

Marked ``cuda``: each test skips inside itself where torch finds no
card. This file imports torch, the port and ``chip_smoke.py`` only (the
machine with the card has no jax), so run it there without the suite's
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_vision_cuda.py
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

CASES = chip_smoke.vision_cases(np.random.RandomState(0))


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
def test_vision_type_on_the_card_matches_the_cpu(cuda, name, type, ins,
                                                 attrs):
    cpu = torch.device("cpu")
    want, _ = chip_smoke._lower(type, ins, attrs, cpu)
    got, _ = chip_smoke._lower(type, ins, attrs, cuda)
    share = chip_smoke.vision_amax(name)
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
def test_the_sweep_covers_the_21_types(cuda):
    assert len({c[1] for c in CASES}) == chip_smoke.VISION_TYPES == 21


@pytest.mark.cuda
def test_the_repairs_on_the_card(cuda):
    chip_smoke.repairs_on_card(cuda)


@pytest.mark.cuda
def test_word2vec_dense_and_sparse(cuda, monkeypatch):
    monkeypatch.setitem(chip_smoke.BOOK_W2V, "dict_size", 500)
    monkeypatch.setattr(chip_smoke, "BOOK_W2V_B", 16)
    res = chip_smoke.w2v_phase(fluid, 0, cuda)
    assert set(res) == {"word2vec dense", "word2vec row-sparse"}


@pytest.mark.cuda
def test_ssd300_at_a_reduced_width(cuda, monkeypatch):
    monkeypatch.setitem(chip_smoke.SSD, "div", 8)
    monkeypatch.setattr(chip_smoke, "SSD_B", 4)
    launched, res = chip_smoke.ssd_phase(fluid, 0, cuda)
    assert launched == 5 * 5
    assert res["noisy"] >= 0
