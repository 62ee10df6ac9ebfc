"""The dense op library on the card, at small sizes: each case of
``chip_smoke.py``'s phase 6f sweep (every op type of the library, its
outputs and its gradients by autograd) on the card against the CPU from
the same numpy inputs; the six random ops through ``run_chunk``'s
captured graphs, bitwise against eager steps; and
``nets.scaled_dot_product_attention`` against the ``fused_attention``
op (float32 B1) on the same q, k, v at the bounds of PERF.md section 2,
with B1's launches exactly the program's.

Marked ``cuda``: each test skips inside itself where torch finds no
card. This file imports torch, the port and ``chip_smoke.py`` only (the
machine with the card has no jax), so run it there without the suite's
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_dense_cuda.py
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

CASES = chip_smoke.dense_cases(np.random.RandomState(0))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sweep holds the card against "
                    "the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name,type,ins,attrs", CASES,
                         ids=[c[0] for c in CASES])
def test_dense_type_on_the_card_matches_the_cpu(cuda, name, type, ins,
                                                attrs):
    cpu = torch.device("cpu")
    want, _ = chip_smoke._lower(type, ins, attrs, cpu)
    got, _ = chip_smoke._lower(type, ins, attrs, cuda)
    for k, (g, w) in enumerate(zip(got, want)):
        chip_smoke._dense_close("%s out %d" % (name, k), g, w)
    floats = [w for w in want if np.issubdtype(w.dtype, np.floating)]
    if registry.get(type).no_grad or not floats:
        return
    rng = np.random.RandomState(1)
    cots = [np.asarray(rng.randn(*w.shape), np.float32) for w in floats]
    _, gw = chip_smoke._lower(type, ins, attrs, cpu, grad_cots=cots)
    _, gg = chip_smoke._lower(type, ins, attrs, cuda, grad_cots=cots)
    for k, (g, w) in enumerate(zip(gg, gw)):
        chip_smoke._dense_close("%s grad %d" % (name, k), g, w)


@pytest.mark.cuda
def test_the_sweep_covers_every_type_of_the_library(cuda):
    types = {c[1] for c in CASES} | {r[0] for r in chip_smoke.DENSE_RANDOM}
    assert len(types) == 60
    chip_smoke.dense_sweep(cuda, 0)


@pytest.mark.cuda
def test_random_ops_replay_their_eager_draws(cuda):
    chip_smoke.random_graphs(fluid, 0, cuda)


@pytest.mark.cuda
def test_nets_attention_against_b1(cuda, monkeypatch):
    monkeypatch.setitem(chip_smoke.SDPA, "b", 2)
    monkeypatch.setitem(chip_smoke.SDPA, "t", 160)
    monkeypatch.setitem(chip_smoke.SDPA, "d", 128)
    monkeypatch.setitem(chip_smoke.SDPA, "heads", 2)
    assert chip_smoke.sdpa_phase(fluid, 0, cuda) > 0
