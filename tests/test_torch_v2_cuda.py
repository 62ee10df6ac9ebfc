"""The v2 frontend and the staging readers on the card, at reduced
widths: a v2 stacked-LSTM net (dict 5149, emb and hid 64, 3 layers,
batch 16) and the v2 GRU net trained, tested, checkpointed and inferred
through ``paddle_tpu_torch.v2`` on the card with their B3/B4 and B5/B6
launches exactly the programs' (``chip_smoke.v2_train_path``);
``device_chunks`` and ``double_buffer`` yielding CUDA tensors equal to
the host values, and ``run_chunk`` fed by ``device_chunks`` bitwise the
host-fed run (``chip_smoke.v2_readers``); the first step card against
CPU (``chip_smoke.v2_cross_check``); and that the staging readers raise
where torch finds no card.

Marked ``cuda``: each test that needs the card skips inside itself
where torch finds none. This file imports torch, the port and
``chip_smoke.py`` only (the machine with the card has no jax), so run it
there without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_v2_cuda.py
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
import paddle_tpu_torch as fluid  # noqa: E402
import paddle_tpu_torch.v2 as paddle  # noqa: E402

DICT = 5149
SMALL = dict(emb_dim=64, hid_dim=64, stacked_num=3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the tests run v2 on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    saved = dict(paddle._settings)
    yield torch.device("cuda", 0)
    paddle._settings.clear()
    paddle._settings.update(saved)


@pytest.mark.cuda
def test_v2_stacked_net_launches_b3_b4_as_its_programs_say(cuda):
    got, nums = chip_smoke.v2_train_path(
        fluid, paddle, 0, cuda, "v2 stacked LSTM (small)",
        lambda: chip_smoke.v2_stacked_build(paddle, DICT, **SMALL), "lstm",
        4, 1, batch=16)
    # 3 lstm ops, each re-run inside its grad: 6 B3 + 3 B4 a step; 3 B3
    # a test batch and an infer call
    assert got == {"lstm_fwd": 6 * 4 + 3 + 3 * 2, "lstm_bwd": 3 * 4}
    assert nums["params"] > 0


@pytest.mark.cuda
def test_v2_gru_net_launches_b5_b6_as_its_program_says(cuda):
    got, _ = chip_smoke.v2_train_path(
        fluid, paddle, 0, cuda, "v2 GRU (small)",
        lambda: chip_smoke.v2_gru_build(paddle, DICT, 64, 64), "gru", 4, 1,
        batch=16, checkpoint=False)
    assert got == {"gru_fwd": 2 * 4 + 1, "gru_bwd": 4}


@pytest.mark.cuda
def test_staging_readers_give_the_host_values_on_the_card(cuda):
    nums = chip_smoke.v2_readers(
        fluid, paddle, 0, cuda,
        lambda: chip_smoke.v2_stacked_build(paddle, DICT, **SMALL),
        batch=16, k=2, chunks=2)
    assert nums["chunks_s"] > 0


@pytest.mark.cuda
def test_v2_first_step_on_the_card_matches_the_cpu(cuda):
    chip_smoke.v2_cross_check(
        fluid, paddle, 0,
        lambda: chip_smoke.v2_stacked_build(paddle, DICT, **SMALL), 8)


@pytest.mark.cuda
def test_staging_readers_raise_without_a_card(monkeypatch):
    """Where torch finds no card both readers raise at once, whatever the
    place; with a card, a place that is not a CUDA device raises too."""
    def reader():
        yield {"x": torch.zeros(2)}

    if torch.cuda.is_available():
        for fn in (fluid.reader.device_chunks, fluid.reader.double_buffer):
            with pytest.raises(ValueError, match="not one"):
                fn(reader, place=fluid.CPUPlace())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (fluid.reader.device_chunks, fluid.reader.double_buffer):
        for place in (None, fluid.CUDAPlace(0), fluid.CPUPlace()):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                fn(reader, place=place)
