"""Checkpoints and recovery on the card, at reduced width (phase 6o of
chip_smoke.py runs them at bench.py's):

* (a) the guarded transformer (bf16 AMP, dynamic loss scale): 2 steps,
  an async ``CheckpointManager`` save and a ``ShardedCheckpointManager``
  one, 2 more; each generation restored into a fresh scope on the card
  runs the same 2 steps bitwise (losses and every state tensor, the
  guard's included), with the program's bf16 B1 launches
  (``chip_smoke.ckpt_round_trip``);
* (b) ``guard.nonfinite`` on a whole chunk: the detector trips,
  ``RecoveryLoop`` quarantines the diverged generation and restores the
  clean one; counters equal to the injected counts, the end state
  bitwise the unfaulted run's (``chip_smoke.ckpt_rollback``);
* a bfloat16 tensor and a float32 one through both checkpoint kinds on
  the card, restored bitwise onto the card.

Marked ``cuda``: each test skips inside itself where torch finds no
card. This file imports torch and the port only (the machine with the
card has no jax), so run it there without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_checkpoint_cuda.py
"""

import os
import sys

import pytest
import torch

import paddle_tpu_torch as fluid

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

SMALL = dict(vocab_size=1000, seq_len=128, d_model=128, num_layers=2,
             num_heads=2, lr=1e-3)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from paddle_tpu_torch.kernels import _build

    _build.load_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def lm(card):
    """guard_phase's program, weights and feed at SMALL's width."""
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.models.transformer import build_transformer_lm

    def build(armed):
        with unique_name.guard():
            prog, startup, _, (loss,) = build_transformer_lm(**SMALL)
        if armed == "scaling":
            fluid.amp.enable(prog, loss=loss, dynamic_loss_scale=True,
                             growth_interval=cs.GUARD_GROWTH,
                             divergence=False)
        else:
            fluid.amp.enable(prog)
        return prog, startup, loss

    prog, startup, loss = build("scaling")
    fwd, grad, _ = cs.attention_launches(prog)
    startup.random_seed = 3
    s0 = fluid.Scope()
    fluid.Executor().run(startup, scope=s0)
    feed = {n: torch.from_numpy(a).to(card) for n, a in cs.lm_feed(
        SMALL["vocab_size"], SMALL["seq_len"], 4, 3).items()}
    return dict(prog=prog, loss=loss, init=cs.scope_state(s0), feed=feed,
                build=build, b1=fwd + grad)


@pytest.mark.cuda
def test_round_trip_bitwise_on_the_card(card, lm, tmp_path):
    assert cs.ckpt_round_trip(fluid, lm, card, str(tmp_path),
                              lambda: "beside") == (4 * lm["b1"], "beside")


@pytest.mark.cuda
def test_rollback_bitwise_on_the_card(card, lm, tmp_path):
    assert cs.ckpt_rollback(fluid, lm, card, str(tmp_path)) == \
        5 * cs.CKPT_K * lm["b1"]


@pytest.mark.cuda
def test_bf16_restores_bitwise_onto_the_card(card, tmp_path):
    from paddle_tpu_torch.distributed.checkpoint import (load_checkpoint,
                                                         save_checkpoint)
    from paddle_tpu_torch.distributed.sharded_checkpoint import (
        load_sharded_checkpoint, save_sharded_checkpoint)

    g = torch.Generator().manual_seed(0)
    scope = fluid.Scope()
    scope.set_var("w", torch.randn(37, 5, generator=g).bfloat16().to(card))
    scope.set_var("f", torch.randn(3, 7, generator=g).to(card))
    save_checkpoint(str(tmp_path / "p"), 1, scope=scope, names=["w", "f"])
    save_sharded_checkpoint(str(tmp_path / "s"), 1, scope, names=["w", "f"])
    place = fluid.CUDAPlace(0)
    for load in (lambda s: load_checkpoint(str(tmp_path / "p"), s,
                                           place=place),
                 lambda s: load_sharded_checkpoint(str(tmp_path / "s"), s,
                                                   {}, place=place)):
        s = fluid.Scope()
        load(s)
        for n in ("w", "f"):
            got, want = s.find_var(n), scope.find_var(n)
            assert got.device == want.device and got.dtype == want.dtype
            assert torch.equal(got.view(torch.int16) if n == "w" else got,
                               want.view(torch.int16) if n == "w" else want)
