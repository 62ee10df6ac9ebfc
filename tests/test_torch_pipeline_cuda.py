"""Pipeline ('pp') and expert ('ep') parallelism on the card, at reduced
width (phase 6n of chip_smoke.py runs them at bench.py's).

NCCL refuses two ranks of one communicator on one card, so the S-stage
schedules run in one process (``pipeline.pipeline_in_process``) and the
executor path at NCCL world 1 (tests/test_torch_pipeline.py and
tests/test_torch_moe.py hold the sends and sums across ranks at gloo
worlds on the CPU):

* the GPipe and 1F1B schedules of 4 stages on a small transformer's own
  stage sub-block under bf16 AMP: both forwards bitwise the serial loop
  run microbatch by microbatch, the two schedules' gradients bitwise
  equal, both near one whole-batch backward, 1F1B's stash within its
  bound, the bf16 B1 launches the schedule's (``chip_smoke.
  pp_schedules``);
* a float32 MLP stage through both schedules on the card against the
  same on the CPU (each tensor within 1e-5 of its largest magnitude);
* the executor path (``chip_smoke.pp_phase`` at reduced width): the
  ('pp',) mesh of 1 with pp_micro 8, eager steps and graph replays
  bitwise, against the plain Executor; the 4-stage program under
  Executor; ``layers.moe`` top-1 and top-2 under an ('ep',) mesh of 1
  bitwise the Executor, and card against the CPU on margin tokens.

Marked ``cuda``: each test skips inside itself where torch finds no
card. This file imports torch and the port only (the machine with the
card has no jax), so run it there without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_pipeline_cuda.py
"""

import os
import sys

import pytest
import torch

import paddle_tpu_torch as fluid

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

SMALL = dict(vocab_size=1000, seq_len=128, d_model=128, num_layers=4,
             num_heads=2)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from paddle_tpu_torch.kernels import _build

    _build.load_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_schedules_on_the_card(card):
    n = cs.pp_schedules(fluid, 0, card, SMALL, 16, 4, 8, "test")
    assert n > 0


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_float32_schedules_match_the_cpu(card, schedule):
    from paddle_tpu_torch.parallel import pipeline as pl

    g = torch.Generator().manual_seed(0)
    w = torch.randn(4, 64, 64, generator=g) * 0.2
    b = torch.randn(4, 64, generator=g) * 0.2
    x = torch.randn(32, 64, generator=g)
    dy = torch.randn(32, 64, generator=g)

    def stage(p, c, a):
        return torch.tanh(a @ p["w"] + p["b"])

    out = {}
    for dev in ("cpu", card):
        p = {"w": w.to(dev).requires_grad_(), "b": b.to(dev).requires_grad_()}
        stats = {}
        y = pl.pipeline_in_process(stage, p, [], x.to(dev), 8, schedule,
                                   stats)
        gw, gb = torch.autograd.grad(y, [p["w"], p["b"]], dy.to(dev))
        out[str(dev)] = [t.detach().cpu() for t in (y, gw, gb)]
        # the 1F1B backward's stash (GPipe keeps graphs, no stash)
        assert all(n <= stats["bound"][st]
                   for st, n in stats["peak"].items())
        assert (len(stats["peak"]) == 4) == (schedule == "1f1b")
    # float32 with TF32 off: each tensor within 1e-5 of its largest
    # magnitude (the card's and the CPU's tanh and GEMM sums round apart)
    for name, a, c in zip(("y", "dw", "db"), out["cuda:0"], out["cpu"]):
        err = float((a - c).abs().max())
        print("%s %s card vs CPU: %.3g of max %.3g" % (
            schedule, name, err, float(c.abs().max())))
        assert err <= 1e-5 * float(c.abs().max()), (name, err)


@pytest.mark.cuda
def test_executor_and_moe_paths(card):
    saved = cs.MOE_B, cs.MOE_F
    cs.MOE_B, cs.MOE_F = 4, 256
    try:
        launches = cs.pp_phase(fluid, 0, card, cfg=SMALL, batch=16)
    finally:
        cs.MOE_B, cs.MOE_F = saved
    assert launches["flash_attention_bf16"] > 0


@pytest.mark.cuda
def test_init_moe_params_lands_on_the_card(card):
    """A CPU generator's draws, put on the card by default (an entry
    point runs on the card unless the caller asks for the CPU)."""
    from paddle_tpu_torch.parallel.expert_parallel import init_moe_params

    p = init_moe_params(torch.Generator().manual_seed(0), 64, 128, 4)
    q = init_moe_params(torch.Generator().manual_seed(0), 64, 128, 4,
                        place=fluid.CPUPlace())
    for k in p:
        assert p[k].device.type == "cuda" and q[k].device.type == "cpu"
        assert torch.equal(p[k].cpu(), q[k])
