"""Smoke run of paddle_tpu_torch on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py [--seed N]

Drives the port's four main paths through the entry points a user
calls, on random weights and data made from ``--seed``:

* KV-cached decode serving of the transformer LM at the repo's full
  decode-serving width (vocab 8192, d_model 512, 8 layers, 8 heads,
  max_len 512, 16 slots, prompt buckets 8/16/32);
* training of the stacked-LSTM text classifier at the repo's full width
  (dict 30000, emb 512, hid 512, 3 layers, 2 classes, Adam lr 1e-3) on a
  batch of 64 ragged sequences of 16..80 ids;
* training of the attention seq2seq (NMT) model at the repo's full width
  (vocab 30000 source and target, emb 512, hid 512, Adam lr 1e-3) on a
  batch of 64 ragged source and target sequences of 8..30 ids;
* training of ResNet-50 at full width (3x224x224 images, 1000 classes,
  depth 50, batch 64, float32, Momentum lr 0.1 mu 0.9), twice from the
  same weights: config A "nhwc+reductions" (``layout="NHWC"`` and
  ``passes.enable(prog, layout="NHWC", pallas_reductions=True)``, whose
  53 batch_norm_grad ops launch the batch-norm backward kernel) and
  config B "nchw+fused1x1" (NCHW, no passes,
  ``FLAGS_fused_conv1x1_bwd`` on, whose 1x1 stride-1 convolutions
  launch the fused dx+dw kernel in their backward). The two kernels
  cannot fire in one program: the first takes NHWC only, the second
  NCHW only.

Phases, in order; any failure raises and the script exits non-zero:

1. device: require CUDA, print the card's name and power limit, turn
   TF32 off for float32 matmuls and convolutions;
2. build every CUDA kernel from ``paddle_tpu_torch/csrc``, one nvcc per
   source, all started together, and read from the built libraries that
   the flash-attention forward and the fused 1x1 backward run on the
   tensor cores (HMMA) fed by cp.async copies (LDGSTS), with no spills;
3. hold each kernel against its plain PyTorch version on the card (the
   fused 1x1 backward at every distinct shape of the ResNet-50 path, as
   derived from the program, also against float64, and its float32 dw
   error against float64 by the length of its dw chunks);
4. decode serving: create the weights with the port's Executor, warm a
   DecodeEngine, push 24 mixed requests through a DecodeLoop, check the
   kernels' launch counts and that greedy tokens equal the argmax of the
   port's one-shot logits;
5. stacked-LSTM training: startup, 2 warmup steps, 10 counted steps
   (falling finite loss, exact LSTM launch counts), a profile of one
   step, and the card against the CPU at a reduced size from the same
   weights (losses of 3 steps, first-step gradients);
6. seq2seq training, the same way (exact GRU launch counts);
7. ResNet-50 training: A against B on the card from the same weights
   (first-step loss and every gradient, each held to its own norm),
   then each config's startup, 2 warmup and 10 counted steps at lr 0.1
   (exact launch counts derived from the program; a finite loss that
   comes under the first counted one, if need be after further steps:
   lr 0.1 with momentum overshoots on one repeated batch, in the JAX
   package as here, tests/test_torch_convnet.py), 5 steps from the same
   weights at lr 0.01 whose loss falls at every step, a profile of one
   step, and the card against the CPU, and A against B again, at the
   ``resnet_cifar`` size (32x32, 10 classes, batch 8);
8. time each kernel, its plain version and one PyTorch library call at
   the main paths' shapes with CUDA events (the flash-attention forward
   at six shapes, the fused 1x1 backward at every distinct shape of the
   ResNet-50 path), and profile the decode step;
9. print the kernel table as one JSON line, then the result line.

It imports nothing of JAX and nothing of the JAX package.
"""

import argparse
import json
import math
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# the card's published peaks (NVIDIA H100 SXM data sheet): HBM bytes/s,
# and float32 FLOP/s outside the tensor cores (the FMA kernels' path)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# dense TF32 tensor-core FLOP/s (the same data sheet)
TF32_FLOPS_PER_S = 495e12

# full width: the repo's decode-serving configuration
VOCAB, D_MODEL, N_LAYERS, N_HEADS = 8192, 512, 8, 8
MAX_LEN, SLOTS, BUCKETS = 512, 16, (8, 16, 32)
N_REQUESTS, LONG_NEW, SHORT_NEW = 24, 128, 8

# full width: the repo's stacked-LSTM configuration (bench.py:163-167)
# at the reference's published batch of 64
DICT, EMB, HID, STACKED, CLASSES, LR = 30000, 512, 512, 3, 2, 1e-3
LSTM_B, LSTM_T, MIN_LEN = 64, 80, 16
WARMUP_STEPS, TRAIN_STEPS = 2, 10
# the card against the CPU: a reduced size the CPU's plain step loop runs
XCHECK = dict(dict_dim=1000, emb_dim=128, hid_dim=128, stacked_num=3)
XCHECK_B, XCHECK_T, XCHECK_STEPS = 16, 20, 3

# full width: the repo's seq2seq configuration (bench.py:186-218, after
# benchmark/fluid/machine_translation.py) at its batch of 64
S2S = dict(src_vocab=30000, tgt_vocab=30000, emb_dim=512, hidden_dim=512)
S2S_B, S2S_T, S2S_MIN = 64, 30, 8
S2S_XCHECK = dict(src_vocab=1000, tgt_vocab=1000, emb_dim=128,
                  hidden_dim=128)
S2S_XCHECK_B, S2S_XCHECK_T = 16, 12

# full width: ResNet-50 as the reference benchmarks it (batch 64)
RESNET = dict(image_shape=(3, 224, 224), class_dim=1000, depth=50, lr=0.1)
RESNET_B = 64
RESNET_XCHECK = dict(image_shape=(3, 32, 32), class_dim=10, depth=50, lr=0.1)
RESNET_XCHECK_B = 8
# further steps at lr 0.1 allowed for the loss to come under the first
# counted one (H100 runs took 12 to 31: cuDNN's backward is not
# run-to-run deterministic and the overshoot amplifies it)
RESNET_SETTLE_STEPS = 120
# the counted steps run at the reference's lr 0.1, where the loss on one
# repeated batch overshoots before it falls (the JAX package's does the
# same from the same weights: tests/test_torch_convnet.py); at this lr it
# falls at every one of RESNET_LOW_LR_STEPS steps
RESNET_LOW_LR, RESNET_LOW_LR_STEPS = 0.01, 5
# At its initial weights a batch-normalised ReLU net turns a rounding
# difference in its input into relu gates that flip, most of all where a
# batch norm sees few values (at 32x32 and batch 8 stage 4 normalises 8 a
# channel): a 1e-6 change of the input moves single gradients by 0.2-0.4
# of their largest value, at depth 18 as at depth 50
# (tests/test_torch_convnet.py measures it). So where two runs'
# GRADIENTS are compared, the scale of the last batch norm of every
# residual branch is multiplied by this in both runs: the blocks then
# start close to the identity, as a zero-initialised residual does. The
# training runs use the weights as the startup program made them.
RESNET_DAMP = 0.03
# Two runs' gradients are held three ways: each within GTOL x its own
# largest magnitude, each within PL2TOL of its own L2 norm (so a
# parameter inside a damped branch, whose gradient is small beside the
# others', counts as much as any), and all together within L2TOL in
# relative L2 norm. The card against the CPU, and A against B on the
# card, at 32x32 and batch 8 (ten times what an H100 run measured):
RESNET_GTOL, RESNET_PL2TOL, RESNET_L2TOL = 5e-3, 2e-3, 4e-4
# A against B at full width: the two configs run different library
# convolutions (channels-last and not) over 802816 positions, and single
# gates flip: single entries differed by up to 0.054 of the largest and
# the worst gradient by 5.3e-3 of its norm in an H100 run, so the
# per-parameter norm carries the check (a gradient 5% wrong fails it)
RESNET_AB_GTOL, RESNET_AB_PL2TOL, RESNET_AB_L2TOL = 1e-1, 2e-2, 2e-3

# kernel vs plain version: the same fp32 math in another summation order
ATOL = RTOL = 1e-5
# the LSTM: hs/cs within atol 1e-5, rtol 1e-4 (80 dependent steps reorder
# the recurrence's sums); its gradients (dxg, dh0, dc0, dpeep, and dW
# through the GEMM outside the kernel) within rtol 1e-4 and an atol of
# 1e-5 times the output's largest magnitude, because the backward
# carries every step's reordering error into sums whose terms reach
# tens to hundreds at the path's shape. The GRU's kernels are held to
# the same tolerances for the same reasons.
LSTM_ATOL, LSTM_RTOL = 1e-5, 1e-4
# The batch-norm backward: its sums run over up to 802816 rows in another
# order than torch's, and sum(dy x) - mean sum(dy) cancels, so dscale and
# dbias are held to rtol 1e-4 plus 1e-5 of their largest magnitude; dx to
# rtol 1e-4 plus 1e-5 of its largest magnitude in float32 and to one
# bfloat16 rounding (rtol 1e-2 plus 4e-3 of the largest) in bfloat16.
# The fused 1x1 backward: dw sums up to 200704 products: rtol 1e-4 plus
# 2e-5 of the largest magnitude in float32, one bfloat16 rounding in
# bfloat16. Both are also held against float64 plain versions.
BN_RTOL, BN_AMAX = 1e-4, 1e-5
C1_RTOL, C1_AMAX = 1e-4, 2e-5
BF16_RTOL, BF16_AMAX = 1e-2, 4e-3
# (N, H, W, C): the ResNet-50 stem at batch 64, a stage-4 shape, a row
# count (315) that no power of two divides, channels that fill no float4
BN_SHAPES = ((64, 112, 112, 64), (64, 7, 7, 2048), (5, 7, 9, 24),
             (3, 5, 7, 6))
# (B, Ci, H, W, Co): B8 is checked at every distinct shape of the
# ResNet-50 path (derived from the program: c1_path_shapes) and at these,
# where no dimension fills a tile
C1_EXTRA_SHAPES = ((3, 24, 5, 7, 40),)
# dw chunk lengths (positions) of the precision sweep at 64 -> 256 @ 56x56
C1_SWEEP_SHAPE = (64, 64, 56, 56, 256)
C1_SWEEP_CHUNKS = (64, 256, 1024, 4096)

SOURCES = {"flash_attention": "paddle_tpu_torch/csrc/flash_attention.cu",
           "flash_decode": "paddle_tpu_torch/csrc/flash_attention.cu",
           "lstm_fwd": "paddle_tpu_torch/csrc/lstm_cell.cu",
           "lstm_bwd": "paddle_tpu_torch/csrc/lstm_cell.cu",
           "gru_fwd": "paddle_tpu_torch/csrc/gru_cell.cu",
           "gru_bwd": "paddle_tpu_torch/csrc/gru_cell.cu",
           "bn_grad": "paddle_tpu_torch/csrc/bn_grad.cu",
           "conv1x1_bwd": "paddle_tpu_torch/csrc/conv1x1_bwd.cu"}
REPLACES = {"flash_attention": "paddle_tpu/kernels/flash_attention.py:70",
            "flash_decode": "paddle_tpu/kernels/flash_attention.py:374",
            "lstm_fwd": "paddle_tpu/kernels/lstm_cell.py:97",
            "lstm_bwd": "paddle_tpu/kernels/lstm_cell.py:198",
            "gru_fwd": "paddle_tpu/kernels/gru_cell.py:67",
            "gru_bwd": "paddle_tpu/kernels/gru_cell.py:143",
            "bn_grad": "paddle_tpu/kernels/bn_grad.py:72",
            "conv1x1_bwd": "paddle_tpu/kernels/conv1x1_bwd.py:85"}


def phase(name):
    print("== %s" % name, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


# B1 and B8 run on the tensor cores fed by cp.async copies: (library,
# kernel function). The bfloat16 B8 whose rows start on 2-byte
# boundaries stages through registers (cp.async copies 4 bytes or more).
TENSOR_CORE_KERNELS = (("flash_attention", "flash_fwd_kernel"),
                       ("conv1x1_bwd", "conv1x1_bwd_kernel"))
SYNC_STAGED = "13__nv_bfloat16Li1E"


def sass_check(build):
    """For every instantiation of the tensor-core kernels: registers,
    stack and local memory from the built library, and its SASS's HMMA
    (tensor-core) and LDGSTS (cp.async) instructions and local-memory
    loads and stores (spills). Fails where a kernel has no HMMA, no
    LDGSTS (but SYNC_STAGED), or spills."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for lib, kernel in TENSOR_CORE_KERNELS:
        path = build._target(lib)[1]
        res = subprocess.run([tool, "--dump-resource-usage", path],
                             check=True, capture_output=True, text=True,
                             timeout=120).stdout
        usage = dict(re.findall(r"Function (\S+):\s*\n\s*(REG:\d+ STACK:\d+ "
                                r"SHARED:\d+ LOCAL:\d+)", res))
        sass = subprocess.run([tool, "--dump-sass", path], check=True,
                              capture_output=True, text=True,
                              timeout=120).stdout
        counts, fn = {}, None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
                counts[fn] = [0, 0, 0]
            elif fn is not None:
                counts[fn][0] += "HMMA" in line
                counts[fn][1] += "LDGSTS" in line
                counts[fn][2] += bool(re.search(r"\b(LDL|STL)\b", line))
        mine = sorted(f for f in counts if kernel in f)
        if not mine:
            raise AssertionError("%s: no %s in its SASS" % (path, kernel))
        for f in mine:
            hmma, ldgsts, local = counts[f]
            use = usage.get(f, "REG:? STACK:? SHARED:? LOCAL:?")
            print("sass %s: %s; HMMA %d, LDGSTS %d, local loads/stores %d"
                  % (f, use, hmma, ldgsts, local))
            if hmma == 0 or (ldgsts == 0 and SYNC_STAGED not in f) \
                    or local or "STACK:0 " not in use \
                    or not use.endswith("LOCAL:0"):
                raise AssertionError("%s: not a spill-free tensor-core "
                                     "kernel fed by cp.async" % f)


def assert_close(what, got, want, atol=ATOL, rtol=RTOL):
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError("%s: kernel disagrees with its plain version "
                             "(max abs err %.3g)" % (what, err.max()))
    return float(err.max()) if err.numel() else 0.0


def time_ms(fn, reps=25, flush=None):
    """Median over ``reps`` runs of one call's device time (CUDA
    events), after warmup; ``flush`` runs before each timed call to
    evict the 50 MB L2 (the decode path finds its caches cold). A spin
    kernel ahead of each run keeps the device busy while the host
    enqueues the call, so the events bracket device time, not the
    host's launch overhead (a call that synchronises inside, like the
    plain decode version, still pays its host time)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda._sleep(1_000_000)   # ~0.5 ms at the H100's clocks
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_profile(step, n_steps, step_ms, label, share_of=None):
    """Profile ``n_steps`` calls of ``step`` with torch.profiler and print
    the card's busy share of ``step_ms`` (host wall time per step, taken
    without the profiler), the top-10 device kernels and, for
    ``share_of``, the device time of the kernels whose name holds it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
    # device-side events (kernels, copies): their intervals are device time
    by_kernel = {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            us, n = by_kernel.get(e.name, (0.0, 0))
            by_kernel[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    if not by_kernel:
        print("%s: host %.3f ms/step; device busy not measured (the "
              "profiler recorded no device events)" % (label, step_ms))
        return
    busy_ms = sum(us for us, _ in by_kernel.values()) / 1000.0 / n_steps
    ops = sum(n for _, n in by_kernel.values()) / n_steps
    print("%s: host %.3f ms/step; device busy %.3f ms/step (%.1f%%, idle "
          "%.1f%%); %.1f device ops/step"
          % (label, step_ms, busy_ms, 100.0 * busy_ms / step_ms,
             100.0 - 100.0 * busy_ms / step_ms, ops))
    for name, (us, n) in sorted(by_kernel.items(),
                                key=lambda kv: -kv[1][0])[:10]:
        print("  device %-70s %9.1f us/step %6.1f calls/step" % (
            name[:70], us / n_steps, n / n_steps))
    if share_of is not None:
        us = sum(u for k, (u, _) in by_kernel.items() if share_of in k)
        n = sum(c for k, (_, c) in by_kernel.items() if share_of in k)
        print("%s: %s %.3f ms/step in %.1f launches/step, %.1f%% of the "
              "device's busy time" % (label, share_of, us / 1000.0 / n_steps,
                                      n / n_steps,
                                      100.0 * us / 1000.0 / n_steps / busy_ms))


def lstm_inputs(B, T, H, peep, g, dev, ragged=True):
    """Seeded LSTM inputs on the card; ragged masks hold a row of length
    0 and a row of length T."""
    xg = torch.randn(B, T, 4 * H, generator=g) * 0.5
    w = torch.randn(H, 4 * H, generator=g) * H ** -0.5
    h0 = torch.randn(B, H, generator=g) * 0.1
    c0 = torch.randn(B, H, generator=g) * 0.1
    if ragged:
        lens = torch.randint(0, T + 1, (B,), generator=g)
        lens[0], lens[-1] = 0, T
    else:
        lens = torch.full((B,), T)
    mask = (torch.arange(T)[None] < lens[:, None]).float()
    p = torch.randn(3, H, generator=g) * 0.1 if peep else torch.zeros(3, H)
    dhs = torch.randn(B, T, H, generator=g)
    dcs = torch.randn(B, T, H, generator=g)
    return [t.to(dev) for t in (xg, w, h0, c0, mask, p, dhs, dcs)]


def check_lstm(lc, g, dev):
    """B3 and B4 against their plain versions: hs, cs; dxg, dW (through
    the GEMM outside the kernel), dh0, dc0, dpeep. Returns the max abs
    errors {kernel: err} and dW's."""
    err = {"lstm_fwd": 0.0, "lstm_bwd": 0.0}
    dw_err = 0.0
    for B, T, H in ((8, 5, 32), (LSTM_B, LSTM_T, HID), (37, 17, 128)):
        for peep in (True, False):
            xg, w, h0, c0, mask, p, dhs, dcs = lstm_inputs(B, T, H, peep,
                                                           g, dev)
            what = "lstm %s peep=%s" % ((B, T, H), peep)
            leaves = [t.clone().requires_grad_() for t in (xg, w, h0, c0, p)]
            hs, cs = lc.lstm_sequence(leaves[0], leaves[1], leaves[2],
                                      leaves[3], mask, leaves[4])
            got = torch.autograd.grad((hs, cs), leaves, (dhs, dcs))
            rhs, rcs, rst = lc.lstm_forward_reference(xg, w, h0, c0, mask, p)
            dxg, dh0, dc0, dp = lc.lstm_backward_reference(
                rst, rcs, w, p, c0, mask, dhs, dcs)
            h_prev = torch.cat([h0[:, None], rhs[:, :-1]], dim=1)
            dw = torch.einsum("bth,btg->hg", h_prev, dxg)
            for name, a, b in (("hs", hs, rhs), ("cs", cs, rcs)):
                err["lstm_fwd"] = max(err["lstm_fwd"], assert_close(
                    "%s %s" % (what, name), a.detach(), b,
                    LSTM_ATOL, LSTM_RTOL))
            for name, a, b in (("dxg", got[0], dxg), ("dW", got[1], dw),
                               ("dh0", got[2], dh0), ("dc0", got[3], dc0),
                               ("dpeep", got[4], dp)):
                atol = LSTM_ATOL * max(1.0, float(b.abs().max()))
                e = assert_close("%s %s" % (what, name), a, b, atol,
                                 LSTM_RTOL)
                if name == "dW":
                    dw_err = max(dw_err, e)
                else:
                    err["lstm_bwd"] = max(err["lstm_bwd"], e)
    torch.cuda.synchronize()
    return err, dw_err


def gru_inputs(B, T, H, g, dev, ragged=True):
    """Seeded GRU inputs on the card; ragged masks hold a row of length
    0 and a row of length T."""
    xg = torch.randn(B, T, 3 * H, generator=g) * 0.5
    w = torch.randn(H, 3 * H, generator=g) * H ** -0.5
    h0 = torch.randn(B, H, generator=g) * 0.1
    if ragged:
        lens = torch.randint(0, T + 1, (B,), generator=g)
        lens[0], lens[-1] = 0, T
    else:
        lens = torch.full((B,), T)
    mask = (torch.arange(T)[None] < lens[:, None]).float()
    dhs = torch.randn(B, T, H, generator=g)
    return [t.to(dev) for t in (xg, w, h0, mask, dhs)]


def check_gru(gc, g, dev):
    """B5 and B6 against their plain versions: hs and the stash; dxg, dW
    (through the GEMMs outside the kernel) and dh0. Returns the max abs
    errors {kernel: err} and dW's."""
    err = {"gru_fwd": 0.0, "gru_bwd": 0.0}
    dw_err = 0.0
    for B, T, H in ((8, 5, 32), (S2S_B, S2S_T, S2S["hidden_dim"]),
                    (37, 17, 128)):
        xg, w, h0, mask, dhs = gru_inputs(B, T, H, g, dev)
        what = "gru %s" % ((B, T, H),)
        leaves = [t.clone().requires_grad_() for t in (xg, w, h0)]
        hs = gc.gru_sequence(leaves[0], leaves[1], leaves[2], mask)
        got = torch.autograd.grad(hs, leaves, dhs)
        _, stash = gc.gru_forward(xg, w, h0, mask)
        rhs, rst = gc.gru_forward_reference(xg, w, h0, mask)
        dxg, dh0 = gc.gru_backward_reference(rst, rhs, w, h0, mask, dhs)
        h_prev = torch.cat([h0[:, None], rhs[:, :-1]], dim=1)
        dw = torch.cat([
            torch.einsum("bth,btg->hg", h_prev, dxg[..., :2 * H]),
            torch.einsum("bth,btg->hg", rst[..., H:2 * H] * h_prev,
                         dxg[..., 2 * H:])], dim=1)
        for name, a, b in (("hs", hs, rhs), ("stash", stash, rst)):
            err["gru_fwd"] = max(err["gru_fwd"], assert_close(
                "%s %s" % (what, name), a.detach(), b, LSTM_ATOL,
                LSTM_RTOL))
        for name, a, b in (("dxg", got[0], dxg), ("dW", got[1], dw),
                           ("dh0", got[2], dh0)):
            atol = LSTM_ATOL * max(1.0, float(b.abs().max()))
            e = assert_close("%s %s" % (what, name), a, b, atol, LSTM_RTOL)
            if name == "dW":
                dw_err = max(dw_err, e)
            else:
                err["gru_bwd"] = max(err["gru_bwd"], e)
    torch.cuda.synchronize()
    return err, dw_err


def stacked_lstm_batch(rng, B, T, min_len, dict_dim):
    """Ragged ids uniform in [1, dict_dim), lengths uniform in
    [min_len, T] with one row of length T; labels 0/1."""
    lens = rng.randint(min_len, T + 1, B)
    lens[rng.randint(B)] = T
    words = [rng.randint(1, dict_dim, (int(n), 1)).astype(np.int64)
             for n in lens]
    label = rng.randint(0, CLASSES, (B, 1)).astype(np.int64)
    return lens, words, label


def train_phase(fluid, seed, dev):
    """The stacked-LSTM training path at full width, then the card
    against the CPU at a reduced size. Returns the B3/B4 launch counts
    of the counted steps."""
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.kernels import lstm_cell as lc
    from paddle_tpu_torch.models.stacked_lstm import build_stacked_lstm_train

    with unique_name.guard():
        prog, startup, _, (loss, acc) = build_stacked_lstm_train(
            dict_dim=DICT, class_dim=CLASSES, emb_dim=EMB, hid_dim=HID,
            stacked_num=STACKED, lr=LR)
    startup.random_seed = seed
    scope = fluid.Scope()
    exe = fluid.Executor()                      # CUDAPlace(0)
    exe.run(startup, scope=scope)
    n_params = sum(p.numel() for n, p in scope.vars.items()
                   if prog.global_block().var(n).is_parameter)
    rng = np.random.RandomState(seed)
    lens, words, label = stacked_lstm_batch(rng, LSTM_B, LSTM_T, MIN_LEN,
                                            DICT)
    tokens = int(lens.sum())
    print("parameters: %d (%.1f MB fp32); batch %d sequences, lengths "
          "%d..%d, %d real tokens of %d padded" % (
              n_params, n_params * 4 / 1e6, LSTM_B, lens.min(), lens.max(),
              tokens, LSTM_B * LSTM_T))
    # the first step feeds the ragged list; the packed batch then stays
    # on the card
    packed = np.zeros((LSTM_B, LSTM_T, 1), np.int64)
    for i, w in enumerate(words):
        packed[i, :len(w)] = w
    on_card = {"words": fluid.PackedSeq(
        torch.from_numpy(packed).to(dev),
        torch.from_numpy(lens.astype(np.int32)).to(dev)),
        "label": torch.from_numpy(label).to(dev)}
    for i in range(WARMUP_STEPS):
        exe.run(prog, feed={"words": words, "label": label} if i == 0
                else on_card, fetch_list=[loss], scope=scope)
    torch.cuda.synchronize()
    lc.reset_launches()
    losses, accs = [], []
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        l_, a_ = exe.run(prog, feed=on_card, fetch_list=[loss, acc],
                         scope=scope)
        losses.append(float(l_))
        accs.append(float(a_))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(lc.launches)
    want = {"lstm_fwd": 2 * STACKED * TRAIN_STEPS,
            "lstm_bwd": STACKED * TRAIN_STEPS}
    print("launches on the main path:", json.dumps(launches),
          "expected", json.dumps(want),
          "(per step: %d lstm ops forward, %d lstm_grad ops, each "
          "recomputing its forward)" % (STACKED, STACKED))
    if launches != want:
        raise AssertionError("LSTM launch counts %s != %s"
                             % (launches, want))
    print("losses:", " ".join("%.6f" % v for v in losses))
    print("accuracy:", " ".join("%.4f" % v for v in accs))
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError("training loss not finite and falling: %s"
                             % losses)
    step_ms = wall * 1000.0 / TRAIN_STEPS
    print("train: %d steps in %.3f s = %.3f ms/step, %.2f sequences/s, "
          "%.1f tokens/s (real tokens)" % (
              TRAIN_STEPS, wall, step_ms, LSTM_B / (step_ms / 1e3),
              tokens / (step_ms / 1e3)))
    device_profile(lambda: exe.run(prog, feed=on_card, fetch_list=[loss],
                                   scope=scope),
                   1, step_ms, "train step")

    # the card against the CPU from the same weights, at a reduced size
    xlens, xwords, xlabel = stacked_lstm_batch(rng, XCHECK_B, XCHECK_T, 1,
                                               XCHECK["dict_dim"])

    def build():
        prog, startup, feeds, (xloss, _) = build_stacked_lstm_train(
            class_dim=CLASSES, lr=LR, **XCHECK)
        return prog, startup, feeds, (xloss,)

    cross_check(fluid, exe, build, seed, {"words": xwords, "label": xlabel},
                XCHECK_STEPS, "%s, B %d, T <= %d" % (XCHECK, XCHECK_B,
                                                     XCHECK_T))
    return launches


def grad_diff(names, got, want):
    """How far the gradients ``got`` lie from ``want``: the worst single
    entry as a share of its gradient's largest magnitude, the worst
    gradient in relative L2 norm, and all together in relative L2 norm."""
    d = dict(worst=0.0, worst_name="", pl2=0.0, pl2_name="")
    num = den = 0.0
    for name, g, w in zip(names, got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        e = float(np.abs(g - w).max()) / max(float(np.abs(w).max()), 1e-30)
        n2, d2 = float(((g - w) ** 2).sum()), float((w ** 2).sum())
        if e > d["worst"]:
            d["worst"], d["worst_name"] = e, name
        if (n2 / max(d2, 1e-300)) ** 0.5 > d["pl2"]:
            d["pl2"], d["pl2_name"] = (n2 / max(d2, 1e-300)) ** 0.5, name
        num += n2
        den += d2
    d["l2"] = (num / max(den, 1e-300)) ** 0.5
    return d


def check_grad_diff(what, d, gtol, l2tol, pl2tol=None):
    print("%s: worst entry %.3g x max|g| (%s), worst gradient %.3g of its "
          "L2 norm (%s), all together %.3g in relative L2 norm" % (
              what, d["worst"], d["worst_name"], d["pl2"], d["pl2_name"],
              d["l2"]))
    if d["worst"] > gtol or d["l2"] > l2tol or \
            (pl2tol is not None and d["pl2"] > pl2tol):
        raise AssertionError("%s: gradients differ by more than %g x "
                             "max|g|, %s of one gradient's L2 norm or %g "
                             "of all together" % (what, gtol, pl2tol, l2tol))


def cross_check(fluid, exe, build, seed, batch, steps, label, gtol=1e-4,
                ltol=1e-4, l2tol=1e-3, pl2tol=None, edit=None):
    """The card against the CPU from the same weights: the losses of
    ``steps`` optimizer steps within rtol ``ltol``, every first-step
    parameter gradient within ``gtol`` x its largest magnitude (and
    within ``pl2tol`` of its L2 norm, where given) and all of them
    together within ``l2tol`` in relative L2 norm. ``edit(prog, scope)``
    changes the CPU's weights before they are carried to the card.
    Returns the card's first-step loss and gradients, by name."""
    from paddle_tpu_torch import interop, unique_name

    with unique_name.guard():
        xprog, xstart, _, (xloss,) = build()
    xstart.random_seed = seed
    cpu_scope, card_scope = fluid.Scope(), fluid.Scope()
    cpu = fluid.Executor(fluid.CPUPlace())
    cpu.run(xstart, scope=cpu_scope)
    if edit is not None:
        edit(xprog, cpu_scope)
    interop.load_reference_state(
        {n: t.numpy() for n, t in cpu_scope.vars.items()}, card_scope,
        fluid.CUDAPlace(0), [xprog, xstart])
    grads = sorted(p.name + "@GRAD"
                   for p in xprog.global_block().all_parameters())
    first = None
    for step in range(steps):
        extra = grads if step == 0 else []
        c = cpu.run(xprog, feed=batch, fetch_list=[xloss] + extra,
                    scope=cpu_scope)
        k = exe.run(xprog, feed=batch, fetch_list=[xloss] + extra,
                    scope=card_scope)
        print("cross-check step %d: loss cpu %.7f card %.7f" % (
            step, float(c[0]), float(k[0])))
        np.testing.assert_allclose(k[0], c[0], rtol=ltol)
        if step == 0:
            first = dict(zip(["loss"] + grads, k))
            check_grad_diff("card vs cpu at %s, %d first-step gradients"
                            % (label, len(grads)),
                            grad_diff(grads, k[1:], c[1:]), gtol, l2tol,
                            pl2tol)
    print("card == cpu at %s: losses of %d steps within rtol %g" % (
        label, steps, ltol))
    torch.cuda.synchronize()
    return first


def seq2seq_batch(rng, B, T, min_len, vocab):
    """Ragged source and target ids uniform in [2, vocab), lengths
    uniform in [min_len, T] with one row of length T each; tgt_next is
    tgt shifted by one (tests/test_book.py)."""
    feed = {}
    for name in ("src_ids", "tgt_ids"):
        lens = rng.randint(min_len, T + 1, B)
        lens[rng.randint(B)] = T
        feed[name] = [rng.randint(2, vocab, (int(n), 1)).astype(np.int64)
                      for n in lens]
    feed["tgt_next_ids"] = [np.roll(t, -1, axis=0) for t in feed["tgt_ids"]]
    return feed


def seq2seq_phase(fluid, seed, dev):
    """The seq2seq training path at full width, then the card against
    the CPU at a reduced size. Returns the B5/B6 launch counts of the
    counted steps."""
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.kernels import gru_cell as gc
    from paddle_tpu_torch.models.seq2seq import build_seq2seq

    with unique_name.guard():
        prog, startup, _, (loss,) = build_seq2seq(lr=LR, **S2S)
    startup.random_seed = seed
    scope = fluid.Scope()
    exe = fluid.Executor()                      # CUDAPlace(0)
    exe.run(startup, scope=scope)
    n_params = sum(p.numel() for n, p in scope.vars.items()
                   if prog.global_block().var(n).is_parameter)
    rng = np.random.RandomState(seed)
    feed = seq2seq_batch(rng, S2S_B, S2S_T, S2S_MIN, S2S["tgt_vocab"])
    src_tok = sum(len(s) for s in feed["src_ids"])
    tgt_tok = sum(len(s) for s in feed["tgt_ids"])
    print("parameters: %d (%.1f MB fp32); batch %d pairs, %d source and "
          "%d target tokens (padded %d x %d each)" % (
              n_params, n_params * 4 / 1e6, S2S_B, src_tok, tgt_tok, S2S_B,
              S2S_T))
    # the first step feeds the ragged lists; the packed batch then stays
    # on the card
    on_card = {}
    for name, seqs in feed.items():
        packed = np.zeros((S2S_B, S2S_T, 1), np.int64)
        for i, s_ in enumerate(seqs):
            packed[i, :len(s_)] = s_
        lens = np.asarray([len(s_) for s_ in seqs], np.int32)
        on_card[name] = fluid.PackedSeq(torch.from_numpy(packed).to(dev),
                                        torch.from_numpy(lens).to(dev))
    for i in range(WARMUP_STEPS):
        exe.run(prog, feed=feed if i == 0 else on_card, fetch_list=[loss],
                scope=scope)
    torch.cuda.synchronize()
    gc.reset_launches()
    losses = []
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        losses.append(float(exe.run(prog, feed=on_card, fetch_list=[loss],
                                    scope=scope)[0]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(gc.launches)
    # per step: the two encoder GRUs forward, and each gru_grad op
    # recomputes its forward through the generic grad, then runs B6
    want = {"gru_fwd": 4 * TRAIN_STEPS, "gru_bwd": 2 * TRAIN_STEPS}
    print("launches on the main path:", json.dumps(launches),
          "expected", json.dumps(want),
          "(per step: 2 gru ops forward, 2 gru_grad ops, each recomputing "
          "its forward)")
    if launches != want:
        raise AssertionError("GRU launch counts %s != %s"
                             % (launches, want))
    print("losses:", " ".join("%.6f" % v for v in losses))
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError("training loss not finite and falling: %s"
                             % losses)
    step_ms = wall * 1000.0 / TRAIN_STEPS
    print("train: %d steps in %.3f s = %.3f ms/step, %.2f pairs/s, %.1f "
          "target tokens/s" % (TRAIN_STEPS, wall, step_ms,
                               S2S_B / (step_ms / 1e3),
                               tgt_tok / (step_ms / 1e3)))
    device_profile(lambda: exe.run(prog, feed=on_card, fetch_list=[loss],
                                   scope=scope),
                   1, step_ms, "seq2seq train step")

    xbatch = seq2seq_batch(rng, S2S_XCHECK_B, S2S_XCHECK_T, 1,
                           S2S_XCHECK["tgt_vocab"])
    # gradients within 1e-3 x max|g|: at initialisation the attention's
    # scores are nearly equal, so att_dec_w's gradient (~4e-8 at most,
    # for a loss of ~43) is a sum of terms that nearly cancel, and the
    # CPU's and the card's fp32 summation orders differ there by ~1.1e-4
    # of its largest value
    cross_check(fluid, exe, lambda: build_seq2seq(lr=LR, **S2S_XCHECK),
                seed, xbatch, XCHECK_STEPS,
                "%s, B %d, T <= %d" % (S2S_XCHECK, S2S_XCHECK_B,
                                       S2S_XCHECK_T), gtol=1e-3)
    return launches


def rel_close(what, got, want, rtol, amax):
    """|got - want| <= amax * max|want| + rtol * |want|; returns the max
    abs err."""
    got, want = got.to(torch.float64), want.to(torch.float64)
    err = (got - want).abs()
    tol = amax * float(want.abs().max()) + rtol * want.abs()
    if bool((err > tol).any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError("%s: disagrees (max abs err %.3g, max|want| "
                             "%.3g)" % (what, err.max(), want.abs().max()))
    return float(err.max())


def check_bn_grad(kbn, g, dev):
    """B7 against its plain version on the card, and both against the
    plain version in float64. Returns the float32 max abs err of dx
    against the plain version."""
    worst = 0.0
    for shape in BN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn(*shape, generator=g) * 1.5 + 0.7).to(dtype) \
                .to(dev)
            dy = torch.randn(*shape, generator=g).to(dtype).to(dev)
            scale = (torch.rand(shape[-1], generator=g) + 0.5).to(dev)
            got = kbn.bn_grad(x, dy, scale, 1e-5)
            plain = kbn.bn_grad_reference(x, dy, scale, 1e-5)
            truth = kbn.bn_grad_reference(x.double(), dy.double(),
                                          scale.double(), 1e-5)
            f32 = dtype == torch.float32
            what = "bn_grad %s %s" % (shape, dtype)
            errs = {}
            for ref_name, ref in (("plain", plain), ("float64", truth)):
                errs[ref_name] = [
                    rel_close("%s dx vs %s" % (what, ref_name), got[0],
                              ref[0], BN_RTOL if f32 else BF16_RTOL,
                              BN_AMAX if f32 else BF16_AMAX),
                    rel_close("%s dscale vs %s" % (what, ref_name), got[1],
                              ref[1], BN_RTOL, BN_AMAX),
                    rel_close("%s dbias vs %s" % (what, ref_name), got[2],
                              ref[2], BN_RTOL, BN_AMAX)]
            perr = [float((a.double() - b).abs().max())
                    for a, b in zip(plain, truth)]
            print("%s: max abs err (dx, dscale, dbias) kernel-plain "
                  "%.3g %.3g %.3g; kernel-float64 %.3g %.3g %.3g; "
                  "plain-float64 %.3g %.3g %.3g (max|dscale| %.3g)" % (
                      what, *errs["plain"], *errs["float64"], *perr,
                      float(truth[1].abs().max())))
            if f32:
                worst = max(worst, errs["plain"][0])
            again = kbn.bn_grad(x, dy, scale, 1e-5)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(what + ": two runs differ")
    torch.cuda.synchronize()
    return worst


def c1_path_shapes(fused):
    """{(B, Ci, H, W, Co): launches a step} of the 1x1 convolutions that
    resnet_expected_launches found in a config-B program."""
    shapes = {}
    for xshape, wshape in fused:
        key = (RESNET_B, xshape[1], xshape[2], xshape[3], wshape[0])
        shapes[key] = shapes.get(key, 0) + 1
    return shapes


def check_conv1x1(k1, g, dev, shapes):
    """B8 against its plain version on the card, and both against
    float64, at each (B, Ci, H, W, Co) of ``shapes``. Returns the float32
    max abs err of dx and dw against the plain version."""
    worst = 0.0
    for b, ci, h, w, co in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(b, ci, h, w, generator=g).to(dtype).to(dev)
            wt = (torch.randn(co, ci, 1, 1, generator=g) * ci ** -0.5) \
                .to(dtype).to(dev)
            dy = torch.randn(b, co, h, w, generator=g).to(dtype).to(dev)
            got = k1.conv1x1_bwd(x, wt, dy)
            plain = k1.conv1x1_bwd_reference(x, wt, dy)
            truth = k1.conv1x1_bwd_reference(x.double(), wt.double(),
                                             dy.double())
            f32 = dtype == torch.float32
            rtol, amax = (C1_RTOL, C1_AMAX) if f32 else (BF16_RTOL,
                                                         BF16_AMAX)
            what = "conv1x1_bwd %s %s" % ((b, ci, h, w, co), dtype)
            errs = {}
            for ref_name, ref in (("plain", plain), ("float64", truth)):
                errs[ref_name] = [
                    rel_close("%s %s vs %s" % (what, n, ref_name), a, r,
                              rtol, amax)
                    for n, a, r in (("dx", got[0], ref[0]),
                                    ("dw", got[1], ref[1]))]
            perr = [float((a.double() - r).abs().max())
                    for a, r in zip(plain, truth)]
            print("%s: max abs err (dx, dw) kernel-plain %.3g %.3g; "
                  "kernel-float64 %.3g %.3g; plain-float64 %.3g %.3g "
                  "(max|dw| %.3g)" % (what, *errs["plain"],
                                      *errs["float64"], *perr,
                                      float(truth[1].abs().max())))
            if f32:
                worst = max(worst, *errs["plain"])
            again = k1.conv1x1_bwd(x, wt, dy)
            if not all(torch.equal(a, r) for a, r in zip(got, again)):
                raise AssertionError(what + ": two runs differ")
    torch.cuda.synchronize()
    return worst


def c1_chunk_sweep(k1, build, g, dev):
    """dw's error against float64 at C1_SWEEP_SHAPE in float32 when its
    depth is cut into chunks of each length of C1_SWEEP_CHUNKS (the
    plan's other numbers as plan() works them out for that chunk): the
    longer a block's chain of tensor-core products, the more a truncating
    accumulation shows. Each must hold the path's tolerance."""
    b, ci, h, w, co = C1_SWEEP_SHAPE
    hw, j = h * w, b * h * w
    x = torch.randn(b, ci, h, w, generator=g).to(dev)
    wt = (torch.randn(co, ci, 1, 1, generator=g) * ci ** -0.5).to(dev)
    dy = torch.randn(b, co, h, w, generator=g).to(dev)
    truth = k1.conv1x1_bwd_reference(x.double(), wt.double(), dy.double())[1]
    top = float(truth.abs().max())
    pl = k1.plan(b, ci, co, hw)
    tiles = -(-co // pl.co_tile) * -(-ci // pl.ci_tile)
    lib = build.load("conv1x1_bwd")
    errs = []
    for chunk in C1_SWEEP_CHUNKS:
        splits = -(-j // chunk)
        group = math.isqrt(splits - 1) + 1
        partial = torch.empty((splits, co, ci), dtype=torch.float32,
                              device=dev)
        tickets = torch.zeros((tiles * (-(-splits // group) + 1),),
                              dtype=torch.int32, device=dev)
        dx, dw = torch.empty_like(x), torch.empty_like(wt)
        rc = lib.conv1x1_bwd(x.data_ptr(), wt.data_ptr(), dy.data_ptr(),
                             dx.data_ptr(), dw.data_ptr(),
                             partial.data_ptr(), tickets.data_ptr(), b, ci,
                             co, hw, splits, chunk, group, pl.order, 0,
                             pl.ci_tile, pl.co_tile, int(pl.vec),
                             torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError("conv1x1_bwd chunk %d: cudaError %d"
                               % (chunk, rc))
        err = (dw.double() - truth).abs()
        tol = C1_AMAX * top + C1_RTOL * truth.abs()
        e = float(err.max())
        errs.append((chunk, e, bool((err <= tol).all())
                     and bool(torch.isfinite(dw).all())))
    print("conv1x1_bwd %s float32 dw vs float64 by chunk length (max|dw| "
          "%.4g): %s" % (C1_SWEEP_SHAPE, top, "; ".join(
              "chunk %d: %.4g (%.3g of max)%s" % (c, e, e / top,
                                                  "" if ok else " OUTSIDE")
              for c, e, ok in errs)))
    if not all(ok for _, _, ok in errs):
        raise AssertionError("conv1x1_bwd: dw outside rtol %g + %g max at "
                             "some chunk length" % (C1_RTOL, C1_AMAX))
    torch.cuda.synchronize()


def resnet_build(config, sizes):
    """ResNet-50 in config "A" (nhwc+reductions) or "B" (nchw; the
    caller turns FLAGS_fused_conv1x1_bwd on)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.resnet import build_resnet50_train

    prog, startup, feeds, (loss, acc) = build_resnet50_train(
        layout="NHWC" if config == "A" else "NCHW", **sizes)
    if config == "A":
        fluid.passes.enable(prog, layout="NHWC", pallas_reductions=True)
    return prog, startup, feeds, (loss, acc)


def resnet_damp(prog, scope):
    """Multiply the scale of the last batch norm of every residual
    branch by RESNET_DAMP (see there)."""
    ops = prog.global_block().ops
    branch = {op.input("Y")[0] for op in ops if op.type == "elementwise_add"}
    n = 0
    for op in ops:
        if op.type == "batch_norm" and op.output("Y")[0] in branch:
            name = op.input("Scale")[0]
            scope.set_var(name, scope.find_var(name) * RESNET_DAMP)
            n += 1
    return n


def resnet_expected_launches(prog):
    """Launches a step, worked out from the program as built: one B7 for
    every batch_norm op (the reduction pass tags each one's grad in an
    NHWC program), one B8 for every conv2d that is 1x1, stride 1,
    unpadded, undilated and ungrouped. In ResNet-50 those are the 16
    conv3 of the bottlenecks, 13 conv1 (all but the stride-2 ones that
    open stages 2-4) and the one stride-1 shortcut of stage 1."""
    block = prog.global_block()
    n_bn = sum(op.type == "batch_norm" for op in block.ops)
    fused = []
    for op in block.ops:
        if op.type != "conv2d":
            continue
        wshape = block.var(op.input("Filter")[0]).shape
        a = op.attrs
        if tuple(wshape[2:]) == (1, 1) and list(a["strides"]) == [1, 1] \
                and not any(a["paddings"]) \
                and list(a["dilations"]) == [1, 1] \
                and (a.get("groups", 1) or 1) == 1:
            fused.append((block.var(op.input("Input")[0]).shape, wshape))
    return n_bn, fused


def resnet_phase(fluid, seed, dev):
    """ResNet-50 at full width in configs A and B, A against B, and the
    card against the CPU at the resnet_cifar size. Returns the B7/B8
    launch counts of the counted steps and the path's kernel shapes."""
    from paddle_tpu_torch import flags, unique_name
    from paddle_tpu_torch.kernels import bn_grad as kbn
    from paddle_tpu_torch.kernels import conv1x1_bwd as k1

    def set_fused(on):
        flags.set_flags({"FLAGS_fused_conv1x1_bwd": on})

    progs = {}
    for config in ("A", "B"):
        with unique_name.guard():
            progs[config] = resnet_build(config, RESNET)
    n_bn, fused = resnet_expected_launches(progs["B"][0])
    print("per step, from the program: %d batch_norm ops -> %d B7 launches "
          "in config A; %d of %d conv2d ops are 1x1 stride-1 -> %d B8 "
          "launches in config B" % (
              n_bn, n_bn, len(fused),
              sum(op.type == "conv2d"
                  for op in progs["B"][0].global_block().ops), len(fused)))
    if (n_bn, len(fused)) != (53, 30):
        raise AssertionError("ResNet-50 should hold 53 batch norms and 30 "
                             "fusable convolutions, got %d and %d"
                             % (n_bn, len(fused)))

    # one set of weights for everything below
    startup = progs["B"][1]
    startup.random_seed = seed
    scope0 = fluid.Scope()
    exe = fluid.Executor()                      # CUDAPlace(0)
    exe.run(startup, scope=scope0)
    block = progs["B"][0].global_block()
    n_params = sum(t.numel() for n, t in scope0.vars.items()
                   if block.var(n).is_parameter)
    print("parameters: %d (%.1f MB fp32); batch %d images %s" % (
        n_params, n_params * 4 / 1e6, RESNET_B, RESNET["image_shape"]))

    def clone(scope):
        out = fluid.Scope()
        for n, t in scope.vars.items():
            out.set_var(n, t.clone())
        return out

    rng = np.random.RandomState(seed)
    images = rng.randn(RESNET_B, *RESNET["image_shape"]).astype(np.float32)
    labels = rng.randint(0, RESNET["class_dim"],
                         (RESNET_B, 1)).astype(np.int64)
    feeds = {
        "A": {"data": torch.from_numpy(np.ascontiguousarray(
            images.transpose(0, 2, 3, 1))).to(dev),
            "label": torch.from_numpy(labels).to(dev)},
        "B": {"data": torch.from_numpy(images).to(dev),
              "label": torch.from_numpy(labels).to(dev)}}

    # ---- A against B: same weights, same batch, first step ----
    grads = sorted(p.name + "@GRAD" for p in block.all_parameters())
    first = {}
    for config in ("A", "B"):
        prog, _, _, (loss, _) = progs[config]
        scope = clone(scope0)
        resnet_damp(prog, scope)
        set_fused(config == "B")
        try:
            first[config] = exe.run(prog, feed=feeds[config],
                                    fetch_list=[loss.name] + grads,
                                    scope=scope)
        finally:
            set_fused(False)
        del scope
    la, lb = float(first["A"][0]), float(first["B"][0])
    print("A vs B on the card, same weights (residual branches damped x%g) "
          "and batch: first-step loss A %.7f B %.7f" % (RESNET_DAMP, la, lb))
    np.testing.assert_allclose(la, lb, rtol=1e-4)
    check_grad_diff("A vs B at full width, %d gradients" % len(grads),
                    grad_diff(grads, first["A"][1:], first["B"][1:]),
                    RESNET_AB_GTOL, RESNET_AB_L2TOL, RESNET_AB_PL2TOL)
    del first
    torch.cuda.empty_cache()

    # ---- train each config ----
    launches = {}
    for config, name in (("A", "nhwc+reductions"), ("B", "nchw+fused1x1")):
        prog, _, _, (loss, acc) = progs[config]
        scope = clone(scope0)
        feed = feeds[config]
        set_fused(config == "B")
        try:
            torch.cuda.reset_peak_memory_stats()
            for _ in range(WARMUP_STEPS):
                exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
            torch.cuda.synchronize()
            kbn.reset_launches()
            k1.reset_launches()
            losses, accs = [], []
            t0 = time.perf_counter()
            for _ in range(TRAIN_STEPS):
                l_, a_ = exe.run(prog, feed=feed, fetch_list=[loss, acc],
                                 scope=scope)
                losses.append(float(l_))
                accs.append(float(a_))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = {"bn_grad": kbn.launches["bn_grad"],
                   "conv1x1_bwd": k1.launches["conv1x1_bwd"]}
            want = {"bn_grad": n_bn * TRAIN_STEPS if config == "A" else 0,
                    "conv1x1_bwd": len(fused) * TRAIN_STEPS
                    if config == "B" else 0}
            print("config %s (%s): launches on the main path: %s expected "
                  "%s" % (config, name, json.dumps(got), json.dumps(want)))
            if got != want:
                raise AssertionError("ResNet-50 config %s launch counts %s "
                                     "!= %s" % (config, got, want))
            launches["bn_grad" if config == "A" else "conv1x1_bwd"] = \
                got["bn_grad" if config == "A" else "conv1x1_bwd"]
            print("losses:", " ".join("%.6f" % v for v in losses))
            print("accuracy:", " ".join("%.4f" % v for v in accs))
            # Momentum at lr 0.1 from the initial weights overshoots on
            # the one repeated batch before it settles: the loss must be
            # finite throughout and fall below the first counted loss
            # within RESNET_SETTLE_STEPS further steps
            more = []
            while len(more) < RESNET_SETTLE_STEPS and \
                    not min(losses[1:] + more) < losses[0]:
                more.append(float(exe.run(prog, feed=feed, fetch_list=[loss],
                                          scope=scope)[0]))
            if more:
                print("further steps until the loss is under the first "
                      "counted one:", " ".join("%.6f" % v for v in more))
            if not np.isfinite(losses + more).all() or \
                    not min(losses[1:] + more) < losses[0]:
                raise AssertionError("training loss not finite and "
                                     "falling: %s" % (losses + more))
            # the same weights at the lower lr: the loss falls at
            # every step
            low = clone(scope0)
            lr_name = next(op.input("LearningRate")[0]
                           for op in prog.global_block().ops
                           if op.type == "momentum")
            low.set_var(lr_name, torch.full_like(low.find_var(lr_name),
                                                 RESNET_LOW_LR))
            low_losses = [float(exe.run(prog, feed=feed, fetch_list=[loss],
                                        scope=low)[0])
                          for _ in range(RESNET_LOW_LR_STEPS + 1)]
            del low
            print("losses at lr %g:" % RESNET_LOW_LR,
                  " ".join("%.6f" % v for v in low_losses))
            if not np.isfinite(low_losses).all() or \
                    not (np.diff(low_losses) < 0).all():
                raise AssertionError("training loss at lr %g does not fall "
                                     "at every step: %s"
                                     % (RESNET_LOW_LR, low_losses))
            step_ms = wall * 1000.0 / TRAIN_STEPS
            print("config %s train: %d steps in %.3f s = %.3f ms/step, "
                  "%.2f images/s; peak device memory %.2f GB" % (
                      config, TRAIN_STEPS, wall, step_ms,
                      RESNET_B / (step_ms / 1e3),
                      torch.cuda.max_memory_allocated() / 1e9))
            device_profile(lambda: exe.run(prog, feed=feed,
                                           fetch_list=[loss], scope=scope),
                           1, step_ms, "resnet50 config %s step" % config,
                           share_of=None if config == "A"
                           else "conv1x1_bwd_kernel")
            if config == "B":
                # the same program with the flag off: the library's two
                # backward convolutions where B8 ran, for comparison of
                # the device time inside one step
                set_fused(False)
                before = k1.launches["conv1x1_bwd"]
                exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(3):
                    exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
                torch.cuda.synchronize()
                device_profile(
                    lambda: exe.run(prog, feed=feed, fetch_list=[loss],
                                    scope=scope),
                    1, (time.perf_counter() - t0) * 1000.0 / 3,
                    "resnet50 config B step with the flag off (library "
                    "backward, no B8)")
                if k1.launches["conv1x1_bwd"] != before:
                    raise AssertionError("B8 launched with the flag off")
        finally:
            set_fused(False)
        del scope
        torch.cuda.empty_cache()

    # ---- the card against the CPU at the resnet_cifar size ----
    xrng = np.random.RandomState(seed + 1)
    ximages = xrng.randn(RESNET_XCHECK_B,
                         *RESNET_XCHECK["image_shape"]).astype(np.float32)
    xlabels = xrng.randint(0, RESNET_XCHECK["class_dim"],
                           (RESNET_XCHECK_B, 1)).astype(np.int64)
    on_card = {}
    for config in ("A", "B"):
        x = ximages if config == "B" else np.ascontiguousarray(
            ximages.transpose(0, 2, 3, 1))

        def build():
            prog, startup, fds, (loss, _) = resnet_build(config,
                                                         RESNET_XCHECK)
            return prog, startup, fds, (loss,)

        set_fused(config == "B")
        kbn.reset_launches()
        k1.reset_launches()
        try:
            on_card[config] = cross_check(
                fluid, exe, build, seed, {"data": x, "label": xlabels},
                XCHECK_STEPS, "config %s, %s, batch %d, residual branches "
                "damped x%g" % (config, RESNET_XCHECK, RESNET_XCHECK_B,
                                RESNET_DAMP),
                gtol=RESNET_GTOL, ltol=1e-3, l2tol=RESNET_L2TOL,
                pl2tol=RESNET_PL2TOL, edit=resnet_damp)
        finally:
            set_fused(False)
        print("cross-check launches on the card:",
              json.dumps({**kbn.launches, **k1.launches}))
        want = (n_bn * XCHECK_STEPS, 0) if config == "A" \
            else (0, len(fused) * XCHECK_STEPS)
        if (kbn.launches["bn_grad"], k1.launches["conv1x1_bwd"]) != want:
            raise AssertionError("cross-check launch counts")
    # the two configs' startups draw the same weights, so the card's two
    # runs are also A against B at this size, B7 in one and B8 in the
    # other
    names = sorted(n for n in on_card["A"] if n != "loss")
    np.testing.assert_allclose(on_card["A"]["loss"], on_card["B"]["loss"],
                               rtol=1e-5)
    check_grad_diff("A vs B on the card at %s" % RESNET_XCHECK,
                    grad_diff(names, [on_card["A"][n] for n in names],
                              [on_card["B"][n] for n in names]),
                    RESNET_GTOL, RESNET_L2TOL, RESNET_PL2TOL)

    bn_shapes = {}
    for op in progs["A"][0].global_block().ops:
        if op.type == "batch_norm":
            c, h, w = progs["B"][0].global_block().var(
                op.input("X")[0]).shape[1:]
            key = (RESNET_B, h, w, c)
            bn_shapes[key] = bn_shapes.get(key, 0) + 1
    return launches, bn_shapes, c1_path_shapes(fused)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    # ---- 1. device ----
    phase("device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False)")
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import layers, unique_name
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import bn_grad as kbn
    from paddle_tpu_torch.kernels import conv1x1_bwd as k1
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import gru_cell as gc
    from paddle_tpu_torch.kernels import lstm_cell as lc
    from paddle_tpu_torch.models.transformer import (
        build_transformer_decode, transformer_lm)
    from paddle_tpu_torch.serving import DecodeEngine, DecodeLoop

    dev = torch.device("cuda", 0)
    card = card_line()
    print("card:", card)
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          "python", sys.version.split()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32 off for float32 matmul and cudnn")

    # ---- 2. build ----
    phase("build")
    t0 = time.perf_counter()
    _build.load_all()
    print("built %s in %.2f s (nvcc %s)" % (
        sorted(_build.SOURCES), time.perf_counter() - t0,
        " ".join(_build.NVCC_FLAGS)))
    sass_check(_build)

    # ---- 3. kernels against their plain versions ----
    phase("kernels vs plain versions (atol %g, rtol %g; LSTM and GRU "
          "atol %g, rtol %g; bn_grad rtol %g + %g max|ref|; conv1x1_bwd "
          "rtol %g + %g max|ref|; bfloat16 rtol %g + %g max|ref|)" % (
              ATOL, RTOL, LSTM_ATOL, LSTM_RTOL, BN_RTOL, BN_AMAX, C1_RTOL,
              C1_AMAX, BF16_RTOL, BF16_AMAX))
    g = torch.Generator(device="cpu").manual_seed(args.seed)
    max_err = {"flash_attention": 0.0, "flash_decode": 0.0}

    def randn(*shape):
        return torch.randn(*shape, generator=g).to(dev)

    cases = [(1, 8, s, d) for s in (8, 16, 32, 128, 200) for d in (64, 128)]
    cases.append((1, 8, 160, 64))
    for b, h, s, d in cases:
        q, k, v = randn(b, h, s, d), randn(b, h, s, d), randn(b, h, s, d)
        seg = torch.sort(torch.randint(0, 3, (b, s), generator=g),
                         dim=1)[0].to(torch.int32).to(dev)
        for causal in (False, True):
            for segs in (None, (seg, seg)):
                ko, kl = fa.flash_attention(q, k, v, causal=causal,
                                            segment_ids=segs,
                                            return_lse=True)
                ro, rl = fa.flash_attention_reference(q, k, v, causal,
                                                      None, segs)
                what = "flash_attention %s causal=%s seg=%s" % (
                    (b, h, s, d), causal, segs is not None)
                e = max(assert_close(what + " O", ko, ro),
                        assert_close(what + " lse", kl, rl))
                max_err["flash_attention"] = max(
                    max_err["flash_attention"], e)
    torch.cuda.synchronize()
    b, h, s, d = SLOTS, N_HEADS, MAX_LEN, D_MODEL // N_HEADS
    q, kc, vc = randn(b, h, 1, d), randn(b, h, s, d), randn(b, h, s, d)
    lens = torch.tensor([0, 1, 127, 128, 129, 300, 512] * 3,
                        dtype=torch.int32)[:b].to(dev)
    max_err["flash_decode"] = assert_close(
        "flash_decode %s lens %s" % ((b, h, s, d), lens.tolist()),
        fa.flash_decode(q, kc, vc, lens),
        fa.flash_decode_reference(q, kc, vc, lens))
    if float(fa.flash_decode(q, kc, vc, lens)[0].abs().max()) != 0.0:
        raise AssertionError("flash_decode: an empty cache row is not 0")
    torch.cuda.synchronize()
    lstm_err, dw_err = check_lstm(lc, g, dev)
    max_err.update(lstm_err)
    gru_err, gru_dw_err = check_gru(gc, g, dev)
    max_err.update(gru_err)
    max_err["bn_grad"] = check_bn_grad(kbn, g, dev)
    # B8 at every distinct shape the config-B program gives it
    with unique_name.guard():
        c1_path = c1_path_shapes(resnet_expected_launches(
            resnet_build("B", RESNET)[0])[1])
    max_err["conv1x1_bwd"] = check_conv1x1(
        k1, g, dev, sorted(c1_path) + list(C1_EXTRA_SHAPES))
    c1_chunk_sweep(k1, _build, g, dev)
    print("max abs err:", json.dumps(max_err), "(dW through the outside "
          "GEMMs: LSTM %.3g, GRU %.3g)" % (dw_err, gru_dw_err))

    # ---- 4. the slice at full width ----
    phase("decode serving at full width (seed %d)" % args.seed)
    scope = fluid.Scope()
    with unique_name.guard():
        prog, startup = fluid.Program(), fluid.Program()
        startup.random_seed = args.seed
        with fluid.program_guard(prog, startup):
            tokens = layers.data("tokens", [-1], dtype="int64")
            logits_var = transformer_lm(
                tokens, VOCAB, d_model=D_MODEL, num_layers=N_LAYERS,
                num_heads=N_HEADS, max_len=MAX_LEN)
    exe = fluid.Executor()                      # CUDAPlace(0)
    exe.run(startup, scope=scope)
    n_params = sum(t.numel() for t in scope.vars.values())
    print("parameters: %d (%.1f MB fp32) on %s" % (
        n_params, n_params * 4 / 1e6, scope.find_var("fc_0.w_0").device))

    prefill, decode, meta = build_transformer_decode(
        vocab_size=VOCAB, d_model=D_MODEL, num_layers=N_LAYERS,
        num_heads=N_HEADS, max_len=MAX_LEN)
    engine = DecodeEngine(prefill, decode, meta, num_slots=SLOTS,
                          prompt_buckets=BUCKETS, scope=scope)
    t0 = time.perf_counter()
    engine.warmup()
    warmup_s = time.perf_counter() - t0
    if engine.compile_count() != len(BUCKETS) + 1:
        raise AssertionError("compile_count %d" % engine.compile_count())
    print("KV cache %.1f MB; warmup %.2f s; compile_count %d" % (
        engine.new_cache().nbytes() / 1e6, warmup_s,
        engine.compile_count()))

    rng = np.random.RandomState(args.seed)
    workload = [(rng.randint(1, VOCAB, rng.randint(3, 31)),
                 LONG_NEW if i % 2 == 0 else SHORT_NEW)
                for i in range(N_REQUESTS)]
    torch.cuda.synchronize()
    fa.reset_launches()
    loop = DecodeLoop(engine, max_queue=N_REQUESTS, name="chip-smoke")
    t0 = time.perf_counter()
    try:
        gens = [loop.submit(p, max_new_tokens=m) for p, m in workload]
        outs = [gen.result(timeout=600) for gen in gens]
    finally:
        if not loop.close(timeout=120):
            raise RuntimeError("decode loop did not drain")
    wall = time.perf_counter() - t0
    launches = dict(fa.launches)
    steps = loop.steps_dispatched()
    toks = sum(len(o[0]) for o in outs)
    for (got, reason), (p, m) in zip(outs, workload):
        if reason != "length" or len(got) != m:
            raise AssertionError("request %s: %s after %d tokens"
                                 % (p.tolist(), reason, len(got)))
    want = {"flash_attention": N_LAYERS * N_REQUESTS,
            "flash_decode": N_LAYERS * steps}
    print("launches on the main path:", json.dumps(launches),
          "expected", json.dumps(want))
    if launches != want:
        raise AssertionError("kernel launch counts %s != %s"
                             % (launches, want))
    gaps = [b_ - a_ for gen in gens
            for a_, b_ in zip(gen.token_times, gen.token_times[1:])]
    gaps_ms = np.asarray(gaps) * 1000.0
    p50, p99 = (float(np.percentile(gaps_ms, p)) for p in (50, 99))
    ttft_ms = np.asarray([gen.token_times[0] - gen.submitted
                          for gen in gens]) * 1000.0
    occupancy = (toks - N_REQUESTS) / float(max(steps, 1) * SLOTS)
    print("decode: %d requests, %d tokens in %.3f s = %.2f tokens/s; "
          "%d steps (%.3f ms/step); per-token gap p50 %.3f ms p99 %.3f ms "
          "(%d gaps); time to first token p50 %.3f ms max %.3f ms; "
          "occupancy %.3f" % (
              N_REQUESTS, toks, wall, toks / wall, steps,
              wall * 1000.0 / steps, p50, p99, len(gaps),
              float(np.median(ttft_ms)), float(ttft_ms.max()), occupancy))

    # the result: greedy tokens == argmax of the one-shot logits
    fa.reset_launches()
    checked = 0
    for (got, _), (p, _m) in list(zip(outs, workload))[:3]:
        seq = np.concatenate([p, got[:-1]]).reshape(1, -1)
        out, = exe.run(prog, feed={"tokens": seq}, fetch_list=[logits_var],
                       scope=scope)
        if out.shape != (1, seq.shape[1], VOCAB) or \
                not np.isfinite(out).all():
            raise AssertionError("one-shot logits %s not finite/shaped"
                                 % (out.shape,))
        ref = out[0, len(p) - 1:]
        expect = np.argmax(ref, -1)
        top2 = np.sort(ref, -1)[:, -2:]
        for i, (a_, b_) in enumerate(zip(got, expect)):
            if a_ != b_:
                gap = float(top2[i, 1] - top2[i, 0])
                print("  mismatch at token %d: decode %d one-shot %d, "
                      "one-shot top-2 gap %.3g" % (i, a_, b_, gap))
                if gap >= 1e-4:
                    raise AssertionError("greedy decode disagrees with "
                                         "the one-shot argmax")
        checked += len(got)
    if fa.launches["flash_attention"] != 3 * N_LAYERS:
        raise AssertionError("one-shot launches %s" % fa.launches)
    print("greedy == one-shot argmax on %d tokens of 3 requests" % checked)
    torch.cuda.synchronize()

    # ---- 5. the training slice at full width ----
    phase("stacked-LSTM training at full width (seed %d)" % args.seed)
    launches.update(train_phase(fluid, args.seed, dev))

    # ---- 6. the seq2seq training slice at full width ----
    phase("seq2seq training at full width (seed %d)" % args.seed)
    launches.update(seq2seq_phase(fluid, args.seed, dev))

    # ---- 7. the convnet training slice at full width ----
    phase("ResNet-50 training at full width, configs A and B (seed %d)"
          % args.seed)
    resnet_launches, bn_shapes, c1_shapes = resnet_phase(fluid, args.seed,
                                                         dev)
    launches.update(resnet_launches)

    # ---- 8. times ----
    phase("times (CUDA events, median of 25 runs after warmup; 10 runs for "
          "bn_grad and conv1x1_bwd)")
    flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)

    def flush():
        flush_buf.zero_()

    rows = []
    kv_shape = (SLOTS, N_HEADS, MAX_LEN, D_MODEL // N_HEADS)
    kc, vc = randn(*kv_shape), randn(*kv_shape)
    q1 = randn(SLOTS, N_HEADS, 1, kv_shape[3])
    for L in (MAX_LEN, 160):
        lens = torch.full((SLOTS,), L, dtype=torch.int32, device=dev)
        mask = (torch.arange(MAX_LEN, device=dev)[None, :]
                < lens[:, None])[:, None, None, :]
        bh, dh = SLOTS * N_HEADS, kv_shape[3]
        rows.append(dict(
            name="flash_decode", shape="[16,8,512,64] cache_len=%d" % L,
            ms=time_ms(lambda: fa.flash_decode(q1, kc, vc, lens), flush=flush),
            plain_ms=time_ms(lambda: fa.flash_decode_reference(
                q1, kc, vc, lens), flush=flush),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q1, kc, vc, attn_mask=mask), flush=flush),
            bytes=4 * (2 * bh * dh + 2 * bh * L * dh + SLOTS),
            flops=4 * bh * L * dh))
    # B1 at the prefill buckets, the one-shot forward of the 160-token
    # check, the transformer training shape (bench.py's [16,8,512,64]) and
    # the same with the widest head the kernel takes
    for b, s, causal, d in ((1, 8, True, 64), (1, 16, True, 64),
                            (1, 32, True, 64), (1, 160, True, 64),
                            (16, 512, True, 64), (16, 512, True, 128)):
        q, k, v = (randn(b, N_HEADS, s, d) for _ in range(3))
        pairs = s * (s + 1) // 2 if causal else s * s
        rows.append(dict(
            name="flash_attention",
            shape="[%d,8,%d,%d] causal=%s" % (b, s, d, causal),
            ms=time_ms(lambda: fa.flash_attention(q, k, v, causal=causal)),
            plain_ms=time_ms(lambda: fa.flash_attention_reference(
                q, k, v, causal), reps=5 if b > 1 else 25),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal)),
            library="torch.nn.functional.scaled_dot_product_attention, "
                    "float32, causal, TF32 off",
            bytes=4 * (4 * b * N_HEADS * s * d + b * N_HEADS * s),
            flops=4 * b * N_HEADS * pairs * d, tf32x3=True))
    # B3 and B4 at the training path's shape, every step valid
    B, T, H = LSTM_B, LSTM_T, HID
    xg, w, h0, c0, mask, p, dhs, dcs = lstm_inputs(B, T, H, True, g, dev,
                                                   ragged=False)
    _, cs, stash = lc.lstm_forward(xg, w, h0, c0, mask, p)
    cudnn = torch.nn.LSTM(H, H, batch_first=True).to(dev)
    x_in = torch.randn(B, T, H, generator=g).to(dev)
    gout = torch.randn(B, T, H, generator=g).to(dev)

    def cudnn_fwd():
        with torch.no_grad():
            cudnn(x_in)

    def cudnn_fwd_bwd():
        out, _ = cudnn(x_in)
        out.backward(gout)

    rows.append(dict(
        name="lstm_fwd", shape="[64,80,512] peep, all steps valid",
        ms=time_ms(lambda: lc.lstm_forward(xg, w, h0, c0, mask, p)),
        plain_ms=time_ms(lambda: lc.lstm_forward_reference(
            xg, w, h0, c0, mask, p)),
        library_ms=time_ms(cudnn_fwd),
        library="torch.nn.LSTM (cuDNN) forward, input size 512, no "
                "peepholes: also does the input GEMM",
        bytes=4 * (2 * B * T * 4 * H + H * 4 * H + 3 * H + 2 * B * H
                   + B * T + 2 * B * T * H),
        flops=2 * B * T * H * 4 * H))
    rows.append(dict(
        name="lstm_bwd", shape="[64,80,512] peep, all steps valid",
        ms=time_ms(lambda: lc.lstm_backward(stash, cs, w, p, c0, mask, dhs,
                                            dcs)),
        plain_ms=time_ms(lambda: lc.lstm_backward_reference(
            stash, cs, w, p, c0, mask, dhs, dcs)),
        library_ms=time_ms(cudnn_fwd_bwd),
        library="torch.nn.LSTM (cuDNN) forward plus backward, input size "
                "512, no peepholes: also does the input GEMMs and dW",
        bytes=4 * (2 * B * T * 4 * H + 3 * B * T * H + H * 4 * H + 2 * 3 * H
                   + 3 * B * H + B * T),
        flops=2 * B * T * 4 * H * H))
    # B5 and B6 at the seq2seq path's shape, every step valid
    B, T, H = S2S_B, S2S_T, S2S["hidden_dim"]
    xg, w, h0, mask, dhs = gru_inputs(B, T, H, g, dev, ragged=False)
    hs, stash = gc.gru_forward(xg, w, h0, mask)
    cudnn_gru = torch.nn.GRU(H, H, batch_first=True).to(dev)
    x_gru = torch.randn(B, T, H, generator=g).to(dev)
    g_gru = torch.randn(B, T, H, generator=g).to(dev)

    def cudnn_gru_fwd():
        with torch.no_grad():
            cudnn_gru(x_gru)

    def cudnn_gru_fwd_bwd():
        out, _ = cudnn_gru(x_gru)
        out.backward(g_gru)

    rows.append(dict(
        name="gru_fwd", shape="[64,30,512], all steps valid",
        ms=time_ms(lambda: gc.gru_forward(xg, w, h0, mask)),
        plain_ms=time_ms(lambda: gc.gru_forward_reference(xg, w, h0, mask)),
        library_ms=time_ms(cudnn_gru_fwd),
        library="torch.nn.GRU (cuDNN) forward, input size 512: applies r "
                "after the product (r * (h W_hn)) where Paddle takes "
                "(r * h) W_c, and also does the input GEMM",
        bytes=4 * (2 * B * T * 3 * H + H * 3 * H + B * H + B * T
                   + B * T * H),
        flops=2 * B * T * H * 3 * H))
    rows.append(dict(
        name="gru_bwd", shape="[64,30,512], all steps valid",
        ms=time_ms(lambda: gc.gru_backward(stash, hs, w, h0, mask, dhs)),
        plain_ms=time_ms(lambda: gc.gru_backward_reference(
            stash, hs, w, h0, mask, dhs)),
        library_ms=time_ms(cudnn_gru_fwd_bwd),
        library="torch.nn.GRU (cuDNN) forward plus backward, input size "
                "512: r after the product, and also the input GEMMs and dW",
        bytes=4 * (2 * B * T * 3 * H + 2 * B * T * H + H * 3 * H
                   + 2 * B * H + B * T),
        flops=2 * B * T * 3 * H * H))
    # B7 at every distinct shape of the ResNet-50 path (kernel only), and
    # with its plain version and the library at the largest (the stem)
    # and the smallest; the activations exceed the L2, so no flush
    def bn_case(shape, full):
        n, h, w, c = shape
        x = torch.randn(*shape, generator=g).to(dev)
        dy = torch.randn(*shape, generator=g).to(dev)
        sc = (torch.rand(c, generator=g) + 0.5).to(dev)
        row = dict(name="bn_grad", shape="%s x%d a step" % (
            list(shape), bn_shapes[shape]),
            ms=time_ms(lambda: kbn.bn_grad(x, dy, sc, 1e-5), reps=10),
            plain_ms=float("nan"), library_ms=float("nan"),
            bytes=4 * (5 * x.numel() + 3 * c), flops=12 * x.numel(),
            per_step=bn_shapes[shape])
        if full:
            xr = x.permute(0, 3, 1, 2).requires_grad_()
            dyr = dy.permute(0, 3, 1, 2)

            def library():
                y = F.batch_norm(xr, None, None, sc, None, True, 0.1, 1e-5)
                torch.autograd.grad(y, xr, dyr)

            row["plain_ms"] = time_ms(
                lambda: kbn.bn_grad_reference(x, dy, sc, 1e-5), reps=10)
            row["library_ms"] = time_ms(library, reps=10)
            row["library"] = ("torch.nn.functional.batch_norm forward "
                              "plus torch.autograd.grad to x, channels "
                              "last: also runs the forward, gives no "
                              "dscale or dbias")
        return row

    by_size = sorted(bn_shapes, key=lambda s_: s_[0] * s_[1] * s_[2] * s_[3])
    bn_rows = [bn_case(s_, s_ in (by_size[0], (64, 112, 112, 64)))
               for s_ in sorted(bn_shapes, key=lambda s_: (-s_[1], s_[3]))]
    rows.extend(bn_rows)

    # B8 at every distinct shape of the ResNet-50 path, beside its plain
    # version (the two einsums, cuBLAS) and the one PyTorch call that
    # computes the same function (cuDNN's convolution backward)
    def c1_case(shape):
        b, ci, h, w, co = shape
        x = torch.randn(b, ci, h, w, generator=g).to(dev)
        wt = (torch.randn(co, ci, 1, 1, generator=g) * ci ** -0.5).to(dev)
        dy = torch.randn(b, co, h, w, generator=g).to(dev)
        return dict(
            name="conv1x1_bwd", shape="%s x%d a step" % (
                list(shape), c1_shapes[shape]),
            ms=time_ms(lambda: k1.conv1x1_bwd(x, wt, dy), reps=10),
            plain_ms=time_ms(lambda: k1.conv1x1_bwd_reference(x, wt, dy),
                             reps=10),
            library_ms=time_ms(lambda: torch.ops.aten.convolution_backward(
                dy, x, wt, None, [1, 1], [0, 0], [1, 1], False, [0, 0], 1,
                [True, True, False]), reps=10),
            library="torch.ops.aten.convolution_backward (cuDNN, TF32 "
                    "off): dx and dw in one call",
            bytes=4 * (2 * x.numel() + dy.numel() + 2 * wt.numel()),
            flops=4 * b * h * w * ci * co, per_step=c1_shapes[shape],
            tf32x3=True)

    c1_rows = [c1_case(s_)
               for s_ in sorted(c1_shapes, key=lambda s_: (-s_[2], s_[1],
                                                           s_[4]))]
    rows.extend(c1_rows)
    for r in rows:
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        # the float32 FMA rate; the 3xTF32 kernels' floor is three TF32
        # tensor-core operations for each float32 one
        t_fma = r["flops"] / FP32_FLOPS_PER_S * 1e3
        t_ops = 3 * r["flops"] / TF32_FLOPS_PER_S * 1e3 \
            if r.get("tf32x3") else t_fma
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        # nan: not timed at this shape
        print("time %s %s: kernel_ms %.6f plain_ms %.6f library_ms %.6f "
              "bound_ms %.6f (%s; %d bytes, %d flops%s)%s" % (
                  r["name"], r["shape"], r["ms"], r["plain_ms"],
                  r["library_ms"], r["bound_ms"], r["bound_by"],
                  r["bytes"], r["flops"],
                  "; 3xTF32 tensor-core bound %.6f, float32 FMA bound %.6f"
                  % (max(t_bytes, t_ops), max(t_bytes, t_fma))
                  if r.get("tf32x3") else "",
                  "; library: " + r["library"] if "library" in r else ""))

    for name, krows in (("bn_grad", bn_rows), ("conv1x1_bwd", c1_rows)):
        print("%s over one ResNet-50 step: %d launches, kernel %.3f ms, "
              "bound %.3f ms%s" % (
                  name, sum(r["per_step"] for r in krows),
                  sum(r["per_step"] * r["ms"] for r in krows),
                  sum(r["per_step"] * r["bound_ms"] for r in krows),
                  "; library %.3f ms, plain version %.3f ms" % (
                      sum(r["per_step"] * r["library_ms"] for r in krows),
                      sum(r["per_step"] * r["plain_ms"] for r in krows))
                  if name == "conv1x1_bwd" else ""))

    # the decode step end to end: host wall time vs device busy time
    cache = engine.new_cache()
    cache.pos[:] = 160
    last = np.ones(SLOTS, np.int64)
    for _ in range(3):
        engine.decode_step(last, cache)
    torch.cuda.synchronize()
    n_steps = 20
    t0 = time.perf_counter()
    for _ in range(n_steps):
        engine.decode_step(last, cache)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1000.0 / n_steps
    device_profile(lambda: engine.decode_step(last, cache), n_steps,
                   step_ms, "decode step at pos 160")
    torch.cuda.synchronize()

    # ---- 9. result ----
    by_name = {}
    for r in rows:   # the main path's deepest decode and largest bucket
        if (r["name"], r["shape"]) in (
                ("flash_decode", "[16,8,512,64] cache_len=160"),
                ("flash_attention", "[1,8,32,64] causal=True")) \
                or r["name"] in ("lstm_fwd", "lstm_bwd", "gru_fwd",
                                 "gru_bwd") \
                or r["shape"].startswith(("[64, 112, 112, 64]",
                                          "[64, 64, 56, 56, 256]")):
            # bn_grad at the stem, conv1x1_bwd at the first conv3
            by_name[r["name"]] = r
    table = [{"name": n, "route": "cuda", "source": SOURCES[n],
              "replaces": REPLACES[n], "launches": launches[n],
              "max_abs_err": max_err[n], "ms": by_name[n]["ms"],
              "plain_ms": by_name[n]["plain_ms"],
              "bound_ms": by_name[n]["bound_ms"],
              "bound_by": by_name[n]["bound_by"],
              "library_ms": by_name[n]["library_ms"]}
             for n in ("flash_attention", "flash_decode", "lstm_fwd",
                       "lstm_bwd", "gru_fwd", "gru_bwd", "bn_grad",
                       "conv1x1_bwd")]
    print("card:", card_line())
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
