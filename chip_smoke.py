"""Smoke run of paddle_tpu_torch on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py [--seed N]

Drives the port's three main paths through the entry points a user
calls, on random weights and data made from ``--seed``:

* KV-cached decode serving of the transformer LM at the repo's full
  decode-serving width (vocab 8192, d_model 512, 8 layers, 8 heads,
  max_len 512, 16 slots, prompt buckets 8/16/32);
* training of the stacked-LSTM text classifier at the repo's full width
  (dict 30000, emb 512, hid 512, 3 layers, 2 classes, Adam lr 1e-3) on a
  batch of 64 ragged sequences of 16..80 ids;
* training of the attention seq2seq (NMT) model at the repo's full width
  (vocab 30000 source and target, emb 512, hid 512, Adam lr 1e-3) on a
  batch of 64 ragged source and target sequences of 8..30 ids.

Phases, in order; any failure raises and the script exits non-zero:

1. device: require CUDA, print the card's name and power limit, turn
   TF32 off for float32 matmuls and convolutions;
2. build every CUDA kernel from ``paddle_tpu_torch/csrc``, one nvcc per
   source, all started together;
3. hold each kernel against its plain PyTorch version on the card;
4. decode serving: create the weights with the port's Executor, warm a
   DecodeEngine, push 24 mixed requests through a DecodeLoop, check the
   kernels' launch counts and that greedy tokens equal the argmax of the
   port's one-shot logits;
5. stacked-LSTM training: startup, 2 warmup steps, 10 counted steps
   (falling finite loss, exact LSTM launch counts), a profile of one
   step, and the card against the CPU at a reduced size from the same
   weights (losses of 3 steps, first-step gradients);
6. seq2seq training, the same way (exact GRU launch counts);
7. time each kernel, its plain version and one PyTorch library call at
   the main paths' shapes with CUDA events, and profile the decode step;
8. print the kernel table as one JSON line, then the result line.

It imports nothing of JAX and nothing of the JAX package.
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# the card's published peaks (NVIDIA H100 SXM data sheet): HBM bytes/s,
# and float32 FLOP/s outside the tensor cores (the kernels' FMA path)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

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

SOURCES = {"flash_attention": "paddle_tpu_torch/csrc/flash_attention.cu",
           "flash_decode": "paddle_tpu_torch/csrc/flash_attention.cu",
           "lstm_fwd": "paddle_tpu_torch/csrc/lstm_cell.cu",
           "lstm_bwd": "paddle_tpu_torch/csrc/lstm_cell.cu",
           "gru_fwd": "paddle_tpu_torch/csrc/gru_cell.cu",
           "gru_bwd": "paddle_tpu_torch/csrc/gru_cell.cu"}
REPLACES = {"flash_attention": "paddle_tpu/kernels/flash_attention.py:70",
            "flash_decode": "paddle_tpu/kernels/flash_attention.py:374",
            "lstm_fwd": "paddle_tpu/kernels/lstm_cell.py:97",
            "lstm_bwd": "paddle_tpu/kernels/lstm_cell.py:198",
            "gru_fwd": "paddle_tpu/kernels/gru_cell.py:67",
            "gru_bwd": "paddle_tpu/kernels/gru_cell.py:143"}


def phase(name):
    print("== %s" % name, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


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


def device_profile(step, n_steps, step_ms, label):
    """Profile ``n_steps`` calls of ``step`` with torch.profiler and print
    the card's busy share of ``step_ms`` (host wall time per step, taken
    without the profiler) and the top-10 device kernels."""
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


def cross_check(fluid, exe, build, seed, batch, steps, label, gtol=1e-4):
    """The card against the CPU from the same weights: the losses of
    ``steps`` Adam steps within rtol 1e-4, every first-step parameter
    gradient within ``gtol`` x its largest magnitude."""
    from paddle_tpu_torch import interop, unique_name

    with unique_name.guard():
        xprog, xstart, _, (xloss,) = build()
    xstart.random_seed = seed
    cpu_scope, card_scope = fluid.Scope(), fluid.Scope()
    cpu = fluid.Executor(fluid.CPUPlace())
    cpu.run(xstart, scope=cpu_scope)
    interop.load_reference_state(
        {n: t.numpy() for n, t in cpu_scope.vars.items()}, card_scope,
        fluid.CUDAPlace(0), [xprog, xstart])
    grads = sorted(p.name + "@GRAD"
                   for p in xprog.global_block().all_parameters())
    worst = 0.0
    for step in range(steps):
        extra = grads if step == 0 else []
        c = cpu.run(xprog, feed=batch, fetch_list=[xloss] + extra,
                    scope=cpu_scope)
        k = exe.run(xprog, feed=batch, fetch_list=[xloss] + extra,
                    scope=card_scope)
        print("cross-check step %d: loss cpu %.7f card %.7f" % (
            step, float(c[0]), float(k[0])))
        np.testing.assert_allclose(k[0], c[0], rtol=1e-4)
        for name, cg, kg in zip(extra, c[1:], k[1:]):
            atol = gtol * float(np.abs(cg).max())
            np.testing.assert_allclose(kg, cg, rtol=0, atol=atol,
                                       err_msg=name)
            worst = max(worst, float(np.abs(kg - cg).max())
                        / max(float(np.abs(cg).max()), 1e-30))
    print("card == cpu at %s: losses of %d steps within rtol 1e-4; %d "
          "first-step gradients within %g x max|g| (worst %.3g x "
          "max|g|)" % (label, steps, len(grads), gtol, worst))
    torch.cuda.synchronize()


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

    # ---- 3. kernels against their plain versions ----
    phase("kernels vs plain versions (atol %g, rtol %g; LSTM and GRU "
          "atol %g, rtol %g)" % (ATOL, RTOL, LSTM_ATOL, LSTM_RTOL))
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

    # ---- 7. times ----
    phase("times (CUDA events, median of 25 runs after warmup)")
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
    for s, causal in ((32, True), (160, True)):
        q, k, v = (randn(1, N_HEADS, s, 64) for _ in range(3))
        pairs = s * (s + 1) // 2 if causal else s * s
        rows.append(dict(
            name="flash_attention",
            shape="[1,8,%d,64] causal=%s" % (s, causal),
            ms=time_ms(lambda: fa.flash_attention(q, k, v, causal=causal)),
            plain_ms=time_ms(lambda: fa.flash_attention_reference(
                q, k, v, causal)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal)),
            bytes=4 * (4 * N_HEADS * s * 64 + N_HEADS * s),
            flops=4 * N_HEADS * pairs * 64))
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
    for r in rows:
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["flops"] / FP32_FLOPS_PER_S * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        print("time %s %s: kernel_ms %.6f plain_ms %.6f library_ms %.6f "
              "bound_ms %.6f (%s; %d bytes, %d flops)%s" % (
                  r["name"], r["shape"], r["ms"], r["plain_ms"],
                  r["library_ms"], r["bound_ms"], r["bound_by"],
                  r["bytes"], r["flops"],
                  "; library: " + r["library"] if "library" in r else ""))

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

    # ---- 8. result ----
    by_name = {}
    for r in rows:   # the main path's deepest decode and largest bucket
        if (r["name"], r["shape"]) in (
                ("flash_decode", "[16,8,512,64] cache_len=160"),
                ("flash_attention", "[1,8,32,64] causal=True")) \
                or r["name"] in ("lstm_fwd", "lstm_bwd", "gru_fwd",
                                 "gru_bwd"):
            by_name[r["name"]] = r
    table = [{"name": n, "route": "cuda", "source": SOURCES[n],
              "replaces": REPLACES[n], "launches": launches[n],
              "max_abs_err": max_err[n], "ms": by_name[n]["ms"],
              "plain_ms": by_name[n]["plain_ms"],
              "bound_ms": by_name[n]["bound_ms"],
              "bound_by": by_name[n]["bound_by"],
              "library_ms": by_name[n]["library_ms"]}
             for n in ("flash_attention", "flash_decode", "lstm_fwd",
                       "lstm_bwd", "gru_fwd", "gru_bwd")]
    print("card:", card_line())
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
