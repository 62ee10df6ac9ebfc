"""Smoke run of paddle_tpu_torch on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py [--seed N]

Drives the port's main paths through the entry points a user
calls, on random weights and data made from ``--seed``:

* KV-cached decode serving of the transformer LM at the repo's full
  decode-serving width (vocab 8192, d_model 512, 8 layers, 8 heads,
  max_len 512, 16 slots, prompt buckets 8/16/32), from a float32 and
  from a bfloat16 KV cache (``DecodeEngine(cache_dtype="bfloat16")``);
* training of the stacked-LSTM text classifier at the repo's full width
  (dict 30000, emb 512, hid 512, 3 layers, 2 classes, Adam lr 1e-3) on a
  batch of 64 ragged sequences of 16..80 ids;
* training of the attention seq2seq (NMT) model at the repo's full width
  (vocab 30000 source and target, emb 512, hid 512, Adam lr 1e-3) on a
  batch of 64 ragged source and target sequences of 8..30 ids, then its
  beam-search decode from the trained weights
  (``build_seq2seq(mode="decode")``: beam 4, 32 steps, 64 sources of 30
  ids), whose encoder's two directions launch the GRU forward kernel;
* row-sparse embedding training: the word_embedding model (4 context
  words through one [30000, 512] table, ``is_sparse=True``) under SGD
  and lazy Adam, against dense updates, through CUDA graphs and under
  the step guard;
* training of ResNet-50 at full width (3x224x224 images, 1000 classes,
  depth 50, batch 64, float32, Momentum lr 0.1 mu 0.9), twice from the
  same weights: config A "nhwc+reductions" (``layout="NHWC"`` and
  ``passes.enable(prog, layout="NHWC", pallas_reductions=True)``, whose
  53 batch_norm_grad ops launch the batch-norm backward kernel) and
  config B "nchw+fused1x1" (NCHW, no passes,
  ``FLAGS_fused_conv1x1_bwd`` on, whose 1x1 stride-1 convolutions
  launch the fused dx+dw kernel in their backward). The two kernels
  cannot fire in one program: the first takes NHWC only, the second
  NCHW only;
* the same ResNet-50 as bench.py runs convnets: bf16 AMP
  (``amp.enable``) in config C "bench" (``passes.enable(prog,
  layout="NHWC", epilogue_fusion=True, pallas_reductions=True)``: 49
  fused ``conv2d_bn_act_grad`` and 4 ``batch_norm_grad`` launch the
  batch-norm backward in bfloat16) and config D
  "nchw+fused1x1+epilogue" (``epilogue_fusion=True`` and
  ``FLAGS_fused_conv1x1_bwd``: 26 of the 30 1x1 stride-1 convolutions
  launch the fused 1x1 backward in bfloat16 inside the fused op's
  grad); and VGG-16 (config C's passes, 13 batch-norm backwards a
  step), GoogLeNet (NCHW with the flag, 37 fused 1x1 backwards a step),
  AlexNet and SmallNet, all under AMP at bench.py's full widths;
* training of the transformer LM as bench.py runs it (vocab 32000, seq
  512, d_model 512, 8 layers, 8 heads, batch 16, Adam lr 1e-3, bf16
  AMP): 8 flash-attention forwards and 8 more inside
  ``fused_attention_grad`` a step, all in the bfloat16 kernel; and
  bench.py's memory row (the same model in float32, attention dropout
  0.1) with the remat pass off and ``remat="blocks"``; and the same
  transformer under the training-health guard with dynamic loss scaling
  (``amp.enable(prog, loss=..., dynamic_loss_scale=True)``), a
  non-finite gradient injected at two steps;
* the stacked LSTM and seq2seq as bench.py trains them: bf16 AMP at the
  full widths above, batch 64, every row at bench.py's full length (80
  and 30): 6 bf16 LSTM forwards and 3 backwards a step, 4 bf16 GRU
  forwards and 2 backwards a step.

Phases, in order; any failure raises and the script exits non-zero:

1. device: require CUDA, print the card's name and power limit, turn
   TF32 off for float32 matmuls and convolutions;
2. build every CUDA kernel from ``paddle_tpu_torch/csrc``, one nvcc per
   source, all started together, and read from the built libraries that
   the flash-attention forward, the fused 1x1 backward and the LSTM and
   GRU forwards and backwards run on the tensor cores (HMMA) fed
   by asynchronous copies (LDGSTS), the bfloat16 flash-attention forward,
   fused 1x1 backward and the LSTM's and GRU's cluster kernels on wgmma
   (HGMMA) fed by TMA (UTMALDG; the 1x1 backward by the loader its plan
   gives each instantiation; the cluster forwards' all-gathers by bulk
   copies, UBLKCP), and that the decode kernel moves 16-byte words, all
   with no spills;
3. hold each kernel against its plain PyTorch version on the card (the
   decode kernel at head_dim 32, 64 and 128 and lengths around its
   chunks' and tiles' edges, on a cache on 4-byte boundaries, with NaN
   past the lengths, and twice to the same bits, and over bfloat16 caches
   at head_dim 64, 32, 128 and 13, also against a float64 witness that
   rounds p where it does; the fused 1x1 backward
   at every distinct shape of the ResNet-50 path, as derived from the
   program, also against float64, and its float32 dw error against
   float64 by the length of its dw chunks; the LSTM kernels also against
   float64 at T = 20, 40 and 80 and the GRU kernels at T = 10, 20 and
   30, beside their float32 plain versions, and run twice to the same
   bits; the GRU kernels also at the widest H the backward's launch
   plan admits on the card; the batch-norm backward in bfloat16 at
   every distinct shape of config C, the fused 1x1 backward's config-D
   shapes shown to be config B's, and at odd shapes for each of its
   loaders; the bfloat16 flash-attention forward at the serving and
   training shapes, packed cases, sq != sk, not causal, head_dim 32, 40,
   128 and 13, against the plain version walking the keys as the kernel
   does and against float64; both flash-attention forwards twice to the
   same bits; the fused 1x1 backward's dw error against float64 by its
   chunk length in float32 and bfloat16; the bfloat16 LSTM and GRU
   kernels at the AMP paths' shapes, on the cluster kernels where
   cluster_plan takes a shape and at one it refuses, the card's plans
   equal to cluster_plan's, against their plain versions and a float64
   witness that rounds where they round, and twice to the same bits);
4. decode serving: create the weights with the port's Executor, warm a
   DecodeEngine (which captures the decode step and each prefill bucket
   as a CUDA graph), push 24 mixed requests through a DecodeLoop, check
   the kernels' launch counts (credited once per replay) and that greedy
   tokens equal the argmax of the port's one-shot logits;
4b. the same from a bfloat16 KV cache (half the bytes): launch counts
   (8 bf16 B2 a decode step, none float32), tokens/s, gaps and time to
   first token, the greedy tokens of 3 requests against the float32
   cache's wherever its top-two margin exceeds twice the largest logit
   difference between the engines (teacher-forced), the same tokens with
   graphs and eagerly, ``compile_count()`` frozen while the loop serves;
5. stacked-LSTM training: startup, 2 warmup steps, 10 counted steps
   (falling finite loss, exact LSTM launch counts), a profile of one
   step, and the card against the CPU at a reduced size from the same
   weights (losses of 3 steps, first-step gradients);
6. seq2seq training, the same way (exact GRU launch counts);
6b. the seq2seq beam-search decode from the trained scope: exactly 2
   float32 GRU forwards a decode call (from the program), well-formed
   beams (best first, 1 <= length <= 32, eos past each length), every
   beam's score x length equal to its teacher-forced log-probability
   (the training graph run forward only) within 1e-4 relative, a
   beam-1 decode emitting the teacher-forced argmax away from near-ties,
   the card against the CPU at a reduced width (ids and lengths equal,
   scores at rtol 1e-4, rows past a near-tie of the K-th and (K+1)-th
   candidates excepted and counted); wall ms, tokens/s, device busy
   time, launches and peak memory of a decode call;
6c. row-sparse embedding training (the word_embedding graph at dict
   30000, embedding 512, batch 64): sparse against dense SGD over 3
   steps, lazy Adam leaving every row no id looks up bitwise unchanged
   while the loss falls, the card against the CPU at dict 1000, sparse
   and dense SGD and Adam through ``run_chunk``'s graphs bitwise against
   eager steps (host and device ms/step), and the step guard skipping a
   step whose row-sparse gradient is NaN;
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
8. bench.py's convnet configuration: C against D on the card from the
   same weights under AMP (first-step loss and every gradient, at the
   bf16 bounds), then each config's 2 warmup and 10 counted steps as in
   7 (launch counts derived from the transformed program, and those
   made inside ``conv2d_bn_act``'s grad counted apart), the card against
   the CPU at the ``resnet_cifar`` size, and C against D there; then
   VGG-16, GoogLeNet, AlexNet and SmallNet at full width, batch 64,
   2 warmup and 5 counted steps each (exact launch counts, a finite
   loss that comes under the first counted one);
9. the transformer LM under bf16 AMP: 2 warmup and 10 counted steps
   (exact bfloat16 B1 launches derived from the program, no float32
   B1, a finite falling loss), a profile of one step, B1's backward
   share of the step, the card against the CPU at a reduced size in
   float32 and under AMP; then the memory row, remat off against
   "blocks" from the same weights: equal losses and first-step
   gradients (bitwise, or else within B1's tolerance, printed which),
   the peak allocated memory of each (the "blocks" arm must be lower),
   the activation ledger and each arm's B1 launches;
9b. the stacked LSTM and seq2seq under bf16 AMP: 2 warmup and 10
   counted steps each (exact bfloat16 B3/B4 and B5/B6 launches derived
   from the program, no float32 one, a finite falling loss), a profile
   of one step, the card against the CPU at the reduced sizes under AMP;
9c. graphs: the decode engine (whose every entry is a captured CUDA
   graph since phase 4) against one that runs its entries eagerly:
   identical greedy tokens of 3 requests, ``compile_count()`` unchanged
   after the loop served them, host ms of a decode step with and without
   graphs; then ``Executor.run_chunk`` as replayed CUDA graphs on the
   transformer as bench.py runs it (bf16 AMP, K=8, two chunks),
   ResNet-50 configs C and D under AMP, the AMP stacked LSTM and
   seq2seq, and the memory row (float32, attention dropout 0.1: a random
   draw each step): from the same weights, the graph run's losses and
   every state tensor bitwise equal to eager ``run()`` steps' (where two
   eager runs already differ, those tensors are named and their updates
   held at the card-against-card bounds), the launches through the
   graphs exactly the program's, host ms/step and device busy ms/step
   with and without graphs over one warm chunk;
9d. the transformer under bf16 AMP and the step guard with dynamic loss
   scaling, three chunks of K=8 through ``run_chunk``'s graphs (clean;
   ``guard.nonfinite`` armed at steps 11 and 12; clean): the health
   rows skip exactly those steps and the scale follows the rule, every
   state tensor but the guard's is bitwise unchanged across a skipped
   step, the 24 replays equal 24 eager steps bitwise (tensors two eager
   runs already disagree on held at the AMP bounds), the guard without
   scaling equals no guard, 16 bf16 B1 a step skipped or not, and the
   guard's overhead in host and device ms/step with graphs;
10. time each kernel, its plain version and one PyTorch library call at
   the main paths' shapes with CUDA events (the decode kernel at lengths
   512 and 160, the L2 flushed by a write and by a read, beside SDPA
   over the valid prefix and the masked call over the whole cache, and
   over bfloat16 caches beside SDPA in bfloat16; the
   flash-attention forward at six shapes, the fused 1x1 backward at
   every distinct shape of the ResNet-50 path, the LSTM kernels at T = 8
   and 80 and the GRU kernels at T = 3 and 30 for their cost a step,
   with their launch plans; the batch-norm and fused 1x1 backwards
   also in bfloat16 at every distinct shape of configs C and D, beside
   their plain versions and the library's bfloat16 calls; the bfloat16
   flash-attention forward at the transformer's shape beside SDPA in
   bfloat16; the bfloat16 LSTM and GRU kernels at the AMP paths' shapes
   beside cuDNN's LSTM and GRU in bfloat16), and profile the decode
   step;
11. print the seconds it took, the card, the kernel table as one JSON
   line, then the result line.

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
# dense TF32 and BF16 tensor-core FLOP/s (the same data sheet)
TF32_FLOPS_PER_S = 495e12
BF16_FLOPS_PER_S = 989e12

# full width: the repo's decode-serving configuration
VOCAB, D_MODEL, N_LAYERS, N_HEADS = 8192, 512, 8, 8
MAX_LEN, SLOTS, BUCKETS = 512, 16, (8, 16, 32)
N_REQUESTS, LONG_NEW, SHORT_NEW = 24, 128, 8

# full width: the repo's stacked-LSTM configuration (bench.py:163-167)
# at the reference's published batch of 64
DICT, EMB, HID, STACKED, CLASSES, LR = 30000, 512, 512, 3, 2, 1e-3
LSTM_B, LSTM_T, MIN_LEN = 64, 80, 16
# the short sequence B3 and B4 are also timed at, for their cost a step
LSTM_SHORT_T = 8
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
# sequence lengths at which B5 and B6 are held against float64, and the
# short one they are also timed at, for their cost a step
GRU_WITNESS_T = (10, 20, 30)
GRU_SHORT_T = 3

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

# bench.py's convnet configuration: bf16 AMP (bench.py:303-304) and its
# pass A/B's pipeline (bench.py:2237-2250)
BENCH_PASSES = dict(layout="NHWC", epilogue_fusion=True,
                    pallas_reductions=True)
# Two bf16 runs' gradients (C against D, the card against the CPU):
# the bf16 convolutions of two implementations accumulate differently,
# and at the resnet_cifar size the gradients lie 0.13-0.14 from their
# float32 values in relative L2 norm in the JAX package and in this one
# alike (tests/test_torch_amp.py), single bias gradients, which nearly
# cancel, up to 0.3: first-step losses rtol 1e-2, each gradient within
# 0.5 of its own L2 norm, all together within 0.2 (PERF.md section 2)
AMP_LTOL, AMP_PL2TOL, AMP_L2TOL = 1e-2, 0.5, 0.2
# A gradient whose L2 norm is under this share of the largest gradient's
# cancels at the initial weights (seq2seq's att_dec_w: 7.8e-7 in float32,
# 2.0e-6 under bf16, on the CPU at S2S_XCHECK's size; the next smallest
# 7.6e-4): the AMP cross-checks hold it in the whole's norm only
AMP_CANCELS = 1e-4
# the other convnets at full width under AMP, batch RESNET_B: bench.py's
# builders (bench.py:55-124) with their optimizers and lrs; VGG-16 in
# bench.py's pass configuration, GoogLeNet NCHW with the fused 1x1
# backward; want = (B7, B8) launches a step
OTHER_MODELS = (
    ("vgg16", dict(module="vgg", build="build_vgg16_train",
                   image=(3, 224, 224), classes=1000, passes=BENCH_PASSES,
                   flag=False, want=(13, 0))),
    ("googlenet", dict(module="googlenet", build="build_googlenet_train",
                       image=(3, 224, 224), classes=1000, flag=True,
                       want=(0, 37))),
    ("alexnet", dict(module="alexnet", build="build_alexnet_train",
                     image=(3, 227, 227), classes=1000, flag=False,
                     want=(0, 0))),
    ("smallnet", dict(module="smallnet", build="build_smallnet_train",
                      image=(3, 32, 32), classes=10, flag=False,
                      want=(0, 0))))
OTHER_WARMUP, OTHER_STEPS = 2, 5
# further steps allowed for their loss to come under the first counted
# one (dropout draws a new mask each step)
OTHER_SETTLE_STEPS = 30
# the batch-norm backward's three kernels (partial sums, finalize, dx)
B7_KERNELS = ("bn_partial", "bn_finalize", "bn_dx")

# bench.py's transformer run (bench.py:221-253, DEFAULT_BATCH 16, bf16
# AMP unless --fp32): vocab 32000, seq 512, d_model 512, 8 layers, 8
# heads, Adam lr 1e-3
LM = dict(vocab_size=32000, seq_len=512, d_model=512, num_layers=8,
          num_heads=8, lr=1e-3)
LM_B = 16
# the card against the CPU at a reduced size
LM_XCHECK = dict(vocab_size=1000, seq_len=64, d_model=128, num_layers=2,
                 num_heads=2, lr=1e-3)
LM_XCHECK_B, LM_XCHECK_STEPS = 4, 3
# bench.py's memory row (_bench_memory, bench.py:2528-2635): the same
# model in float32 with attention dropout 0.1, remat off against
# remat="blocks"
MEM_WARMUP, MEM_STEPS = 2, 3
# B1 in bfloat16, (b, h, sq, sk, d, causal, segments): the training
# path's shape, the serving shapes, a packed (segment) case, sq not a
# multiple of the wgmma kernel's 128 rows, sq != sk both ways, not
# causal, head_dim 32 and 128, and head_dim 40 (a multiple of 8 that
# needs zero columns) and 13 (not one: the mma.sync kernel)
B1_BF16_CASES = ((1, 8, 32, 32, 64, True, False),
                 (1, 8, 160, 160, 64, True, False),
                 (16, 8, 512, 512, 64, True, False),
                 (2, 8, 160, 160, 64, True, True),
                 (2, 4, 200, 200, 64, True, False),
                 (2, 3, 200, 120, 64, False, False),
                 (2, 3, 120, 200, 64, True, False),
                 (2, 4, 256, 256, 64, False, True),
                 (2, 2, 130, 130, 32, True, False),
                 (1, 2, 200, 200, 128, True, True),
                 (1, 2, 64, 100, 40, True, False),
                 (1, 2, 17, 29, 13, True, False))

# bench.py's recurrent runs under bf16 AMP (bench.py:159-218, 303-304)
# feed every row at the full length, LSTM_T and S2S_T (bench.py:175-176,
# 203-204); the card against the CPU at XCHECK / S2S_XCHECK's sizes,
# equal lengths.
# The bfloat16 B3-B6 against their plain versions and the float64
# witness (ragged masks with an empty and a full row), beside the AMP
# paths' shapes
RNN_BF16_SHAPES = ((8, 5, 32), (37, 17, 128), (200, 4, 64))
# an LSTM shape kernels.lstm_cell.cluster_plan refuses (W does not fit a
# cluster of 16 blocks): the bf16 B3 and B4 of lstm_cell.cu stay held
LSTM_BF16_REFUSED = ((16, 6, 1024),)
# and a GRU shape kernels.gru_cell.cluster_plan refuses: the bf16 B5 and
# B6 of gru_cell.cu stay held
GRU_BF16_REFUSED = ((16, 6, 1024),)

# Executor.run_chunk as replayed CUDA graphs: steps a chunk (bench.py runs
# the transformer row with K=8, bench.py:311-318) and chunks a path
GRAPH_K = dict(transformer=8, resnet=4, rnn=4, dropout=4)
GRAPH_CHUNKS = 2
# the guard phase's growth interval: the scale grows after 4 clean steps
GUARD_GROWTH = 4

# the seq2seq beam-search decode: the JAX package's default beam, 32
# steps, from the seq2seq training phase's scope, over S2S_B source
# sentences of S2S_T ids each (equal lengths, as bench.py feeds them);
# the margin under which a teacher-forced argmax or a K-th/(K+1)-th
# candidate gap counts as a near-tie
BEAM, BEAM_T, BOS, EOS = 4, 32, 0, 1
BEAM_TIE = 1e-4
# the card-against-CPU decode multiplies the output layer's weights by
# this: at initialisation the logits are so flat that 14 of 16 rows pass
# a step whose K-th and (K+1)-th candidates lie within BEAM_TIE (1 of 16
# at 30; measured on the CPU)
BEAM_XCHECK_SHARPEN = 30.0
# row-sparse embedding training: the word_embedding golden's graph
# (tools/goldens.py:70-86: 4 context words through one table,
# fc(act="sigmoid"), fc(act="softmax"), cross-entropy) at bench.py's
# text widths (dict 30000, embedding 512, bench.py:163-167), hidden 512,
# batch 64; the card against the CPU at dict 1000, embedding 64
W2V = dict(dict_size=30000, emb=512, hidden=512)
W2V_XCHECK = dict(dict_size=1000, emb=64, hidden=64)
W2V_B, W2V_CONTEXT = 64, 4

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
# sequence lengths at which B3 and B4 are held against float64
LSTM_WITNESS_T = (20, 40, 80)
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
# ResNet-50 path (derived from the program: transformed_launches) and at these,
# where no dimension fills a tile: HW = 35 and 49 (bfloat16: bulk copies),
# 100 (8-byte cp.async) and 81 (through registers), Ci and Co not
# multiples of 64
C1_EXTRA_SHAPES = ((3, 24, 5, 7, 40), (2, 40, 7, 7, 72),
                   (2, 72, 10, 10, 48), (2, 24, 9, 9, 40))
# dw chunk lengths (positions) of the precision sweep at 64 -> 256 @ 56x56
C1_SWEEP_SHAPE = (64, 64, 56, 56, 256)
C1_SWEEP_CHUNKS = (64, 256, 1024, 4096)

SOURCES = {"flash_attention": "paddle_tpu_torch/csrc/flash_attention.cu",
           "flash_attention_bf16":
               "paddle_tpu_torch/csrc/flash_attention.cu",
           "flash_decode": "paddle_tpu_torch/csrc/flash_attention.cu",
           "flash_decode_bf16": "paddle_tpu_torch/csrc/flash_attention.cu",
           "lstm_fwd": "paddle_tpu_torch/csrc/lstm_cell.cu",
           "lstm_bwd": "paddle_tpu_torch/csrc/lstm_cell.cu",
           "gru_fwd": "paddle_tpu_torch/csrc/gru_cell.cu",
           "gru_bwd": "paddle_tpu_torch/csrc/gru_cell.cu",
           "bn_grad": "paddle_tpu_torch/csrc/bn_grad.cu",
           "conv1x1_bwd": "paddle_tpu_torch/csrc/conv1x1_bwd.cu",
           "bn_grad_bf16": "paddle_tpu_torch/csrc/bn_grad.cu",
           "conv1x1_bwd_bf16": "paddle_tpu_torch/csrc/conv1x1_bwd.cu",
           "lstm_fwd_bf16": "paddle_tpu_torch/csrc/lstm_cluster.cu",
           "lstm_bwd_bf16": "paddle_tpu_torch/csrc/lstm_cluster.cu",
           "gru_fwd_bf16": "paddle_tpu_torch/csrc/gru_cluster.cu",
           "gru_bwd_bf16": "paddle_tpu_torch/csrc/gru_cluster.cu"}
REPLACES = {"flash_attention": "paddle_tpu/kernels/flash_attention.py:70",
            "flash_attention_bf16":
                "paddle_tpu/kernels/flash_attention.py:70",
            "flash_decode": "paddle_tpu/kernels/flash_attention.py:374",
            "flash_decode_bf16": "paddle_tpu/kernels/flash_attention.py:374",
            "lstm_fwd": "paddle_tpu/kernels/lstm_cell.py:97",
            "lstm_bwd": "paddle_tpu/kernels/lstm_cell.py:198",
            "gru_fwd": "paddle_tpu/kernels/gru_cell.py:67",
            "gru_bwd": "paddle_tpu/kernels/gru_cell.py:143",
            "bn_grad": "paddle_tpu/kernels/bn_grad.py:72",
            "conv1x1_bwd": "paddle_tpu/kernels/conv1x1_bwd.py:85",
            "bn_grad_bf16": "paddle_tpu/kernels/bn_grad.py:72",
            "conv1x1_bwd_bf16": "paddle_tpu/kernels/conv1x1_bwd.py:85",
            "lstm_fwd_bf16": "paddle_tpu/kernels/lstm_cell.py:97",
            "lstm_bwd_bf16": "paddle_tpu/kernels/lstm_cell.py:198",
            "gru_fwd_bf16": "paddle_tpu/kernels/gru_cell.py:67",
            "gru_bwd_bf16": "paddle_tpu/kernels/gru_cell.py:143"}


def phase(name):
    print("== %s" % name, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


# B1, B3, B4, B5, B6 and B8 run on the tensor cores fed by asynchronous
# copies: (library, kernel function). The mma.sync kernels show HMMA in
# the SASS and cp.async as LDGSTS; the bfloat16 B1, B3-B6 and B8 on
# wgmma show HGMMA and TMA loads (UTMALDG; bulk copies,
# UBLKCP). Which loader an instantiation of the bfloat16 B8 runs is its
# last template argument (kernels.conv1x1_bwd.LOADERS): TMA must show
# UTMALDG, the bulk copies UBLKCP and UTMALDG (w), the 8-byte cp.async
# copies LDGSTS; the one that stages through registers needs none.
TENSOR_CORE_KERNELS = (("flash_attention", "flash_fwd_kernel"),
                       ("flash_attention", "flash_fwd_bf16_kernel"),
                       ("flash_attention", "flash_fwd_wgmma_kernel"),
                       ("conv1x1_bwd", "conv1x1_bwd_kernel"),
                       ("conv1x1_bwd", "conv1x1_bwd_bf16_kernel"),
                       ("lstm_cell", "lstm_fwd_kernel"),
                       ("lstm_cell", "lstm_bwd_kernel"),
                       ("lstm_cluster", "lstm_fwd_cluster_kernel"),
                       ("lstm_cluster", "lstm_bwd_cluster_kernel"),
                       ("gru_cell", "gru_fwd_kernel"),
                       ("gru_cell", "gru_bwd_kernel"),
                       ("gru_cluster", "gru_fwd_cluster_kernel"),
                       ("gru_cluster", "gru_bwd_cluster_kernel"))
WGMMA_KERNELS = ("flash_fwd_wgmma_kernel", "conv1x1_bwd_bf16_kernel",
                 "lstm_fwd_cluster_kernel", "lstm_bwd_cluster_kernel",
                 "gru_fwd_cluster_kernel", "gru_bwd_cluster_kernel")
# the bf16 B8's kernel in a profile (the AMP paths' 1x1 backward)
B8_BF16_KERNELS = ("conv1x1_bwd_bf16_kernel",)
# B2 is bound by bytes and has no product for the tensor cores: its SASS
# must move 16-byte words (LDGSTS of 16 bytes, or LDG.E.128)
WIDE_LOAD_KERNELS = (("flash_attention", "flash_decode_kernel"),)
ASYNC_COPIES = ("LDGSTS", "UTMALDG", "UBLKCP")
# an LDGSTS or LDG with the .128 (16-byte) modifier
WIDE_LOAD = re.compile(r"\b(LDGSTS|LDG)(\.[A-Z0-9_]+)*\.128\b")
# the bfloat16 B8's loader: the last template argument
C1_LOADER = re.compile(r"conv1x1_bwd_bf16_kernelILi\d+ELi\d+ELi(\d)E")


def copies_wanted(fn):
    """The copy instructions an instantiation must show: a tuple of
    opcodes it needs all of, or of which any one will do (a list)."""
    if "flash_fwd_wgmma_kernel" in fn:
        return ("UTMALDG",)
    # the bf16 LSTM's and GRU's cluster kernels: their inputs by TMA, W
    # staged by cp.async; B3's and B5's all-gathers by bulk copies between
    # the blocks
    if "lstm_fwd_cluster_kernel" in fn or "gru_fwd_cluster_kernel" in fn:
        return ("UTMALDG", "LDGSTS", "UBLKCP")
    if "lstm_bwd_cluster_kernel" in fn or "gru_bwd_cluster_kernel" in fn:
        return ("UTMALDG", "LDGSTS")
    m = C1_LOADER.search(fn)
    if m:
        return {0: ("UTMALDG",), 1: ("LDGSTS",), 2: (),
                3: ("UBLKCP", "UTMALDG")}[int(m.group(1))]
    return list(ASYNC_COPIES)


def sass_check(build):
    """For every instantiation of the tensor-core kernels: registers,
    stack and local memory from the built library, and its SASS's
    tensor-core instructions (HMMA, or HGMMA for WGMMA_KERNELS, which
    must have them), its copies (copies_wanted) and local-memory loads and
    stores (spills). Fails where a kernel lacks its tensor-core
    instructions or its copies, or spills. The kernels of
    WIDE_LOAD_KERNELS must have 16-byte loads instead."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for lib, kernel in TENSOR_CORE_KERNELS + WIDE_LOAD_KERNELS:
        wide = (lib, kernel) in WIDE_LOAD_KERNELS
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
                counts[fn] = dict(HMMA=0, HGMMA=0, local=0, wide=0,
                                  **{op: 0 for op in ASYNC_COPIES})
            elif fn is not None:
                c = counts[fn]
                c["HMMA"] += "HMMA" in line
                c["HGMMA"] += "HGMMA" in line
                for op in ASYNC_COPIES:
                    c[op] += op in line
                c["local"] += bool(re.search(r"\b(LDL|STL)\b", line))
                c["wide"] += bool(WIDE_LOAD.search(line))
        # "flash_fwd_bf16_kernel" must not match "flash_fwd_wgmma_kernel";
        # a template's instantiations continue with I, a plain function
        # with its parameters (E...)
        mine = sorted(f for f in counts if re.search(kernel + r"[IE]", f))
        if not mine:
            raise AssertionError("%s: no %s in its SASS" % (path, kernel))
        for f in mine:
            c = counts[f]
            use = usage.get(f, "REG:? STACK:? SHARED:? LOCAL:?")
            print("sass %s: %s; HMMA %d, HGMMA %d, %s, 16-byte loads %d, "
                  "local loads/stores %d" % (
                      f, use, c["HMMA"], c["HGMMA"],
                      ", ".join("%s %d" % (op, c[op]) for op in ASYNC_COPIES),
                      c["wide"], c["local"]))
            spills = c["local"] or "STACK:0 " not in use \
                or not use.endswith("LOCAL:0")
            if wide:
                if c["wide"] == 0 or spills:
                    raise AssertionError("%s: no 16-byte loads, or spills"
                                         % f)
                continue
            tensor = c["HGMMA"] if kernel in WGMMA_KERNELS else c["HMMA"]
            want = copies_wanted(f)
            copies_ok = any(c[op] for op in want) if isinstance(want, list) \
                else all(c[op] for op in want)
            if tensor == 0 or not copies_ok or spills:
                raise AssertionError(
                    "%s: not a spill-free tensor-core kernel (%s) with its "
                    "copies (%s)" % (f, "HGMMA" if kernel in WGMMA_KERNELS
                                     else "HMMA", want))


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
    ``share_of`` (a name or a tuple of names), the device time of the
    kernels whose name holds one."""
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
        names = (share_of,) if isinstance(share_of, str) else share_of
        mine = [v for k, v in by_kernel.items()
                if any(n_ in k for n_ in names)]
        us = sum(u for u, _ in mine)
        n = sum(c for _, c in mine)
        print("%s: %s %.3f ms/step in %.1f launches/step, %.1f%% of the "
              "device's busy time" % (
                  label, "+".join(names), us / 1000.0 / n_steps,
                  n / n_steps, 100.0 * us / 1000.0 / n_steps / busy_ms))


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


def lstm_witness(lc, g, dev):
    """B3 and B4 at the path's width against float64, beside the float32
    plain versions, at T = LSTM_WITNESS_T: hs, cs of the forward, dxg,
    dh0 of the backward (each on its own forward's stash), as the largest
    error against float64 (hs, cs) or the largest error over the largest
    magnitude (dxg, dh0), so that growth with T shows. Hard only at the
    kernels' tolerances. Then two runs of each kernel at the path's
    shape must agree to the bit."""
    for T in LSTM_WITNESS_T:
        xg, w, h0, c0, mask, p, dhs, dcs = lstm_inputs(LSTM_B, T, HID, True,
                                                       g, dev)
        f64 = [t.double() for t in (xg, w, h0, c0, mask, p, dhs, dcs)]
        ths, tcs, tst = lc.lstm_forward_reference(*f64[:6])
        tgot = lc.lstm_backward_reference(tst, tcs, f64[1], f64[5], f64[3],
                                          f64[4], f64[6], f64[7])
        line = []
        for label, fwd, bwd in (
                ("kernel", lc.lstm_forward, lc.lstm_backward),
                ("plain", lc.lstm_forward_reference,
                 lc.lstm_backward_reference)):
            hs, cs, st = fwd(xg, w, h0, c0, mask, p)
            dxg, dh0, _, _ = bwd(st, cs, w, p, c0, mask, dhs, dcs)
            errs = [float((hs.double() - ths).abs().max()),
                    float((cs.double() - tcs).abs().max())]
            for got, want in ((dxg, tgot[0]), (dh0, tgot[1])):
                errs.append(float((got.double() - want).abs().max()
                                  / want.abs().max()))
            line.append("%s hs %.3g cs %.3g dxg %.3g dh0 %.3g" % (
                (label,) + tuple(errs)))
            if label == "kernel":
                for name, a, b in (("hs", hs, ths), ("cs", cs, tcs)):
                    assert_close("lstm float64 T=%d %s" % (T, name),
                                 a.double(), b, LSTM_ATOL, LSTM_RTOL)
                for name, a, b in (("dxg", dxg, tgot[0]),
                                   ("dh0", dh0, tgot[1])):
                    assert_close("lstm float64 T=%d %s" % (T, name),
                                 a.double(), b,
                                 LSTM_ATOL * max(1.0, float(b.abs().max())),
                                 LSTM_RTOL)
        print("lstm against float64 at [%d,%d,%d]: %s" % (
            LSTM_B, T, HID, "; ".join(line)))
    xg, w, h0, c0, mask, p, dhs, dcs = lstm_inputs(LSTM_B, LSTM_T, HID, True,
                                                   g, dev)
    runs = []
    for _ in range(2):
        hs, cs, st = lc.lstm_forward(xg, w, h0, c0, mask, p)
        runs.append((hs, cs, st) + lc.lstm_backward(st, cs, w, p, c0, mask,
                                                    dhs, dcs))
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError("lstm: two runs of the kernels differ")
    print("lstm: two runs of B3 and B4 at [%d,%d,%d] agree to the bit"
          % (LSTM_B, LSTM_T, HID))


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


def check_decode(fa, g, dev):
    """B2 against its plain version at the decode path's [16, 8, 512, d]
    for d = 32, 64, 128: lengths 0, 1, around the first non-empty chunks
    (n - 1, n, n + 1 for the plan's n blocks a row), around one tile a
    warp in every chunk (n 32 +- 1), 160, 300, 511, 512 and past the
    cache (clamped); once more on a cache that starts 4 bytes into its
    storage (the 4-byte copies), once with NaN in every position past
    each row's length (never read: the output must not change), and
    twice to the same bits; an empty row is 0. Returns the max abs err."""
    b, h, s = SLOTS, N_HEADS, MAX_LEN
    worst = 0.0
    for d in (32, 64, 128):
        pl = fa.decode_plan(b, h, s, d, torch.cuda.get_device_properties(
            dev).multi_processor_count)
        n = pl["blocks_per_row"]
        lens = torch.tensor([0, 1, n - 1, n, n + 1, 32 * n - 1, 32 * n,
                             32 * n + 1, 159, 160, 161, 300, 511, 512, 600,
                             2], dtype=torch.int32).to(dev)
        q = torch.randn(b, h, 1, d, generator=g).to(dev)
        kc, vc = (torch.randn(b, h, s, d, generator=g).to(dev)
                  for _ in range(2))
        what = "flash_decode %s lens %s" % ((b, h, s, d), lens.tolist())
        out = fa.flash_decode(q, kc, vc, lens)
        worst = max(worst, assert_close(
            what, out, fa.flash_decode_reference(q, kc, vc, lens)))
        if not torch.equal(out, fa.flash_decode(q, kc, vc, lens)):
            raise AssertionError(what + ": two runs differ")
        if float(out[0].abs().max()) != 0.0:
            raise AssertionError("flash_decode: an empty cache row is not 0")
        flat = torch.randn(1 + b * h * s * d, generator=g).to(dev)
        kv = flat[1:].view(b, h, s, d)
        worst = max(worst, assert_close(
            what + " 4-byte aligned cache", fa.flash_decode(q, kv, kv, lens),
            fa.flash_decode_reference(q, kv, kv, lens)))
        for i, n_ in enumerate(lens.tolist()):
            kc[i, :, n_:] = float("nan")
            vc[i, :, n_:] = float("nan")
        if not torch.equal(fa.flash_decode(q, kc, vc, lens), out):
            raise AssertionError(what + ": NaN past the lengths changed "
                                 "the output")
        print("flash_decode d=%d: %s; %d blocks a row in clusters, %d "
              "threads, %d stages a warp, %d shared bytes a block; max abs "
              "err %.3g; two runs bit-identical; NaN past the lengths never "
              "read" % (d, lens.tolist(), n, pl["threads"], pl["stages"],
                        pl["smem_bytes"], worst))
    torch.cuda.synchronize()
    return worst


def check_decode_bf16(fa, g, dev):
    """B2 over bfloat16 caches (``DecodeEngine(cache_dtype="bfloat16")``)
    at the decode path's [16, 8, 512, d], d = 64 (the path's), 32, 128
    and 13 (2-byte loads): ragged lengths with 512 and 160 among them,
    0, around the chunks' and tiles' edges and past the cache. Held
    against its plain version (the same walk, p rounded to bf16 where
    the kernel rounds it) and a float64 witness with the same roundings,
    at one bfloat16 rounding (BF16_RTOL, BF16_AMAX: p's rounding can flip
    by one bf16 ulp where the two compute exp(s - m) in another order);
    once more on a cache 2 bytes into its storage (no 16-byte rows), once
    with NaN past every row's length (never read), twice to the same
    bits; an empty row is 0, the output float32. Returns the max abs err
    against the plain version."""
    b, h, s = SLOTS, N_HEADS, MAX_LEN
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    worst = 0.0
    for d in (64, 32, 128, 13):
        n = fa.decode_plan(b, h, s, d, sms, 2)["blocks_per_row"]
        lens = torch.tensor([512, 160, 0, 1, n - 1, n + 1, 32 * n - 1,
                             32 * n + 1, 159, 161, 300, 511, 600, 2, 77,
                             512], dtype=torch.int32).to(dev)
        q = torch.randn(b, h, 1, d, generator=g).to(dev)
        kc, vc = (torch.randn(b, h, s, d, generator=g).to(torch.bfloat16)
                  .to(dev) for _ in range(2))
        what = "flash_decode bf16 %s lens %s" % ((b, h, s, d), lens.tolist())
        out = fa.flash_decode(q, kc, vc, lens)
        if out.dtype != torch.float32:
            raise AssertionError(what + ": output %s" % out.dtype)
        worst = max(worst, rel_close(
            what, out, fa.flash_decode_reference(q, kc, vc, lens),
            BF16_RTOL, BF16_AMAX))
        rel_close(what + " against float64", out, fa.flash_decode_reference(
            q, kc, vc, lens, acc=torch.float64), BF16_RTOL, BF16_AMAX)
        if not torch.equal(out, fa.flash_decode(q, kc, vc, lens)):
            raise AssertionError(what + ": two runs differ")
        if float(out[2].abs().max()) != 0.0:
            raise AssertionError(what + ": an empty cache row is not 0")
        flat = torch.randn(1 + b * h * s * d, generator=g).to(
            torch.bfloat16).to(dev)
        kv = flat[1:].view(b, h, s, d)
        worst = max(worst, rel_close(
            what + " 2-byte aligned cache", fa.flash_decode(q, kv, kv, lens),
            fa.flash_decode_reference(q, kv, kv, lens), BF16_RTOL,
            BF16_AMAX))
        for i, n_ in enumerate(lens.tolist()):
            kc[i, :, n_:] = float("nan")
            vc[i, :, n_:] = float("nan")
        if not torch.equal(fa.flash_decode(q, kc, vc, lens), out):
            raise AssertionError(what + ": NaN past the lengths changed "
                                 "the output")
        pl = fa.decode_plan(b, h, s, d, sms, 2)
        print("flash_decode bf16 d=%d: %s; %d blocks a row, %d shared bytes "
              "a block (float32 cache: %d); max abs err %.3g (plain "
              "version and float64 witness at one bf16 rounding); two runs "
              "bit-identical; NaN past the lengths never read" % (
                  d, lens.tolist(), n, pl["smem_bytes"],
                  fa.decode_plan(b, h, s, d, sms)["smem_bytes"], worst))
    torch.cuda.synchronize()
    return worst


def gru_widest(gc, dev):
    """The widest H, a multiple of 8, whose rows of S2S_B B6's launch
    plan admits on this card: its copy ``launch_plan`` at the card's SM
    count, which the kernel's own ``gru_plan`` (it checks residency)
    must admit, and refuse at H + 8. Returns H and the card's plan."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    h = 8
    while True:
        try:
            gc.launch_plan("gru_bwd", S2S_B, h + 8, sms)
        except ValueError:
            break
        h += 8
    plan = gc.card_plan("gru_bwd", S2S_B, h, dev)
    try:
        gc.card_plan("gru_bwd", S2S_B, h + 8, dev)
    except RuntimeError:
        return h, plan
    raise AssertionError("gru_bwd: the card admits H %d, launch_plan does "
                         "not" % (h + 8))


def check_gru(gc, g, dev):
    """B5 and B6 against their plain versions: hs and the stash; dxg, dW
    (through the GEMMs outside the kernel) and dh0, at three shapes and
    at the widest H that B6 takes on this card. Returns the max abs
    errors {kernel: err} and dW's."""
    err = {"gru_fwd": 0.0, "gru_bwd": 0.0}
    dw_err = 0.0
    h_max, plan = gru_widest(gc, dev)
    print("gru_bwd: the widest H its launch plan admits at B=%d on this "
          "card: %d (%s)" % (S2S_B, h_max, json.dumps(plan)))
    for B, T, H in ((8, 5, 32), (S2S_B, S2S_T, S2S["hidden_dim"]),
                    (37, 17, 128), (S2S_B, S2S_T, h_max)):
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


def gru_witness(gc, g, dev):
    """B5 and B6 at the path's width against float64, beside their
    float32 plain versions, at T = GRU_WITNESS_T: the largest error of hs
    and of the stash against the float64 plain version, and of dxg and
    dh0 over their largest magnitude, B6 (and its float32 plain version)
    taking the float64 stash rounded to float32. Hard at the kernels'
    tolerances, and each kernel's error may not grow more than twofold
    from the shortest T to the longest. Then two runs of B5, and of B6 on
    B5's stash, at the path's shape must agree to the bit, and B6 must
    hold its tolerances on B5's stash."""
    errs = {"gru_fwd": {}, "gru_bwd": {}}
    for T in GRU_WITNESS_T:
        xg, w, h0, mask, dhs = gru_inputs(S2S_B, T, S2S["hidden_dim"], g,
                                          dev)
        f64 = [t.double() for t in (xg, w, h0, mask, dhs)]
        ths, tst = gc.gru_forward_reference(*f64[:4])
        tdxg, tdh0 = gc.gru_backward_reference(tst, ths, *f64[1:])
        line = []
        for label, fwd, bwd in (
                ("kernel", gc.gru_forward, gc.gru_backward),
                ("plain", gc.gru_forward_reference,
                 gc.gru_backward_reference)):
            hs, st = fwd(xg, w, h0, mask)
            dxg, dh0 = bwd(tst.float(), ths.float(), w, h0, mask, dhs)
            e = [float((hs.double() - ths).abs().max()),
                 float((st.double() - tst).abs().max())]
            be = [float((got.double() - want).abs().max()
                        / want.abs().max())
                  for got, want in ((dxg, tdxg), (dh0, tdh0))]
            line.append("%s hs %.3g stash %.3g dxg %.3g dh0 %.3g" % (
                (label,) + tuple(e + be)))
            if label == "kernel":
                errs["gru_fwd"][T] = max(e)
                errs["gru_bwd"][T] = max(be)
                assert_close("gru float64 T=%d hs" % T, hs.double(), ths,
                             LSTM_ATOL, LSTM_RTOL)
                assert_close("gru float64 T=%d stash" % T, st.double(), tst,
                             LSTM_ATOL, LSTM_RTOL)
                for name, a_, b_ in (("dxg", dxg, tdxg), ("dh0", dh0, tdh0)):
                    assert_close("gru float64 T=%d %s" % (T, name),
                                 a_.double(), b_,
                                 LSTM_ATOL * max(1.0, float(b_.abs().max())),
                                 LSTM_RTOL)
        print("gru against float64 at [%d,%d,%d] (dxg, dh0: over their "
              "largest magnitude): %s" % (S2S_B, T, S2S["hidden_dim"],
                                          "; ".join(line)))
    t0, t1 = GRU_WITNESS_T[0], GRU_WITNESS_T[-1]
    for name, e in errs.items():
        print("%s: the kernel's error against float64 from T=%d to T=%d: "
              "%.3g -> %.3g (x%.2f)" % (name, t0, t1, e[t0], e[t1],
                                        e[t1] / e[t0]))
        if e[t1] > 2 * e[t0]:
            raise AssertionError("%s: the error against float64 grows more "
                                 "than twofold from T=%d to T=%d"
                                 % (name, t0, t1))
    xg, w, h0, mask, dhs = gru_inputs(S2S_B, S2S_T, S2S["hidden_dim"], g,
                                      dev)
    runs = []
    for _ in range(2):
        hs, st = gc.gru_forward(xg, w, h0, mask)
        runs.append((hs, st) + gc.gru_backward(st, hs, w, h0, mask, dhs))
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError("gru: two runs of the kernels differ")
    hs, st, dxg, dh0 = runs[0]
    want = gc.gru_backward_reference(st, hs, w, h0, mask, dhs)
    for name, a, b in (("dxg", dxg, want[0]), ("dh0", dh0, want[1])):
        assert_close("gru B6 on B5's stash %s" % name, a, b,
                     LSTM_ATOL * max(1.0, float(b.abs().max())), LSTM_RTOL)
    print("gru: two runs of B5 and B6 at [%d,%d,%d] agree to the bit; B6 "
          "on B5's stash holds its tolerances" % (S2S_B, S2S_T,
                                                 S2S["hidden_dim"]))


def check_rnn_bf16(lc, gc, g, dev):
    """The bfloat16 B3-B6 at the AMP paths' shapes (LSTM [64, 80, 512]
    with and without peepholes, GRU [64, 30, 512]) and at
    RNN_BF16_SHAPES, ragged (the LSTM on the cluster kernels of
    lstm_cluster.cu wherever kernels.lstm_cell.cluster_plan takes the
    shape, and also at LSTM_BF16_REFUSED, which it refuses, on
    lstm_cell.cu's; the GRU on gru_cluster.cu's wherever
    kernels.gru_cell.cluster_plan takes it, and at GRU_BF16_REFUSED on
    gru_cell.cu's), the card's cluster plans equal to cluster_plan's:
    each kernel against its plain version on
    the same bfloat16 inputs (hs, cs, the stash; dxg, dh0, dc0, dpeep on
    the plain forward's stash; dW through lstm_sequence's and
    gru_sequence's GEMMs), all at one bfloat16 rounding, and against a
    float64 witness that rounds to bfloat16 where the kernels do (the
    plain versions in float64 with ``rounding=torch.bfloat16``), its
    error printed beside the bf16 plain version's; then two runs of each
    at the path's shape to the same bits. Returns the max errors
    against the plain versions {kernel: err}."""
    bf16 = torch.bfloat16
    err = dict.fromkeys(("lstm_fwd_bf16", "lstm_bwd_bf16", "gru_fwd_bf16",
                         "gru_bwd_bf16"), 0.0)

    def held(name, what, got, want):
        err[name] = max(err[name], rel_close(what, got.double(),
                                             want.double(), BF16_RTOL,
                                             BF16_AMAX))

    if not lc.cluster_plan(LSTM_B, HID)["take"]:
        raise AssertionError("the path's LSTM [%d, *, %d] is not on the "
                             "cluster kernels" % (LSTM_B, HID))
    for B, H in [(LSTM_B, HID)] + [(b, h) for b, _, h in
                                   RNN_BF16_SHAPES + LSTM_BF16_REFUSED]:
        want = lc.cluster_plan(B, H)
        for kind in ("lstm_fwd", "lstm_bwd"):
            card = lc.card_cluster_plan(kind, B, H, dev)
            if {k: card[k] for k in want} != want:
                raise AssertionError("%s [%d, *, %d]: the card's cluster "
                                     "plan %s != cluster_plan's %s"
                                     % (kind, B, H, card, want))
    for B, _, H in LSTM_BF16_REFUSED:
        if lc.cluster_plan(B, H)["take"]:
            raise AssertionError("cluster_plan takes [%d, *, %d]" % (B, H))
    print("lstm bf16 cluster plans (card = cluster_plan): path %s; "
          "refused %s" % (json.dumps(lc.card_cluster_plan(
              "lstm_bwd", LSTM_B, HID, dev)), [
              sh for sh in LSTM_BF16_REFUSED]))
    s2s_h = S2S["hidden_dim"]
    if not gc.cluster_plan(S2S_B, s2s_h)["take"]:
        raise AssertionError("the path's GRU [%d, *, %d] is not on the "
                             "cluster kernels" % (S2S_B, s2s_h))
    for B, H in [(S2S_B, s2s_h)] + [(b, h) for b, _, h in
                                   RNN_BF16_SHAPES + GRU_BF16_REFUSED]:
        want = gc.cluster_plan(B, H)
        for kind in ("gru_fwd", "gru_bwd"):
            card = gc.card_cluster_plan(kind, B, H, dev)
            if {k: card[k] for k in want} != want:
                raise AssertionError("%s [%d, *, %d]: the card's cluster "
                                     "plan %s != cluster_plan's %s"
                                     % (kind, B, H, card, want))
    for B, _, H in GRU_BF16_REFUSED:
        if gc.cluster_plan(B, H)["take"]:
            raise AssertionError("cluster_plan takes [%d, *, %d]" % (B, H))
    print("gru bf16 cluster plans (card = cluster_plan): path %s; refused "
          "%s" % (json.dumps({k: gc.card_cluster_plan(k, S2S_B, s2s_h, dev)
                              for k in ("gru_fwd", "gru_bwd")}),
                  [sh for sh in GRU_BF16_REFUSED]))
    for (B, T, H), peep in [((LSTM_B, LSTM_T, HID), True),
                            ((LSTM_B, LSTM_T, HID), False)] + [
            (sh, True) for sh in RNN_BF16_SHAPES + LSTM_BF16_REFUSED]:
        xg, w, h0, c0, mask, p, dhs, dcs = lstm_inputs(B, T, H, peep, g,
                                                       dev)
        xg, w, dhs, dcs = (t.to(bf16) for t in (xg, w, dhs, dcs))
        what = "lstm bf16 %s peep=%s" % ((B, T, H), peep)
        hs, cs, st = lc.lstm_forward(xg, w, h0, c0, mask, p)
        rhs, rcs, rst = lc.lstm_forward_reference(xg, w, h0, c0, mask, p)
        for name, a, b in (("hs", hs, rhs), ("cs", cs, rcs),
                           ("stash", st, rst)):
            held("lstm_fwd_bf16", "%s %s" % (what, name), a, b)
        got = lc.lstm_backward(rst, rcs, w, p, c0, mask, dhs, dcs)
        want = lc.lstm_backward_reference(rst, rcs, w, p, c0, mask, dhs, dcs)
        for name, a, b in zip(("dxg", "dh0", "dc0", "dpeep"), got, want):
            held("lstm_bwd_bf16", "%s %s" % (what, name), a, b)
        # dW through the GEMM outside the kernel, the card against its
        # plain route on the CPU
        leaves = [t.clone().requires_grad_() for t in (xg, w)]
        kd = torch.autograd.grad(lc.lstm_sequence(
            leaves[0], leaves[1], h0, c0, mask, p), leaves[1], (dhs, dcs))[0]
        cl = [t.detach().cpu().requires_grad_() for t in leaves]
        rd = torch.autograd.grad(lc.lstm_sequence(
            cl[0], cl[1], h0.cpu(), c0.cpu(), mask.cpu(), p.cpu()), cl[1],
            (dhs.cpu(), dcs.cpu()))[0]
        rel_close(what + " dW", kd.double().cpu(), rd.double(), BF16_RTOL,
                  BF16_AMAX)
        # the float64 witness, with the kernels' roundings
        f64 = [t.double() for t in (xg, w, h0, c0, mask, p, dhs, dcs)]
        whs, wcs, wst = lc.lstm_forward_reference(*f64[:6], rounding=bf16)
        wgot = lc.lstm_backward_reference(wst, wcs, f64[1], f64[5], f64[3],
                                          f64[4], f64[6], f64[7],
                                          rounding=bf16)
        line = []
        for label, outs in (("kernel", (hs, cs, st, got)),
                            ("plain", (rhs, rcs, rst, want))):
            e = [rel_close("%s %s vs float64 %s" % (what, label, n),
                           a.double(), b, BF16_RTOL, BF16_AMAX)
                 for n, a, b in (("hs", outs[0], whs), ("cs", outs[1], wcs),
                                 ("stash", outs[2], wst))]
            # the backward on the float64 witness's own stash
            kb = (lc.lstm_backward if label == "kernel"
                  else lc.lstm_backward_reference)(
                wst.to(bf16), wcs.float(), w, p, c0, mask, dhs, dcs)
            e += [rel_close("%s %s vs float64 %s" % (what, label, n),
                            a.double(), b, BF16_RTOL, BF16_AMAX)
                  for n, a, b in zip(("dxg", "dh0"), kb, wgot)]
            line.append("%s hs %.3g cs %.3g stash %.3g dxg %.3g dh0 %.3g"
                        % ((label,) + tuple(e)))
        print("%s against the float64 witness (max abs err): %s"
              % (what, "; ".join(line)))
    for B, T, H in [(S2S_B, S2S_T, S2S["hidden_dim"])] + list(
            RNN_BF16_SHAPES + GRU_BF16_REFUSED):
        xg, w, h0, mask, dhs = gru_inputs(B, T, H, g, dev)
        xg, w, dhs = (t.to(bf16) for t in (xg, w, dhs))
        what = "gru bf16 %s" % ((B, T, H),)
        hs, st = gc.gru_forward(xg, w, h0, mask)
        rhs, rst = gc.gru_forward_reference(xg, w, h0, mask)
        for name, a, b in (("hs", hs, rhs), ("stash", st, rst)):
            held("gru_fwd_bf16", "%s %s" % (what, name), a, b)
        got = gc.gru_backward(rst, rhs, w, h0, mask, dhs)
        want = gc.gru_backward_reference(rst, rhs, w, h0, mask, dhs)
        for name, a, b in zip(("dxg", "dh0"), got, want):
            held("gru_bwd_bf16", "%s %s" % (what, name), a, b)
        leaves = [t.clone().requires_grad_() for t in (xg, w)]
        kd = torch.autograd.grad(gc.gru_sequence(leaves[0], leaves[1], h0,
                                                 mask), leaves[1], dhs)[0]
        cl = [t.detach().cpu().requires_grad_() for t in leaves]
        rd = torch.autograd.grad(gc.gru_sequence(cl[0], cl[1], h0.cpu(),
                                                 mask.cpu()), cl[1],
                                 dhs.cpu())[0]
        rel_close(what + " dW", kd.double().cpu(), rd.double(), BF16_RTOL,
                  BF16_AMAX)
        f64 = [t.double() for t in (xg, w, h0, mask, dhs)]
        whs, wst = gc.gru_forward_reference(*f64[:4], rounding=bf16)
        wgot = gc.gru_backward_reference(wst, whs, *f64[1:], rounding=bf16)
        line = []
        for label, outs in (("kernel", (hs, st)), ("plain", (rhs, rst))):
            e = [rel_close("%s %s vs float64 %s" % (what, label, n),
                           a.double(), b, BF16_RTOL, BF16_AMAX)
                 for n, a, b in (("hs", outs[0], whs), ("stash", outs[1],
                                                        wst))]
            kb = (gc.gru_backward if label == "kernel"
                  else gc.gru_backward_reference)(
                wst.to(bf16), whs.to(bf16), w, h0, mask, dhs)
            e += [rel_close("%s %s vs float64 %s" % (what, label, n),
                            a.double(), b, BF16_RTOL, BF16_AMAX)
                  for n, a, b in zip(("dxg", "dh0"), kb, wgot)]
            line.append("%s hs %.3g stash %.3g dxg %.3g dh0 %.3g"
                        % ((label,) + tuple(e)))
        print("%s against the float64 witness (max abs err): %s"
              % (what, "; ".join(line)))
    # two runs at the paths' shapes to the same bits
    xg, w, h0, c0, mask, p, dhs, dcs = lstm_inputs(LSTM_B, LSTM_T, HID,
                                                   True, g, dev, ragged=False)
    xg, w, dhs, dcs = (t.to(bf16) for t in (xg, w, dhs, dcs))
    runs = []
    for _ in range(2):
        hs, cs, st = lc.lstm_forward(xg, w, h0, c0, mask, p)
        runs.append((hs, cs, st) + lc.lstm_backward(st, cs, w, p, c0, mask,
                                                    dhs, dcs))
    same_bits("lstm bf16 B3 and B4", *runs)
    xg, w, h0, mask, dhs = gru_inputs(S2S_B, S2S_T, S2S["hidden_dim"], g,
                                      dev, ragged=False)
    xg, w, dhs = (t.to(bf16) for t in (xg, w, dhs))
    runs = []
    for _ in range(2):
        hs, st = gc.gru_forward(xg, w, h0, mask)
        runs.append((hs, st) + gc.gru_backward(st, hs, w, h0, mask, dhs))
    same_bits("gru bf16 B5 and B6", *runs)
    torch.cuda.synchronize()
    # gru_cell.cu's bf16 plan at the refused shape, its copy against the
    # kernel's
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plans = {}
    for B, _, H in GRU_BF16_REFUSED:
        for k in ("gru_fwd", "gru_bwd"):
            plans[k] = gc.launch_plan(k, B, H, sms, bf16)
            card = gc.card_plan(k, B, H, dev, bf16)
            if card != {k_: plans[k][k_] for k_ in card}:
                raise AssertionError("%s bf16 launch_plan %s != the kernel's "
                                     "%s" % (k, plans[k], card))
    print("bf16 B3-B6: two runs at the paths' shapes agree to the bit; "
          "gru_cell.cu's bf16 launch plans at %s %s" % (
              list(GRU_BF16_REFUSED), json.dumps(plans)))
    return err


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
            "lstm_bwd": STACKED * TRAIN_STEPS, "lstm_fwd_bf16": 0,
            "lstm_bwd_bf16": 0}
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


def grad_diff(names, got, want, pl2_floor=0.0):
    """How far the gradients ``got`` lie from ``want``: the worst single
    entry as a share of its gradient's largest magnitude, the worst
    gradient in relative L2 norm, and all together in relative L2 norm.
    A gradient whose L2 norm is under ``pl2_floor`` times the largest
    gradient's is a sum that cancels at these weights: it counts in the
    whole's norm but not as a gradient of its own (listed in
    ``cancels``)."""
    d = dict(worst=0.0, worst_name="", pl2=0.0, pl2_name="", cancels=[])
    num = den = 0.0
    top = max(float(np.linalg.norm(np.asarray(w, np.float64)))
              for w in want)
    for name, g, w in zip(names, got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        n2, d2 = float(((g - w) ** 2).sum()), float((w ** 2).sum())
        num += n2
        den += d2
        if d2 ** 0.5 < pl2_floor * top:
            d["cancels"].append("%s (%.3g of the largest norm)"
                                % (name, d2 ** 0.5 / top))
            continue
        e = float(np.abs(g - w).max()) / max(float(np.abs(w).max()), 1e-30)
        if e > d["worst"]:
            d["worst"], d["worst_name"] = e, name
        if (n2 / max(d2, 1e-300)) ** 0.5 > d["pl2"]:
            d["pl2"], d["pl2_name"] = (n2 / max(d2, 1e-300)) ** 0.5, name
    d["l2"] = (num / max(den, 1e-300)) ** 0.5
    return d


def check_grad_diff(what, d, gtol, l2tol, pl2tol=None):
    print("%s: worst entry %.3g x max|g| (%s), worst gradient %.3g of its "
          "L2 norm (%s), all together %.3g in relative L2 norm%s" % (
              what, d["worst"], d["worst_name"], d["pl2"], d["pl2_name"],
              d["l2"], "; held in the whole only, their sums cancel: "
              + ", ".join(d["cancels"]) if d.get("cancels") else ""))
    if (gtol is not None and d["worst"] > gtol) or d["l2"] > l2tol or \
            (pl2tol is not None and d["pl2"] > pl2tol):
        raise AssertionError("%s: gradients differ by more than %s x "
                             "max|g|, %s of one gradient's L2 norm or %g "
                             "of all together" % (what, gtol, pl2tol, l2tol))


def cross_check(fluid, exe, build, seed, batch, steps, label, gtol=1e-4,
                ltol=1e-4, l2tol=1e-3, pl2tol=None, edit=None, pl2_floor=0.0):
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
                            grad_diff(grads, k[1:], c[1:], pl2_floor), gtol,
                            l2tol, pl2tol)
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
    counted steps and the trained scope (the beam decode's weights)."""
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
    want = {"gru_fwd": 4 * TRAIN_STEPS, "gru_bwd": 2 * TRAIN_STEPS,
            "gru_fwd_bf16": 0, "gru_bwd_bf16": 0}
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
    return launches, scope


def recurrent_launches(prog, op_type):
    """Launches of a recurrent kernel pair a step, read from the program
    the executor runs (``passes.apply``): one forward for every ``op_type``
    op and one more for every ``op_type + "_grad"`` (the generic grad
    re-runs the forward under autograd), one backward for every grad.
    Returns (forwards, backwards)."""
    from paddle_tpu_torch import passes

    out, _ = passes.apply(prog)
    ops = out.global_block().ops
    fwd = sum(op.type == op_type for op in ops)
    grad = sum(op.type == op_type + "_grad" for op in ops)
    return fwd + grad, grad


def beam_decode_phase(fluid, seed, dev, scope):
    """The seq2seq beam-search decode at full width (``S2S``), from the
    scope the seq2seq training phase leaves (the decode program shares
    its parameters by name): ``build_seq2seq(mode="decode",
    beam_size=BEAM, max_len=BEAM_T)`` over S2S_B sources of S2S_T ids.
    Checks (a) the launches of one decode call: one float32 B5 for each
    ``gru`` op of the program (the two encoder directions), nothing else;
    (b) well-formed beams: the shapes, best first, 1 <= length <= BEAM_T,
    ``EOS`` past each length; (c) every one of the S2S_B x BEAM beams
    rescored by a forward-only program ``seq2seq_train`` builds over the
    same scope (tgt = BOS then the beam's first L-1 ids, tgt_next its L
    ids): its summed log-probability equals score x length (the decode
    normalises by length) within 1e-4 relative; (d) a beam-1 decode
    emits the argmax of that teacher-forced distribution wherever the
    top-two margin exceeds BEAM_TIE; (e) the card against the port on
    the CPU at S2S_XCHECK's widths from the same weights (the output
    layer sharpened by BEAM_XCHECK_SHARPEN): ids and lengths equal,
    scores at rtol 1e-4, except the rows with a step whose K-th and
    (K+1)-th candidates lie within BEAM_TIE on either device. Then the wall ms of a call (median of 5 after a warm call),
    generated and candidate tokens/s, the device's busy time and
    launches in a call, and the peak memory. Returns the kernels'
    launches of the counted call."""
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.models.seq2seq import build_seq2seq, seq2seq_train
    from paddle_tpu_torch.ops import beam_search_ops

    print("card:", card_line())
    def decode_prog(sizes, beam):
        with unique_name.guard():
            prog, _, _, outs = build_seq2seq(
                mode="decode", beam_size=beam, max_len=BEAM_T, bos_id=BOS,
                eos_id=EOS, **sizes)
        return prog, list(outs)

    def on_card(src):
        b, t = src.shape[:2]
        return fluid.PackedSeq(torch.from_numpy(src).to(dev), torch.full(
            (b,), t, dtype=torch.int32, device=dev))

    prog, outs = decode_prog(S2S, BEAM)
    fwd, bwd = recurrent_launches(prog, "gru")
    rng = np.random.RandomState(seed + 1)
    src = rng.randint(2, S2S["src_vocab"], (S2S_B, S2S_T, 1)).astype(
        np.int64)
    feed = {"src_ids": on_card(src)}
    exe = fluid.Executor()
    exe.run(prog, feed=feed, fetch_list=outs, scope=scope)      # warm
    torch.cuda.synchronize()
    reset_all_launches()
    ids, scores, lengths = exe.run(prog, feed=feed, fetch_list=outs,
                                   scope=scope)
    torch.cuda.synchronize()
    got = {n: v for n, v in all_launches().items() if v}
    want = {"gru_fwd": fwd}
    print("launches of one decode call: %s, expected %s (one B5 for each "
          "of the program's %d gru ops, the encoder's two directions; %d "
          "gru_grad)" % (json.dumps(got), json.dumps(want), fwd, bwd))
    if got != want or bwd:
        raise AssertionError("beam decode launches %s != %s" % (got, want))

    # (b) well-formed beams
    B, K, T = S2S_B, BEAM, BEAM_T
    if ids.shape != (B, K, T) or scores.shape != (B, K) \
            or lengths.shape != (B, K):
        raise AssertionError("beam shapes %s %s %s" % (
            ids.shape, scores.shape, lengths.shape))
    past = np.arange(T)[None, None, :] >= lengths[:, :, None]
    if not (np.isfinite(scores).all() and np.all(np.diff(scores, axis=1)
                                                 <= 0)
            and np.all((lengths >= 1) & (lengths <= T))
            and np.all(ids[past] == EOS)):
        raise AssertionError("beams not well formed")
    print("beams: ids %s, scores %s, lengths %s; best first; lengths %d.."
          "%d (mean %.2f), %d of %d beams ended by EOS; eos past every "
          "length" % (list(ids.shape), list(scores.shape),
                      list(lengths.shape), lengths.min(), lengths.max(),
                      lengths.mean(), int(np.sum(lengths < T)), B * K))

    # (c) rescoring by the teacher-forced training graph, forward only
    with unique_name.guard():
        fprog, fstart = fluid.Program(), fluid.Program()
        with fluid.program_guard(fprog, fstart):
            seq2seq_train(**S2S)
    b0 = fprog.global_block()
    # the per-sentence sum of the token losses (the last sequence_pool;
    # sequence_first_step is the first)
    pooled = [o for o in b0.ops if o.type == "sequence_pool"][-1] \
        .output("Out")[0]
    probs = [o for o in b0.ops if o.type == "softmax"][-1].output("Out")[0]

    def forced(beam_ids, beam_lens, fetch):
        """Teacher-force each beam (row b * k + j) through ``fprog``."""
        k = beam_ids.shape[1]
        tgt, nxt = [], []
        for b in range(beam_ids.shape[0]):
            for j in range(k):
                y = beam_ids[b, j, :beam_lens[b, j]].reshape(-1, 1)
                nxt.append(y)
                tgt.append(np.concatenate([[[BOS]], y[:-1]]).astype(
                    np.int64))
        return exe.run(fprog, feed={
            "src_ids": on_card(np.repeat(src, k, axis=0)), "tgt_ids": tgt,
            "tgt_next_ids": nxt}, fetch_list=[fetch], scope=scope)[0]

    logp = -forced(ids, lengths, pooled).reshape(B, K).astype(np.float64)
    want_sum = scores.astype(np.float64) * lengths
    rel = np.abs(logp - want_sum) / np.maximum(np.abs(want_sum), 1e-30)
    print("rescoring: the %d beams' teacher-forced log-probability sums "
          "%.4f..%.4f; score x length within %.3g relative at worst "
          "(limit 1e-4)" % (B * K, logp.min(), logp.max(), rel.max()))
    if not rel.max() <= 1e-4:
        raise AssertionError("rescored beams disagree: %.3g" % rel.max())

    # (d) beam 1 against the teacher-forced argmax
    prog1, outs1 = decode_prog(S2S, 1)
    ids1, _, len1 = exe.run(prog1, feed=feed, fetch_list=outs1, scope=scope)
    p1 = forced(ids1, len1, probs).data
    checked = ties = 0
    for b in range(B):
        for t in range(int(len1[b, 0])):
            lp = np.log(np.maximum(p1[b, t].astype(np.float64), 1e-30))
            top2 = np.partition(lp, -2)[-2:]
            if top2[1] - top2[0] <= BEAM_TIE:
                ties += 1
                continue
            checked += 1
            if int(np.argmax(lp)) != int(ids1[b, 0, t]):
                raise AssertionError(
                    "beam 1: row %d step %d emitted %d, the teacher-forced "
                    "argmax is %d" % (b, t, ids1[b, 0, t], np.argmax(lp)))
    print("beam 1: %d emitted tokens equal the teacher-forced argmax; %d "
          "near-ties (top-two margin <= %g) excepted" % (checked, ties,
                                                          BEAM_TIE))
    del p1

    # (e) the card against the CPU at a reduced width, same weights
    with unique_name.guard():
        _, xstart, _, _ = build_seq2seq(lr=LR, **S2S_XCHECK)
    xstart.random_seed = seed
    cpu_scope, card_scope = fluid.Scope(), fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(xstart, scope=cpu_scope)
    for n in ("dec_out_w", "dec_out_b"):
        cpu_scope.find_var(n).mul_(BEAM_XCHECK_SHARPEN)
    for n, t_ in cpu_scope.vars.items():
        card_scope.set_var(n, t_.to(dev))
    xprog, xouts = decode_prog(S2S_XCHECK, BEAM)
    xsrc = rng.randint(2, S2S_XCHECK["src_vocab"],
                       (S2S_XCHECK_B, S2S_XCHECK_T, 1)).astype(np.int64)
    orig = beam_search_ops.top_k_lower_index_first
    res = {}
    for name, ex, sc in (("cpu", fluid.Executor(fluid.CPUPlace()),
                          cpu_scope),
                         ("card", exe, card_scope)):
        gaps = []

        def recording(x, k):
            # the first k of the top k + 1 are the top k
            v, i = orig(x, k + 1)
            gaps.append((v[:, k - 1] - v[:, k]).abs().cpu())
            return v[:, :k], i[:, :k]

        beam_search_ops.top_k_lower_index_first = recording
        try:
            out = ex.run(xprog, feed={"src_ids": [r for r in xsrc]},
                         fetch_list=xouts, scope=sc)
        finally:
            beam_search_ops.top_k_lower_index_first = orig
        res[name] = (out, torch.stack(gaps).min(0).values.numpy())
    near = (res["cpu"][1] <= BEAM_TIE) | (res["card"][1] <= BEAM_TIE)
    ok = ~near
    (ci, cs, cl), (ki, ks, kl) = res["cpu"][0], res["card"][0]
    if not (np.array_equal(ki[ok], ci[ok]) and np.array_equal(kl[ok],
                                                              cl[ok])):
        raise AssertionError("beam decode: card and CPU disagree on ids or "
                             "lengths away from near-ties")
    np.testing.assert_allclose(ks[ok], cs[ok], rtol=1e-4)
    print("card == cpu at %s (output layer x%g), %d sources of %d ids, "
          "beam %d, max_len %d: ids and lengths equal, scores within rtol "
          "1e-4 (worst %.3g) on %d of %d rows; %d rows excepted (a step's "
          "K-th and (K+1)-th candidates within %g)" % (
              S2S_XCHECK, BEAM_XCHECK_SHARPEN, S2S_XCHECK_B, S2S_XCHECK_T,
              BEAM, BEAM_T,
              float(np.max(np.abs(ks[ok] - cs[ok]) / np.abs(cs[ok])))
              if ok.any() else 0.0, int(ok.sum()), len(ok),
              int(near.sum()), BEAM_TIE))
    del cpu_scope, card_scope

    # the decode call's wall time, tokens/s, device time, memory
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exe.run(prog, feed=feed, fetch_list=outs, scope=scope)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1000.0)
    wall = float(np.median(walls))
    gen = int(lengths[:, 0].sum())
    print("decode call: %.3f ms wall (median of 5: %s); %d sentences, %.1f "
          "sentences/s; %d generated tokens (the top beams' lengths), "
          "%.1f generated tokens/s; %d candidate tokens (B x K x T), %.1f "
          "candidate tokens/s" % (
              wall, " ".join("%.3f" % w for w in walls), B,
              B / wall * 1e3, gen, gen / wall * 1e3, B * K * T,
              B * K * T / wall * 1e3))
    device_profile(lambda: exe.run(prog, feed=feed, fetch_list=outs,
                                   scope=scope),
                   1, wall, "beam decode call", share_of="gru_fwd_kernel")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    exe.run(prog, feed=feed, fetch_list=outs, scope=scope)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    print("decode call: peak allocated %.1f MB, %.1f MB above the %.1f MB "
          "held before it (the training scope)" % (
              peak / 1e6, (peak - base) / 1e6, base / 1e6))
    return {"gru_fwd": fwd}


def word_embedding_build(fluid, sizes, is_sparse, opt, only_table=False):
    """The word_embedding golden's graph (tools/goldens.py:70-86) at
    ``sizes``, its table row-sparse or dense, trained by ``opt()``; only
    the table with ``only_table``."""
    from paddle_tpu_torch import layers, unique_name

    with unique_name.guard():
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            words = [layers.data("w%d" % i, [1], dtype="int64")
                     for i in range(W2V_CONTEXT)]
            embs = [layers.embedding(
                w, size=[sizes["dict_size"], sizes["emb"]],
                is_sparse=is_sparse, param_attr=fluid.ParamAttr(
                    name="shared")) for w in words]
            hidden = layers.fc(layers.concat(embs, axis=1), sizes["hidden"],
                               act="sigmoid")
            predict = layers.fc(hidden, sizes["dict_size"], act="softmax")
            label = layers.data("next", [1], dtype="int64")
            loss = layers.mean(layers.cross_entropy(predict, label))
            opt().minimize(loss, parameter_list=["shared"] if only_table
                           else None)
    return prog, startup, loss


def word_embedding_feed(rng, sizes, dev=None):
    """W2V_B windows of Zipf-distributed ids (a text's word frequencies:
    the frequent words repeat within a batch, so the row-sparse gradient
    carries duplicate rows), as tensors on ``dev`` or numpy."""
    ids = np.minimum(rng.zipf(1.1, (W2V_CONTEXT + 1, W2V_B, 1)),
                     sizes["dict_size"]) - 1
    feed = {"w%d" % i: ids[i].astype(np.int64) for i in range(W2V_CONTEXT)}
    feed["next"] = ids[W2V_CONTEXT].astype(np.int64)
    if dev is not None:
        feed = {n: torch.from_numpy(a).to(dev) for n, a in feed.items()}
    return feed


def sparse_phase(fluid, seed, dev):
    """Row-sparse embedding training at full width (``W2V``): (a) sparse
    SGD (lr 0.1) against dense SGD from the same weights, 3 steps: losses
    at rtol 1e-5, the table within 1e-5 x max|table|; (b) sparse Adam
    (1e-3), 2 + 10 steps: each step leaves the parameter and both moments
    of every row it does not look up bitwise unchanged, the loss falls,
    and no kernel of the port's is launched (the path has none); (c) the
    card against the port on the CPU at ``W2V_XCHECK``, sparse Adam, 3
    steps: losses and every state tensor at rtol 1e-4; (d) ``run_chunk``
    (K=4, two chunks of graph replays) against eager steps, sparse and
    dense, SGD and Adam (graph_path: bitwise, and the sparse updates
    bitwise from one eager run to the next), with host and device ms/step
    eager and with graphs; (e) the step guard over the table alone:
    ``guard.nonfinite`` at step 2 puts a NaN into the row-sparse
    gradient, the only gradient, and the step is skipped with every state
    tensor bitwise unchanged."""
    from paddle_tpu_torch import fault, guard

    print("card:", card_line())
    rng = np.random.RandomState(seed + 2)
    feed = word_embedding_feed(rng, W2V, dev)
    ids = torch.cat([feed["w%d" % i].reshape(-1)
                     for i in range(W2V_CONTEXT)])
    touched = torch.unique(ids)
    untouched = torch.ones(W2V["dict_size"], dtype=torch.bool, device=dev)
    untouched[touched] = False
    V, E = W2V["dict_size"], W2V["emb"]
    print("batch %d windows: %d ids, %d distinct rows of %d; the table "
          "%.1f MB, with Adam's moments %.1f MB" % (
              W2V_B, ids.numel(), touched.numel(), V, V * E * 4 / 1e6,
              3 * V * E * 4 / 1e6))
    exe = fluid.Executor()

    # (a) sparse SGD against dense SGD
    sgd = (lambda: fluid.optimizer.SGD(0.1))
    adam = (lambda: fluid.optimizer.Adam(1e-3))
    sp = word_embedding_build(fluid, W2V, True, sgd)
    de = word_embedding_build(fluid, W2V, False, sgd)
    sp[1].random_seed = seed
    s_scope, d_scope = fluid.Scope(), fluid.Scope()
    exe.run(sp[1], scope=s_scope)
    for n, t in s_scope.vars.items():
        d_scope.set_var(n, t.clone())
    ls, ld = [], []
    for _ in range(3):
        ls.append(float(exe.run(sp[0], feed=feed, fetch_list=[sp[2]],
                                scope=s_scope)[0]))
        ld.append(float(exe.run(de[0], feed=feed, fetch_list=[de[2]],
                                scope=d_scope)[0]))
    np.testing.assert_allclose(ls, ld, rtol=1e-5)
    ts, td = s_scope.find_var("shared"), d_scope.find_var("shared")
    err, amax = float((ts - td).abs().max()), float(td.abs().max())
    print("sparse SGD == dense SGD over 3 steps: losses %s / %s (rtol "
          "1e-5), the table within %.3g of max|table| %.4g (limit 1e-5)"
          % (" ".join("%.6f" % v for v in ls),
             " ".join("%.6f" % v for v in ld), err / amax, amax))
    if not err <= 1e-5 * amax:
        raise AssertionError("sparse and dense SGD tables differ: %.3g"
                             % err)
    del s_scope, d_scope

    # (b) sparse Adam: untouched rows bitwise, the loss falls
    prog, startup, loss = word_embedding_build(fluid, W2V, True, adam)
    startup.random_seed = seed
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    table = ["shared"] + sorted(
        n for n, v in prog.global_block().vars.items()
        if getattr(v, "optimizer_state_for", None) == "shared"
        and tuple(v.shape) == (V, E))
    reset_all_launches()
    losses = []
    for _ in range(WARMUP_STEPS + TRAIN_STEPS):
        before = {n: scope.find_var(n)[untouched].clone() for n in table}
        losses.append(float(exe.run(prog, feed=feed, fetch_list=[loss],
                                    scope=scope)[0]))
        for n in table:
            if not torch.equal(scope.find_var(n)[untouched], before[n]):
                raise AssertionError("lazy Adam moved untouched rows of %s"
                                     % n)
    torch.cuda.synchronize()
    launched = {n: v for n, v in all_launches().items() if v}
    print("sparse Adam: %d steps, %s and its moments %s bitwise unchanged "
          "on the %d rows no id looks up; losses %s; kernel launches %s "
          "(the path runs none of the port's kernels)" % (
              len(losses), table[0], table[1:], int(untouched.sum()),
              " ".join("%.6f" % v for v in losses), json.dumps(launched)))
    if len(table) != 3 or launched or not np.isfinite(losses).all() \
            or not losses[-1] < losses[0]:
        raise AssertionError("sparse Adam: moments %s, launches %s, losses "
                             "%s" % (table, launched, losses))
    del scope

    # (c) the card against the CPU at a reduced width
    xprog, xstart, xloss = word_embedding_build(fluid, W2V_XCHECK, True,
                                                adam)
    xstart.random_seed = seed
    cpu_scope, card_scope = fluid.Scope(), fluid.Scope()
    cpu = fluid.Executor(fluid.CPUPlace())
    cpu.run(xstart, scope=cpu_scope)
    for n, t in cpu_scope.vars.items():
        card_scope.set_var(n, t.to(dev))
    xfeed = word_embedding_feed(rng, W2V_XCHECK)
    for step in range(3):
        c = float(cpu.run(xprog, feed=xfeed, fetch_list=[xloss],
                          scope=cpu_scope)[0])
        k = float(exe.run(xprog, feed=xfeed, fetch_list=[xloss],
                          scope=card_scope)[0])
        np.testing.assert_allclose(k, c, rtol=1e-4)
    worst = 0.0
    for n, want in cpu_scope.vars.items():
        got = card_scope.find_var(n).cpu()
        d = (got.double() - want.double()).abs()
        lim = 1e-4 * want.double().abs() + 1e-6 * float(
            want.double().abs().max())
        if bool((d > lim).any()):
            raise AssertionError("sparse Adam card vs cpu: %s" % n)
        worst = max(worst, float((d / (want.double().abs() + 1e-30))
                                 .max()) if want.numel() else 0.0)
    print("card == cpu at %s, batch %d: 3 sparse Adam steps' losses (last "
          "%.7f / %.7f) and all %d state tensors within rtol 1e-4 (+ 1e-6 "
          "of each tensor's max)" % (W2V_XCHECK, W2V_B, c, k,
                                     len(cpu_scope.vars)))
    del cpu_scope, card_scope

    # (d) run_chunk's graphs against eager steps; ms/step
    times = {}
    for opt_name, opt in (("SGD", sgd), ("Adam", adam)):
        for sparse in (True, False):
            label = "word_embedding %s %s" % ("sparse" if sparse
                                              else "dense", opt_name)
            r = graph_path(fluid, label, word_embedding_build(
                fluid, W2V, sparse, opt), feed, 4, 2, seed, {},
                (1e-5, 1e-4, 1e-5))
            if sparse and r["noisy"]:
                raise AssertionError("%s: %d state tensors differ between "
                                     "two eager runs" % (label, r["noisy"]))
            times[label] = r
    print("word_embedding ms/step (host eager, host graphs, busy eager, "
          "busy graphs): %s" % "; ".join(
              "%s %.3f %.3f %s %s" % (n, r["host_eager"], r["host_graphs"],
                                      "%.3f" % r["busy_eager"]
                                      if r["busy_eager"] is not None
                                      else "n/m",
                                      "%.3f" % r["busy_graphs"]
                                      if r["busy_graphs"] is not None
                                      else "n/m")
              for n, r in times.items()))

    # (e) the guard skips a step whose row-sparse gradient is NaN
    prog, startup, loss = word_embedding_build(fluid, W2V, True, adam,
                                               only_table=True)
    guard.enable(prog, loss, divergence=False)
    startup.random_seed = seed
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    gexe = fluid.Executor()             # its steps count from 1 here
    fault.clear()
    fault.inject("guard.nonfinite", crash_on_nth=2, times=1)
    try:
        rows = []
        for i in range(4):
            before = scope_state(scope)
            gexe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
            rows.append(gexe.poll_health())
            after = scope_state(scope)
            if i == 1:
                moved = [n for n in before if not n.startswith("guard@")
                         and not torch.equal(before[n], after[n])]
                if moved:
                    raise AssertionError("the skipped step moved %s"
                                         % moved)
            if not bool(torch.isfinite(after["shared"]).all()):
                raise AssertionError("a NaN reached the table")
    finally:
        fault.clear()
    skipped = np.concatenate(rows)[:, 2]
    print("guard over the row-sparse table gradient alone, NaN injected at "
          "step 2: skipped %s (want [0, 1, 0, 0]); every state tensor "
          "bitwise unchanged across the skip; the table finite" %
          skipped.tolist())
    if skipped.tolist() != [0.0, 1.0, 0.0, 0.0]:
        raise AssertionError("guard skipped %s" % skipped)
    return times


def rnn_amp_phase(fluid, seed, dev, model):
    """The stacked LSTM (``model="lstm"``) or seq2seq (``"gru"``) trained
    as bench.py runs it: bf16 AMP at full width, batch 64, every row at
    the full length, 2 warmup and 10 counted steps on one repeated batch
    (exact bfloat16 B3/B4 or B5/B6 launches derived from the program, no
    float32 one), a profile of one step, the card against the CPU at the
    reduced size under AMP at the AMP bounds. Returns the counted steps'
    launches."""
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.kernels import gru_cell as gc
    from paddle_tpu_torch.kernels import lstm_cell as lc
    from paddle_tpu_torch.models.seq2seq import build_seq2seq
    from paddle_tpu_torch.models.stacked_lstm import build_stacked_lstm_train

    rng = np.random.RandomState(seed)
    if model == "lstm":
        kern, B, T = lc, LSTM_B, LSTM_T

        def build(**kw):
            built = build_stacked_lstm_train(class_dim=CLASSES, lr=LR, **kw)
            return built[0], built[1], built[2], built[3][:1]

        full = dict(dict_dim=DICT, emb_dim=EMB, hid_dim=HID,
                    stacked_num=STACKED)
        xsize = XCHECK
        # bench.py's feed (bench.py:169-176): ids in [0, dict), labels 0/1
        feed = {"words": rng.randint(0, DICT, (B, T, 1)),
                "label": rng.randint(0, CLASSES, (B, 1))}
        xfeed = {"words": [rng.randint(0, xsize["dict_dim"], (XCHECK_T, 1))
                           for _ in range(XCHECK_B)],
                 "label": rng.randint(0, CLASSES, (XCHECK_B, 1))}
    else:
        kern, B, T = gc, S2S_B, S2S_T

        def build(**kw):
            return build_seq2seq(lr=LR, **kw)

        full, xsize = S2S, S2S_XCHECK
        # bench.py's feed (bench.py:197-205): three independent id
        # sequences in [1, vocab)
        feed = {n: rng.randint(1, S2S["tgt_vocab"], (B, T, 1))
                for n in ("src_ids", "tgt_ids", "tgt_next_ids")}
        xfeed = {n: [rng.randint(1, xsize["tgt_vocab"], (S2S_XCHECK_T, 1))
                     for _ in range(S2S_XCHECK_B)]
                 for n in ("src_ids", "tgt_ids", "tgt_next_ids")}
    with unique_name.guard():
        prog, startup, _, (loss,) = build(**full)
    fluid.amp.enable(prog)
    fwd, bwd = recurrent_launches(prog, model)
    startup.random_seed = seed
    scope = fluid.Scope()
    exe = fluid.Executor()                      # CUDAPlace(0)
    exe.run(startup, scope=scope)
    n_params = sum(p.numel() for n, p in scope.vars.items()
                   if prog.global_block().var(n).is_parameter)
    on_card = {n: torch.from_numpy(a.astype(np.int64)).to(dev)
               for n, a in feed.items()}
    for n in on_card:
        if on_card[n].dim() == 3:       # a sequence: every row full length
            on_card[n] = fluid.PackedSeq(on_card[n], torch.full(
                (B,), T, dtype=torch.int32, device=dev))
    print("parameters: %d (%.1f MB fp32 masters); batch %d x %d tokens, "
          "every row full length; bf16 AMP; from the program a step: %d "
          "bf16 forwards (with the grads' recomputes), %d backwards"
          % (n_params, n_params * 4 / 1e6, B, T, fwd, bwd))
    for _ in range(WARMUP_STEPS):
        exe.run(prog, feed=on_card, fetch_list=[loss], scope=scope)
    torch.cuda.synchronize()
    kern.reset_launches()
    losses = []
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        losses.append(float(exe.run(prog, feed=on_card, fetch_list=[loss],
                                    scope=scope)[0]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kern.launches)
    want = {model + "_fwd": 0, model + "_bwd": 0,
            model + "_fwd_bf16": fwd * TRAIN_STEPS,
            model + "_bwd_bf16": bwd * TRAIN_STEPS}
    print("launches on the main path:", json.dumps(launches), "expected",
          json.dumps(want))
    if launches != want:
        raise AssertionError("%s launch counts %s != %s"
                             % (model, launches, want))
    print("losses:", " ".join("%.6f" % v for v in losses))
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError("training loss not finite and falling: %s"
                             % losses)
    step_ms = wall * 1000.0 / TRAIN_STEPS
    print("%s train (bf16 AMP): %d steps in %.3f s = %.3f ms/step, %.2f "
          "sequences/s, %.1f tokens/s" % (
              "stacked LSTM" if model == "lstm" else "seq2seq", TRAIN_STEPS,
              wall, step_ms, B / (step_ms / 1e3), B * T / (step_ms / 1e3)))
    device_profile(lambda: exe.run(prog, feed=on_card, fetch_list=[loss],
                                   scope=scope),
                   1, step_ms, "%s step (bf16 AMP)" % model,
                   share_of=(model + "_fwd_kernel", model + "_bwd_kernel"))
    del scope, exe, on_card
    torch.cuda.empty_cache()

    kern.reset_launches()
    # seq2seq's att_dec_w gradient cancels at initialisation (its norm is
    # ~1e-6 of the largest gradient's in float32 and in bf16 alike, where
    # the next smallest is ~8e-4): under bf16 what is left of it is the
    # roundings of its terms, so it is held in the whole's norm only
    cross_check(fluid, fluid.Executor(), lambda: _amp(fluid, build(**xsize)),
                seed, xfeed, XCHECK_STEPS, "%s, equal lengths, bf16 AMP"
                % (xsize,), gtol=None, ltol=AMP_LTOL, l2tol=AMP_L2TOL,
                pl2tol=AMP_PL2TOL, pl2_floor=AMP_CANCELS)
    with unique_name.guard():
        xfwd, xbwd = recurrent_launches(_amp(fluid, build(**xsize))[0],
                                        model)
    if kern.launches[model + "_fwd_bf16"] != xfwd * XCHECK_STEPS or \
            kern.launches[model + "_bwd_bf16"] != xbwd * XCHECK_STEPS or \
            kern.launches[model + "_fwd"] or kern.launches[model + "_bwd"]:
        raise AssertionError("cross-check launches %s" % kern.launches)
    return launches


def _amp(fluid, built):
    fluid.amp.enable(built[0])
    return built


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


def check_bn_grad(kbn, g, dev, shapes=BN_SHAPES,
                  dtypes=(torch.float32, torch.bfloat16)):
    """B7 against its plain version on the card, and both against the
    plain version in float64. Returns the max abs err of dx against the
    plain version in the first of ``dtypes``."""
    worst = 0.0
    for shape in shapes:
        for dtype in dtypes:
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
            if dtype == dtypes[0]:
                worst = max(worst, errs["plain"][0])
            again = kbn.bn_grad(x, dy, scale, 1e-5)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(what + ": two runs differ")
    torch.cuda.synchronize()
    return worst


def check_conv1x1(k1, g, dev, shapes,
                  dtypes=(torch.float32, torch.bfloat16)):
    """B8 against its plain version on the card, and both against
    float64, at each (B, Ci, H, W, Co) of ``shapes``. Returns the max abs
    err of dx and dw against the plain version in the first of
    ``dtypes``."""
    worst = 0.0
    for b, ci, h, w, co in shapes:
        for dtype in dtypes:
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
            what = "conv1x1_bwd %s %s (%s)" % (
                (b, ci, h, w, co), dtype,
                k1.plan(b, ci, co, h * w, x.element_size()).loader)
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
            if dtype == dtypes[0]:
                worst = max(worst, *errs["plain"])
            again = k1.conv1x1_bwd(x, wt, dy)
            if not all(torch.equal(a, r) for a, r in zip(got, again)):
                raise AssertionError(what + ": two runs differ")
    torch.cuda.synchronize()
    return worst


def c1_chunk_sweep(k1, build, g, dev):
    """dw's error against float64 at C1_SWEEP_SHAPE when its depth is cut
    into chunks of each length of C1_SWEEP_CHUNKS (the plan's other
    numbers as plan() works them out for that chunk): the longer a
    block's chain of tensor-core products, the more a truncating
    accumulation shows. float32 (each 32-deep stage summed apart) must
    hold the path's tolerance; bfloat16 (one accumulator a chunk, on
    wgmma) the bfloat16 one, and the sweep shows how far inside it."""
    b, ci, h, w, co = C1_SWEEP_SHAPE
    hw = h * w
    lib = build.load("conv1x1_bwd")
    for dtype, rtol, amax in ((torch.float32, C1_RTOL, C1_AMAX),
                              (torch.bfloat16, BF16_RTOL, BF16_AMAX)):
        x = torch.randn(b, ci, h, w, generator=g).to(dtype).to(dev)
        wt = (torch.randn(co, ci, 1, 1, generator=g) * ci ** -0.5) \
            .to(dtype).to(dev)
        dy = torch.randn(b, co, h, w, generator=g).to(dtype).to(dev)
        truth = k1.conv1x1_bwd_reference(x.double(), wt.double(),
                                         dy.double())[1]
        top = float(truth.abs().max())
        pl = k1.plan(b, ci, co, hw, x.element_size())
        depth = b * pl.hw_pad
        tiles = -(-co // pl.co_tile) * -(-ci // pl.ci_tile)
        errs = []
        for chunk in C1_SWEEP_CHUNKS:
            splits = -(-depth // chunk)
            group = math.isqrt(splits - 1) + 1
            partial = torch.empty((splits, co, ci), dtype=torch.float32,
                                  device=dev)
            tickets = torch.zeros((tiles * (-(-splits // group) + 1),),
                                  dtype=torch.int32, device=dev)
            dx, dw = torch.empty_like(x), torch.empty_like(wt)
            if dtype == torch.bfloat16:
                fn, last = lib.conv1x1_bwd_bf16, k1.LOADERS[pl.loader]
            else:
                fn, last = lib.conv1x1_bwd, int(pl.vec)
            rc = fn(x.data_ptr(), wt.data_ptr(), dy.data_ptr(),
                    dx.data_ptr(), dw.data_ptr(), partial.data_ptr(),
                    tickets.data_ptr(), b, ci, co, hw, splits, chunk, group,
                    pl.order, pl.ci_tile, pl.co_tile, last,
                    torch.cuda.current_stream(dev).cuda_stream)
            if rc != 0:
                raise RuntimeError("conv1x1_bwd %s chunk %d: cudaError %d"
                                   % (dtype, chunk, rc))
            err = (dw.double() - truth).abs()
            tol = amax * top + rtol * truth.abs()
            e = float(err.max())
            errs.append((chunk, e, bool((err <= tol).all())
                         and bool(torch.isfinite(dw).all())))
        print("conv1x1_bwd %s %s dw vs float64 by chunk length (max|dw| "
              "%.4g, loader %s): %s" % (C1_SWEEP_SHAPE, dtype, top,
                                        pl.loader, "; ".join(
            "chunk %d: %.4g (%.3g of max)%s" % (c, e, e / top,
                                                "" if ok else " OUTSIDE")
            for c, e, ok in errs)))
        if not all(ok for _, _, ok in errs):
            raise AssertionError("conv1x1_bwd %s: dw outside rtol %g + %g "
                                 "max at some chunk length"
                                 % (dtype, rtol, amax))
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


def resnet_train(exe, prog, feed, loss, acc, scope, low, label, want,
                 want_inside, share_of):
    """WARMUP_STEPS and TRAIN_STEPS counted steps of a ResNet-50 config
    from ``scope``: the launch counts of the counted steps must equal
    ``want`` and those made inside ``conv2d_bn_act``'s grad
    ``want_inside``; the loss (Momentum at lr 0.1 overshoots on the one
    repeated batch) must be finite and come under the first counted one
    within RESNET_SETTLE_STEPS further steps; from ``low``, the same
    weights at RESNET_LOW_LR, it must fall at every step. Prints
    ms/step, images/s, peak memory and a profile of one step (with
    ``share_of``'s device time). Returns the counted launches."""
    from paddle_tpu_torch.kernels import bn_grad as kbn
    from paddle_tpu_torch.kernels import conv1x1_bwd as k1

    torch.cuda.reset_peak_memory_stats()
    for _ in range(WARMUP_STEPS):
        exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
    torch.cuda.synchronize()
    kbn.reset_launches()
    k1.reset_launches()
    losses, accs = [], []
    with InsideFused(kbn, k1) as in_fused:
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
    print("config %s: launches on the main path: %s expected %s; inside "
          "conv2d_bn_act_grad %s expected %s" % (
              label, json.dumps(got), json.dumps(want),
              json.dumps(in_fused.counts), json.dumps(want_inside)))
    if got != want or in_fused.counts != want_inside:
        raise AssertionError("ResNet-50 config %s launch counts" % label)
    print("losses:", " ".join("%.6f" % v for v in losses))
    print("accuracy:", " ".join("%.4f" % v for v in accs))
    settle(exe, prog, feed, loss, scope, losses, RESNET_SETTLE_STEPS)
    lr_name = next(op.input("LearningRate")[0]
                   for op in prog.global_block().ops
                   if op.type == "momentum")
    low.set_var(lr_name, torch.full_like(low.find_var(lr_name),
                                         RESNET_LOW_LR))
    low_losses = [float(exe.run(prog, feed=feed, fetch_list=[loss],
                                scope=low)[0])
                  for _ in range(RESNET_LOW_LR_STEPS + 1)]
    print("losses at lr %g:" % RESNET_LOW_LR,
          " ".join("%.6f" % v for v in low_losses))
    if not np.isfinite(low_losses).all() or \
            not (np.diff(low_losses) < 0).all():
        raise AssertionError("training loss at lr %g does not fall at "
                             "every step: %s" % (RESNET_LOW_LR, low_losses))
    step_ms = wall * 1000.0 / TRAIN_STEPS
    print("config %s train: %d steps in %.3f s = %.3f ms/step, %.2f "
          "images/s; peak device memory %.2f GB" % (
              label, TRAIN_STEPS, wall, step_ms, RESNET_B / (step_ms / 1e3),
              torch.cuda.max_memory_allocated() / 1e9))
    device_profile(lambda: exe.run(prog, feed=feed, fetch_list=[loss],
                                   scope=scope),
                   1, step_ms, "resnet50 config %s step" % label,
                   share_of=share_of)
    return got


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
    bn_shapes = transformed_launches(progs["A"][0], RESNET_B)[0]
    c1_shapes = transformed_launches(progs["B"][0], RESNET_B)[1]
    n_bn, n_c1 = sum(bn_shapes.values()), sum(c1_shapes.values())
    print("per step, from the transformed programs: %d tagged batch-norm "
          "grads -> %d B7 launches in config A; %d 1x1 stride-1 conv2d "
          "ops -> %d B8 launches in config B" % (n_bn, n_bn, n_c1, n_c1))
    if (n_bn, n_c1) != (53, 30):
        raise AssertionError("ResNet-50 should hold 53 batch norms and 30 "
                             "fusable convolutions, got %d and %d"
                             % (n_bn, n_c1))

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
            key = "bn_grad" if config == "A" else "conv1x1_bwd"
            want = {"bn_grad": 0, "conv1x1_bwd": 0}
            launches[key] = resnet_train(
                exe, prog, feed, loss, acc, scope, clone(scope0),
                "%s (%s)" % (config, name),
                dict(want, **{key: (n_bn if config == "A" else n_c1)
                              * TRAIN_STEPS}), want,
                B7_KERNELS if config == "A" else "conv1x1_bwd_kernel")[key]
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
            else (0, n_c1 * XCHECK_STEPS)
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

    return launches, bn_shapes, c1_shapes


def fused_build(config, sizes):
    """ResNet-50 under bf16 AMP (``amp.enable``, as bench.py runs every
    convnet) in config C "bench" (NHWC, ``passes.enable(layout="NHWC",
    epilogue_fusion=True, pallas_reductions=True)``, bench.py's pass
    A/B) or D "nchw+fused1x1+epilogue" (NCHW, ``epilogue_fusion=True``;
    the caller turns FLAGS_fused_conv1x1_bwd on)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.resnet import build_resnet50_train

    prog, startup, feeds, (loss, acc) = build_resnet50_train(
        layout="NHWC" if config == "C" else "NCHW", **sizes)
    fluid.amp.enable(prog)
    if config == "C":
        fluid.passes.enable(prog, **BENCH_PASSES)
    else:
        fluid.passes.enable(prog, epilogue_fusion=True)
    return prog, startup, feeds, (loss, acc)


def transformed_launches(prog, batch, fetches=()):
    """Launches a step and their shapes, read from the program the
    executor runs (``passes.apply``): one B7 for every op the reduction
    pass tagged, at its NHWC activation (for a fused op, its conv's
    output), and one B8 for every 1x1 stride-1 unpadded undilated
    ungrouped NCHW convolution, inside ``conv2d_bn_act`` or a plain
    ``conv2d``. Returns ({(N, H, W, C): count}, {(B, Ci, H, W, Co):
    count}, (how many of the B7, how many of the B8 sit inside
    ``conv2d_bn_act``'s grad))."""
    from paddle_tpu_torch import passes

    out, _ = passes.apply(prog, protected=fetches)
    block = out.global_block()
    by_uid = {op.uid: op for op in block.ops}

    def shape(name):
        return tuple(batch if d == -1 else d for d in block.var(name).shape)

    b7, b8, fused7, fused8 = {}, {}, 0, 0
    for op in block.ops:
        if op.attrs.get("use_pallas_reduction"):
            key = shape(op.input("X")[0]) if op.type == "batch_norm_grad" \
                else shape(by_uid[op.attrs["fwd_op_uid"]].output("Out")[0])
            b7[key] = b7.get(key, 0) + 1
            fused7 += op.type == "conv2d_bn_act_grad"
        if op.type not in ("conv2d", "conv2d_bn_act") or \
                op.attrs.get("conv_type", "conv2d") != "conv2d":
            continue
        a = op.attrs
        wshape = block.var(op.input("Filter")[0]).shape
        if tuple(wshape[2:]) == (1, 1) and list(a["strides"]) == [1, 1] \
                and not any(a["paddings"]) \
                and list(a["dilations"]) == [1, 1] \
                and (a.get("groups", 1) or 1) == 1 \
                and a.get("data_layout", "NCHW") == "NCHW":
            x = shape(op.input("Input")[0])
            key = x + (wshape[0],)
            b8[key] = b8.get(key, 0) + 1
            fused8 += op.type == "conv2d_bn_act"
    return b7, b8, (fused7, fused8)


def bench_path_shapes():
    """B7's shapes in config C and B8's in config D at full width, from
    the transformed programs."""
    from paddle_tpu_torch import unique_name

    with unique_name.guard():
        prog_c = fused_build("C", RESNET)[0]
    with unique_name.guard():
        prog_d = fused_build("D", RESNET)[0]
    return (transformed_launches(prog_c, RESNET_B)[0],
            transformed_launches(prog_d, RESNET_B)[1])


class InsideFused:
    """Counts the B7 and B8 launches made inside ``conv2d_bn_act``'s
    grad while it is entered (wraps the registered grad lowering)."""

    def __init__(self, kbn, k1):
        from paddle_tpu_torch.core import registry

        self.spec = registry.get("conv2d_bn_act")
        self.kbn, self.k1 = kbn, k1
        self.counts = {"bn_grad": 0, "conv1x1_bwd": 0}

    def __enter__(self):
        self.real = real = self.spec.grad_lower

        def counted(*a, **k):
            b0 = self.kbn.launches["bn_grad"]
            c0 = self.k1.launches["conv1x1_bwd"]
            try:
                return real(*a, **k)
            finally:
                self.counts["bn_grad"] += self.kbn.launches["bn_grad"] - b0
                self.counts["conv1x1_bwd"] += \
                    self.k1.launches["conv1x1_bwd"] - c0

        self.spec.grad_lower = counted
        return self

    def __exit__(self, *exc):
        self.spec.grad_lower = self.real


def settle(exe, prog, feed, loss, scope, losses, limit):
    """Further steps until a loss comes under the first of ``losses``
    (one repeated batch: a high lr overshoots first), at most ``limit``;
    raises unless every loss is finite and one came under."""
    more = []
    while len(more) < limit and not min(losses[1:] + more) < losses[0]:
        more.append(float(exe.run(prog, feed=feed, fetch_list=[loss],
                                  scope=scope)[0]))
    if more:
        print("further steps until the loss is under the first counted "
              "one:", " ".join("%.6f" % v for v in more))
    if not np.isfinite(losses + more).all() or \
            not min(losses[1:] + more) < losses[0]:
        raise AssertionError("training loss not finite and falling: %s"
                             % (losses + more))


def convnet_bench_phase(fluid, seed, dev):
    """ResNet-50 at full width in bench.py's convnet configuration:
    configs C and D under bf16 AMP, C against D, the card against the
    CPU at the resnet_cifar size; then VGG-16, GoogLeNet, AlexNet and
    SmallNet under AMP. Returns the counted steps' B7 (config C) and B8
    (config D) launches."""
    from paddle_tpu_torch import flags, unique_name
    from paddle_tpu_torch.kernels import bn_grad as kbn
    from paddle_tpu_torch.kernels import conv1x1_bwd as k1

    def set_fused(on):
        flags.set_flags({"FLAGS_fused_conv1x1_bwd": on})

    progs = {}
    for config in ("C", "D"):
        with unique_name.guard():
            progs[config] = fused_build(config, RESNET)
    plans = {c: transformed_launches(
        p[0], RESNET_B, [p[3][0].name, p[3][1].name])
        for c, p in progs.items()}
    # (B7, B8) a step, and those inside conv2d_bn_act's grad
    per_step = {c: (sum(pl[0].values()), sum(pl[1].values()))
                for c, pl in plans.items()}
    inside = {c: pl[2] for c, pl in plans.items()}
    print("per step, from the transformed programs: config C %s (B7, B8), "
          "%s inside conv2d_bn_act_grad; config D %s, %s inside" % (
              per_step["C"], inside["C"], per_step["D"], inside["D"]))
    if (per_step, inside) != ({"C": (53, 0), "D": (0, 30)},
                              {"C": (49, 0), "D": (0, 26)}):
        raise AssertionError("configs C and D should launch 53 B7 (49 "
                             "fused) and 30 B8 (26 fused) a step")

    startup = progs["D"][1]
    startup.random_seed = seed
    scope0 = fluid.Scope()
    exe = fluid.Executor()                      # CUDAPlace(0)
    exe.run(startup, scope=scope0)

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
        "C": {"data": torch.from_numpy(np.ascontiguousarray(
            images.transpose(0, 2, 3, 1))).to(dev),
            "label": torch.from_numpy(labels).to(dev)},
        "D": {"data": torch.from_numpy(images).to(dev),
              "label": torch.from_numpy(labels).to(dev)}}

    # ---- C against D: same weights, same batch, first step ----
    block = progs["D"][0].global_block()
    grads = sorted(p.name + "@GRAD" for p in block.all_parameters())
    first = {}
    for config in ("C", "D"):
        prog, _, _, (loss, _) = progs[config]
        scope = clone(scope0)
        resnet_damp(prog, scope)
        set_fused(config == "D")
        try:
            first[config] = exe.run(prog, feed=feeds[config],
                                    fetch_list=[loss.name] + grads,
                                    scope=scope)
        finally:
            set_fused(False)
        del scope
    lc, ld = float(first["C"][0]), float(first["D"][0])
    print("C vs D on the card under AMP, same weights (residual branches "
          "damped x%g) and batch: first-step loss C %.7f D %.7f"
          % (RESNET_DAMP, lc, ld))
    if not all(str(g.dtype) == "float32" for g in first["C"][1:]):
        raise AssertionError("master gradients must be float32 under AMP")
    np.testing.assert_allclose(lc, ld, rtol=AMP_LTOL)
    check_grad_diff("C vs D at full width, %d gradients" % len(grads),
                    grad_diff(grads, first["C"][1:], first["D"][1:]),
                    None, AMP_L2TOL, AMP_PL2TOL)
    del first
    torch.cuda.empty_cache()

    # ---- train each config ----
    launches = {}
    for config, name in (("C", "bench"), ("D", "nchw+fused1x1+epilogue")):
        prog, _, _, (loss, acc) = progs[config]
        scope = clone(scope0)
        set_fused(config == "D")
        try:
            key = "bn_grad" if config == "C" else "conv1x1_bwd"
            launches[key + "_bf16"] = resnet_train(
                exe, prog, feeds[config], loss, acc, scope, clone(scope0),
                "%s (%s, bf16 AMP)" % (config, name),
                {"bn_grad": per_step[config][0] * TRAIN_STEPS,
                 "conv1x1_bwd": per_step[config][1] * TRAIN_STEPS},
                {"bn_grad": inside[config][0] * TRAIN_STEPS,
                 "conv1x1_bwd": inside[config][1] * TRAIN_STEPS},
                B7_KERNELS if config == "C" else B8_BF16_KERNELS)[key]
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
    for config in ("C", "D"):
        x = ximages if config == "D" else np.ascontiguousarray(
            ximages.transpose(0, 2, 3, 1))

        def build():
            prog, startup, fds, (loss, _) = fused_build(config,
                                                        RESNET_XCHECK)
            return prog, startup, fds, (loss,)

        set_fused(config == "D")
        kbn.reset_launches()
        k1.reset_launches()
        try:
            on_card[config] = cross_check(
                fluid, exe, build, seed, {"data": x, "label": xlabels},
                1, "config %s under AMP, %s, batch %d, residual branches "
                "damped x%g" % (config, RESNET_XCHECK, RESNET_XCHECK_B,
                                RESNET_DAMP),
                gtol=None, ltol=AMP_LTOL, l2tol=AMP_L2TOL,
                pl2tol=AMP_PL2TOL, edit=resnet_damp)
        finally:
            set_fused(False)
        print("cross-check launches on the card:",
              json.dumps({**kbn.launches, **k1.launches}))
        if (kbn.launches["bn_grad"], k1.launches["conv1x1_bwd"]) != \
                per_step[config]:
            raise AssertionError("cross-check launch counts")
    names = sorted(n for n in on_card["C"] if n != "loss")
    np.testing.assert_allclose(on_card["C"]["loss"], on_card["D"]["loss"],
                               rtol=AMP_LTOL)
    check_grad_diff("C vs D on the card at %s" % RESNET_XCHECK,
                    grad_diff(names, [on_card["C"][n] for n in names],
                              [on_card["D"][n] for n in names]),
                    None, AMP_L2TOL, AMP_PL2TOL)

    # ---- the other convnets, as bench.py runs them ----
    for name, kw in OTHER_MODELS:
        other_model(fluid, exe, name, kw, seed, dev, kbn, k1, set_fused)
    return launches


def other_model(fluid, exe, name, kw, seed, dev, kbn, k1, set_fused):
    """One of VGG-16, GoogLeNet, AlexNet and SmallNet at full width under
    bf16 AMP: OTHER_WARMUP + OTHER_STEPS steps on one repeated batch of
    uniform images (bench.py's fake data), exact launch counts from the
    transformed program, a finite loss that comes under the first
    counted one."""
    import importlib

    from paddle_tpu_torch import unique_name

    mod = importlib.import_module("paddle_tpu_torch.models." + kw["module"])
    nhwc = kw.get("passes") is not None
    with unique_name.guard():
        prog, startup, _, (loss, acc) = getattr(mod, kw["build"])(
            image_shape=kw["image"], class_dim=kw["classes"],
            **({"layout": "NHWC"} if nhwc else {}))
    fluid.amp.enable(prog)
    if nhwc:
        fluid.passes.enable(prog, **kw["passes"])
    b7, b8, _ = transformed_launches(prog, RESNET_B, [loss.name, acc.name])
    n_b7, n_b8 = sum(b7.values()), sum(b8.values()) if kw["flag"] else 0
    print("%s %s batch %d, bf16 AMP%s%s: %d B7 and %d B8 a step, from the "
          "transformed program" % (
              name, kw["image"], RESNET_B,
              ", passes %s" % kw["passes"] if nhwc else "",
              ", FLAGS_fused_conv1x1_bwd on" if kw["flag"] else "",
              n_b7, n_b8))
    if (n_b7, n_b8) != kw["want"]:
        raise AssertionError("%s launches a step %s != %s"
                             % (name, (n_b7, n_b8), kw["want"]))
    startup.random_seed = seed
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(seed)
    images = rng.rand(RESNET_B, *kw["image"]).astype(np.float32)
    if nhwc:
        images = np.ascontiguousarray(images.transpose(0, 2, 3, 1))
    feed = {"data": torch.from_numpy(images).to(dev),
            "label": torch.from_numpy(rng.randint(
                0, kw["classes"], (RESNET_B, 1)).astype(np.int64)).to(dev)}
    set_fused(kw["flag"])
    try:
        torch.cuda.reset_peak_memory_stats()
        for _ in range(OTHER_WARMUP):
            exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
        kbn.reset_launches()
        k1.reset_launches()
        t0 = time.perf_counter()
        losses = [float(exe.run(prog, feed=feed, fetch_list=[loss],
                                scope=scope)[0])
                  for _ in range(OTHER_STEPS)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = (kbn.launches["bn_grad"], k1.launches["conv1x1_bwd"])
        want = (n_b7 * OTHER_STEPS, n_b8 * OTHER_STEPS)
        print("%s: launches (bn_grad, conv1x1_bwd) %s expected %s"
              % (name, got, want))
        if got != want:
            raise AssertionError("%s launch counts" % name)
        print("losses:", " ".join("%.6f" % v for v in losses))
        settle(exe, prog, feed, loss, scope, losses, OTHER_SETTLE_STEPS)
        step_ms = wall * 1000.0 / OTHER_STEPS
        print("%s train: %d steps in %.3f s = %.3f ms/step, %.2f images/s; "
              "peak device memory %.2f GB" % (
                  name, OTHER_STEPS, wall, step_ms,
                  RESNET_B / (step_ms / 1e3),
                  torch.cuda.max_memory_allocated() / 1e9))
        if n_b7 or n_b8:
            device_profile(lambda: exe.run(prog, feed=feed,
                                           fetch_list=[loss], scope=scope),
                           1, step_ms, "%s step" % name,
                           share_of=B7_KERNELS if n_b7
                           else B8_BF16_KERNELS)
    finally:
        set_fused(False)
    del scope
    torch.cuda.empty_cache()


def same_bits(what, first, second):
    """Two runs of a kernel on the same inputs give the same bits."""
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError("%s: two runs differ" % what)


def check_b1_bf16(fa, g, dev):
    """B1 in bfloat16 at B1_BF16_CASES against its plain version walking
    the keys as the kernel the plan picks does (``fwd_plan``: O at one
    bfloat16 rounding, the log-sum-exp at ATOL/RTOL), against a float64
    softmax attention on the same bfloat16 values (O at one bfloat16
    rounding), and run twice to the same bits. Returns the largest error
    against the plain version."""
    worst = 0.0
    for b, h, sq, sk, d, causal, seg in B1_BF16_CASES:
        q = torch.randn(b, h, sq, d, generator=g).to(torch.bfloat16).to(dev)
        k, v = (torch.randn(b, h, sk, d, generator=g).to(torch.bfloat16)
                .to(dev) for _ in range(2))
        segs = None
        if seg:   # queries' ids = keys' (sq == sk)
            ids = torch.sort(torch.randint(0, 3, (b, sq), generator=g),
                             dim=1)[0].to(torch.int32).to(dev)
            segs = (ids, ids)
        pl = fa.fwd_plan(b, h, sq, sk, d)
        n0 = dict(fa.launches)
        ko, kl = fa.flash_attention(q, k, v, causal=causal,
                                    segment_ids=segs, return_lse=True)
        if fa.launches["flash_attention_bf16"] != \
                n0["flash_attention_bf16"] + 1 or \
                fa.launches["flash_attention"] != n0["flash_attention"]:
            raise AssertionError("a bfloat16 call must launch the "
                                 "bfloat16 kernel once: %s" % fa.launches)
        ro, rl = fa.flash_attention_reference(
            q, k, v, causal, None, segs, block_q=pl["walk_q"],
            block_k=pl["block_k"], key_split=pl["key_split"])
        what = "flash_attention_bf16 %s causal=%s seg=%s (%s)" % (
            (b, h, sq, sk, d), causal, seg, pl["loader"])
        same_bits(what, (ko, kl), fa.flash_attention(
            q, k, v, causal=causal, segment_ids=segs, return_lse=True))
        e = rel_close(what + " O", ko.float(), ro.to(torch.bfloat16).float(),
                      BF16_RTOL, BF16_AMAX)
        e = max(e, assert_close(what + " lse", kl, rl))
        # float64: softmax(q k^T scale + mask) v on the bfloat16 values
        sc = torch.einsum("bhqd,bhkd->bhqk", q.double(), k.double()) \
            * d ** -0.5
        ok = torch.ones(sq, sk, dtype=torch.bool, device=dev)
        if causal:
            ok = torch.arange(sq, device=dev)[:, None] >= \
                torch.arange(sk, device=dev)[None, :]
        ok = ok[None, None]
        if segs is not None:
            ok = ok & (segs[0][:, None, :, None] == segs[1][:, None, None, :])
        sc = torch.where(ok, sc, fa.DEFAULT_MASK_VALUE)
        truth = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(sc, -1),
                             v.double())
        e64 = rel_close(what + " O vs float64", ko.double(), truth,
                        BF16_RTOL, BF16_AMAX)
        print("%s: max abs err %.3g against the plain version, %.3g "
              "against float64" % (what, e, e64))
        worst = max(worst, e)
    torch.cuda.synchronize()
    return worst


def attention_launches(prog):
    """B1 launches a step, read from the program: one for every one-shot
    ``fused_attention`` op and one for every ``fused_attention_grad``
    (the generic grad re-runs the forward under autograd); plus one
    for every ``fused_attention`` inside a segment that the remat plan
    replays. Returns (forward, grad, replay)."""
    from paddle_tpu_torch import passes

    out, _ = passes.apply(prog)
    ops = out.global_block().ops
    fwd = sum(op.type == "fused_attention"
              and op.attrs.get("cache_mode") is None for op in ops)
    grad = sum(op.type == "fused_attention_grad" for op in ops)
    plan = getattr(out, "_remat_plan", None)
    replay = 0 if plan is None else sum(
        ops[i].type == "fused_attention" for seg in plan.segments
        for i in range(seg.start, seg.end))
    return fwd, grad, replay


def lm_feed(vocab, seq, batch, seed):
    """bench.py's transformer batch (bench.py:238-242): tokens, then
    targets, uniform ids from RandomState(seed)."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, vocab, (batch, seq)).astype(np.int64)
    tgts = rng.randint(0, vocab, (batch, seq)).astype(np.int64)
    return {"tokens": toks, "targets": tgts}


def transformer_phase(fluid, seed, dev):
    """The transformer LM trained as bench.py runs it: bf16 AMP at full
    width, 2 warmup and 10 counted steps on one repeated batch (exact
    bf16 B1 launches, no float32 B1), a profile, B1's backward share;
    the card against the CPU at a reduced size in float32 and under
    AMP. Returns the counted steps' B1 launches."""
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models.transformer import build_transformer_lm

    with unique_name.guard():
        prog, startup, _, (loss,) = build_transformer_lm(**LM)
    fluid.amp.enable(prog)
    fwd, grad, _ = attention_launches(prog)
    if (fwd, grad) != (LM["num_layers"], LM["num_layers"]):
        raise AssertionError("the program should hold %d fused_attention "
                             "and as many grads, not %d and %d"
                             % (LM["num_layers"], fwd, grad))
    startup.random_seed = seed
    scope = fluid.Scope()
    exe = fluid.Executor()                      # CUDAPlace(0)
    exe.run(startup, scope=scope)
    n_params = sum(p.numel() for n, p in scope.vars.items()
                   if prog.global_block().var(n).is_parameter)
    feed = {n: torch.from_numpy(a).to(dev) for n, a in lm_feed(
        LM["vocab_size"], LM["seq_len"], LM_B, seed).items()}
    tokens = LM_B * LM["seq_len"]
    print("parameters: %d (%.1f MB fp32 masters); batch %d x %d tokens; "
          "bf16 AMP; B1 a step from the program: %d forward + %d inside "
          "fused_attention_grad" % (n_params, n_params * 4 / 1e6, LM_B,
                                    LM["seq_len"], fwd, grad))
    for _ in range(WARMUP_STEPS):
        exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
    torch.cuda.synchronize()
    fa.reset_launches()
    losses = []
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        losses.append(float(exe.run(prog, feed=feed, fetch_list=[loss],
                                    scope=scope)[0]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.launches)
    want = {"flash_attention": 0,
            "flash_attention_bf16": (fwd + grad) * TRAIN_STEPS,
            "flash_decode": 0, "flash_decode_bf16": 0}
    print("launches on the main path:", json.dumps(launches), "expected",
          json.dumps(want))
    if launches != want:
        raise AssertionError("B1 launch counts %s != %s" % (launches, want))
    print("losses:", " ".join("%.6f" % v for v in losses))
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError("training loss not finite and falling: %s"
                             % losses)
    step_ms = wall * 1000.0 / TRAIN_STEPS
    print("transformer train (bf16 AMP): %d steps in %.3f s = %.3f ms/step, "
          "%.2f sequences/s, %.1f tokens/s" % (
              TRAIN_STEPS, wall, step_ms, LM_B / (step_ms / 1e3),
              tokens / (step_ms / 1e3)))
    device_profile(lambda: exe.run(prog, feed=feed, fetch_list=[loss],
                                   scope=scope),
                   1, step_ms, "transformer step (bf16 AMP)",
                   share_of=("flash_fwd_wgmma_kernel",
                             "flash_fwd_bf16_kernel"))
    # B1's backward (plain PyTorch) at the path's shape, a step's worth
    b, h, s, d = LM_B, LM["num_heads"], LM["seq_len"], \
        LM["d_model"] // LM["num_heads"]
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v, do = (torch.randn(b, h, s, d, generator=g).to(torch.bfloat16)
                   .to(dev) for _ in range(4))
    o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    bwd_ms = time_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do,
                                                    True), reps=10)
    fwd_ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=True))
    print("B1 a step: forward kernel %d x %.6f ms = %.3f ms, backward "
          "(flash_attention_bwd, plain PyTorch, bf16 in, float32 sums) "
          "%d x %.6f ms = %.3f ms = %.1f%% of the %.3f ms step" % (
              fwd + grad, fwd_ms, (fwd + grad) * fwd_ms, grad, bwd_ms,
              grad * bwd_ms, 100.0 * grad * bwd_ms / step_ms, step_ms))
    del scope, exe, feed, q, k, v, do, o, lse
    torch.cuda.empty_cache()

    # the card against the CPU at a reduced size, float32 and bf16 AMP
    xfeed = lm_feed(LM_XCHECK["vocab_size"], LM_XCHECK["seq_len"],
                    LM_XCHECK_B, seed + 1)
    for amp in (False, True):
        def build():
            built = build_transformer_lm(**LM_XCHECK)
            if amp:
                fluid.amp.enable(built[0])
            return built

        fa.reset_launches()
        cross_check(fluid, fluid.Executor(), build, seed, xfeed,
                    LM_XCHECK_STEPS, "%s, batch %d, %s" % (
                        LM_XCHECK, LM_XCHECK_B,
                        "bf16 AMP" if amp else "float32"),
                    **(dict(gtol=None, ltol=AMP_LTOL, l2tol=AMP_L2TOL,
                            pl2tol=AMP_PL2TOL) if amp else {}))
        key = "flash_attention_bf16" if amp else "flash_attention"
        if fa.launches[key] != 2 * LM_XCHECK["num_layers"] * LM_XCHECK_STEPS:
            raise AssertionError("cross-check launches %s" % fa.launches)
    return launches


def remat_phase(fluid, seed, dev):
    """bench.py's memory row on the card: the transformer at full width
    in float32 with attention dropout 0.1, remat off and "blocks", from
    the same weights on the same batch: equal losses and first-step
    gradients (bitwise, or else within B1's tolerance, said which), the
    peak allocated memory of each arm's counted steps (the "blocks" arm
    must be lower), the activation ledger, and the B1 launches of each
    (the replay re-runs each segment's attention)."""
    from paddle_tpu_torch import layers, passes, unique_name
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models.transformer import transformer_lm
    from paddle_tpu_torch.passes import remat as remat_lib

    def build():
        with unique_name.guard():
            prog, startup = fluid.Program(), fluid.Program()
            with fluid.program_guard(prog, startup):
                tokens = layers.data("tokens", [LM["seq_len"]],
                                     dtype="int64")
                targets = layers.data("targets", [LM["seq_len"]],
                                      dtype="int64")
                logits = transformer_lm(
                    tokens, LM["vocab_size"], d_model=LM["d_model"],
                    num_layers=LM["num_layers"], num_heads=LM["num_heads"],
                    max_len=max(LM["seq_len"], 2048), dropout_rate=0.1)
                loss = layers.mean(layers.softmax_with_cross_entropy(
                    logits, layers.unsqueeze(targets, [2])))
                fluid.optimizer.Adam(LM["lr"]).minimize(loss)
        return prog, startup, loss

    prog, startup, _ = build()
    startup.random_seed = seed
    scope0 = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope0)
    feed = {n: torch.from_numpy(a).to(dev) for n, a in lm_feed(
        LM["vocab_size"], LM["seq_len"], LM_B, seed).items()}
    off_ledger = remat_lib.activation_ledger(prog)
    arms = {}
    for policy in (None, "blocks"):
        prog, _, loss = build()
        if policy is not None:
            passes.enable(prog, remat=policy)
        grads = sorted(p.name + "@GRAD"
                       for p in prog.global_block().all_parameters())
        fwd, grad, replay = attention_launches(prog)
        scope = fluid.Scope()
        for n, t in scope0.vars.items():
            scope.set_var(n, t.clone())
        exe = fluid.Executor()
        torch.cuda.synchronize()
        first = exe.run(prog, feed=feed, fetch_list=[loss] + grads,
                        scope=scope)
        losses = [float(first[0])]
        for _ in range(MEM_WARMUP - 1):
            losses.append(float(exe.run(prog, feed=feed, fetch_list=[loss],
                                        scope=scope)[0]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        fa.reset_launches()
        t0 = time.perf_counter()
        for _ in range(MEM_STEPS):
            losses.append(float(exe.run(prog, feed=feed, fetch_list=[loss],
                                        scope=scope)[0]))
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1000.0 / MEM_STEPS
        peak = torch.cuda.max_memory_allocated(dev)
        want = (fwd + grad + replay) * MEM_STEPS
        if fa.launches["flash_attention"] != want:
            raise AssertionError("remat %s: B1 launches %s, expected %d"
                                 % (policy, fa.launches, want))
        plan = passes.apply(prog, protected=[loss.name])[0]
        ledger = remat_lib.activation_ledger(plan)
        arms[policy] = dict(losses=losses, grads=first[1:], peak=peak)
        print("remat %s: %.3f ms/step; peak allocated %d bytes (%.1f MB; "
              "%.1f MB held between steps); B1 a step %d forward + %d grad "
              "+ %d replayed; activation ledger stored %d, saved %d bytes "
              "a sample; losses %s" % (
                  policy, step_ms, peak, peak / 1e6, base / 1e6, fwd, grad,
                  replay, ledger[0], ledger[1],
                  " ".join("%.7f" % v for v in losses)))
        del scope, exe, first
        torch.cuda.empty_cache()
    off, on = arms[None], arms["blocks"]
    bitwise = off["losses"] == on["losses"] and all(
        np.array_equal(a, b) for a, b in zip(off["grads"], on["grads"]))
    if not bitwise:
        np.testing.assert_allclose(on["losses"], off["losses"], rtol=1e-5)
        names = ["g%d" % i for i in range(len(off["grads"]))]
        check_grad_diff("remat blocks vs off, first-step gradients",
                        grad_diff(names, on["grads"], off["grads"]),
                        1e-4, 1e-4)
    stored_off = off_ledger[0]
    print("remat: losses and first-step gradients %s; peak allocated off "
          "%.1f MB, blocks %.1f MB (%.1f%% lower); activation ledger off "
          "%d bytes a sample, blocks stores %d (%.1f%% less)" % (
              "bitwise equal" if bitwise else
              "equal within rtol 1e-5 (losses) and 1e-4 x max|g| "
              "(not bitwise)", off["peak"] / 1e6, on["peak"] / 1e6,
              100.0 * (1 - on["peak"] / off["peak"]), stored_off,
              ledger[0], 100.0 * (1 - ledger[0] / stored_off)))
    if not on["peak"] < off["peak"]:
        raise AssertionError("remat blocks peak %d not below off %d"
                             % (on["peak"], off["peak"]))


def all_launches():
    """Every kernel wrapper's launch count, by name."""
    from paddle_tpu_torch.core import graphs

    out = {}
    for counts in graphs.launch_counters():
        out.update(counts)
    return out


def reset_all_launches():
    from paddle_tpu_torch.core import graphs

    for counts in graphs.launch_counters():
        for n in counts:
            counts[n] = 0


def scope_state(scope):
    return {n: t.clone() for n, t in scope.vars.items()
            if isinstance(t, torch.Tensor)}


def chunk_of(feed, k):
    """One step's feed repeated over a [k, ...] chunk (the phases train
    on one repeated batch)."""
    from paddle_tpu_torch import PackedSeq

    return {n: PackedSeq(torch.stack([v.data] * k), torch.stack(
        [v.lengths] * k)) if isinstance(v, PackedSeq)
        else torch.stack([v] * k) for n, v in feed.items()}


def device_busy_ms(fn):
    """Device time (ms) of the kernels and copies one call of ``fn``
    runs, from torch.profiler, or None if it recorded no device event."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if str(e.device_type).endswith("CUDA")]
    return sum(us) / 1000.0 if us else None


def graph_path(fluid, label, built, feed, k, chunks, seed, want, bounds):
    """One training path through ``Executor.run_chunk`` on the card: from
    the same weights, ``k * chunks`` eager ``run()`` steps twice, and
    ``chunks`` chunks of ``k`` graph replays. Every loss and state tensor
    on which the two eager runs agree must be bitwise equal in the graph
    run; the tensors where they already differ (the library's
    reductions that are not run-to-run deterministic) are named and
    their updates held at ``bounds`` = (loss rtol, each update's relative
    L2, all together; PERF.md section 2). The kernels' launches through
    the graphs must equal ``want`` (a step's, from the program) times the
    steps. Then host ms/step and device busy ms/step, eager against
    graphs, over one warm chunk. Returns the numbers."""
    prog, startup, loss = built
    startup.random_seed = seed
    scope0 = fluid.Scope()
    fluid.Executor().run(startup, scope=scope0)
    init = scope_state(scope0)
    steps = k * chunks
    chunk = chunk_of(feed, k)

    def fresh():
        s = fluid.Scope()
        for n, t in init.items():
            s.set_var(n, t.clone())
        return s

    runs = []
    for _ in range(2):
        scope, exe = fresh(), fluid.Executor()
        exe._step = 1                  # the step after startup's
        reset_all_launches()
        losses = [exe.run(prog, feed=feed, fetch_list=[loss],
                          scope=scope)[0] for _ in range(steps)]
        torch.cuda.synchronize()
        runs.append((np.stack(losses), scope_state(scope),
                     all_launches()))
        del scope, exe
    scope, exe = fresh(), fluid.Executor()
    reset_all_launches()
    losses = []
    for c in range(chunks):
        losses.append(exe.run_chunk(prog, feed_chunk=chunk, k=k,
                                    fetch_list=[loss], scope=scope,
                                    step0=1 if c == 0 else None)[0])
    torch.cuda.synchronize()
    got = all_launches()
    graph_losses, graph_state = np.concatenate(losses), scope_state(scope)
    expect = {n: v * steps for n, v in want.items()}
    print("graphs %s: launches through the graphs %s; eager %s; from the "
          "program %s" % (label, json.dumps({n: v for n, v in got.items()
                                               if v}),
                          json.dumps({n: v for n, v in runs[0][2].items()
                                      if v}),
                          json.dumps(expect)))
    if got != runs[0][2] or {n: v for n, v in got.items() if v} != \
            {n: v for n, v in expect.items() if v}:
        raise AssertionError("%s: launch counts through the graphs" % label)

    (l1, s1, _), (l2, s2, _) = runs
    noisy = sorted(n for n in s1 if not torch.equal(s1[n], s2[n]))
    loss_noisy = not np.array_equal(l1, l2)
    differ = sorted(n for n in s1 if n not in noisy
                    and not torch.equal(s1[n], graph_state[n]))
    if set(graph_state) != set(s1) or differ:
        raise AssertionError("%s: graph replays differ from eager steps in "
                             "%s, on which two eager runs agree"
                             % (label, differ[:10]))
    if not loss_noisy and not np.array_equal(l1, graph_losses):
        raise AssertionError("%s: graph losses %s != eager %s"
                             % (label, graph_losses, l1))
    ltol, pl2tol, l2tol = bounds
    if loss_noisy:
        np.testing.assert_allclose(graph_losses, l1, rtol=ltol)
    if noisy:
        def upd(s):
            return [(s[n].double() - init[n].double()).cpu().numpy()
                    for n in noisy]
        check_grad_diff("%s: updates of the %d tensors two eager runs "
                        "already disagree on, graphs against eager"
                        % (label, len(noisy)),
                        grad_diff(noisy, upd(graph_state), upd(s1),
                                  AMP_CANCELS), None, l2tol, pl2tol)
        eager_d = grad_diff(noisy, upd(s2), upd(s1), AMP_CANCELS)
        print("%s: the same two eager runs against each other: worst "
              "update %.3g of its L2 norm, all together %.3g"
              % (label, eager_d["pl2"], eager_d["l2"]))
    print("graphs %s: K=%d x %d chunks; losses %s (%s); %d of %d state "
          "tensors bitwise equal to the eager steps'%s" % (
              label, k, chunks, "bitwise equal" if not loss_noisy else
              "within rtol %g (two eager runs differ)" % ltol,
              " ".join("%.6f" % v for v in graph_losses),
              len(s1) - len(noisy), len(s1),
              "; %d named, where two eager runs differ, held at the "
              "bounds: %s" % (len(noisy), ", ".join(noisy[:8])
                              + (" ..." if len(noisy) > 8 else ""))
              if noisy else ""))
    del runs, s1, s2, graph_state

    # one warm chunk, eager and with graphs
    def eager_chunk():
        for _ in range(k):
            exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)

    def graph_chunk():
        exe.run_chunk(prog, feed_chunk=chunk, k=k, fetch_list=[loss],
                      scope=scope)

    out = {}
    for name, fn in (("eager", eager_chunk), ("graphs", graph_chunk),
                     ("eager2", eager_chunk), ("graphs2", graph_chunk)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1000.0 / k
        out[name.rstrip("2")] = min(ms, out.get(name.rstrip("2"), ms))
    busy = {n: device_busy_ms(fn) for n, fn in (("eager", eager_chunk),
                                                ("graphs", graph_chunk))}
    print("graphs %s: host ms/step eager %.3f, graphs %.3f (%.2fx); device "
          "busy ms/step eager %s, graphs %s" % (
              label, out["eager"], out["graphs"],
              out["eager"] / out["graphs"],
              *("%.3f" % (busy[n] / k) if busy[n] is not None
                else "not measured (no device events)"
                for n in ("eager", "graphs"))))
    del scope, exe, chunk
    torch.cuda.empty_cache()
    return dict(host_eager=out["eager"], host_graphs=out["graphs"],
                busy_eager=None if busy["eager"] is None
                else busy["eager"] / k,
                busy_graphs=None if busy["graphs"] is None
                else busy["graphs"] / k, noisy=len(noisy))


def graphs_phase(fluid, seed, dev):
    """The training paths through ``Executor.run_chunk`` as replayed CUDA
    graphs (graph_path): the transformer as bench.py runs it (bf16 AMP,
    K=8, two chunks), ResNet-50 configs C and D under AMP, the AMP stacked
    LSTM and seq2seq, and bench.py's memory row (float32, attention
    dropout 0.1: a random draw every step)."""
    from paddle_tpu_torch import flags, layers, unique_name
    from paddle_tpu_torch.models.seq2seq import build_seq2seq
    from paddle_tpu_torch.models.stacked_lstm import build_stacked_lstm_train
    from paddle_tpu_torch.models.transformer import (build_transformer_lm,
                                                     transformer_lm)

    amp_bounds = (AMP_LTOL, AMP_PL2TOL, AMP_L2TOL)
    fp32_bounds = (1e-4, RESNET_AB_PL2TOL, RESNET_AB_L2TOL)
    res = {}

    # the transformer as bench.py trains it
    with unique_name.guard():
        prog, startup, _, (loss,) = build_transformer_lm(**LM)
    fluid.amp.enable(prog)
    fwd, grad, _ = attention_launches(prog)
    feed = {n: torch.from_numpy(a).to(dev) for n, a in lm_feed(
        LM["vocab_size"], LM["seq_len"], LM_B, seed).items()}
    res["transformer"] = graph_path(
        fluid, "transformer (bf16 AMP)", (prog, startup, loss), feed,
        GRAPH_K["transformer"], GRAPH_CHUNKS, seed,
        {"flash_attention_bf16": fwd + grad}, amp_bounds)

    # ResNet-50 configs C and D under AMP
    rng = np.random.RandomState(seed)
    images = rng.randn(RESNET_B, *RESNET["image_shape"]).astype(np.float32)
    labels = torch.from_numpy(rng.randint(
        0, RESNET["class_dim"], (RESNET_B, 1)).astype(np.int64)).to(dev)
    for config in ("C", "D"):
        with unique_name.guard():
            prog, startup, _, (loss, acc) = fused_build(config, RESNET)
        b7, b8, _ = transformed_launches(prog, RESNET_B, [loss.name])
        x = images if config == "D" else np.ascontiguousarray(
            images.transpose(0, 2, 3, 1))
        feed = {"data": torch.from_numpy(x).to(dev), "label": labels}
        flags.set_flags({"FLAGS_fused_conv1x1_bwd": config == "D"})
        try:
            res["resnet_" + config] = graph_path(
                fluid, "ResNet-50 config %s (bf16 AMP)" % config,
                (prog, startup, loss), feed, GRAPH_K["resnet"], GRAPH_CHUNKS,
                seed, {"bn_grad": sum(b7.values())} if config == "C"
                else {"conv1x1_bwd": sum(b8.values())}, amp_bounds)
        finally:
            flags.set_flags({"FLAGS_fused_conv1x1_bwd": False})

    # the AMP stacked LSTM and seq2seq, every row full length
    for model in ("lstm", "gru"):
        if model == "lstm":
            with unique_name.guard():
                prog, startup, _, (loss, _) = build_stacked_lstm_train(
                    class_dim=CLASSES, lr=LR, dict_dim=DICT, emb_dim=EMB,
                    hid_dim=HID, stacked_num=STACKED)
            B, T = LSTM_B, LSTM_T
            feed = {"words": rng.randint(0, DICT, (B, T, 1)),
                    "label": rng.randint(0, CLASSES, (B, 1))}
        else:
            with unique_name.guard():
                prog, startup, _, (loss,) = build_seq2seq(lr=LR, **S2S)
            B, T = S2S_B, S2S_T
            feed = {n: rng.randint(1, S2S["tgt_vocab"], (B, T, 1))
                    for n in ("src_ids", "tgt_ids", "tgt_next_ids")}
        fluid.amp.enable(prog)
        fwd, bwd = recurrent_launches(prog, model)
        on_card = {}
        for n, a in feed.items():
            t = torch.from_numpy(a.astype(np.int64)).to(dev)
            on_card[n] = fluid.PackedSeq(t, torch.full(
                (B,), T, dtype=torch.int32, device=dev)) if t.dim() == 3 \
                else t
        res[model] = graph_path(
            fluid, "%s (bf16 AMP)" % ("stacked LSTM" if model == "lstm"
                                      else "seq2seq"),
            (prog, startup, loss), on_card, GRAPH_K["rnn"], GRAPH_CHUNKS,
            seed, {model + "_fwd_bf16": fwd, model + "_bwd_bf16": bwd},
            amp_bounds)

    # a path that draws randomness: bench.py's memory row, float32 with
    # attention dropout 0.1 (remat off)
    with unique_name.guard():
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            tokens = layers.data("tokens", [LM["seq_len"]], dtype="int64")
            targets = layers.data("targets", [LM["seq_len"]], dtype="int64")
            logits = transformer_lm(
                tokens, LM["vocab_size"], d_model=LM["d_model"],
                num_layers=LM["num_layers"], num_heads=LM["num_heads"],
                max_len=max(LM["seq_len"], 2048), dropout_rate=0.1)
            loss = layers.mean(layers.softmax_with_cross_entropy(
                logits, layers.unsqueeze(targets, [2])))
            fluid.optimizer.Adam(LM["lr"]).minimize(loss)
    n_drop = sum(op.type == "dropout" for op in prog.global_block().ops)
    fwd, grad, _ = attention_launches(prog)
    feed = {n: torch.from_numpy(a).to(dev) for n, a in lm_feed(
        LM["vocab_size"], LM["seq_len"], LM_B, seed).items()}
    print("memory row: %d dropout ops a step, each a random stream the "
          "graph reseeds before every replay" % n_drop)
    if not n_drop:
        raise AssertionError("the memory row should draw dropout masks")
    res["dropout"] = graph_path(
        fluid, "memory row (float32, attention dropout 0.1)",
        (prog, startup, loss), feed, GRAPH_K["dropout"], GRAPH_CHUNKS,
        seed, {"flash_attention": fwd + grad}, fp32_bounds)
    return res


def expected_scales(cfg, skipped):
    """The loss scale after each step, by the guard's rule (halve on a
    skip, floor min_loss_scale; grow after growth_interval clean steps,
    cap max_loss_scale)."""
    scale, good, out = cfg.init_loss_scale, 0, []
    for skip in skipped:
        if skip:
            scale, good = max(scale * cfg.scale_backoff,
                              cfg.min_loss_scale), 0
        else:
            good += 1
            if good >= cfg.growth_interval:
                scale, good = min(scale * cfg.scale_growth,
                                  cfg.max_loss_scale), 0
        out.append(scale)
    return out


def guard_phase(fluid, seed, dev):
    """The transformer as bench.py trains it (bf16 AMP, K=8) under the
    step guard with dynamic loss scaling: ``amp.enable(prog, loss=...,
    dynamic_loss_scale=True, growth_interval=GUARD_GROWTH,
    divergence=False)``, three chunks of ``run_chunk``: clean, then with
    ``fault.inject("guard.nonfinite", crash_on_nth=11, times=2)``, then
    clean after ``fault.clear()``. Checks (a) the health rows: skipped
    exactly at steps 11 and 12, the scale halved twice there and grown by
    the rule elsewhere; (b) every state tensor but the guard's bitwise
    unchanged across each skipped step, the guard's moving by the rule;
    (c) the 24 replayed steps bitwise equal to 24 eager run() steps from
    the same weights with the same rule (a tensor on which two eager
    runs already differ is named and its update held at the AMP bounds);
    (d) the guard on without scaling and with no fault bitwise equal to
    the guard off, through the graphs; (e) 16 bf16 B1 launches every
    step, skipped or not. Then (f) host and device busy ms/step of a warm
    chunk through the graphs, guarded against unguarded: the guard's
    overhead."""
    from paddle_tpu_torch import fault, guard, unique_name
    from paddle_tpu_torch.models.transformer import build_transformer_lm

    def build(armed):
        with unique_name.guard():
            prog, startup, _, (loss,) = build_transformer_lm(**LM)
        if armed == "scaling":
            fluid.amp.enable(prog, loss=loss, dynamic_loss_scale=True,
                             growth_interval=GUARD_GROWTH, divergence=False)
        else:
            fluid.amp.enable(prog)
            if armed == "guard":
                guard.enable(prog, loss, divergence=False)
        return prog, startup, loss

    prog, startup, loss = build("scaling")
    fwd, grad, _ = attention_launches(prog)
    startup.random_seed = seed
    scope0 = fluid.Scope()
    fluid.Executor().run(startup, scope=scope0)
    init = scope_state(scope0)
    del scope0
    feed = {n: torch.from_numpy(a).to(dev) for n, a in lm_feed(
        LM["vocab_size"], LM["seq_len"], LM_B, seed).items()}
    k, chunks = GRAPH_K["transformer"], 3
    steps = k * chunks
    poison = (11, 12)

    def fresh():
        s_ = fluid.Scope()
        for n, t in init.items():
            s_.set_var(n, t.clone())
        return s_

    def armed_at(step):
        """The rule as the runs arm it: before chunk 2's first step,
        cleared before chunk 3's."""
        if step == k:
            fault.inject("guard.nonfinite", crash_on_nth=poison[0],
                         times=len(poison))
        elif step == 2 * k:
            fault.clear()

    # eager run() steps, twice, snapshotting around the skipped steps
    runs = []
    for rep in range(2):
        scope, exe = fresh(), fluid.Executor()
        exe._step = 0
        fault.clear()
        reset_all_launches()
        losses, rows, around = [], [], {}
        for i in range(steps):
            armed_at(i)
            losses.append(exe.run(prog, feed=feed, fetch_list=[loss],
                                  scope=scope)[0])
            rows.append(exe.last_health)
            if rep == 0 and i + 1 in (poison[0] - 1,) + poison:
                around[i + 1] = scope_state(scope)
        exe.poll_health()
        fault.clear()
        torch.cuda.synchronize()
        runs.append((np.stack(losses), scope_state(scope), all_launches(),
                     np.concatenate(rows), around))
        del scope, exe
    # the graph run: three chunks of K replays
    scope, exe = fresh(), fluid.Executor()
    chunk = chunk_of(feed, k)
    fault.clear()
    reset_all_launches()
    g_losses, g_rows = [], []
    for c in range(chunks):
        armed_at(c * k)
        g_losses.append(exe.run_chunk(prog, feed_chunk=chunk, k=k,
                                      fetch_list=[loss], scope=scope,
                                      step0=0 if c == 0 else None)[0])
        g_rows.append(exe.last_health)
    exe.poll_health()
    fault.clear()
    torch.cuda.synchronize()
    g_launch, g_state = all_launches(), scope_state(scope)
    g_losses, g_rows = np.concatenate(g_losses), np.concatenate(g_rows)
    cfg = prog.guard
    del scope, exe

    # (a) the health rows
    skipped = [i + 1 for i in range(steps) if g_rows[i, 2] > 0.5]
    want_scale = expected_scales(cfg, [i + 1 in poison
                                       for i in range(steps)])
    print("guard: health rows of the 24 replayed steps (loss, grad_norm, "
          "skipped, nonfinite_loss, nonfinite_grad, loss_scale): skipped at "
          "%s; loss scale %s; grad norms %s" % (
              skipped, " ".join("%g" % v for v in g_rows[:, 5]),
              " ".join("%.4g" % v for v in g_rows[:, 1])))
    if skipped != list(poison) or list(g_rows[:, 5]) != want_scale:
        raise AssertionError("(a) skipped %s (want %s), scales %s (want %s)"
                             % (skipped, list(poison), list(g_rows[:, 5]),
                                want_scale))
    if not (g_rows[[p - 1 for p in poison], 4] == 1).all() or \
            g_rows[:, 3].any() or not np.isfinite(np.delete(
                g_rows[:, :2], [p - 1 for p in poison], 0)).all():
        raise AssertionError("(a) non-finite flags %s" % g_rows[:, 3:5])
    # (b) across each skipped step
    around = runs[0][4]
    for p_ in poison:
        a, b = around[p_ - 1], around[p_]
        moved = sorted(n for n in a if not n.startswith("guard@")
                       and not torch.equal(a[n], b[n]))
        if moved:
            raise AssertionError("(b) step %d skipped but %s changed"
                                 % (p_, moved[:5]))
        if int(b["guard@skipped_steps"]) != int(a["guard@skipped_steps"]) + 1 \
                or float(b["guard@loss_scale"]) != \
                float(a["guard@loss_scale"]) * cfg.scale_backoff \
                or int(b["guard@good_steps"]) != 0:
            raise AssertionError("(b) the guard state across step %d" % p_)
    n_state = sum(not n.startswith("guard@") for n in around[poison[0]])
    print("guard: across each skipped step (11, 12) all %d state tensors "
          "but the guard's bitwise unchanged (parameters, Adam moments and "
          "beta powers); the skip counter +1, the scale halved, the clean "
          "streak 0" % n_state)
    # (c) graphs against eager, (e) launches
    (l1, s1, e_launch, e_rows, _), (l2, s2, _, _, _) = runs
    want = {"flash_attention_bf16": (fwd + grad) * steps}
    if {n: v for n, v in g_launch.items() if v} != want or \
            g_launch != e_launch:
        raise AssertionError("(e) launches through the graphs %s, eager %s,"
                             " want %s" % (g_launch, e_launch, want))
    noisy = sorted(n for n in s1 if not torch.equal(s1[n], s2[n]))
    loss_noisy = not np.array_equal(l1, l2)
    differ = sorted(n for n in s1 if n not in noisy
                    and not torch.equal(s1[n], g_state[n]))
    if set(g_state) != set(s1) or differ:
        raise AssertionError("(c) graph replays differ from eager steps in "
                             "%s, on which two eager runs agree" % differ[:10])
    if not loss_noisy and not np.array_equal(l1, g_losses):
        raise AssertionError("(c) graph losses %s != eager %s"
                             % (g_losses, l1))
    if not np.array_equal(e_rows[:, 2:], g_rows[:, 2:]):
        raise AssertionError("(c) health flags or scales differ: eager %s, "
                             "graphs %s" % (e_rows[:, 2:], g_rows[:, 2:]))
    if loss_noisy:
        np.testing.assert_allclose(g_losses, l1, rtol=AMP_LTOL)
    if noisy:
        def upd(s_):
            return [(s_[n].double() - init[n].double()).cpu().numpy()
                    if n in init else s_[n].double().cpu().numpy()
                    for n in noisy]
        check_grad_diff("guard: updates of the %d tensors two eager runs "
                        "already disagree on, graphs against eager"
                        % len(noisy), grad_diff(noisy, upd(g_state), upd(s1),
                                                AMP_CANCELS),
                        None, AMP_L2TOL, AMP_PL2TOL)
    print("guard (c): the 24 replayed steps' losses %s and %d of %d state "
          "tensors bitwise equal to the eager steps', health rows' flags "
          "and scales equal%s; (e) launches %s = %d bf16 B1 a step (%d "
          "forward + %d in fused_attention_grad), skipped or not" % (
              "bitwise equal" if not loss_noisy else
              "within rtol %g (two eager runs differ)" % AMP_LTOL,
              len(s1) - len(noisy), len(s1),
              "; %d named, where two eager runs differ, held at the AMP "
              "bounds: %s" % (len(noisy), ", ".join(noisy[:6])) if noisy
              else "", json.dumps(want), fwd + grad, fwd, grad))
    del runs, s1, s2, g_state, around

    # (d) guard on without scaling, no fault, against guard off; (f) the
    # guard's overhead with graphs
    res = {}
    chunk = chunk_of(feed, k)
    for armed in ("off", "guard", "scaling"):
        prog_, _, loss_ = build(armed)
        scope, exe = fresh(), fluid.Executor()
        first = exe.run_chunk(prog_, feed_chunk=chunk, k=k,
                              fetch_list=[loss_], scope=scope, step0=0)[0]
        exe.poll_health()
        state = {n: t for n, t in scope_state(scope).items()
                 if not n.startswith("guard@")}

        def run_one():
            exe.run_chunk(prog_, feed_chunk=chunk, k=k, fetch_list=[loss_],
                          scope=scope)
            exe.poll_health()

        host = []
        for _ in range(2):
            run_one()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_one()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1000.0 / k)
        busy = device_busy_ms(run_one)
        res[armed] = dict(losses=first, state=state, host=min(host),
                          busy=None if busy is None else busy / k)
        if armed != "guard":
            # where the guard's time goes: its select (one where a state
            # tensor), the gradients' concatenation and dot
            device_profile(run_one, 1, min(host) * k,
                           "guard (f) %s, one chunk of %d steps" % (armed, k),
                           share_of=("where", "CatArrayBatchedCopy", "dot"))
        del scope, exe
        torch.cuda.empty_cache()
    off, on = res["off"], res["guard"]
    differ = sorted(n for n in off["state"] if n not in noisy
                    and not torch.equal(off["state"][n], on["state"][n]))
    if set(off["state"]) != set(on["state"]) or differ or (
            not loss_noisy and not np.array_equal(off["losses"],
                                                  on["losses"])):
        raise AssertionError("(d) guard on (no scaling, no fault) differs "
                             "from guard off in %s" % differ[:10])
    print("guard (d): on without scaling and with no fault against off, 8 "
          "replayed steps from the same weights: losses %s, %d of %d state "
          "tensors bitwise equal%s" % (
              "bitwise equal" if np.array_equal(off["losses"], on["losses"])
              else "within the AMP bounds (two eager runs differ)",
              len(off["state"]) - len(noisy), len(off["state"]),
              " (the %d that differ between two eager runs excepted)"
              % len(noisy) if noisy else ""))

    def fmt(v):
        return "%.3f" % v if v is not None else "not measured"

    print("guard (f) overhead with graphs (transformer bf16 AMP, K=%d, one "
          "warm chunk, the better of two for host): host ms/step off %.3f, "
          "guard %.3f, guard + dynamic loss scale %.3f; device busy ms/step "
          "off %s, guard %s, guard + scale %s" % (
              k, res["off"]["host"], res["guard"]["host"],
              res["scaling"]["host"], fmt(res["off"]["busy"]),
              fmt(res["guard"]["busy"]), fmt(res["scaling"]["busy"])))
    return res


def forced_logits(engine, reqs):
    """Each request's logits rows as the engine computes them when fed
    ``tokens`` (teacher forcing): request r in slot r, its prefill's
    row, then one decode step a token; row i predicts tokens[i]."""
    cache = engine.new_cache()
    rows = []
    for r, (prompt, _) in enumerate(reqs):
        rows.append([engine.prefill(prompt, r, cache)])
    last = np.zeros(SLOTS, np.int64)
    for j in range(max(len(t) for _, t in reqs) - 1):
        live = [r for r, (_, t) in enumerate(reqs) if j < len(t) - 1]
        for r in live:
            last[r] = reqs[r][1][j]
        logits = engine.decode_step(last, cache)
        for r in live:
            rows[r].append(logits[r, 0])
            cache.pos[r] += 1
    return [np.stack(r) for r in rows]


def decode_bf16_phase(engine, loop_cls, engine_cls, scope, prefill, decode,
                      meta, workload, outs):
    """Decode serving from a bfloat16 KV cache at full width: the same
    weights and workload as the float32 phase through a
    ``DecodeEngine(cache_dtype="bfloat16")`` with its graphs, 8 bf16 B2
    launches a decode step (none float32), credited once per replay; the
    greedy tokens of 3 requests against the float32-cache engine's
    wherever that engine's top-two logit margin exceeds twice the
    largest logit difference between the two engines on those steps
    (teacher-forced: both fed the float32 engine's tokens); the same
    tokens with graphs and eagerly, ``compile_count()`` unchanged while
    the loop serves. Returns the main path's B2 bf16 launches."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    eng = engine_cls(prefill, decode, meta, num_slots=SLOTS,
                     prompt_buckets=BUCKETS, scope=scope,
                     cache_dtype="bfloat16")
    t0 = time.perf_counter()
    eng.warmup()
    warmup_s = time.perf_counter() - t0
    count = eng.compile_count()
    if count != len(BUCKETS) + 1:
        raise AssertionError("bf16 engine compile_count %d" % count)
    cache16, cache32 = eng.new_cache(), engine.new_cache()
    if cache16.dtype != torch.bfloat16 or \
            2 * cache16.nbytes() != cache32.nbytes():
        raise AssertionError("bf16 cache %s, %d bytes against %d" % (
            cache16.dtype, cache16.nbytes(), cache32.nbytes()))
    print("bf16 KV cache %.1f MB (float32 %.1f MB); warmup %.2f s; "
          "compile_count %d" % (cache16.nbytes() / 1e6,
                                cache32.nbytes() / 1e6, warmup_s, count))
    del cache16, cache32
    torch.cuda.synchronize()
    fa.reset_launches()
    loop = loop_cls(eng, max_queue=N_REQUESTS, name="chip-smoke-bf16")
    t0 = time.perf_counter()
    try:
        gens = [loop.submit(p, max_new_tokens=m) for p, m in workload]
        got = [gen.result(timeout=600) for gen in gens]
    finally:
        if not loop.close(timeout=120):
            raise RuntimeError("decode loop did not drain")
    wall = time.perf_counter() - t0
    launches = dict(fa.launches)
    steps = loop.steps_dispatched()
    toks = sum(len(o[0]) for o in got)
    want = {"flash_attention": N_LAYERS * N_REQUESTS,
            "flash_attention_bf16": 0, "flash_decode": 0,
            "flash_decode_bf16": N_LAYERS * steps}
    print("launches on the bf16-cache path:", json.dumps(launches),
          "expected", json.dumps(want))
    if launches != want:
        raise AssertionError("bf16-cache launch counts %s != %s"
                             % (launches, want))
    if eng.compile_count() != count or len(eng._graphs) != count:
        raise AssertionError("bf16 compile_count moved while the loop "
                             "served: %d -> %d" % (count, eng.compile_count()))
    for (t, reason), (p, m) in zip(got, workload):
        if reason != "length" or len(t) != m:
            raise AssertionError("bf16 request %s: %s after %d tokens"
                                 % (p.tolist(), reason, len(t)))
    gaps_ms = np.asarray([b_ - a_ for gen in gens for a_, b_ in zip(
        gen.token_times, gen.token_times[1:])]) * 1000.0
    ttft_ms = np.asarray([gen.token_times[0] - gen.submitted
                          for gen in gens]) * 1000.0
    print("decode bf16 cache: %d requests, %d tokens in %.3f s = %.2f "
          "tokens/s; %d steps (%.3f ms/step); per-token gap p50 %.3f ms "
          "p99 %.3f ms; time to first token p50 %.3f ms max %.3f ms" % (
              N_REQUESTS, toks, wall, toks / wall, steps,
              wall * 1000.0 / steps, float(np.percentile(gaps_ms, 50)),
              float(np.percentile(gaps_ms, 99)), float(np.median(ttft_ms)),
              float(ttft_ms.max())))

    # the greedy tokens against the float32-cache engine's
    reqs = [(p, t) for (t, _), (p, _m) in list(zip(outs, workload))[:3]]
    l32, l16 = forced_logits(engine, reqs), forced_logits(eng, reqs)
    diff = max(float(np.abs(a - b).max()) for a, b in zip(l32, l16))
    checked = ties = 0
    for (p, t), a, b, (t16, _) in zip(reqs, l32, l16, got):
        top2 = np.sort(a, -1)[:, -2:]
        margin = top2[:, 1] - top2[:, 0]
        clear = margin > 2 * diff
        if (np.argmax(b, -1) != np.asarray(t))[clear].any():
            raise AssertionError("bf16-cache argmax differs from the "
                                 "float32 engine's token where its margin "
                                 "exceeds 2 x %.3g" % diff)
        # the free-running bf16 loop: the same tokens up to the first
        # near-tie
        first = int(np.argmin(clear)) if not clear.all() else len(t)
        if list(t16[:first]) != list(t[:first]):
            raise AssertionError("bf16 loop tokens %s != float32 %s before "
                                 "the first near-tie at %d" % (
                                     t16[:first], t[:first], first))
        checked += int(clear.sum())
        ties += int((~clear).sum())
    print("bf16 cache against float32 cache, 3 requests teacher-forced: "
          "largest logit difference %.6g; argmax equal on all %d tokens "
          "whose float32 top-two margin exceeds %.6g (%d within it); the "
          "free-running loops' tokens equal up to the first such step" % (
              diff, checked, 2 * diff, ties))
    decode_graphs(eng, loop_cls, engine_cls, scope, prefill, decode, meta,
                  workload, cache_dtype="bfloat16")
    del eng
    torch.cuda.empty_cache()
    return launches["flash_decode_bf16"]


def decode_graphs(engine, loop_cls, engine_cls, scope, prefill, decode, meta,
                  workload, cache_dtype="float32"):
    """The decode engine with graphs (``engine``, warmed) against one
    that runs every entry eagerly on the card: the greedy tokens of 3
    requests identical, ``compile_count()`` unchanged after the loop
    served them, and the host ms of a decode step with and without
    graphs."""
    eager = engine_cls(prefill, decode, meta, num_slots=SLOTS,
                       prompt_buckets=BUCKETS, scope=scope,
                       cache_dtype=cache_dtype)
    eager._graphs = None               # every entry eager, on the card
    eager.warmup()
    count = engine.compile_count()
    toks = {}
    for name, eng in (("graphs", engine), ("eager", eager)):
        loop = loop_cls(eng, name="chip-smoke-" + name)
        try:
            gens = [loop.submit(p, max_new_tokens=m)
                    for p, m in workload[:3]]
            toks[name] = [g.result(timeout=600)[0] for g in gens]
        finally:
            if not loop.close(timeout=120):
                raise RuntimeError("decode loop did not drain")
    if toks["graphs"] != toks["eager"]:
        raise AssertionError("decode tokens with graphs %s != eager %s"
                             % (toks["graphs"], toks["eager"]))
    if engine.compile_count() != count or len(engine._graphs) != count:
        raise AssertionError("compile_count moved while the loop served: "
                             "%d -> %d" % (count, engine.compile_count()))
    ms = {}
    for name, eng in (("graphs", engine), ("eager", eager)):
        cache = eng.new_cache()
        cache.pos[:] = 160
        last = np.ones(SLOTS, np.int64)
        for _ in range(3):
            eng.decode_step(last, cache)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            eng.decode_step(last, cache)
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1000.0 / 20
        busy = device_busy_ms(lambda: eng.decode_step(last, cache))
        ms[name + "_busy"] = busy
    print("graphs decode (%s cache): tokens of 3 requests identical with "
          "graphs and eagerly (%d tokens); compile_count %d before and "
          "after; host "
          "ms a decode step at pos 160: eager %.3f, graphs %.3f (%.2fx); "
          "device busy ms eager %s, graphs %s" % (
              cache_dtype, sum(len(t) for t in toks["graphs"]), count,
              ms["eager"],
              ms["graphs"], ms["eager"] / ms["graphs"],
              *("%.3f" % ms[n + "_busy"] if ms[n + "_busy"] is not None
                else "not measured" for n in ("eager", "graphs"))))
    del eager
    return ms


def main():
    started = time.perf_counter()
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
    print("built %s in %.2f s (nvcc %s); each library's nvcc, all started "
          "together: %s" % (
              sorted(_build.SOURCES), time.perf_counter() - t0,
              " ".join(_build.NVCC_FLAGS), json.dumps(
                  {k: round(v, 2) for k, v in _build.build_seconds.items()})))
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
                same_bits(what, (ko, kl), fa.flash_attention(
                    q, k, v, causal=causal, segment_ids=segs,
                    return_lse=True))
                e = max(assert_close(what + " O", ko, ro),
                        assert_close(what + " lse", kl, rl))
                max_err["flash_attention"] = max(
                    max_err["flash_attention"], e)
    torch.cuda.synchronize()
    max_err["flash_attention_bf16"] = check_b1_bf16(fa, g, dev)
    max_err["flash_decode"] = check_decode(fa, g, dev)
    max_err["flash_decode_bf16"] = check_decode_bf16(fa, g, dev)
    lstm_err, dw_err = check_lstm(lc, g, dev)
    max_err.update(lstm_err)
    lstm_witness(lc, g, dev)
    gru_err, gru_dw_err = check_gru(gc, g, dev)
    max_err.update(gru_err)
    gru_witness(gc, g, dev)
    max_err.update(check_rnn_bf16(lc, gc, g, dev))
    max_err["bn_grad"] = check_bn_grad(kbn, g, dev)
    # B8 at every distinct shape the config-B program gives it
    with unique_name.guard():
        c1_path = transformed_launches(resnet_build("B", RESNET)[0],
                                       RESNET_B)[1]
    max_err["conv1x1_bwd"] = check_conv1x1(
        k1, g, dev, sorted(c1_path) + list(C1_EXTRA_SHAPES))
    c1_chunk_sweep(k1, _build, g, dev)
    # bench.py's configuration: B7 in bfloat16 at every distinct shape of
    # config C, B8's shapes in config D (both dtypes checked above)
    bn_bf16_shapes, c1_bf16_shapes = bench_path_shapes()
    print("config C: B7 at %d distinct shapes %s; config D: B8 at %d "
          "distinct shapes, the config-B set: %s" % (
              len(bn_bf16_shapes), sorted(bn_bf16_shapes),
              len(c1_bf16_shapes), set(c1_bf16_shapes) == set(c1_path)))
    if set(c1_bf16_shapes) != set(c1_path):
        raise AssertionError("config D's 1x1 shapes %s != config B's %s"
                             % (sorted(c1_bf16_shapes), sorted(c1_path)))
    max_err["bn_grad_bf16"] = check_bn_grad(
        kbn, g, dev, sorted(bn_bf16_shapes), (torch.bfloat16,))
    max_err["conv1x1_bwd_bf16"] = check_conv1x1(
        k1, g, dev, sorted(c1_bf16_shapes), (torch.bfloat16,))
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
            "flash_attention_bf16": 0, "flash_decode": N_LAYERS * steps,
            "flash_decode_bf16": 0}
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

    # ---- 4b. decode serving from a bfloat16 KV cache ----
    phase("decode serving from a bfloat16 KV cache at full width (seed %d)"
          % args.seed)
    launches["flash_decode_bf16"] = decode_bf16_phase(
        engine, DecodeLoop, DecodeEngine, scope, prefill, decode, meta,
        workload, outs)

    # ---- 5. the training slice at full width ----
    phase("stacked-LSTM training at full width (seed %d)" % args.seed)
    launches.update(train_phase(fluid, args.seed, dev))

    # ---- 6. the seq2seq training slice at full width ----
    phase("seq2seq training at full width (seed %d)" % args.seed)
    s2s_launches, s2s_scope = seq2seq_phase(fluid, args.seed, dev)
    launches.update(s2s_launches)

    # ---- 6b. the seq2seq beam-search decode at full width ----
    phase("seq2seq beam-search decode at full width: beam %d, max_len %d, "
          "%d sources of %d ids, from the trained scope (seed %d)"
          % (BEAM, BEAM_T, S2S_B, S2S_T, args.seed))
    t0 = time.perf_counter()
    launches["gru_fwd"] += beam_decode_phase(fluid, args.seed, dev,
                                             s2s_scope)["gru_fwd"]
    del s2s_scope
    print("beam decode phase: %.1f s" % (time.perf_counter() - t0))

    # ---- 6c. row-sparse embedding training at full width ----
    phase("row-sparse embedding training at full width: the "
          "word_embedding graph, dict %d, embedding %d, batch %d (seed %d)"
          % (W2V["dict_size"], W2V["emb"], W2V_B, args.seed))
    t0 = time.perf_counter()
    sparse_phase(fluid, args.seed, dev)
    print("row-sparse phase: %.1f s" % (time.perf_counter() - t0))

    # ---- 7. the convnet training slice at full width ----
    phase("ResNet-50 training at full width, configs A and B (seed %d)"
          % args.seed)
    resnet_launches, bn_shapes, c1_shapes = resnet_phase(fluid, args.seed,
                                                         dev)
    launches.update(resnet_launches)

    # ---- 8. bench.py's convnet configuration at full width ----
    phase("convnet benchmark configuration at full width: ResNet-50 "
          "configs C and D under bf16 AMP, VGG-16, GoogLeNet, AlexNet, "
          "SmallNet (seed %d)" % args.seed)
    launches.update(convnet_bench_phase(fluid, args.seed, dev))

    # ---- 9. the transformer LM as bench.py trains it, and remat ----
    phase("transformer LM training as bench.py runs it: full width under "
          "bf16 AMP, the card against the CPU in float32 and AMP (seed %d)"
          % args.seed)
    launches["flash_attention_bf16"] = transformer_phase(
        fluid, args.seed, dev)["flash_attention_bf16"]
    phase("remat at the memory row's width: float32, attention dropout "
          "0.1, off against \"blocks\" (seed %d)" % args.seed)
    remat_phase(fluid, args.seed, dev)

    # ---- 9b. the stacked LSTM and seq2seq as bench.py trains them ----
    for model, label in (("lstm", "stacked-LSTM"), ("gru", "seq2seq")):
        phase("%s training as bench.py runs it: full width under bf16 AMP, "
              "every row full length, the card against the CPU under AMP "
              "(seed %d)" % (label, args.seed))
        amp_launches = rnn_amp_phase(fluid, args.seed, dev, model)
        launches.update({k: v for k, v in amp_launches.items()
                         if k.endswith("_bf16")})

    # ---- 9c. K steps a call as replayed CUDA graphs ----
    phase("graphs: Executor.run_chunk replays against eager run() steps "
          "(bitwise, launches exact), the decode engine's graphs against "
          "eager entries (seed %d)" % args.seed)
    decode_graphs(engine, DecodeLoop, DecodeEngine, scope, prefill, decode,
                  meta, workload)
    graphs_phase(fluid, args.seed, dev)

    # ---- 9d. AMP training under the step guard ----
    phase("the transformer as bench.py trains it under the step guard with "
          "dynamic loss scaling (bf16 AMP, K=%d, guard.nonfinite at steps "
          "11 and 12; seed %d)" % (GRAPH_K["transformer"], args.seed))
    guard_phase(fluid, args.seed, dev)

    # ---- 10. times ----
    phase("times (CUDA events, median of 25 runs after warmup; 10 runs for "
          "bn_grad and conv1x1_bwd)")
    flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    flush_sum = torch.empty((), device=dev)

    def flush():
        flush_buf.zero_()

    def clean_flush():
        # the L2 flushed by a read: clean lines, which the kernel's reads
        # need not write back first (as most of the decode step's are)
        torch.sum(flush_buf, dim=0, out=flush_sum)

    rows = []
    kv_shape = (SLOTS, N_HEADS, MAX_LEN, D_MODEL // N_HEADS)
    kc, vc = randn(*kv_shape), randn(*kv_shape)
    q1 = randn(SLOTS, N_HEADS, 1, kv_shape[3])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print("flash_decode launch plan at %s: %s" % (
        list(kv_shape), json.dumps(fa.decode_plan(*kv_shape, sms))))
    for L in (MAX_LEN, 160):
        lens = torch.full((SLOTS,), L, dtype=torch.int32, device=dev)
        mask = (torch.arange(MAX_LEN, device=dev)[None, :]
                < lens[:, None])[:, None, None, :]
        kp, vp = kc[:, :, :L], vc[:, :, :L]
        bh, dh = SLOTS * N_HEADS, kv_shape[3]
        print("time flash_decode [16,8,512,64] cache_len=%d with the L2 "
              "flushed by a read: kernel_ms %.6f library_ms %.6f (SDPA "
              "over the valid prefix)" % (
                  L, time_ms(lambda: fa.flash_decode(q1, kc, vc, lens),
                             flush=clean_flush),
                  time_ms(lambda: F.scaled_dot_product_attention(q1, kp, vp),
                          flush=clean_flush)))
        rows.append(dict(
            name="flash_decode", shape="[16,8,512,64] cache_len=%d" % L,
            ms=time_ms(lambda: fa.flash_decode(q1, kc, vc, lens), flush=flush),
            plain_ms=time_ms(lambda: fa.flash_decode_reference(
                q1, kc, vc, lens), flush=flush),
            # every row's length is L here: SDPA over the valid prefix,
            # unmasked, computes the same function
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q1, kp, vp), flush=flush),
            library="torch.nn.functional.scaled_dot_product_attention "
                    "over the valid prefix kc[:, :, :%d], no mask; the "
                    "masked call over all %d positions (attn_mask of the "
                    "lengths, any lengths) %.6f ms" % (
                        L, MAX_LEN, time_ms(
                            lambda: F.scaled_dot_product_attention(
                                q1, kc, vc, attn_mask=mask), flush=flush)),
            bytes=4 * (2 * bh * dh + 2 * bh * L * dh + SLOTS),
            flops=4 * bh * L * dh))
    # B2 over bfloat16 caches (the bf16-cache decode path): K and V 2
    # bytes an element, q and the output 4; beside SDPA in bfloat16 over
    # the valid prefix (a bfloat16 q and output, where B2 takes and
    # gives float32)
    kb, vb = kc.to(torch.bfloat16), vc.to(torch.bfloat16)
    q1b = q1.to(torch.bfloat16)
    print("flash_decode bf16 launch plan at %s: %s" % (
        list(kv_shape), json.dumps(fa.decode_plan(*kv_shape, sms, 2))))
    for L in (MAX_LEN, 160):
        lens = torch.full((SLOTS,), L, dtype=torch.int32, device=dev)
        kp, vp = kb[:, :, :L], vb[:, :, :L]
        bh, dh = SLOTS * N_HEADS, kv_shape[3]
        print("time flash_decode_bf16 [16,8,512,64] cache_len=%d with the "
              "L2 flushed by a read: kernel_ms %.6f library_ms %.6f (SDPA "
              "bf16 over the valid prefix)" % (
                  L, time_ms(lambda: fa.flash_decode(q1, kb, vb, lens),
                             flush=clean_flush),
                  time_ms(lambda: F.scaled_dot_product_attention(
                      q1b, kp, vp), flush=clean_flush)))
        rows.append(dict(
            name="flash_decode_bf16",
            shape="[16,8,512,64] cache_len=%d" % L,
            ms=time_ms(lambda: fa.flash_decode(q1, kb, vb, lens),
                       flush=flush),
            plain_ms=time_ms(lambda: fa.flash_decode_reference(
                q1, kb, vb, lens), flush=flush),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q1b, kp, vp), flush=flush),
            library="torch.nn.functional.scaled_dot_product_attention in "
                    "bfloat16 over the valid prefix kb[:, :, :%d], no mask: "
                    "q and the output bfloat16 where B2 takes and gives "
                    "float32" % L,
            bytes=2 * 2 * bh * L * dh + 4 * (2 * bh * dh + SLOTS),
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
    # B1 in bfloat16 at the transformer training path's shape, beside
    # SDPA in bfloat16 (its flash kernel): q, k, v, o 2 bytes an
    # element, lse 4, the products at the bfloat16 tensor-core rate
    b, s, d = LM_B, LM["seq_len"], LM["d_model"] // LM["num_heads"]
    q, k, v = (randn(b, N_HEADS, s, d).to(torch.bfloat16) for _ in range(3))
    rows.append(dict(
        name="flash_attention_bf16",
        shape="[%d,8,%d,%d] causal=True" % (b, s, d),
        ms=time_ms(lambda: fa.flash_attention(q, k, v, causal=True)),
        plain_ms=time_ms(lambda: fa.flash_attention_reference(
            q, k, v, True), reps=5),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True)),
        library="torch.nn.functional.scaled_dot_product_attention, "
                "bfloat16, causal",
        bytes=2 * 4 * b * N_HEADS * s * d + 4 * b * N_HEADS * s,
        flops=4 * b * N_HEADS * (s * (s + 1) // 2) * d,
        peak=BF16_FLOPS_PER_S))
    # B3 and B4 at the training path's shape, every step valid, and at
    # T = 8: (t80 - t8) / 72 is a step's cost without the launch and the
    # blocks' set-up; in float32 and in bfloat16 (the AMP path's shape is
    # the same)
    bf16 = torch.bfloat16
    B, T, H = LSTM_B, LSTM_T, HID
    lstm_t, lstm_in = {}, {}
    for dt, sfx in ((torch.float32, ""), (bf16, "_bf16")):
        for T_ in (LSTM_SHORT_T, T):
            xg, w, h0, c0, mask, p, dhs, dcs = lstm_inputs(
                B, T_, H, True, g, dev, ragged=False)
            xg, w, dhs, dcs = (t.to(dt) for t in (xg, w, dhs, dcs))
            _, cs, stash = lc.lstm_forward(xg, w, h0, c0, mask, p)
            lstm_t["lstm_fwd" + sfx, T_] = time_ms(
                lambda: lc.lstm_forward(xg, w, h0, c0, mask, p))
            lstm_t["lstm_bwd" + sfx, T_] = time_ms(
                lambda: lc.lstm_backward(stash, cs, w, p, c0, mask, dhs,
                                         dcs))
        lstm_in[dt] = (xg, w, h0, c0, mask, p, dhs, dcs, cs, stash)
        for kind in ("lstm_fwd", "lstm_bwd"):
            name = kind + sfx
            if lc.cluster_plan(B, H, dt)["take"]:
                pl = lc.card_cluster_plan(kind, B, H, dev)
                how = ("one cluster of %d blocks per row group of %d rows "
                       "(%d row groups, %d clusters at once); exchange "
                       "through distributed shared memory" % (
                           pl["blocks"], pl["rows"], pl["row_groups"],
                           pl["clusters_at_once"]))
            else:
                pl = lc.launch_plan(kind, B, H, dev, dt)
                how = ("cluster size %d, %d blocks, %d row groups of 32 in "
                       "flight; exchange through L2 %d bytes a step" % (
                           pl["cluster"], pl["blocks"], pl["rows_in_flight"],
                           pl["exchange_bytes"]))
            print("%s at [%d,%d,%d]: %.6f ms, at T=%d %.6f ms: %.3f us a "
                  "step; %s" % (
                      name, B, T, H, lstm_t[name, T], LSTM_SHORT_T,
                      lstm_t[name, LSTM_SHORT_T],
                      (lstm_t[name, T] - lstm_t[name, LSTM_SHORT_T]) * 1e3
                      / (T - LSTM_SHORT_T), how))
    xg, w, h0, c0, mask, p, dhs, dcs, cs, stash = lstm_in[torch.float32]
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
        ms=lstm_t["lstm_fwd", T],
        plain_ms=time_ms(lambda: lc.lstm_forward_reference(
            xg, w, h0, c0, mask, p)),
        library_ms=time_ms(cudnn_fwd),
        library="torch.nn.LSTM (cuDNN) forward, input size 512, no "
                "peepholes: also does the input GEMM",
        bytes=4 * (2 * B * T * 4 * H + H * 4 * H + 3 * H + 2 * B * H
                   + B * T + 2 * B * T * H),
        flops=2 * B * T * H * 4 * H, tf32x3=True))
    rows.append(dict(
        name="lstm_bwd", shape="[64,80,512] peep, all steps valid",
        ms=lstm_t["lstm_bwd", T],
        plain_ms=time_ms(lambda: lc.lstm_backward_reference(
            stash, cs, w, p, c0, mask, dhs, dcs)),
        library_ms=time_ms(cudnn_fwd_bwd),
        library="torch.nn.LSTM (cuDNN) forward plus backward, input size "
                "512, no peepholes: also does the input GEMMs and dW",
        bytes=4 * (2 * B * T * 4 * H + 3 * B * T * H + H * 4 * H + 2 * 3 * H
                   + 3 * B * H + B * T),
        flops=2 * B * T * 4 * H * H, tf32x3=True))
    # B5 and B6 at the seq2seq path's shape, every step valid, and at
    # T = GRU_SHORT_T: (t30 - t3) / 27 is a step's cost without the
    # launch and the blocks' set-up
    B, T, H = S2S_B, S2S_T, S2S["hidden_dim"]
    gru_t, gru_in = {}, {}
    for dt, sfx in ((torch.float32, ""), (bf16, "_bf16")):
        for T_ in (GRU_SHORT_T, T):
            xg, w, h0, mask, dhs = gru_inputs(B, T_, H, g, dev, ragged=False)
            xg, w, dhs = (t.to(dt) for t in (xg, w, dhs))
            hs, stash = gc.gru_forward(xg, w, h0, mask)
            gru_t["gru_fwd" + sfx, T_] = time_ms(
                lambda: gc.gru_forward(xg, w, h0, mask))
            gru_t["gru_bwd" + sfx, T_] = time_ms(
                lambda: gc.gru_backward(stash, hs, w, h0, mask, dhs))
        gru_in[dt] = (xg, w, h0, mask, dhs, hs, stash)
        for kind in ("gru_fwd", "gru_bwd"):
            if gc.cluster_plan(B, H, dt)["take"]:
                pl = gc.card_cluster_plan(kind, B, H, dev)
                how = ("one cluster of %d blocks per row group of %d rows "
                       "(%d row groups, %d clusters at once); both "
                       "exchanges through distributed shared memory; the "
                       "card's plan %s" % (
                           pl["blocks"], pl["rows"], pl["row_groups"],
                           pl["clusters_at_once"], json.dumps(pl)))
            else:
                pl, card_pl = (gc.launch_plan(kind, B, H, sms, dt),
                               gc.card_plan(kind, B, H, dev, dt))
                if card_pl != {k: pl[k] for k in card_pl}:
                    raise AssertionError("%s launch_plan %s != the kernel's "
                                         "%s" % (kind, pl, card_pl))
                how = ("launch plan %s (the card's gru_plan agrees)"
                       % json.dumps(pl))
            name = kind + sfx
            print("%s at [%d,%d,%d]: %.6f ms, %.3f us a step (time / T); at "
                  "T=%d %.6f ms: %.3f us a step ((t%d - t%d) / %d); %s" % (
                      name, B, T, H, gru_t[name, T], gru_t[name, T] * 1e3 / T,
                      GRU_SHORT_T, gru_t[name, GRU_SHORT_T],
                      (gru_t[name, T] - gru_t[name, GRU_SHORT_T]) * 1e3
                      / (T - GRU_SHORT_T), T, GRU_SHORT_T, T - GRU_SHORT_T,
                      how))
    xg, w, h0, mask, dhs, hs, stash = gru_in[torch.float32]
    cudnn_gru = torch.nn.GRU(H, H, batch_first=True).to(dev)
    x_gru = torch.randn(B, T, H, generator=g).to(dev)
    g_gru = torch.randn(B, T, H, generator=g).to(dev)

    def cudnn_gru_fwd():
        with torch.no_grad():
            cudnn_gru(x_gru)

    def cudnn_gru_fwd_bwd():
        out, _ = cudnn_gru(x_gru)
        out.backward(g_gru)

    # the backward alone: the parameters frozen, one forward kept, and
    # the gradient to the input only
    frozen_gru = torch.nn.GRU(H, H, batch_first=True).to(dev)
    frozen_gru.requires_grad_(False)
    x_leaf = x_gru.clone().requires_grad_()
    out_kept, _ = frozen_gru(x_leaf)

    def cudnn_gru_bwd_data():
        torch.autograd.grad(out_kept, x_leaf, g_gru, retain_graph=True)

    rows.append(dict(
        name="gru_fwd", shape="[64,30,512], all steps valid",
        ms=gru_t["gru_fwd", T],
        plain_ms=time_ms(lambda: gc.gru_forward_reference(xg, w, h0, mask)),
        library_ms=time_ms(cudnn_gru_fwd),
        library="torch.nn.GRU (cuDNN) forward, input size 512: applies r "
                "after the product (r * (h W_hn)) where Paddle takes "
                "(r * h) W_c, and also does the input GEMM",
        bytes=4 * (2 * B * T * 3 * H + H * 3 * H + B * H + B * T
                   + B * T * H),
        flops=2 * B * T * H * 3 * H, tf32x3=True))
    rows.append(dict(
        name="gru_bwd", shape="[64,30,512], all steps valid",
        ms=gru_t["gru_bwd", T],
        plain_ms=time_ms(lambda: gc.gru_backward_reference(
            stash, hs, w, h0, mask, dhs)),
        library_ms=time_ms(cudnn_gru_bwd_data),
        library="cuDNN GRU backward-data, r after the product, includes dx "
                "of the input GEMM (torch.nn.GRU, input size 512, its "
                "parameters frozen, one forward kept, torch.autograd.grad "
                "to the input); cuDNN GRU forward plus backward, with the "
                "input GEMMs and dW, %.6f ms" % time_ms(cudnn_gru_fwd_bwd),
        bytes=4 * (2 * B * T * 3 * H + 2 * B * T * H + H * 3 * H
                   + 2 * B * H + B * T),
        flops=2 * B * T * 3 * H * H, tf32x3=True))
    # B3-B6 in bfloat16 at the AMP paths' shapes, every step valid: xg,
    # w, hs, the stash, dhs, dcs and dxg 2 bytes an element, h0, c0,
    # mask, peep, cs, dh0, dc0 and dpeep 4; the products at the bfloat16
    # tensor-core rate; beside cuDNN's LSTM and GRU in bfloat16 (float16
    # where this torch's cuDNN refuses bfloat16)
    def cudnn_rnn(cls, H_):
        for dt in (bf16, torch.float16):
            rnn = cls(H_, H_, batch_first=True).to(dev, dt)
            x = torch.randn(B, T, H_, generator=g).to(dev, dt)
            try:
                rnn(x)
                return rnn, x, dt
            except RuntimeError as e:
                print("cuDNN %s refuses %s: %s" % (cls.__name__, dt, e))
        raise AssertionError("cuDNN %s takes neither bf16 nor fp16"
                             % cls.__name__)

    B, T, H = LSTM_B, LSTM_T, HID
    xg, w, h0, c0, mask, p, dhs, dcs, cs, stash = lstm_in[bf16]
    lib_lstm, x_lib, lib_dt = cudnn_rnn(torch.nn.LSTM, H)
    g_lib = torch.randn(B, T, H, generator=g).to(dev, lib_dt)

    def cudnn_bf16_fwd():
        with torch.no_grad():
            lib_lstm(x_lib)

    def cudnn_bf16_fwd_bwd():
        out, _ = lib_lstm(x_lib)
        out.backward(g_lib)

    rows.append(dict(
        name="lstm_fwd_bf16", shape="[64,80,512] peep, all steps valid",
        ms=lstm_t["lstm_fwd_bf16", T],
        plain_ms=time_ms(lambda: lc.lstm_forward_reference(
            xg, w, h0, c0, mask, p)),
        library_ms=time_ms(cudnn_bf16_fwd),
        library="torch.nn.LSTM (cuDNN) forward in %s, input size 512, no "
                "peepholes: also does the input GEMM" % lib_dt,
        bytes=2 * (2 * B * T * 4 * H + H * 4 * H + B * T * H)
        + 4 * (3 * H + 2 * B * H + B * T + B * T * H),
        flops=2 * B * T * H * 4 * H, peak=BF16_FLOPS_PER_S))
    rows.append(dict(
        name="lstm_bwd_bf16", shape="[64,80,512] peep, all steps valid",
        ms=lstm_t["lstm_bwd_bf16", T],
        plain_ms=time_ms(lambda: lc.lstm_backward_reference(
            stash, cs, w, p, c0, mask, dhs, dcs)),
        library_ms=time_ms(cudnn_bf16_fwd_bwd),
        library="torch.nn.LSTM (cuDNN) forward plus backward in %s, input "
                "size 512, no peepholes: also does the input GEMMs and dW"
                % lib_dt,
        bytes=2 * (2 * B * T * 4 * H + H * 4 * H + 2 * B * T * H)
        + 4 * (B * T * H + 2 * 3 * H + 3 * B * H + B * T),
        flops=2 * B * T * 4 * H * H, peak=BF16_FLOPS_PER_S))
    B, T, H = S2S_B, S2S_T, S2S["hidden_dim"]
    xg, w, h0, mask, dhs, hs, stash = gru_in[bf16]
    lib_gru, xg_lib, gdt = cudnn_rnn(torch.nn.GRU, H)
    gg_lib = torch.randn(B, T, H, generator=g).to(dev, gdt)
    frozen_bf16 = torch.nn.GRU(H, H, batch_first=True).to(dev, gdt)
    frozen_bf16.requires_grad_(False)
    xl_bf16 = xg_lib.clone().requires_grad_()
    kept_bf16, _ = frozen_bf16(xl_bf16)

    def cudnn_gru_bf16_fwd():
        with torch.no_grad():
            lib_gru(xg_lib)

    def cudnn_gru_bf16_fwd_bwd():
        out, _ = lib_gru(xg_lib)
        out.backward(gg_lib)

    rows.append(dict(
        name="gru_fwd_bf16", shape="[64,30,512], all steps valid",
        ms=gru_t["gru_fwd_bf16", T],
        plain_ms=time_ms(lambda: gc.gru_forward_reference(xg, w, h0, mask)),
        library_ms=time_ms(cudnn_gru_bf16_fwd),
        library="torch.nn.GRU (cuDNN) forward in %s, input size 512: r "
                "after the product, and the input GEMM too" % gdt,
        bytes=2 * (2 * B * T * 3 * H + H * 3 * H + B * T * H)
        + 4 * (B * H + B * T),
        flops=2 * B * T * H * 3 * H, peak=BF16_FLOPS_PER_S))
    rows.append(dict(
        name="gru_bwd_bf16", shape="[64,30,512], all steps valid",
        ms=gru_t["gru_bwd_bf16", T],
        plain_ms=time_ms(lambda: gc.gru_backward_reference(
            stash, hs, w, h0, mask, dhs)),
        library_ms=time_ms(lambda: torch.autograd.grad(
            kept_bf16, xl_bf16, gg_lib, retain_graph=True)),
        library="cuDNN GRU backward-data in %s, r after the product, "
                "includes dx of the input GEMM (parameters frozen, one "
                "forward kept); cuDNN GRU forward plus backward, with the "
                "input GEMMs and dW, %.6f ms" % (
                    gdt, time_ms(cudnn_gru_bf16_fwd_bwd)),
        bytes=2 * (2 * B * T * 3 * H + 2 * B * T * H + H * 3 * H)
        + 4 * (2 * B * H + B * T),
        flops=2 * B * T * 3 * H * H, peak=BF16_FLOPS_PER_S))
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
            bytes=4 * (3 * x.numel() + 3 * c), flops=12 * x.numel(),
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

    # B7 and B8 in bfloat16 on bench.py's path: B7 at every distinct
    # shape of config C (beside F.batch_norm forward + autograd in
    # bfloat16, channels last), B8 at every distinct shape of config D
    # (beside cuDNN's bfloat16 convolution backward); a bfloat16 element
    # is 2 bytes, and B8's products bound at the bfloat16 tensor-core
    # rate (its one-pass TF32 floor printed beside: a bfloat16 value is
    # exact in TF32, which is what B8 multiplies in)

    def bn_bf16_case(shape):
        n, h, w, c = shape
        x = (torch.randn(*shape, generator=g) * 1.5 + 0.7).to(bf16).to(dev)
        dy = torch.randn(*shape, generator=g).to(bf16).to(dev)
        sc = (torch.rand(c, generator=g) + 0.5).to(dev)
        xr = x.permute(0, 3, 1, 2).requires_grad_()
        dyr = dy.permute(0, 3, 1, 2)

        def library():
            y = F.batch_norm(xr, None, None, sc, None, True, 0.1, 1e-5)
            torch.autograd.grad(y, xr, dyr)

        return dict(
            name="bn_grad_bf16", shape="%s x%d a config-C step" % (
                list(shape), bn_bf16_shapes[shape]),
            ms=time_ms(lambda: kbn.bn_grad(x, dy, sc, 1e-5), reps=10),
            plain_ms=time_ms(lambda: kbn.bn_grad_reference(x, dy, sc, 1e-5),
                             reps=10),
            library_ms=time_ms(library, reps=10),
            library="torch.nn.functional.batch_norm forward plus "
                    "torch.autograd.grad to x, bfloat16, channels last: "
                    "also runs the forward, gives no dscale or dbias",
            bytes=2 * 3 * x.numel() + 4 * 3 * c, flops=12 * x.numel(),
            per_step=bn_bf16_shapes[shape])

    def c1_bf16_case(shape):
        b, ci, h, w, co = shape
        x = torch.randn(b, ci, h, w, generator=g).to(bf16).to(dev)
        wt = (torch.randn(co, ci, 1, 1, generator=g) * ci ** -0.5) \
            .to(bf16).to(dev)
        dy = torch.randn(b, co, h, w, generator=g).to(bf16).to(dev)
        return dict(
            name="conv1x1_bwd_bf16", shape="%s x%d a config-D step" % (
                list(shape), c1_bf16_shapes[shape]),
            ms=time_ms(lambda: k1.conv1x1_bwd(x, wt, dy), reps=10),
            plain_ms=time_ms(lambda: k1.conv1x1_bwd_reference(x, wt, dy),
                             reps=10),
            library_ms=time_ms(lambda: torch.ops.aten.convolution_backward(
                dy, x, wt, None, [1, 1], [0, 0], [1, 1], False, [0, 0], 1,
                [True, True, False]), reps=10),
            library="torch.ops.aten.convolution_backward (cuDNN), "
                    "bfloat16: dx and dw in one call",
            bytes=2 * (2 * x.numel() + dy.numel() + 2 * wt.numel()),
            flops=4 * b * h * w * ci * co, per_step=c1_bf16_shapes[shape],
            peak=BF16_FLOPS_PER_S)

    bn_bf16_rows = [bn_bf16_case(s_) for s_ in sorted(
        bn_bf16_shapes, key=lambda s_: (-s_[1], s_[3]))]
    c1_bf16_rows = [c1_bf16_case(s_) for s_ in sorted(
        c1_bf16_shapes, key=lambda s_: (-s_[2], s_[1], s_[4]))]
    rows.extend(bn_bf16_rows + c1_bf16_rows)
    for r in rows:
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        # the float32 FMA rate; the 3xTF32 kernels' floor is three TF32
        # tensor-core operations for each float32 one
        t_fma = r["flops"] / FP32_FLOPS_PER_S * 1e3
        t_ops = 3 * r["flops"] / TF32_FLOPS_PER_S * 1e3 \
            if r.get("tf32x3") else t_fma
        if "peak" in r:
            t_ops = r["flops"] / r["peak"] * 1e3
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
                  if r.get("tf32x3") else
                  "; bfloat16 tensor-core bound %.6f, one-pass TF32 bound "
                  "%.6f" % (max(t_bytes, t_ops), max(
                      t_bytes, r["flops"] / TF32_FLOPS_PER_S * 1e3))
                  if "peak" in r else "",
                  "; library: " + r["library"] if "library" in r else ""))

    for name, krows in (("bn_grad", bn_rows), ("conv1x1_bwd", c1_rows),
                        ("bn_grad_bf16", bn_bf16_rows),
                        ("conv1x1_bwd_bf16", c1_bf16_rows)):
        print("%s over one ResNet-50 step: %d launches, kernel %.3f ms, "
              "bound %.3f ms%s" % (
                  name, sum(r["per_step"] for r in krows),
                  sum(r["per_step"] * r["ms"] for r in krows),
                  sum(r["per_step"] * r["bound_ms"] for r in krows),
                  "; library %.3f ms, plain version %.3f ms" % (
                      sum(r["per_step"] * r["library_ms"] for r in krows),
                      sum(r["per_step"] * r["plain_ms"] for r in krows))
                  if name != "bn_grad" else ""))

    # the decode step end to end (one graph replay): host wall time vs
    # device busy time, the kernels by name
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
                   step_ms, "decode step at pos 160 (graphs)")
    torch.cuda.synchronize()

    # ---- 11. result ----
    by_name = {}
    for r in rows:   # the main path's deepest decode and largest bucket
        if (r["name"], r["shape"]) in (
                ("flash_decode", "[16,8,512,64] cache_len=160"),
                ("flash_decode_bf16", "[16,8,512,64] cache_len=160"),
                ("flash_attention", "[1,8,32,64] causal=True"),
                ("flash_attention_bf16", "[16,8,512,64] causal=True")) \
                or r["name"] in ("lstm_fwd", "lstm_bwd", "gru_fwd",
                                 "gru_bwd", "lstm_fwd_bf16", "lstm_bwd_bf16",
                                 "gru_fwd_bf16", "gru_bwd_bf16") \
                or r["shape"].startswith(("[64, 112, 112, 64]",
                                          "[64, 64, 56, 56, 256]")):
            # bn_grad at the stem, conv1x1_bwd at the first conv3, in
            # float32 and in bfloat16
            by_name[r["name"]] = r
    table = [{"name": n, "route": "cuda", "source": SOURCES[n],
              "replaces": REPLACES[n], "launches": launches[n],
              "max_abs_err": max_err[n], "ms": by_name[n]["ms"],
              "plain_ms": by_name[n]["plain_ms"],
              "bound_ms": by_name[n]["bound_ms"],
              "bound_by": by_name[n]["bound_by"],
              "library_ms": by_name[n]["library_ms"]}
             for n in ("flash_attention", "flash_attention_bf16",
                       "flash_decode", "flash_decode_bf16", "lstm_fwd",
                       "lstm_bwd", "gru_fwd", "gru_bwd", "bn_grad",
                       "conv1x1_bwd", "bn_grad_bf16", "conv1x1_bwd_bf16",
                       "lstm_fwd_bf16", "lstm_bwd_bf16", "gru_fwd_bf16",
                       "gru_bwd_bf16")]
    print("chip_smoke: %.1f s in all" % (time.perf_counter() - started))
    print("card:", card_line())
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
