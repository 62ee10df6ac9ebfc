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
* one-shot serving: LeNet saved, loaded and served over RPC
  (``ServingEngine``, ``DynamicBatcher``, ``ServingServer``,
  ``ServingClient``), the stacked LSTM's ragged requests through the
  engine and batcher, ``generate`` over RPC, and the ``serve`` CLI;
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
  forwards and 2 backwards a step;
* the book's semantic-role tagger (``models/srl.py``) at the CoNLL-2005
  widths (44068 words, 3162 predicates, 59 labels, embedding 32, LSTM
  size 512, Adam lr 1e-3, float32), batches of 16 sentences of 5..39
  ids: a bidirectional ``dynamic_lstm`` (4 float32 LSTM forwards and 2
  backwards a step), ``linear_chain_crf``, then ``crf_decoding`` and
  ``chunk_eval`` on a held-out batch;
* Fluid control flow: ``tests/test_control_flow.py``'s While RNN
  (trained through ``max_iters``, and for inference) and Switch at
  width 64, and benchmark/fluid/stacked_dynamic_lstm.py's LSTM cell
  written with Variable operators inside a ``DynamicRNN`` (dict 30000,
  embedding 512, H 512, batch 32, lengths 16..80);
* the dense op library: its 60 op types, the book's fit_a_line (13
  features, batch 20) and movielens recommender (6040 users, 3952
  movies, title vocabulary 5175, ``nets.sequence_conv_pool`` over the
  titles, ``cos_sim``, batch 256), and ``nets.scaled_dot_product_attention``
  at the transformer cell's width (batch 16, seq 512, d_model 512, 8
  heads) against the ``fused_attention`` op, whose float32 B1 it
  launches;
* the CRNN-CTC text recognizer (PaddlePaddle/models'
  ocr_recognition/crnn_ctc_model.py: 48x512 images, conv channels 16 to
  128, GRUs of 200, 95 classes and the blank, batch 32, Momentum lr
  1e-3 with L2 decay): trained and evaluated (``warpctc``,
  ``ctc_greedy_decoder``, ``edit_distance``) with the published relu
  candidate (the GRU's step loop) and with tanh (4 float32 GRU forwards
  and 2 backwards a step at [32, 64, 200]);
* the loss, optimizer and metric families: the stacked-LSTM classifier
  above under each optimizer this port adds (RMSProp, Adamax, Adadelta,
  DecayedAdagrad, FTRL, LAMB, with ModelAverage), evaluated by
  ``layers.auc``, ``evaluator.Accuracy`` and ``average.WeightedAverage``
  over a pass, and the book's word2vec with PaddlePaddle/models'
  ``hsigmoid`` and ``nce`` heads.
* the v2 frontend (``paddle_tpu_torch.v2``) with its readers and the
  imdb loader: the v2 book's stacked-LSTM sentiment net at the widths
  above over imdb's 5149 words and a v2 GRU classifier, trained, tested,
  checkpointed and inferred through ``paddle.v2``, and the staging
  readers ``device_chunks`` and ``double_buffer``.
* the executor and program tooling: every program above runs under
  the IR verifier (``FLAGS_verify_ir``, on by default: each plan miss
  and each pass stage verified); the per-op NaN/Inf guard
  (``set_check_nan_inf``) on the transformer as bench.py trains it;
  ``calc_gradient`` through the stacked LSTM; seq2seq fed through
  ``LoDTensor``; ``InferenceTranspiler`` on ResNet-50's is_test clone;
  ``Executor.cost_analysis`` of the transformer and ResNet-50 steps.
* parallelism through ``ParallelExecutor`` over NCCL at world 1 (the
  card holds one rank; the sums across ranks are held on the CPU by the
  gloo tests): ResNet-50 config D in every data-parallel mode and the
  stacked LSTM's collectives in a CUDA graph (phase 6l); the
  transformer as bench.py trains it under a (dp, 'mp') mesh with
  ``build_transformer_lm(mp=True)`` and ``CommConfig()``, eagerly and as
  graph replays, and under a (dp, 'sp') mesh with ``seq_axis="sp"`` in
  the global view, whose attention is ring attention over B1, with the
  ring's blocks at 4 chunks checked in one process (phase 6m).

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
4c. serving (S1-S4): LeNet from startup weights saved with
   ``io.save_inference_model`` and loaded back, served by a
   ``ServingEngine`` (buckets 1-64, each a captured CUDA graph) behind a
   ``ServingServer`` (3 ms window) to 16 ``ServingClient`` threads x 64
   requests of batch 1, as bench.py's serving row runs on an accelerator:
   every answer bitwise equal to the eager run of its padded bucket and
   within 1e-5 of ``Executor.run`` on its row alone, no capture and no
   jit miss during the traffic, req/s, latency p50/p90/p99 and where a
   request's time goes (tracing spans), then a typed ``Overloaded`` from
   a held batch and a drain that answers every admitted request; the
   stacked LSTM at bench.py's widths through the engine (``seq_lens``
   80) and a ``DynamicBatcher`` fed ragged requests by 8 threads, 3 B3
   launches a replay, the same two bounds; ``generate`` over RPC on phase
   4's engine, tokens identical to its in-process loop, 8 B1 a prefill
   and 8 B2 a step, a 1 ms deadline; and ``python -m paddle_tpu_torch
   serve`` as a subprocess, its answer bitwise S1's float32 engine's,
   SIGTERM to exit 0;
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
6d. the SRL tagger: startup, 1 warmup and 5 counted steps (finite
   falling loss, 4 B3 + 2 B4 a step derived from the program), a
   profile of one step, crf_decoding and chunk_eval on a held-out batch
   (2 B3; precision, recall and F1 printed), run_chunk's graph replays
   bitwise against eager steps (launches credited once per replay), and
   the card against the CPU at word vocab 1000, hid 32 (losses of 3
   steps at rtol 1e-4; Viterbi tags equal on every row whose path has no
   near-tie, one within 1e-5 or within what the two devices' scores can
   differ by);
6e. control flow, each program's eager steps against run_chunk's graph
   replays, bitwise: the While RNN trained (its while stamped
   differentiable: max_iters masked steps) and for inference (the eager
   loop reads its predicate on the host, the graph runs the masked
   form), each running exactly 3 iterations; a While without max_iters
   refusing the capture; the Switch in both branches, and with
   0 * log(0 * y) inside its branch (NaN taken, finite not taken, as
   under lax.cond); the DynamicRNN cell (a loss falling over 3 steps);
6f. the dense op library: each of its 60 op types through its lowering
   on the card and on the CPU from the same numpy inputs (outputs, and
   the gradients by autograd where it is differentiable: integers
   exact, floats within rtol 1e-5 plus 1e-6 of the largest magnitude),
   the six random ops at their JAX tests' properties, the same bits from
   the same stream and through run_chunk's graphs bitwise; fit_a_line
   and the recommender trained eagerly (a finite falling loss over 10
   steps) and through run_chunk (K=4, GRAPH_CHUNKS chunks, bitwise), the card
   against the CPU from the same weights (3 steps' losses at rtol 1e-4,
   first-step gradients within 1e-4 of their largest magnitude); the
   nets attention against float32 B1 on the same q, k, v (outputs and
   their gradients within PERF.md section 2's bound, B1's launches
   exactly the program's, both calls' host ms, device busy ms and
   device ops);
6g. the vision and detection families: each of their 21 op types on
   the card against the CPU (outputs and gradients at 6f's bounds, the
   pools' masks, matches and NMS kept sets exact; the conv-like types
   also at one large shape, the detection types at SSD300's sizes); a
   duplicate-id scatter and out-of-range labels and ids on the card
   (the CPU's bits, NaN with no device-side assert); the book's
   word2vec at its width, dense and row-sparse (a falling loss over 10
   eager steps, run_chunk K=4 x 2 bitwise, the card against the CPU
   from the same weights); SSD300 at its published widths in config B
   (8732 priors, batch 32: B8 against its plain version at the
   program's 1x1 shapes, a falling loss over 1 + 5 eager steps, B8's
   launches exactly the program's eagerly and per replay, run_chunk
   K=4 x 2 bitwise, detection output and mAP at SSD300's test settings
   on the trained weights, the NMS loop's share of the evaluation, and
   the card against the CPU at channels / 8 and batch 4);
6h. the sequence and CTC families: each of their 16 op types on the
   card against the CPU (outputs, lengths and gradients at 6f's bounds,
   warpctc and edit_distance also at the CRNN's sizes), a duplicate-id
   sequence_scatter twice to the same bits; B5 and B6 at the CRNN's
   [32, 64, 200] against their plain versions and float64, twice to the
   same bits, timed beside their bound and cuDNN's GRU; the CRNN-CTC
   recognizer at full width, relu and tanh candidates (1 + 5 eager
   Momentum steps with a falling loss, B5/B6 launches exactly the
   program's, 0 for relu, eagerly and per replay, run_chunk K=4 x 2
   bitwise, the eval program's decodes and edit distances in range, a
   profile of a step with warpctc's share, the eval call's host and busy
   ms), and the card against the CPU at channels / 4 and batch 8 (3
   losses, first-step gradients at bounds set from what a 1e-6 input
   change does to them, the sharpened eval's decodes row for row);
6i. the losses, the optimizers and the metrics: each of their 26 op
   types on the card against the CPU (outputs and the losses' gradients
   at 6f's bounds, counts exact; nce's draw at 6f's random-op checks and
   its arithmetic on the card's ids); the stacked LSTM at full width
   under RMSProp (plain, and centered with momentum), Adamax, Adadelta,
   DecayedAdagrad, FTRL and LAMB, each with cross entropy,
   ``evaluator.Accuracy`` and ``layers.auc`` (1 + 3 eager steps with a
   falling loss, 6 B3 and 3 B4 a step from the program;
   ``ModelAverage.accumulate`` on the Adamax run, its sums against the
   parameters summed on the host; the for_test clone over 4 batches, 3
   B3 a batch, the streamed AUC against ``metrics.Auc`` and a numpy
   AUC, ``evaluator.Accuracy`` and ``average.WeightedAverage`` against
   the pass accuracy; run_chunk K=4 bitwise against eager steps; the
   update ops' device time beside the bytes a one-pass update moves;
   on the Adamax run the card against the CPU at dict 1000, hid 128: 3
   losses, first-step gradients, every parameter and accumulator after
   step 3); and
   word2vec with the ``hsigmoid`` and the ``nce`` head over its 2073
   words (10 steps with a falling loss, graph replays bitwise, the card
   against the CPU with nce's draws the card's on both);
6j. the v2 frontend through ``paddle_tpu_torch.v2``'s own entry points
   (``init``, the v2 layers, ``parameters.create``,
   ``trainer.SGD(...).train`` with an event handler, ``trainer.test``,
   ``Parameters.to_tar`` and ``from_tar``, ``paddle.infer``), fed by
   ``paddle.batch(paddle.reader.shuffle(paddle.dataset.imdb.train(
   word_dict), 1024), 64)``: the v2 book's stacked-LSTM sentiment net at
   emb/hid 512, 3 layers, imdb's 5149 words (8 Adam batches, 2 test
   batches, the checkpoint's arrays equal, 64 rows inferred with the
   detached and the live parameters to the same bits; 6 B3 + 3 B4 a
   step, 3 B3 a test batch and an infer call, from the programs) and a
   v2 GRU net at H 512 (4 batches, 1 test; 2 B5 + 1 B6 a step); test()
   after the pass below the first batch's cost; host ms a batch, device
   busy ms and ops a step, ``feeder.build_feed``'s host ms;
   ``run_chunk`` over ``device_chunks(super_batch(buffered(r, 2), 4))``
   bitwise the same chunks fed from host numpy, ``double_buffer``'s
   batches equal to the host's on the card; the first step card against
   CPU through v2 (the CPU's weights from the card's tar) at emb/hid 128;
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
9e. (6k) the executor and program tooling at full width: (a) the
   transformer of 9 under bf16 AMP, 3 eager steps and a run_chunk of 4
   replays from the same weights twice with FLAGS_check_nan_inf off and
   once on: losses and every state tensor bitwise (tensors two unguarded
   runs already disagree on named), B1's launches equal and the
   program's; one NaN in the first layer's query weight raises after
   the next eager step, and after the next chunk's first replay, naming
   the first op in program order that reads it; every scope tensor alive
   after the raise, the startup re-run and a clean guarded step finite;
   a target id past the vocabulary at chunk step 2 names the first
   float op downstream of the targets and that step; busy ms and device
   ops a step with the flag on and off, eager and with graphs; (b)
   ``calc_gradient`` of the stacked LSTM's loss (dict 30000, emb/hid
   512, 3 layers, batch 64, lengths 16..80) with respect to its
   embedding's output: 6 B3 + 3 B4 from the program, the gradient
   within 1e-4 x max|g| of the port's CPU run from the same weights;
   (c) seq2seq at full width fed through ``LoDTensor`` as the
   reference's machine_translation.py builds its feeds: 2 Adam steps
   bitwise the list-fed steps, 4 B5 + 2 B6 a step; (d)
   ``InferenceTranspiler`` on ResNet-50's is_test clone (float32, batch
   64, 224x224): all 53 batch norms folded on the card, the logits
   within rtol 1e-4 + 1e-5 max of the unfolded program's, busy ms of
   each; (e) ``cost_analysis`` of the transformer step and a config-C
   ResNet-50 step beside their busy ms (achieved TFLOP/s), with B1's
   and B3-B6's ops' flops apart;
9f. (6l) data parallelism at NCCL world 1 (``parallel_phase``);
9g. (6m) tensor and sequence parallelism at NCCL world 1
   (``tp_phase``): the mp and sp transformer steps bitwise the plain
   step, their bf16 B1 launches the program's, the NCCL calls a step
   the census (mp: 2 ``fwd_row`` and 4 ``bwd_col`` all-reduces a block,
   each labelled 'mp'), mp's graph replays bitwise its eager steps; the
   ring's blocks (``context_parallel.ring_in_process``) at 4 chunks of
   [16,8,512,64], causal, segments split off a chunk edge, bfloat16 and
   float32: out, lse, dq, dk, dv against B1 over the whole sequence, the
   plain ring and float64, 10 B1 launches a ring; the placement search
   for the full-width program printed;
9h. (6n) pipeline and expert parallelism (``pp_phase``): the GPipe and
   1F1B schedules of 4 stages in one process on the transformer as
   bench.py trains it (pp_micro 8, bf16 AMP, the stage body the
   program's own sub-block): both forwards bitwise the serial loop run
   microbatch by microbatch, the two schedules' gradients bitwise equal,
   both within 2e-2 (relative L2) of one whole-batch backward, 1F1B's
   stash within 2(S-1-st)+1 a stage, their bf16 B1 launches the
   schedule's; pp_stages 1, pp_micro 8 under a ('pp',) mesh of 1 at NCCL
   world 1: 3 eager steps against the plain Executor's and 3 graph
   replays bitwise them, the NCCL calls a step the census, the bf16 B1
   launches ``pipeline_launches`` derives; the 4-stage program 3 steps
   under Executor; ``layers.moe`` top-1 and top-2 over [16, 512, 512]
   tokens (8 experts, d_ff 2048) 3 Executor steps bitwise under an
   ('ep',) mesh of 1, card against the CPU on margin tokens; the busy ms
   of a pipelined and a plain step;
9i. (6o) checkpoints and recovery (``ckpt_phase``), at NCCL world 1, on
   the transformer as bench.py trains it under the step guard with
   dynamic loss scaling (the guard phase's program and weights): (a) 2
   steps, an async save through ``CheckpointManager`` and through
   ``ShardedCheckpointManager``, 2 more; each generation restored into a
   fresh scope runs the same 2 steps bitwise (losses and every state
   tensor, the guard's included); (b) ``guard.nonfinite`` on a whole
   chunk trips the divergence detector and ``RecoveryLoop`` rolls back
   to the clean generation: counters equal to the injected counts, the
   end state bitwise the unfaulted run's; (c) ``ParallelExecutor``
   ('dp',) of 1 with ``CommConfig(zero_stage=1)``: a sharded generation
   onto the plain ``Executor`` and back, and ``ElasticRecoveryLoop`` with
   the epoch moving twice, bitwise the fixed run; (d) ``RemoteTrainer``
   on the MNIST MLP against an in-process ``ParameterServer``, fed by the
   task master (``serve --membership`` is checked in S4);
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
11. print the IR verifier's count and host seconds over the whole run,
   the seconds it took, the card, the kernel table as one JSON line,
   then the result line.

It imports nothing of JAX and nothing of the JAX package.
"""

import argparse
import collections
import contextlib
import inspect
import io
import json
import math
import os
import queue
import random
import re
import shutil
import signal
import subprocess
import sys
import threading
import time
import warnings

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

# one-shot serving over RPC as bench.py's _bench_serving runs it on an
# accelerator (bench.py:650-751): LeNet, buckets up to 64, a 3 ms
# coalescing window, 16 clients x 64 requests of batch 1; the stacked
# LSTM's ragged requests from 8 threads of 8 each; generate over RPC
# from 8 threads. An answer is held within rtol 1e-5 plus 1e-6 of the
# largest magnitude of Executor.run on its rows alone (another batch
# size may take another cuDNN or cuBLAS algorithm), and bitwise against
# the eager run of its padded bucket
SERVE_MAX_BATCH, SERVE_MAX_QUEUE = 64, 64
SERVE_CLIENTS, SERVE_PER_CLIENT = 16, 64
RAGGED_THREADS, RAGGED_PER_THREAD = 8, 8
GEN_THREADS = 8
SERVE_RTOL, SERVE_AMAX = 1e-5, 1e-6

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
# the batch-norm backward's one kernel (a cooperative launch: the sums,
# the grid barrier and dx), every instantiation
B7_KERNELS = ("bn_grad_kernel",)

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
# one chunk a graph path; the transformer's in the graphs phase takes
# GRAPH_CHUNKS_LONG, the path that replays a whole later chunk (the
# other paths' second chunk made room for phase 6m's time)
GRAPH_CHUNKS, GRAPH_CHUNKS_LONG = 1, 2
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

# the semantic-role tagger (paddle_tpu_torch/models/srl.py) at the
# CoNLL-2005 schema's widths (paddle_tpu/dataset/conll05.py:9-11: 44068
# words, 3162 predicates, 59 labels) and the book's (embedding 32,
# dynamic_lstm size 512 = 4 x hid 128), Adam lr 1e-3, float32; batches
# of 16 sentences whose lengths are drawn as conll05.py draws them
# (randint(5, 40): SRL_LENS is its inclusive range); the card against
# the CPU at word vocab 1000, hid 32
SRL = dict(emb_dim=32, hid_dim=128, lr=1e-3)
SRL_LENS = (5, 39)
SRL_B, SRL_WARMUP, SRL_STEPS = 16, 1, 5
SRL_XCHECK = dict(word_dict_len=1000, emb_dim=32, hid_dim=32, lr=1e-3)
SRL_XCHECK_B, SRL_XCHECK_STEPS = 16, 3
# a Viterbi step whose top two scores lie within this (or within what
# the card's and the CPU's scores can differ by) counts as a near-tie
SRL_TIE = 1e-5
# control flow (path B): tests/test_control_flow.py's While RNN (trained
# through max_iters T steps) and Switch at width CF_H, batch CF_B; the
# DynamicRNN LSTM cell of benchmark/fluid/stacked_dynamic_lstm.py
# written with Variable operators, at the stacked LSTM's dict and H 512,
# batch 32, lengths MIN_LEN..80
CF_H, CF_B, CF_T, CF_MAX_ITERS = 64, 16, 3, 8
DRNN = dict(vocab=DICT, emb=512, hid=512)
DRNN_B, DRNN_T, DRNN_STEPS = 32, 80, 3
GRAPH_K.update(srl=4, control=4, drnn=2)
# the dense op library (phase 6f): each type at the JAX sweeps' shapes,
# the card against the CPU from the same numpy inputs: integer and shape
# results exact, float results and gradients within DENSE_RTOL plus
# DENSE_AMAX of the largest magnitude
DENSE_RTOL, DENSE_AMAX = 1e-5, 1e-6
# the book's fit_a_line over uci_housing's 13 features
# (tests/test_book.py:166-196), batch 20, SGD lr 0.01
FIT_B, FIT_LR = 20, 0.01
# the book's recommender (tests/test_book.py:236-283) at movielens' table
# sizes (paddle_tpu/dataset/movielens.py:12-16: 6040 users, 2 genders, 7
# ages, 3952 movies, title vocabulary 5175) and the 2018 book's widths
# (id embeddings 32, gender and age 16, tower fc 200, 32 title filters of
# width 3 pooled by sum), batch 256, titles of 1..15 ids, SGD lr 0.1
REC = dict(users=6040, genders=2, ages=7, movies=3952, title_vocab=5175,
           id_emb=32, small_emb=16, fc=200, filters=32, filter_size=3,
           lr=0.1)
REC_B, REC_TITLE = 256, (1, 15)
BOOK_STEPS = 10
GRAPH_K.update(book=4)
# nets.scaled_dot_product_attention against B1 at the transformer cell's
# width (bench.py:221-253): batch 16, sequence 512, d_model 512, 8 heads,
# float32, not causal
SDPA = dict(b=16, t=512, d=512, heads=8)
# B1 in float32 (3xTF32 GEMMs, an online softmax over key blocks, its
# backward recomputing P) against the float32 cuBLAS chain with TF32 off
# (PERF.md section 2): the outputs within SDPA_OUT_TOL of their largest
# magnitude, the gradients with respect to q, k and v each within
# SDPA_GRAD_TOL of its own
SDPA_OUT_TOL, SDPA_GRAD_TOL = 1e-5, 1e-4

# the vision and detection families (phase 6g): each type at the JAX
# sweeps' shapes (plus one large shape for each conv-like type), the
# card against the CPU at the DENSE_* bounds, integer results, NMS kept
# sets and matches exact. A large case ("_large") sums 1728 to 16384
# products an output (cuDNN's order against oneDNN's): its floats within
# DENSE_RTOL plus VISION_LARGE_AMAX of the largest magnitude (an H100
# run found 1.6e-6 and 2.3e-6 where DENSE_AMAX allows 1e-6)
VISION_LARGE_AMAX = 1e-5
# the book's word2vec (tests/test_book.py:198-233) at imikolov's
# dictionary (paddle_tpu/dataset/imikolov.py:9: 2073 words) and the
# book's widths: four context words through one shared 32-wide table,
# a sigmoid hidden layer of 256, a softmax over the dictionary, batch
# 32, SGD at tests/test_book.py's lr 0.05, dense and row-sparse
BOOK_W2V = dict(dict_size=2073, emb=32, hid=256, lr=0.05)
BOOK_W2V_B, BOOK_W2V_STEPS = 32, 10
GRAPH_K.update(w2v=4, ssd=4)
# SSD300 (Liu et al., SSD: Single Shot MultiBox Detector, ECCV 2016,
# the PASCAL VOC SSD300 configuration): a 300x300 input, 21 classes,
# six source maps (38, 19, 10, 5, 3, 1 cells; 512, 1024, 512, 256, 256,
# 256 channels) with 4, 6, 6, 6, 4, 4 priors a cell, 8732 priors in all,
# on a VGG-16 trunk with a batch norm after every conv (the repo's
# VGG-16, paddle_tpu/models/vgg.py:10-15); cut: no L2Norm on conv4_3.
# Batch 32, 8 ground-truth boxes an image, Momentum 0.9 at lr 1e-3.
SSD = dict(size=300, div=1, maps=6, classes=21, gt=8, lr=1e-3)
SSD_B, SSD_PRIORS = 32, 8732
SSD_MIN = (30, 60, 111, 162, 213, 264)
SSD_MAX = (60, 111, 162, 213, 264, 315)
SSD_AR = ((2.0,), (2.0, 3.0), (2.0, 3.0), (2.0, 3.0), (2.0,), (2.0,))
# SSD300's test settings for detection_output
SSD_NMS = dict(nms_threshold=0.45, nms_top_k=400, keep_top_k=200,
               score_threshold=0.01)
# the card against the CPU: channels / 8 and batch 4 at the 300x300
# input (all six maps, 8732 priors), 3 Momentum steps' losses within
# SSD_LTOL (the ResNet bound: batch norm over few values a channel and
# relu gates amplify rounding); the detections' scores within rtol
# 1e-4, their rows equal but for near-ties
SSD_X = dict(div=8, batch=4)
SSD_LTOL = 1e-3
# and the first-step gradients: each within SSD_GTOL of its largest
# magnitude and SSD_PL2TOL of its L2 norm (the ResNet A-vs-B bounds), all
# together within SSD_L2TOL; a conv bias under a batch norm has a
# gradient that cancels to rounding noise (held in the whole only,
# AMP_CANCELS). Why: the trunk's batch norms see few values a channel
# at the 3x3 and 1x1 maps and the mining's ranks flip on rounding, so a
# 1e-6 change of the input moves the port's own first-step gradients on
# the CPU by 1.2e-3 all together, 2.3e-3 of one gradient's L2 norm and
# 8e-3 of one's largest entry; an H100 run found 3.0e-3 all together,
# card against CPU
SSD_GTOL, SSD_PL2TOL, SSD_L2TOL = 1e-1, 2e-2, 1e-2

# the CRNN-CTC text recognizer (PaddlePaddle/models,
# fluid/ocr_recognition/crnn_ctc_model.py: ocr_convs, encoder_net,
# ctc_train_net; ctc_reader.py: DATA_SHAPE [1, 48, 512], 95 classes):
# four groups of two 3x3 convs (16, 32, 64, 128 channels), each with a
# batch norm and relu, the first three groups ending in a 2x2 max pool
# in ceil mode; image-to-sequence over the 6-row map (64 frames of 768);
# two fcs of 3 x 200 feeding a forward and a reverse GRU of 200 with the
# relu candidate (variant "a", as published) or tanh ("b": dynamic_gru's
# default, which runs B5 and B6); an fc to 96 classes; warpctc (blank
# 95, norm_by_times), its sum under Momentum 0.9 at lr 1e-3, L2 decay
# 4e-4 on every parameter. Batch 32; labels of 8..24 ids in 0..94, every
# row alignable in its 64 frames. Cut: none of the widths; the frames'
# lengths are fed to sequence_unpad (the repo's im2sequence is dense).
CRNN = dict(width=512, channels=(16, 32, 64, 128), hidden=200, classes=95,
            lr=1e-3)
CRNN_B, CRNN_LABELS, CRNN_L2 = 32, (8, 24), 4e-4
CRNN_ACTS = (("a", "relu"), ("b", "tanh"))
GRAPH_K.update(crnn=4)
# the card against the CPU: channels / 4, batch 8 at the full 48 x 512
# input and H 200: 3 losses within CRNN_LTOL; the eval program's
# decodes from the startup's weights with the output layer x
# CRNN_SHARPEN equal row for row but at frames whose top-two logit
# margin is under CRNN_TIE (counted); the first-step gradients all together
# within CRNN_L2TOL in relative L2 norm, each within CRNN_GTOL of its
# largest magnitude; a
# gradient whose L2 norm is under CRNN_CANCELS of the largest one's is
# held in the whole only. Why: at the published initialisers (batch-norm
# scales from N(0, 0.01), whose epsilon then outweighs the variance of
# the tiny activations) the conv trunk's gradients are 1e-15 to 4e-2 of
# the largest and ill-conditioned: relu gates of batch-norm outputs
# near 0 flip on rounding, so a 1e-6 change of the input moves the
# CPU's own trunk gradients by up to ~4e-3 of their largest entry
# (crnn_conditioning prints it for each run) while the encoder's (fcs,
# GRUs) do not move, and all together move ~2e-5
CRNN_X = dict(channels=(4, 8, 16, 32), batch=8)
CRNN_LTOL, CRNN_TIE, CRNN_SHARPEN = 1e-4, 1e-5, 30.0
CRNN_GTOL, CRNN_L2TOL, CRNN_CANCELS = 1e-2, 1e-4, 1e-4
# phase 6h's sweep: the sequence and CTC types at the JAX sweeps' shapes
# and at the CRNN's ([32, 64, 96] logits, labels of 8..24; 32 rows of 64
# ids against 24), the card against the CPU at the DENSE_* bounds,
# integers and lengths exact. A CRNN-size case ("_crnn") holds its floats
# within DENSE_RTOL plus SEQ_LONG_AMAX of the largest magnitude: warpctc's
# gradient runs back through 64 frames of log-add-exp, the card's exp and
# log1p against the CPU's (an H100 run found 6.1e-6 of the largest
# magnitude where DENSE_AMAX allows 1e-6)
SEQ_TYPES = 16
SEQ_LONG_AMAX = 2e-5

# phase 6i: the losses, the optimizers and the metrics. The sweep: the
# 26 types at the JAX sweeps' shapes, the card against the CPU at the
# DENSE_* bounds, counts exact (nce's arithmetic on the card's own ids;
# its draw at phase 6f's random-op checks: the same bits from the same
# stream, uniform within 0.03 over NCE_DRAWS draws)
OPTIM_TYPES = 26
NCE_DRAWS = 100000
# the stacked-LSTM classifier at train_phase's widths (DICT, EMB, HID,
# STACKED, CLASSES; batch LSTM_B of MIN_LEN..LSTM_T ids) with cross
# entropy, evaluator.Accuracy and layers.auc, under each optimizer this
# slice adds: (tag, class, keywords). The rates give a first step of
# about 1e-3 a weight: RMSProp and Adadelta move a weight by about
# sqrt(1 / (1 - decay)) x rate, but one whose gradient is under
# sqrt(epsilon / (1 - decay)) by about its gradient; DecayedAdagrad,
# whose epsilon sits outside the root, moves every weight with a
# gradient by sqrt(1 / (1 - decay)) x rate (at 1e-3 the loss rose from
# the second step on the card: 0.54, 2.32, 11.5), Adamax and FTRL by
# their rate (FTRL at 5e-3: 0.66, 2.11, 11.4), LAMB by its rate x each
# weight's norm (at 1e-2 the first step raised the loss: 0.84)
OPTIMIZERS = (
    ("rmsprop", "RMSProp", dict(learning_rate=1e-3)),
    ("rmsprop_centered", "RMSProp",
     dict(learning_rate=1e-3, momentum=0.9, centered=True)),
    ("adamax", "Adamax", dict(learning_rate=2e-3)),
    ("adadelta", "Adadelta", dict(learning_rate=1.0)),
    ("decayed_adagrad", "DecayedAdagrad", dict(learning_rate=3e-4)),
    ("ftrl", "Ftrl", dict(learning_rate=1e-3, l1=1e-5, l2=1e-5)),
    ("lamb", "Lamb", dict(learning_rate=3e-3)),
)
# 1 warmup and OPTIM_STEPS counted eager steps; ModelAverage rides the
# OPTIM_AVERAGE run; the for_test clone streams the metrics over
# OPTIM_EVAL_BATCHES batches; run_chunk K=GRAPH_K["optim"], one chunk
OPTIM_WARMUP, OPTIM_STEPS = 1, 3
OPTIM_AVERAGE = "adamax"
# the runs held card against the CPU on the whole stacked LSTM (the
# other optimizers' update ops are held card against the CPU by the
# sweep; phase 6n's time took the rest)
OPTIM_XCHECK = (OPTIM_AVERAGE,)
OPTIM_EVAL_BATCHES = 4
GRAPH_K.update(optim=4)
# the card against the CPU at XCHECK's size (dict 1000, hid 128): 3
# losses within rtol 1e-4, first-step gradients within 1e-4 x max|g|,
# every parameter and optimizer accumulator after the first step within
# OPTIM_STATE_TOL of its largest magnitude ...
# ... plus COND_FACTOR times the most that NOISE_PROBES draws of a 1e-6
# relative change of every weight move that tensor on the CPU over the
# same step (check_state, weight_noise). These updates normalise each
# gradient element, so an element whose gradient is rounding noise takes
# a step of the full rate in a rounding-noise direction: on the CPU at
# XCHECK's size such a change moved Adamax's state by 0.26, FTRL's by
# 1.7e-3 and LAMB's by 1.1e-4 of the largest magnitude after 3 steps.
# The state is held after the first step: by the third, the max pools
# over time have met near-ties whose winner flips on rounding (3 of 6
# such draws moved centered RMSProp's fc_2.w_0 momentum by 0.105 there,
# as the card did in one run), which no number of draws bounds for sure
OPTIM_STATE_TOL = 1e-4
COND_FACTOR, NOISE_PROBES = 4, 4
# ... that allowance never above NOISE_CAP of a tensor's largest
# magnitude, so no tensor gets a bound that would pass nearly anything
NOISE_CAP = 1e-2
# the update ops' share of an eager step: the median of UPDATE_PROFILES
# profiles, the update ops' kernels read from a record_function range
# (one: three profiles of each of the 9 runs agreed within 1.2 % on an
# H100, so the two others made room for phase 6m's time)
UPDATE_PROFILES, UPDATE_RANGE = 1, "update_ops"
# word2vec (BOOK_W2V) with its softmax head replaced by layers.hsigmoid
# and by layers.nce over the 2073 words
W2V_HEADS = ("hsigmoid", "nce")

# phase 6j: the v2 frontend (paddle_tpu_torch.v2) and its readers. The
# v2 book's stacked-LSTM sentiment net (v2_stacked_build) at
# train_phase's widths (EMB, HID, STACKED, CLASSES) over
# dataset.imdb.word_dict()'s 5149 words, fed paddle.batch(paddle.reader.
# shuffle(paddle.dataset.imdb.train(word_dict), V2_SHUFFLE), V2_B) (rows
# of 8..119 ids), at the default (tanh) activations, so that lstmemory
# runs B3/B4; Adam. V2_TRAIN_BATCHES batches of one pass through
# trainer.SGD.train, trainer.test over V2_TEST_BATCHES, to_tar and
# from_tar, paddle.infer on V2_INFER_ROWS rows with the detached and with
# the live parameters
V2_B, V2_SHUFFLE, V2_LR = 64, 1024, 1e-3
# the imdb loader's shortest and longest rows (dataset/imdb.py): B3-B6
# run at [V2_B, up to V2_T, HID] on this path, so check_lstm and
# check_gru hold them there too, ragged from V2_MIN_LEN
V2_MIN_LEN, V2_T = 8, 119
V2_TRAIN_BATCHES, V2_TEST_BATCHES, V2_INFER_ROWS = 8, 2, 64
# the v2 GRU classifier (v2_gru_build) at H = HID on the same reader:
# V2_GRU_BATCHES trained, V2_GRU_TEST_BATCHES tested (B5/B6)
V2_GRU_BATCHES, V2_GRU_TEST_BATCHES = 4, 1
# the staging readers: Executor.run_chunk over V2_CHUNKS chunks of V2_K
# steps from device_chunks(super_batch(buffered(r, 2), V2_K)) against
# the same chunks fed from host numpy
V2_K, V2_CHUNKS = 4, 2
# the card against the CPU (first step: cost and updated parameters):
# the stacked net at XCHECK's widths over the same vocabulary, batch
# XCHECK_B, at phase 6i's bounds (cross_check)
V2_XCHECK = dict(emb_dim=XCHECK["emb_dim"], hid_dim=XCHECK["hid_dim"],
                 stacked_num=XCHECK["stacked_num"])

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
# count (315) that no power of two divides, channels that fill no float4;
# x and dy wholly resident in the blocks' shared memory (64x14x14x256),
# just past it (64x56x56x64: in float32 a third of the tiles is read
# again), and fewer rows than blocks (2x3x5x40)
BN_SHAPES = ((64, 112, 112, 64), (64, 7, 7, 2048), (5, 7, 9, 24),
             (3, 5, 7, 6), (64, 14, 14, 256), (64, 56, 56, 64),
             (2, 3, 5, 40))
# B7's three loaders, each forced where the plan would take another, at
# a shape with more tiles than slots and at two odd ones
BN_LOADER_SHAPES = ((16, 56, 56, 64), (5, 7, 9, 24), (2, 3, 5, 40))
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


_STARTED = time.perf_counter()


def phase(name):
    print("== %s [%.1f s]" % (name, time.perf_counter() - _STARTED),
          flush=True)


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
# B7 is bound by bytes: by its loader (the last template argument), the
# TMA instantiation must have UTMALDG, the 16-byte one LDG of 16 bytes,
# the element one neither; none may spill
B7_LOADER = re.compile(r"bn_grad_kernelILb\dELi(\d)E")
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
    WIDE_LOAD_KERNELS must have 16-byte loads instead, and B7's by its
    loader (B7_LOADER)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for lib, kernel in TENSOR_CORE_KERNELS + WIDE_LOAD_KERNELS + (
            ("bn_grad", "bn_grad_kernel"),):
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
            m = B7_LOADER.search(f)
            if m:
                loader = int(m.group(1))
                ok = (c["UTMALDG"] > 0, c["wide"] > 0, True)[loader]
                if spills or not ok:
                    raise AssertionError(
                        "%s: spills, or lacks its loader's copies (%s)" % (
                            f, ("UTMALDG", "16-byte LDG", "-")[loader]))
                continue
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


# the plain versions' times are context for the kernels' (1 to 350 ms a
# call, the host's launches as much as the device's work): the median of
# PLAIN_REPS runs after the warmup
PLAIN_REPS = 5


def plain_time_ms(fn, reps=PLAIN_REPS, flush=None):
    """time_ms for a plain version: PLAIN_REPS runs unless told."""
    return time_ms(fn, reps=reps, flush=flush)


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
    kernels whose name holds one. Returns (busy ms, device ops) a step,
    (None, 0) where the profiler recorded no device event. The profiler
    records the device's activity only: recording every host op as well
    multiplies the cost of profiling an eager step of thousands of
    launches several times over and adds nothing to these sums."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
        return None, 0
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
    return busy_ms, ops


def lstm_inputs(B, T, H, peep, g, dev, ragged=True, min_len=0):
    """Seeded LSTM inputs on the card; ragged lengths are uniform in
    [min_len, T] with a row of length min_len and a row of length T."""
    xg = torch.randn(B, T, 4 * H, generator=g) * 0.5
    w = torch.randn(H, 4 * H, generator=g) * H ** -0.5
    h0 = torch.randn(B, H, generator=g) * 0.1
    c0 = torch.randn(B, H, generator=g) * 0.1
    if ragged:
        lens = torch.randint(min_len, T + 1, (B,), generator=g)
        lens[0], lens[-1] = min_len, T
    else:
        lens = torch.full((B,), T)
    mask = (torch.arange(T)[None] < lens[:, None]).float()
    p = torch.randn(3, H, generator=g) * 0.1 if peep else torch.zeros(3, H)
    dhs = torch.randn(B, T, H, generator=g)
    dcs = torch.randn(B, T, H, generator=g)
    return [t.to(dev) for t in (xg, w, h0, c0, mask, p, dhs, dcs)]


def check_lstm(lc, g, dev):
    """B3 and B4 against their plain versions: hs, cs; dxg, dW (through
    the GEMM outside the kernel), dh0, dc0, dpeep; at the stacked LSTM's
    shape, at the SRL tagger's (SRL_B sentences of SRL_LENS, hid 128)
    and at the v2 stacked net's longest batch (V2_B rows of
    V2_MIN_LEN..V2_T ids, HID): either direction gives the kernel a
    valid prefix, so one mask shape covers the forward, the reverse and
    the decode. Returns the max abs errors {kernel: err} and dW's."""
    err = {"lstm_fwd": 0.0, "lstm_bwd": 0.0}
    dw_err = 0.0
    for B, T, H, lo in ((8, 5, 32, 0), (LSTM_B, LSTM_T, HID, 0),
                        (37, 17, 128, 0),
                        (SRL_B, SRL_LENS[1], SRL["hid_dim"], SRL_LENS[0]),
                        (V2_B, V2_T, HID, V2_MIN_LEN)):
        case = {"lstm_fwd": 0.0, "lstm_bwd": 0.0}
        for peep in (True, False):
            xg, w, h0, c0, mask, p, dhs, dcs = lstm_inputs(
                B, T, H, peep, g, dev, min_len=lo)
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
                case["lstm_fwd"] = max(case["lstm_fwd"], assert_close(
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
                    case["lstm_bwd"] = max(case["lstm_bwd"], e)
        print("lstm [%d,%d,%d], lengths %d..%d: max abs err B3 %.3g, B4 "
              "%.3g" % (B, T, H, lo, T, case["lstm_fwd"], case["lstm_bwd"]))
        err = {k: max(v, case[k]) for k, v in err.items()}
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


def gru_inputs(B, T, H, g, dev, ragged=True, min_len=0):
    """Seeded GRU inputs on the card; ragged lengths are uniform in
    [min_len, T] with a row of length min_len and a row of length T."""
    xg = torch.randn(B, T, 3 * H, generator=g) * 0.5
    w = torch.randn(H, 3 * H, generator=g) * H ** -0.5
    h0 = torch.randn(B, H, generator=g) * 0.1
    if ragged:
        lens = torch.randint(min_len, T + 1, (B,), generator=g)
        lens[0], lens[-1] = min_len, T
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


def check_gru_shape(gc, B, T, H, g, dev, ragged=True, min_len=0):
    """B5 and B6 against their plain versions at [B, T, H]: hs and the
    stash; dxg, dW (through the GEMMs outside the kernel) and dh0.
    Returns the max abs errors of the forward, the backward and dW."""
    xg, w, h0, mask, dhs = gru_inputs(B, T, H, g, dev, ragged, min_len)
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
    fwd = max(assert_close("%s %s" % (what, name), a.detach(), b, LSTM_ATOL,
                           LSTM_RTOL)
              for name, a, b in (("hs", hs, rhs), ("stash", stash, rst)))
    errs = {}
    for name, a, b in (("dxg", got[0], dxg), ("dW", got[1], dw),
                       ("dh0", got[2], dh0)):
        atol = LSTM_ATOL * max(1.0, float(b.abs().max()))
        errs[name] = assert_close("%s %s" % (what, name), a, b, atol,
                                  LSTM_RTOL)
    return fwd, max(errs["dxg"], errs["dh0"]), errs["dW"]


def check_gru(gc, g, dev):
    """B5 and B6 against their plain versions (check_gru_shape) at three
    shapes, at the v2 GRU net's longest batch (V2_B rows of
    V2_MIN_LEN..V2_T ids, HID) and at the widest H that B6 takes on this
    card. Returns the max abs errors {kernel: err} and dW's."""
    err = {"gru_fwd": 0.0, "gru_bwd": 0.0}
    dw_err = 0.0
    h_max, plan = gru_widest(gc, dev)
    print("gru_bwd: the widest H its launch plan admits at B=%d on this "
          "card: %d (%s)" % (S2S_B, h_max, json.dumps(plan)))
    for B, T, H, lo in ((8, 5, 32, 0), (S2S_B, S2S_T, S2S["hidden_dim"], 0),
                        (37, 17, 128, 0), (V2_B, V2_T, HID, V2_MIN_LEN),
                        (S2S_B, S2S_T, h_max, 0)):
        fwd, bwd, dw = check_gru_shape(gc, B, T, H, g, dev, min_len=lo)
        print("gru [%d,%d,%d], lengths %d..%d: max abs err B5 %.3g, B6 "
              "%.3g, dW %.3g" % (B, T, H, lo, T, fwd, bwd, dw))
        err["gru_fwd"] = max(err["gru_fwd"], fwd)
        err["gru_bwd"] = max(err["gru_bwd"], bwd)
        dw_err = max(dw_err, dw)
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
    on_card = packed_on(fluid, {"words": words, "label": label}, dev)
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


def state_names(prog):
    """The program's parameters and optimizer accumulators."""
    return sorted(v.name for v in prog.list_vars() if v.persistable and (
        v.is_parameter or getattr(v, "optimizer_state_for", None)))


def state_diffs(names, got, want):
    """{name: max |got - want| / max |want|} over the float tensors
    ``got(name)`` and ``want(name)`` (tensors or arrays)."""
    def host(v):
        return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v)
    out = {}
    for n in names:
        w = host(want(n))
        if not np.issubdtype(w.dtype, np.floating) or not w.size:
            continue
        w = w.astype(np.float64)
        g = host(got(n)).astype(np.float64).reshape(w.shape)
        out[n] = float(np.abs(g - w).max()) / max(float(np.abs(w).max()),
                                                  1e-30)
    return out


def weight_noise(prog, scope, seed, rel=1e-6):
    """Every float parameter of ``prog`` in ``scope`` x (1 + ``rel`` x a
    standard normal draw from ``seed``): a probe of how far rounding
    moves a run of the program."""
    g = torch.Generator().manual_seed(seed)
    for p in prog.global_block().all_parameters():
        t = scope.find_var(p.name)
        if t.is_floating_point():
            n = torch.randn(tuple(t.shape), generator=g).to(t.device, t.dtype)
            scope.set_var(p.name, t * (1 + rel * n))


def check_state(label, diffs, moved, tol, detail=False):
    """Each tensor's difference (``state_diffs``) within ``tol`` plus
    COND_FACTOR times ``moved[name]``, the most that a 1e-6 relative
    change of the weights (weight_noise, NOISE_PROBES draws) moves that
    tensor over the same steps, that allowance never above NOISE_CAP: a
    tensor that rounding moves further is held at ``tol`` + NOISE_CAP,
    not at a bound that would pass nearly anything. With ``detail``,
    prints each tensor's difference beside its allowance, and the
    largest allowance granted to an optimizer moment."""
    allow = {n: min(COND_FACTOR * moved.get(n, 0.0), NOISE_CAP)
             for n in diffs}
    if detail:
        for n in sorted(diffs):
            print("%s: %s differs by %.3g, allowed %g + %.3g" % (
                label, n, diffs[n], tol, allow[n]))
        moments = [n for n in diffs if "moment" in n]
        if moments:
            top = max(moments, key=allow.get)
            print("%s: the largest allowance of the %d moment tensors: %s "
                  "%.3g (it differs by %.3g)" % (
                      label, len(moments), top, allow[top], diffs[top]))
    worst = max(diffs, key=lambda n: diffs[n] / (tol + allow[n]))
    over = [n for n in diffs if diffs[n] > tol + allow[n]]
    capped = sorted(n for n in diffs if allow[n] == NOISE_CAP)
    print("%s: %d parameters and optimizer accumulators, the worst %s at "
          "%.3g x its largest magnitude where a 1e-6 weight change moves it "
          "by %.3g (bound %g + min(%d x that, %g)); %d of them beyond %g; "
          "%d held at the cap%s" % (
              label, len(diffs), worst, diffs[worst], moved.get(worst, 0.0),
              tol, COND_FACTOR, NOISE_CAP,
              sum(d > tol for d in diffs.values()), tol, len(capped),
              " (%s, differing by %s)" % (", ".join(capped[:4]), " ".join(
                  "%.3g" % diffs[n] for n in capped[:4])) if capped else ""))
    if over:
        raise AssertionError("%s: %s differ by %s" % (
            label, over[:5], [diffs[n] for n in over[:5]]))


def noise_moves(fluid, prog, fetch, init, feed, steps, names):
    """{name: the most any of NOISE_PROBES weight_noise draws moves that
    state tensor over ``steps`` runs of ``prog`` from ``init`` on the
    CPU}, against the same runs without noise."""
    exe = fluid.Executor(fluid.CPUPlace())
    runs = []
    for seed in [None] + list(range(NOISE_PROBES)):
        sc = fluid.Scope()
        for n, t in init.items():
            sc.set_var(n, t.clone())
        if seed is not None:
            weight_noise(prog, sc, seed)
        for _ in range(steps):
            exe.run(prog, feed=feed, fetch_list=[fetch], scope=sc)
        runs.append(sc)
    moved = {}
    for sc in runs[1:]:
        for n, d in state_diffs(names, sc.find_var, runs[0].find_var).items():
            moved[n] = max(moved.get(n, 0.0), d)
    return moved


def cross_check(fluid, exe, build, seed, batch, steps, label, gtol=1e-4,
                ltol=1e-4, l2tol=1e-3, pl2tol=None, edit=None, pl2_floor=0.0,
                state_tol=None):
    """The card against the CPU from the same weights: the losses of
    ``steps`` optimizer steps within rtol ``ltol``, every first-step
    parameter gradient within ``gtol`` x its largest magnitude (and
    within ``pl2tol`` of its L2 norm, where given) and all of them
    together within ``l2tol`` in relative L2 norm; with ``state_tol``,
    every parameter and optimizer accumulator after the first step
    (check_state, against what weight_noise moves them by on the CPU).
    ``edit(prog, scope)`` changes the CPU's
    weights before they are carried to the card. Each step runs on the
    card first, then on the CPU (each executor draws from generators of
    its own step key and op, so the order changes no draw; SameDraws
    replays the card's draws on the CPU). Returns the card's first-step
    loss and gradients, by name."""
    from paddle_tpu_torch import interop, unique_name

    with unique_name.guard():
        xprog, xstart, _, (xloss,) = build()
    xstart.random_seed = seed
    cpu_scope, card_scope = fluid.Scope(), fluid.Scope()
    cpu = fluid.Executor(fluid.CPUPlace())
    cpu.run(xstart, scope=cpu_scope)
    if edit is not None:
        edit(xprog, cpu_scope)
    init = scope_state(cpu_scope)
    interop.load_reference_state(
        {n: t.numpy() for n, t in cpu_scope.vars.items()}, card_scope,
        fluid.CUDAPlace(0), [xprog, xstart])
    grads = sorted(p.name + "@GRAD"
                   for p in xprog.global_block().all_parameters())
    first = None
    for step in range(steps):
        extra = grads if step == 0 else []
        out = {}
        for where in ("card", "cpu"):
            e, sc = (exe, card_scope) if where == "card" else (cpu, cpu_scope)
            out[where] = e.run(xprog, feed=batch, fetch_list=[xloss] + extra,
                               scope=sc)
        c, k = out["cpu"], out["card"]
        print("cross-check step %d: loss cpu %.7f card %.7f" % (
            step, float(c[0]), float(k[0])))
        np.testing.assert_allclose(k[0], c[0], rtol=ltol)
        if step == 0:
            first = dict(zip(["loss"] + grads, k))
            check_grad_diff("card vs cpu at %s, %d first-step gradients"
                            % (label, len(grads)),
                            grad_diff(grads, k[1:], c[1:], pl2_floor), gtol,
                            l2tol, pl2tol)
            if state_tol is not None:
                names = state_names(xprog)
                check_state(
                    "card vs cpu at %s after the first step" % label,
                    state_diffs(names, card_scope.find_var,
                                cpu_scope.find_var),
                    noise_moves(fluid, xprog, xloss, init, batch, 1, names),
                    state_tol)
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
    on_card = packed_on(fluid, feed, dev)
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
    (K=4, GRAPH_CHUNKS chunks of graph replays) against eager steps, sparse and
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


def srl_batch(rng, b, sizes):
    """``b`` sentences as paddle_tpu/dataset/conll05.py makes them:
    lengths randint(5, 40), word ids uniform, one predicate a sentence,
    labels uniform over the tag set. Returns (lengths, ragged feed)."""
    lens = rng.randint(SRL_LENS[0], SRL_LENS[1] + 1, b)
    return lens, {
        "word": [rng.randint(0, sizes["word_dict_len"], (n, 1))
                 .astype(np.int64) for n in lens],
        "pred": [np.full((n, 1), rng.randint(sizes["pred_dict_len"]),
                         np.int64) for n in lens],
        "label": [rng.randint(0, sizes["label_dict_len"], (n, 1))
                  .astype(np.int64) for n in lens]}


def packed_on(fluid, feed, dev):
    """A feed on the card, so that it stays there: ragged [len_i, 1] id
    lists packed as the executor packs them (zero-padded to the
    longest, in the arrays' dtype), arrays as they are."""
    from paddle_tpu_torch.core.executor import _pack_ragged

    out = {}
    for name, v in feed.items():
        if isinstance(v, list):
            p = _pack_ragged(v, v[0].dtype.name)
            out[name] = fluid.PackedSeq(p.data.to(dev), p.lengths.to(dev))
        else:
            out[name] = torch.from_numpy(v).to(dev)
    return out


def viterbi_margins(em, lens, trans):
    """The smallest margin along each row's Viterbi path, in float64:
    at every step the best previous tag's score over the second best's
    for the tag the path takes, and at the end the best last tag over
    the second. Returns (paths, margins)."""
    start, end, tr = (trans[0].astype(np.float64),
                      trans[1].astype(np.float64),
                      trans[2:].astype(np.float64))
    paths, margins = [], []
    for row, n in enumerate(lens):
        e = em[row, :n].astype(np.float64)
        delta = start + e[0]
        bps, gaps = [], []
        for t in range(1, n):
            sc = delta[:, None] + tr
            top = np.sort(sc, 0)
            bps.append(np.argmax(sc, 0))
            gaps.append(top[-1] - top[-2])
            delta = top[-1] + e[t]
        fin = np.sort(delta + end)
        tag = int(np.argmax(delta + end))
        gap, path = fin[-1] - fin[-2], [tag]
        for t in range(n - 2, -1, -1):
            gap = min(gap, gaps[t][tag])
            tag = int(bps[t][tag])
            path.append(tag)
        paths.append(path[::-1])
        margins.append(gap)
    return paths, np.asarray(margins)


def srl_phase(fluid, seed, dev):
    """Path A: the semantic-role tagger at full width (float32): startup,
    warmup and counted Adam steps (finite falling loss, B3 and B4 counts
    derived from the program), a profile of one step, crf_decoding and
    chunk_eval on a held-out batch (2 B3), run_chunk's graph replays
    bitwise against eager steps, and the card against the CPU at a
    reduced width (losses of 3 steps, Viterbi tags outside near-ties).
    Returns the counted steps' launches."""
    from paddle_tpu_torch import interop, unique_name
    from paddle_tpu_torch.kernels import lstm_cell as lc
    from paddle_tpu_torch.models import srl

    t0 = time.perf_counter()
    sizes = dict(word_dict_len=srl.WORDS, pred_dict_len=srl.PREDICATES,
                 label_dict_len=srl.LABELS)
    with unique_name.guard():
        prog, startup, _, (loss,) = srl.build_srl(mode="train", **sizes,
                                                  **SRL)
    with unique_name.guard():
        iprog, _, _, ifetch = srl.build_srl(mode="infer", **sizes, **SRL)
    fwd, bwd = recurrent_launches(prog, "lstm")
    ifwd = sum(op.type == "lstm" for op in iprog.global_block().ops)
    print("from the programs: %d B3 and %d B4 a training step (2 lstm "
          "ops, 2 lstm_grad each recomputing its forward), %d B3 a decode"
          % (fwd, bwd, ifwd))
    if (fwd, bwd, ifwd) != (4, 2, 2):
        raise AssertionError("SRL launches a step %s" % ((fwd, bwd, ifwd),))
    startup.random_seed = seed
    scope = fluid.Scope()
    exe = fluid.Executor()                      # CUDAPlace(0)
    exe.run(startup, scope=scope)
    n_params = sum(p.numel() for n, p in scope.vars.items()
                   if prog.global_block().var(n).is_parameter)
    rng = np.random.RandomState(seed)
    lens, feed = srl_batch(rng, SRL_B, sizes)
    tokens = int(lens.sum())
    print("parameters: %d (%.1f MB fp32); batch %d sentences, lengths "
          "%d..%d, %d tokens of %d padded" % (
              n_params, n_params * 4 / 1e6, SRL_B, lens.min(), lens.max(),
              tokens, SRL_B * lens.max()))
    on_card = packed_on(fluid, feed, dev)
    for i in range(SRL_WARMUP):
        exe.run(prog, feed=feed if i == 0 else on_card, fetch_list=[loss],
                scope=scope)
    torch.cuda.synchronize()
    lc.reset_launches()
    losses = []
    t1 = time.perf_counter()
    for _ in range(SRL_STEPS):
        losses.append(float(exe.run(prog, feed=on_card, fetch_list=[loss],
                                    scope=scope)[0]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = dict(lc.launches)
    want = {"lstm_fwd": fwd * SRL_STEPS, "lstm_bwd": bwd * SRL_STEPS,
            "lstm_fwd_bf16": 0, "lstm_bwd_bf16": 0}
    print("launches on path A:", json.dumps(launches), "expected",
          json.dumps(want))
    if launches != want:
        raise AssertionError("SRL launch counts %s != %s" % (launches, want))
    print("losses:", " ".join("%.6f" % v for v in losses))
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError("SRL loss not finite and falling: %s" % losses)
    step_ms = wall * 1000.0 / SRL_STEPS
    print("train: %d steps in %.3f s = %.3f ms/step, %.2f sentences/s, "
          "%.1f tokens/s" % (SRL_STEPS, wall, step_ms,
                             SRL_B / (step_ms / 1e3),
                             tokens / (step_ms / 1e3)))
    device_profile(lambda: exe.run(prog, feed=on_card, fetch_list=[loss],
                                   scope=scope),
                   1, step_ms, "SRL train step", share_of="lstm_")

    # the held-out batch: Viterbi tags and chunk_eval
    hlens, held = srl_batch(rng, SRL_B, sizes)
    lc.reset_launches()
    t1 = time.perf_counter()
    out = exe.run(iprog, feed=held, fetch_list=list(ifetch), scope=scope)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t1) * 1000.0
    if lc.launches["lstm_fwd"] != ifwd or lc.launches["lstm_bwd"]:
        raise AssertionError("decode launches %s" % lc.launches)
    tags, (prec, rec, f1, ni, nl, nc) = out[0], out[1:]
    t = np.asarray(tags.data)
    if t.shape != (SRL_B, hlens.max(), 1) or t.min() < 0 \
            or t.max() >= srl.LABELS \
            or list(tags.lengths) != list(hlens) \
            or any(t[i, n:].any() for i, n in enumerate(hlens)):
        raise AssertionError("Viterbi tags malformed: %s" % (t.shape,))
    vals = [float(prec), float(rec), float(f1)]
    if not all(0.0 <= v <= 1.0 for v in vals) or int(nc) > min(int(ni),
                                                                int(nl)):
        raise AssertionError("chunk_eval out of range: %s" % out[1:])
    print("held-out batch (%d sentences, %d tokens): decode %.3f ms (%d "
          "B3); chunk_eval IOB: precision %.6f recall %.6f F1 %.6f (%d "
          "chunks inferred, %d labelled, %d correct)" % (
              SRL_B, int(hlens.sum()), decode_ms, ifwd, *vals, int(ni),
              int(nl), int(nc)))

    # run_chunk's graph replays against eager steps
    graph_path(fluid, "SRL tagger (float32)", (prog, startup, loss),
               on_card, GRAPH_K["srl"], GRAPH_CHUNKS, seed,
               {"lstm_fwd": fwd, "lstm_bwd": bwd},
               (1e-4, RESNET_AB_PL2TOL, RESNET_AB_L2TOL))

    # the card against the CPU from the same weights at a reduced width
    xsizes = dict(sizes, **SRL_XCHECK)
    with unique_name.guard():
        xprog, xstart, _, (xloss,) = srl.build_srl(mode="train", **xsizes)
    with unique_name.guard():
        xiprog, _, _, xifetch = srl.build_srl(mode="infer", **xsizes)
    xstart.random_seed = seed
    cpu_scope, card_scope = fluid.Scope(), fluid.Scope()
    cpu = fluid.Executor(fluid.CPUPlace())
    cpu.run(xstart, scope=cpu_scope)
    interop.load_reference_state(
        {n: v.numpy() for n, v in cpu_scope.vars.items()}, card_scope,
        fluid.CUDAPlace(0), [xprog, xstart])
    _, xbatch = srl_batch(rng, SRL_XCHECK_B, xsizes)
    for step in range(SRL_XCHECK_STEPS):
        c = float(cpu.run(xprog, feed=xbatch, fetch_list=[xloss],
                          scope=cpu_scope)[0])
        k = float(exe.run(xprog, feed=xbatch, fetch_list=[xloss],
                          scope=card_scope)[0])
        print("cross-check step %d: loss cpu %.7f card %.7f" % (step, c, k))
        np.testing.assert_allclose(k, c, rtol=1e-4)
    emission = [op for op in xiprog.global_block().ops
                if op.type == "crf_decoding"][0].input("Emission")[0]
    xlens, xheld = srl_batch(rng, SRL_XCHECK_B, xsizes)
    c = cpu.run(xiprog, feed=xheld, fetch_list=[xifetch[0], emission],
                scope=cpu_scope)
    k = exe.run(xiprog, feed=xheld, fetch_list=[xifetch[0], emission],
                scope=card_scope)
    trans = cpu_scope.find_var("crfw").numpy()
    d_em = float(np.abs(np.asarray(k[1].data) - np.asarray(c[1].data)).max())
    d_tr = float(np.abs(card_scope.find_var("crfw").cpu().numpy()
                        - trans).max())
    em = np.asarray(c[1].data)
    paths, margins = viterbi_margins(em, xlens, trans)
    # a path's score moves by at most len x (d_em + d_tr) between the
    # card and the CPU, and float32 sums of len terms round by about
    # len x eps x their size against float64
    size = np.array([np.abs(em[i, :n]).max(-1).sum() + n * np.abs(
        trans).max() for i, n in enumerate(xlens)])
    tie = np.maximum(SRL_TIE, 2.0 * xlens * (d_em + d_tr)
                     + 2.0 * xlens * np.finfo(np.float32).eps * size)
    ct, kt = np.asarray(c[0].data)[:, :, 0], np.asarray(k[0].data)[:, :, 0]
    differ = [i for i in range(len(xlens)) if not np.array_equal(
        ct[i, :xlens[i]], kt[i, :xlens[i]])]
    wrong = [i for i in differ if margins[i] > tie[i]]
    ref_wrong = [i for i, n in enumerate(xlens)
                 if margins[i] > tie[i] and list(ct[i, :n]) != paths[i]]
    print("card vs cpu at %s, B %d: losses of %d steps within rtol 1e-4; "
          "Viterbi tags: %d of %d rows differ, %d of them past a near-tie "
          "(emissions differ by %.3g, transitions by %.3g; smallest path "
          "margin %.3g)" % (SRL_XCHECK, SRL_XCHECK_B, SRL_XCHECK_STEPS,
                            len(differ), len(xlens), len(differ) -
                            len(wrong), d_em, d_tr, float(margins.min())))
    if wrong or ref_wrong:
        raise AssertionError("Viterbi tags differ outside near-ties: rows "
                             "%s (card vs cpu), %s (cpu vs float64)"
                             % (wrong, ref_wrong))
    torch.cuda.synchronize()
    print("SRL phase: %.1f s" % (time.perf_counter() - t0))
    return launches


def while_program(fluid, layers, max_iters, train):
    """tests/test_control_flow.py's While RNN (h <- tanh(fc(h)) CF_T
    times) at width CF_H with a softmax classifier; ``train``: SGD (the
    while is stamped differentiable), else inference."""
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        x = layers.data("x", [CF_H])
        label = layers.data("label", [1], dtype="int64")
        i = layers.fill_constant([1], "int32", 0)
        n = layers.fill_constant([1], "int32", CF_T)
        h = layers.fc(x, CF_H, act="tanh", bias_attr=False)
        cond = layers.less_than(i, n)
        w = layers.While(cond, max_iters=max_iters)
        with w.block():
            h2 = layers.fc(h, CF_H, act="tanh", bias_attr=False)
            layers.assign(h2, output=h)
            layers.increment(i, value=1.0, in_place=True)
            layers.less_than(i, n, cond=cond)
        pred = layers.fc(h, 3, act="softmax")
        loss = layers.mean(layers.cross_entropy(pred, label))
        if train:
            fluid.optimizer.SGD(0.5).minimize(loss)
    return prog, startup, loss, i


def switch_program(fluid, layers, taken, nan):
    """tests/test_control_flow.py's conditional program at width CF_H;
    with ``nan`` the branch also adds 0 * log(0 * y): -inf in its
    forward, 0 / 0 in its gradient."""
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        x = layers.data("x", [CF_H])
        a = layers.fill_constant([1], "int32", 0 if taken else 5)
        b = layers.fill_constant([1], "int32", 3)
        cond = layers.less_than(a, b)
        y = layers.fc(x, CF_H, param_attr=fluid.ParamAttr(name="cb_w"),
                      bias_attr=False)
        sw = layers.Switch()
        with sw.case(cond):
            y2 = layers.scale(y, scale=3.0)
            if nan:
                bad = layers.log(layers.scale(y, scale=0.0))
                y2 = layers.elementwise_add(y2, layers.scale(bad, scale=0.0))
            layers.assign(y2, output=y)
        loss = layers.mean(y)
        fluid.append_backward(loss)
    return prog, startup, loss


def switch_in_while_program(fluid, layers, taken):
    """The NaN branch of switch_program(nan=True) as a Switch inside a
    While of max_iters CF_T (h <- tanh(fc(h)), then tripled, plus
    0 * log(0 * h), when taken); loss = mean(h), differentiated through
    the loop's masked steps, so the conditional's own backward selects
    its gradients."""
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        x = layers.data("x", [CF_H])
        i = layers.fill_constant([1], "int32", 0)
        n = layers.fill_constant([1], "int32", CF_T)
        a = layers.fill_constant([1], "int32", 0 if taken else 5)
        b = layers.fill_constant([1], "int32", 3)
        h = layers.fc(x, CF_H, act="tanh", bias_attr=False)
        cond = layers.less_than(i, n)
        w = layers.While(cond, max_iters=CF_T)
        with w.block():
            h2 = layers.fc(h, CF_H, act="tanh",
                           param_attr=fluid.ParamAttr(name="loop_w"),
                           bias_attr=False)
            sw = layers.Switch()
            with sw.case(layers.less_than(a, b)):
                bad = layers.log(layers.scale(h2, scale=0.0))
                layers.assign(layers.elementwise_add(
                    layers.scale(h2, scale=3.0), layers.scale(bad, scale=0.0)),
                    output=h2)
            layers.assign(h2, output=h)
            layers.increment(i, value=1.0, in_place=True)
            layers.less_than(i, n, cond=cond)
        loss = layers.mean(h)
        fluid.append_backward(loss)
    return prog, startup, loss


def dynamic_rnn_program(fluid, layers, vocab, emb, hid, lr=1e-3):
    """benchmark/fluid/stacked_dynamic_lstm.py's model: an LSTM cell
    written with Variable operators (fc gates, sigmoid/tanh, * and +)
    inside a DynamicRNN, memory(value=0.0, shape=[hid]), the last step
    pooled, a softmax over CLASSES, Adam."""
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        words = layers.data("words", [1], dtype="int64", lod_level=1)
        label = layers.data("label", [1], dtype="int64")
        sentence = layers.embedding(words, size=[vocab, emb])
        sentence = layers.fc(sentence, hid, act="tanh", num_flatten_dims=2)
        rnn = layers.DynamicRNN()
        with rnn.block():
            word = rnn.step_input(sentence)
            prev_hidden = rnn.memory(value=0.0, shape=[hid])
            prev_cell = rnn.memory(value=0.0, shape=[hid])

            def gate_common(ipt, hidden, size):
                gate0 = layers.fc(ipt, size, bias_attr=True)
                gate1 = layers.fc(hidden, size, bias_attr=False)
                return gate0 + gate1

            forget_gate = layers.sigmoid(gate_common(word, prev_hidden, hid))
            input_gate = layers.sigmoid(gate_common(word, prev_hidden, hid))
            output_gate = layers.sigmoid(gate_common(word, prev_hidden, hid))
            cell_gate = layers.tanh(gate_common(word, prev_hidden, hid))
            cell = forget_gate * prev_cell + input_gate * cell_gate
            hidden = output_gate * layers.tanh(cell)
            rnn.update_memory(prev_cell, cell)
            rnn.update_memory(prev_hidden, hidden)
            rnn.output(hidden)
        last = layers.sequence_pool(rnn(), "last")
        logit = layers.fc(last, CLASSES, act="softmax")
        loss = layers.mean(layers.cross_entropy(logit, label))
        fluid.optimizer.Adam(lr).minimize(loss)
    return prog, startup, loss


def control_flow_phase(fluid, seed, dev):
    """Path B: the While RNN trained through max_iters and run for
    inference, the Switch in both branches (and with a NaN inside the
    branch, at the top level and inside a While), the DynamicRNN operator cell at H 512: eager steps against
    run_chunk's graph replays, bitwise; a While without max_iters refuses
    the capture."""
    from paddle_tpu_torch import layers, unique_name
    from paddle_tpu_torch.data_feeder import stack_feeds

    t0 = time.perf_counter()
    bounds = (1e-4, RESNET_AB_PL2TOL, RESNET_AB_L2TOL)
    rng = np.random.RandomState(seed)
    feed = {"x": torch.from_numpy(rng.rand(CF_B, CF_H).astype(
        np.float32)).to(dev), "label": torch.from_numpy(rng.randint(
            0, 3, (CF_B, 1)).astype(np.int64)).to(dev)}
    res = {}
    for train, max_iters in ((True, CF_T), (False, CF_MAX_ITERS)):
        with unique_name.guard():
            prog, startup, loss, i = while_program(fluid, layers, max_iters,
                                                   train)
        label = "While RNN (%s, max_iters %d)" % (
            "SGD" if train else "inference", max_iters)
        res[label] = graph_path(fluid, label, (prog, startup, loss), feed,
                                GRAPH_K["control"], GRAPH_CHUNKS, seed, {},
                                bounds)
        scope = fluid.Scope()
        fluid.Executor().run(startup, scope=scope)
        n = fluid.Executor().run(prog, feed=feed, fetch_list=[i],
                                 scope=scope)[0]
        if int(n[0]) != CF_T:
            raise AssertionError("%s ran %s iterations, not %d"
                                 % (label, n, CF_T))

    # a while without max_iters reads its predicate on the host: it runs
    # eagerly and refuses a graph
    with unique_name.guard():
        prog, startup, loss, i = while_program(fluid, layers, 0, False)
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    if int(exe.run(prog, feed=feed, fetch_list=[i], scope=scope)[0][0]) \
            != CF_T:
        raise AssertionError("the unbounded while's iterations")
    try:
        exe.run_chunk(prog, feed_chunk=chunk_of(feed, 2), fetch_list=[loss],
                      scope=scope)
    except RuntimeError as e:
        if "max_iters=N" not in str(e):
            raise
        print("an unbounded While under capture raises: %s" %
              str(e).split("\n")[0][:110])
    else:
        raise AssertionError("an unbounded While was captured")

    # the Switch in both branches, and with a NaN inside the branch
    for taken in (True, False):
        with unique_name.guard():
            built = switch_program(fluid, layers, taken, False)
        res["switch_%s" % taken] = graph_path(
            fluid, "Switch (branch %s)" % ("taken" if taken else
                                            "not taken"),
            built, {"x": feed["x"]}, GRAPH_K["control"], GRAPH_CHUNKS, seed,
            {}, bounds)
        for where, build, grad in (
                ("", lambda f, l_, t: switch_program(f, l_, t, True),
                 "cb_w@GRAD"),
                (" inside a While", switch_in_while_program, "loop_w@GRAD")):
            with unique_name.guard():
                prog, startup, loss = build(fluid, layers, taken)
            startup.random_seed = seed
            scope = fluid.Scope()
            fluid.Executor().run(startup, scope=scope)
            feeds = [{"x": rng.rand(CF_B, CF_H).astype(np.float32)}
                     for _ in range(3)]
            fetch = [loss.name, grad]
            exe = fluid.Executor()
            eager = [exe.run(prog, feed=f, fetch_list=fetch, scope=scope,
                             return_numpy=False) for f in feeds]
            chunk = fluid.Executor().run_chunk(
                prog, feed_chunk=stack_feeds(feeds), fetch_list=fetch,
                scope=scope, return_numpy=False)
            for j, name in enumerate(fetch):
                want = torch.stack([e[j] for e in eager])
                if not torch.equal(torch.nan_to_num(chunk[j], nan=7.0),
                                   torch.nan_to_num(want, nan=7.0)) or \
                        bool(torch.isnan(chunk[j]).any()) != taken:
                    raise AssertionError(
                        "Switch%s with NaN in the branch (%s): %s through "
                        "the graph" % (where, "taken" if taken else
                                       "not taken", name))
            print("Switch%s with 0 * log(0 * y) in the branch, %s: the "
                  "graph's loss and %s bitwise the eager steps' (%s)" % (
                      where, "taken" if taken else "not taken", grad,
                      "NaN in both, as under lax.cond" if taken else
                      "finite: the branch not taken stays out of the "
                      "gradient"))

    # the DynamicRNN operator cell at H 512
    with unique_name.guard():
        prog, startup, loss = dynamic_rnn_program(fluid, layers, **DRNN)
    lens, words, label = stacked_lstm_batch(rng, DRNN_B, DRNN_T, MIN_LEN,
                                            DRNN["vocab"])
    dfeed = packed_on(fluid, {"words": words, "label": label}, dev)
    startup.random_seed = seed
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    exe.run(prog, feed={"words": words, "label": label}, fetch_list=[loss],
            scope=scope)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    losses = [float(exe.run(prog, feed=dfeed, fetch_list=[loss],
                            scope=scope)[0]) for _ in range(DRNN_STEPS)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t1) * 1000.0 / DRNN_STEPS
    print("DynamicRNN cell (dict %d, emb %d, H %d, batch %d, lengths "
          "%d..%d): losses %s; eager %.3f ms/step" % (
              DRNN["vocab"], DRNN["emb"], DRNN["hid"], DRNN_B, lens.min(),
              lens.max(), " ".join("%.6f" % v for v in losses), step_ms))
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError("DynamicRNN loss not finite and falling: %s"
                             % losses)
    del scope, exe
    res["drnn"] = graph_path(fluid, "DynamicRNN LSTM cell (H %d)"
                             % DRNN["hid"], (prog, startup, loss), dfeed,
                             GRAPH_K["drnn"], GRAPH_CHUNKS, seed, {}, bounds)
    torch.cuda.synchronize()
    print("control-flow phase: %.1f s" % (time.perf_counter() - t0))
    return res


def dense_cases(rng):
    """(name, op type, inputs, attrs) of phase 6f's sweep: each type of
    the dense op library at the JAX sweeps' shapes (tests/
    test_op_sweep_{math,tensor,nn,rnn_seq}.py) and at the cases where
    the obvious call computes something else (signs under mod,
    out-of-range ids, ties, wraps). A ("seq", data, lengths) input is a
    PackedSeq."""
    def f(*shape):
        return rng.randn(*shape).astype(np.float32)

    def i64(*a):
        return np.array(a, np.int64)

    def seq(data, lens):
        data = data.copy()
        for r, n in enumerate(lens):
            data[r, n:] = 0
        return ("seq", data, np.asarray(lens, np.int32))

    a = rng.rand(2, 3, 4).astype(np.float32) + 0.5
    b = rng.rand(2, 3, 4).astype(np.float32) + 0.5
    xs = (rng.rand(3, 4).astype(np.float32) - 0.5) * 4
    boxes = np.sort(rng.rand(5, 2, 2), 1).reshape(5, 4).astype(np.float32)
    cases = [
        ("max", "elementwise_max", {"X": [a], "Y": [b]}, {}),
        ("mod", "elementwise_mod", {"X": [f(4, 5) * 3], "Y": [
            np.where(rng.rand(4, 5) > 0.5, 1.0, -1.0).astype(np.float32)
            * (rng.rand(4, 5) + 0.5).astype(np.float32)]}, {}),
        ("mod_int", "elementwise_mod", {
            "X": [np.array([7, -7, 7, -7], np.int32)],
            "Y": [np.array([3, 3, -3, -3], np.int32)]}, {}),
        ("floordiv", "elementwise_floordiv",
         {"X": [f(4, 5) * 5], "Y": [f(4, 5) + 0.1]}, {})]
    for r in ("mean", "max", "min", "prod"):
        cases += [("reduce_%s" % r, "reduce_" + r, {"X": [a]},
                   {"dim": [1], "keep_dim": True}),
                  ("reduce_%s_all" % r, "reduce_" + r, {"X": [a]},
                   {"reduce_all": True})]
    cases += [
        ("l1_norm", "l1_norm", {"X": [xs]}, {}),
        ("squared_l2_norm", "squared_l2_norm", {"X": [xs]}, {}),
        ("squared_l2_distance", "squared_l2_distance",
         {"X": [f(4, 5)], "Y": [f(4, 5)]}, {}),
        ("frobenius_norm", "frobenius_norm", {"X": [a]}, {"dim": [1, 2]}),
        ("norm", "norm", {"X": [xs]}, {"axis": 1}),
        ("isfinite", "isfinite", {"X": [np.array([1.0, np.inf],
                                                 np.float32)]}, {}),
        ("cumsum", "cumsum", {"X": [a]}, {"axis": 1, "exclusive": True,
                                         "reverse": True}),
        ("label_smooth", "label_smooth", {
            "X": [np.eye(4, dtype=np.float32)[rng.randint(0, 4, 5)]],
            "PriorDist": [np.array([[0.1, 0.2, 0.3, 0.4]], np.float32)]},
         {"epsilon": 0.2}),
        ("matmul", "matmul", {"X": [f(2, 1, 3, 4)], "Y": [f(3, 5, 4)]},
         {"transpose_Y": True, "alpha": 0.5}),
        ("matmul_vec", "matmul", {"X": [f(4)], "Y": [f(4, 5)]},
         {"transpose_X": True}),
        ("dot", "dot", {"X": [f(3, 5)], "Y": [f(3, 5)]}, {}),
        ("cos_sim", "cos_sim", {"X": [f(4, 6)], "Y": [f(1, 6)]}, {}),
        ("bilinear", "bilinear_tensor_product", {
            "X": [f(3, 4)], "Y": [f(3, 5)], "Weight": [f(6, 4, 5)],
            "Bias": [f(1, 6)]}, {}),
        ("iou", "iou_similarity", {"X": [boxes], "Y": [boxes[:3]]}, {}),
        ("log_softmax", "log_softmax", {"X": [seq(f(2, 4, 5), [4, 2])]},
         {}),
        ("square_error_cost", "square_error_cost",
         {"X": [f(4, 1)], "Y": [f(4, 1)]}, {}),
        ("sequence_conv", "sequence_conv", {
            "X": [seq(f(2, 4, 2), [4, 3])], "Filter": [f(6, 4)]},
         {"contextLength": 3, "contextStart": -1}),
        ("split", "split", {"X": [a]}, {"axis": 2, "sections": [1, 3]}),
        ("reshape2", "reshape2", {"X": [a]}, {"shape": [0, -1]}),
        ("transpose2", "transpose2", {"X": [a]}, {"axis": [2, 0, 1]}),
        ("flatten", "flatten", {"X": [a]}, {"axis": 2}),
        ("expand", "expand", {"X": [a]}, {"expand_times": [2, 1, 3]}),
        ("tile", "tile", {"X": [a]}, {"repeat_times": [1, 2, 1]}),
        ("stack", "stack", {"X": [a, b]}, {"axis": 1}),
        ("unstack", "unstack", {"X": [a]}, {"axis": 1}),
        ("pad", "pad", {"X": [a]}, {"paddings": [0, 1, 1, 0, 0, 2],
                                    "pad_value": 0.5}),
        ("pad2d", "pad2d", {"X": [f(2, 3, 4, 5)]},
         {"paddings": [1, 1, 1, 1], "mode": "reflect"}),
        ("pad2d_edge", "pad2d", {"X": [f(2, 3, 4, 5)]},
         {"paddings": [2, 0, 1, 3], "mode": "edge"}),
        ("crop", "crop", {"X": [a]}, {"offsets": [1, 2, 3],
                                      "shape": [2, 2, 3]}),
        ("slice", "slice", {"X": [a]}, {"axes": [2, 1], "starts": [-3, -2],
                                        "ends": [-1, 100]}),
        ("strided_slice", "strided_slice", {"X": [a]}, {
            "axes": [2, 1], "starts": [-1, 2], "ends": [-10, 0],
            "strides": [-2, -1]}),
        ("reverse", "reverse", {"X": [a]}, {"axis": [0, 2]}),
        ("shape", "shape", {"Input": [a]}, {}),
        ("gather", "gather", {"X": [f(3, 4)], "Index": [i64(5, -1, 0, 2)]},
         {}),
        ("gather_nd", "gather_nd", {"X": [f(4, 3)], "Index": [
            i64([5, 0], [-1, 2], [2, 1])]}, {}),
        ("scatter", "scatter", {"X": [f(5, 3)], "Ids": [i64(3, 0, -1)],
                                "Updates": [f(3, 3)]}, {}),
        ("scatter_add", "scatter", {"X": [f(5, 3)], "Ids": [i64(3, 0, 3, 3)],
                                    "Updates": [f(4, 3)]},
         {"overwrite": False}),
        ("multiplex", "multiplex", {"X": [f(4, 5), f(4, 5)], "Ids": [
            np.array([[3], [-1], [0], [1]], np.int32)]}, {}),
        ("one_hot", "one_hot", {"X": [i64(1, 4, -1, 3, 0)]}, {"depth": 4}),
        ("arg_max", "arg_max", {"X": [np.array([[1, 3, 3, 0], [2, 2, 2, 2]],
                                               np.float32)]}, {}),
        ("arg_min", "arg_min", {"X": [f(3, 6)]}, {"axis": 0}),
        ("argsort", "argsort", {"X": [rng.randint(0, 3, (2, 3000))
                                      .astype(np.float32)]}, {}),
        ("unique_with_counts", "unique_with_counts",
         {"X": [i64(3, 1, 3, 2, 5, 3)]}, {}),
        ("hash", "hash", {"X": [np.array([[0], [1], [12345], [2 ** 31 - 1],
                                          [-1], [987654321]], np.int64)]},
         {"hash_size": 977, "num_hash": 3}),
        ("similarity_focus", "similarity_focus", {"X": [f(2, 3, 4, 4)]},
         {"axis": 1, "indexes": [2, 0]}),
        ("fill_zeros_like", "fill_zeros_like", {"X": [a]}, {}),
        ("minus", "minus", {"X": [a], "Y": [b]}, {}),
        ("linspace", "linspace", {}, {"start": 3.0, "stop": -2.0,
                                      "num": 11}),
        ("range", "range", {}, {"start": -3, "end": 10, "step": 3,
                                "dtype": "int32"}),
        ("row_conv", "row_conv", {"X": [seq(f(2, 4, 3), [4, 2])],
                                  "Filter": [f(3, 3)]}, {}),
    ]
    return cases


# the random ops: (type, inputs, attrs), each held to its JAX test's
# property on the card
DENSE_RANDOM = (
    ("uniform_random_batch_size_like", "Input", (6, 2),
     {"shape": [-1, 500], "min": -2.0, "max": 3.0}),
    ("truncated_gaussian_random", None, None,
     {"shape": [128, 128], "mean": 0.5, "std": 2.0}),
    ("randint", None, None, {"shape": [40, 50], "low": -3, "high": 9}),
    ("shuffle_batch", "X", (32, 2), {}),
    ("sampling_id", "X", (4000, 3), {}),
    ("random_crop", "X", (2, 3, 8, 8), {"shape": [3, 5, 5]}))


def _lower(type, ins, attrs, dev, key=0, uid=1, grad_cots=None,
           lengths=False):
    """One op's lowering on ``dev`` over numpy inputs: its outputs on the
    host (with ``lengths``, each sequence output's lengths after them),
    and (``grad_cots``, one cotangent a float output) the gradients with
    respect to its float inputs by autograd."""
    from paddle_tpu_torch import PackedSeq
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.core.lower import TraceContext

    class Op:
        def __init__(self):
            self.type, self.attrs, self.uid = type, attrs, uid
            self.inputs, self.outputs = {}, {}

    spec = registry.get(type)
    leaves = []

    def put(v, slot):
        if isinstance(v, tuple):
            d = torch.from_numpy(v[1]).to(dev)
            if grad_cots is not None and slot not in spec.nondiff_inputs:
                d.requires_grad_()
                leaves.append(d)
            return PackedSeq(d, torch.from_numpy(v[2]).to(dev))
        t = torch.from_numpy(np.array(v)).to(dev)
        if grad_cots is not None and t.is_floating_point() and \
                slot not in spec.nondiff_inputs:
            t.requires_grad_()
            leaves.append(t)
        return t

    tins = {s: [put(v, s) for v in vals] for s, vals in ins.items()}
    op = Op()
    with torch.enable_grad():
        out = registry.normalize_outputs(spec.lower(
            TraceContext(key=key, device=dev).for_op(op), tins, attrs, op))
        flat = [v.data if isinstance(v, PackedSeq) else v
                for s in sorted(out) for v in out[s] if v is not None]
        for v in flat:
            if v.device.type != dev.type:
                raise AssertionError("%s: an output on %s, not %s"
                                     % (type, v.device, dev))
        host = [v.detach().cpu().numpy() for v in flat]
        if lengths:
            host += [v.lengths.cpu().numpy() for s in sorted(out)
                     for v in out[s] if isinstance(v, PackedSeq)]
        if grad_cots is None:
            return host, None
        fl = [v for v in flat if v.is_floating_point()]
        pairs = [(v, torch.from_numpy(c).to(dev))
                 for v, c in zip(fl, grad_cots) if v.requires_grad]
        g = torch.autograd.grad([v for v, _ in pairs], leaves,
                                [c for _, c in pairs], allow_unused=True) \
            if pairs else [None] * len(leaves)
    return host, [np.zeros(x.shape, np.float32) if gi is None
                  else gi.cpu().numpy() for x, gi in zip(leaves, g)]


def _dense_close(what, got, want, amax_share=None):
    amax_share = DENSE_AMAX if amax_share is None else amax_share
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError("%s: card %s %s, cpu %s %s" % (
            what, got.shape, got.dtype, want.shape, want.dtype))
    if not np.issubdtype(want.dtype, np.floating):
        if not np.array_equal(got, want):
            raise AssertionError("%s: card and cpu differ" % what)
        return 0.0
    amax = float(np.nanmax(np.abs(want))) if want.size and \
        not np.isnan(want).all() else 0.0
    np.testing.assert_allclose(got, want, rtol=DENSE_RTOL,
                               atol=amax_share * amax, err_msg=what)
    err = np.abs(np.nan_to_num(got) - np.nan_to_num(want))
    return float(err.max() / max(amax, 1e-30)) if err.size else 0.0


def dense_sweep(dev, seed):
    """Phase 6f (a): every type on the card against the CPU."""
    from paddle_tpu_torch.core import registry

    rng = np.random.RandomState(seed)
    cpu = torch.device("cpu")
    worst, types, n_grads = 0.0, set(), 0
    for name, type, ins, attrs in dense_cases(rng):
        types.add(type)
        want, _ = _lower(type, ins, attrs, cpu)
        got, _ = _lower(type, ins, attrs, dev)
        for k, (g, w) in enumerate(zip(got, want)):
            worst = max(worst, _dense_close("%s out %d" % (name, k), g, w))
        spec = registry.get(type)
        if spec.no_grad or not any(np.issubdtype(w.dtype, np.floating)
                                   for w in want):
            continue
        cots = [np.asarray(rng.randn(*w.shape), np.float32) for w in want
                if np.issubdtype(w.dtype, np.floating)]
        _, gw = _lower(type, ins, attrs, cpu, grad_cots=cots)
        _, gg = _lower(type, ins, attrs, dev, grad_cots=cots)
        for k, (g, w) in enumerate(zip(gg, gw)):
            worst = max(worst, _dense_close("%s grad %d" % (name, k), g, w))
            n_grads += 1
    # the random ops: their JAX tests' properties, and the same bits
    # from the same (step key, op uid, seed)
    for type, slot, shape, attrs in DENSE_RANDOM:
        types.add(type)
        ins = {}
        if type == "sampling_id":
            ins = {slot: [np.tile(np.array([[0.2, 0.5, 0.3]], np.float32),
                                  (shape[0], 1))]}
        elif slot is not None:
            ins = {slot: [np.arange(np.prod(shape), dtype=np.float32)
                          .reshape(shape)]}
        out, _ = _lower(type, ins, attrs, dev, key=seed)
        again, _ = _lower(type, ins, attrs, dev, key=seed)
        other, _ = _lower(type, ins, attrs, dev, key=seed, uid=2)
        if any(not np.array_equal(x, y) for x, y in zip(out, again)) or \
                np.array_equal(out[0], other[0]):
            raise AssertionError("%s: not a function of its stream" % type)
        v = out[0]
        if type == "uniform_random_batch_size_like":
            ok = v.shape == (6, 500) and v.min() >= -2.0 and v.max() < 3.0 \
                and abs(v.mean() - 0.5) < 0.1
        elif type == "truncated_gaussian_random":
            z = (v - 0.5) / 2.0
            ok = np.abs(z).max() <= 2.0 + 1e-6 and abs(z.mean()) < 0.03 \
                and abs(z.std() - 0.8796) < 0.02
        elif type == "randint":
            ok = v.dtype == np.int32 and v.min() == -3 and v.max() == 8
        elif type == "shuffle_batch":
            idx = out[1]
            ok = sorted(idx.tolist()) == list(range(32)) and \
                np.array_equal(v, ins["X"][0][idx])
        elif type == "sampling_id":
            freq = np.bincount(v, minlength=3) / v.size
            ok = np.abs(freq - [0.2, 0.5, 0.3]).max() < 0.03
        else:
            x = ins["X"][0]
            ok = v.shape == (2, 3, 5, 5) and sum(
                np.array_equal(v, x[:, :, i:i + 5, j:j + 5])
                for i in range(4) for j in range(4)) == 1
        if not ok:
            raise AssertionError("%s: the property fails on the card" % type)
    if len(types) != 60:
        raise AssertionError("the sweep covers %d types" % len(types))
    print("dense sweep: %d types on the card against the CPU, %d gradients; "
          "integer results exact, the worst float %.3g x max|ref| (bound "
          "rtol %g + %g x max|ref|); 6 random ops at their properties, "
          "the same bits from the same stream"
          % (len(types), n_grads, worst, DENSE_RTOL, DENSE_AMAX))
    return worst


def random_ops_program(fluid, layers):
    """The six random ops in one program, their outputs fetched."""
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        x = layers.data("x", [2])
        probs = layers.data("probs", [3])
        img = layers.data("img", [3, 8, 8])
        outs = [layers.uniform_random_batch_size_like(x, [-1, 50]),
                layers.sampling_id(probs),
                layers.random_crop(img, [3, 5, 5])]
        block = prog.global_block()
        for name, type, attrs in (
                ("tg", "truncated_gaussian_random", {"shape": [16, 16]}),
                ("ri", "randint", {"shape": [8, 8], "low": 0, "high": 9})):
            block.create_var(name=name, shape=attrs["shape"],
                             dtype="float32" if name == "tg" else "int32")
            block.append_op(type, {}, {"Out": [name]}, attrs)
            outs.append(block.var(name))
        sb = block.create_var(name="sb", shape=[-1, 2], dtype="float32")
        block.create_var(name="sb_idx", shape=[-1], dtype="int32")
        block.append_op("shuffle_batch", {"X": [x.name]},
                        {"Out": ["sb"], "ShuffleIdx": ["sb_idx"]}, {})
        outs.append(sb)
    return prog, startup, outs


def random_graphs(fluid, seed, dev):
    """Phase 6f (a): the random ops through run_chunk's graph replays
    bitwise against eager run() steps."""
    from paddle_tpu_torch import layers, unique_name

    with unique_name.guard():
        prog, startup, outs = random_ops_program(fluid, layers)
    startup.random_seed = prog.random_seed = seed
    rng = np.random.RandomState(seed)
    feed = {"x": torch.from_numpy(rng.rand(32, 2).astype(np.float32)).to(dev),
            "probs": torch.from_numpy(np.tile(np.array(
                [[0.2, 0.5, 0.3]], np.float32), (64, 1))).to(dev),
            "img": torch.from_numpy(rng.rand(2, 3, 8, 8).astype(
                np.float32)).to(dev)}
    k = GRAPH_K["book"]
    names = [v.name for v in outs]
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    exe._step = 1
    eager = [exe.run(prog, feed=feed, fetch_list=names, scope=scope)
             for _ in range(k * GRAPH_CHUNKS)]
    exe = fluid.Executor()
    chunks = [exe.run_chunk(prog, feed_chunk=chunk_of(feed, k), k=k,
                            fetch_list=names, scope=scope,
                            step0=1 if c == 0 else None)
              for c in range(GRAPH_CHUNKS)]
    for j, n in enumerate(names):
        want = np.stack([e[j] for e in eager])
        got = np.concatenate([c[j] for c in chunks])
        if not np.array_equal(got, want):
            raise AssertionError("random op %s: graph replays differ from "
                                 "eager steps" % n)
        if np.array_equal(want[0], want[1]):
            raise AssertionError("random op %s drew the same at two steps"
                                 % n)
    print("random ops through run_chunk (K=%d x %d chunks): %d outputs "
          "bitwise equal to eager steps, each step's draw its own"
          % (k, GRAPH_CHUNKS, len(names)))


def book_build(fluid, which):
    """tests/test_book.py's fit_a_line (:166-174) or recommender
    (:236-262) program, at the widths of FIT_* and REC."""
    from paddle_tpu_torch import layers, nets

    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        if which == "fit_a_line":
            x = layers.data("x", [13])
            y = layers.data("y", [1])
            loss = layers.mean(layers.square_error_cost(layers.fc(x, 1), y))
            fluid.optimizer.SGD(FIT_LR).minimize(loss)
            return prog, startup, None, (loss,)
        r = REC
        ids = {n: layers.data(n, [1], dtype="int64")
               for n in ("uid", "gender", "age", "mid")}
        usr = layers.fc(layers.concat([
            layers.embedding(ids["uid"], size=[r["users"], r["id_emb"]]),
            layers.embedding(ids["gender"],
                             size=[r["genders"], r["small_emb"]]),
            layers.embedding(ids["age"], size=[r["ages"], r["small_emb"]])],
            axis=1), r["fc"], act="tanh")
        title = layers.data("title", [1], dtype="int64", lod_level=1)
        tfeat = nets.sequence_conv_pool(
            layers.embedding(title, size=[r["title_vocab"], r["id_emb"]]),
            num_filters=r["filters"], filter_size=r["filter_size"],
            act="tanh", pool_type="sum")
        mov = layers.fc(layers.concat([
            layers.embedding(ids["mid"], size=[r["movies"], r["id_emb"]]),
            tfeat], axis=1), r["fc"], act="tanh")
        sim = layers.scale(layers.cos_sim(usr, mov), scale=5.0)
        rating = layers.data("rating", [1])
        loss = layers.mean(layers.square_error_cost(sim, rating))
        fluid.optimizer.SGD(r["lr"]).minimize(loss)
    return prog, startup, None, (loss,)


def book_feed(rng, which):
    """A batch at the program's widths: uci_housing's 13 features and a
    linear price, or movielens rows (ids over the tables, ratings 1..5,
    titles of REC_TITLE ids)."""
    if which == "fit_a_line":
        x = rng.rand(FIT_B, 13).astype(np.float32)
        return {"x": x, "y": (x @ rng.rand(13, 1)).astype(np.float32)}
    r = REC
    out = {n: rng.randint(0, r[t], (REC_B, 1)).astype(np.int64)
           for n, t in (("uid", "users"), ("gender", "genders"),
                        ("age", "ages"), ("mid", "movies"))}
    out["title"] = [rng.randint(0, r["title_vocab"], (int(n), 1))
                    .astype(np.int64)
                    for n in rng.randint(REC_TITLE[0], REC_TITLE[1] + 1,
                                         REC_B)]
    out["rating"] = rng.randint(1, 6, (REC_B, 1)).astype(np.float32)
    return out


def book_phase(fluid, seed, dev):
    """Phase 6f (b): fit_a_line and the recommender trained eagerly and
    through run_chunk's graphs (bitwise), and the card against the CPU
    from the same weights."""
    from paddle_tpu_torch import unique_name

    bounds = (1e-4, RESNET_AB_PL2TOL, RESNET_AB_L2TOL)
    res = {}
    for which in ("fit_a_line", "recommender"):
        feed = book_feed(np.random.RandomState(seed), which)
        on_card = packed_on(fluid, feed, dev)
        with unique_name.guard():
            prog, startup, _, (loss,) = book_build(fluid, which)
        startup.random_seed = seed
        scope = fluid.Scope()
        exe = fluid.Executor()
        exe.run(startup, scope=scope)
        exe.run(prog, feed=on_card, fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses = [float(exe.run(prog, feed=on_card, fetch_list=[loss],
                                scope=scope)[0]) for _ in range(BOOK_STEPS)]
        step_ms = (time.perf_counter() - t1) * 1000.0 / BOOK_STEPS
        print("%s: losses %s; eager %.3f ms/step (with the loss's host "
              "read)" % (which, " ".join("%.6f" % v for v in losses),
                         step_ms))
        if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
            raise AssertionError("%s: loss not finite and falling: %s"
                                 % (which, losses))
        del scope, exe
        res[which] = graph_path(fluid, which, (prog, startup, loss),
                                on_card, GRAPH_K["book"], GRAPH_CHUNKS, seed,
                                {}, bounds)
        cross_check(fluid, fluid.Executor(),
                    lambda w=which: book_build(fluid, w), seed, feed, 3,
                    which, gtol=1e-4, ltol=1e-4)
    return res


def device_ops(fn):
    """(device busy ms, kernel count) of one call of ``fn``, from
    torch.profiler; (None, 0) if it recorded no device event."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if str(e.device_type).endswith("CUDA")]
    if not ev:
        return None, 0
    return sum(e.time_range.elapsed_us() for e in ev) / 1000.0, len(ev)


def sdpa_build(fluid, fused):
    """q, k, v parameters [B, T, D] and a loss sum(out * r): ``out`` from
    nets.scaled_dot_product_attention (matmul, softmax, matmul) or from
    the fused_attention op over the same heads (B1, not causal)."""
    from paddle_tpu_torch import layers, nets

    b, t, d, h = SDPA["b"], SDPA["t"], SDPA["d"], SDPA["heads"]
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        q, k, v = (layers.create_parameter(
            [b, t, d], "float32", attr=fluid.ParamAttr(name=n))
            for n in ("q", "k", "v"))
        r = layers.data("r", [t, d])
        if fused:
            def heads(x):
                return layers.transpose(layers.reshape(x, [0, 0, h, d // h]),
                                        [0, 2, 1, 3])
            o = layers.flash_attention(heads(q), heads(k), heads(v),
                                       causal=False)
            out = layers.reshape(layers.transpose(o, [0, 2, 1, 3]),
                                 [0, 0, d])
        else:
            out = nets.scaled_dot_product_attention(q, k, v, num_heads=h)
        loss = layers.reduce_sum(layers.elementwise_mul(out, r))
        fluid.append_backward(loss)
    return prog, out


def sdpa_phase(fluid, seed, dev):
    """Phase 6f (c): nets.scaled_dot_product_attention against the
    fused_attention op (float32 B1) on the same q, k, v: outputs and
    the gradients with respect to q, k and v, B1's launches from the
    program, each call's time. Returns B1's launches."""
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.kernels import flash_attention as fa

    b, t, d = SDPA["b"], SDPA["t"], SDPA["d"]
    g = torch.Generator(device="cpu").manual_seed(seed)
    vals = {n: torch.randn(b, t, d, generator=g).to(dev)
            for n in ("q", "k", "v")}
    feed = {"r": torch.randn(b, t, d, generator=g).to(dev)}
    res, timing = {}, {}
    for fused in (False, True):
        with unique_name.guard():
            prog, out = sdpa_build(fluid, fused)
        scope = fluid.Scope()
        for n, v in vals.items():
            scope.set_var(n, v.clone())
        exe = fluid.Executor()
        fetch = [out.name, "q@GRAD", "k@GRAD", "v@GRAD"]

        def call():
            return exe.run(prog, feed=feed, fetch_list=fetch, scope=scope,
                           return_numpy=False)
        reset_all_launches()
        res[fused] = call()
        torch.cuda.synchronize()
        got = all_launches()
        fwd, grad, _ = attention_launches(prog)
        want = {"flash_attention": fwd + grad} if fused else {}
        if {n: c for n, c in got.items() if c} != want:
            raise AssertionError("attention %s: launches %s, from the "
                                 "program %s" % ("B1" if fused else "nets",
                                                 got, want))
        if fused:
            launched = got["flash_attention"]
        walls = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1000.0)
        busy, n_ops = device_ops(call)
        timing[fused] = (float(np.median(walls[1:])), busy, n_ops)
        label = "fused_attention (float32 B1)" if fused else \
            "nets.scaled_dot_product_attention"
        print("%s, forward and backward at batch %d, seq %d, d_model %d, "
              "%d heads: %.3f ms a call (host, median of 5), device busy "
              "%s ms in %d device ops; B1 launches %d (program: %d "
              "forward + %d in the grad)" % (
                  label, b, t, d, SDPA["heads"], timing[fused][0],
                  "%.3f" % busy if busy is not None else "not measured",
                  n_ops, got["flash_attention"], fwd if fused else 0,
                  grad if fused else 0))
        del scope, exe
    for j, name in enumerate(("out", "dq", "dk", "dv")):
        ref, ker = res[False][j], res[True][j]
        e = float((ker - ref).abs().max() / ref.abs().max())
        tol = SDPA_OUT_TOL if j == 0 else SDPA_GRAD_TOL
        print("B1 against the nets composition, %s: max|diff| %.3g x "
              "max|ref| (bound %g)" % (name, e, tol))
        if not bool(torch.isfinite(ker).all()) or e > tol:
            raise AssertionError("attention %s: B1 and the nets "
                                 "composition differ by %.3g x max" % (name,
                                                                       e))
    print("attention: the nets composition takes %.2fx B1's host ms a call "
          "and %s its device busy ms (card: %s)" % (
              timing[False][0] / timing[True][0],
              "%.2fx" % (timing[False][1] / timing[True][1])
              if timing[True][1] and timing[False][1] else "not measured",
              card_line()))
    torch.cuda.empty_cache()
    return launched


def dense_phase(fluid, seed, dev):
    """Phase 6f: the dense op library on the card. Returns B1's
    launches."""
    t0 = time.perf_counter()
    dense_sweep(dev, seed)
    random_graphs(fluid, seed, dev)
    book_phase(fluid, seed, dev)
    launched = sdpa_phase(fluid, seed, dev)
    torch.cuda.synchronize()
    print("dense phase: %.1f s" % (time.perf_counter() - t0))
    return launched


# ---- phase 6g: the vision and detection families, word2vec, SSD300 ----

def w2v_body(fluid, dict_size, emb, hid, is_sparse=False, lr=None,
             head="softmax"):
    """tests/test_book.py:198-233's word2vec n-gram model, appended to the
    current program through ``fluid``'s layers (either package): four
    context words SHARING one embedding table, concat, a sigmoid hidden
    layer, a softmax over the dictionary, cross entropy against the next
    word, SGD. ``head`` "hsigmoid" or "nce" puts ``layers.hsigmoid`` or
    ``layers.nce`` over the dictionary in the softmax's place, as
    PaddlePaddle/models' hsigmoid and nce_cost n-gram examples do; their
    cost is the prediction. Returns (prediction, loss)."""
    layers = fluid.layers
    emb_attr = fluid.ParamAttr(name="shared_w")
    words = [layers.data("w%d" % i, [1], dtype="int64") for i in range(4)]
    embs = [layers.embedding(w, size=[dict_size, emb], is_sparse=is_sparse,
                             param_attr=emb_attr) for w in words]
    hidden = layers.fc(layers.concat(embs, axis=1), hid, act="sigmoid")
    nxt = layers.data("next", [1], dtype="int64")
    if head == "softmax":
        predict = layers.fc(hidden, dict_size, act="softmax")
        cost = layers.cross_entropy(predict, nxt)
    elif head == "hsigmoid":
        predict = cost = layers.hsigmoid(hidden, nxt, dict_size)
    else:
        predict = cost = layers.nce(hidden, nxt, dict_size)
    loss = layers.mean(cost)
    fluid.optimizer.SGD(lr or BOOK_W2V["lr"]).minimize(loss)
    return predict, loss


def w2v_build(fluid, is_sparse=False, head="softmax"):
    """The word2vec program at BOOK_W2V's widths."""
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        predict, loss = w2v_body(fluid, BOOK_W2V["dict_size"],
                                 BOOK_W2V["emb"], BOOK_W2V["hid"],
                                 is_sparse, head=head)
    return prog, startup, predict, (loss,)


def w2v_feed(rng, batch, dict_size):
    out = {"w%d" % i: rng.randint(0, dict_size, (batch, 1)).astype(np.int64)
           for i in range(4)}
    out["next"] = rng.randint(0, dict_size, (batch, 1)).astype(np.int64)
    return out


def ssd_build(fluid, size=300, div=1, maps=6, classes=21, gt=8, lr=1e-3,
              config="A", neg_pos_ratio=3.0):
    """SSD300 (SSD's constants above) through ``fluid``'s layers (either
    package), at an input of ``size`` pixels, every trunk, extra and head
    width divided by ``div``, and the first ``maps`` of the six source
    maps; the prior sizes scale with ``size / 300``. The trunk is VGG-16
    built as the repo's VGG-16 builds its blocks (conv, batch norm,
    relu), with what SSD changes: pool3 in ceil mode (75 -> 38), pool5
    3x3 stride 1, fc6 a 3x3 conv of 1024 at dilation 6 and fc7 a 1x1
    conv of 1024; the extras are 1x1 then 3x3 convs, stride 2 for the
    10 and 5 maps, unpadded for the 3 and 1 maps. Every source map gets
    3x3 conv heads for its priors' offsets and class logits, turned to
    [B, priors, 4] and [B, priors, classes]; ssd_loss at overlap 0.5 and
    neg_pos_ratio 3, its mean under Momentum 0.9. Config "A" attaches
    the NHWC layout and reduction passes, as ResNet-50's config A does:
    every batch_norm_grad then launches B7.

    Returns (program, startup, (loc, conf, priors, variances), (loss,))."""
    layers = fluid.layers
    det = layers.detection
    scale = size / 300.0
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        img = layers.data("img", [3, size, size])
        gt_box = layers.data("gt_box", [gt, 4])
        gt_label = layers.data("gt_label", [gt, 1], dtype="int64")

        def cbr(x, n, k, stride=1, pad=0, dil=1):
            y = layers.conv2d(x, max(n // div, 1), k, stride=stride,
                              padding=pad, dilation=dil)
            return layers.batch_norm(y, act="relu")

        def block(x, n, reps):
            for _ in range(reps):
                x = cbr(x, n, 3, pad=1)
            return x

        x = layers.pool2d(block(img, 64, 2), 2, pool_stride=2)
        x = layers.pool2d(block(x, 128, 2), 2, pool_stride=2)
        x = layers.pool2d(block(x, 256, 3), 2, pool_stride=2,
                          ceil_mode=True)
        sources = [block(x, 512, 3)]                         # conv4_3
        x = layers.pool2d(sources[0], 2, pool_stride=2)
        x = layers.pool2d(block(x, 512, 3), 3, pool_stride=1,
                          pool_padding=1)                    # pool5
        x = cbr(x, 1024, 3, pad=6, dil=6)                    # fc6
        sources.append(cbr(x, 1024, 1))                      # fc7
        x = sources[-1]
        for mid, out, stride, pad in ((256, 512, 2, 1), (128, 256, 2, 1),
                                      (128, 256, 1, 0),
                                      (128, 256, 1, 0))[:max(maps - 2, 0)]:
            x = cbr(cbr(x, mid, 1), out, 3, stride=stride, pad=pad)
            sources.append(x)
        locs, confs, boxes, variances = [], [], [], []
        for i, src in enumerate(sources[:maps]):
            box, var = det.prior_box(
                src, img, min_sizes=[SSD_MIN[i] * scale],
                max_sizes=[SSD_MAX[i] * scale], aspect_ratios=SSD_AR[i],
                variance=(0.1, 0.1, 0.2, 0.2), flip=True)
            p = 2 + 2 * len(SSD_AR[i])
            for n, out in ((4, locs), (classes, confs)):
                h = layers.conv2d(src, n * p, 3, padding=1)
                out.append(layers.reshape(
                    layers.transpose(h, [0, 2, 3, 1]), [0, -1, n]))
            boxes.append(layers.reshape(box, [-1, 4]))
            variances.append(layers.reshape(var, [-1, 4]))
        loc = layers.concat(locs, axis=1)
        conf = layers.concat(confs, axis=1)
        prior = layers.concat(boxes, axis=0)
        prior_var = layers.concat(variances, axis=0)
        loss = layers.mean(det.ssd_loss(loc, conf, gt_box, gt_label, prior,
                                        prior_var, overlap_threshold=0.5,
                                        neg_pos_ratio=neg_pos_ratio))
        fluid.optimizer.Momentum(lr, 0.9).minimize(loss)
    if config == "A":
        fluid.passes.enable(prog, layout="NHWC", pallas_reductions=True)
    return prog, startup, (loc, conf, prior, prior_var), (loss,)


def ssd_eval_program(fluid, prog, heads, nms=None):
    """The trained program cut to its heads for inference (a
    ``clone(for_test=True)`` without the loss, the backward and the
    optimizer: ``io.get_inference_program``) with SSD300's detection
    output (the logits' softmax, the offsets decoded against the priors,
    multiclass NMS at ``nms``, SSD_NMS by default) and its mAP at
    overlap 0.5 against a ground-truth feed ``gt`` [G, 5] rows of
    (label, box). A run feeds ``img`` and ``gt``. Returns (program,
    detections, mAP)."""
    layers = fluid.layers
    test = fluid.io.get_inference_program(list(heads), main_program=prog)
    block = test.global_block()
    loc, conf, prior, prior_var = (block.var(v.name) for v in heads)
    with fluid.program_guard(test, fluid.Program()):
        scores = layers.softmax(conf)
        dets = layers.detection.detection_output(
            loc, scores, prior, prior_var, **(nms or SSD_NMS))
        gt = layers.data("gt", [int(prog.global_block().var(
            "gt_box").shape[1]), 5])
        m = layers.detection.detection_map(dets, gt, overlap_threshold=0.5)
    return test, dets, m


def ssd_feed(rng, batch, size=300, gt=8, classes=21):
    """A synthetic batch: images N(0, 1), ``gt`` boxes an image (sides
    0.1..0.6 of the image, anywhere inside it), labels 1..classes-1, no
    padding rows; ``gt`` is the same boxes as detection_map's (label,
    box) rows."""
    img = rng.randn(batch, 3, size, size).astype(np.float32)
    wh = rng.uniform(0.1, 0.6, (batch, gt, 2))
    xy = rng.uniform(0, 1, (batch, gt, 2)) * (1 - wh)
    box = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    label = rng.randint(1, classes, (batch, gt, 1)).astype(np.int64)
    return {"img": img, "gt_box": box, "gt_label": label,
            "gt": np.concatenate([label.astype(np.float32), box], -1)}


def vision_cases(rng):
    """(name, op type, inputs, attrs) of phase 6g's sweep: each of the 21
    vision and detection types at the JAX sweeps' shapes
    (tests/test_op_sweep_{nn,tensor}.py, tests/test_detection.py) and
    the tie and edge cases of tests/test_torch_{vision_ops,detection}.py,
    plus one large shape for each conv-like type (a decoder's stride-2
    conv2d_transpose [32, 512, 19, 19] -> [32, 256, 38, 38], so cuDNN
    picks its real algorithms) and the detection types at SSD300's
    sizes. A ("seq", data, lengths) input is a PackedSeq."""
    def f(*shape):
        return rng.randn(*shape).astype(np.float32)

    def boxes(*lead):
        a = np.sort(rng.rand(*lead, 2, 2), -2)
        return np.concatenate([a[..., 0, :], a[..., 1, :]], -1).astype(
            np.float32)

    def seq(data, lens):
        data = data.copy()
        for r, n in enumerate(lens):
            data[r, n:] = 0
        return ("seq", data, np.asarray(lens, np.int32))

    def ssd_loss_ins(b, m, c, g, ties=False):
        prior = boxes(m)
        gt = prior[rng.randint(0, m, (b, g))] + f(b, g, 4) * 0.02
        gt[-1, -1] = 0.0
        conf = f(b, m, c)
        if ties:
            conf[:, ::2] = 0.5
        return {"Loc": [f(b, m, 4) * 0.2], "Conf": [conf], "GTBox": [gt],
                "GTLabel": [rng.randint(1, c, (b, g, 1)).astype(np.int32)],
                "PriorBox": [prior],
                "PriorBoxVar": [np.array([.1, .1, .2, .2], np.float32)]}

    def det_rows(b, d, g):
        gtb = boxes(b, g)
        gl = rng.randint(1, 4, (b, g, 1)).astype(np.float32)
        pick = rng.randint(0, g, (b, d))
        near = np.take_along_axis(gtb, pick[..., None], 1) + f(b, d, 4) * .03
        far = rng.rand(b, d, 1) < 0.3
        return (np.concatenate([np.take_along_axis(gl, pick[..., None], 1),
                                np.round(rng.rand(b, d, 1), 1),
                                np.where(far, boxes(b, d), near)], -1)
                .astype(np.float32),
                np.concatenate([gl, gtb], -1).astype(np.float32))

    prior_attrs = {"min_sizes": [8.0], "max_sizes": [16.0],
                   "aspect_ratios": [2.0], "flip": True, "clip": True,
                   "variances": [0.1, 0.1, 0.2, 0.2], "step_w": 0.0,
                   "step_h": 0.0, "offset": 0.5}
    det, gt = det_rows(3, 12, 5)
    sdet, sgt = det_rows(SSD_B, SSD_NMS["keep_top_k"], SSD["gt"])
    pool_in = f(32, 64, 56, 56)
    return [
        ("conv3d", "conv3d", {"Input": [f(1, 2, 5, 5, 5)],
                              "Filter": [f(3, 2, 3, 3, 3)]},
         {"strides": [1, 1, 1], "paddings": [0, 0, 0]}),
        ("conv3d_groups_dilated", "conv3d",
         {"Input": [f(2, 4, 5, 6, 5)], "Filter": [f(4, 2, 3, 3, 3)]},
         {"strides": [2, 1, 1], "paddings": [1, 1, 0],
          "dilations": [1, 2, 1], "groups": 2}),
        ("conv3d_large", "conv3d", {"Input": [f(8, 64, 16, 32, 32)],
                                    "Filter": [f(64, 64, 3, 3, 3) * 0.05]},
         {"strides": [1, 1, 1], "paddings": [1, 1, 1]}),
        ("conv2d_transpose", "conv2d_transpose",
         {"Input": [f(1, 2, 4, 4)], "Filter": [f(2, 3, 3, 3)]},
         {"strides": [2, 2], "paddings": [1, 1]}),
        ("conv2d_transpose_groups_dilated", "conv2d_transpose",
         {"Input": [f(2, 4, 5, 4)], "Filter": [f(4, 3, 3, 2)]},
         {"strides": [2, 1], "paddings": [0, 1], "dilations": [2, 1],
          "groups": 2}),
        ("conv2d_transpose_large", "conv2d_transpose",
         {"Input": [f(32, 512, 19, 19)], "Filter": [f(512, 256, 4, 4) * .02]},
         {"strides": [2, 2], "paddings": [1, 1]}),
        ("conv3d_transpose_output_size", "conv3d_transpose",
         {"Input": [f(1, 2, 3, 3, 3)], "Filter": [f(2, 3, 3, 3, 3)]},
         {"strides": [2, 2, 2], "paddings": [1, 1, 1],
          "output_size": [6, 7, 5]}),
        ("conv3d_transpose_groups", "conv3d_transpose",
         {"Input": [f(1, 4, 3, 3, 3)], "Filter": [f(4, 2, 2, 3, 3)]},
         {"strides": [2, 1, 2], "paddings": [0, 1, 0], "groups": 2,
          "dilations": [1, 2, 1]}),
        ("conv3d_transpose_large", "conv3d_transpose",
         {"Input": [f(8, 64, 8, 16, 16)], "Filter": [f(64, 32, 4, 4, 4) * .05]},
         {"strides": [2, 2, 2], "paddings": [1, 1, 1]}),
        ("pool3d_max_ceil", "pool3d", {"X": [f(2, 2, 5, 6, 5)]},
         {"pooling_type": "max", "ksize": [2, 3, 2], "strides": [2, 2, 2],
          "paddings": [1, 0, 1], "ceil_mode": True}),
        ("pool3d_avg", "pool3d", {"X": [f(2, 2, 5, 6, 5)]},
         {"pooling_type": "avg", "ksize": [2, 3, 2], "strides": [2, 2, 2],
          "paddings": [1, 1, 0]}),
        ("pool3d_avg_inclusive", "pool3d", {"X": [f(2, 2, 5, 6, 5)]},
         {"pooling_type": "avg", "ksize": [2, 2, 2], "strides": [2, 2, 2],
          "paddings": [1, 1, 0], "exclusive": False}),
        ("pool3d_large", "pool3d", {"X": [f(8, 64, 16, 32, 32)]},
         {"pooling_type": "max", "ksize": [2, 2, 2], "strides": [2, 2, 2]}),
        ("pool2d_with_index", "pool2d_with_index", {"X": [f(2, 2, 6, 6)]},
         {"ksize": [2, 2], "strides": [2, 2]}),
        ("pool2d_with_index_negative_padded", "pool2d_with_index",
         {"X": [np.full((1, 1, 4, 4), -5.0, np.float32)]},
         {"ksize": [2, 2], "strides": [2, 2], "paddings": [1, 1]}),
        ("pool2d_with_index_large", "pool2d_with_index", {"X": [pool_in]},
         {"ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1]}),
        ("max_pool3d_with_index", "max_pool3d_with_index",
         {"X": [f(1, 2, 5, 6, 4)]},
         {"ksize": [2, 3, 2], "strides": [2, 2, 1], "paddings": [1, 1, 0]}),
        ("max_pool3d_with_index_large", "max_pool3d_with_index",
         {"X": [f(8, 32, 16, 32, 32)]}, {"ksize": [2, 2, 2],
                                         "strides": [2, 2, 2]}),
        ("unpool", "unpool", {"X": [f(2, 2, 3, 3)], "Indices": [
            rng.randint(0, 36, (2, 2, 3, 3)).astype(np.int32)]},
         {"ksize": [2, 2], "strides": [2, 2]}),
        ("unpool_duplicates", "unpool", {"X": [f(1, 1, 2, 2)], "Indices": [
            np.array([[[[3, 3], [3, 0]]]], np.int32)]},
         {"ksize": [2, 2], "strides": [2, 2]}),
        ("unpool_large", "unpool", {"X": [f(32, 64, 28, 28)], "Indices": [
            (np.arange(28)[:, None] * 112 + np.arange(28)[None, :] * 2
             + rng.randint(0, 2, (32, 64, 28, 28))
             + 56 * rng.randint(0, 2, (32, 64, 28, 28))).astype(np.int32)]},
         {"ksize": [2, 2], "strides": [2, 2]}),
        ("spp_max", "spp", {"X": [f(2, 3, 7, 5)]},
         {"pyramid_height": 3, "pooling_type": "max"}),
        ("spp_avg", "spp", {"X": [f(32, 256, 13, 13)]},
         {"pyramid_height": 3, "pooling_type": "avg"}),
        ("im2sequence", "im2sequence", {"X": [f(1, 2, 4, 4)]},
         {"kernels": [2, 2], "strides": [2, 2]}),
        ("im2sequence_large", "im2sequence", {"X": [f(32, 64, 32, 32)]},
         {"kernels": [3, 3], "strides": [1, 1]}),
        ("resize_nearest", "resize_nearest", {"X": [f(2, 2, 5, 3)]},
         {"out_h": 7, "out_w": 8}),
        ("resize_nearest_large", "resize_nearest",
         {"X": [f(32, 256, 19, 19)]}, {"out_h": 38, "out_w": 38}),
        ("resize_bilinear", "resize_bilinear", {"X": [f(1, 2, 4, 4)]},
         {"out_h": 8, "out_w": 8}),
        ("resize_bilinear_shrink", "resize_bilinear", {"X": [f(2, 3, 9, 7)]},
         {"out_h": 4, "out_w": 11}),
        ("resize_bilinear_large", "resize_bilinear",
         {"X": [f(32, 256, 19, 19)]}, {"out_h": 38, "out_w": 38}),
        ("grid_sampler", "grid_sampler", {"X": [f(2, 3, 5, 6)], "Grid": [
            (rng.rand(2, 4, 3, 2) * 2.4 - 1.2).astype(np.float32)]}, {}),
        ("grid_sampler_large", "grid_sampler", {"X": [f(32, 64, 38, 38)],
                                                "Grid": [(rng.rand(
            32, 38, 38, 2) * 2.2 - 1.1).astype(np.float32)]}, {}),
        ("roi_pool", "roi_pool", {
            "X": [np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4)],
            "ROIs": [np.array([[0, 0, 0, 3, 3]], np.float32)]},
         {"pooled_height": 2, "pooled_width": 2, "spatial_scale": 1.0}),
        ("roi_pool_scaled", "roi_pool", {"X": [f(2, 3, 12, 10)], "ROIs": [
            np.array([[0, 1, 2, 7, 9], [1, 0, 0, 9, 11],
                      [1, 3.4, 2.6, 5.5, 4.5]], np.float32)]},
         {"pooled_height": 3, "pooled_width": 2, "spatial_scale": 0.8}),
        ("prior_box", "prior_box", {
            "Input": [np.zeros((1, 8, 4, 4), np.float32)],
            "Image": [np.zeros((1, 3, 32, 32), np.float32)]}, prior_attrs),
        ("prior_box_ssd300_conv4_3", "prior_box", {
            "Input": [np.zeros((1, 8, 38, 38), np.float32)],
            "Image": [np.zeros((1, 3, 300, 300), np.float32)]},
         dict(prior_attrs, min_sizes=[30.0], max_sizes=[60.0], clip=False)),
        ("box_coder_encode", "box_coder", {
            "PriorBox": [boxes(5)],
            "PriorBoxVar": [np.full((5, 4), 0.1, np.float32)],
            "TargetBox": [boxes(3)]}, {"code_type": "encode_center_size"}),
        ("box_coder_decode_ssd300", "box_coder", {
            "PriorBox": [boxes(SSD_PRIORS)],
            "PriorBoxVar": [np.array([.1, .1, .2, .2], np.float32)],
            "TargetBox": [f(SSD_B, SSD_PRIORS, 4) * 0.3]},
         {"code_type": "decode_center_size"}),
        ("bipartite_match", "bipartite_match", {"DistMat": [np.array(
            [[0.9, 0.4, 0.1], [0.8, 0.7, 0.2]], np.float32)]}, {}),
        ("bipartite_match_ties_per_prediction", "bipartite_match",
         {"DistMat": [np.round(rng.rand(2, 5, 6), 1).astype(np.float32)]},
         {"match_type": "per_prediction", "dist_threshold": 0.5}),
        ("bipartite_match_ssd300", "bipartite_match",
         {"DistMat": [rng.rand(SSD_B, SSD["gt"], SSD_PRIORS).astype(
             np.float32)]}, {}),
        ("target_assign", "target_assign", {
            "X": [np.arange(12, dtype=np.float32).reshape(1, 3, 4)],
            "MatchIndices": [np.array([[1, -1, 2, 0]], np.int32)]},
         {"mismatch_value": -9}),
        ("target_assign_packed", "target_assign", {
            "X": [seq(f(2, 4, 3), [4, 2])],
            "MatchIndices": [rng.randint(-1, 4, (2, 6)).astype(np.int32)]},
         {}),
        ("mine_hard_examples", "mine_hard_examples", {
            "ClsLoss": [np.array([[0.9, 0.1, 0.5, 0.7, 0.3]], np.float32)],
            "MatchIndices": [np.array([[2, -1, -1, -1, -1]], np.int32)]},
         {"neg_pos_ratio": 2.0}),
        ("mine_hard_examples_ties_ssd300", "mine_hard_examples", {
            "ClsLoss": [np.round(rng.rand(SSD_B, SSD_PRIORS), 2).astype(
                np.float32)],
            "MatchIndices": [np.where(rng.rand(SSD_B, SSD_PRIORS) < 0.02,
                                      rng.randint(0, 8, (SSD_B, SSD_PRIORS)),
                                      -1).astype(np.int32)]},
         {"neg_pos_ratio": 3.0}),
        ("multiclass_nms", "multiclass_nms", {
            "BBoxes": [np.array([[[0, 0, 1, 1], [0, 0, 1.05, 1.05],
                                  [2, 2, 3, 3]]], np.float32)],
            "Scores": [np.array([[[0, 0, 0], [0.9, 0.8, 0.7]]],
                                np.float32)]},
         {"score_threshold": 0.1, "nms_threshold": 0.5, "keep_top_k": 5}),
        ("multiclass_nms_ties", "multiclass_nms", {
            "BBoxes": [boxes(2, 30)],
            "Scores": [np.round(rng.rand(2, 4, 30), 1).astype(np.float32)]},
         {"score_threshold": 0.05, "nms_threshold": 0.45, "nms_top_k": -1,
          "keep_top_k": -1, "background_label": -1}),
        ("multiclass_nms_ssd300", "multiclass_nms", {
            "BBoxes": [boxes(4, SSD_PRIORS)],
            "Scores": [rng.dirichlet(np.ones(SSD["classes"]), (
                4, SSD_PRIORS)).transpose(0, 2, 1).astype(np.float32)]},
         dict(SSD_NMS, background_label=0)),
        ("detection_map", "detection_map", {"DetectRes": [seq(
            det, [12, 7, 0])], "Label": [seq(gt, [5, 3, 4])]},
         {"overlap_threshold": 0.5}),
        ("detection_map_ssd300", "detection_map", {"DetectRes": [sdet],
                                                   "Label": [sgt]},
         {"overlap_threshold": 0.5}),
        ("ssd_loss", "ssd_loss", ssd_loss_ins(2, 40, 4, 3), {
            "overlap_threshold": 0.5, "neg_pos_ratio": 3.0,
            "background_label": 0}),
        ("ssd_loss_background_ties", "ssd_loss",
         ssd_loss_ins(3, 60, 5, 4, True), {
             "overlap_threshold": 0.4, "neg_pos_ratio": 2.0,
             "background_label": 0}),
        ("ssd_loss_ssd300", "ssd_loss",
         ssd_loss_ins(4, SSD_PRIORS, SSD["classes"], SSD["gt"]), {
             "overlap_threshold": 0.5, "neg_pos_ratio": 3.0,
             "background_label": 0}),
    ]


VISION_TYPES = 21


def nms_near_ties(ins, attrs):
    """How many (image, class) rows of a multiclass_nms case hold two
    unequal scores of its first ``nms_top_k``, or a score and the score
    threshold, within 1e-6, or an IoU within 1e-6 of the NMS threshold:
    rows where two roundings could order or keep boxes differently. The
    card and the CPU compute the same IEEE operations on the same inputs
    here, so these rows are held exact all the same; the count says how
    much of the sweep that claim covers."""
    from paddle_tpu_torch.ops.math_ops import pairwise_iou

    boxes, scores = ins["BBoxes"][0], ins["Scores"][0]
    thr = attrs.get("nms_threshold", 0.3)
    sthr = attrs.get("score_threshold", 0.0)
    top = attrs.get("nms_top_k", -1)
    n = 0
    for b in range(scores.shape[0]):
        for c in range(scores.shape[1]):
            order = np.argsort(-scores[b, c], kind="stable")
            order = order[:top] if top > 0 else order
            s = scores[b, c][order]
            d = np.diff(s)
            cand = torch.from_numpy(boxes[b][order])
            iou = pairwise_iou(cand, cand).numpy()
            if ((d != 0) & (np.abs(d) < 1e-6)).any() or \
                    (np.abs(s - sthr) < 1e-6).any() or \
                    (np.abs(iou - thr) < 1e-6).any():
                n += 1
    return n


def vision_amax(name):
    """The share of the largest magnitude a case's floats are held to."""
    return VISION_LARGE_AMAX if name.endswith("_large") else DENSE_AMAX


def vision_sweep(dev, seed):
    """Phase 6g (a): the 21 vision and detection types on the card against
    the CPU, outputs and autograd gradients; NMS rows where no near-tie
    could reorder them."""
    from paddle_tpu_torch.core import registry

    rng = np.random.RandomState(seed + 7)
    cpu = torch.device("cpu")
    worst, types, n_grads, near = 0.0, set(), 0, 0
    for name, type, ins, attrs in vision_cases(rng):
        types.add(type)
        want, _ = _lower(type, ins, attrs, cpu)
        got, _ = _lower(type, ins, attrs, dev)
        torch.cuda.synchronize()
        if type == "multiclass_nms":
            near += nms_near_ties(ins, attrs)
        share = vision_amax(name)
        for k, (g, w) in enumerate(zip(got, want)):
            worst = max(worst, _dense_close("%s out %d" % (name, k), g, w,
                                            share))
        spec = registry.get(type)
        if spec.no_grad or not any(np.issubdtype(w.dtype, np.floating)
                                   for w in want):
            continue
        cots = [np.asarray(rng.randn(*w.shape), np.float32) for w in want
                if np.issubdtype(w.dtype, np.floating)]
        _, gw = _lower(type, ins, attrs, cpu, grad_cots=cots)
        _, gg = _lower(type, ins, attrs, dev, grad_cots=cots)
        for k, (g, w) in enumerate(zip(gg, gw)):
            worst = max(worst, _dense_close("%s grad %d" % (name, k), g, w,
                                            share))
            n_grads += 1
    if len(types) != VISION_TYPES:
        raise AssertionError("the sweep covers %d types" % len(types))
    print("vision and detection sweep: %d types on the card against the "
          "CPU, %d gradients; integer results, kept sets and matches exact, "
          "the worst float %.3g x max|ref| (bound rtol %g + %g x "
          "max|ref|, %g at the large shapes); NMS (image, class) rows "
          "holding a near-tie, held exact all the same: %d" % (
              len(types), n_grads, worst, DENSE_RTOL, DENSE_AMAX,
              VISION_LARGE_AMAX, near))
    return worst


def repairs_on_card(dev):
    """Phase 6g (a): the two repairs that the card could break. A
    duplicate-id scatter under ``overwrite`` writes the CPU's bits (the
    last update wins) and sends the gradient to it alone; an
    out-of-range hard label or embedding id reads NaN on the card with no
    device-side assert, and the sparse update of such a row drops it."""
    cpu = torch.device("cpu")
    ins = {"X": [np.zeros((3, 2), np.float32)],
           "Ids": [np.array([1, 1, 1], np.int64)],
           "Updates": [np.arange(6, dtype=np.float32).reshape(3, 2)]}
    cots = [np.arange(6, dtype=np.float32).reshape(3, 2) + 1]
    for d in (cpu, dev):
        out, grads = _lower("scatter", ins, {"overwrite": True}, d,
                            grad_cots=cots)
        if d == cpu:
            want = (out, grads)
        elif not all(np.array_equal(a, b) for a, b in
                     zip(out + grads, want[0] + want[1])):
            raise AssertionError("scatter duplicates: the card's bits "
                                 "differ from the CPU's")
    if not np.array_equal(want[0][0], [[0, 0], [4, 5], [0, 0]]) or \
            not np.array_equal(want[1][1][:2], np.zeros((2, 2))):
        raise AssertionError("scatter duplicates: not the last update")
    labels = np.array([[4], [-100], [-1], [2]], np.int64)
    probs = np.tile(np.array([[.1, .2, .3, .4]], np.float32), (4, 1))
    nan_rows = {}
    for type, slot, x in (("cross_entropy", "X", probs),
                          ("softmax_with_cross_entropy", "Logits", probs)):
        got, g = _lower(type, {slot: [x], "Label": [labels]}, {}, dev,
                        grad_cots=[np.ones((4, 1), np.float32)] +
                        ([np.zeros((4, 4), np.float32)]
                         if type != "cross_entropy" else []))
        torch.cuda.synchronize()
        loss = got[0] if type == "cross_entropy" else got[0]
        nan_rows[type] = int(np.isnan(loss).sum())
        if not (np.isnan(loss[:2]).all() and np.isfinite(loss[2:]).all()
                and np.isfinite(g[0]).all() and not g[0][:2].any()):
            raise AssertionError("%s: out-of-range labels on the card" % type)
    w = np.arange(12, dtype=np.float32).reshape(4, 3)
    got, g = _lower("lookup_table", {"W": [w], "Ids": [np.array(
        [[4], [1], [-1], [-9]], np.int64)]}, {}, dev,
        grad_cots=[np.ones((4, 3), np.float32)])
    torch.cuda.synchronize()
    if not (np.isnan(got[0][[0, 3]]).all() and
            np.array_equal(got[0][[1, 2]], w[[1, 3]]) and
            np.array_equal(g[0].sum(1), [0, 3, 0, 3])):
        raise AssertionError("lookup_table: out-of-range ids on the card")
    from paddle_tpu_torch.core.lower import RowSparse
    from paddle_tpu_torch.ops.optimizer_ops import _merge_rows

    grad = RowSparse(torch.tensor([4, 1, -1, 9], device=dev),
                     torch.ones(4, 3, device=dev), 4)
    dense = grad.to_dense()
    rows, _, valid = _merge_rows(grad)
    torch.cuda.synchronize()
    if dense.sum(1).tolist() != [0, 3, 0, 3] or int(valid.sum()) != 2 \
            or sorted(rows[valid[:, 0]].tolist()) != [1, 3]:
        raise AssertionError("row-sparse rows out of range on the card")
    print("repairs on the card: a duplicate-id scatter writes the CPU's "
          "bits, the last update, and its gradient reaches that update "
          "only; labels 4 and -100 of 4 classes give NaN losses (%s) and "
          "no gradient, no device-side assert; embedding ids 4 and -9 of a "
          "4-row table give NaN rows, and the row-sparse update drops them"
          % json.dumps(nan_rows))


def w2v_phase(fluid, seed, dev):
    """Phase 6g (b): the book's word2vec at BOOK_W2V's widths, dense and
    row-sparse: 10 eager steps whose loss is finite and falls;
    run_chunk's graph replays bitwise against eager steps; and the card
    against the CPU from the same weights: 3 losses within rtol 1e-4,
    every first-step gradient (the row-sparse one made dense) within
    1e-4 x its largest magnitude. Returns the graph_path numbers."""
    from paddle_tpu_torch import interop, unique_name

    res = {}
    dict_size = BOOK_W2V["dict_size"]
    for sparse in (False, True):
        label = "word2vec %s" % ("row-sparse" if sparse else "dense")
        feed = w2v_feed(np.random.RandomState(seed + 3), BOOK_W2V_B,
                        dict_size)
        on_card = {n: torch.from_numpy(v).to(dev) for n, v in feed.items()}
        with unique_name.guard():
            prog, startup, _, (loss,) = w2v_build(fluid, sparse)
        startup.random_seed = seed
        scope, exe = fluid.Scope(), fluid.Executor()
        exe.run(startup, scope=scope)
        exe.run(prog, feed=on_card, fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [float(exe.run(prog, feed=on_card, fetch_list=[loss],
                                scope=scope)[0])
                  for _ in range(BOOK_W2V_STEPS)]
        step_ms = (time.perf_counter() - t0) * 1000.0 / BOOK_W2V_STEPS
        print("%s: losses %s; eager %.3f ms/step (with the loss's host "
              "read)" % (label, " ".join("%.6f" % v for v in losses),
                         step_ms))
        if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
            raise AssertionError("%s: loss not finite and falling: %s"
                                 % (label, losses))
        n_ops = device_ops(lambda: exe.run(prog, feed=on_card,
                                           fetch_list=[loss], scope=scope))
        del scope, exe
        res[label] = graph_path(
            fluid, label, (prog, startup, loss), on_card, GRAPH_K["w2v"],
            GRAPH_CHUNKS, seed, {}, (1e-4, RESNET_AB_PL2TOL,
                                     RESNET_AB_L2TOL))
        res[label]["ops"] = n_ops[1]
        print("%s: %d device ops an eager step (card: %s)"
              % (label, n_ops[1], card_line()))
        # the card against the CPU from the same weights
        cpu_scope, card_scope = fluid.Scope(), fluid.Scope()
        cpu = fluid.Executor(fluid.CPUPlace())
        cpu.run(startup, scope=cpu_scope)
        interop.load_reference_state(
            {n: t.numpy() for n, t in cpu_scope.vars.items()}, card_scope,
            fluid.CUDAPlace(0), [prog, startup])
        grads = sorted(p.name + "@GRAD"
                       for p in prog.global_block().all_parameters())

        def dense(v):
            v = v.to_dense() if hasattr(v, "rows") else v
            return v.detach().cpu().numpy()
        card = fluid.Executor()
        for step in range(3):
            extra = grads if step == 0 else []
            c = cpu.run(prog, feed=feed, fetch_list=[loss] + extra,
                        scope=cpu_scope, return_numpy=False)
            k = card.run(prog, feed=on_card, fetch_list=[loss] + extra,
                         scope=card_scope, return_numpy=False)
            np.testing.assert_allclose(float(k[0]), float(c[0]), rtol=1e-4)
            if step == 0:
                check_grad_diff(
                    "card vs cpu at %s, %d first-step gradients"
                    % (label, len(grads)),
                    grad_diff(grads, [dense(v) for v in k[1:]],
                              [dense(v) for v in c[1:]]), 1e-4, 1e-3)
        print("card == cpu at %s: losses of 3 steps within rtol 1e-4"
              % label)
    torch.cuda.empty_cache()
    return res


def ssd_rows_agree(what, card, cpu):
    """Detection rows [B, K, 6] with counts, card against CPU: each card
    row has a CPU row of its label, box (atol 1e-4) and score (rtol
    1e-4), and the counts are equal, but for near-ties: a row without a
    partner is excused if its score lies within 1e-4 (relative) of its
    image's lowest kept score, where keep_top_k cuts among near-equal
    scores, or of another row's score of its class, where NMS ranks two
    near-equal boxes. Returns (rows compared, rows excused)."""
    (cd, cl), (pd, pl) = card, cpu
    if not np.array_equal(cl, pl):
        raise AssertionError("%s: counts card %s cpu %s" % (what, cl, pl))
    rows = excused = 0
    for b in range(cd.shape[0]):
        n = int(cl[b])
        a, r = cd[b, :n], pd[b, :n]
        cut = float(r[:, 1].min()) if n else 0.0
        for row in a:
            rows += 1
            same = (r[:, 0] == row[0]) & (np.abs(r[:, 2:] - row[2:]).max(
                1) <= 1e-4) & (np.abs(r[:, 1] - row[1]) <= 1e-4 * row[1])
            if same.any():
                continue
            peers = r[r[:, 0] == row[0], 1]
            if abs(row[1] - cut) <= 1e-4 * cut or \
                    (np.abs(peers - row[1]) <= 1e-4 * row[1]).any():
                excused += 1
                continue
            raise AssertionError("%s: image %d, the card's row %s has no "
                                 "CPU partner and is no near-tie"
                                 % (what, b, row.tolist()))
    return rows, excused


def ssd_detect(fluid, exe, test, dets, m, feed, scope):
    out = exe.run(test, feed=feed, fetch_list=[dets, m], scope=scope,
                  return_numpy=False)
    return (out[0].data.cpu().numpy(), out[0].lengths.cpu().numpy(),
            float(out[1]))


def ssd_phase(fluid, seed, dev):
    """Phase 6g (c): SSD300 at its published widths in config B (the JAX
    package's NHWC pass refuses the program: ROADMAP.md Queue 3): 8732
    priors asserted; B8 against its plain version at the program's 1x1
    shapes; 1 + 5 eager Momentum steps at batch 32 whose loss is finite
    and falls, B8's launches equal to the program's 1x1 stride-1 convs a
    step; run_chunk's graph replays bitwise against eager steps, B8
    credited once a replay; SSD300's test-time detection output and mAP
    on the trained weights (rows in range, counts <= keep_top_k, labels
    1..20, mAP in [0, 1], graph replays bitwise), with the NMS loop's
    share of the evaluation; and the card against the CPU at channels / 8
    and batch 4 (the 300x300 input, the six maps, 8732 priors): 3 losses
    within SSD_LTOL, the first-step gradients at the ResNet A-vs-B
    bounds, and the detections of the CPU-trained weights. Returns B8's
    launches on the main path."""
    from paddle_tpu_torch import flags, interop, unique_name
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.core.lower import TraceContext
    from paddle_tpu_torch.kernels import conv1x1_bwd as k1

    t0 = time.perf_counter()
    flags.set_flags({"FLAGS_fused_conv1x1_bwd": True})
    # cuDNN's default convolution backwards may sum in a run-dependent
    # order; the hard-negative ranks turn such a difference into another
    # set of negatives within a few steps, so the bitwise claims need
    # the deterministic algorithms (the phase's times are theirs)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with unique_name.guard():
            prog, startup, heads, (loss,) = ssd_build(fluid, config="B",
                                                      **SSD)
        if tuple(heads[2].shape) != (SSD_PRIORS, 4) or \
                tuple(heads[1].shape)[1:] != (SSD_PRIORS, SSD["classes"]):
            raise AssertionError("SSD300 priors %s, conf %s" % (
                heads[2].shape, heads[1].shape))
        c1_shapes = transformed_launches(prog, SSD_B)[1]
        n_c1 = sum(c1_shapes.values())
        print("SSD300: %d priors; per step, from the program: %d 1x1 "
              "stride-1 convs -> %d B8 launches at %s" % (
                  SSD_PRIORS, n_c1, n_c1, sorted(c1_shapes)))
        if n_c1 != 5:
            raise AssertionError("SSD300 holds fc7 and four extra 1x1 "
                                 "convs, found %d" % n_c1)
        g = torch.Generator(device="cpu").manual_seed(seed + 9)
        check_conv1x1(k1, g, dev, sorted(c1_shapes),
                      dtypes=(torch.float32,))
        feed = ssd_feed(np.random.RandomState(seed + 4), SSD_B)
        train = {n: torch.from_numpy(v).to(dev) for n, v in feed.items()
                 if n != "gt"}
        startup.random_seed = seed
        scope, exe = fluid.Scope(), fluid.Executor()
        exe.run(startup, scope=scope)
        exe.run(prog, feed=train, fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
        reset_all_launches()
        t1 = time.perf_counter()
        losses = [float(exe.run(prog, feed=train, fetch_list=[loss],
                                scope=scope)[0]) for _ in range(5)]
        step_ms = (time.perf_counter() - t1) * 1000.0 / 5
        got = {n: c for n, c in all_launches().items() if c}
        print("SSD300 eager: losses %s; %.3f ms/step (with the loss's host "
              "read); launches %s, from the program %s" % (
                  " ".join("%.6f" % v for v in losses), step_ms,
                  json.dumps(got), json.dumps({"conv1x1_bwd": 5 * n_c1})))
        if got != {"conv1x1_bwd": 5 * n_c1}:
            raise AssertionError("SSD300 launch counts")
        launched = got["conv1x1_bwd"]
        if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
            raise AssertionError("SSD300: loss not finite and falling: %s"
                                 % losses)
        device_profile(lambda: exe.run(prog, feed=train, fetch_list=[loss],
                                       scope=scope), 1, step_ms,
                       "SSD300 step (eager)", share_of=("conv1x1_bwd",))
        # evaluation on the trained weights
        with unique_name.guard():
            test, dets, m = ssd_eval_program(fluid, prog, heads)
        ev = {"img": train["img"], "gt": torch.from_numpy(
            feed["gt"]).to(dev)}
        rows, counts, mean_ap = ssd_detect(fluid, exe, test, dets, m, ev,
                                           scope)
        valid = np.arange(rows.shape[1])[None, :] < counts[:, None]
        lab = rows[..., 0][valid]
        ok = rows.shape[1] == SSD_NMS["keep_top_k"] and \
            (counts <= SSD_NMS["keep_top_k"]).all() and counts.min() > 0 \
            and np.isfinite(rows).all() and (lab >= 1).all() and \
            (lab <= SSD["classes"] - 1).all() and (lab == lab.round()).all() \
            and (rows[..., 1][valid] > SSD_NMS["score_threshold"]).all() \
            and 0.0 <= mean_ap <= 1.0 and not rows[~valid].any()
        print("SSD300 evaluation: detections a image %s (of at most %d), "
              "labels %d..%d, scores %.4f..%.4f, mAP@0.5 %.6f" % (
                  np.bincount(counts).nonzero()[0].tolist(),
                  SSD_NMS["keep_top_k"], lab.min(), lab.max(),
                  rows[..., 1][valid].min(), rows[..., 1][valid].max(),
                  mean_ap))
        if not ok:
            raise AssertionError("SSD300 detections out of range")
        chunk = chunk_of(ev, 2)
        eager = [ssd_detect(fluid, exe, test, dets, m, ev, scope)
                 for _ in range(2)]
        reps = [exe.run_chunk(test, feed_chunk=chunk, k=2, fetch_list=[m],
                              scope=scope)[0]]
        same = all(np.array_equal(e[0], rows) and np.array_equal(
            e[1], counts) for e in eager) and all(np.array_equal(
                np.asarray(r), np.full(2, mean_ap, np.float32))
                for r in reps)
        if not same:
            raise AssertionError("SSD300 evaluation: graph replays or a "
                                 "second eager call differ")

        # the NMS loop's share of the evaluation
        def ev_call():
            exe.run(test, feed=ev, fetch_list=[dets, m], scope=scope,
                    return_numpy=False)
        ev_call()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(3):
            ev_call()
        torch.cuda.synchronize()
        ev_ms = (time.perf_counter() - t1) * 1000.0 / 3
        nms_op = next(op for op in test.global_block().ops
                      if op.type == "multiclass_nms")
        nms_in = exe.run(test, feed=ev, fetch_list=[
            nms_op.input("BBoxes")[0], nms_op.input("Scores")[0]],
            scope=scope, return_numpy=False)
        spec = registry.get("multiclass_nms")
        ctx = TraceContext(device=dev).for_op(nms_op)

        def nms_call():
            spec.lower(ctx, {"BBoxes": [nms_in[0]], "Scores": [nms_in[1]]},
                       nms_op.attrs, nms_op)
        nms_call()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        nms_call()
        torch.cuda.synchronize()
        nms_ms = (time.perf_counter() - t1) * 1000.0
        ev_busy, ev_ops = device_ops(ev_call)
        nms_busy, nms_ops = device_ops(nms_call)
        print("SSD300 evaluation call (eager, batch %d): host %.3f ms, "
              "device busy %s ms in %d device ops; multiclass_nms alone: "
              "host %.3f ms, busy %s ms in %d device ops = %s of the "
              "evaluation's busy time (card: %s)" % (
                  SSD_B, ev_ms, "%.3f" % ev_busy if ev_busy else
                  "not measured", ev_ops, nms_ms,
                  "%.3f" % nms_busy if nms_busy else "not measured",
                  nms_ops, "%.1f%%" % (100.0 * nms_busy / ev_busy)
                  if ev_busy and nms_busy else "not measured", card_line()))
        del scope, exe, test, chunk
        torch.cuda.empty_cache()

        res = graph_path(fluid, "ssd300", (prog, startup, loss), train,
                         GRAPH_K["ssd"], 1, seed,
                         {"conv1x1_bwd": n_c1},
                         (SSD_LTOL, RESNET_AB_PL2TOL, RESNET_AB_L2TOL))
        print("SSD300 graphs: B8 %d launches a step, credited once a "
              "replay (card: %s)" % (n_c1, card_line()))
        del train
        torch.cuda.empty_cache()

        # the card against the CPU at channels / 8, batch 4
        xfeed = ssd_feed(np.random.RandomState(seed + 5), SSD_X["batch"])
        xtrain = {n: v for n, v in xfeed.items() if n != "gt"}

        def build():
            return ssd_build(fluid, config="B", **dict(SSD, div=SSD_X["div"]))
        reset_all_launches()
        cross_check(fluid, fluid.Executor(), build, seed, xtrain, 3,
                    "SSD300 / %d, batch %d" % (SSD_X["div"], SSD_X["batch"]),
                    gtol=SSD_GTOL, ltol=SSD_LTOL, l2tol=SSD_L2TOL,
                    pl2tol=SSD_PL2TOL, pl2_floor=AMP_CANCELS)
        # the detections of the CPU's weights after 3 steps, on both
        with unique_name.guard():
            xprog, xstart, xheads, (xloss,) = build()
        xstart.random_seed = seed
        cpu_scope, card_scope = fluid.Scope(), fluid.Scope()
        cpu = fluid.Executor(fluid.CPUPlace())
        cpu.run(xstart, scope=cpu_scope)
        for _ in range(3):
            cpu.run(xprog, feed=xtrain, fetch_list=[xloss], scope=cpu_scope)
        interop.load_reference_state(
            {n: t.numpy() for n, t in cpu_scope.vars.items()}, card_scope,
            fluid.CUDAPlace(0), [xprog, xstart])
        with unique_name.guard():
            xtest, xdets, xm = ssd_eval_program(fluid, xprog, xheads)
        xev = {n: xfeed[n] for n in ("img", "gt")}
        c_rows, c_counts, c_map = ssd_detect(fluid, cpu, xtest, xdets, xm,
                                             xev, cpu_scope)
        k_rows, k_counts, k_map = ssd_detect(
            fluid, fluid.Executor(), xtest, xdets, xm,
            {n: torch.from_numpy(v).to(dev) for n, v in xev.items()},
            card_scope)
        n_rows, n_excused = ssd_rows_agree(
            "SSD300 / %d detections" % SSD_X["div"], (k_rows, k_counts),
            (c_rows, c_counts))
        np.testing.assert_allclose(k_map, c_map, rtol=1e-3, atol=1e-4)
        print("card == cpu at SSD300 / %d: %d detection rows, %d excused "
              "as near-ties; mAP card %.6f cpu %.6f" % (
                  SSD_X["div"], n_rows, n_excused, k_map, c_map))
    finally:
        flags.set_flags({"FLAGS_fused_conv1x1_bwd": False})
        torch.backends.cudnn.deterministic = deterministic
    torch.cuda.synchronize()
    print("SSD300 phase: %.1f s" % (time.perf_counter() - t0))
    return launched, res


def vision_phase(fluid, seed, dev):
    """Phase 6g: the vision and detection families on the card. Returns
    B8's launches on SSD300's main path."""
    t0 = time.perf_counter()
    vision_sweep(dev, seed)
    repairs_on_card(dev)
    t1 = time.perf_counter()
    w2v = w2v_phase(fluid, seed, dev)
    t2 = time.perf_counter()
    launched, ssd = ssd_phase(fluid, seed, dev)
    torch.cuda.synchronize()
    print("vision phase parts: sweep and repairs %.1f s, word2vec %.1f s, "
          "SSD300 %.1f s" % (t1 - t0, t2 - t1, time.perf_counter() - t2))
    print("vision phase: %.1f s; host ms/step eager / graphs, busy ms/step "
          "eager / graphs: %s (card: %s)" % (
              time.perf_counter() - t0, json.dumps({
                  k: [round(v[n], 3) if v[n] is not None else None
                      for n in ("host_eager", "host_graphs", "busy_eager",
                                "busy_graphs")]
                  for k, v in dict(w2v, ssd300=ssd).items()}), card_line()))
    return launched


# ---- phase 6h: the sequence and CTC families, CRNN-CTC ----

def crnn_build(fluid, width=512, channels=(16, 32, 64, 128), hidden=200,
               classes=95, lr=1e-3, act="relu"):
    """The CRNN-CTC recognizer (CRNN's comment above) through ``fluid``'s
    layers (either package), at an input of 48 x ``width``, the four
    conv groups' ``channels``, GRUs of ``hidden`` with candidate
    activation ``act``, and ``classes`` + 1 outputs (the blank last).
    The initializers are the published ones: Normal(0, 0.0005) for the
    first group's conv weights, Normal(0, 0.01) for the other convs' and
    every batch norm's scale, Normal(0, 0) for the batch norms' shifts,
    Normal(0, 0.02) for the fcs, TruncatedNormal(0, 0.02) for the GRUs'
    weights and Normal(0, 0.02) at learning rate 2 for their biases; L2
    decay CRNN_L2 on every parameter. The eval program is the forward
    cloned for test (batch norms on their running statistics) with the
    greedy decoder and the edit distance to the label, unnormalised.
    Feeds: ``pixel`` [B, 1, 48, width], ``label`` (int32 sequences) and
    ``seq_len`` [B, 1] int64 (the frames of each row).

    Returns (program, startup, eval program, (loss, logits), (decoded,
    distance))."""
    layers, init = fluid.layers, fluid.initializer

    def attr(std, **kw):
        return fluid.ParamAttr(
            regularizer=fluid.regularizer.L2Decay(CRNN_L2),
            initializer=init.Normal(0.0, std), **kw)

    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        pixel = layers.data("pixel", [1, 48, width])
        label = layers.data("label", [1], dtype="int32", lod_level=1)
        seq_len = layers.data("seq_len", [1], dtype="int64")
        x = pixel
        for g, ch in enumerate(channels):
            for _ in range(2):
                x = layers.conv2d(x, ch, 3, padding=1,
                                  param_attr=attr(0.0005 if g == 0
                                                  else 0.01))
                x = layers.batch_norm(x, act="relu", param_attr=attr(0.01),
                                      bias_attr=attr(0.0))
            if g < len(channels) - 1:
                x = layers.pool2d(x, 2, "max", pool_stride=2,
                                  ceil_mode=True)
        feat = layers.im2sequence(x, filter_size=[int(x.shape[2]), 1],
                                  stride=[1, 1])
        frames = layers.sequence_unpad(feat, seq_len)
        grus = []
        for reverse in (False, True):
            xg = layers.fc(frames, 3 * hidden, num_flatten_dims=2,
                           param_attr=attr(0.02), bias_attr=attr(0.02))
            grus.append(layers.dynamic_gru(
                xg, hidden, is_reverse=reverse,
                param_attr=fluid.ParamAttr(
                    regularizer=fluid.regularizer.L2Decay(CRNN_L2),
                    initializer=init.TruncatedNormal(0.0, 0.02)),
                bias_attr=attr(0.02, learning_rate=2.0),
                candidate_activation=act))
        logits = layers.fc(grus, classes + 1, num_flatten_dims=2,
                           param_attr=attr(0.02), bias_attr=attr(0.0))
        cost = layers.warpctc(logits, label, blank=classes,
                              norm_by_times=True)
        loss = layers.reduce_sum(cost)
    test = prog.clone(for_test=True)
    block = test.global_block()
    with fluid.program_guard(test, fluid.Program()):
        decoded = layers.ctc_greedy_decoder(block.var(logits.name),
                                            blank=classes)
        dist, _ = layers.edit_distance(
            decoded, layers.cast(block.var(label.name), "int64"),
            normalized=False)
    with fluid.program_guard(prog, startup):
        fluid.optimizer.Momentum(lr, 0.9).minimize(loss)
    return prog, startup, test, (loss, logits), (decoded, dist)


def crnn_labels(rng, batch, frames, classes=95, lengths=(8, 24)):
    """``batch`` labels of ``lengths`` ids in 0..classes-1, each one
    alignable in ``frames`` frames: its length plus its adjacent repeats
    (each needs a blank between) at most ``frames``."""
    rows = []
    while len(rows) < batch:
        n = rng.randint(lengths[0], lengths[1] + 1)
        r = rng.randint(0, classes, n)
        if n + int((r[1:] == r[:-1]).sum()) <= frames:
            rows.append(r.astype(np.int32).reshape(-1, 1))
    return rows


def crnn_feed(rng, batch, width=512, classes=95, lengths=(8, 24)):
    """A synthetic batch: pixels uniform in [0, 1), labels of
    ``lengths`` ids (a ragged list of [L, 1] int32), every row width / 8
    frames."""
    frames = width // 8
    return {"pixel": rng.uniform(0, 1, (batch, 1, 48, width)).astype(
                np.float32),
            "label": crnn_labels(rng, batch, frames, classes, lengths),
            "seq_len": np.full((batch, 1), frames, np.int64)}


def seq_cases(rng):
    """(name, op type, inputs, attrs) of phase 6h's sweep: each of the 13
    sequence types and the 3 CTC types at the JAX sweeps' shapes
    (tests/test_op_sweep_rnn_seq.py TestSequenceFamily and
    TestMaskedGradients, tests/test_op_tail.py TestLodReset,
    tests/test_crf_ctc.py), with rows of length 0 and duplicate ids,
    and warpctc and edit_distance at the CRNN's sizes. A ("seq", data,
    lengths) input is a PackedSeq."""
    def seq(data, lens):
        data = np.array(data)
        for i, n in enumerate(lens):
            data[i, n:] = 0
        return ("seq", data, np.asarray(lens, np.int32))

    def ps(b, t, d, lens, scale=1.0):
        return seq((rng.rand(b, t, d).astype(np.float32) - 0.5) * scale,
                   lens)

    def ids(rows, width, dtype=np.int32):
        data = np.zeros((len(rows), width, 1), dtype)
        for i, r in enumerate(rows):
            data[i, :len(r), 0] = r
        return seq(data, [len(r) for r in rows])

    def flat_x(lens, d, t):
        data = np.zeros((len(lens), t, d), np.float32)
        stream = rng.rand(sum(lens), d).astype(np.float32)
        pos = 0
        for b, n in enumerate(lens):
            data[b, :n] = stream[pos:pos + n]
            pos += n
        return seq(data, lens)

    tokens = seq(np.array([[[1], [2], [0], [2]], [[2], [2], [0], [0]],
                           [[3], [0], [0], [0]]], np.int64), [4, 2, 0])
    wide_lab = crnn_labels(rng, CRNN_B, CRNN["width"] // 8,
                           CRNN["classes"], CRNN_LABELS)
    hyps = [rng.randint(0, CRNN["classes"],
                        rng.randint(0, CRNN["width"] // 8 + 1))
            for _ in range(CRNN_B)]
    return [
        ("unpad", "sequence_unpad",
         {"X": [rng.randn(3, 4, 2).astype(np.float32)],
          "Length": [np.array([4, 2, 0], np.int64)]}, {}),
        ("softmax", "sequence_softmax", {"X": [ps(2, 4, 1, [4, 2])]}, {}),
        ("softmax_2d_empty_row", "sequence_softmax",
         {"X": [seq(rng.randn(3, 5).astype(np.float32) * 3, [5, 0, 2])]},
         {}),
        ("expand_dense", "sequence_expand",
         {"X": [np.array([[1.0], [2.0]], np.float32)],
          "Y": [ps(2, 3, 1, [3, 2])]}, {"ref_level": -1}),
        ("expand_seq", "sequence_expand",
         {"X": [ps(2, 2, 3, [1, 2])], "Y": [ps(2, 4, 1, [3, 4])]}, {}),
        ("expand_as", "sequence_expand_as",
         {"X": [np.array([[1.0], [2.0]], np.float32)],
          "Y": [ps(2, 3, 1, [3, 1])]}, {}),
        ("concat", "sequence_concat",
         {"X": [ps(3, 3, 2, [3, 0, 1]), ps(3, 2, 2, [0, 2, 1]),
                ps(3, 4, 2, [2, 4, 0])]}, {}),
        ("reverse", "sequence_reverse",
         {"X": [ps(3, 4, 2, [4, 0, 3], scale=2.0)]}, {}),
        ("erase", "sequence_erase", {"X": [tokens]}, {"tokens": [0, 2]}),
        ("slice", "sequence_slice",
         {"X": [ps(3, 4, 2, [4, 2, 3], scale=2.0)],
          "Offset": [np.array([[0], [3], [1]], np.int64)],
          "Length": [np.array([[2], [1], [2]], np.int64)]}, {}),
        ("reshape", "sequence_reshape", {"X": [ps(2, 4, 3, [3, 1])]},
         {"new_dim": 4}),
        ("scatter_duplicates", "sequence_scatter",
         {"X": [rng.randn(3, 6).astype(np.float32)],
          "Ids": [seq(np.array([[2, 2, 5, 2], [-1, 0, 7, -1],
                                [1, 1, 1, 1]], np.int64)[..., None],
                      [4, 4, 0])],
          "Updates": [seq(rng.randn(3, 4, 1).astype(np.float32) * 1e3,
                          [4, 4, 0])]}, {}),
        ("enumerate", "sequence_enumerate",
         {"X": [seq(rng.randint(0, 9, (3, 5, 1)).astype(np.int64),
                    [5, 1, 0])]}, {"win_size": 3, "pad_value": -1}),
        ("roll", "sequence_roll", {"X": [ps(3, 5, 2, [5, 3, 0])]},
         {"offset": -1}),
        ("lod_reset_target_lod", "lod_reset",
         {"X": [flat_x([2, 3, 0, 2], 2, 3)]}, {"target_lod": [0, 1, 1, 7]}),
        ("lod_reset_y", "lod_reset",
         {"X": [flat_x([4, 2], 1, 4)],
          "Y": [seq(np.zeros((3, 3, 1), np.float32), [1, 2, 3])]}, {}),
        ("warpctc", "warpctc",
         {"Logits": [seq(rng.randn(4, 7, 5).astype(np.float32) * 2,
                         [7, 5, 4, 6])],
          "Label": [ids([[1, 2, 2], [3, 3], [1, 2, 3, 4], []], 4)]},
         {"blank": 0, "norm_by_times": True}),
        ("warpctc_crnn", "warpctc",
         {"Logits": [seq(rng.randn(CRNN_B, CRNN["width"] // 8,
                                   CRNN["classes"] + 1).astype(np.float32),
                         [CRNN["width"] // 8] * CRNN_B)],
          "Label": [ids([r[:, 0] for r in wide_lab], CRNN_LABELS[1])]},
         {"blank": CRNN["classes"], "norm_by_times": True}),
        ("ctc_align", "ctc_align",
         {"Input": [seq(rng.randint(0, 4, (4, 8, 1)).astype(np.int32),
                        [8, 3, 8, 0])]}, {"blank": 0}),
        ("ctc_align_ties", "ctc_align",
         {"Input": [seq(np.array([[[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 2.0, 2.0],
                                   [0.0, 0.0, 1.0, 1.0]],
                                  [[0.5, 0.5, 0.0, 0.5], [1.0, 0.0, 1.0, 0.0],
                                   [0.0, 4.0, 0.0, 4.0]]], np.float32),
                        [3, 3])]}, {"blank": 0}),
        ("ctc_align_logits", "ctc_align",
         {"Input": [seq(rng.randn(CRNN_B, CRNN["width"] // 8,
                                  CRNN["classes"] + 1).astype(np.float32),
                        [CRNN["width"] // 8] * CRNN_B)]},
         {"blank": CRNN["classes"]}),
        ("edit_distance", "edit_distance",
         {"Hyps": [ids([[1, 2, 3], [4], [], [5, 6, 7, 8]], 4)],
          "Refs": [ids([[1, 3], [], [2, 2], [8, 7, 6, 5, 4]], 5)]},
         {"normalized": True}),
        ("edit_distance_crnn", "edit_distance",
         {"Hyps": [ids(hyps, CRNN["width"] // 8, np.int64)],
          "Refs": [ids([r[:, 0] for r in wide_lab], CRNN_LABELS[1],
                       np.int64)]}, {"normalized": False}),
    ]


def seq_amax(name):
    """The share of the largest magnitude that phase 6h's sweep allows a
    case's floats (None: DENSE_AMAX)."""
    return SEQ_LONG_AMAX if name.endswith("_crnn") else None


def seq_sweep(dev, seed):
    """Phase 6h (a): the 16 sequence and CTC types on the card against
    the CPU from the same numpy inputs: outputs and lengths, and the
    gradients by autograd where the type is differentiable; integers and
    lengths exact, floats within DENSE_RTOL plus DENSE_AMAX of the
    largest magnitude. sequence_scatter's duplicate ids (added in index
    order, core.lower.add_rows) give the same bits on two runs."""
    from paddle_tpu_torch.core import registry

    rng = np.random.RandomState(seed + 23)
    cpu = torch.device("cpu")
    worst, types, n_grads = 0.0, set(), 0
    for name, type, ins, attrs in seq_cases(rng):
        types.add(type)
        want, _ = _lower(type, ins, attrs, cpu, lengths=True)
        got, _ = _lower(type, ins, attrs, dev, lengths=True)
        share = seq_amax(name)
        for k, (g, w) in enumerate(zip(got, want)):
            worst = max(worst, _dense_close("%s out %d" % (name, k), g, w,
                                            share))
        spec = registry.get(type)
        if spec.no_grad or not any(np.issubdtype(w.dtype, np.floating)
                                   for w in want):
            continue
        cots = [np.asarray(rng.randn(*w.shape), np.float32) for w in want
                if np.issubdtype(w.dtype, np.floating)]
        _, gw = _lower(type, ins, attrs, cpu, grad_cots=cots)
        _, gg = _lower(type, ins, attrs, dev, grad_cots=cots)
        for k, (g, w) in enumerate(zip(gg, gw)):
            worst = max(worst, _dense_close("%s grad %d" % (name, k), g, w,
                                            share))
            n_grads += 1
        if type == "sequence_scatter":
            again, _ = _lower(type, ins, attrs, dev)
            _, gg2 = _lower(type, ins, attrs, dev, grad_cots=cots)
            if not all(np.array_equal(a, b) for a, b in
                       zip(got + gg, again + gg2)):
                raise AssertionError("sequence_scatter: two runs on the "
                                     "card differ")
            print("sequence_scatter with duplicate ids: two runs on the "
                  "card bitwise equal; bitwise the CPU's: %s" % all(
                      np.array_equal(a, b) for a, b in zip(got, want)))
    if len(types) != SEQ_TYPES:
        raise AssertionError("the sweep covers %d types" % len(types))
    print("sequence and CTC sweep: %d types on the card against the CPU, "
          "%d gradients; integers and lengths exact, the worst float %.3g "
          "x max|ref| (bound rtol %g + %g x max|ref|, %g at the CRNN's "
          "sizes)" % (len(types), n_grads, worst, DENSE_RTOL, DENSE_AMAX,
                      SEQ_LONG_AMAX))
    return worst


def crnn_gru_kernels(gc, g, dev):
    """Phase 6h (c): B5 and B6 at variant (b)'s shape, [CRNN_B, 64, 200]
    float32, every step valid: against their plain versions at the
    kernels' bounds (check_gru_shape), against the float64 plain
    versions (B6 on the float64 stash), twice to the same bits, and
    their times beside their bound and cuDNN's GRU at the same shape.
    Returns the max abs errors {kernel: err}."""
    B, T, H = CRNN_B, CRNN["width"] // 8, CRNN["hidden"]
    fwd, bwd, dw = check_gru_shape(gc, B, T, H, g, dev, ragged=False)
    fplan = gc.launch_plan("gru_fwd", B, H, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    bplan = gc.launch_plan("gru_bwd", B, H, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    for kind, pl in (("gru_fwd", fplan), ("gru_bwd", bplan)):
        card = gc.card_plan(kind, B, H, dev)
        if card != {k: pl[k] for k in card}:
            raise AssertionError("%s at H %d: launch_plan %s != the "
                                 "kernel's %s" % (kind, H, pl, card))
    xg, w, h0, mask, dhs = gru_inputs(B, T, H, g, dev, ragged=False)
    f64 = [t.double() for t in (xg, w, h0, mask, dhs)]
    ths, tst = gc.gru_forward_reference(*f64[:4])
    tdxg, tdh0 = gc.gru_backward_reference(tst, ths, *f64[1:])
    hs, st = gc.gru_forward(xg, w, h0, mask)
    dxg, dh0 = gc.gru_backward(tst.float(), ths.float(), w, h0, mask, dhs)
    assert_close("gru [%d,%d,%d] float64 hs" % (B, T, H), hs.double(), ths,
                 LSTM_ATOL, LSTM_RTOL)
    assert_close("gru [%d,%d,%d] float64 stash" % (B, T, H), st.double(),
                 tst, LSTM_ATOL, LSTM_RTOL)
    for name, a, b in (("dxg", dxg, tdxg), ("dh0", dh0, tdh0)):
        assert_close("gru [%d,%d,%d] float64 %s" % (B, T, H, name),
                     a.double(), b,
                     LSTM_ATOL * max(1.0, float(b.abs().max())), LSTM_RTOL)
    runs = []
    for _ in range(2):
        hs_, st_ = gc.gru_forward(xg, w, h0, mask)
        runs.append((hs_, st_) + gc.gru_backward(st_, hs_, w, h0, mask, dhs))
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError("gru [%d,%d,%d]: two runs differ" % (B, T, H))
    print("gru at [%d,%d,%d] (CRNN variant b): against the plain versions "
          "hs/stash %.3g, dxg/dh0 %.3g, dW %.3g (atol %g, rtol %g); "
          "against float64 hs %.3g stash %.3g, dxg %.3g dh0 %.3g of their "
          "largest magnitude; two runs bitwise equal; plans %s %s" % (
              B, T, H, fwd, bwd, dw, LSTM_ATOL, LSTM_RTOL,
              float((hs.double() - ths).abs().max()),
              float((st.double() - tst).abs().max()),
              float((dxg.double() - tdxg).abs().max() / tdxg.abs().max()),
              float((dh0.double() - tdh0).abs().max() / tdh0.abs().max()),
              json.dumps(fplan), json.dumps(bplan)))
    # times: the kernels, their plain versions, cuDNN's GRU (input size
    # H: it also does the input GEMM, and applies r after the product)
    hs, st = gc.gru_forward(xg, w, h0, mask)
    t_short = {}
    xs, ws, h0s, ms_, dhss = gru_inputs(B, GRU_SHORT_T, H, g, dev,
                                        ragged=False)
    hss, sts = gc.gru_forward(xs, ws, h0s, ms_)
    t_short["gru_fwd"] = time_ms(lambda: gc.gru_forward(xs, ws, h0s, ms_))
    t_short["gru_bwd"] = time_ms(lambda: gc.gru_backward(
        sts, hss, ws, h0s, ms_, dhss))
    rnn = torch.nn.GRU(H, H, batch_first=True).to(dev)
    x_in = torch.randn(B, T, H, generator=g).to(dev)
    frozen = torch.nn.GRU(H, H, batch_first=True).to(dev)
    frozen.requires_grad_(False)
    x_leaf = x_in.clone().requires_grad_()
    kept, _ = frozen(x_leaf)
    g_out = torch.randn(B, T, H, generator=g).to(dev)

    def cudnn_fwd():
        with torch.no_grad():
            rnn(x_in)
    rows = [dict(name="gru_fwd", ms=time_ms(lambda: gc.gru_forward(
                     xg, w, h0, mask)),
                 plain_ms=plain_time_ms(lambda: gc.gru_forward_reference(
                     xg, w, h0, mask)),
                 library_ms=time_ms(cudnn_fwd),
                 bytes=4 * (2 * B * T * 3 * H + H * 3 * H + B * H + B * T
                            + B * T * H),
                 flops=2 * B * T * H * 3 * H),
            dict(name="gru_bwd", ms=time_ms(lambda: gc.gru_backward(
                     st, hs, w, h0, mask, dhs)),
                 plain_ms=plain_time_ms(lambda: gc.gru_backward_reference(
                     st, hs, w, h0, mask, dhs)),
                 library_ms=time_ms(lambda: torch.autograd.grad(
                     kept, x_leaf, g_out, retain_graph=True)),
                 bytes=4 * (2 * B * T * 3 * H + 2 * B * T * H + H * 3 * H
                            + 2 * B * H + B * T),
                 flops=2 * B * T * 3 * H * H)]
    for r in rows:
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = 3 * r["flops"] / TF32_FLOPS_PER_S * 1e3
        print("time %s [%d,%d,%d] all steps valid (CRNN variant b): "
              "kernel_ms %.6f (%.3f us a step; at T=%d %.6f ms: %.3f us a "
              "step (t%d - t%d) / %d) plain_ms %.6f library_ms %.6f "
              "bound_ms %.6f (%s; %d bytes, %d flops, 3xTF32); library: "
              "%s (card: %s)" % (
                  r["name"], B, T, H, r["ms"], r["ms"] * 1e3 / T,
                  GRU_SHORT_T, t_short[r["name"]],
                  (r["ms"] - t_short[r["name"]]) * 1e3 / (T - GRU_SHORT_T),
                  T, GRU_SHORT_T, T - GRU_SHORT_T, r["plain_ms"],
                  r["library_ms"], max(t_bytes, t_ops),
                  "bytes" if t_bytes >= t_ops else "operations", r["bytes"],
                  r["flops"], "torch.nn.GRU (cuDNN) forward, input size "
                  "200, no grad" if r["name"] == "gru_fwd" else
                  "cuDNN GRU backward-data (torch.nn.GRU, input size 200, "
                  "parameters frozen, one forward kept, "
                  "torch.autograd.grad to the input)", card_line()))
    del rnn, frozen, kept
    torch.cuda.empty_cache()
    return {"gru_fwd": fwd, "gru_bwd": bwd}


def crnn_decode_rows(logits, decoded, dist):
    """Host arrays of one eval call: logits [B, T, C], decoded ids and
    lengths, distances."""
    return (np.asarray(logits.data.cpu()), np.asarray(decoded.data.cpu()),
            np.asarray(decoded.lengths.cpu()), np.asarray(dist.cpu()))


def crnn_eval(exe, test, fetches, feed, scope):
    """One eval call: (logits, decoded, distances) as host arrays."""
    return crnn_decode_rows(*exe.run(test, feed=feed, fetch_list=fetches,
                                     scope=scope, return_numpy=False))


def crnn_sharpen(prog, scope):
    """Multiply the output layer's weights (the program's last two
    ``mul`` ops: the fc over the two GRUs) in ``scope`` by
    CRNN_SHARPEN."""
    for op in [op for op in prog.global_block().ops
               if op.type == "mul"][-2:]:
        name = op.input("Y")[0]
        scope.set_var(name, scope.find_var(name) * CRNN_SHARPEN)


def crnn_conditioning(fluid, build, seed, feed, label):
    """How far the CPU's own first-step gradients move for a 1e-6 change
    of the pixels (the cross-check's bounds rest on it): printed as
    grad_diff at the cross-check's floor."""
    from paddle_tpu_torch import unique_name

    got = []
    for eps in (0.0, 1e-6):
        with unique_name.guard():
            prog, startup, _, (loss,) = build()
        startup.random_seed = seed
        scope, cpu = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
        cpu.run(startup, scope=scope)
        f = dict(feed, pixel=feed["pixel"] + np.float32(eps) * np.random.
                 RandomState(seed).randn(*feed["pixel"].shape).astype(
                     np.float32))
        names = sorted(p.name + "@GRAD"
                       for p in prog.global_block().all_parameters())
        got.append(cpu.run(prog, feed=f, fetch_list=names, scope=scope))
    d = grad_diff(names, got[1], got[0], CRNN_CANCELS)
    print("%s: a 1e-6 change of the pixels moves the CPU's own first-step "
          "gradients: worst entry %.3g x max|g| (%s), worst gradient %.3g "
          "of its L2 norm (%s), all together %.3g; %d held in the whole "
          "only" % (label, d["worst"], d["worst_name"], d["pl2"],
                    d["pl2_name"], d["l2"], len(d["cancels"])))
    return d


def crnn_variant(fluid, seed, dev, tag, act):
    """Phase 6h (b, d): one CRNN-CTC variant at full width (CRNN, batch
    CRNN_B): startup, 1 + 5 eager Momentum steps with a finite falling
    loss, B5/B6 launches exactly the program's (recurrent_launches; none
    for the relu candidate), the eval program on the trained scope
    (decodes in range, distances >= 0) with its host and busy ms,
    run_chunk's graph replays (one chunk of GRAPH_K["crnn"]) bitwise
    against eager steps (launches credited per replay) with host and
    busy ms/step and device ops a step, warpctc's share of the busy
    step, and the card against the CPU at CRNN_X's width from the same
    weights: 3 losses within CRNN_LTOL, first-step gradients within the
    CRNN_* bounds (crnn_conditioning prints what a 1e-6 input change
    does to them on the CPU), the eval decodes row for row from the
    startup's weights with the output layer sharpened (crnn_sharpen) but
    at frames whose top-two margin is under CRNN_TIE. cuDNN runs its
    deterministic convolutions, so that graph replays can be held
    bitwise. Returns (B5/B6 launches on the main path, numbers)."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _crnn_variant(fluid, seed, dev, tag, act)
    finally:
        torch.cuda.synchronize()
        torch.backends.cudnn.deterministic = deterministic


def _crnn_variant(fluid, seed, dev, tag, act):
    from paddle_tpu_torch import interop, unique_name
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.core.lower import PackedSeq, TraceContext

    t0 = time.perf_counter()
    label = "CRNN-CTC (%s, %s)" % (tag, act)
    with unique_name.guard():
        prog, startup, test, (loss, logits), (decoded, dist) = crnn_build(
            fluid, act=act, **CRNN)
    fwd, bwd = recurrent_launches(prog, "gru")
    want = {"gru_fwd": fwd, "gru_bwd": bwd} if act == "tanh" else {}
    print("%s: per step, from the program: %d gru ops and %d gru_grad -> "
          "%s" % (label, fwd - bwd, bwd, json.dumps(want) if want else
                  "no GRU kernel (the relu candidate runs the step loop)"))
    feed = crnn_feed(np.random.RandomState(seed + 11), CRNN_B,
                     CRNN["width"], CRNN["classes"], CRNN_LABELS)
    train = packed_on(fluid, feed, dev)
    startup.random_seed = seed
    scope, exe = fluid.Scope(), fluid.Executor()
    exe.run(startup, scope=scope)
    exe.run(prog, feed=train, fetch_list=[loss], scope=scope)
    torch.cuda.synchronize()
    reset_all_launches()
    t1 = time.perf_counter()
    losses = [float(exe.run(prog, feed=train, fetch_list=[loss],
                            scope=scope)[0]) for _ in range(5)]
    step_ms = (time.perf_counter() - t1) * 1000.0 / 5
    got = {n: c for n, c in all_launches().items() if c}
    expect = {n: 5 * v for n, v in want.items() if v}
    print("%s eager: losses %s; %.3f ms/step (with the loss's host read); "
          "launches %s, from the program %s" % (
              label, " ".join("%.6f" % v for v in losses), step_ms,
              json.dumps(got), json.dumps(expect)))
    if got != expect:
        raise AssertionError("%s launch counts" % label)
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError("%s: loss not finite and falling: %s"
                             % (label, losses))

    t_eager = time.perf_counter()
    # warpctc's share: its forward, and its grad op (the forward again
    # under autograd, then the backward), on the step's own logits
    lg = exe.run(prog, feed=train, fetch_list=[logits], scope=scope,
                 return_numpy=False)[0]
    ctc_op = next(op for op in prog.global_block().ops
                  if op.type == "warpctc")
    spec = registry.get("warpctc")
    ctx = TraceContext(device=dev).for_op(ctc_op)

    def ctc_fwd():
        spec.lower(ctx, {"Logits": [lg], "Label": [train["label"]]},
                   ctc_op.attrs, ctc_op)

    def ctc_grad():
        x = lg.data.detach().requires_grad_()
        with torch.enable_grad():
            out = spec.lower(ctx, {"Logits": [PackedSeq(x, lg.lengths)],
                                   "Label": [train["label"]]},
                             ctc_op.attrs, ctc_op)
            torch.autograd.grad(out["Loss"].sum(), x)
    ctc_fwd()
    ctc_grad()
    f_busy, f_ops = device_ops(ctc_fwd)
    g_busy, g_ops = device_ops(ctc_grad)
    ctc_busy = None if f_busy is None or g_busy is None else f_busy + g_busy

    # the eval program on the trained scope
    t_profile = time.perf_counter()
    fetches = [logits, decoded, dist]
    _, ids, lens, dists = crnn_eval(exe, test, fetches, train, scope)
    frames = CRNN["width"] // 8
    shape_ok = ids.shape == (CRNN_B, frames, 1)
    ids = ids[..., 0]
    valid = np.arange(ids.shape[1])[None, :] < lens[:, None]
    ok = shape_ok and (lens <= frames).all() and (ids[valid] >= 0).all() \
        and (ids[valid] < CRNN["classes"]).all() and not ids[~valid].any() \
        and np.isfinite(dists).all() and (dists >= 0).all() and \
        (dists == dists.round()).all()
    print("%s eval on the trained weights: decode lengths %d..%d, ids in "
          "%s, edit distances %d..%d (mean %.3f)" % (
              label, lens.min(), lens.max(),
              "[%d, %d]" % (ids[valid].min(), ids[valid].max())
              if valid.any() else "(none)", dists.min(), dists.max(),
              dists.mean()))
    if not ok:
        raise AssertionError("%s: decodes or distances out of range" % label)

    def ev_call():
        exe.run(test, feed=train, fetch_list=[decoded, dist], scope=scope,
                return_numpy=False)
    ev_call()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(3):
        ev_call()
    torch.cuda.synchronize()
    ev_ms = (time.perf_counter() - t1) * 1000.0 / 3
    ev_busy, ev_ops = device_ops(ev_call)
    print("%s eval call (eager, batch %d): host %.3f ms, device busy %s ms "
          "in %d device ops (card: %s)" % (
              label, CRNN_B, ev_ms, "%.3f" % ev_busy if ev_busy is not None
              else "not measured", ev_ops, card_line()))
    # six steps leave every frame's argmax on the blank (the blank's bias
    # grows first); from the startup's weights with the output layer
    # sharpened, the decodes hold labels
    fresh = fluid.Scope()
    exe.run(startup, scope=fresh)
    crnn_sharpen(prog, fresh)
    _, ids, lens, dists = crnn_eval(exe, test, fetches, train, fresh)
    ids = ids[..., 0]
    valid = np.arange(ids.shape[1])[None, :] < lens[:, None]
    if not (valid.any() and (ids[valid] >= 0).all()
            and (ids[valid] < CRNN["classes"]).all()
            and not ids[~valid].any() and (dists >= 0).all()):
        raise AssertionError("%s: sharpened decodes out of range" % label)
    print("%s eval from the startup's weights, output layer x%g: decode "
          "lengths %d..%d, ids in [%d, %d], edit distances %d..%d" % (
              label, CRNN_SHARPEN, lens.min(), lens.max(), ids[valid].min(),
              ids[valid].max(), dists.min(), dists.max()))
    del scope, fresh, exe
    torch.cuda.empty_cache()
    t_eval = time.perf_counter()

    res = graph_path(fluid, "crnn-ctc %s" % tag, (prog, startup, loss),
                     train, GRAPH_K["crnn"], 1, seed, want,
                     (CRNN_LTOL, RESNET_AB_PL2TOL, RESNET_AB_L2TOL))
    res.update(eval_host=ev_ms, eval_busy=ev_busy, ctc_busy=ctc_busy)
    step_busy = res["busy_eager"]
    print("%s: warpctc a step (forward, and its grad op's forward + "
          "backward) %s ms busy in %d device ops of the eager step's %s ms "
          "in %.0f: %s (card: %s)" % (
              label, "%.3f" % ctc_busy if ctc_busy is not None else
              "not measured", f_ops + g_ops, "%.3f" % step_busy
              if step_busy is not None else "not measured",
              res["ops_eager"], "%.1f%%" % (100.0 * ctc_busy / step_busy)
              if ctc_busy is not None and step_busy else "not measured",
              card_line()))
    del train
    torch.cuda.empty_cache()

    # the card against the CPU at CRNN_X's width, batch CRNN_X["batch"]
    t_graphs = time.perf_counter()
    kw = dict(CRNN, channels=CRNN_X["channels"], act=act)
    xfeed = crnn_feed(np.random.RandomState(seed + 12), CRNN_X["batch"],
                      CRNN["width"], CRNN["classes"], CRNN_LABELS)

    def build():
        built = crnn_build(fluid, **kw)
        return built[0], built[1], None, (built[3][0],)
    crnn_conditioning(fluid, build, seed, xfeed, label)
    cross_check(fluid, fluid.Executor(), build, seed, xfeed, 3,
                "%s channels %s, batch %d" % (label, CRNN_X["channels"],
                                              CRNN_X["batch"]),
                gtol=CRNN_GTOL, ltol=CRNN_LTOL, l2tol=CRNN_L2TOL,
                pl2_floor=CRNN_CANCELS)
    # the eval program from the same weights on both: the startup's, its
    # output layer sharpened (as the beam decode's comparison does), so
    # that frames decode to labels and not all to the blank
    with unique_name.guard():
        xprog, xstart, xtest, (xloss, xlogits), xdec = crnn_build(fluid,
                                                                  **kw)
    xstart.random_seed = seed
    cpu_scope, card_scope = fluid.Scope(), fluid.Scope()
    cpu = fluid.Executor(fluid.CPUPlace())
    cpu.run(xstart, scope=cpu_scope)
    crnn_sharpen(xprog, cpu_scope)
    interop.load_reference_state(
        {n: t.numpy() for n, t in cpu_scope.vars.items()}, card_scope,
        fluid.CUDAPlace(0), [xprog, xstart])
    xf = [xlogits] + list(xdec)
    c_lg, c_ids, c_lens, c_d = crnn_eval(cpu, xtest, xf, xfeed, cpu_scope)
    k_lg, k_ids, k_lens, k_d = crnn_eval(fluid.Executor(), xtest, xf,
                                         packed_on(fluid, xfeed, dev),
                                         card_scope)
    top2 = np.sort(c_lg, -1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    near = margin < CRNN_TIE
    flips = np.argmax(k_lg, -1) != np.argmax(c_lg, -1)
    if (flips & ~near).any():
        raise AssertionError("%s: a frame's argmax differs card against "
                             "CPU at a margin over %g" % (label, CRNN_TIE))
    rows_near = near.any(-1)
    same = [r for r in range(c_ids.shape[0]) if not rows_near[r]]
    if not (np.array_equal(k_ids[same], c_ids[same])
            and np.array_equal(k_lens[same], c_lens[same])
            and np.array_equal(k_d[same], c_d[same])):
        raise AssertionError("%s: decodes differ card against CPU" % label)
    print("card == cpu at %s channels %s, output layer x%g: decodes and "
          "edit distances equal on %d of %d rows (decode lengths %d..%d); "
          "frames under a top-two margin of %g: %d (in %d rows, excused), "
          "argmax flipped at %d of them" % (
              label, CRNN_X["channels"], CRNN_SHARPEN, len(same),
              c_ids.shape[0], c_lens.min(), c_lens.max(), CRNN_TIE,
              int(near.sum()), int(rows_near.sum()), int(flips.sum())))
    t1 = time.perf_counter()
    print("%s: %.1f s (eager steps %.1f, warpctc alone %.1f, eval %.1f, "
          "graphs %.1f, card against CPU %.1f)" % (
              label, t1 - t0, t_eager - t0, t_profile - t_eager,
              t_eval - t_profile, t_graphs - t_eval, t1 - t_graphs))
    return expect, res


def ocr_phase(fluid, seed, dev):
    """Phase 6h: the sequence and CTC families and the CRNN-CTC text
    recognizer on the card: the 16 types' sweep, B5/B6 at variant (b)'s
    shape, then variants (a) and (b) (crnn_variant). Returns ({kernel:
    max abs err}, B5/B6 launches on the main path)."""
    from paddle_tpu_torch.kernels import gru_cell as gc

    t0 = time.perf_counter()
    seq_sweep(dev, seed)
    t1 = time.perf_counter()
    g = torch.Generator(device="cpu").manual_seed(seed + 13)
    errs = crnn_gru_kernels(gc, g, dev)
    t2 = time.perf_counter()
    launched, nums = collections.Counter(), {}
    for tag, act in CRNN_ACTS:
        n, nums[tag] = crnn_variant(fluid, seed, dev, tag, act)
        launched.update(n)
    print("sequence/CTC phase parts: sweep %.1f s, B5/B6 at the CRNN's "
          "shape %.1f s, CRNN variants %.1f s" % (
              t1 - t0, t2 - t1, time.perf_counter() - t2))
    print("sequence/CTC phase: %.1f s; per variant host ms/step eager / "
          "graphs, busy ms/step eager / graphs, device ops a step, "
          "warpctc's share of the busy step, eval host / busy ms: %s "
          "(card: %s)" % (
              time.perf_counter() - t0, json.dumps({
                  tag: [None if v[n] is None else round(v[n], 3)
                        for n in ("host_eager", "host_graphs", "busy_eager",
                                  "busy_graphs")]
                  + [v["ops_eager"], None if not v["ctc_busy"]
                     or not v["busy_eager"] else
                     round(v["ctc_busy"] / v["busy_eager"], 4),
                     round(v["eval_host"], 3), None if v["eval_busy"] is None
                     else round(v["eval_busy"], 3)]
                  for tag, v in nums.items()}), card_line()))
    return errs, dict(launched)


# ---- phase 6i: the losses, the optimizers and the metrics ----

def optim_cases(rng):
    """Phase 6i (a)'s cases, (name, type, inputs, attrs): the loss,
    optimizer and metric types but ``nce`` (held apart: its draw) at the
    JAX sweeps' shapes (tests/test_op_sweep_nn.py:256-327 and 376-400,
    tests/test_op_sweep_optim_metric.py:24-175, 183-230 and 246), and
    conv_shift at the reference's NTM shape ([4, 17] against [4, 3])."""
    def f(*shape):
        return rng.randn(*shape).astype(np.float32)

    def pos(*shape):
        return (rng.rand(*shape) * 0.1 + 0.01).astype(np.float32)

    def bits(*shape):
        return (rng.rand(*shape) > 0.5).astype(np.float32)

    p, g, lr = rng.rand(4, 3).astype(np.float32), f(4, 3) - 0.5, \
        np.array([0.1], np.float32)
    b1p, b2p = np.array([0.9], np.float32), np.array([0.999], np.float32)
    probs = rng.rand(64).astype(np.float32)
    return [
        ("sigmoid_ce", "sigmoid_cross_entropy_with_logits",
         {"X": [f(4, 3) * 2], "Label": [bits(4, 3)]}, {}),
        ("huber", "huber_loss", {"X": [f(4, 3)], "Y": [f(4, 3)]},
         {"delta": 0.3}),
        ("smooth_l1", "smooth_l1_loss", {"X": [f(4, 3)], "Y": [f(4, 3)]},
         {"sigma": 2.0}),
        ("hinge", "hinge_loss", {"Logits": [f(4, 1) * 1.5],
                                 "Labels": [bits(4, 1)]}, {}),
        ("modified_huber", "modified_huber_loss",
         {"X": [f(4, 1) * 1.5], "Y": [bits(4, 1)]}, {}),
        ("rank", "rank_loss", {"Label": [bits(4, 1)], "Left": [f(4, 1)],
                               "Right": [f(4, 1)]}, {}),
        ("margin_rank", "margin_rank_loss",
         {"Label": [np.sign(f(4, 1))], "X1": [f(4, 1)], "X2": [f(4, 1)]},
         {"margin": 0.1}),
        ("log", "log_loss",
         {"Predicted": [rng.uniform(0.1, 0.9, (4, 1)).astype(np.float32)],
          "Labels": [bits(4, 1)]}, {"epsilon": 1e-4}),
        ("kldiv", "kldiv_loss",
         {"X": [np.log(rng.uniform(0.1, 0.9, (4, 5))).astype(np.float32)],
          "Target": [rng.uniform(0.1, 0.9, (4, 5)).astype(np.float32)]},
         {"reduction": "batchmean"}),
        ("bpr", "bpr_loss",
         {"X": [f(4, 6)], "Label": [rng.randint(0, 6, (4, 1))]}, {}),
        ("hsigmoid", "hierarchical_sigmoid",
         {"X": [rng.rand(4, 6).astype(np.float32)],
          "W": [rng.rand(7, 6).astype(np.float32)],
          "Label": [rng.randint(0, 8, (4, 1))], "Bias": [f(1, 7)]},
         {"num_classes": 8}),
        ("conv_shift", "conv_shift", {"X": [f(4, 17)], "Y": [f(4, 3)]}, {}),
        ("adamax", "adamax",
         {"Param": [p], "Grad": [g], "Moment": [pos(4, 3)],
          "InfNorm": [pos(4, 3)], "Beta1Pow": [b1p], "LearningRate": [lr]},
         {}),
        ("decayed_adagrad", "decayed_adagrad",
         {"Param": [p], "Grad": [g], "Moment": [pos(4, 3)],
          "LearningRate": [lr]}, {"decay": 0.95, "epsilon": 1e-6}),
        ("adadelta", "adadelta",
         {"Param": [p], "Grad": [g], "AvgSquaredGrad": [pos(4, 3)],
          "AvgSquaredUpdate": [pos(4, 3)]}, {"rho": 0.95, "epsilon": 1e-6}),
        ("rmsprop", "rmsprop",
         {"Param": [p], "Grad": [g], "Moment": [pos(4, 3)],
          "MeanSquare": [pos(4, 3) + 0.1], "MeanGrad": [f(4, 3) * 0.01],
          "LearningRate": [lr]},
         {"decay": 0.95, "epsilon": 1e-6, "momentum": 0.9}),
        ("rmsprop_centered", "rmsprop",
         {"Param": [p], "Grad": [g], "Moment": [pos(4, 3)],
          "MeanSquare": [pos(4, 3) + 0.1], "MeanGrad": [f(4, 3) * 0.01],
          "LearningRate": [lr]},
         {"decay": 0.95, "epsilon": 1e-6, "momentum": 0.9, "centered": True}),
        ("ftrl", "ftrl",
         {"Param": [p], "Grad": [g], "SquaredAccumulator": [pos(4, 3)],
          "LinearAccumulator": [pos(4, 3)], "LearningRate": [lr]},
         {"l1": 0.1, "l2": 0.1}),
        ("proximal_gd", "proximal_gd",
         {"Param": [p], "Grad": [g], "LearningRate": [lr]},
         {"l1": 0.05, "l2": 0.05}),
        ("proximal_adagrad", "proximal_adagrad",
         {"Param": [p], "Grad": [g], "Moment": [pos(4, 3)],
          "LearningRate": [lr]}, {"l1": 0.05, "l2": 0.05}),
        ("lamb", "lamb",
         {"Param": [p], "Grad": [g], "Moment1": [pos(4, 3)],
          "Moment2": [pos(4, 3)], "Beta1Pow": [b1p], "Beta2Pow": [b2p],
          "LearningRate": [lr]}, {"weight_decay": 0.01}),
        ("average_accumulates", "average_accumulates",
         {"param": [rng.rand(3, 2).astype(np.float32)],
          "in_sum_1": [pos(3, 2)], "in_sum_2": [pos(3, 2)],
          "in_sum_3": [pos(3, 2)],
          "in_num_accumulates": [np.array([0], np.int64)],
          "in_old_num_accumulates": [np.array([0], np.int64)],
          "in_num_updates": [np.array([0], np.int64)]},
         {"average_window": 10, "max_average_window": 20}),
        ("auc", "auc",
         {"Predict": [np.stack([1 - probs, probs], 1)],
          "Label": [rng.randint(0, 2, (64, 1))],
          "StatPos": [np.floor(pos(4096) * 100)],
          "StatNeg": [np.floor(pos(4096) * 100)]}, {}),
        ("precision_recall", "precision_recall",
         {"Indices": [np.array([0, 1, 1, 2], np.int64)],
          "Labels": [np.array([[0], [1], [2], [2]], np.int64)],
          "StatesInfo": [np.floor(pos(3, 4) * 100)]},
         {"class_number": 3}),
        ("positive_negative_pair", "positive_negative_pair",
         {"Score": [np.array([0.9, 0.2, 0.5, 0.6, 0.5], np.float32)],
          "Label": [np.array([1.0, 0.0, 0.0, 1.0, 2.0], np.float32)],
          "QueryID": [np.array([7, 7, 7, 7, 3], np.int64)]}, {}),
        ("mean_iou", "mean_iou",
         {"Predictions": [np.array([0, 1, 1, 1], np.int64)],
          "Labels": [np.array([0, 1, 1, 0], np.int64)]},
         {"num_classes": 3}),
    ]


def optim_sweep(dev, seed):
    """Phase 6i (a): the 26 types on the card against the CPU from the
    same numpy inputs: outputs, and the losses' gradients by autograd;
    integers and every integer-valued float (counts, ``Activated``)
    exact, floats within DENSE_RTOL plus DENSE_AMAX of the largest
    magnitude. ``nce``: its draw a function of the op's stream (the same
    bits twice, others under another uid), the label columns first,
    negatives in range and uniform within 0.03 over NCE_DRAWS draws; its
    arithmetic and gradients on the card's ids against the CPU's on the
    same ids."""
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.ops import nn_ops

    rng = np.random.RandomState(seed + 29)
    cpu = torch.device("cpu")
    worst, types, n_grads, exact = 0.0, set(), 0, 0
    for name, type, ins, attrs in optim_cases(rng):
        types.add(type)
        want, _ = _lower(type, ins, attrs, cpu)
        got, _ = _lower(type, ins, attrs, dev)
        for k, (g, w) in enumerate(zip(got, want)):
            worst = max(worst, _dense_close("%s out %d" % (name, k), g, w))
            if np.issubdtype(w.dtype, np.floating) and \
                    np.array_equal(w, np.round(w)):
                exact += 1
                if not np.array_equal(g, w):
                    raise AssertionError("%s out %d: a count differs"
                                         % (name, k))
        if registry.get(type).no_grad:
            continue
        cots = [np.asarray(rng.randn(*w.shape), np.float32) for w in want
                if np.issubdtype(w.dtype, np.floating)]
        _, gw = _lower(type, ins, attrs, cpu, grad_cots=cots)
        _, gg = _lower(type, ins, attrs, dev, grad_cots=cots)
        for k, (g, w) in enumerate(zip(gg, gw)):
            worst = max(worst, _dense_close("%s grad %d" % (name, k), g, w))
            n_grads += 1
    # nce: the draw, then the arithmetic on the card's ids
    types.add("nce")
    attrs = {"num_neg_samples": 3, "num_total_classes": 10}
    ins = {"Input": [rng.rand(4, 6).astype(np.float32)],
           "Weight": [rng.rand(10, 6).astype(np.float32)],
           "Bias": [rng.randn(10, 1).astype(np.float32)],
           "Label": [rng.randint(0, 10, (4, 1))]}
    out, _ = _lower("nce", ins, attrs, dev, key=seed)
    again, _ = _lower("nce", ins, attrs, dev, key=seed)
    other, _ = _lower("nce", ins, attrs, dev, key=seed, uid=2)
    ids = out[1]            # the outputs by slot: Cost, SampleLabels, ...
    if not all(np.array_equal(a, b) for a, b in zip(out, again)) or \
            np.array_equal(ids, other[1]):
        raise AssertionError("nce: not a function of its stream")
    rows, total = NCE_DRAWS // 10, 20
    big = {"Input": [np.zeros((rows, 2), np.float32)],
           "Weight": [np.zeros((total, 2), np.float32)],
           "Label": [np.arange(rows)[:, None] % total]}
    drawn, _ = _lower("nce", big, {"num_neg_samples": 10,
                                   "num_total_classes": total}, dev, key=seed)
    neg = drawn[1][:, 1:]
    freq = np.bincount(neg.ravel(), minlength=total) / neg.size
    if not np.array_equal(drawn[1][:, 0], big["Label"][0][:, 0]) or \
            neg.min() < 0 or neg.max() >= total or \
            np.abs(freq - 1.0 / total).max() >= 0.03:
        raise AssertionError("nce: the draw's properties fail on the card: "
                             "frequencies %s" % freq)
    res = {}
    for d in (cpu, dev):
        leaves = [torch.from_numpy(ins[k][0]).to(d).requires_grad_()
                  for k in ("Input", "Weight", "Bias")]
        cost, logits = nn_ops.nce_logits(
            *leaves, torch.from_numpy(ids.astype(np.int64)).to(d), 1, 3, 10)
        c = torch.from_numpy(np.ones(cost.shape, np.float32)).to(d)
        grads = torch.autograd.grad([cost, logits], leaves,
                                    [c, torch.ones_like(logits)])
        res[d.type] = [v.detach().cpu().numpy()
                       for v in [cost, logits, *grads]]
    for k, (g, w) in enumerate(zip(res[dev.type], res["cpu"])):
        worst = max(worst, _dense_close("nce on the card's ids %d" % k, g, w))
    _dense_close("nce Cost from the op", out[0], res[dev.type][0])
    if len(types) != OPTIM_TYPES:
        raise AssertionError("the sweep covers %d types" % len(types))
    print("losses/optimizers/metrics sweep: %d types on the card against "
          "the CPU, %d gradients; integers and %d integer-valued float "
          "outputs exact, the worst float %.3g x max|ref| (bound rtol %g + "
          "%g x max|ref|); nce's draw the same bits from the same stream, "
          "uniform within %.4f over %d draws (bound 0.03)" % (
              len(types), n_grads + 3, exact, worst, DENSE_RTOL, DENSE_AMAX,
              float(np.abs(freq - 1.0 / total).max()), neg.size))
    return worst


def optim_build(fluid, kind, kw, dict_dim=None, emb_dim=None, hid_dim=None,
                average=False):
    """The stacked-LSTM classifier (``models.stacked_lstm.stacked_lstm_net``
    of ``fluid``, either package) with cross entropy,
    ``evaluator.Accuracy`` and ``layers.auc``, trained by
    ``fluid.optimizer.<kind>(**kw)``; the eval program is the forward
    cloned for test before the optimizer. ``average`` appends
    ``ModelAverage.accumulate``. Feeds "words" (ragged ids) and
    "label"; the widths default to DICT, EMB and HID. Returns the
    programs and variables by name."""
    import importlib

    dict_dim, emb_dim, hid_dim = dict_dim or DICT, emb_dim or EMB, \
        hid_dim or HID
    layers = fluid.layers
    net = importlib.import_module(
        fluid.__name__ + ".models.stacked_lstm").stacked_lstm_net
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        words = layers.data("words", [1], dtype="int64", lod_level=1)
        label = layers.data("label", [1], dtype="int64")
        predict = net(words, dict_dim, CLASSES, emb_dim, hid_dim, STACKED)
        loss = layers.mean(layers.cross_entropy(predict, label))
        ev = fluid.evaluator.Accuracy(input=predict, label=label)
        auc, _, stats = layers.auc(predict, label)
        test = prog.clone(for_test=True)
        getattr(fluid.optimizer, kind)(**kw).minimize(loss)
        avg = None
        if average:
            avg = fluid.optimizer.ModelAverage()
            avg.accumulate(loss)
    return dict(prog=prog, startup=startup, test=test, loss=loss,
                acc=ev.metrics[0], auc=auc, stats=stats, ev=ev,
                predict=predict, average=avg)


def v2_stacked_build(paddle, dict_dim, emb_dim=EMB, hid_dim=HID,
                     stacked_num=STACKED, act=None):
    """The v2 book's stacked-LSTM sentiment net in either package's v2
    DSL (``paddle`` is ``paddle_tpu.v2`` or ``paddle_tpu_torch.v2``):
    embedding, fc(4 hid_dim) -> lstmemory, stacked_num - 1 more
    fc([fc, lstm]) -> lstmemory pairs, every second one reversed, the max
    pools of the last fc and the last lstm, a softmax fc over CLASSES,
    classification_cost. ``act`` is lstmemory's candidate activation
    (None: tanh; the book passes Relu, which takes the step loop). Data
    layers "words" (ids) and "label". Returns (cost, output)."""
    words = paddle.layer.data(
        "words", paddle.data_type.integer_value_sequence(dict_dim))
    label = paddle.layer.data("label",
                              paddle.data_type.integer_value(CLASSES))
    emb = paddle.layer.embedding(input=words, size=emb_dim)
    fc = paddle.layer.fc(input=emb, size=hid_dim * 4)
    lstm = paddle.layer.lstmemory(input=fc, act=act)
    for i in range(2, stacked_num + 1):
        fc = paddle.layer.fc(input=[fc, lstm], size=hid_dim * 4)
        lstm = paddle.layer.lstmemory(input=fc, reverse=i % 2 == 0,
                                      act=act)
    fc_last = paddle.layer.pooling(input=fc,
                                   pooling_type=paddle.pooling.Max())
    lstm_last = paddle.layer.pooling(input=lstm,
                                     pooling_type=paddle.pooling.Max())
    output = paddle.layer.fc(input=[fc_last, lstm_last], size=CLASSES,
                             act=paddle.activation.Softmax())
    return paddle.layer.classification_cost(input=output, label=label), \
        output


def v2_gru_build(paddle, dict_dim, emb_dim=EMB, hid_dim=HID):
    """A v2 GRU classifier in either package's v2 DSL: embedding,
    fc(3 hid_dim) -> grumemory (hidden hid_dim, tanh), max pool, a
    softmax fc over CLASSES, classification_cost; data layers "words"
    and "label". Returns (cost, output)."""
    words = paddle.layer.data(
        "words", paddle.data_type.integer_value_sequence(dict_dim))
    label = paddle.layer.data("label",
                              paddle.data_type.integer_value(CLASSES))
    emb = paddle.layer.embedding(input=words, size=emb_dim)
    gru = paddle.layer.grumemory(
        input=paddle.layer.fc(input=emb, size=hid_dim * 3))
    pooled = paddle.layer.pooling(input=gru,
                                  pooling_type=paddle.pooling.Max())
    output = paddle.layer.fc(input=pooled, size=CLASSES,
                             act=paddle.activation.Softmax())
    return paddle.layer.classification_cost(input=output, label=label), \
        output


def update_share(exe, prog, loss, scope, feed, k, label):
    """The update ops' (those whose lowering writes a ``ParamOut``) share
    of an eager step, from the step's own trace: UPDATE_PROFILES
    profiles (host and device) of ``k`` warm eager steps each, every
    update op's lowering inside a record_function range (UPDATE_RANGE).
    Per profile: the device busy ms a step (every kernel, copy and set)
    and the device ms of the kernels launched inside the ranges; the
    median of each, and of their ratio. Also the bytes a one-pass update
    must move (each parameter-shaped input read once, each
    parameter-shaped output written once, as the lowerings were handed
    them) over HBM_BYTES_PER_S. Returns the numbers."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from paddle_tpu_torch.core import registry

    specs = sorted({registry.get(op.type) for op in prog.global_block().ops
                    if registry.has(op.type) and "ParamOut"
                    in registry.get(op.type).stateful_outputs},
                   key=lambda sp: sp.type)
    moved, n_params = {}, {}

    def annotated(lower):
        def run(ctx, ins, attrs, op):
            with record_function(UPDATE_RANGE):
                out = lower(ctx, ins, attrs, op)
            shape = ins["Param"][0].shape
            read = [t for sl, v in ins.items() if not (
                op.type == "rmsprop" and sl == "MeanGrad"
                and not attrs.get("centered", False))      # not read
                for t in v]
            wrote = [t for v in registry.normalize_outputs(out).values()
                     for t in v]
            moved[op.uid] = sum(t.numel() * t.element_size()
                                for t in read + wrote
                                if isinstance(t, torch.Tensor)
                                and t.shape == shape)
            n_params[op.uid] = ins["Param"][0].numel()
            return out
        return run

    def steps():
        for _ in range(k):
            exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()

    orig = [sp.lower for sp in specs]
    samples = []
    try:
        for sp in specs:
            sp.lower = annotated(sp.lower)
        steps()                                          # warm
        for _ in range(UPDATE_PROFILES):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                steps()
            ev = prof.events()
            busy = sum(e.time_range.elapsed_us() for e in ev
                       if str(e.device_type).endswith("CUDA")
                       and e.name != UPDATE_RANGE
                       and not getattr(e, "is_user_annotation", False))
            upd = sum(e.device_time_total for e in ev
                      if e.name == UPDATE_RANGE
                      and str(e.device_type).endswith("CPU"))
            samples.append((busy / 1000.0 / k, upd / 1000.0 / k))
    finally:
        for sp, lower in zip(specs, orig):
            sp.lower = lower
    busy = float(np.median([b for b, _ in samples]))
    upd = float(np.median([u for _, u in samples]))
    share = float(np.median([u / b for b, u in samples])) if busy else None
    total = sum(moved.values())
    bound = total / HBM_BYTES_PER_S * 1000.0
    n = sum(n_params.values())
    print("%s: %d update ops (%s) over %d parameters (%.1f MB float32), "
          "from %d profiles of %d eager steps: update kernels %s ms a step "
          "(median; each profile %s), %s of the step's busy %.3f ms "
          "(median; each %s); a one-pass update moves %.1f MB, %.4f ms at "
          "%.2f TB/s (%s)" % (
              label, len(moved), ",".join(sp.type for sp in specs), n,
              n * 4 / 1e6, UPDATE_PROFILES, k, "%.4f" % upd,
              " ".join("%.4f" % u for _, u in samples),
              "%.2f%%" % (100.0 * share) if share is not None
              else "a share not measured", busy,
              " ".join("%.4f" % b for b, _ in samples), total / 1e6, bound,
              HBM_BYTES_PER_S / 1e12,
              "%.1fx the bound" % (upd / bound) if upd else "-"))
    if not upd:
        raise AssertionError("%s: the profiles put no device time in the "
                             "update ops' ranges" % label)
    return dict(update_busy=upd, update_share=share, update_step_busy=busy,
                update_mb=total / 1e6, update_bound=bound)


def binned_auc(scores, labels, bins=4096):
    """P(a positive's bin > a negative's) + half P(equal), by pairs, over
    the bins layers.auc puts scores in."""
    b = np.clip((scores.astype(np.float32) * (bins - 1)).astype(np.int64), 0,
                bins - 1)
    pos, neg = b[labels == 1], b[labels == 0]
    if not pos.size or not neg.size:
        return 0.0
    d = pos[:, None] - neg[None, :]
    return float((d > 0).sum() + 0.5 * (d == 0).sum()) / d.size


def optim_path(fluid, seed, dev, tag, kind, kw):
    """Phase 6i (b): the stacked LSTM at full width under one optimizer:
    startup, 1 + OPTIM_STEPS eager steps with a finite falling loss and
    B3/B4 launches exactly the program's; ModelAverage's sums and counts
    (on the OPTIM_AVERAGE run) against the parameters summed on the host;
    the for_test clone over OPTIM_EVAL_BATCHES batches (3 B3 a batch from
    the program): the streamed AUC against metrics.Auc and a numpy AUC on
    the same predictions, evaluator.Accuracy and WeightedAverage against
    the pass accuracy; run_chunk's graph replays bitwise against eager
    steps; the update ops' share of the step; on the OPTIM_XCHECK runs the
    card against the CPU at XCHECK's size. Returns (B3/B4 launches,
    numbers)."""
    from paddle_tpu_torch import average, metrics, unique_name

    started = time.perf_counter()
    label = "stacked LSTM under %s" % tag
    with unique_name.guard():
        m = optim_build(fluid, kind, kw, average=tag == OPTIM_AVERAGE)
    prog, startup, loss = m["prog"], m["startup"], m["loss"]
    startup.random_seed = seed
    scope, exe = fluid.Scope(), fluid.Executor()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(seed)
    lens, words, lab = stacked_lstm_batch(rng, LSTM_B, LSTM_T, MIN_LEN, DICT)
    on_card = packed_on(fluid, {"words": words, "label": lab}, dev)
    fwd, bwd = recurrent_launches(prog, "lstm")
    ma = m["average"]
    host_sums = {n: torch.zeros(scope.find_var(n).shape)
                 for n in (ma.params if ma else ())}

    def accumulate():
        for n, acc in host_sums.items():
            acc += scope.find_var(n).cpu()
    losses, run_s = [], 0.0
    for i in range(OPTIM_WARMUP + OPTIM_STEPS):
        if i == OPTIM_WARMUP:
            torch.cuda.synchronize()
            reset_all_launches()
            run_s = 0.0
        t0 = time.perf_counter()
        losses.append(float(exe.run(prog, feed=on_card, fetch_list=[loss],
                                    scope=scope)[0]))
        run_s += time.perf_counter() - t0
        accumulate()
    step_ms = run_s * 1000.0 / OPTIM_STEPS
    got = {n: c for n, c in all_launches().items() if c}
    want = {n: c for n, c in (("lstm_fwd", fwd * OPTIM_STEPS),
                              ("lstm_bwd", bwd * OPTIM_STEPS)) if c}
    counted = losses[OPTIM_WARMUP:]
    print("%s: losses %s (warmup %.6f); eager %.3f ms/step with the loss's "
          "host read; launches %s, from the program %s" % (
              label, " ".join("%.6f" % v for v in counted), losses[0],
              step_ms, json.dumps(got), json.dumps(want)))
    if got != want:
        raise AssertionError("%s: launches %s != %s" % (label, got, want))
    if not np.isfinite(losses).all() or not counted[-1] < counted[0]:
        raise AssertionError("%s: loss not finite and falling: %s"
                             % (label, losses))
    if ma is not None:
        worst = 0.0
        for n, (s, c) in ma.params.items():
            dsum = scope.find_var(s.name).cpu()
            np.testing.assert_allclose(dsum.numpy(), host_sums[n].numpy(),
                                       rtol=1e-6, err_msg=n)
            worst = max(worst, float((dsum - host_sums[n]).abs().max()
                                     / host_sums[n].abs().max()))
            if float(scope.find_var(c.name).cpu()[0]) != len(losses):
                raise AssertionError("ModelAverage count of %s" % n)
        print("%s: ModelAverage over %d parameters: sums equal the "
              "parameters summed on the host after each of %d steps "
              "(worst %.3g x max, bound rtol 1e-6), counts %d" % (
                  label, len(ma.params), len(losses), worst, len(losses)))

    # the for_test clone streams the metrics over fresh batches
    test, (tfwd, _) = m["test"], recurrent_launches(m["test"], "lstm")
    ref, wavg = metrics.Auc(), average.WeightedAverage()
    scores, labels = [], []
    with fluid.scope_guard(scope):
        m["ev"].reset()
        for v in m["stats"]:
            scope.set_var(v.name, torch.zeros_like(scope.find_var(v.name)))
        reset_all_launches()
        t0 = time.perf_counter()
        for _ in range(OPTIM_EVAL_BATCHES):
            _, w, y = stacked_lstm_batch(rng, LSTM_B, LSTM_T, MIN_LEN, DICT)
            pr, a, auc = exe.run(test, feed={"words": w, "label": y},
                                 fetch_list=[m["predict"], m["acc"],
                                             m["auc"]], scope=scope)
            ref.update(pr, y)
            wavg.add(a, LSTM_B)
            scores.append(pr[:, 1])
            labels.append(y[:, 0])
        eval_ms = (time.perf_counter() - t0) * 1000.0 / OPTIM_EVAL_BATCHES
        passed = m["ev"].eval()
    got = {n: c for n, c in all_launches().items() if c}
    scores, labels = np.concatenate(scores), np.concatenate(labels)
    pass_acc = float((np.argmax(np.stack([1 - scores, scores], 1), 1)
                      == labels).mean())
    exact = binned_auc(scores, labels)
    print("%s: eval over %d batches: streamed AUC %.7f, metrics.Auc %.7f, "
          "numpy AUC %.7f on the bins (%.7f on the raw scores); pass "
          "accuracy %.6f, evaluator.Accuracy %.6f, WeightedAverage %.6f; "
          "%.3f host ms a batch; launches %s, from the program %d B3 a "
          "batch" % (label, OPTIM_EVAL_BATCHES, float(auc), ref.eval(), exact,
                     binned_auc(scores, labels, bins=1 << 24), pass_acc,
                     float(passed[0]), wavg.eval(), eval_ms, json.dumps(got),
                     tfwd))
    if got != ({"lstm_fwd": tfwd * OPTIM_EVAL_BATCHES} if tfwd else {}):
        raise AssertionError("%s: eval launches %s" % (label, got))
    if abs(float(auc) - ref.eval()) > 1e-6 * max(ref.eval(), 1e-30) or \
            abs(ref.eval() - exact) > 1e-6 or \
            abs(float(passed[0]) - pass_acc) > 1e-6 or \
            abs(wavg.eval() - pass_acc) > 1e-6:
        raise AssertionError("%s: the eval pass's metrics disagree" % label)
    launched = {"lstm_fwd": fwd * OPTIM_STEPS + tfwd * OPTIM_EVAL_BATCHES,
                "lstm_bwd": bwd * OPTIM_STEPS}
    nums = graph_path(fluid, label, (prog, startup, loss), on_card,
                      GRAPH_K["optim"], 1, seed,
                      {"lstm_fwd": fwd, "lstm_bwd": bwd},
                      (1e-4, RESNET_AB_PL2TOL, RESNET_AB_L2TOL))
    nums.update(update_share(exe, prog, loss, scope, on_card,
                             GRAPH_K["optim"], label))
    nums.update(eval_ms=eval_ms, step_ms=step_ms)
    print("%s: %.1f s" % (label, time.perf_counter() - started))
    del scope, exe
    torch.cuda.empty_cache()

    xlens, xwords, xlabel = stacked_lstm_batch(rng, XCHECK_B, XCHECK_T, 1,
                                               XCHECK["dict_dim"])

    def build():
        x = optim_build(fluid, kind, kw, dict_dim=XCHECK["dict_dim"],
                        emb_dim=XCHECK["emb_dim"], hid_dim=XCHECK["hid_dim"],
                        average=tag == OPTIM_AVERAGE)
        return x["prog"], x["startup"], None, (x["loss"],)

    if tag in OPTIM_XCHECK:
        cross_check(fluid, fluid.Executor(), build, seed,
                    {"words": xwords, "label": xlabel}, XCHECK_STEPS,
                    "%s, %s, B %d" % (label, XCHECK, XCHECK_B),
                    state_tol=OPTIM_STATE_TOL)
    return launched, nums


class SameDraws:
    """nce's negatives drawn on the card and replayed in order on the
    CPU, whose generator gives other numbers from the same seed: while
    entered, ``ops.nn_ops.nce_draw`` records each draw made on the card
    and hands the CPU the oldest recorded one."""

    def __enter__(self):
        from paddle_tpu_torch.ops import nn_ops

        self.orig, self.drawn = nn_ops.nce_draw, collections.deque()

        def draw(gen, batch, num_neg, total, device):
            if device.type == "cpu":
                return self.drawn.popleft().to(device)
            ids = self.orig(gen, batch, num_neg, total, device)
            if device.type == "cuda":
                self.drawn.append(ids)
            return ids
        nn_ops.nce_draw = draw
        return self

    def __exit__(self, *exc):
        from paddle_tpu_torch.ops import nn_ops

        nn_ops.nce_draw = self.orig


def w2v_head_path(fluid, seed, dev, head):
    """Phase 6i (c): word2vec at BOOK_W2V's widths with the ``head``
    ("hsigmoid" or "nce") over its 2073 words: a finite falling loss over
    BOOK_W2V_STEPS eager steps, run_chunk's graph replays bitwise against
    eager steps, the update ops' share of the step, and the card against
    the CPU from the same weights (3 losses within rtol 1e-4, first-step
    gradients within 1e-4 x max|g|; nce's draws the card's on both).
    Returns the numbers."""
    from paddle_tpu_torch import unique_name

    label = "word2vec with the %s head" % head
    feed = w2v_feed(np.random.RandomState(seed + 7), BOOK_W2V_B,
                    BOOK_W2V["dict_size"])
    on_card = {n: torch.from_numpy(v).to(dev) for n, v in feed.items()}
    with unique_name.guard():
        prog, startup, _, (loss,) = w2v_build(fluid, head=head)
    startup.random_seed = seed
    scope, exe = fluid.Scope(), fluid.Executor()
    exe.run(startup, scope=scope)
    exe.run(prog, feed=on_card, fetch_list=[loss], scope=scope)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [float(exe.run(prog, feed=on_card, fetch_list=[loss],
                            scope=scope)[0])
              for _ in range(BOOK_W2V_STEPS)]
    step_ms = (time.perf_counter() - t0) * 1000.0 / BOOK_W2V_STEPS
    print("%s: losses %s; eager %.3f ms/step (with the loss's host read)"
          % (label, " ".join("%.6f" % v for v in losses), step_ms))
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError("%s: loss not finite and falling: %s"
                             % (label, losses))
    nums = graph_path(fluid, label, (prog, startup, loss), on_card,
                      GRAPH_K["w2v"], GRAPH_CHUNKS, seed, {},
                      (1e-4, RESNET_AB_PL2TOL, RESNET_AB_L2TOL))
    nums.update(update_share(exe, prog, loss, scope, on_card,
                             GRAPH_K["w2v"], label))
    nums["step_ms"] = step_ms
    del scope, exe
    with SameDraws() if head == "nce" else contextlib.nullcontext():
        cross_check(fluid, fluid.Executor(),
                    lambda: w2v_build(fluid, head=head), seed, feed, 3, label)
    torch.cuda.empty_cache()
    return nums


def optim_phase(fluid, seed, dev):
    """Phase 6i: the losses, the optimizers and the metrics on the card:
    the 26 types' sweep, the stacked LSTM under each of OPTIMIZERS
    (optim_path), word2vec with each of W2V_HEADS (w2v_head_path).
    Returns the B3/B4 launches on the main path."""
    t0 = time.perf_counter()
    optim_sweep(dev, seed)
    t1 = time.perf_counter()
    launched, nums = collections.Counter(), {}
    for tag, kind, kw in OPTIMIZERS:
        n, nums[tag] = optim_path(fluid, seed, dev, tag, kind, kw)
        launched.update(n)
    t2 = time.perf_counter()
    for head in W2V_HEADS:
        nums["w2v_" + head] = w2v_head_path(fluid, seed, dev, head)
    print("losses/optimizers/metrics phase parts: sweep %.1f s, stacked "
          "LSTM under %d optimizers %.1f s, word2vec heads %.1f s" % (
              t1 - t0, len(OPTIMIZERS), t2 - t1, time.perf_counter() - t2))
    keys = ("host_eager", "host_graphs", "busy_eager", "busy_graphs",
            "ops_eager", "update_busy", "update_step_busy", "update_share",
            "update_mb", "update_bound")
    print("losses/optimizers/metrics phase: %.1f s; per run %s: %s (card: "
          "%s)" % (time.perf_counter() - t0, ", ".join(keys), json.dumps({
              tag: [None if v.get(k) is None else round(v[k], 4)
                    for k in keys] for tag, v in nums.items()}), card_line()))
    return dict(launched)


@contextlib.contextmanager
def v2_session(fluid, paddle, use_gpu, seed):
    """A fresh main and startup program (the startup seeded), scope and
    name counters, with ``paddle.init(use_gpu=use_gpu)``: the place of
    every executor v2 makes inside."""
    with fluid.unique_name.guard(), \
            fluid.program_guard(fluid.Program(), fluid.Program()), \
            fluid.scope_guard(fluid.Scope()):
        paddle.init(use_gpu=use_gpu, trainer_count=1)
        fluid.default_startup_program().random_seed = seed
        yield


def v2_reader(paddle, word_dict, batches, batch=V2_B, split="train"):
    """The v2 book's reader: ``batches`` batches of ``batch`` rows of
    ``paddle.batch(paddle.reader.shuffle(paddle.dataset.imdb.<split>(
    word_dict), V2_SHUFFLE), batch)`` (``random`` seeded by the
    caller)."""
    rows = getattr(paddle.dataset.imdb, split)(word_dict)
    return paddle.reader.firstn(paddle.batch(
        paddle.reader.shuffle(rows, buf_size=V2_SHUFFLE), batch), batches)


def v2_train_path(fluid, paddle, seed, dev, label, build, op_type, n_train,
                  n_test, batch=V2_B, checkpoint=True):
    """One v2 model on the card through its own entry points: ``init``,
    the layers (``build()`` returns (cost, output)),
    ``parameters.create``, ``trainer.SGD(...).train`` over ``n_train``
    batches of the imdb reader with an event handler that records each
    ``EndIteration`` cost, ``trainer.test`` over ``n_test`` batches; with
    ``checkpoint``, ``Parameters.to_tar`` and ``from_tar`` (every array
    equal) and ``paddle.infer`` on V2_INFER_ROWS rows with the detached
    and with the live parameters (the same bits). The ``op_type``
    kernels' launches over the whole run must equal the programs' (from
    the program, as phase 6i derives them). Returns (launches, numbers)."""
    from paddle_tpu_torch.v2 import feeder

    started = time.perf_counter()
    word_dict = paddle.dataset.imdb.word_dict()
    kernels = {"lstm": ("lstm_fwd", "lstm_bwd"),
               "gru": ("gru_fwd", "gru_bwd")}[op_type]
    nums = {}
    with v2_session(fluid, paddle, True, seed):
        cost, output = build()
        params = paddle.parameters.create(cost)
        scope = fluid.global_scope()
        n_params = sum(scope.find_var(n).numel() for n in params.names())
        if scope.find_var(params.names()[0]).device != dev:
            raise AssertionError("%s: parameters on %s" % (
                label, scope.find_var(params.names()[0]).device))
        sgd = paddle.trainer.SGD(
            cost=cost, parameters=params,
            update_equation=paddle.optimizer.Adam(learning_rate=V2_LR))
        prog = cost.block.program
        fwd, bwd = recurrent_launches(prog, op_type)
        tfwd, _ = recurrent_launches(sgd._test_program, op_type)
        ifwd = recurrent_launches(paddle.inference.Inference(
            output, params)._program, op_type)[0] if checkpoint else 0
        random.seed(seed)
        seen, costs, batch_ms, began = [], [], [], []

        def recorded():
            for b in v2_reader(paddle, word_dict, n_train, batch)():
                seen.append(b)
                yield b

        def handler(e):
            if isinstance(e, paddle.event.BeginIteration):
                began.append(time.perf_counter())
            elif isinstance(e, paddle.event.EndIteration):
                batch_ms.append((time.perf_counter() - began[-1]) * 1e3)
                costs.append(e.cost)

        torch.cuda.synchronize()
        reset_all_launches()
        t0 = time.perf_counter()
        sgd.train(recorded, num_passes=1, event_handler=handler)
        train_s = time.perf_counter() - t0
        result = sgd.test(v2_reader(paddle, word_dict, n_test, batch,
                                    split="test"))
        if checkpoint:
            t0 = time.perf_counter()
            buf = io.BytesIO()
            params.to_tar(buf)
            buf.seek(0)
            detached = paddle.parameters.Parameters.from_tar(buf)
            tar_s = time.perf_counter() - t0
            rows = [(ids,) for ids, _ in paddle.reader.firstn(
                paddle.dataset.imdb.test(word_dict), V2_INFER_ROWS)()]
            probs = [paddle.infer(output_layer=output, parameters=p,
                                  input=rows) for p in (detached, params)]
        torch.cuda.synchronize()
        got = {n: c for n, c in all_launches().items() if c}
        want = {kernels[0]: fwd * n_train + tfwd * n_test + 2 * ifwd,
                kernels[1]: bwd * n_train}
        want = {n: c for n, c in want.items() if c}
        lens = [len(r[0]) for b in seen for r in b]
        print("%s: %d parameters on %s; %d batches of %d rows of %d..%d "
              "ids: costs %s; eager %.3f host ms a batch (median; the cost's "
              "host read included), %.3f s in all; test() cost %.6f over %d "
              "batches; launches %s, from the programs %s (%d + %d a "
              "training step, %d a test batch, %d an infer call)" % (
                  label, n_params, dev, len(seen), batch, min(lens),
                  max(lens), " ".join("%.6f" % c for c in costs),
                  float(np.median(batch_ms)), train_s, result.cost, n_test,
                  json.dumps(got), json.dumps(want), fwd, bwd, tfwd, ifwd))
        if got != want:
            raise AssertionError("%s: launches %s != %s" % (label, got,
                                                             want))
        # learning, read on held-out rows: test() after the pass below
        # the first batch's cost (batch costs are one batch each and may
        # jump: Adam on the nearly separable synthetic rows overshot at
        # full width on an H100, 0.025 then 2.74 then 4e-6, the test
        # cost 1.9e-4)
        if len(costs) != n_train or not np.isfinite(costs).all() or \
                not np.isfinite(result.cost) or \
                not result.cost < costs[0]:
            raise AssertionError("%s: costs not finite, or test() not "
                                 "below the first batch's cost: %s, test "
                                 "%s" % (label, costs, result.cost))
        if checkpoint:
            for n in params.names():
                if not np.array_equal(detached[n], params[n]):
                    raise AssertionError("%s: from_tar's %s differs" % (
                        label, n))
            for p in probs:
                if p.shape != (V2_INFER_ROWS, CLASSES) or \
                        not np.isfinite(p).all() or \
                        np.abs(p.sum(1) - 1).max() > 1e-5:
                    raise AssertionError("%s: infer gave %s" % (label, p))
            if not np.array_equal(probs[0], probs[1]):
                raise AssertionError(
                    "%s: infer from the detached checkpoint differs from "
                    "the live parameters by %.3g" % (
                        label, float(np.abs(probs[0] - probs[1]).max())))
            print("%s: to_tar + from_tar of %d parameters in %.3f s, every "
                  "array equal; paddle.infer on %d rows: the detached and "
                  "the live parameters give the same bits" % (
                      label, len(params.names()), tar_s, V2_INFER_ROWS))
        feeds = [feeder.build_feed(prog, sgd._data_names, b) for b in seen]
        t0 = time.perf_counter()
        for b in seen:
            feeder.build_feed(prog, sgd._data_names, b)
        feed_ms = (time.perf_counter() - t0) * 1e3 / len(seen)
        busy, ops = device_ops(lambda: sgd._exe.run(
            prog, feed=feeds[-1], fetch_list=[cost], return_numpy=False))
        nums.update(batch_ms=float(np.median(batch_ms)), busy_ms=busy,
                    ops=ops, feed_ms=feed_ms, params=n_params)
        print("%s: device busy %s ms and %d device ops a training step "
              "(torch.profiler, one eager step); feeder.build_feed %.3f "
              "host ms a batch; %.1f s (card: %s)" % (
                  label, "%.3f" % busy if busy is not None else "not "
                  "measured", ops, feed_ms, time.perf_counter() - started,
                  card_line()))
    torch.cuda.empty_cache()
    return got, nums


def staged_fields(got, want):
    """(name, staged tensor, host value) of each field of a staged feed
    dict ``got`` and its host feed dict ``want``, a PackedSeq's data and
    lengths apart."""
    for n, v in want.items():
        if hasattr(v, "lengths"):
            yield n, got[n].data, v.data
            yield n, got[n].lengths, v.lengths
        else:
            yield n, got[n], v


def check_staged(what, got, want, dev):
    """Every field of ``got`` a tensor on ``dev`` equal to the host's, in
    the host's dtype; compared on the consumer's stream."""
    for n, t, h in staged_fields(got, want):
        ref = torch.as_tensor(np.asarray(h)).to(dev)
        if t.device != dev or t.dtype != ref.dtype or \
                not torch.equal(t, ref):
            raise AssertionError("%s: %s differs from the host's" % (what,
                                                                    n))


def v2_feeds(paddle, prog, data_names, word_dict, batches, batch):
    """A reader of the imdb batches as feed dicts (``feeder.build_feed``,
    the ragged ids packed as the executor packs them: a PackedSeq)."""
    from paddle_tpu_torch.core.executor import _pack_ragged
    from paddle_tpu_torch.v2 import feeder

    def reader():
        for b in v2_reader(paddle, word_dict, batches, batch)():
            feed = feeder.build_feed(prog, data_names, b)
            yield {n: _pack_ragged(v, prog.global_block().var(n).dtype)
                   if isinstance(v, list) else v for n, v in feed.items()}
    return reader


def v2_readers(fluid, paddle, seed, dev, build, batch=V2_B, k=V2_K,
               chunks=V2_CHUNKS):
    """Phase 6j (c): the staging readers on the card. From one state of
    the v2 net ``build()`` gives (trained by Adam), ``Executor.run_chunk``
    over ``chunks`` chunks of ``k`` steps from
    ``device_chunks(super_batch(buffered(r, 2), k))`` against the same
    chunks of host numpy (``super_batch(r, k)``): the losses and every
    scope tensor the same bits; every staged field a CUDA tensor equal
    to the host's. ``double_buffer(r, place=CUDAPlace(0))``: every batch
    a CUDA tensor equal to the host batch, read on the consumer's
    stream. Returns the numbers."""
    word_dict = paddle.dataset.imdb.word_dict()
    reader = paddle.reader
    with v2_session(fluid, paddle, True, seed):
        cost, _ = build()
        params = paddle.parameters.create(cost)
        sgd = paddle.trainer.SGD(
            cost=cost, parameters=params,
            update_equation=paddle.optimizer.Adam(learning_rate=V2_LR))
        prog, scope = cost.block.program, fluid.global_scope()
        init = scope_state(scope)
        r = v2_feeds(paddle, prog, sgd._data_names, word_dict, k * chunks,
                     batch)
        runs = {}
        for where, chunked in (
                ("device_chunks", lambda: reader.device_chunks(
                    reader.super_batch(reader.buffered(r, 2), k))),
                ("host", lambda: reader.super_batch(r, k))):
            random.seed(seed)
            sc = fluid.Scope()
            for n, t in init.items():
                sc.set_var(n, t.clone())
            exe, losses, staged = fluid.Executor(), [], []
            t0 = time.perf_counter()
            for chunk in chunked()():
                staged.append(chunk)
                losses.append(exe.run_chunk(prog, feed_chunk=chunk,
                                            fetch_list=[cost], scope=sc)[0])
            torch.cuda.synchronize()
            runs[where] = (losses, sc, staged, time.perf_counter() - t0)
        (dl, dsc, dstaged, ds), (hl, hsc, hstaged, hs) = \
            runs["device_chunks"], runs["host"]
        if len(dl) != chunks or len(hl) != chunks:
            raise AssertionError("run_chunk over %d and %d chunks"
                                 % (len(dl), len(hl)))
        for d, h in zip(dstaged, hstaged):
            check_staged("device_chunks", d, h, dev)
        same_bits("run_chunk from device_chunks against host numpy",
                  [torch.from_numpy(np.stack(dl))] +
                  [dsc.find_var(n) for n in init],
                  [torch.from_numpy(np.stack(hl))] +
                  [hsc.find_var(n) for n in init])
        print("device_chunks: %d chunks of %d steps through run_chunk, "
              "losses %s, bitwise the host-fed chunks' (%d scope tensors "
              "equal); %.3f s against %.3f s host-fed" % (
                  chunks, k, " ".join("%.6f" % v for v in
                                      np.concatenate(dl)), len(init), ds,
                  hs))
        random.seed(seed)
        host = list(r())
        random.seed(seed)
        n = 0
        t0 = time.perf_counter()
        for got, want in zip(reader.double_buffer(
                r, place=fluid.CUDAPlace(0))(), host):
            check_staged("double_buffer", got, want, dev)
            n += 1
        if n != len(host):
            raise AssertionError("double_buffer gave %d of %d batches"
                                 % (n, len(host)))
        print("double_buffer: %d batches staged on a side stream, each "
              "equal to its host batch on the consumer's stream (%.3f s)"
              % (n, time.perf_counter() - t0))
    del runs, init
    torch.cuda.empty_cache()
    return dict(chunks_s=ds, host_chunks_s=hs)


def v2_cross_check(fluid, paddle, seed, build, batch):
    """The card against the CPU through v2's own entry points: one v2
    session on the card and one on the CPU (``init(use_gpu=False)``,
    the kernels' plain versions), the CPU's weights loaded from the
    card's ``to_tar`` by ``init_from_tar``; one ``train`` batch each.
    The costs within rtol 1e-4, every parameter and Adam accumulator
    after the step within OPTIM_STATE_TOL of its largest magnitude plus
    what 1e-6 weight draws move it on the CPU (check_state: Adam's first
    step moves every weight with a nonzero gradient by its rate, a
    gradient of rounding noise too)."""
    word_dict = paddle.dataset.imdb.word_dict()
    random.seed(seed)
    rows = next(iter(v2_reader(paddle, word_dict, 1, batch)()))
    out, tar = {}, None
    for use_gpu in (True, False):
        with v2_session(fluid, paddle, use_gpu, seed):
            cost, _ = build()
            params = paddle.parameters.create(cost)
            sgd = paddle.trainer.SGD(
                cost=cost, parameters=params,
                update_equation=paddle.optimizer.Adam(learning_rate=V2_LR))
            if tar is None:
                tar = io.BytesIO()
                params.to_tar(tar)
            else:
                tar.seek(0)
                params.init_from_tar(tar)
            prog, scope = cost.block.program, fluid.global_scope()
            init = {n: t.cpu() for n, t in scope_state(scope).items()}
            costs = []
            sgd.train(lambda: iter([rows]), event_handler=lambda e:
                      costs.append(e.cost)
                      if isinstance(e, paddle.event.EndIteration) else None)
            names = state_names(prog)
            out[use_gpu] = (costs[0], {n: scope.find_var(n).cpu()
                                       for n in names})
            if not use_gpu:
                moved = noise_moves(fluid, prog, cost, init,
                                    sgd._feed_from_batch(rows, None), 1,
                                    names)
    (kc, ks), (cc, cs) = out[True], out[False]
    label = "v2 stacked LSTM %s, batch %d" % (V2_XCHECK, batch)
    print("%s: first-step cost card %.7f cpu %.7f" % (label, kc, cc))
    np.testing.assert_allclose(kc, cc, rtol=1e-4)
    check_state("card vs cpu at %s after the first step" % label,
                state_diffs(names, ks.get, cs.get), moved, OPTIM_STATE_TOL,
                detail=True)


def v2_phase(fluid, seed, dev):
    """Phase 6j: the v2 frontend on the card at full width: (a) the
    stacked-LSTM sentiment net (v2_stacked_build: train, test,
    checkpoint, infer), (b) the GRU classifier (v2_gru_build: train,
    test), (c) the staging readers (v2_readers), and the first step
    card against CPU at V2_XCHECK's widths (v2_cross_check). Returns the
    B3-B6 launches of (a) and (b)."""
    import paddle_tpu_torch.v2 as paddle

    t0 = time.perf_counter()
    dict_dim = len(paddle.dataset.imdb.word_dict())
    launched, nums = collections.Counter(), {}
    got, nums["stacked"] = v2_train_path(
        fluid, paddle, seed, dev, "v2 stacked LSTM (emb %d, hid %d, %d "
        "layers, dict %d)" % (EMB, HID, STACKED, dict_dim),
        lambda: v2_stacked_build(paddle, dict_dim), "lstm",
        V2_TRAIN_BATCHES, V2_TEST_BATCHES)
    launched.update(got)
    got, nums["gru"] = v2_train_path(
        fluid, paddle, seed, dev, "v2 GRU classifier (emb %d, H %d, dict "
        "%d)" % (EMB, HID, dict_dim),
        lambda: v2_gru_build(paddle, dict_dim), "gru", V2_GRU_BATCHES,
        V2_GRU_TEST_BATCHES, checkpoint=False)
    launched.update(got)
    t1 = time.perf_counter()
    nums["readers"] = v2_readers(fluid, paddle, seed, dev,
                                 lambda: v2_stacked_build(paddle, dict_dim))
    t2 = time.perf_counter()
    v2_cross_check(fluid, paddle, seed, lambda: v2_stacked_build(
        paddle, dict_dim, **V2_XCHECK), XCHECK_B)
    print("v2 phase: %.1f s (paths %.1f, readers %.1f, card vs cpu %.1f); "
          "%s (card: %s)" % (
              time.perf_counter() - t0, t1 - t0, t2 - t1,
              time.perf_counter() - t2, json.dumps(nums), card_line()))
    return dict(launched)


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


def check_bn_loaders(kbn, g, dev, shapes=BN_LOADER_SHAPES):
    """B7's three loaders at each shape of ``shapes``, in both dtypes,
    forced (``bn_grad_cuda``'s ``loader``): each within the bounds of
    check_bn_grad of the plain version, the 16-byte loads bitwise TMA's
    (the element loader's threads take one column each: another order
    of the sums); then five calls of mixed shapes captured in one CUDA graph
    and replayed twice, an eager call between, every result bitwise the
    eager one (the grid barrier's counter only grows through it all)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    inputs = []
    for shape in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn(*shape, generator=g) * 1.5 + 0.7).to(dtype) \
                .to(dev)
            dy = torch.randn(*shape, generator=g).to(dtype).to(dev)
            scale = (torch.rand(shape[-1], generator=g) + 0.5).to(dev)
            inputs.append((x, dy, scale))
            want = kbn.bn_grad_cuda(x, dy, scale, 1e-5, loader="tma")
            plain = kbn.bn_grad_reference(x, dy, scale, 1e-5)
            f32 = dtype == torch.float32
            n, h, w, c = shape
            for loader in kbn.LOADERS:
                pl = kbn.plan(n * h * w, c, dtype, True, sms, loader)
                got = kbn.bn_grad_cuda(x, dy, scale, 1e-5, loader=loader)
                what = "bn_grad %s %s loader %s (%s W %d G %d R %d BR %d " \
                       "S %d)" % (shape, dtype, loader, pl.loader, pl.width,
                                  pl.groups, pl.slabs, pl.tile_rows,
                                  pl.slots)
                rel_close(what + " dx", got[0], plain[0],
                          BN_RTOL if f32 else BF16_RTOL,
                          BN_AMAX if f32 else BF16_AMAX)
                rel_close(what + " dscale", got[1], plain[1], BN_RTOL,
                          BN_AMAX)
                rel_close(what + " dbias", got[2], plain[2], BN_RTOL,
                          BN_AMAX)
                if loader == "vec" and not all(
                        torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(what + ": not TMA's bits")
    inputs = inputs[:5]
    want = [kbn.bn_grad(*inp, 1e-5) for inp in inputs]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for inp in inputs:
            kbn.bn_grad(*inp, 1e-5)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [kbn.bn_grad(*inp, 1e-5) for inp in inputs]
    for rep in range(2):
        graph.replay()
        mid = kbn.bn_grad(*inputs[rep], 1e-5)
        torch.cuda.synchronize()
        for o, w_ in zip(outs, want):
            if not all(torch.equal(a, b) for a, b in zip(o, w_)):
                raise AssertionError("bn_grad: a graph replay differs from "
                                     "the eager call")
        if not all(torch.equal(a, b) for a, b in zip(mid, want[rep])):
            raise AssertionError("bn_grad: an eager call between replays "
                                 "differs")
    print("bn_grad: loaders %s at %s in float32 and bfloat16 within the "
          "bounds, vec bitwise tma; 5 calls in a graph, 2 replays bitwise "
          "eager" % (sorted(kbn.LOADERS), list(shapes)))
    del graph


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

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    graphs, and the device ops a step eagerly, over one warm chunk.
    Returns the numbers."""
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
    prof = {n: device_ops(fn) for n, fn in (("eager", eager_chunk),
                                            ("graphs", graph_chunk))}
    busy = {n: v[0] for n, v in prof.items()}
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
                else busy["graphs"] / k, ops_eager=prof["eager"][1] / k,
                noisy=len(noisy))


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
        GRAPH_K["transformer"], GRAPH_CHUNKS_LONG, seed,
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
    # phase 6o trains this program from these weights
    res["lm"] = dict(prog=prog, loss=loss, init=init, feed=feed,
                     build=build, b1=fwd + grad)
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


def serving_breakdown(spans):
    """Per-request tracing spans of a serving run as {bucket: {phase:
    {p50, p99}}} in ms: queue wait, batch form, padding (the pad_rows /
    bucket share of the compute span) and compute, as bench.py's
    ``_serving_breakdown`` (bench.py:596-648) aggregates them."""
    per_trace = {}
    for s in spans:
        per_trace.setdefault(s["trace_id"], []).append(s)
    rows = {}
    for ss in per_trace.values():
        comp = next((s for s in ss
                     if s["name"] == "paddle_tpu.serving.compute"), None)
        if comp is None:
            continue
        bucket = comp["attrs"]["bucket"]
        queue = sum(s["dur_us"] for s in ss
                    if s["name"] == "paddle_tpu.serving.queue_wait")
        form = sum(s["dur_us"] for s in ss
                   if s["name"] == "paddle_tpu.serving.batch_form")
        pad = comp["dur_us"] * comp["attrs"]["pad_rows"] / float(bucket)
        rows.setdefault(bucket, []).append(
            (queue, form, pad, comp["dur_us"] - pad))
    out = {}
    for bucket in sorted(rows):
        arr = np.asarray(rows[bucket]) / 1000.0
        entry = {"requests": len(rows[bucket])}
        for i, name in enumerate(("queue", "batch_form", "padding",
                                  "compute")):
            entry[name + "_ms"] = {
                "p50": float(np.percentile(arr[:, i], 50)),
                "p99": float(np.percentile(arr[:, i], 99))}
        out[str(bucket)] = entry
    return out


def request_split(spans):
    """p50 over requests of each layer's own ms: the client span less the
    server's (framing, the socket and the client's wait to run), the
    server span less the batcher's (the handler and its wait for the
    batch's future to resolve), the batcher's queue wait, batch form and
    compute (copy-in, replay, copy-out)."""
    per_trace = {}
    for s in spans:
        per_trace.setdefault(s["trace_id"], {})[s["name"]] = s["dur_us"]
    rows = []
    for d in per_trace.values():
        if "paddle_tpu.serving.compute" not in d:
            continue
        batch = sum(d.get("paddle_tpu.serving." + n, 0.0) for n in (
            "queue_wait", "batch_form", "compute"))
        rows.append((d["paddle_tpu.serving.client_infer"]
                     - d["paddle_tpu.rpc.server"],
                     d["paddle_tpu.rpc.server"] - batch,
                     d["paddle_tpu.serving.queue_wait"],
                     d["paddle_tpu.serving.batch_form"],
                     d["paddle_tpu.serving.compute"],
                     d["paddle_tpu.serving.client_infer"]))
    arr = np.asarray(rows) / 1000.0
    return {name: float(np.median(arr[:, i])) for i, name in enumerate((
        "client_and_transport", "server_handler", "queue_wait",
        "batch_form", "compute", "total"))}


class Recording:
    """An engine as the batcher sees it, keeping each dispatched batch's
    feed and outputs (host copies) so that every answer can be held
    against an eager run of the same padded bucket afterwards."""

    def __init__(self, engine):
        self.engine = engine
        self.batches = []
        self.lock = threading.Lock()

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def infer(self, feed, **kw):
        outs = self.engine.infer(feed, **kw)
        with self.lock:
            self.batches.append(({n: _host_copy(v) for n, v in feed.items()},
                                 [o.copy() for o in outs]))
        return outs


class Gated:
    """An engine whose dispatches wait for ``gate`` (a blocked batch);
    ``entered`` is set when the first one arrives."""

    def __init__(self, engine):
        self.engine = engine
        self.gate = threading.Event()
        self.entered = threading.Event()

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def infer(self, feed, **kw):
        self.entered.set()
        if not self.gate.wait(120):
            raise RuntimeError("the gate never opened")
        return self.engine.infer(feed, **kw)


def _host_copy(v):
    from paddle_tpu_torch import PackedSeq
    if isinstance(v, PackedSeq):
        return PackedSeq(np.array(v.data), np.array(v.lengths))
    return np.array(v)


def wait_for(pred, timeout=30.0):
    end = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > end:
            raise AssertionError("condition never held")
        time.sleep(0.005)


def serving_close(what, got, want, rtol=SERVE_RTOL, amax=SERVE_AMAX):
    """``got`` within rtol plus amax of max|want| of ``want``; returns the
    largest error over that bound's scale, for printing."""
    tol = rtol * np.abs(want) + amax * float(np.abs(want).max())
    err = np.abs(got - want)
    if not (err <= tol).all():
        raise AssertionError("%s: max abs err %.3g exceeds rtol %g + %g "
                             "max|want|" % (what, float(err.max()), rtol,
                                            amax))
    return float(err.max())


def serving_oneshot(fluid, seed, dev, work):
    """S1: LeNet over RPC as bench.py's _bench_serving runs it on an
    accelerator (bench.py:650-751), from startup weights saved and
    loaded back; then overload and drain."""
    from paddle_tpu_torch import layers, telemetry, tracing, unique_name
    from paddle_tpu_torch.models.lenet import lenet
    from paddle_tpu_torch.serving import (Overloaded, DynamicBatcher,
                                          ServingClient, ServingEngine,
                                          ServingServer)

    scope = fluid.Scope()
    with unique_name.guard():
        prog, startup = fluid.Program(), fluid.Program()
        startup.random_seed = seed
        with fluid.program_guard(prog, startup):
            img = layers.data("img", [1, 28, 28])
            predict = lenet(img)
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    model_dir = os.path.join(work, "lenet")
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(model_dir, ["img"], [predict], exe,
                                      main_program=prog)
    loaded = fluid.Scope()
    with fluid.scope_guard(loaded):
        iprog, feeds, fetch_vars = fluid.io.load_inference_model(model_dir,
                                                                 exe)
    fetches = [v.name for v in fetch_vars]
    for n in scope.vars:
        if not torch.equal(loaded.find_var(n), scope.find_var(n)):
            raise AssertionError("%s changed through save/load" % n)

    # the eager engine every answer is held against, built before the
    # telemetry counts: the counters then see the served engine alone
    eager = ServingEngine(iprog, feeds, fetches, scope=loaded,
                          max_batch=SERVE_MAX_BATCH)
    eager._capture = False
    eager.warmup()
    telemetry.reset()
    telemetry.enable()
    engine = ServingEngine(iprog, feeds, fetches, scope=loaded,
                           max_batch=SERVE_MAX_BATCH)
    t0 = time.perf_counter()
    per_bucket = engine.warmup()
    warmup_s = time.perf_counter() - t0
    if engine.compile_count() != 7 or engine.buckets != (1, 2, 4, 8, 16,
                                                         32, 64):
        raise AssertionError("buckets %s, compile_count %d"
                             % (engine.buckets, engine.compile_count()))
    print("S1 LeNet: %d buckets %s captured in %.3f s (%s); counted flops "
          "a bucket %s" % (
              engine.compile_count(), list(engine.buckets), warmup_s,
              json.dumps({b: round(s, 4) for b, s in per_bucket.items()}),
              json.dumps({b: c["flops"] for b, c in
                          sorted(engine.bucket_costs().items())})))
    misses0 = telemetry.summary()[
        "paddle_tpu_executor_jit_cache_misses_total"]

    spans = []
    server = ServingServer(engine, max_delay_ms=3.0,
                           max_queue=SERVE_MAX_QUEUE)
    rec = Recording(engine)
    server.batcher.engine = rec
    server.start()
    rng = np.random.RandomState(seed)
    images = rng.rand(SERVE_CLIENTS, SERVE_PER_CLIENT, 1, 1, 28,
                      28).astype(np.float32)
    answers = np.full((SERVE_CLIENTS, SERVE_PER_CLIENT, 10), np.nan,
                      np.float32)
    latencies = []
    lock = threading.Lock()
    errors = []

    def client(i):
        try:
            with ServingClient(server.address) as c:
                c.ready()
                for k in range(SERVE_PER_CLIENT):
                    t = time.perf_counter()
                    answers[i, k] = c.infer({"img": images[i, k]})[0][0]
                    with lock:
                        latencies.append(time.perf_counter() - t)
        except Exception as e:      # surfaced below, never swallowed
            errors.append(repr(e))

    tracing.add_sink(spans.append)
    tracing.enable()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(SERVE_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    tracing.disable()
    tracing.remove_sink(spans.append)
    server.drain()
    if errors:
        raise AssertionError("S1 clients failed: %s" % errors[:3])
    n_req = SERVE_CLIENTS * SERVE_PER_CLIENT
    if len(latencies) != n_req or not np.isfinite(answers).all():
        raise AssertionError("S1: %d of %d requests answered"
                             % (len(latencies), n_req))
    s = telemetry.summary()
    if s["paddle_tpu_executor_jit_cache_misses_total"] != misses0 or \
            engine.compile_count() != 7:
        raise AssertionError("S1 traffic rebuilt a bucket: misses %s -> "
                             "%s, compile_count %d" % (
                                 misses0, s[
                                     "paddle_tpu_executor_jit_cache_"
                                     "misses_total"],
                                 engine.compile_count()))
    # every answer bitwise equal to the eager run of its padded bucket
    where = {}
    eager_outs = []
    for b, (feed, outs) in enumerate(rec.batches):
        want = eager.infer(feed)[0]
        if not np.array_equal(want, outs[0]):
            raise AssertionError("S1 batch %d (%d rows): the replay is not "
                                 "the eager bucket's bits" % (
                                     b, len(outs[0])))
        eager_outs.append(want)
        for r, x in enumerate(feed["img"]):
            where[x.tobytes()] = (b, r)
    sizes = collections.Counter(len(o[0]) for _, o in rec.batches)
    worst = 0.0
    for i in range(SERVE_CLIENTS):
        for k in range(SERVE_PER_CLIENT):
            b, r = where[images[i, k, 0].tobytes()]
            if not np.array_equal(answers[i, k], eager_outs[b][r]):
                raise AssertionError("S1 answer %d/%d differs from its "
                                     "batch's eager row" % (i, k))
            alone = exe.run(iprog, feed={"img": images[i, k]},
                            fetch_list=fetches, scope=loaded)[0][0]
            worst = max(worst, serving_close("S1 answer %d/%d" % (i, k),
                                             answers[i, k], alone))
    lat = np.sort(np.asarray(latencies)) * 1000.0
    p50, p90, p99 = (float(np.percentile(lat, p)) for p in (50, 90, 99))
    breakdown = serving_breakdown(spans)
    if not breakdown:
        raise AssertionError("S1 recorded no request traces")
    print("S1 LeNet over RPC: %d clients x %d requests of batch 1 = %d in "
          "%.3f s = %.1f req/s; latency p50 %.3f p90 %.3f p99 %.3f ms; %d "
          "batches by rows %s; every answer bitwise equal to its padded "
          "bucket run eagerly, and within rtol %g + %g max|want| of "
          "Executor.run on its row alone (max abs err %.3g); "
          "compile_count 7 and jit misses %d before and after" % (
              SERVE_CLIENTS, SERVE_PER_CLIENT, n_req, wall, n_req / wall,
              p50, p90, p99, len(rec.batches),
              json.dumps(dict(sorted(sizes.items()))), SERVE_RTOL,
              SERVE_AMAX, worst, misses0))
    print("S1 per-bucket breakdown (ms, from the tracing spans): %s"
          % json.dumps(breakdown))
    print("S1 where a request's time goes (ms, p50 over requests, from "
          "the tracing spans): %s" % json.dumps(request_split(spans)))
    print("S1 telemetry: %s" % json.dumps(
        {k: v for k, v in sorted(s.items()) if "serving" in k}))

    # overload: a batch held at the engine, a queue of 1
    gated = Gated(engine)
    small = ServingServer(batcher=DynamicBatcher(
        gated, max_delay_ms=1.0, max_queue=1, name="overload"))
    small.start(warmup=False)
    got = {"ok": 0, "overloaded": 0}

    def probe(k):
        with ServingClient(small.address) as c:
            try:
                c.infer({"img": images[0, k]})
                key = "ok"
            except Overloaded:
                key = "overloaded"
            with lock:
                got[key] += 1

    held = [threading.Thread(target=probe, args=(0,))]
    held[0].start()
    if not gated.entered.wait(60):
        raise AssertionError("S1 overload: the first batch never arrived")
    held.append(threading.Thread(target=probe, args=(1,)))
    held[1].start()
    wait_for(lambda: small.batcher.depth() == 1)
    probe(2)
    if got["overloaded"] != 1:
        raise AssertionError("S1 overload: %s" % got)
    # drain while the two admitted requests wait: both are answered
    drainer = threading.Thread(target=small.drain)
    drainer.start()
    time.sleep(0.05)
    gated.gate.set()
    drainer.join(120)
    for t in held:
        t.join(120)
    if got != {"ok": 2, "overloaded": 1} or drainer.is_alive():
        raise AssertionError("S1 drain: %s" % got)
    print("S1 overload: a held batch and max_queue=1 shed the third request "
          "with a typed Overloaded; drain answered both admitted ones")
    telemetry.disable()
    return dict(req_s=n_req / wall, p50=p50, p90=p90, p99=p99,
                warmup_s=warmup_s), model_dir, engine, eager


def serving_ragged(fluid, seed, dev, work):
    """S2: the stacked-LSTM classifier at bench.py's widths
    (bench.py:159-183), its inference program saved and loaded back,
    ragged PackedSeq requests through a DynamicBatcher from 8 threads:
    B3 inside the bucket graphs."""
    from paddle_tpu_torch import PackedSeq, layers, unique_name
    from paddle_tpu_torch.kernels import lstm_cell as lc
    from paddle_tpu_torch.models.stacked_lstm import stacked_lstm_net
    from paddle_tpu_torch.serving import DynamicBatcher, ServingEngine

    scope = fluid.Scope()
    with unique_name.guard():
        prog, startup = fluid.Program(), fluid.Program()
        startup.random_seed = seed
        with fluid.program_guard(prog, startup):
            words = layers.data("words", [1], dtype="int64", lod_level=1)
            prediction = stacked_lstm_net(words, DICT, class_dim=CLASSES,
                                          emb_dim=EMB, hid_dim=HID,
                                          stacked_num=STACKED)
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    infer = fluid.io.get_inference_program([prediction], prog)
    model_dir = os.path.join(work, "stacked_lstm")
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(model_dir, ["words"], [prediction],
                                      exe, main_program=infer)
    loaded = fluid.Scope()
    with fluid.scope_guard(loaded):
        iprog, feeds, fetch_vars = fluid.io.load_inference_model(model_dir,
                                                                 exe)
    fetches = [v.name for v in fetch_vars]
    n_lstm = sum(op.type == "lstm" for op in iprog.global_block().ops)
    if n_lstm != STACKED:
        raise AssertionError("%d lstm ops in the inference program"
                             % n_lstm)
    engine = ServingEngine(iprog, feeds, fetches, scope=loaded,
                           seq_lens={"words": LSTM_T},
                           max_batch=SERVE_MAX_BATCH)
    t0 = time.perf_counter()
    engine.warmup()
    warmup_s = time.perf_counter() - t0
    eager = ServingEngine(iprog, feeds, fetches, scope=loaded,
                          seq_lens={"words": LSTM_T},
                          max_batch=SERVE_MAX_BATCH)
    eager._capture = False
    eager.warmup()
    rng = np.random.RandomState(seed + 1)
    reqs = []
    for _ in range(RAGGED_THREADS * RAGGED_PER_THREAD):
        rows = int(rng.randint(1, 9))
        lens = rng.randint(MIN_LEN, LSTM_T + 1, rows).astype(np.int32)
        ids = np.zeros((rows, int(lens.max()), 1), np.int64)
        for r, n in enumerate(lens):
            ids[r, :n, 0] = rng.randint(0, DICT, n)
        reqs.append(PackedSeq(ids, lens))
    rec = Recording(engine)
    answers = [None] * len(reqs)
    errors = []
    torch.cuda.synchronize()
    lc.reset_launches()
    batcher = DynamicBatcher(rec, max_delay_ms=3.0, max_queue=len(reqs),
                             name="ragged")

    def worker(k):
        try:
            for i in range(k, len(reqs), RAGGED_THREADS):
                answers[i] = batcher.submit({"words": reqs[i]}).result(
                    300)[0]
        except Exception as e:      # surfaced below, never swallowed
            errors.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(k,))
               for k in range(RAGGED_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    if not batcher.close(timeout=120):
        raise AssertionError("S2 batcher did not drain")
    launches = dict(lc.launches)
    if errors or any(a is None for a in answers):
        raise AssertionError("S2: %s" % (errors[:3] or "requests lost"))
    n_batches = len(rec.batches)
    want = {"lstm_fwd": n_lstm * n_batches, "lstm_bwd": 0,
            "lstm_fwd_bf16": 0, "lstm_bwd_bf16": 0}
    print("S2 launches over %d replays: %s, expected %s (%d lstm ops)" % (
        n_batches, json.dumps(launches), json.dumps(want), n_lstm))
    if launches != want:
        raise AssertionError("S2 B3 launches %s != %s" % (launches, want))
    where = {}
    for b, (feed, outs) in enumerate(rec.batches):
        if not np.array_equal(eager.infer(feed)[0], outs[0]):
            raise AssertionError("S2 batch %d: the replay is not the eager "
                                 "bucket's bits" % b)
        seq = feed["words"]
        for r in range(len(seq.lengths)):
            where[(seq.data[r, :seq.lengths[r]].tobytes())] = (b, r)
    worst = 0.0
    rows = 0
    for i, (req, got) in enumerate(zip(reqs, answers)):
        for r in range(len(req.lengths)):
            b, rr = where[req.data[r, :req.lengths[r]].tobytes()]
            if not np.array_equal(got[r], rec.batches[b][1][0][rr]):
                raise AssertionError("S2 request %d row %d is not its "
                                     "batch's row" % (i, r))
        alone = exe.run(iprog, feed={"words": req}, fetch_list=fetches,
                        scope=loaded)[0]
        if got.shape != (len(req.lengths), CLASSES):
            raise AssertionError("S2 answer shape %s" % (got.shape,))
        worst = max(worst, serving_close("S2 request %d" % i, got, alone))
        rows += len(req.lengths)
    print("S2 stacked LSTM (dict %d, emb/hid %d, %d layers): %d requests of "
          "1-8 ragged rows (%d rows, lengths %d..%d) from %d threads in "
          "%.3f s = %.1f req/s, %d batches; warmup %.3f s for %d buckets; "
          "every answer bitwise equal to its padded bucket run eagerly and "
          "within rtol %g + %g max|want| of Executor.run on the request's "
          "rows alone (max abs err %.3g)" % (
              DICT, HID, STACKED, len(reqs), rows, MIN_LEN, LSTM_T,
              RAGGED_THREADS, wall, len(reqs) / wall, n_batches, warmup_s,
              engine.compile_count(), SERVE_RTOL, SERVE_AMAX, worst))
    return launches


def serving_generate(engine, workload, outs):
    """S3: ``generate`` over RPC through the full-width decode engine of
    phase 4, the same 24 requests from 8 threads; tokens equal to phase
    4's in-process DecodeLoop."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.serving import (DeadlineExceeded, DecodeLoop,
                                          ServingClient, ServingServer)

    compiled = engine.compile_count()
    loop = DecodeLoop(engine, max_queue=N_REQUESTS)
    seen = []
    submit = loop.submit

    def recording_submit(*a, **kw):
        g = submit(*a, **kw)
        seen.append(g)
        return g

    loop.submit = recording_submit
    server = ServingServer(decoder=loop).start()
    got = [None] * N_REQUESTS
    errors = []

    def worker(k):
        try:
            with ServingClient(server.address) as c:
                for i in range(k, N_REQUESTS, GEN_THREADS):
                    p, m = workload[i]
                    got[i] = c.generate(p, max_new_tokens=m)
        except Exception as e:      # surfaced below, never swallowed
            errors.append(repr(e))

    torch.cuda.synchronize()
    fa.reset_launches()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(k,))
               for k in range(GEN_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    launches = dict(fa.launches)
    steps = loop.steps_dispatched()
    if errors or any(g is None for g in got):
        raise AssertionError("S3: %s" % (errors[:3] or "requests lost"))
    want = {"flash_attention": N_LAYERS * N_REQUESTS,
            "flash_attention_bf16": 0, "flash_decode": N_LAYERS * steps,
            "flash_decode_bf16": 0}
    print("S3 launches: %s, expected %s (%d decode steps)" % (
        json.dumps(launches), json.dumps(want), steps))
    if launches != want:
        raise AssertionError("S3 launches %s != %s" % (launches, want))
    for i, ((toks, reason), (ref, ref_reason)) in enumerate(zip(got, outs)):
        if list(toks) != list(ref) or reason != ref_reason:
            raise AssertionError("S3 request %d: %s/%s over RPC, %s/%s in "
                                 "process" % (i, toks[:8], reason, ref[:8],
                                              ref_reason))
    if engine.compile_count() != compiled:
        raise AssertionError("S3 compile_count %d -> %d"
                             % (compiled, engine.compile_count()))
    toks = sum(len(t) for t, _ in got)
    gaps = np.asarray([b - a for g in seen
                       for a, b in zip(g.token_times, g.token_times[1:])])
    p50, p99 = (float(np.percentile(gaps * 1000.0, p)) for p in (50, 99))
    # a 1 ms deadline: the generation stops at it, or never gets a slot
    with ServingClient(server.address) as c:
        try:
            _, reason = c.generate(workload[0][0], max_new_tokens=LONG_NEW,
                                   deadline_ms=1)
            verdict = "finish_reason %r" % reason
            if reason != "deadline":
                raise AssertionError("S3 1 ms deadline: %s" % verdict)
        except DeadlineExceeded:
            verdict = "a typed DeadlineExceeded"
    server.drain()
    print("S3 generate over RPC: %d requests from %d threads, %d tokens in "
          "%.3f s = %.2f tokens/s; per-token gap p50 %.3f ms p99 %.3f ms; "
          "tokens identical to the in-process DecodeLoop; compile_count %d "
          "frozen; a 1 ms deadline gave %s" % (
              N_REQUESTS, GEN_THREADS, toks, wall, toks / wall, p50, p99,
              compiled, verdict))
    return dict(tokens_s=toks / wall, gap_p50=p50, gap_p99=p99)


def serving_cli(model_dir, engine):
    """S4: ``python -m paddle_tpu_torch serve`` over S1's model as a
    subprocess: it answers one row bitwise as S1's float32 engine does
    (the serve process turns TF32 off, as this script does), and SIGTERM
    drains it to exit 0. It runs with ``--membership`` (phase 6o (d)):
    after warmup the replica is in the membership service's
    ``discover("replica")`` under its endpoint, and SIGTERM deregisters
    it (the epoch moves once each way)."""
    from paddle_tpu_torch.distributed.membership import (MembershipClient,
                                                         MembershipServer)
    from paddle_tpu_torch.serving import ServingClient

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    members = MembershipServer(default_ttl=10.0).start()
    mc = MembershipClient(members.address)
    e0 = mc.epoch()
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch", "serve", "--model-dir",
         model_dir, "--port", "0", "--max-batch", "8", "--die-with-parent",
         "--membership", "%s:%d" % members.address, "--name", "s4",
         "--ttl", "10", "--heartbeat-interval", "1"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=here)
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(l) for l in proc.stdout],
                     daemon=True).start()
    try:
        t0 = time.perf_counter()
        line = ""
        while "serving listening on" not in line:
            try:
                line = lines.get(timeout=1.0)
            except queue.Empty:
                if proc.poll() is not None or \
                        time.perf_counter() - t0 > 300:
                    raise AssertionError("serve did not start (rc %s)"
                                         % proc.poll())
        ready_s = time.perf_counter() - t0
        host, port = line.split("listening on ")[1].split(" ")[0].split(":")
        found = mc.discover("replica")
        if found != [["s4", "%s:%s" % (host, port)]] or \
                mc.epoch() != e0 + 1:
            raise AssertionError("serve --membership: discover %s, epoch "
                                 "%d (from %d)" % (found, mc.epoch(), e0))
        x = np.random.RandomState(7).rand(1, 1, 28, 28).astype(np.float32)
        with ServingClient((host, int(port))) as c:
            if not c.ready()["ready"]:
                raise AssertionError("serve is not ready")
            out = c.infer({"img": x})[0]
        want = engine.infer({"img": x})[0]
        if not np.array_equal(out, want):
            raise AssertionError("serve's answer %s != S1's %s"
                                 % (out, want))
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        if rc != 0:
            raise AssertionError("serve exited %d after SIGTERM" % rc)
        if mc.discover("replica") != [] or mc.epoch() != e0 + 2:
            raise AssertionError("serve --membership: still registered "
                                 "after SIGTERM (%s)"
                                 % mc.discover("replica"))
        print("S4 python -m paddle_tpu_torch serve --membership: listening "
              "after %.2f s (%s), registered as s4 under its endpoint, its "
              "answer bitwise equal to S1's float32 engine on the same row, "
              "SIGTERM deregistered it and drained it to exit 0"
              % (ready_s, line.strip()))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        mc.close()
        members.shutdown()


# ---- phase 6k: the executor and program tooling ----
# (b)'s card-against-CPU comparison: the stacked LSTM's first rows
CALC_CPU_ROWS = 16
# (a) the NaN/Inf guard on the transformer as bench.py trains it: eager
# steps, then one run_chunk of TOOL_K graph replays; the chunk step whose
# targets hold an id past the vocabulary (read as NaN by the jnp rule)
TOOL_EAGER, TOOL_K, TOOL_BAD_STEP = 3, 4, 2


def to_lodtensor(fluid, rows):
    """benchmark/fluid/machine_translation.py's ``to_lodtensor``: the
    rows flattened into one [sum(len), 1] int64 array and their offsets
    as the LoD."""
    lod = [0]
    for r in rows:
        lod.append(lod[-1] + len(r))
    flat = np.concatenate(rows, axis=0).astype("int64")
    t = fluid.LoDTensor()
    t.set(flat.reshape([len(flat), 1]), fluid.CUDAPlace(0))
    t.set_lod([lod])
    return t


def fresh_scope(fluid, init):
    s = fluid.Scope()
    for n, t in init.items():
        s.set_var(n, t.clone())
    return s


def bitwise_or_noisy(label, runs, got):
    """``got`` (losses, state) against the first of two reference runs
    from the same weights: every loss and state tensor on which the two
    references agree must be bitwise ``got``'s. Returns the names where
    the references already differ (the library's reductions that are not
    run-to-run deterministic), printed, with their largest difference
    from ``got`` as a share of the tensor's largest magnitude."""
    (l1, s1), (l2, s2) = runs
    lg, sg = got
    noisy = sorted(n for n in s1 if not torch.equal(s1[n], s2[n]))
    differ = sorted(n for n in s1 if n not in noisy
                    and not torch.equal(s1[n], sg[n]))
    if set(sg) != set(s1) or differ:
        raise AssertionError("%s: differs in %s, on which two reference "
                             "runs agree" % (label, differ[:10]))
    if np.array_equal(l1, l2) and not np.array_equal(l1, lg):
        raise AssertionError("%s: losses %s != %s" % (label, lg, l1))
    worst = max((float((sg[n].double() - s1[n].double()).abs().max()
                       / max(s1[n].double().abs().max(), 1e-30))
                 for n in noisy), default=0.0)
    print("%s: losses %s (%s); %d of %d state tensors bitwise equal%s" % (
        label, " ".join("%.6f" % v for v in lg),
        "bitwise equal" if np.array_equal(l1, lg) else
        "two reference runs differ too", len(s1) - len(noisy), len(s1),
        "; %d where two reference runs already differ (%s), at most "
        "%.3g of their largest magnitude from the reference" % (
            len(noisy), ", ".join(noisy[:6]), worst) if noisy else ""))
    return noisy


def first_float_reader(prog, name):
    """The first op in program order downstream of ``name`` whose
    output is a float: where a NaN read from ``name`` first shows."""
    block = prog.global_block()
    seen = {name}
    for op in block.ops:
        if not any(n in seen for n in op.input_arg_names):
            continue
        outs = [n for n in op.output_arg_names if n]
        if any(str(block._find_var_recursive(n).dtype).startswith(
                ("float", "bfloat")) for n in outs):
            return op
        seen.update(outs)
    raise AssertionError("nothing downstream of %r makes a float" % name)


def attention_weight(prog):
    """The weight of the product that makes the first fused_attention's
    Q (the first layer's query projection), and the first op in program
    order that reads it."""
    block = prog.global_block()
    producer = {n: op for op in block.ops for n in op.output_arg_names}
    att = next(op for op in block.ops if op.type == "fused_attention")
    op = producer[att.inputs["Q"][0]]
    while op.type != "mul":
        op = producer[op.input_arg_names[0]]
    w = op.inputs["Y"][0]
    return w, next(o for o in block.ops if w in o.input_arg_names)


def expect_nan(fluid, label, want_op, call, step=None):
    """``call()`` must raise the NaN/Inf guard's error naming ``want_op``
    (and ``step``, for a chunk)."""
    from paddle_tpu_torch.core import debug

    try:
        call()
    except debug.NanInfError as e:
        got = (e.op_type, e.op_uid, e.step)
        if got != (want_op.type, want_op.uid, step):
            raise AssertionError("%s: the guard named %s, the program "
                                 "says %s" % (label, got, (
                                     want_op.type, want_op.uid, step)))
        print("%s: raised %r" % (label, str(e)))
        return
    raise AssertionError("%s: the NaN/Inf guard did not raise" % label)


def nan_guard_path(fluid, dev, cfg, batch, seed, eager=TOOL_EAGER,
                   k=TOOL_K, bad_step=TOOL_BAD_STEP):
    """(a) of phase 6k: the transformer LM under bf16 AMP (``cfg``, a
    ``build_transformer_lm`` configuration) with the NaN/Inf guard.
    ``eager`` steps and one ``run_chunk`` of ``k`` steps from the same
    weights, twice with the flag off and once on: the guarded run's
    losses and state bitwise the unguarded one's, its B1 launches the
    same. Then, guarded: one NaN in the first layer's query weight makes
    the next step raise naming the first op that reads it; the scope is
    whole after the raise; the startup re-run and a clean step pass; the
    same inside the chunk's graph (chunk step 0), and an out-of-range
    target at chunk step ``bad_step`` names the first float op
    downstream of the targets and that step. Returns the numbers: busy
    ms and device ops a step with the flag on and off, eager and with
    graphs, and the step's cost_analysis."""
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.models.transformer import build_transformer_lm

    with unique_name.guard():
        prog, startup, _, (loss,) = build_transformer_lm(**cfg)
    fluid.amp.enable(prog)
    fwd, grad, _ = attention_launches(prog)
    startup.random_seed = seed
    s0 = fluid.Scope()
    fluid.Executor().run(startup, scope=s0)
    init = scope_state(s0)
    del s0
    feeds = [{n: torch.from_numpy(a).to(dev) for n, a in lm_feed(
        cfg["vocab_size"], cfg["seq_len"], batch, seed + i).items()}
        for i in range(eager + k)]
    chunk = {n: torch.stack([f[n] for f in feeds[eager:]]) for n in feeds[0]}

    def train(flag):
        fluid.set_check_nan_inf(flag)
        try:
            scope, exe = fresh_scope(fluid, init), fluid.Executor()
            exe._step = 1
            reset_all_launches()
            losses = [exe.run(prog, feed=f, fetch_list=[loss],
                              scope=scope)[0] for f in feeds[:eager]]
            losses.extend(exe.run_chunk(prog, feed_chunk=chunk, k=k,
                                        fetch_list=[loss], scope=scope)[0])
            torch.cuda.synchronize()
            return (np.stack([np.asarray(v).ravel()[0] for v in losses]),
                    scope_state(scope), all_launches(), exe, scope)
        finally:
            fluid.set_check_nan_inf(False)

    off, off2, on = train(False), train(False), train(True)
    want = {n: 0 for n in off[2]}
    want["flash_attention_bf16"] = (fwd + grad) * (eager + k)
    print("guard: launches off %s, on %s; from the program %s" % (
        json.dumps({n: v for n, v in off[2].items() if v}),
        json.dumps({n: v for n, v in on[2].items() if v}),
        json.dumps({n: v for n, v in want.items() if v})))
    if on[2] != want or off[2] != want:
        raise AssertionError("guard: B1 launches %s / %s != %s"
                             % (off[2], on[2], want))
    noisy = bitwise_or_noisy(
        "guard: %d eager steps + a chunk of %d replays, the flag on "
        "against off" % (eager, k),
        [(off[0], off[1]), (off2[0], off2[1])], (on[0], on[1]))
    del off2

    out = {"noisy": len(noisy)}
    exe_off, scope_off, exe_on, scope_on = off[3], off[4], on[3], on[4]
    for label, exe, scope, flag in (("off", exe_off, scope_off, False),
                                    ("on", exe_on, scope_on, True)):
        fluid.set_check_nan_inf(flag)
        try:
            out["eager_" + label] = device_ops(lambda: exe.run(
                prog, feed=feeds[0], fetch_list=[loss], scope=scope))
            graph = device_ops(lambda: exe.run_chunk(
                prog, feed_chunk=chunk, k=k, fetch_list=[loss],
                scope=scope))
            out["graphs_" + label] = (None if graph[0] is None
                                      else graph[0] / k, graph[1] / k)
        finally:
            fluid.set_check_nan_inf(False)
    for mode in ("eager", "graphs"):
        print("guard %s: device busy ms/step off %s, on %s; device ops/step "
              "off %.1f, on %.1f" % (
                  mode, *("%.3f" % out["%s_%s" % (mode, f)][0]
                          if out["%s_%s" % (mode, f)][0] is not None
                          else "not measured" for f in ("off", "on")),
                  out[mode + "_off"][1], out[mode + "_on"][1]))
    out["cost"] = exe_off.cost_analysis(prog, feed=feeds[0],
                                        fetch_list=[loss], scope=scope_off)
    del off, exe_off, scope_off

    fluid.set_check_nan_inf(True)
    try:
        w, first = attention_weight(prog)
        scope_on.find_var(w)[0, 0] = float("nan")
        expect_nan(fluid, "guard: one NaN in %s, an eager step" % w, first,
                   lambda: exe_on.run(prog, feed=feeds[0],
                                      fetch_list=[loss], scope=scope_on))
        alive = torch.stack([t.float().sum() for t in scope_on.vars.values()
                             if isinstance(t, torch.Tensor)])
        torch.cuda.synchronize()
        print("guard: after the raise all %d scope tensors are alive"
              % alive.numel())
        exe_on.run(startup, scope=scope_on)
        clean = exe_on.run(prog, feed=feeds[0], fetch_list=[loss],
                           scope=scope_on)[0]
        if not np.isfinite(clean).all():
            raise AssertionError("guard: the clean step after the startup "
                                 "re-run is not finite: %s" % clean)
        scope_on.find_var(w)[0, 0] = float("nan")
        base = exe_on._step
        expect_nan(fluid, "guard: one NaN in %s, a chunk of %d replays"
                   % (w, k), first,
                   lambda: exe_on.run_chunk(prog, feed_chunk=chunk, k=k,
                                            fetch_list=[loss],
                                            scope=scope_on), step=base)
        exe_on.run(startup, scope=scope_on)
        bad = {n: v.clone() for n, v in chunk.items()}
        bad["targets"][bad_step, 0, 0] = cfg["vocab_size"] + 7
        base = exe_on._step
        expect_nan(fluid, "guard: target id %d at chunk step %d"
                   % (cfg["vocab_size"] + 7, bad_step),
                   first_float_reader(prog, "targets"),
                   lambda: exe_on.run_chunk(prog, feed_chunk=bad, k=k,
                                            fetch_list=[loss],
                                            scope=scope_on),
                   step=base + bad_step)
    finally:
        fluid.set_check_nan_inf(False)
    del exe_on, scope_on
    torch.cuda.empty_cache()
    return out


def max_pool_winners(seq, lens):
    """For each (row, feature) of a [B, T, F] sequence, the set of time
    steps that hold its largest valid value, as a boolean [B, T, F]."""
    x = np.asarray(seq, np.float64)
    valid = np.arange(x.shape[1])[None, :, None] < lens[:, None, None]
    x = np.where(valid, x, -np.inf)
    return x == x.max(axis=1, keepdims=True)


def calc_gradient_path(fluid, dev, dims, batch, T, min_len, seed,
                       max_flipped=4, cpu_rows=CALC_CPU_ROWS):
    """(b) of phase 6k: ``calc_gradient`` of the stacked LSTM's loss with
    respect to its embedding's output (an activation, not a parameter),
    on the card: the B3 and B4 launches of the call are the program's
    (one B3 a ``lstm`` op and one more inside each ``lstm_grad``, one B4
    a ``lstm_grad``), and the gradient equals the port's CPU run from the
    same weights within 1e-4 of its largest magnitude on every row whose
    max pools pick the same time steps on both. The net ends in two max
    pools over ~2560 features of up to 80 steps a row: a gap between a
    feature's two largest values that the card's and the CPU's roundings
    order differently (or tie) sends that feature's gradient to another
    step, which the recurrences carry over the whole row. Such rows (at
    most ``max_flipped``) are named, with their error, and left out. The
    comparison runs on the batch's first ``cpu_rows`` rows (the card
    again, and the CPU: the CPU's full-width call took most of the
    phase's host time). Returns the numbers and the program, feed and
    scope."""
    from paddle_tpu_torch import layers, unique_name
    from paddle_tpu_torch.kernels import lstm_cell as lc
    from paddle_tpu_torch.models.stacked_lstm import stacked_lstm_net

    with unique_name.guard():
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            words = layers.data("words", [1], dtype="int64", lod_level=1)
            label = layers.data("label", [1], dtype="int64")
            pred = stacked_lstm_net(words, dims["dict_dim"], CLASSES,
                                    dims["emb_dim"], dims["hid_dim"],
                                    dims["stacked_num"])
            loss = layers.mean(layers.cross_entropy(pred, label))
            emb = next(op for op in prog.global_block().ops
                       if op.type == "lookup_table").outputs["Out"][0]
            (g,) = fluid.calc_gradient(loss, [emb])
    pooled = [op.inputs["X"][0] for op in prog.global_block().ops
              if op.type == "sequence_pool"]
    fetch = [loss, g] + pooled
    fwd, bwd = recurrent_launches(prog, "lstm")
    startup.random_seed = seed
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(seed)
    lens, words_, label_ = stacked_lstm_batch(rng, batch, T, min_len,
                                              dims["dict_dim"])
    feed = {"words": words_, "label": label_}
    exe.run(prog, feed=feed, fetch_list=[loss, g], scope=scope)
    torch.cuda.synchronize()
    lc.reset_launches()
    t0 = time.perf_counter()
    card = exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1000.0
    want = {"lstm_fwd": fwd, "lstm_bwd": bwd, "lstm_fwd_bf16": 0,
            "lstm_bwd_bf16": 0}
    if dict(lc.launches) != want:
        raise AssertionError("calc_gradient: LSTM launches %s != %s"
                             % (dict(lc.launches), want))
    cpu_scope = fluid.Scope()
    for n, t in scope.vars.items():
        cpu_scope.set_var(n, t.cpu())
    full_loss = float(card[0])
    lens = lens[:cpu_rows]
    part = {"words": words_[:cpu_rows], "label": label_[:cpu_rows]}
    card = exe.run(prog, feed=part, fetch_list=fetch, scope=scope)
    t0 = time.perf_counter()
    cpu = fluid.Executor(fluid.CPUPlace()).run(
        prog, feed=part, fetch_list=fetch, scope=cpu_scope)
    cpu_s = time.perf_counter() - t0
    flipped = sorted({int(r) for a, b in zip(card[2:], cpu[2:])
                      for r in np.nonzero((max_pool_winners(a.data, lens)
                                           != max_pool_winners(b.data, lens))
                                          .any(axis=(1, 2)))[0]})
    gc_, gp = card[1].data, cpu[1].data
    top = float(np.abs(gp).max())
    d = np.abs(gc_ - gp).reshape(gc_.shape[0], -1).max(axis=1) / top
    kept = [r for r in range(gc_.shape[0]) if r not in flipped]
    err = float(d[kept].max())
    print("calc_gradient: d loss / d %s at batch %d (%.7f; %d + %d B3 + "
          "%d B4, from the program), the card against the CPU on its first "
          "%d rows [%s], lengths %d..%d: loss card %.7f, CPU %.7f; the "
          "gradient's largest difference %.3g x max|g| (bound 1e-4) over "
          "the %d rows whose max pools pick the same steps; %s; card call "
          "%.3f ms, CPU %.1f s" % (
              emb, batch, full_loss, fwd - bwd, bwd, bwd, cpu_rows,
              "x".join(map(str, gc_.shape)), lens.min(), lens.max(),
              float(card[0]), float(cpu[0]), err,
              len(kept), "rows whose max pools pick other steps on the "
              "card and the CPU (a near-tie): %s" % ", ".join(
                  "%d (length %d, %.3g x max|g|)" % (r, lens[r], d[r])
                  for r in flipped) if flipped else "no max pool picks "
              "other steps", ms, cpu_s))
    if not np.isfinite(gc_).all() or err > 1e-4 or \
            len(flipped) > max_flipped:
        raise AssertionError("calc_gradient: the card's gradient differs "
                             "from the CPU's by %.3g x max|g| (%d rows "
                             "left out)" % (err, len(flipped)))
    if abs(float(card[0]) - float(cpu[0])) > 1e-4 * abs(float(cpu[0])):
        raise AssertionError("calc_gradient: losses %s, %s"
                             % (card[0], cpu[0]))
    del cpu_scope
    return dict(ms=ms, rel_err=err, flipped=flipped, launches=want), (
        prog, feed, [loss, g], scope)


def lod_feed_path(fluid, dev, cfg, batch, T, min_len, seed, steps=2):
    """(c) of phase 6k: seq2seq (``cfg``, a ``build_seq2seq``
    configuration) fed through ``LoDTensor`` as the reference's
    machine_translation.py builds its feeds (``set`` of the flattened
    ids, ``set_lod`` of the offsets): ``steps`` Adam steps bitwise the
    same steps fed as lists of rows (twice, to name any tensor two
    list-fed runs already disagree on), 4 B5 + 2 B6 a step from the
    program. Returns the numbers and the program, feed and scope."""
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.kernels import gru_cell as gc
    from paddle_tpu_torch.models.seq2seq import build_seq2seq

    with unique_name.guard():
        prog, startup, _, (loss,) = build_seq2seq(lr=LR, **cfg)
    fwd, bwd = recurrent_launches(prog, "gru")
    startup.random_seed = seed
    s0 = fluid.Scope()
    fluid.Executor().run(startup, scope=s0)
    init = scope_state(s0)
    del s0
    rng = np.random.RandomState(seed)
    rows = seq2seq_batch(rng, batch, T, min_len, cfg["tgt_vocab"])
    lod = {n: to_lodtensor(fluid, r) for n, r in rows.items()}

    def train(feed):
        scope, exe = fresh_scope(fluid, init), fluid.Executor()
        exe._step = 1
        gc.reset_launches()
        losses = [float(exe.run(prog, feed=feed, fetch_list=[loss],
                                scope=scope)[0]) for _ in range(steps)]
        torch.cuda.synchronize()
        return np.asarray(losses), scope_state(scope), dict(gc.launches)

    by_rows, by_rows2, by_lod = train(rows), train(rows), train(lod)
    want = {"gru_fwd": fwd * steps, "gru_bwd": bwd * steps,
            "gru_fwd_bf16": 0, "gru_bwd_bf16": 0}
    if by_lod[2] != want or by_rows[2] != want:
        raise AssertionError("LoDTensor feeds: GRU launches %s / %s != %s"
                             % (by_lod[2], by_rows[2], want))
    noisy = bitwise_or_noisy(
        "LoDTensor feeds: %d steps of %d pairs, lengths %d..%d, fed "
        "through LoDTensor against lists of rows; %d B5 + %d B6 a step "
        "(from the program)" % (steps, batch, min_len, T, fwd, bwd),
        [by_rows[:2], by_rows2[:2]], by_lod[:2])
    del by_rows, by_rows2, by_lod
    torch.cuda.empty_cache()
    return dict(noisy=len(noisy), launches=want), (prog, rows, [loss], init)


def resnet_logits(train):
    """The input of the softmax whose output the loss reads."""
    ops = train.global_block().ops
    probs = next(op for op in ops if op.type == "cross_entropy").inputs[
        "X"][0]
    return next(op for op in ops if op.type == "softmax"
                and op.outputs["Out"][0] == probs).inputs["X"][0]


def calibrate_bn(fluid, exe, train, logits, feed, scope):
    """Set every batch norm's running statistics to its statistics over
    the batch ``feed``: the training-mode forward pruned to ``logits``,
    run once with each batch norm's momentum at 0. The is_test program
    then normalises that batch as training does (random statistics
    silence a deep net: its logits come out 0)."""
    from paddle_tpu_torch import io

    calib = io.get_inference_program([logits], main_program=train)
    n = 0
    for op in calib.global_block().ops:
        if op.type == "batch_norm":
            op.attrs["momentum"] = 0.0
            n += 1
    exe.run(calib, feed=feed, fetch_list=[logits], scope=scope)
    return n


def fold_path(fluid, dev, cfg, batch, seed):
    """(d) of phase 6k: ``InferenceTranspiler`` on ResNet-50's is_test
    clone (``cfg``, a ``build_resnet50_train`` configuration), float32,
    pruned to its logits, with each batch norm's running statistics set
    to those of the batch (``calibrate_bn``): every ``batch_norm`` folds
    into its conv on the card, and the folded program's logits equal
    the unfolded one's within rtol 1e-4 plus 1e-5 of the largest
    magnitude. Returns the batch norms folded, the gap and each
    program's busy ms."""
    from paddle_tpu_torch import io, unique_name
    from paddle_tpu_torch.models.resnet import build_resnet50_train

    with unique_name.guard():
        train, startup, _, _ = build_resnet50_train(**cfg)
    logits = resnet_logits(train)
    infer = io.get_inference_program(
        [logits], main_program=train.clone(for_test=True))
    startup.random_seed = seed
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand((batch,) + tuple(cfg["image_shape"]), generator=gen,
                   device=dev)
    calibrate_bn(fluid, exe, train, logits, {"data": x}, scope)
    n_bn = sum(op.type == "batch_norm" for op in infer.global_block().ops)

    def run():
        return exe.run(infer, feed={"data": x}, fetch_list=[logits],
                       scope=scope, return_numpy=False)[0]

    ref = run().clone()
    busy_ref = device_busy_ms(run)
    version = infer.fingerprint
    with unique_name.guard():
        fluid.InferenceTranspiler().transpile(infer, scope=scope)
    left = sum(op.type == "batch_norm" for op in infer.global_block().ops)
    if infer.fingerprint == version or left or n_bn != 53:
        raise AssertionError("fold: %d batch norms, %d left; the "
                             "fingerprint %s moved" % (
                                 n_bn, left, infer.fingerprint != version))
    got = run()
    busy = device_busy_ms(run)
    d = (got.double() - ref.double()).abs()
    top = float(ref.double().abs().max())
    bound = 1e-4 * ref.double().abs() + 1e-5 * top
    gap = float(d.max())
    share = float((d / bound).max())
    print("fold: %d batch_norm ops folded into their convs on the card "
          "(ResNet-50 is_test, batch %d, %s); logits' largest gap %.3g "
          "(max|logit| %.3g), %.3g of the bound rtol 1e-4 + 1e-5 max at "
          "its worst entry; device busy ms unfolded %s, folded %s" % (
              n_bn, batch, "x".join(map(str, cfg["image_shape"])), gap,
              top, share, *("%.3f" % b if b is not None else "not measured"
                            for b in (busy_ref, busy))))
    if not bool((d <= bound).all()):
        raise AssertionError("fold: the folded logits differ by %.3g" % gap)
    del scope, exe
    torch.cuda.empty_cache()
    return dict(folded=n_bn, gap=gap, share=share, busy_unfolded=busy_ref,
                busy_folded=busy)


def cost_line(label, cost, busy_ms, kinds):
    """Print one step's cost_analysis beside its busy ms, and the flops
    of the op types ``kinds`` (the hand-written kernels' ops) apart."""
    f, b = cost["flops"], cost["bytes accessed"]
    print("cost %s: %.4g flops, %.4g bytes accessed; device busy %s ms "
          "-> %s TFLOP/s" % (
              label, f, b, "%.3f" % busy_ms if busy_ms else "not measured",
              "%.2f" % (f / busy_ms / 1e9) if busy_ms else "not measured"))
    by = cost["flops by op"]
    print("cost %s: %s" % (label, ", ".join(
        "%s %.4g (%.1f%%)" % (n, by[n], 100.0 * by[n] / f)
        for n in kinds if n in by)))


def tooling_phase(fluid, seed, dev):
    """Phase 6k: the executor and program tooling at full width
    (``nan_guard_path``, ``calc_gradient_path``, ``lod_feed_path``,
    ``fold_path``, then each step's ``cost_analysis``: the transformer
    of (a) and ResNet-50 config C, with B1's and B3-B6's ops apart)."""
    from paddle_tpu_torch import unique_name

    t0 = time.perf_counter()
    guard = nan_guard_path(fluid, dev, LM, LM_B, seed)
    calc, (lprog, lfeed, lfetch, lscope) = calc_gradient_path(
        fluid, dev, dict(dict_dim=DICT, emb_dim=EMB, hid_dim=HID,
                         stacked_num=STACKED), LSTM_B, LSTM_T, MIN_LEN, seed)
    lcost = fluid.Executor().cost_analysis(lprog, feed=lfeed,
                                           fetch_list=lfetch, scope=lscope)
    lbusy = device_busy_ms(lambda: fluid.Executor().run(
        lprog, feed=lfeed, fetch_list=lfetch, scope=lscope))
    del lscope
    lod, (sprog, srows, sfetch, sinit) = lod_feed_path(
        fluid, dev, S2S, S2S_B, S2S_T, S2S_MIN, seed)
    sscope = fresh_scope(fluid, sinit)
    scost = fluid.Executor().cost_analysis(sprog, feed=srows,
                                           fetch_list=sfetch, scope=sscope)
    del sscope, sinit
    fold = fold_path(fluid, dev, RESNET, RESNET_B, seed)

    # config C's step, for its cost beside its busy time
    with unique_name.guard():
        cprog, cstart, _, (closs, _acc) = fused_build("C", RESNET)
    cstart.random_seed = seed
    cscope, cexe = fluid.Scope(), fluid.Executor()
    cexe.run(cstart, scope=cscope)
    rng = np.random.RandomState(seed)
    cfeed = {"data": torch.from_numpy(rng.randn(
        RESNET_B, *RESNET["image_shape"][1:], RESNET["image_shape"][0])
        .astype(np.float32)).to(dev), "label": torch.from_numpy(
        rng.randint(0, RESNET["class_dim"], (RESNET_B, 1))).to(dev)}
    for _ in range(2):
        cexe.run(cprog, feed=cfeed, fetch_list=[closs], scope=cscope)
    cbusy = device_busy_ms(lambda: cexe.run(cprog, feed=cfeed,
                                            fetch_list=[closs],
                                            scope=cscope))
    ccost = cexe.cost_analysis(cprog, feed=cfeed, fetch_list=[closs],
                               scope=cscope)
    del cscope, cexe
    torch.cuda.empty_cache()
    cost_line("transformer step (bf16 AMP, batch %d)" % LM_B, guard["cost"],
              guard["eager_off"][0], ("fused_attention",
                                      "fused_attention_grad", "mul",
                                      "mul_grad"))
    cost_line("ResNet-50 config C step (bf16 AMP, batch %d)" % RESNET_B,
              ccost, cbusy, ("conv2d", "conv2d_grad", "conv2d_bn_act",
                             "conv2d_bn_act_grad"))
    cost_line("stacked-LSTM calc_gradient call (float32, batch %d)"
              % LSTM_B, lcost, lbusy, ("lstm", "lstm_grad", "mul",
                                       "mul_grad"))
    cost_line("seq2seq step (float32, batch %d, rows fed)" % S2S_B, scost,
              None, ("gru", "gru_grad", "mul", "mul_grad"))
    print("phase 6k: %.1f s" % (time.perf_counter() - t0))
    return dict(guard=guard, calc=calc, lod=lod, fold=fold)


# ---- phase 6l: data parallelism (paddle_tpu_torch.parallel) ----
# The card holds one rank: the parallel path runs at NCCL world 1 (NCCL
# refuses two ranks of one communicator on one card), where every bucket,
# reduce-scatter, all-gather and quantized exchange is real and each sum
# over the ranks has one addend; the sums across ranks are held on the
# CPU by tests/test_torch_parallel.py's gloo worlds of 2, 3 and 4.
# (a) ResNet-50 config D (bf16 AMP, NCHW, epilogue fusion, fused 1x1
# backward; Momentum; batch RESNET_B): PE_STEPS steps in each mode from
# one start state; (b) the stacked LSTM at train_phase's widths under
# CommConfig(bucket_mb=PE_BUCKET_MB): PE_LSTM_K eager steps against one
# run_chunk of PE_LSTM_K graph replays, the collectives captured.
PE_STEPS, PE_LSTM_K, PE_BUCKET_MB = 2, 4, 4.0
# the modes of (a): (comm_config keywords or None, executor zero_stage)
PE_MODES = (("none_z0", None, 0), ("none_z1", None, 1),
            ("comm_fp32", dict(bucket_mb=PE_BUCKET_MB), 0),
            ("comm_int8", dict(bucket_mb=PE_BUCKET_MB, quantize="int8"), 0),
            ("comm_z1", dict(bucket_mb=PE_BUCKET_MB, zero_stage=1), 0))


def free_port():
    """A free TCP port on the loopback interface (the rendezvous)."""
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def comm_profile(fn, reps=3):
    """``reps`` calls of ``fn``, each under torch.profiler: (the median
    device busy ms of a call's kernels and copies, (NCCL calls on the
    host, their ranges on the device, the ranges' device us) of the
    first call). PyTorch marks each NCCL call on the device timeline as
    a range ``nccl:<kind>`` (at one rank NCCL moves the data by a device
    copy inside it): those ranges are counted apart, not added to the
    busy time. Only the first call records the host too (the NCCL calls
    are counted there); the others record the device alone, which costs
    the host far less."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.parallel import comm_audit

    busy, nccl = [], None
    for i in range(reps):
        acts = [ProfilerActivity.CUDA] if i else \
            [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if str(e.device_type).endswith("CUDA")
              and not e.name.startswith("nccl:")]
        if us:
            busy.append(sum(us) / 1000.0)
        if nccl is None:
            nccl = comm_audit.device_collectives(prof)
    return (float(np.median(busy)) if busy else None), nccl


def same_state(a, b):
    """Names whose values differ bit for bit between two scope states
    (a ZeRO shard compared as its flat elements)."""
    def bits(t):
        return t.reshape(-1).view(torch.uint8)

    bad = [n for n in a if n in b and not torch.equal(bits(a[n]),
                                                      bits(b[n]))]
    return sorted(bad) + sorted(set(a) ^ set(b))


def pe_state(scope):
    """A scope's tensors, ZeRO shards as their local rows (flat)."""
    return {n: t.detach().as_subclass(torch.Tensor).clone()
            for n, t in scope.vars.items() if isinstance(t, torch.Tensor)}


def parallel_phase(fluid, seed, dev):
    """Phase 6l: data parallelism through ``ParallelExecutor`` over NCCL
    at world 1 on the card (``distribute.init_multihost``). (a) ResNet-50
    config D: the plain Executor, then every PE_MODES mode, PE_STEPS steps
    each from the same start state. The global view at zero_stage 0 is
    the plain Executor bitwise (at one rank every cross-rank sum is its
    one addend and the local-view mean and batch-norm forms are exactly
    the serial ones); zero_stage 1, the bucketed comm path and ZeRO-1
    are bitwise the global view; int8 after its first step is within its
    quantization bound (each element of a bucket moves by at most lr x
    the bucket's max gradient / 127: half a step in each of the two
    phases); the second step of every mode is finite. cuDNN runs its
    deterministic algorithms for the phase (its default backward is not
    run-to-run deterministic). Launches: exactly the program's bf16 B8 a
    step (transformed_launches); the NCCL calls a step equal the step's
    census. (b) the stacked LSTM: PE_LSTM_K eager PE steps against one
    run_chunk of PE_LSTM_K graph replays with the collectives captured,
    bitwise, 6 B3 + 3 B4 a step credited per replay, the census of the
    captured step holding one exchange a bucket. Prints, for each mode,
    busy ms a step, the NCCL calls' us, buckets and wire bytes from the
    plan, and each bucket's overlap (launched before the last backward
    op). Returns the counted steps' launches."""
    import torch.distributed as dist

    from paddle_tpu_torch import flags, unique_name
    from paddle_tpu_torch.kernels import conv1x1_bwd as k1
    from paddle_tpu_torch.kernels import lstm_cell as lc
    from paddle_tpu_torch.models.stacked_lstm import build_stacked_lstm_train
    from paddle_tpu_torch.parallel import CommConfig, ParallelExecutor
    from paddle_tpu_torch.parallel import comm_audit
    from paddle_tpu_torch.parallel.distribute import init_multihost

    t0 = time.perf_counter()
    init_multihost("localhost:%d" % free_port(), 1, 0, device=dev)
    print("process group: backend %s, world %d, rank %d (card: %s)" % (
        dist.get_backend(), dist.get_world_size(), dist.get_rank(),
        card_line()))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    launches = {"conv1x1_bwd_bf16": 0, "lstm_fwd": 0, "lstm_bwd": 0}
    try:
        # ---- (a) ResNet-50 config D ----
        with unique_name.guard():
            prog, startup, _, (loss, acc) = fused_build("D", RESNET)
        _, b8, _ = transformed_launches(prog, RESNET_B, [loss.name])
        want_b8 = sum(b8.values())
        startup.random_seed = seed
        scope0 = fluid.Scope()
        fluid.Executor().run(startup, scope=scope0)
        init = scope_state(scope0)
        del scope0
        rng = np.random.RandomState(seed)
        feed = {"data": torch.from_numpy(rng.randn(
            RESNET_B, *RESNET["image_shape"]).astype(np.float32)).to(dev),
            "label": torch.from_numpy(rng.randint(
                0, RESNET["class_dim"], (RESNET_B, 1)).astype(np.int64))
            .to(dev)}

        def fresh():
            s = fluid.Scope()
            for n, t in init.items():
                s.set_var(n, t.clone())
            return s

        flags.set_flags({"FLAGS_fused_conv1x1_bwd": True})
        runs = {}
        try:
            for name, cfg, zero in (("plain", None, 0),) + PE_MODES:
                scope = fresh()
                exe = fluid.Executor() if name == "plain" else \
                    ParallelExecutor(loss_name=loss.name, main_program=prog,
                                     zero_stage=zero,
                                     comm_config=None if cfg is None
                                     else CommConfig(**cfg))
                exe._step = 1          # the step after startup's

                def step():
                    return float(exe.run(program=prog, feed=feed,
                                         fetch_list=[loss], scope=scope)[0])

                losses, states = [], []
                # the local view's batch norm keeps per-rank running
                # statistics: one warning a statistic, counted instead
                # of printed
                with warnings.catch_warnings(record=True) as noted:
                    warnings.simplefilter("always", RuntimeWarning)
                    for s in range(PE_STEPS):
                        if s == PE_STEPS - 1:
                            reset_all_launches()
                        losses.append(step())
                        torch.cuda.synchronize()
                        states.append(pe_state(scope))
                    b8_step = k1.launches["conv1x1_bwd"]
                    # one further step, profiled: busy, the NCCL calls
                    # (one a mode: phase 6n's time took the other two)
                    busy, nccl = comm_profile(step, reps=1)
                if b8_step != want_b8:
                    raise AssertionError(
                        "%s: %d bf16 B8 launches in a step, the program "
                        "has %d" % (name, b8_step, want_b8))
                if name != "plain":
                    launches["conv1x1_bwd_bf16"] += b8_step
                    print("%s: %d warnings of state updated from this "
                          "rank's rows (the local view's batch-norm "
                          "statistics)" % (name, len(noted)))
                runs[name] = dict(
                    losses=losses, states=states, busy=busy, nccl=nccl,
                    census=getattr(exe, "last_census", None),
                    plan=getattr(exe, "_comm_plans", {}).get(
                        prog.fingerprint))
                if not np.isfinite(losses).all():
                    raise AssertionError("%s: losses %s" % (name, losses))
                del scope, exe
                torch.cuda.empty_cache()
        finally:
            flags.set_flags({"FLAGS_fused_conv1x1_bwd": False})

        for name, ref in (("none_z0", "plain"), ("none_z1", "none_z0"),
                          ("comm_fp32", "none_z0"),
                          ("comm_z1", "comm_fp32")):
            a, b = runs[name], runs[ref]
            bad = same_state(a["states"][-1], b["states"][-1])
            if a["losses"] != b["losses"] or bad:
                raise AssertionError(
                    "%s is not bitwise %s: losses %s %s, state differs at "
                    "%s" % (name, ref, a["losses"], b["losses"], bad[:5]))
            print("ResNet-50 config D: %s bitwise %s (losses %s, %d state "
                  "tensors)" % (name, ref, a["losses"], len(b["states"][-1])))
        # int8 after its first step against the float32 exchange
        q, f = runs["comm_int8"], runs["comm_fp32"]
        if q["losses"][0] != f["losses"][0]:
            raise AssertionError("int8's first loss (before any update) "
                                 "must be the float32 path's")
        lr = RESNET["lr"]
        worst = 0.0
        for b in f["plan"].buckets:
            grads = {p: (init[p].float() - f["states"][0][p].float())
                     .reshape(-1) / lr for p, _ in b.grads}
            step = max(float(g.abs().max()) for g in grads.values()) / 127.0
            for p, _ in b.grads:
                d = float((q["states"][0][p].float()
                           - f["states"][0][p].float()).abs().max())
                ulp = 4 * float(init[p].float().abs().max()) * 2.0 ** -23
                worst = max(worst, d / (lr * step + ulp))
        if worst > 1.01:
            raise AssertionError("int8: a parameter moved %.3f of its "
                                 "bucket's quantization bound" % worst)
        print("ResNet-50 config D: int8 after one step within %.3f of its "
              "bound (lr x bucket max|g| / 127 an element); second-step "
              "loss %.7f against the float32 path's %.7f" % (
                  worst, q["losses"][1], f["losses"][1]))

        for name, _, _ in PE_MODES:
            r = runs[name]
            plan, census = r["plan"], r["census"]
            overlap = comm_audit.bucket_overlap(census)
            stats = comm_audit.collective_stats(census)
            calls, ranges, nus = r["nccl"]
            if calls != len(census):
                raise AssertionError(
                    "%s: the profiler saw %d NCCL calls in a step (%d "
                    "device ranges), the census has %d"
                    % (name, calls, ranges, len(census)))
            print("PE %s (ResNet-50 config D, bf16 AMP, batch %d, NCCL "
                  "world 1): busy %s ms a step (median of 3), %d NCCL "
                  "calls a step = the census (%s), %d device ranges seen, "
                  "their device time %.1f us; plan: %d buckets, %d grad "
                  "bytes, %d wire bytes modeled; bucket exchanges launched "
                  "before the last backward op: %d of %d %s; %d bf16 B8 a "
                  "step (card: %s)" % (
                      name, RESNET_B, "%.3f" % r["busy"] if r["busy"]
                      else "not measured", calls, json.dumps(
                          {k: v["count"] for k, v in stats.items()}),
                      ranges, nus, len(plan.buckets), plan.grad_bytes,
                      plan.wire_bytes(), sum(overlap.values()),
                      len(overlap), json.dumps(
                          {str(k): v for k, v in sorted(overlap.items())})
                      if len(overlap) <= 16 else "",
                      want_b8, card_line()))
        print("plain Executor (ResNet-50 config D): busy %s ms a step "
              "(median of 3)" % (
            "%.3f" % runs["plain"]["busy"] if runs["plain"]["busy"]
            else "not measured"))
        del runs, init
        torch.cuda.empty_cache()

        # ---- (b) the stacked LSTM, its collectives in a CUDA graph ----
        with unique_name.guard():
            prog, startup, _, (loss, acc) = build_stacked_lstm_train(
                dict_dim=DICT, class_dim=CLASSES, emb_dim=EMB, hid_dim=HID,
                stacked_num=STACKED, lr=LR)
        fwd, bwd = recurrent_launches(prog, "lstm")
        startup.random_seed = seed
        scope0 = fluid.Scope()
        fluid.Executor().run(startup, scope=scope0)
        init = scope_state(scope0)
        del scope0
        lens, words, label = stacked_lstm_batch(
            np.random.RandomState(seed), LSTM_B, LSTM_T, MIN_LEN, DICT)
        on_card = packed_on(fluid, {"words": words, "label": label}, dev)

        def lstm_pe():
            s = fluid.Scope()
            for n, t in init.items():
                s.set_var(n, t.clone())
            pe = ParallelExecutor(
                loss_name=loss.name, main_program=prog, zero_stage=0,
                comm_config=CommConfig(bucket_mb=PE_BUCKET_MB))
            pe._step = 1
            return s, pe

        scope, pe = lstm_pe()
        reset_all_launches()
        t1 = time.perf_counter()
        eager = [float(pe.run(fetch_list=[loss], feed=on_card,
                              scope=scope)[0]) for _ in range(PE_LSTM_K)]
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t1) * 1000.0 / PE_LSTM_K
        eager_launch = (lc.launches["lstm_fwd"], lc.launches["lstm_bwd"])
        eager_state = pe_state(scope)
        plan = pe._comm_plans[prog.fingerprint]
        eager_census = pe.last_census
        busy_e, (ncalls_e, _, nus_e) = comm_profile(lambda: pe.run(
            fetch_list=[loss], feed=on_card, scope=scope))
        del scope, pe
        scope, pe = lstm_pe()
        chunk = chunk_of(on_card, PE_LSTM_K)
        reset_all_launches()
        out = pe.run_chunk(prog, feed_chunk=chunk, fetch_list=[loss],
                           scope=scope)
        torch.cuda.synchronize()
        graph = [float(v) for v in np.asarray(out[0]).ravel()]
        graph_launch = (lc.launches["lstm_fwd"], lc.launches["lstm_bwd"])
        census = pe.last_census
        bad = same_state(pe_state(scope), eager_state)
        if graph != eager or bad:
            raise AssertionError(
                "stacked LSTM under PE: graph replays differ from eager "
                "steps: %s %s, state %s" % (graph, eager, bad[:5]))
        want = (fwd * PE_LSTM_K, bwd * PE_LSTM_K)
        if eager_launch != want or graph_launch != want:
            raise AssertionError(
                "stacked LSTM under PE: B3/B4 launches eager %s, graphs "
                "%s, the program's %s" % (eager_launch, graph_launch, want))
        launches["lstm_fwd"] += graph_launch[0]
        launches["lstm_bwd"] += graph_launch[1]
        if census.count("bucket") != 2 * len(plan.buckets) or \
                len(census) != len(eager_census):
            raise AssertionError(
                "the captured step's collectives: %d bucket exchanges for "
                "%d buckets, %d in all against the eager step's %d" % (
                    census.count("bucket"), len(plan.buckets), len(census),
                    len(eager_census)))
        t1 = time.perf_counter()
        pe.run_chunk(prog, feed_chunk=chunk, fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
        graph_ms = (time.perf_counter() - t1) * 1000.0 / PE_LSTM_K
        busy_g = device_busy_ms(lambda: pe.run_chunk(
            prog, feed_chunk=chunk, fetch_list=[loss], scope=scope))
        overlap = comm_audit.bucket_overlap(census)
        print("PE stacked LSTM (dict %d, emb/hid %d, %d layers, batch %d "
              "of %d..%d ids, Adam, CommConfig(bucket_mb=%g), NCCL world "
              "1): %d eager steps bitwise %d graph replays (losses %s); "
              "%d B3 + %d B4 a step; %d collectives a replay = the census "
              "(%d buckets x 2 + the loss mean's), %d grad bytes, %d wire "
              "bytes modeled, buckets launched before the last backward "
              "op %s; host %.3f ms a step eager, %.3f graphs; busy %s ms "
              "a step eager (NCCL calls %d, %.1f us), %s graphs (card: %s)"
              % (DICT, EMB, STACKED, LSTM_B, lens.min(), lens.max(),
                 PE_BUCKET_MB, PE_LSTM_K, PE_LSTM_K, graph, fwd, bwd,
                 len(census), len(plan.buckets), plan.grad_bytes,
                 plan.wire_bytes(), json.dumps(
                     {str(k): v for k, v in sorted(overlap.items())}),
                 eager_ms, graph_ms, "%.3f" % busy_e if busy_e else
                 "not measured", ncalls_e, nus_e, "%.3f" % (
                     busy_g / PE_LSTM_K) if busy_g else "not measured",
                 card_line()))
        del scope, pe, init
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
        dist.destroy_process_group()
    print("phase 6l: %.1f s" % (time.perf_counter() - t0))
    return launches


# ---- phase 6m: tensor and sequence parallelism ----
# The card holds one rank, so both axes run at NCCL world 1, where every
# Megatron all-reduce, parameter gather and gradient exchange is real and
# each sum over the ranks has one addend (the cross-rank sums and the
# ring's exchanges are held on the CPU at gloo worlds of 2 and 4 by
# tests/test_torch_{tensor,context}_parallel.py). (a) the transformer as
# bench.py trains it (LM, bf16 AMP, batch LM_B) built with mp=True under
# make_mesh((1, 1), ("dp", "mp")) and CommConfig(): TP_K eager steps
# against the plain Executor's from the same state, then one run_chunk of
# TP_K graph replays with the mp collectives captured; (b) the same
# transformer built with seq_axis="sp" under make_mesh((1, 1), ("dp",
# "sp")) in the global view (ZeRO-1, the default): TP_K eager steps
# against the plain Executor's; (c) the ring's blocks at RING_N chunks of
# RING_SHAPE in one process (a ring of one runs no off-diagonal block),
# causal, with segment ids whose boundary (RING_SEG_AT) is off a chunk
# edge; (d) the placement search for the full-width program.
TP_K = 3
RING_N, RING_SHAPE, RING_SEG_AT = 4, (16, 8, 512, 64), 200
# the ring against B1 over the whole sequence and the float64 witness in
# bfloat16: each block's output is rounded to bfloat16 by B1 and the
# merged output once more, two roundings where the whole-sequence call
# has one, so twice B1's bfloat16 bound (BF16_RTOL, BF16_AMAX); float32:
# RING_RTOL + RING_AMAX x max|want| (B1's 3xTF32 products, the merge's
# and the backward's float32 sums over 512 keys)
RING_RTOL, RING_AMAX = 1e-4, 1e-5


def ring_check(cp, fa, dev, seed):
    """Phase 6m (c): the port's ring blocks (``context_parallel.
    ring_in_process``/``ring_in_process_bwd``: the same block, merge and
    block backward functions each rank runs) at RING_N chunks of
    RING_SHAPE, causal, with segment ids off a chunk edge, in bfloat16
    and float32: out, lse, dq, dk and dv against B1 over the whole
    sequence (and ``flash_attention_bwd`` on its output), against the
    plain ring (flash_attention_reference blocks) and against float64;
    exactly RING_N (RING_N + 1) / 2 B1 launches a ring. Returns the
    largest error against the plain ring."""
    b, h, s, d = RING_SHAPE
    g = torch.Generator(device="cpu").manual_seed(seed)
    ids = (torch.arange(s)[None, :] >= RING_SEG_AT).to(torch.int32) \
        .expand(b, s).contiguous().to(dev)
    seg = (ids, ids)
    base = [torch.randn(b, h, s, d, generator=g).to(dev) for _ in range(4)]
    worst = 0.0
    for dt in (torch.bfloat16, torch.float32):
        q, k, v, do = (t.to(dt) for t in base)
        key = "flash_attention_bf16" if dt == torch.bfloat16 \
            else "flash_attention"
        rtol, amax = (2 * BF16_RTOL, 2 * BF16_AMAX) \
            if dt == torch.bfloat16 else (RING_RTOL, RING_AMAX)
        n0 = fa.launches[key]
        out, lse = cp.ring_in_process(q, k, v, RING_N, True, segment_ids=seg)
        torch.cuda.synchronize()
        blocks = fa.launches[key] - n0
        if blocks != RING_N * (RING_N + 1) // 2:
            raise AssertionError("ring of %d: %d B1 launches, causal wants "
                                 "%d" % (RING_N, blocks,
                                         RING_N * (RING_N + 1) // 2))
        grads = cp.ring_in_process_bwd(q, k, v, out, lse, do, RING_N, True,
                                       segment_ids=seg)
        po, pl_ = cp.ring_in_process(q, k, v, RING_N, True, segment_ids=seg,
                                     plain=True)
        pgrads = cp.ring_in_process_bwd(q, k, v, po, pl_, do, RING_N, True,
                                        segment_ids=seg)
        wo, wl = fa.flash_attention(q, k, v, causal=True, segment_ids=seg,
                                    return_lse=True)
        wgrads = fa.flash_attention_bwd(q, k, v, wo, wl, do, True, None, seg)
        # float64: softmax attention and its autograd on the same values
        q64, k64, v64 = (t.double().requires_grad_() for t in (q, k, v))
        sc = torch.einsum("bhqd,bhkd->bhqk", q64, k64) * d ** -0.5
        ok = torch.tril(torch.ones(s, s, dtype=torch.bool, device=dev))
        ok = ok[None, None] & (ids[:, None, :, None] == ids[:, None, None, :])
        sc = torch.where(ok, sc, fa.DEFAULT_MASK_VALUE)
        l64 = torch.logsumexp(sc, -1)
        o64 = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(sc, -1), v64)
        g64 = torch.autograd.grad(o64, (q64, k64, v64), do.double())
        errs = {}
        for name, got, plain, whole, truth in zip(
                ("out", "lse", "dq", "dk", "dv"), (out, lse) + grads,
                (po, pl_) + pgrads, (wo, wl) + wgrads,
                (o64.detach(), l64.detach()) + g64):
            what = "ring of %d %s %s" % (RING_N, str(dt)[6:], name)
            if name == "lse":
                # float32 in both dtypes: the merge's log-sum-exp
                e = (assert_close(what + " vs the plain ring", got, plain),
                     assert_close(what + " vs whole B1", got, whole),
                     assert_close(what + " vs float64", got.double(), truth))
            else:
                e = tuple(rel_close(what + w, got, want, rtol, amax)
                          for w, want in ((" vs the plain ring", plain),
                                          (" vs whole B1", whole),
                                          (" vs float64", truth)))
            errs[name] = e
            worst = max(worst, e[0])
        print("ring of %d at %s %s, causal, segments split at %d (chunk "
              "%d): %d B1 launches; max abs err vs the plain ring / B1 "
              "over the whole sequence / float64: %s (bounds: %s)" % (
                  RING_N, list(RING_SHAPE), str(dt)[6:], RING_SEG_AT,
                  s // RING_N, blocks, json.dumps(
                      {k_: ["%.3g" % x for x in e_]
                       for k_, e_ in errs.items()}),
                  "rtol %g + %g max|want|, lse atol/rtol %g" % (
                      rtol, amax, ATOL)))
        del q64, k64, v64, sc, ok, l64, o64, g64
        torch.cuda.empty_cache()
    return worst


def tp_phase(fluid, seed, dev):
    """Phase 6m: tensor ('mp') and sequence ('sp') parallelism through
    ``ParallelExecutor`` at NCCL world 1 (see the comment above). (a)
    and (b): the parallel steps are the plain step's bits (at one rank
    each mp sum and each all-gather has one addend, the ring is one
    causal B1 block merged with nothing, the global mean divides by one,
    position ids start at 0); exactly the program's bf16 B1 launches a
    step (``attention_launches``: head-split at LM heads / mp, the
    ring's one block); the NCCL calls a step equal the step's census,
    whose mp all-reduces are 2 ``fwd_row`` and 4 ``bwd_col`` a block,
    each labelled 'mp'; (a)'s graph replays bitwise its eager steps.
    Prints busy ms a step for each mode beside the plain step's and the
    mp NCCL calls' device us, with the card's name and power limit.
    Returns the counted steps' B1 launches."""
    import torch.distributed as dist

    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models.transformer import build_transformer_lm
    from paddle_tpu_torch.parallel import (CommConfig, ParallelExecutor,
                                           comm_audit, make_mesh)
    from paddle_tpu_torch.parallel import context_parallel as cp
    from paddle_tpu_torch.parallel import placement as pl
    from paddle_tpu_torch.parallel.distribute import init_multihost

    t0 = time.perf_counter()
    init_multihost("localhost:%d" % free_port(), 1, 0, device=dev)
    launches = {"flash_attention_bf16": 0}
    feed = {n: torch.from_numpy(a).to(dev) for n, a in lm_feed(
        LM["vocab_size"], LM["seq_len"], LM_B, seed).items()}
    card = card_line()
    try:
        for mode in ("mp", "sp"):
            kw = dict(mp=True) if mode == "mp" else dict(seq_axis="sp")
            with unique_name.guard():
                prog, startup, _, (loss,) = build_transformer_lm(**LM, **kw)
            fluid.amp.enable(prog)
            fwd, grad, _ = attention_launches(prog)
            want = (fwd + grad) * TP_K
            startup.random_seed = seed
            scope0 = fluid.Scope()
            fluid.Executor().run(startup, scope=scope0)
            init = scope_state(scope0)
            del scope0

            def fresh():
                s_ = fluid.Scope()
                for n, t in init.items():
                    s_.set_var(n, t.clone())
                return s_

            def parallel():
                if mode == "mp":
                    return ParallelExecutor(
                        loss_name=loss.name, main_program=prog,
                        mesh=make_mesh((1, 1), ("dp", "mp")), zero_stage=0,
                        comm_config=CommConfig())
                return ParallelExecutor(
                    loss_name=loss.name, main_program=prog,
                    mesh=make_mesh((1, 1), ("dp", "sp")), seq_axis="sp")

            runs = {}
            for name in ("plain", mode):
                scope = fresh()
                exe = fluid.Executor() if name == "plain" else parallel()
                exe._step = 1          # the step after startup's

                def step():
                    return float(exe.run(program=prog, feed=feed,
                                         fetch_list=[loss], scope=scope)[0])

                fa.reset_launches()
                losses = [step() for _ in range(TP_K)]
                torch.cuda.synchronize()
                b1 = dict(fa.launches)
                state = pe_state(scope)
                busy, nccl = comm_profile(step, reps=1)
                runs[name] = dict(losses=losses, state=state, b1=b1,
                                  busy=busy, nccl=nccl,
                                  census=getattr(exe, "last_census", None))
                del scope, exe
                torch.cuda.empty_cache()
            a, p = runs[mode], runs["plain"]
            if a["b1"]["flash_attention_bf16"] != want or \
                    a["b1"]["flash_attention"] != 0:
                raise AssertionError(
                    "%s: B1 launches %s in %d steps, the program has %d "
                    "bf16 (%d forward + %d inside fused_attention_grad a "
                    "step)" % (mode, a["b1"], TP_K, want, fwd, grad))
            launches["flash_attention_bf16"] += want
            bad = same_state(a["state"], p["state"])
            if a["losses"] != p["losses"] or bad:
                raise AssertionError(
                    "%s is not bitwise the plain step: losses %s %s, state "
                    "differs at %s" % (mode, a["losses"], p["losses"],
                                       bad[:5]))
            census = a["census"]
            calls, ranges, nus = a["nccl"]
            if calls != len(census):
                raise AssertionError(
                    "%s: the profiler saw %d NCCL calls in a step, the "
                    "census has %d" % (mode, calls, len(census)))
            axes = comm_audit.axis_stats(census)
            flat = comm_audit.collective_stats(census)
            if sum(k_["count"] for kinds in axes.values()
                   for k_ in kinds.values()) != len(census):
                raise AssertionError("%s: per-axis counts %s do not sum "
                                     "to the census" % (mode, axes))
            nl = LM["num_layers"]
            if mode == "mp":
                tags = [r["tag"] for r in census.records
                        if r["axis"] == "mp"]
                if tags.count("mp.fwd_row") != 2 * nl or \
                        tags.count("mp.bwd_col") != 4 * nl:
                    raise AssertionError(
                        "mp census: %d fwd_row and %d bwd_col all-reduces, "
                        "the program's %d and %d" % (
                            tags.count("mp.fwd_row"),
                            tags.count("mp.bwd_col"), 2 * nl, 4 * nl))
            print("%s (transformer %s, bf16 AMP, batch %d, NCCL world 1): "
                  "%d steps bitwise the plain Executor's (losses %s); %d "
                  "bf16 B1 a step = the program's; %d NCCL calls a step = "
                  "the census %s, by axis %s, their device time %.1f us "
                  "(%d ranges); busy %s ms a step against the plain step's "
                  "%s ms (card: %s)" % (
                      mode, json.dumps(LM), LM_B, TP_K, a["losses"],
                      fwd + grad, calls, json.dumps(
                          {k_: v["count"] for k_, v in flat.items()}),
                      json.dumps({ax: {k_: v["count"]
                                       for k_, v in kinds.items()}
                                  for ax, kinds in axes.items()}),
                      nus, ranges,
                      "%.3f" % a["busy"] if a["busy"] else "not measured",
                      "%.3f" % p["busy"] if p["busy"] else "not measured",
                      card))
            if mode == "mp":
                # K graph replays, the mp collectives captured
                scope = fresh()
                pe = parallel()
                pe._step = 1
                fa.reset_launches()
                out = pe.run_chunk(prog, feed_chunk=chunk_of(feed, TP_K),
                                   fetch_list=[loss], scope=scope)
                torch.cuda.synchronize()
                graph = [float(v) for v in np.asarray(out[0]).ravel()]
                gb1 = fa.launches["flash_attention_bf16"]
                bad = same_state(pe_state(scope), a["state"])
                if graph != a["losses"] or bad or gb1 != want:
                    raise AssertionError(
                        "mp graph replays: losses %s against eager %s, "
                        "state differs at %s, %d bf16 B1 against %d" % (
                            graph, a["losses"], bad[:5], gb1, want))
                launches["flash_attention_bf16"] += gb1
                busy_g = device_busy_ms(lambda: pe.run_chunk(
                    prog, feed_chunk=chunk_of(feed, TP_K), fetch_list=[loss],
                    scope=scope))
                print("mp: %d graph replays bitwise the eager steps, %d "
                      "collectives a replay = the eager census, %d bf16 B1 "
                      "credited; busy %s ms a step in graphs (card: %s)" % (
                          TP_K, len(pe.last_census), gb1,
                          "%.3f" % (busy_g / TP_K) if busy_g
                          else "not measured", card))
                del scope, pe
            if mode == "mp":
                mp_prog = prog
            del runs, init
            torch.cuda.empty_cache()

        # ---- (c) the ring's blocks ----
        ring_err = ring_check(cp, fa, dev, seed)

        # ---- (d) the placement search for the full-width program ----
        def rebuild(p_):
            with unique_name.guard():
                return build_transformer_lm(**LM, mp=p_.mp > 1)[0]

        cands = pl.legal_placements(8, num_heads=LM["num_heads"],
                                    num_layers=LM["num_layers"],
                                    batch_size=LM_B)
        rows = pl.rank([c for c in cands if c.pp == 1], rebuild,
                       batch=LM_B)
        print("placement: hbm_report (1, 1, 1) %s; (1, 8, 1) %s; "
              "legal_placements(8, heads %d, layers %d, batch %d): %s; "
              "estimate_wire_bytes at batch %d, cheapest first (pp = 1; "
              "the pipeline waits for ROADMAP.md Queue 1 item 4b): %s" % (
                  json.dumps(pl.hbm_report(mp_prog, pl.Placement())),
                  json.dumps(pl.hbm_report(mp_prog, pl.Placement(1, 8, 1))),
                  LM["num_heads"], LM["num_layers"], LM_B,
                  [c.label for c in cands], LM_B, json.dumps(
                      [(r["placement"].label, r["wire"]) for r in rows])))
    finally:
        dist.destroy_process_group()
    print("phase 6m: %.1f s (ring max abs err vs the plain ring %.3g)"
          % (time.perf_counter() - t0, ring_err))
    return launches


# ---- phase 6n: pipeline and expert parallelism ----
# The card holds one NCCL rank, so (a) runs the S-stage schedules in one
# process (``pipeline.pipeline_in_process``: every stage on the card, a
# send a hand-over) on the transformer as bench.py trains it (LM, bf16
# AMP, batch LM_B) built with pp_stages=PP_S, pp_micro=PP_M: its stage
# body is the program's own sub-block, B1 in bf16 in every stage; (b)
# runs the executor path at NCCL world 1: pp_stages=1, pp_micro=PP_M
# under a ('pp',) mesh of 1, PP_K eager steps and a run_chunk of PP_K
# graph replays, then the PP_S-stage program PP_K steps under Executor;
# (c) layers.moe at the transformer's width (MOE_T tokens of LM d_model,
# MOE_E experts, MOE_F d_ff, top-1 and top-2) under Executor and an
# ('ep',) mesh of 1, and card against the CPU at MOE_XT tokens whose
# routing keeps a margin. The sums across ranks (the pp sends, the
# experts' all-reduces) are held on the CPU at gloo worlds of 2, 4 and 8
# by tests/test_torch_{pipeline,moe}.py.
PP_S, PP_M, PP_K = 4, 8, 3
MOE_B, MOE_E, MOE_F = 16, 8, 2048
MOE_XB, MOE_XT = 2, 64
# a token keeps a routing margin when its k-th and (k+1)-th gate
# probabilities differ by this much (relative to the k-th) on the CPU
MOE_MARGIN = 1e-3
# card against the CPU after one step on those tokens (float32, TF32
# off): each parameter within this share of its largest magnitude, the
# loss within this share of itself (the products sum in other orders)
MOE_XRTOL = 1e-4
# the microbatched schedules against one whole-batch serial backward:
# the products' shapes differ, so bf16 roundings differ; relative L2 of
# each gradient against its own norm
PP_WHOLE_RTOL = 2e-2
# the ('pp',) executor's Adam moments after its first step against the
# plain Executor's, relative L2 (H100 reading 2.1e-2 on a moment2, the
# square of a gradient, at bench.py's width: the whole model's
# gradients under bf16, not only the trunk's against a small cotangent)
PP_STATE_RTOL = 5e-2
# Adam's first step moves an element by lr g / (|g| + eps), +-lr wherever
# |g| >> eps, so a parameter after it holds only its gradient's signs: an
# element whose gradient nearly cancels may step the other way under
# other product shapes. At most this share of a parameter's elements
# may lie half a step (lr / 2) apart (H100 reading 1.17e-2 at bench.py's
# width)
PP_STEP_SHARE = 5e-2
# the ('pp',) executor's losses against the plain Executor's, relative
# to each loss (H100 readings 1.37e-5 at bench.py's width, 3.31e-5 at the
# card test's reduced width)
PP_LOSS_RTOL = 1e-3


def pipeline_op(prog):
    """The program's ``pipeline`` op."""
    return next(o for o in prog.global_block().ops if o.type == "pipeline")


def stage_attention(prog):
    """B1 launches of one stage's forward (the ``fused_attention`` ops of
    the pipeline op's sub-block)."""
    return sum(o.type == "fused_attention" for o in prog.block(
        pipeline_op(prog).attrs["sub_block_id"]).ops)


def pipeline_launches(prog):
    """B1 launches of one training step of a program whose trunk is a
    ``pipeline`` op: the op's forward runs every stage on every
    microbatch once, and its grad (the generic grad: the lowering again,
    under autograd) once more in GPipe (each microbatch's graph kept;
    its backward is FlashAttention's, no B1) or, in 1F1B, the forward,
    the backward's forward replay on stages 0..S-2 and the recompute of
    every stage."""
    op = pipeline_op(prog)
    s, m = op.attrs["num_stages"], op.attrs["num_micro"]
    per = stage_attention(prog)
    fwd = s * m * per
    grad = fwd if op.attrs["schedule"] == "gpipe" \
        else fwd + (s - 1) * m * per + fwd
    return fwd + grad


def first_step_gaps(init, got, want, params, lr):
    """({accumulator: rel L2}, {parameter: share of elements more than
    lr / 2 apart}) of two scope states ``got`` and ``want`` after one
    Adam step from ``init`` (a tensor of ``got`` reshaped to ``want``'s:
    a trunk tensor is the [1, ...] stack of the plain one). The moments
    hold the gradient itself (m1 = (1 - b1) g, m2 = (1 - b2) g^2 from
    zero); a parameter only its signs (PP_STEP_SHARE)."""
    serr, share = {}, {}
    for n, v in init.items():
        if not v.is_floating_point():
            continue
        w = want[n]
        g = got[n].reshape(w.shape)
        if n in params:
            share[n] = float(((g.double() - w.double()).abs() > lr / 2)
                             .double().mean())
        else:
            serr[n] = rel_l2(g, w)
    return serr, share


def rel_l2(a, b):
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / max(float(torch.linalg.vector_norm(b)), 1e-30))


def pp_schedules(fluid, seed, dev, cfg, batch, s, m, card):
    """Phase 6n (a): the GPipe and 1F1B schedules of ``s`` stages in one
    process on the transformer ``cfg`` (pp_stages=s, pp_micro=m) under
    bf16 AMP: (1) both forwards bitwise the serial stage loop run
    microbatch by microbatch; (2) the two schedules' parameter gradients
    (for one cotangent) bitwise equal; (3) both within PP_WHOLE_RTOL of
    one whole-batch serial backward; (4) the 1F1B backward's most
    stashed inputs a stage within 2(S-1-st)+1; B1 launches exactly the
    schedule's (pipeline_launches' terms). Returns its B1 launches."""
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.core.lower import TraceContext
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models.transformer import build_transformer_lm
    from paddle_tpu_torch.ops.pipeline_ops import stage_fn
    from paddle_tpu_torch.parallel import pipeline as pl

    with unique_name.guard():
        prog, startup, _, _ = build_transformer_lm(
            **dict(cfg, pp_stages=s, pp_micro=m))
    fluid.amp.enable(prog)
    startup.random_seed = seed
    scope = fluid.Scope()
    fluid.Executor(fluid.CUDAPlace(0) if dev.type == "cuda"
                   else fluid.CPUPlace()).run(startup, scope=scope)
    # the op's own stage body (its sub-block, the program's AMP casts)
    op = pipeline_op(prog)
    stage = stage_fn(TraceContext(key=seed, training=True, program=prog,
                                  device=dev), op)
    params = [scope.find_var(n) for n in op.attrs["param_names"]]
    per = stage_attention(prog)
    g = torch.Generator(device="cpu").manual_seed(seed)
    shape = (batch, cfg["seq_len"], cfg["d_model"])
    x = torch.randn(shape, generator=g).to(dev)
    dy = (torch.randn(shape, generator=g) * 1e-2).to(dev)
    key = "flash_attention_bf16" if dev.type == "cuda" else None

    def count():
        return fa.launches[key] if key else 0

    def serial(ps, a):
        for i in range(s):
            a = stage([p[i] for p in ps], [], a)
        return a

    total = 0
    n0 = count()
    with torch.no_grad():
        ys = torch.cat([serial(params, xm) for xm in x.split(batch // m)])
    total += count() - n0
    runs, t0 = {}, time.perf_counter()
    for sch in ("gpipe", "1f1b"):
        leaves = [p.detach().clone().requires_grad_() for p in params]
        stats = {}
        n0 = count()
        y = pl.pipeline_in_process(stage, leaves, [], x, m, sch, stats)
        grads = torch.autograd.grad(y, leaves, dy)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        b1 = count() - n0
        want = s * m * per * (1 if sch == "gpipe" else 3) \
            - (0 if sch == "gpipe" else m * per)
        if key and b1 != want:
            raise AssertionError("%s: %d bf16 B1 launches, the schedule "
                                 "has %d" % (sch, b1, want))
        total += b1
        runs[sch] = (y.detach(), [gr.detach() for gr in grads], stats, b1)
        del y, grads, leaves
    for sch, (y, _, stats, _) in runs.items():
        if not torch.equal(y, ys):
            raise AssertionError("%s forward is not bitwise the serial "
                                 "loop run microbatch by microbatch (max "
                                 "abs diff %.3g)" % (
                                     sch, float((y - ys).abs().max())))
    gp, fp = runs["gpipe"][1], runs["1f1b"][1]
    bad = [n for n, a, b in zip(op.attrs["param_names"], gp, fp)
           if not torch.equal(a, b)]
    if bad:
        raise AssertionError("GPipe and 1F1B gradients differ at %s"
                             % bad[:5])
    peak, bound = runs["1f1b"][2]["peak"], runs["1f1b"][2]["bound"]
    if any(peak[st] > bound[st] for st in bound):
        raise AssertionError("1F1B stashed %s inputs a stage, bound %s"
                             % (peak, bound))
    leaves = [p.detach().clone().requires_grad_() for p in params]
    n0 = count()
    yw = serial(leaves, x)
    gw = torch.autograd.grad(yw, leaves, dy)
    total += count() - n0
    errs = {n: rel_l2(a, b) for n, a, b in zip(op.attrs["param_names"],
                                               gp, gw)}
    fwd_err = rel_l2(ys, yw.detach())
    worst = max(errs.values())
    if worst > PP_WHOLE_RTOL or fwd_err > PP_WHOLE_RTOL:
        raise AssertionError(
            "microbatched schedules against the whole-batch backward: "
            "forward %.3g, worst gradient %s %.3g (bound %g)" % (
                fwd_err, max(errs, key=errs.get), worst, PP_WHOLE_RTOL))
    print("pipeline schedules in one process (transformer %s, pp_stages "
          "%d, pp_micro %d, bf16 AMP, batch %d): both forwards bitwise "
          "the serial loop microbatch by microbatch; GPipe and 1F1B "
          "gradients bitwise equal over %d stacked parameters; against "
          "one whole-batch serial backward: forward rel L2 %.3g, worst "
          "gradient rel L2 %.3g (%s; bound %g); 1F1B stashed inputs a "
          "stage %s (bound %s); bf16 B1 launches GPipe %d, 1F1B %d (%d "
          "a stage forward); %.1f s (card: %s)" % (
              json.dumps(cfg), s, m, batch, len(gp), fwd_err, worst,
              max(errs, key=errs.get), PP_WHOLE_RTOL,
              json.dumps(peak), json.dumps(bound), runs["gpipe"][3],
              runs["1f1b"][3], per, time.perf_counter() - t0, card))
    return total


def moe_build(fluid, tokens, d, e, f, top_k, lr=1.0):
    """``layers.moe`` over [B, tokens, d]: ``e`` experts of ``f``, top-k,
    the moe golden's loss (mean square + 0.01 aux) and SGD."""
    from paddle_tpu_torch import unique_name

    layers = fluid.layers
    with unique_name.guard():
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            x = layers.data("x", [tokens, d])
            out, aux = layers.moe(x, num_experts=e, d_ff=f, top_k=top_k)
            loss = layers.elementwise_add(
                layers.mean(layers.square(out)),
                layers.scale(aux, scale=0.01))
            fluid.optimizer.SGD(lr).minimize(loss)
    return prog, startup, loss


def moe_margin_tokens(gate, pool, k, n):
    """The first ``n`` tokens of ``pool`` (float64 on the CPU) whose k-th
    and (k+1)-th gate probabilities (and, for k > 1, every pair of the
    top k+1) differ by MOE_MARGIN of the k-th: their routing cannot flip
    between the card's and the CPU's roundings."""
    probs = torch.softmax(pool.double() @ gate.double(), dim=-1)
    top = torch.topk(probs, k + 1, dim=-1).values
    gap = (top[:, :-1] - top[:, 1:]) / top[:, :-1]
    keep = torch.nonzero(gap.min(dim=-1).values > MOE_MARGIN)[:, 0]
    if keep.numel() < n:
        raise AssertionError("only %d of %d tokens keep a routing margin"
                             % (keep.numel(), pool.shape[0]))
    return pool[keep[:n]]


def moe_path(fluid, seed, dev, cfg, top_k, card, comm_profile_fn):
    """Phase 6n (c) for one top-k: PP_K steps under Executor, the same
    under ParallelExecutor on an ('ep',) mesh of 1 bitwise; card against
    the CPU at MOE_XB x MOE_XT margin tokens, one step."""
    from paddle_tpu_torch.parallel import ParallelExecutor, make_mesh

    d, t = cfg["d_model"], cfg["seq_len"]
    prog, startup, loss = moe_build(fluid, t, d, MOE_E, MOE_F, top_k)
    startup.random_seed = seed
    scope0 = fluid.Scope()
    fluid.Executor().run(startup, scope=scope0)
    init = scope_state(scope0)
    g = torch.Generator(device="cpu").manual_seed(seed + top_k)
    feed = {"x": (torch.randn(MOE_B, t, d, generator=g) * 0.5).to(dev)}
    runs = {}
    for name in ("plain", "ep"):
        scope = fluid.Scope()
        for n, v in init.items():
            scope.set_var(n, v.clone())
        exe = fluid.Executor() if name == "plain" else ParallelExecutor(
            loss_name=loss.name, main_program=prog,
            mesh=make_mesh((1,), ("ep",)))
        exe._step = 1
        losses = [float(exe.run(program=prog, feed=feed, fetch_list=[loss],
                                scope=scope)[0]) for _ in range(PP_K)]
        runs[name] = dict(losses=losses, state=pe_state(scope),
                          census=getattr(exe, "last_census", None))
        if name == "ep":
            busy, nccl = comm_profile_fn(lambda: exe.run(
                program=prog, feed=feed, fetch_list=[loss], scope=scope),
                reps=1)
            runs[name]["busy"], runs[name]["nccl"] = busy, nccl
        del scope, exe
    a, p = runs["ep"], runs["plain"]
    bad = same_state(a["state"], p["state"])
    if a["losses"] != p["losses"] or bad:
        raise AssertionError("moe top-%d on ('ep',) of 1 is not bitwise "
                             "the Executor: losses %s %s, state at %s"
                             % (top_k, a["losses"], p["losses"], bad[:5]))
    if not (np.isfinite(p["losses"]).all()
            and p["losses"][-1] < p["losses"][0]):
        raise AssertionError("moe top-%d losses %s" % (top_k, p["losses"]))
    calls = a["nccl"][0]
    if calls != len(a["census"]):
        raise AssertionError("moe ep: %d NCCL calls a step, the census %d"
                             % (calls, len(a["census"])))
    # card against the CPU: margin tokens, one step from the same state
    xprog, xstart, xloss = moe_build(fluid, MOE_XT, d, MOE_E, MOE_F,
                                     top_k)
    xstart.random_seed = seed
    s_cpu = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(xstart, scope=s_cpu)
    mop = next(o for o in xprog.global_block().ops if o.type == "moe")
    gate = s_cpu.find_var(mop.inputs["Gate"][0])
    pool = torch.randn(64 * MOE_XB * MOE_XT, d, generator=g) * 0.5
    toks = moe_margin_tokens(gate, pool, top_k, MOE_XB * MOE_XT) \
        .float().reshape(MOE_XB, MOE_XT, d)
    s_card = fluid.Scope()
    for n, v in scope_state(s_cpu).items():
        s_card.set_var(n, v.to(dev))
    lc = float(fluid.Executor(fluid.CPUPlace()).run(
        xprog, feed={"x": toks}, fetch_list=[xloss], scope=s_cpu)[0])
    lg = float(fluid.Executor().run(xprog, feed={"x": toks.to(dev)},
                                    fetch_list=[xloss], scope=s_card)[0])
    worst = 0.0
    for n, v in scope_state(s_cpu).items():
        w = s_card.find_var(n).cpu()
        if v.is_floating_point():
            e = float((w.double() - v.double()).abs().max())
            tol = MOE_XRTOL * float(v.double().abs().max())
            if e > tol:
                raise AssertionError("moe top-%d card vs CPU: %s differs "
                                     "by %.3g (bound %.3g)" % (top_k, n, e,
                                                                tol))
            worst = max(worst, e / max(float(v.double().abs().max()),
                                       1e-30))
    if abs(lg - lc) > MOE_XRTOL * abs(lc):
        raise AssertionError("moe top-%d card vs CPU loss %r %r"
                             % (top_k, lg, lc))
    print("moe top-%d ([%d, %d, %d] tokens, %d experts, d_ff %d, SGD): %d "
          "Executor steps (losses %s) bitwise under an ('ep',) mesh of 1; "
          "%d NCCL calls a step = the census %s; busy %s ms a step; card "
          "vs CPU at [%d, %d] margin tokens (k-th/(k+1)-th gate gap > %g "
          "of the k-th on the CPU in float64): loss %r vs %r, worst "
          "parameter %.3g of its max after one step (bound %g of the "
          "max) (card: %s)" % (
              top_k, MOE_B, t, d, MOE_E, MOE_F, PP_K, p["losses"], calls,
              json.dumps(comm_audit_kinds(a["census"])),
              "%.3f" % a["busy"] if a["busy"] else "not measured",
              MOE_XB, MOE_XT, MOE_MARGIN, lg, lc, worst, MOE_XRTOL, card))
    return a["busy"]


def comm_audit_kinds(census):
    from paddle_tpu_torch.parallel import comm_audit

    return {k: v["count"] for k, v in
            comm_audit.collective_stats(census).items()}


def pp_phase(fluid, seed, dev, cfg=None, batch=None):
    """Phase 6n: pipeline ('pp') and expert ('ep') parallelism (see the
    comment above). (a) ``pp_schedules``; (b) the ('pp',) mesh of 1
    under ParallelExecutor: PP_K eager steps, the same from a fresh
    state as one run_chunk of graph replays (bitwise the eager ones),
    the plain Executor's losses within PP_LOSS_RTOL, its Adam moments
    after the first step within PP_STATE_RTOL (rel L2; microbatching
    changes the products' shapes) and its parameters then within
    PP_STEP_SHARE (``first_step_gaps``), the B1 launches
    ``pipeline_launches`` derives, the NCCL calls a step the census, and
    the PP_S-stage program PP_K steps under Executor (finite, falling
    losses); (c) ``moe_path`` top-1 and top-2. Prints the busy ms of a
    pipelined and a plain step beside the card's name and power limit.
    Returns the path's B1 launches."""
    import torch.distributed as dist

    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models.transformer import build_transformer_lm
    from paddle_tpu_torch.parallel import ParallelExecutor, make_mesh
    from paddle_tpu_torch.parallel.distribute import init_multihost

    cfg = cfg or LM
    batch = batch or LM_B
    t0 = time.perf_counter()
    init_multihost("localhost:%d" % free_port(), 1, 0, device=dev)
    launches = {"flash_attention_bf16": 0}
    card = card_line()
    try:
        # ---- (a) the schedules of PP_S stages in one process ----
        launches["flash_attention_bf16"] += pp_schedules(
            fluid, seed, dev, cfg, batch, PP_S, PP_M, card)
        torch.cuda.empty_cache()

        t_a = time.perf_counter()

        # ---- (b) the executor path at world 1 ----
        feed = {n: torch.from_numpy(a).to(dev) for n, a in lm_feed(
            cfg["vocab_size"], cfg["seq_len"], batch, seed).items()}
        with unique_name.guard():
            prog, startup, _, (loss,) = build_transformer_lm(
                **dict(cfg, pp_stages=1, pp_micro=PP_M))
        with unique_name.guard():
            plain, _, _, (ploss,) = build_transformer_lm(**cfg)
        for p_ in (prog, plain):
            fluid.amp.enable(p_)
        startup.random_seed = seed
        scope0 = fluid.Scope()
        fluid.Executor().run(startup, scope=scope0)
        init = scope_state(scope0)
        del scope0
        want = pipeline_launches(prog)
        pf, pg, _ = attention_launches(plain)

        pvars = plain.global_block().vars

        def fresh(plain_layout=False):
            s_ = fluid.Scope()
            for n, v in init.items():
                # the plain program's trunk parameters (and their Adam
                # moments) are the one stage's [1, ...] stacks without
                # the stage dim
                if plain_layout and n in pvars and tuple(v.shape) == \
                        (1,) + tuple(pvars[n].shape):
                    v = v[0]
                s_.set_var(n, v.clone())
            return s_

        runs = {}
        for name in ("plain", "pp"):
            if name == "plain":
                scope = fresh(True)
                exe = fluid.Executor()
                pr, lo = plain, ploss
            else:
                scope = fresh()
                exe = ParallelExecutor(loss_name=loss.name,
                                       main_program=prog,
                                       mesh=make_mesh((1,), ("pp",)))
                pr, lo = prog, loss
            exe._step = 1

            def step():
                return float(exe.run(program=pr, feed=feed, fetch_list=[lo],
                                     scope=scope)[0])

            fa.reset_launches()
            losses = [step()]
            first = pe_state(scope)
            losses += [step() for _ in range(PP_K - 1)]
            torch.cuda.synchronize()
            b1 = dict(fa.launches)
            runs[name] = dict(losses=losses, state=pe_state(scope), b1=b1,
                              first=first)
            busy, nccl = comm_profile(step, reps=1)
            runs[name].update(busy=busy, nccl=nccl,
                              census=getattr(exe, "last_census", None))
            del scope, exe
            torch.cuda.empty_cache()
        a, p = runs["pp"], runs["plain"]
        if a["b1"]["flash_attention_bf16"] != want * PP_K or \
                a["b1"]["flash_attention"] != 0:
            raise AssertionError("pp: B1 launches %s in %d steps, the "
                                 "program's %d a step" % (a["b1"], PP_K,
                                                          want))
        if p["b1"]["flash_attention_bf16"] != (pf + pg) * PP_K:
            raise AssertionError("plain: B1 launches %s, the program's %d "
                                 "a step" % (p["b1"], pf + pg))
        launches["flash_attention_bf16"] += (want + pf + pg) * PP_K
        lerr = max(abs(x_ - y_) / abs(y_) for x_, y_ in zip(a["losses"],
                                                          p["losses"]))
        if lerr > PP_LOSS_RTOL:
            raise AssertionError("pp_micro %d losses %s against the plain "
                                 "Executor's %s (worst rel %.3g, bound %g)"
                                 % (PP_M, a["losses"], p["losses"], lerr,
                                    PP_LOSS_RTOL))
        serr, share = first_step_gaps(
            init, a["first"], p["first"],
            {v.name for v in plain.global_block().all_parameters()},
            cfg.get("lr", inspect.signature(
                build_transformer_lm).parameters["lr"].default))
        sworst = max(serr, key=serr.get)
        pworst = max(share, key=share.get)
        first = ("after the first step %d accumulators within rel L2 %.3g "
                 "(%s; bound %g), %d parameters with at most %.3g of "
                 "their elements half a step apart (%s; bound %g)" % (
                     len(serr), serr[sworst], sworst, PP_STATE_RTOL,
                     len(share), share[pworst], pworst, PP_STEP_SHARE))
        print("pp_micro %d against the plain Executor: %s" % (PP_M, first))
        if serr[sworst] > PP_STATE_RTOL or share[pworst] > PP_STEP_SHARE:
            raise AssertionError("pp_micro %d state %s" % (PP_M, first))
        census, (calls, ranges, nus) = a["census"], a["nccl"]
        if calls != len(census):
            raise AssertionError("pp: %d NCCL calls a step, the census %d"
                                 % (calls, len(census)))
        # K graph replays from a fresh state: bitwise the eager steps
        scope = fresh()
        pe = ParallelExecutor(loss_name=loss.name, main_program=prog,
                              mesh=make_mesh((1,), ("pp",)))
        pe._step = 1
        fa.reset_launches()
        out = pe.run_chunk(prog, feed_chunk=chunk_of(feed, PP_K),
                           fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
        graph = [float(v) for v in np.asarray(out[0]).ravel()]
        gb1 = fa.launches["flash_attention_bf16"]
        bad = same_state(pe_state(scope), a["state"])
        if graph != a["losses"] or bad or gb1 != want * PP_K:
            raise AssertionError(
                "pp graph replays: losses %s against eager %s, state "
                "differs at %s, %d bf16 B1 against %d" % (
                    graph, a["losses"], bad[:5], gb1, want * PP_K))
        launches["flash_attention_bf16"] += gb1
        busy_g = device_busy_ms(lambda: pe.run_chunk(
            prog, feed_chunk=chunk_of(feed, PP_K), fetch_list=[loss],
            scope=scope))
        del scope, pe
        torch.cuda.empty_cache()
        print("pp executor path (transformer %s, pp_stages 1, pp_micro %d, "
              "bf16 AMP, batch %d, ('pp',) mesh of 1, NCCL world 1): %d "
              "eager steps (losses %s) against the plain Executor's %s "
              "(worst rel %.3g, bound %g); %s; %d graph replays bitwise the "
              "eager steps; %d bf16 B1 a step = the program's (%d stage "
              "forwards x 2: the op and its generic grad's GPipe "
              "forward) against the plain step's %d; %d NCCL calls a step "
              "= the census %s (%d ranges, %.1f us); busy ms a step: "
              "pipelined %s, plain %s, pipelined in graphs %s (card: %s)"
              % (json.dumps(cfg), PP_M, batch, PP_K, a["losses"],
                 p["losses"], lerr, PP_LOSS_RTOL, first, PP_K, want,
                 want // 2,
                 pf + pg, calls, json.dumps(comm_audit_kinds(census)),
                 ranges, nus,
                 "%.3f" % a["busy"] if a["busy"] else "not measured",
                 "%.3f" % p["busy"] if p["busy"] else "not measured",
                 "%.3f" % (busy_g / PP_K) if busy_g else "not measured",
                 card))
        del runs, init

        # the PP_S-stage program trains under Executor as bench.py trains
        with unique_name.guard():
            prog4, start4, _, (loss4,) = build_transformer_lm(
                **dict(cfg, pp_stages=PP_S, pp_micro=PP_M))
        fluid.amp.enable(prog4)
        start4.random_seed = seed
        scope = fluid.Scope()
        exe = fluid.Executor()
        exe.run(start4, scope=scope)
        fa.reset_launches()
        losses = [float(exe.run(prog4, feed=feed, fetch_list=[loss4],
                                scope=scope)[0]) for _ in range(PP_K)]
        torch.cuda.synchronize()
        n4 = fa.launches["flash_attention_bf16"]
        # the serial loop: every stage once in the op, once more in its
        # generic grad's forward under autograd
        w4 = 2 * PP_S * stage_attention(prog4)
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]) \
                or n4 != w4 * PP_K:
            raise AssertionError("pp_stages %d under Executor: losses %s, "
                                 "%d bf16 B1 (want %d)" % (
                                     PP_S, losses, n4, w4 * PP_K))
        launches["flash_attention_bf16"] += n4
        print("pp_stages %d, pp_micro %d under Executor (the serial stage "
              "loop, bf16 AMP): %d steps, losses %s; %d bf16 B1 a step"
              % (PP_S, PP_M, PP_K, losses, w4))
        del scope, exe
        torch.cuda.empty_cache()
        t_b = time.perf_counter()

        # ---- (c) MoE at the transformer's width ----
        for k in (1, 2):
            moe_path(fluid, seed, dev, cfg, k, card, comm_profile)
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    t1 = time.perf_counter()
    print("phase 6n: %.1f s ((a) %.1f s, (b) %.1f s, (c) %.1f s)"
          % (t1 - t0, t_a - t0, t_b - t_a, t1 - t_b))
    return launches


# ---- phase 6o: checkpoints and recovery (paddle_tpu_torch.distributed) ----
# The transformer as bench.py trains it under the step guard with dynamic
# loss scaling: guard_phase's program and weights. (b) and (c) run chunks
# of CKPT_K steps, three a run. A generation is ~700 MB: (a) writes its two
# with zlib, the default and the JAX package's bytes (~18 MB/s a thread on
# the card's host, ~40 s a generation); (b) and (c) write their six
# uncompressed, as a run that saves this often would.
CKPT_K, CKPT_CHUNKS, CKPT_COMPRESSOR = 4, 3, "none"
# the MNIST MLP of (d): batch, SGD rate, tasks (one batch a task)
PS_B, PS_LR, PS_TASKS = 64, 0.1, 3


def b1_counts(want_bf16):
    """B1's launches by name since the last ``reset_all_launches``,
    against ``want_bf16`` bf16 ones and no float32 one."""
    got = {n: v for n, v in all_launches().items() if v}
    if got != {"flash_attention_bf16": want_bf16}:
        raise AssertionError("launches %s, want %d bf16 B1 and nothing "
                             "else" % (got, want_bf16))
    return want_bf16


def same_scope(what, got, want):
    """Every tensor of two ``scope_state`` dicts bitwise equal."""
    if set(got) != set(want):
        raise AssertionError("%s: names differ: %s" % (
            what, sorted(set(got) ^ set(want))[:8]))
    bad = [n for n in want if got[n].dtype != want[n].dtype
           or not torch.equal(got[n].reshape(-1), want[n].reshape(-1))]
    if bad:
        raise AssertionError("%s: %d of %d tensors differ: %s"
                             % (what, len(bad), len(want), bad[:8]))
    return len(want)


def dir_bytes(d):
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(d) for f in fs)


def last_write(d):
    """Seconds since the epoch of the newest file under ``d``: when a
    writer thread committed its generation."""
    return max(os.path.getmtime(os.path.join(r, f))
               for r, _, fs in os.walk(d) for f in fs)


def ckpt_round_trip(fluid, lm, dev, d, meanwhile):
    """(a) 2 eager steps, one async save through ``CheckpointManager``
    (the whole scope, the guard's state included) and one through
    ``ShardedCheckpointManager``, 2 more steps and ``meanwhile()`` while
    they write (zlib, the default: ~40 s a generation); each generation
    restored into a fresh scope on the card runs the same 2 steps:
    losses and every state tensor bitwise the uninterrupted run's, 16
    bf16 B1 a step. Returns (a)'s B1 launches and what ``meanwhile``
    returned."""
    from paddle_tpu_torch.distributed.checkpoint import (CheckpointManager,
                                                         load_checkpoint)
    from paddle_tpu_torch.distributed.sharded_checkpoint import (
        ShardedCheckpointManager, load_sharded_checkpoint)

    prog, loss, feed, per_step = lm["prog"], lm["loss"], lm["feed"], \
        lm["b1"]
    place = fluid.CUDAPlace(dev.index or 0)

    def step(exe, scope, s):
        return float(exe.run(prog, feed=feed, fetch_list=[loss],
                             scope=scope, step0=s)[0])

    scope, exe = fresh_scope(fluid, lm["init"]), fluid.Executor()
    losses = [step(exe, scope, s) for s in range(2)]
    plain = CheckpointManager(os.path.join(d, "plain"), async_save=True,
                              scope=scope)
    sharded = ShardedCheckpointManager(os.path.join(d, "sharded"))
    torch.cuda.synchronize()
    t0, wall0 = time.perf_counter(), time.time()
    plain.save(1)
    t_plain = time.perf_counter() - t0
    sharded.save(1, scope, prog)
    t_snap = time.perf_counter() - t0
    losses += [step(exe, scope, s) for s in range(2, 4)]
    torch.cuda.synchronize()
    t_steps = time.perf_counter() - t0 - t_snap
    exe.poll_health()
    want = scope_state(scope)
    del scope, exe
    t1 = time.perf_counter()
    beside = meanwhile()
    t_beside = time.perf_counter() - t1
    plain.wait()
    sharded.wait()
    t_write = [last_write(os.path.join(d, n)) - wall0
               for n in ("plain", "sharded")]
    out = {}
    for name, restore in (
            ("CheckpointManager", lambda s: load_checkpoint(
                os.path.join(d, "plain"), scope=s, place=place)),
            ("ShardedCheckpointManager", lambda s: load_sharded_checkpoint(
                os.path.join(d, "sharded"), s, {}, place=place))):
        scope = fluid.Scope()
        t1 = time.perf_counter()
        meta = restore(scope)
        t_restore = time.perf_counter() - t1
        if meta["step"] != 1:
            raise AssertionError("(a) %s restored step %s" % (name,
                                                              meta["step"]))
        exe = fluid.Executor()
        reset_all_launches()
        # the restored generation's step: the resumed run goes on after it
        got = [step(exe, scope, meta["step"] + 1 + i) for i in range(2)]
        exe.poll_health()
        torch.cuda.synchronize()
        b1_counts(2 * per_step)
        if got != losses[2:]:
            raise AssertionError("(a) %s: losses %s after the restore, %s "
                                 "uninterrupted" % (name, got, losses[2:]))
        n = same_scope("(a) %s" % name, scope_state(scope), want)
        out[name] = (t_restore, n)
        del scope, exe
    print("6o (a) checkpoint round trip, the guarded transformer (bf16 AMP, "
          "dynamic loss scale): losses %s; async save after step 1: %.3f s "
          "on the training thread for CheckpointManager's host copy (%.1f "
          "MB of zlib chunks), %.3f s for both managers', then 2 steps "
          "(%.3f s) and (b) and (c) (%.1f s) beside the writers, which "
          "committed %.1f s and %.1f s after the save; restored into a "
          "fresh scope on the card and 2 steps run: %s, losses and every "
          "state tensor (the guard's 3 included) bitwise the uninterrupted "
          "run's, %d bf16 B1 a step" % (
              losses, t_plain, dir_bytes(os.path.join(d, "plain")) / 1e6,
              t_snap, t_steps, t_beside, t_write[0], t_write[1],
              ", ".join("%s %.3f s (%d tensors)" % (n, t, c)
                        for n, (t, c) in out.items()), per_step))
    return 2 * 2 * per_step, beside


def ckpt_rollback(fluid, lm, dev, d):
    """(b) ``guard.nonfinite`` on every step of the second chunk: the
    guard skips them, the detector trips (``max_consecutive_skips`` =
    CKPT_K) on the rows it processes at the third chunk's dispatch, and
    ``RecoveryLoop`` quarantines the diverged generation, restores the
    clean one and replays: every counter equals the injected counts
    (tests/test_guard.py:591-678), the final state and the replayed
    losses bitwise the unfaulted run's."""
    from paddle_tpu_torch import fault, guard, telemetry
    from paddle_tpu_torch.distributed.recovery import RecoveryLoop
    from paddle_tpu_torch.distributed.sharded_checkpoint import (
        ShardedCheckpointManager, latest_sharded_checkpoint)

    prog, loss, per_step = lm["prog"], lm["loss"], lm["b1"]
    k, steps = CKPT_K, CKPT_K * CKPT_CHUNKS
    chunk = chunk_of(lm["feed"], k)
    cfg0 = prog.guard
    guard.enable(prog, loss, dynamic_loss_scale=True,
                 growth_interval=GUARD_GROWTH, max_consecutive_skips=k)
    try:
        scope, exe = fresh_scope(fluid, lm["init"]), fluid.Executor()
        ref_losses = {s: exe.run_chunk(prog, feed_chunk=chunk, k=k,
                                       fetch_list=[loss], scope=scope,
                                       step0=s)[0]
                      for s in range(0, steps, k)}
        exe.poll_health()
        ref = scope_state(scope)
        del scope, exe
        telemetry.reset()
        telemetry.enable()
        scope, exe = fresh_scope(fluid, lm["init"]), fluid.Executor()
        rule = fault.inject("guard.nonfinite", crash_on_nth=k + 1, times=k)
        calls, losses = [], {}

        def step_fn(s):
            calls.append(s)
            losses[s] = exe.run_chunk(prog, feed_chunk=chunk, k=k,
                                      fetch_list=[loss], scope=scope,
                                      step0=s)[0]

        ckpt = os.path.join(d, "rollback")
        loop = RecoveryLoop(ckpt, scope, prog, target_shardings={},
                            max_rollbacks=1,
                            manager=ShardedCheckpointManager(
                                ckpt, keep_max=2,
                                compressor=CKPT_COMPRESSOR))
        reset_all_launches()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            loop.run(step_fn, steps, steps_per_call=k)
        exe.poll_health()
        torch.cuda.synchronize()
        t_loop = time.perf_counter() - t0
        fault.clear()
        s = telemetry.summary()
        telemetry.disable()
        counters = {n: s.get("paddle_tpu_%s" % n) for n in (
            "guard_skipped_steps_total", "fault_injected_total",
            "guard_rollbacks_total", "guard_divergence_total")}
        want_counters = {"guard_skipped_steps_total": k,
                         "fault_injected_total": k,
                         "guard_rollbacks_total": 1,
                         "guard_divergence_total": 1}
        if counters != want_counters or rule.fires != k \
                or loop.rollbacks != 1 or loop.restarts != 0 \
                or calls != [0, k, 2 * k, k, 2 * k] \
                or not s.get("paddle_tpu_checkpoint_quarantined_total") \
                or not any("diverged" in str(c.message) for c in caught):
            raise AssertionError(
                "(b) counters %s (want %s), fires %d, rollbacks %d, "
                "restarts %d, chunks %s" % (counters, want_counters,
                                            rule.fires, loop.rollbacks,
                                            loop.restarts, calls))
        best = latest_sharded_checkpoint(ckpt, quarantine=False)
        if best["step"] != steps - 1 or not best["health"]["clean"]:
            raise AssertionError("(b) newest generation %s" % best)
        for st in (k, 2 * k):
            if not np.array_equal(losses[st], ref_losses[st]):
                raise AssertionError("(b) replayed losses at %d: %s, "
                                     "unfaulted %s" % (st, losses[st],
                                                       ref_losses[st]))
        n = same_scope("(b) final state", scope_state(scope), ref)
        b1 = b1_counts(len(calls) * k * per_step)
        scale = float(scope.find_var("guard@loss_scale"))
        del scope, exe
    finally:
        prog.guard = cfg0
        fault.clear()
    print("6o (b) rollback: guard.nonfinite at steps %d..%d (1-based), the "
          "detector tripped on the rows of chunk %d processed at the next "
          "dispatch; RecoveryLoop quarantined the diverged generation, "
          "restored generation %d and replayed: chunks run %s, counters %s, "
          "rule fires %d; the replayed losses and all %d state tensors (the "
          "guard's: loss scale %g) bitwise the unfaulted run's; %d bf16 B1; "
          "%.3f s" % (k + 1, 2 * k, k, k - 1, calls, counters, rule.fires,
                      n, scale, b1, t_loop))
    return b1


class _EpochStub:
    """A watcher whose epoch the step function moves (one rank, one
    card: the membership's (epoch, members) pair without a server)."""

    def __init__(self):
        self.epoch, self.members = 0, ("w0",)

    def snapshot(self):
        return self.epoch, self.members


def ckpt_elastic(fluid, lm, dev, d):
    """(c) ``ParallelExecutor`` on ('dp',) of 1 with
    ``CommConfig(zero_stage=1)`` (the guard does not compose with it:
    the AMP program without the guard, the same weights): a sharded
    generation restored onto the plain ``Executor`` (``{}``, the ZeRO
    accumulators folded back by ``restore_full_opt_state``) and back
    onto the executor's layout continues bitwise; ``ElasticRecoveryLoop``
    with the epoch moving twice (``set_mesh`` onto a new one-rank mesh
    each time, the state resharded in memory) runs bitwise the fixed
    run, ``cluster_epoch`` follows and the plan and its graphs are built
    once an epoch."""
    from paddle_tpu_torch import telemetry
    from paddle_tpu_torch.distributed.recovery import ElasticRecoveryLoop
    from paddle_tpu_torch.distributed.sharded_checkpoint import (
        load_sharded_checkpoint, save_sharded_checkpoint)
    from paddle_tpu_torch.parallel import (CommConfig, ParallelExecutor,
                                           collectives, make_mesh)

    prog, _startup, loss = lm["build"]("off")
    per_step = lm["b1"]
    k, steps = CKPT_K, CKPT_K * CKPT_CHUNKS
    chunk = chunk_of(lm["feed"], k)
    place = fluid.CUDAPlace(dev.index or 0)

    def new_pe():
        return ParallelExecutor(loss_name=loss.name, main_program=prog,
                                mesh=make_mesh((1,), ("dp",)),
                                zero_stage=0,
                                comm_config=CommConfig(zero_stage=1))

    def run(pe, scope, s):
        return pe.run_chunk(prog, feed_chunk=chunk, k=k, fetch_list=[loss],
                            scope=scope, step0=s)[0]

    reset_all_launches()
    scope, pe = fresh_scope(fluid, lm["init"]), new_pe()
    fixed = [run(pe, scope, s) for s in range(0, steps, k)]
    ref = scope_state(scope)
    del scope, pe
    # a sharded generation onto the plain Executor and back
    scope, pe = fresh_scope(fluid, lm["init"]), new_pe()
    run(pe, scope, 0)
    save_sharded_checkpoint(os.path.join(d, "c_pe"), k - 1, scope, prog,
                            compressor=CKPT_COMPRESSOR)
    del scope, pe
    plain = fluid.Scope()
    meta = load_sharded_checkpoint(os.path.join(d, "c_pe"), plain, {},
                                   place=place)
    folded = collectives.restore_full_opt_state(plain, prog)
    save_sharded_checkpoint(os.path.join(d, "c_plain"), k - 1, plain, prog,
                            compressor=CKPT_COMPRESSOR)
    first = float(fluid.Executor().run(prog, feed=lm["feed"],
                                       fetch_list=[loss], scope=plain,
                                       step0=meta["step"] + 1)[0])
    if first != float(fixed[1][0]):
        raise AssertionError("(c) the plain Executor's first loss %r != the "
                             "fixed run's %r" % (first, fixed[1][0]))
    del plain
    scope, pe = fluid.Scope(), new_pe()
    load_sharded_checkpoint(os.path.join(d, "c_plain"), scope,
                            pe.state_shardings(prog), place=place)
    back = [run(pe, scope, s) for s in range(k, steps, k)]
    if not all(np.array_equal(a, b) for a, b in zip(back, fixed[1:])):
        raise AssertionError("(c) losses after the round trip %s, fixed %s"
                             % (back, fixed[1:]))
    same_scope("(c) after the round trip", scope_state(scope), ref)
    del scope, pe
    # the elastic loop, the epoch moving before steps k and 2k
    telemetry.reset()
    telemetry.enable()
    w = _EpochStub()
    scope, pe = fresh_scope(fluid, lm["init"]), new_pe()

    def rebuild(members, epoch):
        pe.set_mesh(make_mesh((1,), ("dp",)), epoch=epoch)
        return pe.state_shardings(prog)

    got = {}

    def step_fn(s):
        got[s] = run(pe, scope, s)
        if s in (0, k):   # the loop reshards at the next boundary
            w.epoch += 1

    loop = ElasticRecoveryLoop(os.path.join(d, "elastic"), scope, prog,
                               watcher=w, rebuild=rebuild,
                               target_shardings=pe.state_shardings(prog),
                               save_interval_steps=10 ** 9, place=place)
    t0 = time.perf_counter()
    loop.run(step_fn, steps, steps_per_call=k)
    torch.cuda.synchronize()
    t_loop = time.perf_counter() - t0
    # a plan miss an epoch, and on the card its graph's capture, which
    # the recompile detector counts too
    builds = telemetry.recompile_detector.compile_count(prog.fingerprint)
    want = 3 * (2 if dev.type == "cuda" else 1)
    s = telemetry.summary()
    telemetry.disable()
    if loop.reshards != 2 or loop.last_reshard["path"] != "memory" \
            or loop.cluster_epoch != 2 or pe.cluster_epoch != 2 \
            or builds != want:
        raise AssertionError("(c) reshards %d (%s), epochs loop %s "
                             "executor %s, plan builds and captures %d "
                             "(want 2, memory, 2, 2, %d)"
                             % (loop.reshards, loop.last_reshard["path"],
                                loop.cluster_epoch, pe.cluster_epoch,
                                builds, want))
    if not all(np.array_equal(got[st], fixed[i])
               for i, st in enumerate(range(0, steps, k))):
        raise AssertionError("(c) elastic losses %s, fixed %s" % (got,
                                                                   fixed))
    n = same_scope("(c) elastic against fixed", scope_state(scope), ref)
    del scope, pe
    b1 = b1_counts((3 * steps + 1) * per_step)
    print("6o (c) ParallelExecutor ('dp',) of 1, CommConfig(zero_stage=1): "
          "a sharded generation restored onto the plain Executor ({}, %d "
          "ZeRO accumulators folded back), its first loss bitwise the fixed "
          "run's, and back onto the executor's layout: %d steps bitwise; "
          "ElasticRecoveryLoop, the epoch moved before steps %d and %d: 2 "
          "in-memory reshards (downtime %s s, %.1f MB moved), "
          "cluster_epoch %d, %d plan builds and graph captures (one of "
          "each an epoch on the card), losses and all %d state tensors "
          "bitwise the fixed run's; %d bf16 B1; loop %.3f s" % (
              folded, steps - k, k, 2 * k,
              s.get("paddle_tpu_elastic_downtime_seconds:sum"),
              s.get("paddle_tpu_elastic_state_moved_bytes_total", 0) / 1e6,
              loop.cluster_epoch, builds, n, b1, t_loop))
    return b1


def ckpt_services(fluid, seed, dev):
    """(d) ``RemoteTrainer`` on the MNIST MLP (``models.lenet.mlp``)
    against an in-process ``ParameterServer`` (SGD), fed by
    ``MasterClient.tasks()`` (one batch a task), against the plain
    ``Executor`` with SGD from the same weights: every task finishes
    once; the first loss bitwise (the same weights), then the update:
    the server's numpy ``p - lr * g`` against the card's SGD op, held at
    4 ulps of each parameter's largest magnitude."""
    from paddle_tpu_torch import layers, unique_name
    from paddle_tpu_torch.distributed.master import (MasterClient,
                                                     MasterServer)
    from paddle_tpu_torch.distributed.pserver import (ParameterServer,
                                                      RemoteTrainer,
                                                      sgd_update)
    from paddle_tpu_torch.models.lenet import mlp

    with unique_name.guard():
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            img = layers.data("img", [784])
            label = layers.data("label", [1], dtype="int64")
            loss = layers.mean(layers.cross_entropy(mlp(img), label))
            fluid.optimizer.SGD(PS_LR).minimize(loss)
    startup.random_seed = seed
    s0 = fluid.Scope()
    fluid.Executor().run(startup, scope=s0)
    init = scope_state(s0)
    del s0
    rng = np.random.RandomState(seed)
    feeds = [{"img": rng.rand(PS_B, 784).astype(np.float32),
              "label": rng.randint(0, 10, (PS_B, 1)).astype(np.int64)}
             for _ in range(PS_TASKS)]
    scope, exe = fresh_scope(fluid, init), fluid.Executor()
    plain = [float(exe.run(prog, feed=f, fetch_list=[loss],
                           scope=scope)[0]) for f in feeds]
    want = scope_state(scope)
    del scope, exe
    srv = ParameterServer(trainers=1, optimizer=sgd_update(PS_LR)).start()
    master = MasterServer(lease_timeout=60.0).start()
    finished = []
    try:
        mc = MasterClient(master.address)
        mc.set_dataset(task_payloads=[json.dumps({"batch": i})
                                      for i in range(PS_TASKS)])
        scope = fresh_scope(fluid, init)
        rt = RemoteTrainer(prog, ["%s:%d" % srv.address],
                           exe=fluid.Executor(), scope=scope,
                           init_params=True)
        remote = []
        for tid, payload in mc.tasks(lease_timeout=60.0):
            i = json.loads(payload)["batch"]
            remote.append(float(rt.step(feeds[i], fetch_list=[loss])[0]))
            mc.task_finished(tid)
            finished.append(i)
        counts = mc.counts()
        rt.close()
        mc.close()
    finally:
        master.shutdown()
        srv.shutdown()
    if sorted(finished) != list(range(PS_TASKS)) or counts != {
            "todo": 0, "pending": 0, "done": PS_TASKS, "discarded": 0}:
        raise AssertionError("(d) tasks finished %s, counts %s"
                             % (finished, counts))
    if remote[0] != plain[0] or not np.allclose(remote, plain, rtol=1e-6,
                                                atol=0):
        raise AssertionError("(d) RemoteTrainer losses %s, plain %s"
                             % (remote, plain))
    worst = 0.0
    for p, _g in rt.params_grads:
        a, b = scope.find_var(p), want[p]
        ulp = float(torch.finfo(torch.float32).eps) * float(b.abs().max())
        err = float((a - b).abs().max())
        worst = max(worst, err / ulp)
        if err > 4 * ulp:
            raise AssertionError("(d) %s differs by %.3g (%.2f ulps of its "
                                 "max)" % (p, err, err / ulp))
    print("6o (d) RemoteTrainer (MNIST MLP, batch %d, SGD %g) fed by "
          "MasterClient.tasks(): tasks %s each finished once, counts %s; "
          "losses %s, the plain Executor's %s (the first bitwise); "
          "parameters within %.2f ulps of each one's largest magnitude "
          "(bound 4)" % (PS_B, PS_LR, finished, counts, remote, plain,
                         worst))


def ckpt_phase(fluid, seed, dev, lm):
    """Phase 6o: checkpoints and recovery on the card (NCCL world 1),
    (a)-(c) through guard_phase's transformer, (d) the host services.
    Returns the bf16 B1 launches of (a)-(c)."""
    import tempfile

    import torch.distributed as dist

    from paddle_tpu_torch.parallel.distribute import init_multihost

    t0 = time.perf_counter()
    d = tempfile.mkdtemp(prefix="ckpt_phase_")
    init_multihost("localhost:%d" % free_port(), 1, 0, device=dev)
    times = {}

    def timed(name, fn):
        t = time.perf_counter()
        out = fn()
        times[name] = time.perf_counter() - t
        return out

    def meanwhile():
        return (timed("b", lambda: ckpt_rollback(fluid, lm, dev, d))
                + timed("c", lambda: ckpt_elastic(fluid, lm, dev, d)))

    try:
        # (b) and (c) run while (a)'s writers compress its generations
        b1, b1_bc = ckpt_round_trip(fluid, lm, dev, d, meanwhile)
        b1 += b1_bc
        times["a"] = time.perf_counter() - t0 - times["b"] - times["c"]
    finally:
        dist.destroy_process_group()
        shutil.rmtree(d, ignore_errors=True)
        torch.cuda.empty_cache()
    timed("d", lambda: ckpt_services(fluid, seed, dev))
    print("phase 6o: %.1f s ((a) %.1f s beside (b) %.1f s and (c) %.1f s, "
          "(d) %.1f s)" % (time.perf_counter() - t0, times["a"],
                           times["b"], times["c"], times["d"]))
    return b1


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
    check_bn_loaders(kbn, g, dev)
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

    # ---- 4c. the serving tier: one-shot over RPC, ragged, generate, CLI --
    phase("serving at full width: S1 LeNet over RPC (%d clients x %d), S2 "
          "the stacked LSTM's ragged requests, S3 generate over RPC, S4 "
          "python -m paddle_tpu_torch serve (seed %d)" % (
              SERVE_CLIENTS, SERVE_PER_CLIENT, args.seed))
    t0 = time.perf_counter()
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_serving")
    shutil.rmtree(work, ignore_errors=True)
    s1, lenet_dir, s1_engine, s1_eager = serving_oneshot(
        fluid, args.seed, dev, work)
    s2_launches = serving_ragged(fluid, args.seed, dev, work)
    s3 = serving_generate(engine, workload, outs)
    serving_cli(lenet_dir, s1_engine)
    del s1_engine, s1_eager
    shutil.rmtree(work, ignore_errors=True)
    print("serving: %s; S2 B3 launches %d (card: %s)" % (
        json.dumps(dict(s1, **s3)), s2_launches["lstm_fwd"], card_line()))
    print("serving phase: %.1f s" % (time.perf_counter() - t0))

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

    # ---- 6d. path A: the SRL tagger at full width ----
    phase("semantic-role tagger (bi-LSTM + CRF) at full width: words %d, "
          "predicates %d, labels %d, embedding %d, LSTM size %d, batch %d "
          "(seed %d)" % (44068, 3162, 59, SRL["emb_dim"],
                         4 * SRL["hid_dim"], SRL_B, args.seed))
    srl_launches = srl_phase(fluid, args.seed, dev)
    launches["lstm_fwd"] += srl_launches["lstm_fwd"]
    launches["lstm_bwd"] += srl_launches["lstm_bwd"]

    # ---- 6e. path B: control flow ----
    phase("control flow: While (max_iters), Switch, DynamicRNN with "
          "Variable operators, eager against graph replays (seed %d)"
          % args.seed)
    control_flow_phase(fluid, args.seed, dev)

    # ---- 6f. the dense op library ----
    phase("dense op library: %d types on the card against the CPU, the "
          "random ops through graphs, fit_a_line and the recommender "
          "(users %d, movies %d, titles %d, batch %d), "
          "nets.scaled_dot_product_attention against B1 at batch %d, seq "
          "%d, d_model %d (seed %d)" % (
              60, REC["users"], REC["movies"], REC["title_vocab"], REC_B,
              SDPA["b"], SDPA["t"], SDPA["d"], args.seed))
    launches["flash_attention"] += dense_phase(fluid, args.seed, dev)

    # ---- 6g. the vision and detection families, word2vec, SSD300 ----
    phase("vision and detection: %d types on the card against the CPU, "
          "the repairs, word2vec (dictionary %d, batch %d), SSD300 (%d "
          "priors, batch %d) in config B (seed %d)" % (
              VISION_TYPES, BOOK_W2V["dict_size"], BOOK_W2V_B, SSD_PRIORS,
              SSD_B, args.seed))
    ssd_b8 = vision_phase(fluid, args.seed, dev)

    # ---- 6h. the sequence and CTC families, CRNN-CTC ----
    phase("sequence and CTC: %d types on the card against the CPU, B5/B6 "
          "at [%d,%d,%d], the CRNN-CTC recognizer (48x%d, conv channels %s, "
          "GRUs of %d, %d classes + blank, batch %d) with the relu and the "
          "tanh candidate (seed %d)" % (
              SEQ_TYPES, CRNN_B, CRNN["width"] // 8, CRNN["hidden"],
              CRNN["width"], CRNN["channels"], CRNN["hidden"],
              CRNN["classes"], CRNN_B, args.seed))
    ocr_err, ocr_launches = ocr_phase(fluid, args.seed, dev)
    for n, e in ocr_err.items():
        max_err[n] = max(max_err[n], e)
    for n, c in ocr_launches.items():
        launches[n] += c

    # ---- 6i. the losses, the optimizers and the metrics ----
    phase("losses, optimizers and metrics: %d types on the card against the "
          "CPU, the stacked LSTM at full width under %s with layers.auc, "
          "evaluator.Accuracy and ModelAverage, word2vec (dictionary %d) "
          "with the %s heads (seed %d)" % (
              OPTIM_TYPES, ", ".join(o[0] for o in OPTIMIZERS),
              BOOK_W2V["dict_size"], " and ".join(W2V_HEADS), args.seed))
    for n, c in optim_phase(fluid, args.seed, dev).items():
        launches[n] += c

    # ---- 6j. the v2 frontend, its readers and the imdb loader ----
    phase("v2 frontend: the stacked-LSTM sentiment net (emb %d, hid %d, %d "
          "layers, imdb's %d words) trained, tested, checkpointed and "
          "inferred through paddle.v2, the GRU classifier (H %d), "
          "device_chunks and double_buffer (seed %d)" % (
              EMB, HID, STACKED, 5149, HID, args.seed))
    for n, c in v2_phase(fluid, args.seed, dev).items():
        launches[n] += c

    # ---- 7. the convnet training slice at full width ----
    phase("ResNet-50 training at full width, configs A and B (seed %d)"
          % args.seed)
    resnet_launches, bn_shapes, c1_shapes = resnet_phase(fluid, args.seed,
                                                         dev)
    launches.update(resnet_launches)
    launches["conv1x1_bwd"] += ssd_b8

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
    lm = guard_phase(fluid, args.seed, dev)["lm"]

    # ---- 9e. the executor and program tooling (phase 6k) ----
    phase("executor and program tooling at full width: the NaN/Inf guard "
          "on the transformer (eager and in graphs), calc_gradient "
          "through the stacked LSTM, seq2seq fed through LoDTensor, "
          "InferenceTranspiler on ResNet-50, cost_analysis (seed %d)"
          % args.seed)
    tooling_phase(fluid, args.seed, dev)

    # ---- 9f. data parallelism (phase 6l) ----
    phase("data parallelism at NCCL world 1: ResNet-50 config D through "
          "ParallelExecutor in every mode (global view at ZeRO 0 and 1, "
          "bucketed, int8, ZeRO-1), the stacked LSTM's collectives "
          "captured in a CUDA graph (seed %d)" % args.seed)
    for n, c in parallel_phase(fluid, args.seed, dev).items():
        launches[n] += c

    # ---- 9g. tensor and sequence parallelism (phase 6m) ----
    phase("tensor and sequence parallelism at NCCL world 1: the "
          "transformer as bench.py trains it with mp=True under CommConfig "
          "(eager and graph replays) and with seq_axis='sp' in the global "
          "view, the ring's blocks at %d chunks of %s, the placement search "
          "(seed %d)" % (RING_N, list(RING_SHAPE), args.seed))
    for n, c in tp_phase(fluid, args.seed, dev).items():
        launches[n] += c

    # ---- 9h. pipeline and expert parallelism (phase 6n) ----
    phase("pipeline and expert parallelism: the GPipe and 1F1B schedules "
          "of %d stages in one process on the transformer as bench.py "
          "trains it, the ('pp',) executor path at NCCL world 1 (eager and "
          "graph replays), the %d-stage program under Executor, layers.moe "
          "top-1 and top-2 at the transformer's width under an ('ep',) "
          "mesh of 1 and card vs CPU (seed %d)" % (PP_S, PP_S, args.seed))
    for n, c in pp_phase(fluid, args.seed, dev).items():
        launches[n] += c

    # ---- 9i. checkpoints and recovery (phase 6o) ----
    phase("checkpoints and recovery: the guarded transformer (bf16 AMP, "
          "dynamic loss scale) through CheckpointManager and "
          "ShardedCheckpointManager, the guard's rollback under "
          "RecoveryLoop, ParallelExecutor ('dp',) of 1 with "
          "CommConfig(zero_stage=1) under ElasticRecoveryLoop (NCCL world "
          "1), RemoteTrainer fed by the task master (seed %d)" % args.seed)
    launches["flash_attention_bf16"] += ckpt_phase(fluid, args.seed, dev,
                                                   lm)
    del lm

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
            plain_ms=plain_time_ms(lambda: fa.flash_decode_reference(
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
            plain_ms=plain_time_ms(lambda: fa.flash_decode_reference(
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
            plain_ms=plain_time_ms(lambda: fa.flash_attention_reference(
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
        plain_ms=plain_time_ms(lambda: fa.flash_attention_reference(
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
        plain_ms=plain_time_ms(lambda: lc.lstm_forward_reference(
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
        plain_ms=plain_time_ms(lambda: lc.lstm_backward_reference(
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
        plain_ms=plain_time_ms(lambda: gc.gru_forward_reference(
            xg, w, h0, mask)),
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
        plain_ms=plain_time_ms(lambda: gc.gru_backward_reference(
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
        plain_ms=plain_time_ms(lambda: lc.lstm_forward_reference(
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
        plain_ms=plain_time_ms(lambda: lc.lstm_backward_reference(
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
        plain_ms=plain_time_ms(lambda: gc.gru_forward_reference(
            xg, w, h0, mask)),
        library_ms=time_ms(cudnn_gru_bf16_fwd),
        library="torch.nn.GRU (cuDNN) forward in %s, input size 512: r "
                "after the product, and the input GEMM too" % gdt,
        bytes=2 * (2 * B * T * 3 * H + H * 3 * H + B * T * H)
        + 4 * (B * H + B * T),
        flops=2 * B * T * H * 3 * H, peak=BF16_FLOPS_PER_S))
    rows.append(dict(
        name="gru_bwd_bf16", shape="[64,30,512], all steps valid",
        ms=gru_t["gru_bwd_bf16", T],
        plain_ms=plain_time_ms(lambda: gc.gru_backward_reference(
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
    # B7 at every distinct shape of the ResNet-50 path: the kernel with
    # the L2 flushed before each call (x + dy fit it at the smaller
    # shapes, where a warm loop would read them from the L2), its warm
    # time beside, its plan's floor, and the one PyTorch call that
    # computes the same function from the saved statistics
    # (native_batch_norm_backward, channels last); F.batch_norm forward
    # plus autograd (which also runs a forward) as a second column, and
    # the plain version, at the stem and the smallest shape
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def bn_row(name, shape, dtype, per_step, full, step):
        n, h, w, c = shape
        m = n * h * w
        x = (torch.randn(*shape, generator=g) * 1.5 + 0.7).to(dtype).to(dev)
        dy = torch.randn(*shape, generator=g).to(dtype).to(dev)
        sc = (torch.rand(c, generator=g) + 0.5).to(dev)
        xf = x.float().reshape(m, c)
        mean = xf.mean(0)
        invstd = torch.rsqrt(xf.var(0, unbiased=False) + 1e-5)
        del xf
        xr = x.permute(0, 3, 1, 2)
        dyr = dy.permute(0, 3, 1, 2)
        xg = xr.detach().requires_grad_()

        def fwd_grad():
            y = F.batch_norm(xg, None, None, sc, None, True, 0.1, 1e-5)
            torch.autograd.grad(y, xg, dyr)

        pl = kbn.plan(m, c, dtype, True, sms)
        elt = x.element_size()
        row = dict(
            name=name, shape="%s x%d a %s step" % (list(shape), per_step,
                                                   step),
            ms=time_ms(lambda: kbn.bn_grad(x, dy, sc, 1e-5), reps=10,
                       flush=flush),
            warm_ms=time_ms(lambda: kbn.bn_grad(x, dy, sc, 1e-5), reps=10),
            plain_ms=float("nan"),
            library_ms=time_ms(
                lambda: torch.ops.aten.native_batch_norm_backward(
                    dyr, xr, sc, None, None, mean, invstd, True, 1e-5,
                    [True, True, True]), reps=10, flush=flush),
            library="torch.ops.aten.native_batch_norm_backward, channels "
                    "last, from the saved mean and inverse std: dx, "
                    "dscale, dbias (L2 flushed)",
            fwd_grad_ms=time_ms(fwd_grad, reps=10, flush=flush),
            floor_ms=pl.hbm_bytes / HBM_BYTES_PER_S * 1e3,
            bytes=3 * elt * x.numel() + 4 * 3 * c, flops=12 * x.numel(),
            per_step=per_step)
        if full:
            row["plain_ms"] = plain_time_ms(
                lambda: kbn.bn_grad_reference(x, dy, sc, 1e-5))
        row["extra"] = (
            "; L2 flushed (warm %.6f ms); plan floor %.6f ms (%s W %d G %d "
            "R %d BR %d S %d, %d bytes); F.batch_norm forward + autograd "
            "%.6f ms" % (row["warm_ms"], row["floor_ms"], pl.loader,
                         pl.width, pl.groups, pl.slabs, pl.tile_rows,
                         pl.slots, pl.hbm_bytes, row["fwd_grad_ms"]))
        return row

    def bn_case(shape, full):
        return bn_row("bn_grad", shape, torch.float32, bn_shapes[shape],
                      full, "config-A")

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
            plain_ms=plain_time_ms(lambda: k1.conv1x1_bwd_reference(x, wt, dy),
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
        return bn_row("bn_grad_bf16", shape, bf16, bn_bf16_shapes[shape],
                      True, "config-C")

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
            plain_ms=plain_time_ms(lambda: k1.conv1x1_bwd_reference(x, wt, dy),
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
                  "; library: " + r["library"] if "library" in r else "")
              + r.get("extra", ""))

    for name, krows in (("bn_grad", bn_rows), ("conv1x1_bwd", c1_rows),
                        ("bn_grad_bf16", bn_bf16_rows),
                        ("conv1x1_bwd_bf16", c1_bf16_rows)):
        print("%s over one ResNet-50 step: %d launches, kernel %.3f ms, "
              "bound %.3f ms%s%s" % (
                  name, sum(r["per_step"] for r in krows),
                  sum(r["per_step"] * r["ms"] for r in krows),
                  sum(r["per_step"] * r["bound_ms"] for r in krows),
                  "; library %.3f ms" % sum(
                      r["per_step"] * r["library_ms"] for r in krows),
                  "; plain version %.3f ms" % sum(
                      r["per_step"] * r["plain_ms"] for r in krows)
                  if name != "bn_grad" else
                  "; warm %.3f ms, plan floor %.3f ms, F.batch_norm forward "
                  "+ autograd %.3f ms" % tuple(
                      sum(r["per_step"] * r[k] for r in krows)
                      for k in ("warm_ms", "floor_ms", "fwd_grad_ms"))))
        if name == "bn_grad_bf16":
            print("bn_grad_bf16 over one ResNet-50 step: warm %.3f ms, plan "
                  "floor %.3f ms, F.batch_norm forward + autograd %.3f ms"
                  % tuple(sum(r["per_step"] * r[k] for r in krows)
                          for k in ("warm_ms", "floor_ms", "fwd_grad_ms")))

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
    from paddle_tpu_torch import analysis
    vs = analysis.stats()
    print("IR verifier (FLAGS_verify_ir, on): %d verifications (plan "
          "misses, new feed signatures, pipeline stages), %d failed (the "
          "expected ones none), %.3f host s in all" % (
              vs["runs"], vs["failures"], vs["seconds"]))
    print("chip_smoke: %.1f s in all" % (time.perf_counter() - started))
    print("card:", card_line())
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
