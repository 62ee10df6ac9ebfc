"""Where a step of the LSTM kernels (B3, B4) or of the GRU kernels (B5,
B6), or a call of the decode kernel (B2), goes, on one NVIDIA GPU.

    python3 lstm_breakdown.py            # B3 and B4 at [64, T, 512]
    python3 lstm_breakdown.py --lstm-bf16  # bf16 B3, B4 (cluster kernels)
    python3 lstm_breakdown.py --gru-bf16   # bf16 B5, B6 (cluster kernels)
    python3 lstm_breakdown.py --gru      # B5 at [64, T, 512]
    python3 lstm_breakdown.py --gru-bwd  # B6 at [64, T, 512]
    python3 lstm_breakdown.py --decode   # B2 at [16, 8, 512, 64]
    python3 lstm_breakdown.py --flash-bf16   # bf16 B1 at [16, 8, 512, 64]
    python3 lstm_breakdown.py --conv1x1-bf16 # bf16 B8 at config D's shapes
    python3 lstm_breakdown.py --bn-grad      # B7 at ResNet-50 shapes

Builds variants of a kernel's source under ``paddle_tpu_torch/csrc/``
(and of the headers it shares) with one part changed or switched off,
all ``nvcc`` started together, and times each call as the median of
CUDA events bracketing it behind a spin kernel, as ``chip_smoke.py``
does. A variant's results are wrong by design where it switches a part
off; only its time is read.

The recurrent kernels (``lstm_cell.cu``, ``gru_cell.cu`` and their
``rnn_step.cuh``) are timed at [64, T, 512], every step valid, at a
short and a long T (LSTM 8 and 80, GRU 3 and 30): the difference over
the difference of T is the cost of one step. Their variants:

* ``nowait``: every wait for the other blocks' exchange is skipped (for
  B5 also ``nowait_h``, only the wait for h_{t-1} before the u, r
  product, and ``nowait_rh``, only the wait for r h_{t-1} before the
  candidate's);
* ``nomma``: the tensor-core products are skipped;
* ``nocell``: the cell updates are skipped (with ``nowait`` and
  ``nomma``);
* ``nofence``: the release fence before a block's counter is skipped;
* ``nopartner`` (B6): no sums cross to the partner block of a cluster:
  no store to its shared memory, no mbarrier arrival or wait.

B6 is timed on a stash that the kernels' own forward wrote; the
variants change the backward's library only.

The bfloat16 B3 and B4 that run one thread-block cluster per row group
(``lstm_cluster.cu``, ``--lstm-bf16``) are timed the same way, at T 8
and 80 (B4 on the stash of the kernels' own forward), at the 16 rows a
cluster they are built for (32 and 64 would not fit the shared memory
at H 512: the bytes they would need are printed).
Their variants: ``nowait`` (each step's waits for the exchange move
after the product, off the chain), ``nomma`` (no wgmma product),
``nocell`` (B3: the cell's arithmetic without its exponentials; B4: no
gate gradients), ``noexchange`` (no all-gather in B3, no reduce-scatter
in B4: each block waits for its own arrival only), and
``nomma+nocell``: the exchange and its waits alone, the floor of the
chain that this design leaves. Last, lstm_cell.cu's bf16 kernels at the
same inputs, as the wrappers take them where the plan refuses a shape.

The bfloat16 B5 and B6 as one cluster per row group (``gru_cluster.cu``,
``--gru-bf16``) are timed at [64, T, 512] for T 8 and 30 (B6 on the
stash of the kernels' own forward), with the same variants: ``nowait``
(each wait for an exchange moves past the work that reads it, before
the next send), ``nomma``, ``nocell`` (B5: the cell without its
exponentials; B6: no gate gradients), ``nogather`` (B6 reads only the
first block's piece of each reduce-scatter), ``chain32`` (B5's
warpgroups each run their 16 k16 steps of both products twice: the
32-deep chain of a product whose K is not split), ``lateu`` (B6 issues
the carry's da_u half beside its da_r half, after drh has come, instead
of beside drh's product), ``noexchange1`` and
``noexchange2`` (no bytes of the step's first exchange, B5's h_{t-1}
and B6's drh, or of its second, B5's r h_{t-1} and B6's carry: each
block waits for its own thread 0's arrival only), ``noexchange`` (neither),
``nomma+nocell`` (the two exchanges and their waits alone: the chain
floor) and all of those; then gru_cell.cu's bf16 kernels at the same
inputs.

The difference of a variant's step from the kernels' own is what that
part costs on the step's chain.

The decode kernel (``flash_attention.cu``) is timed at the serving
path's [16, 8, 512, 64] with every row's length 0, 160 and 512, three
ways: the 50 MB L2 flushed by writing a 256 MB buffer before each call
(it then holds dirty lines that the kernel's reads must first write
back: how ``chip_smoke.py``'s kernel table times B2), flushed by reading
it (clean lines), and warm (the cache already in L2). Its variants:

* ``stages4``: 4 ring stages a warp instead of 2;
* ``n1``, ``n4``: 1 (no split) or 4 blocks a row instead of the plan's;
* ``noload``: no key is copied (the walk reads what shared memory
  holds);
* ``nomerge``: no cluster barrier and no merge: each warp writes its
  own partial to the output;
* ``empty``: every block returns at once (launch and scheduling only).

Also the events alone (no kernel between them) and
``F.scaled_dot_product_attention`` over the valid prefix.

The bfloat16 flash-attention forward on wgmma (``--flash-bf16``) is
timed at the transformer's [16, 8, 512, 64], causal and not, beside
SDPA in bfloat16. Its variants: ``noqk`` (no S = Q K^T product),
``nosoftmax`` (P = S / 1000: no exponentials, no rescaling), ``nopv``
(no O += P V product), ``nostore`` (O is not stored). The bfloat16 fused
1x1 backward (``--conv1x1-bf16``) is timed at one config-D shape for each
of its loaders (TMA at 56x56 and 28x28, 8-byte cp.async at 14x14, bulk
copies at 7x7) beside cuDNN's bfloat16 ``convolution_backward``; its
variants: ``nomma`` (no wgmma product), ``norelayout`` (the bulk copies
are not swizzled into the tiles).

The batch-norm backward (``--bn-grad``, B7, ``bn_grad.cu``) is timed at
ResNet-50 shapes in both dtypes, warm and with the L2 flushed by a write
and by a read, beside ``native_batch_norm_backward``. Its variants:
``contiguous`` (each block takes one run of neighbouring tiles instead
of every R-th tile), ``nohint`` (no tile is marked to leave the L2
first), ``empty`` (every block arrives at the barrier's counter, waits
and returns: the cooperative launch and the barrier alone), ``nowait``
(no block waits at the grid barrier), ``nophase2`` (no dx: the sums,
the barrier and the coefficients), ``nofinal`` (no block adds the
partial rows after the barrier), ``nopartial`` (no block adds its row
lanes or writes its partial row).

Needs a card and ``nvcc``; builds into ``build/lstm_breakdown/``.
"""

import argparse
import ctypes
import os
import shutil
import subprocess
import sys

import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from paddle_tpu_torch.kernels import _build  # noqa: E402
from paddle_tpu_torch.kernels import flash_attention as fa  # noqa: E402
from paddle_tpu_torch.kernels import gru_cell as gc  # noqa: E402
from paddle_tpu_torch.kernels import lstm_cell as lc  # noqa: E402

FENCE = "  __threadfence();\n  atomicAdd(counter, 1u);"
GRU_WAIT = "rs::wait_count(&%s[rg * nch + c], producers(c) * (t + 1));"
ARRIVE = ('  asm volatile("barrier.cluster.arrive.relaxed.aligned;\\n" ::: '
          '"memory");\n')
WAIT = '  asm volatile("barrier.cluster.wait.aligned;\\n" ::: "memory");\n'
PARTNER = ("    rs::st_remote(xpart + (n & 1) * rs::kThreads + tid, 1 - hf, "
           "other);\n"
           "    __syncthreads();   // partials read, the partner's sums "
           "stored\n"
           "    if (tid == 0) rs::mbar_arrive_remote(xbar, 1 - hf);\n"
           "    rs::mbar_wait_cluster(xbar, n & 1);\n")
EDITS = {
    "nowait": [("if (v >= target) return;", "return;")],
    "nowait_h": [(GRU_WAIT % "hflag", "(void)c;")],
    "nowait_rh": [(GRU_WAIT % "rflag", "(void)c;")],
    "nomma": [("    if (steps)\n      stage_mma<NT>(slot,",
               "    if (0)\n      stage_mma<NT>(slot,")],
    "nocell": [("      if (live) {\n        float gsum[4];",
                "      if (0) {\n        float gsum[4];")],
    "nocell_gru": [("      if (live) {\n        const int row = r * rs::",
                    "      if (0) {\n        const int row = r * rs::"),
                   ("      if (live) {\n        c = tanhf(",
                    "      if (0) {\n        c = tanhf(")],
    "nofence": [(FENCE, "  atomicAdd(counter, 1u);")],
    "nopartner": [(PARTNER, "    __syncthreads();   // partials read\n")],
    "stages4": [("constexpr int kDecStages = 2;",
                 "constexpr int kDecStages = 4;")],
    "n1": [("int n = 1;\n  while (n < kDecMaxCluster",
            "int n = 1;\n  while (false && n < kDecMaxCluster")],
    "n4": [("2LL * B * H * n < 3LL * sms", "1LL * B * H * n < 3LL * sms")],
    "noload": [("    if (it + kDecStages - 1 < my_tiles) "
                "load(it + kDecStages - 1);\n", ""),
               ("    if (i < my_tiles) load(i);\n", "")],
    "nomerge": [(ARRIVE, ""), (WAIT, ""),
                ("  float* slot = cluster.map_shared_rank(\n"
                 "      slots + (rank * kDecWarps + warp) * SM::SLOT, 0);",
                 "  if (g == 0) out[(size_t)bh * D + 4 * t] = acc[0][0] + l;"
                 "\n  return;\n  float* slot = slots;")],
    "empty": [(ARRIVE, "  if (S >= 0) return;\n" + ARRIVE)],
    "noqk": [("        hopper::wgmma_ss_n64<0, 0>(\n            s, desc(q_addr",
              "        if (kk < 0) hopper::wgmma_ss_n64<0, 0>(\n"
              "            s, desc(q_addr")],
    "nosoftmax": [("          s[i] = ex2(fmaf(s[i], kLog2e, -ml[(i >> 1) & 1]));",
                   "          s[i] = s[i] * 0.001f;"),
                  ("        alpha[h] = ex2((m[h] - m_new) * kLog2e);",
                   "        alpha[h] = 1.f;")],
    "nopv": [("            hopper::wgmma_rs_n64<1>(acc[n], pa[c], dv, 1);",
              "            { if (c < 0) hopper::wgmma_rs_n64<1>(acc[n], pa[c],"
              " dv, 1); }"),
             ("            hopper::wgmma_rs_n32<1>(acc[n], pa[c], dv, 1);",
              "            { if (c < 0) hopper::wgmma_rs_n32<1>(acc[n], pa[c],"
              " dv, 1); }")],
    "nostore": [("  if (wi == 0 && lane == 0) {\n#pragma unroll\n"
                 "    for (int sub = 0;",
                 "  if (wi < 0) {\n#pragma unroll\n    for (int sub = 0;")],
    "nomma": [("        hopper::wgmma_ss_n64<TA, TB>(acc[n], da, db, 1);",
               "        { if (kk < 0) hopper::wgmma_ss_n64<TA, TB>(acc[n], da,"
               " db, 1); }"),
              ("        hopper::wgmma_ss_n32<TA, TB>(acc[n], da, db, 1);",
               "        { if (kk < 0) hopper::wgmma_ss_n32<TA, TB>(acc[n], da,"
               " db, 1); }")],
    "norelayout": [("      relayout_rows(swzbuf, lin, min(CO_T, Co - m0), HW,"
                    " tid);\n      relayout_rows(swzbuf + A_SUBS * kSubBytes,"
                    " lin + CO_T * HW,\n                    min(CI_T, Ci - n0),"
                    " HW, tid);", ""),
                   ("        for (int i = 0; i < imgs; ++i)\n          relayout("
                    "swzbuf, lin + i * kBK * HW, rows, HW, i * HW, warp, lane);",
                    "")],
}
CLUSTER_WAIT_FWD = ("    rc::wait(&full[par], (t >> 1) & 1);\n    __syncwarp();\n"
                    "    float acc[NR];")
CLUSTER_PRODUCT_DONE = "    hopper::wgmma_wait<0>();\n    fence_regs(acc);\n"
CLUSTER_WAIT_BWD = "      rc::wait(&rbar[(s - 1) & 1], ((s - 1) >> 1) & 1);\n"
CLUSTER_A_DONE = ("    hopper::fence_proxy_async();\n"
                  "    __syncthreads();   // dgates_t is in its tile")
CLUSTER_CELL = ("      act[0] = rc::sigm_fast(gi);\n"
                "      act[1] = rc::tanh_fast(gsum[1]);\n"
                "      act[2] = rc::sigm_fast(gf);\n"
                "      float c_t = act[2] * c_prev + act[0] * act[1];\n"
                "      act[3] = rc::sigm_fast(gsum[3] + c_t * p2);\n"
                "      float h_t = act[3] * rc::tanh_fast(c_t);\n")
EDITS.update({
    "c_nowait": [(CLUSTER_WAIT_FWD, "    __syncwarp();\n    float acc[NR];"),
                 (CLUSTER_PRODUCT_DONE, CLUSTER_PRODUCT_DONE
                  + "    rc::wait(&full[par], (t >> 1) & 1);\n"),
                 (CLUSTER_WAIT_BWD, ""),
                 (CLUSTER_A_DONE, "    if (s) " + CLUSTER_WAIT_BWD.strip()
                  + "\n" + CLUSTER_A_DONE)],
    "c_nomma": [("for (int kk = 0; kk < KS; ++kk)",
                 "for (int kk = 0; kk < 0; ++kk)"),
                ("for (int kk = 0; kk < 8; ++kk) {",
                 "for (int kk = 0; kk < 0; ++kk) {")],
    "c_nocell": [(CLUSTER_CELL,
                  "      act[0] = gi;\n      act[1] = gsum[1];\n"
                  "      act[2] = gf;\n      float c_t = c_prev;\n"
                  "      act[3] = gsum[3];\n      float h_t = h_prev;\n"),
                 ("      for (int e = 0; e < 2; ++e) {\n"
                  "        const int n = rows[e], x0",
                  "      for (int e = 0; e < 0; ++e) {\n"
                  "        const int n = rows[e], x0")],
    "c_noexchange": [("const unsigned xbytes = (nb - 1) * kSlice;",
                      "const unsigned xbytes = 0;"),
                     ("const unsigned xbytes = (unsigned)((nb - 1) * kPiece);",
                      "const unsigned xbytes = 0;"),
                     ("rc::all_gather(", "if (0) rc::all_gather("),
                     ("rc::scatter_tile<kRows>(",
                      "if (0) rc::scatter_tile<kRows>(")],
})
CLUSTER_VARIANTS = {"kernels": [], "nowait": ["c_nowait"],
                    "nomma": ["c_nomma"], "nocell": ["c_nocell"],
                    "noexchange": ["c_noexchange"],
                    "nomma+nocell": ["c_nomma", "c_nocell"],
                    "nomma+nocell+noexchange": ["c_nomma", "c_nocell",
                                                "c_noexchange"]}
G_WAIT_H = "    rc::wait(hbar, ph);\n"
G_WAIT_R = "    rc::wait(rbar, ph);\n"
G_WAIT_C = ("      rc::wait(cbar, (s - 1) & 1);\n"
            "      if (tid == 0) rc::expect(cbar, xbytes);\n")
G_WAIT_D = ("    rc::wait(dbar, s & 1);\n"
            "    if (tid == 0 && s + 1 < T_) rc::expect(dbar, xbytes);\n")
G_A_DONE = "    __syncthreads();   // da_c and da_u are in their tiles\n"
G_R_DONE = ("    hopper::fence_proxy_async();\n"
            "    __syncthreads();   // da_r is in its tile")
G_P2R = ("    hopper::wgmma_fence();\n#pragma unroll\n    for (int half = 0; "
         "half < 2; ++half) {\n#pragma unroll\n      for (int kk = 0; kk < 2; "
         "++kk) {\n        const uint64_t db = desc(dra")
G_P2U = ("    hopper::wgmma_fence();\n#pragma unroll\n"
         "    for (int kk = 0; kk < 2; ++kk)\n#pragma unroll\n"
         "      for (int i = 0; i < kTilesWg; ++i)\n"
         "        hopper::wgmma_rs_n16<0>(acc2[i], wur_f[i][kk],\n"
         "                                desc(dua + kk * 32, 512, 2), 1);\n")
G_CELLS = ("for (int e = 0; e < 2; ++e) {\n      const int n = rows[e]",
           "for (int e = 0; e < 2; ++e) {\n        const int n = rows[e]")
EDITS.update({
    "g_nowait": [(G_WAIT_H + "    float acc[8];", "    float acc[8];"),
                 ("    hopper::wgmma_wait<0>();\n    fence_regs(acc);\n",
                  "    hopper::wgmma_wait<0>();\n    fence_regs(acc);\n"
                  + G_WAIT_H),
                 (G_WAIT_R + "    float acc2[8];", "    float acc2[8];"),
                 ("    hopper::wgmma_wait<0>();\n    fence_regs(acc2);\n",
                  "    hopper::wgmma_wait<0>();\n    fence_regs(acc2);\n"
                  + G_WAIT_R),
                 (G_WAIT_C, ""),
                 (G_A_DONE, G_A_DONE + "    if (s) {\n" + G_WAIT_C
                  + "    }\n"),
                 (G_WAIT_D, ""),
                 (G_R_DONE, G_WAIT_D + G_R_DONE)],
    "g_nomma": [("for (int kk = 0; kk < kKsWg; ++kk) {\n      const int ks",
                 "for (int kk = 0; kk < 0; ++kk) {\n      const int ks"),
                ("for (int kk = 0; kk < 2; ++kk) {",
                 "for (int kk = 0; kk < 0; ++kk) {")],
    "g_nocell": [("rc::sigm_fast(", "("), ("rc::tanh_fast(", "(")]
    + [(c, c.replace("e < 2", "e < 0")) for c in G_CELLS],
    "g_chain32": [("for (int kk = 0; kk < kKsWg; ++kk) {\n      const int ks = "
                   "kKsWg * wg + kk;",
                   "for (int kk = 0; kk < 2 * kKsWg; ++kk) {\n      const int "
                   "ks = kKsWg * wg + kk % kKsWg;"),
                  ("acc, wur_f[kk], desc(", "acc, wur_f[kk % kKsWg], desc("),
                  ("{wc_f[kk][0], zero, wc_f[kk][1], zero}",
                   "{wc_f[kk % kKsWg][0], zero, wc_f[kk % kKsWg][1], zero}")],
    "g_lateu": [("      if (half == 0) {\n#pragma unroll\n        for (int kk",
                 "      if (half < 0) {\n#pragma unroll\n        for (int kk"),
                (G_P2R, G_P2U + G_P2R)],
    "g_nogather": [(", nb, ju, quad, hf)", ", 1, ju, quad, hf)")],
    "g_nox1": [("rc::expect(hbar, xbytes)", "rc::expect(hbar, 0)"),
               ("rc::all_gather(own_h,", "if (0) rc::all_gather(own_h,"),
               ("rc::expect(dbar, xbytes)", "rc::expect(dbar, 0)"),
               ("hopper::mbar_init(dbar, 1 + rc::kOwnArrivals);",
                "hopper::mbar_init(dbar, 1);"),
               ("rc::scatter_tile<kRows, true>(acc[i],",
                "if (0) rc::scatter_tile<kRows, true>(acc[i],")],
    "g_nox2": [("rc::expect(rbar, xbytes)", "rc::expect(rbar, 0)"),
               ("rc::all_gather(own_r,", "if (0) rc::all_gather(own_r,"),
               ("rc::expect(cbar, xbytes)", "rc::expect(cbar, 0)"),
               ("hopper::mbar_init(cbar, 1 + rc::kOwnArrivals);",
                "hopper::mbar_init(cbar, 1);"),
               ("rc::scatter_tile<kRows, true>(acc2[i],",
                "if (0) rc::scatter_tile<kRows, true>(acc2[i],")],
})
GRU_CLUSTER_VARIANTS = {
    "kernels": [], "nowait": ["g_nowait"], "nomma": ["g_nomma"],
    "nocell": ["g_nocell"], "nogather": ["g_nogather"],
    "chain32": ["g_chain32"], "lateu": ["g_lateu"],
    "noexchange1": ["g_nox1"],
    "noexchange2": ["g_nox2"], "noexchange": ["g_nox1", "g_nox2"],
    "nomma+nocell": ["g_nomma", "g_nocell"],
    "nomma+nocell+noexchange": ["g_nomma", "g_nocell", "g_nox1", "g_nox2"]}
LSTM_VARIANTS = {"kernels": [], "nowait": ["nowait"], "nomma": ["nomma"],
                 "nowait+nomma": ["nowait", "nomma"],
                 "nowait+nomma+nocell": ["nowait", "nomma", "nocell"],
                 "nofence": ["nofence"]}
GRU_VARIANTS = {"kernels": [], "nowait": ["nowait"],
                "nowait_h": ["nowait_h"], "nowait_rh": ["nowait_rh"],
                "nomma": ["nomma"], "nowait+nomma": ["nowait", "nomma"],
                "nowait+nomma+nocell": ["nowait", "nomma", "nocell_gru"],
                "nofence": ["nofence"]}
GRU_BWD_VARIANTS = {"kernel": [], "nomma": ["nomma"], "nowait": ["nowait"],
                    "nofence": ["nofence"], "nopartner": ["nopartner"],
                    "nowait+nomma+nopartner": ["nowait", "nomma",
                                               "nopartner"]}
DECODE_VARIANTS = {"kernel": [], **{name: [name] for name in (
    "stages4", "n1", "n4", "noload", "nomerge", "empty")}}
FLASH_BF16_VARIANTS = {"kernel": [], **{name: [name] for name in (
    "noqk", "nosoftmax", "nopv", "nostore")}}
C1_BF16_VARIANTS = {"kernel": [], "nomma": ["nomma"],
                    "norelayout": ["norelayout"]}
EDITS.update({
    "empty": [("  if (r >= a.R) {   // no rows: arrive,",
               "  if (true) {   // no rows: arrive,")],
    "nowait": [("  if (tid == 0) {\n    arrive();\n    wait_arrivals(target);",
                "  if (tid == 0) {\n    arrive();")],
    "nophase2": [("  for (int t = n - 1; t >= 0; --t) {",
                  "  for (int t = n - 1; t >= n; --t) {")],
    "contiguous": [(
        "  const int n = r < a.T ? (a.T - 1 - r) / a.R + 1 : 0;\n"
        "  auto tile = [&](int k) { return (long long)r + (long long)k * "
        "a.R; };",
        "  const long long t0 = (long long)r * a.T / a.R;\n"
        "  const int n = (int)((long long)(r + 1) * a.T / a.R - t0);\n"
        "  auto tile = [&](int k) { return t0 + k; };")],
    "nohint": [("      if (last) {", "      if (false) {")],
    "nofinal": [("  if (ni <= kThreads) {", "  if (ni < 0) {"),
                ("    for (int item = tid; item < ni; item += kThreads)",
                 "    for (int item = tid; item < 0; item += kThreads)")],
    "nopartial": [("  if (tpr <= 16 && (tpr & (tpr - 1)) == 0) {",
                   "  if (false) {"),
                  ("    for (int q = 0; q < 4; ++q) {\n      if (l < lanes)",
                   "    for (int q = 0; q < 0; ++q) {\n      if (l < lanes)")],
})
BN_VARIANTS = {"kernel": [], **{name: [name] for name in (
    "contiguous", "nohint", "empty", "nowait", "nophase2", "nofinal",
    "nopartial")}}
# (N, H, W, C, dtype): B7 at the stem, a shape just past the blocks'
# shared memory, two wholly resident ones, in bfloat16; one in float32
BN_SHAPES = ((64, 112, 112, 64, "bf16"), (64, 56, 56, 64, "bf16"),
             (64, 14, 14, 256, "bf16"), (64, 7, 7, 2048, "bf16"),
             (64, 7, 7, 512, "fp32"))
# (B, Ci, H, W, Co): one config-D shape for each loader of the bf16 B8
C1_BF16_SHAPES = ((64, 64, 56, 56, 256), (64, 128, 28, 28, 512),
                  (64, 256, 14, 14, 1024), (64, 512, 7, 7, 2048))
B, H = 64, 512
DECODE_SHAPE = (16, 8, 512, 64)


def build(out_dir, lib, variants):
    """One library of csrc/<lib>.cu a variant, each built in its own
    directory beside its edited copies of the shared headers; all nvcc
    started together."""
    names = [lib + ".cu"] + sorted(f for f in os.listdir(_build.CSRC)
                                   if f.endswith(".cuh"))
    procs = {}
    for i, (name, edits) in enumerate(variants.items()):
        vdir = os.path.join(out_dir, lib, str(i))
        shutil.rmtree(vdir, ignore_errors=True)
        os.makedirs(vdir)
        texts = {f: open(os.path.join(_build.CSRC, f)).read() for f in names}
        for e in edits:
            for old, new in EDITS[e]:
                hit = [f for f in names if old in texts[f]]
                if not hit:
                    raise SystemExit("lstm_breakdown: %r not in the sources"
                                     % old)
                for f in hit:
                    texts[f] = texts[f].replace(old, new)
        for f, text in texts.items():
            with open(os.path.join(vdir, f), "w") as fh:
                fh.write(text)
        so = os.path.join(vdir, lib + ".so")
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so,
             os.path.join(vdir, lib + ".cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            so)
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit("lstm_breakdown: %s did not build:\n%s"
                             % (name, log))
        dll = ctypes.CDLL(so)
        for fn, (argtypes, restype) in _build.SOURCES[lib].items():
            getattr(dll, fn).argtypes = argtypes
            getattr(dll, fn).restype = restype
        libs[name] = dll
    return libs


def time_ms(fn, reps=15, flush=None):
    """The median of ``reps`` calls of ``fn``, each behind a spin kernel
    (and after ``flush``, when one is given), in ms."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda._sleep(1_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def lstm(out_dir, dev, g):
    t_short, t_long = 8, 80
    libs = build(out_dir, "lstm_cell", LSTM_VARIANTS)
    inputs = {}
    for T in (t_short, t_long):
        xg = torch.randn(B, T, 4 * H, generator=g) * 0.5
        w = torch.randn(H, 4 * H, generator=g) * H ** -0.5
        h0, c0 = (torch.randn(B, H, generator=g) * 0.1 for _ in range(2))
        p = torch.randn(3, H, generator=g) * 0.1
        dhs, dcs = (torch.randn(B, T, H, generator=g) for _ in range(2))
        inputs[T] = [t.to(dev) for t in (xg, w, h0, c0, torch.ones(B, T), p,
                                         dhs, dcs)]
    for name, lib in libs.items():
        _build._libs["lstm_cell"] = lib
        ms = {}
        for T, (xg, w, h0, c0, mask, p, dhs, dcs) in inputs.items():
            _, cs, st = lc.lstm_forward(xg, w, h0, c0, mask, p)
            ms["fwd", T] = time_ms(
                lambda: lc.lstm_forward(xg, w, h0, c0, mask, p))
            ms["bwd", T] = time_ms(
                lambda: lc.lstm_backward(st, cs, w, p, c0, mask, dhs, dcs))
        print("%-20s " % name + " | ".join(
            "%s %.4f ms at T=%d, %.4f at T=%d: %.3f us a step" % (
                k, ms[k, t_long], t_long, ms[k, t_short], t_short,
                (ms[k, t_long] - ms[k, t_short]) * 1e3 / (t_long - t_short))
            for k in ("fwd", "bwd")), flush=True)


def lstm_bf16(out_dir, dev, g):
    t_short, t_long = 8, 80
    inputs = {}
    for T in (t_short, t_long):
        xg = torch.randn(B, T, 4 * H, generator=g) * 0.5
        w = torch.randn(H, 4 * H, generator=g) * H ** -0.5
        h0, c0 = (torch.randn(B, H, generator=g) * 0.1 for _ in range(2))
        p = torch.randn(3, H, generator=g) * 0.1
        dhs, dcs = (torch.randn(B, T, H, generator=g) for _ in range(2))
        xg, w, dhs, dcs = (t.bfloat16() for t in (xg, w, dhs, dcs))
        inputs[T] = [t.to(dev) for t in (xg, w, h0, c0, torch.ones(B, T), p,
                                         dhs, dcs)]
    print("plan at [%d, *, %d]: %s" % (B, H, lc.cluster_plan(B, H)))
    libs = build(out_dir, "lstm_cluster", CLUSTER_VARIANTS)
    # the stash each backward reads: the kernels' own forward's
    _build._libs["lstm_cluster"] = libs["kernels"]
    for T, (xg, w, h0, c0, mask, p, dhs, dcs) in inputs.items():
        _, cs, st = lc.lstm_forward(xg, w, h0, c0, mask, p)
        inputs[T] += [cs, st]
    nb = -(-H // lc.CLUSTER_UNITS)
    for rows in (32, 64):
        print("%d rows a cluster: refused, %s" % (rows, ", ".join(
            "%s %d bytes of shared memory a block" % (
                k, lc.cluster_smem("lstm_" + k, nb, rows))
            for k in ("fwd", "bwd"))) + " (%d allowed)" % lc.SMEM_LIMIT)
    for name, lib in libs.items():
        _build._libs["lstm_cluster"] = lib
        ms = {}
        for T, (xg, w, h0, c0, mask, p, dhs, dcs, cs, st) in inputs.items():
            ms["fwd", T] = time_ms(
                lambda: lc._fwd_cluster(xg, w, h0, c0, mask, p))
            ms["bwd", T] = time_ms(
                lambda: lc._bwd_cluster(st, cs, w, p, c0, mask, dhs, dcs))
        print("%-24s %s" % (name, " | ".join(
            "%s %.4f ms at T=%d, %.4f at T=%d: %.3f us a step" % (
                k, ms[k, t_long], t_long, ms[k, t_short], t_short,
                (ms[k, t_long] - ms[k, t_short]) * 1e3 / (t_long - t_short))
            for k in ("fwd", "bwd"))), flush=True)
    # lstm_cell.cu's bf16 kernels at the same inputs, as the wrappers take
    # them for a shape the plan refuses
    real = lc.cluster_plan
    lc.cluster_plan = lambda *a, **k: dict(real(*a, **k), take=False)
    try:
        ms = {}
        for T, (xg, w, h0, c0, mask, p, dhs, dcs, cs, st) in inputs.items():
            ms["fwd", T] = time_ms(
                lambda: lc.lstm_forward(xg, w, h0, c0, mask, p))
            ms["bwd", T] = time_ms(
                lambda: lc.lstm_backward(st, cs, w, p, c0, mask, dhs, dcs))
    finally:
        lc.cluster_plan = real
    print("%-24s          %s" % ("lstm_cell.cu bf16", " | ".join(
        "%s %.4f ms at T=%d, %.4f at T=%d: %.3f us a step" % (
            k, ms[k, t_long], t_long, ms[k, t_short], t_short,
            (ms[k, t_long] - ms[k, t_short]) * 1e3 / (t_long - t_short))
        for k in ("fwd", "bwd"))), flush=True)


def gru_bf16(out_dir, dev, g):
    t_short, t_long = 8, 30
    inputs = {}
    for T in (t_short, t_long):
        xg = torch.randn(B, T, 3 * H, generator=g) * 0.5
        w = torch.randn(H, 3 * H, generator=g) * H ** -0.5
        h0 = torch.randn(B, H, generator=g) * 0.1
        dhs = torch.randn(B, T, H, generator=g)
        xg, w, dhs = (t.bfloat16() for t in (xg, w, dhs))
        inputs[T] = [t.to(dev) for t in (xg, w, h0, torch.ones(B, T), dhs)]
    print("plan at [%d, *, %d]: %s" % (B, H, gc.cluster_plan(B, H)))
    libs = build(out_dir, "gru_cluster", GRU_CLUSTER_VARIANTS)
    # the stash each backward reads: the kernels' own forward's
    _build._libs["gru_cluster"] = libs["kernels"]
    for T, (xg, w, h0, mask, dhs) in inputs.items():
        inputs[T] += list(gc._fwd_cluster(xg, w, h0, mask))
    nb = -(-H // gc.CLUSTER_UNITS)
    print("32 rows a cluster: refused, %s" % ", ".join(
        "%s %d bytes of shared memory a block" % (
            k, gc.cluster_smem("gru_" + k, nb, 32)) for k in ("fwd", "bwd"))
        + " (%d allowed)" % gc.SMEM_LIMIT)

    def line(name, ms):
        print("%-24s %s" % (name, " | ".join(
            "%s %.4f ms at T=%d, %.4f at T=%d: %.3f us a step" % (
                k, ms[k, t_long], t_long, ms[k, t_short], t_short,
                (ms[k, t_long] - ms[k, t_short]) * 1e3 / (t_long - t_short))
            for k in ("fwd", "bwd"))), flush=True)

    for name, lib in libs.items():
        _build._libs["gru_cluster"] = lib
        ms = {}
        for T, (xg, w, h0, mask, dhs, hs, st) in inputs.items():
            ms["fwd", T] = time_ms(lambda: gc._fwd_cluster(xg, w, h0, mask))
            ms["bwd", T] = time_ms(
                lambda: gc._bwd_cluster(st, hs, w, h0, mask, dhs))
        line(name, ms)
    # gru_cell.cu's bf16 kernels at the same inputs, as the wrappers take
    # them for a shape the plan refuses
    real = gc.cluster_plan
    gc.cluster_plan = lambda *a, **k: dict(real(*a, **k), take=False)
    try:
        ms = {}
        for T, (xg, w, h0, mask, dhs, hs, st) in inputs.items():
            ms["fwd", T] = time_ms(lambda: gc.gru_forward(xg, w, h0, mask))
            ms["bwd", T] = time_ms(
                lambda: gc.gru_backward(st, hs, w, h0, mask, dhs))
    finally:
        gc.cluster_plan = real
    line("gru_cell.cu bf16", ms)


def gru(out_dir, dev, g):
    t_short, t_long = 3, 30
    libs = build(out_dir, "gru_cell", GRU_VARIANTS)
    inputs = {}
    for T in (t_short, t_long):
        xg = torch.randn(B, T, 3 * H, generator=g) * 0.5
        w = torch.randn(H, 3 * H, generator=g) * H ** -0.5
        h0 = torch.randn(B, H, generator=g) * 0.1
        inputs[T] = [t.to(dev) for t in (xg, w, h0, torch.ones(B, T))]
    for name, lib in libs.items():
        _build._libs["gru_cell"] = lib
        ms = {T: time_ms(lambda: gc.gru_forward(*args))
              for T, args in inputs.items()}
        print("%-20s fwd %.4f ms at T=%d, %.4f at T=%d: %.3f us a step" % (
            name, ms[t_long], t_long, ms[t_short], t_short,
            (ms[t_long] - ms[t_short]) * 1e3 / (t_long - t_short)),
            flush=True)


def gru_bwd(out_dir, dev, g):
    t_short, t_long = 3, 30
    inputs = {}
    for T in (t_short, t_long):
        xg = torch.randn(B, T, 3 * H, generator=g) * 0.5
        w = torch.randn(H, 3 * H, generator=g) * H ** -0.5
        h0 = torch.randn(B, H, generator=g) * 0.1
        dhs = torch.randn(B, T, H, generator=g)
        xg, w, h0, mask, dhs = (t.to(dev) for t in (xg, w, h0,
                                                     torch.ones(B, T), dhs))
        hs, stash = gc.gru_forward(xg, w, h0, mask)
        inputs[T] = (stash, hs, w, h0, mask, dhs)
    libs = build(out_dir, "gru_cell", GRU_BWD_VARIANTS)
    for name, lib in libs.items():
        _build._libs["gru_cell"] = lib
        ms = {T: time_ms(lambda: gc.gru_backward(*args))
              for T, args in inputs.items()}
        print("%-24s bwd %.4f ms at T=%d, %.4f at T=%d: %.3f us a step" % (
            name, ms[t_long], t_long, ms[t_short], t_short,
            (ms[t_long] - ms[t_short]) * 1e3 / (t_long - t_short)),
            flush=True)


def decode(out_dir, dev, g):
    libs = build(out_dir, "flash_attention", DECODE_VARIANTS)
    b, h, s, d = DECODE_SHAPE
    q = torch.randn(b, h, 1, d, generator=g).to(dev)
    kc, vc = (torch.randn(b, h, s, d, generator=g).to(dev) for _ in range(2))
    buf = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    total = torch.empty((), device=dev)
    flushes = {"dirty": buf.zero_,
               "clean": lambda: torch.sum(buf, dim=0, out=total),
               "warm": None}

    def us(fn):
        return "  ".join("%s %.2f us" % (k, 1e3 * time_ms(fn, 25, f))
                         for k, f in flushes.items())

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print("plan at %s on %d SMs: %s" % (list(DECODE_SHAPE), sms,
                                         fa.decode_plan(*DECODE_SHAPE, sms)))
    print("events alone: %s" % us(lambda: None))
    for L in (0, 160, 512):
        lens = torch.full((b,), L, dtype=torch.int32, device=dev)
        for name, lib in libs.items():
            _build._libs["flash_attention"] = lib
            print("L=%3d %-8s %s" % (L, name, us(
                lambda: fa.flash_decode(q, kc, vc, lens))), flush=True)
        if L:
            kp, vp = kc[:, :, :L], vc[:, :, :L]
            print("L=%3d sdpa     %s  (over the valid prefix, no mask)" % (
                L, us(lambda: F.scaled_dot_product_attention(q, kp, vp))),
                flush=True)


def flash_bf16(out_dir, dev, g):
    libs = build(out_dir, "flash_attention", FLASH_BF16_VARIANTS)
    q, k, v = (torch.randn(*DECODE_SHAPE, generator=g).bfloat16().to(dev)
               for _ in range(3))
    print("plan at %s: %s" % (list(DECODE_SHAPE), fa.fwd_plan(
        *DECODE_SHAPE[:3], DECODE_SHAPE[2], DECODE_SHAPE[3])))
    for causal in (True, False):
        for name, lib in libs.items():
            _build._libs["flash_attention"] = lib
            print("causal=%-5s %-10s %.2f us" % (causal, name, 1e3 * time_ms(
                lambda: fa.flash_attention(q, k, v, causal=causal), 25)),
                flush=True)
        print("causal=%-5s %-10s %.2f us" % (causal, "sdpa", 1e3 * time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v,
                                                   is_causal=causal), 25)),
            flush=True)


def conv1x1_bf16(out_dir, dev, g):
    from paddle_tpu_torch.kernels import conv1x1_bwd as k1

    libs = build(out_dir, "conv1x1_bwd", C1_BF16_VARIANTS)
    for b, ci, h, w, co in C1_BF16_SHAPES:
        x = torch.randn(b, ci, h, w, generator=g).bfloat16().to(dev)
        wt = (torch.randn(co, ci, 1, 1, generator=g) * ci ** -0.5) \
            .bfloat16().to(dev)
        dy = torch.randn(b, co, h, w, generator=g).bfloat16().to(dev)
        loader = k1.plan(b, ci, co, h * w, 2).loader
        for name, lib in libs.items():
            _build._libs["conv1x1_bwd"] = lib
            print("%s %-9s %-10s %.2f us" % (
                [b, ci, h, w, co], loader, name,
                1e3 * time_ms(lambda: k1.conv1x1_bwd(x, wt, dy), 10)),
                flush=True)
        print("%s %-9s %-10s %.2f us" % (
            [b, ci, h, w, co], loader, "cudnn", 1e3 * time_ms(
                lambda: torch.ops.aten.convolution_backward(
                    dy, x, wt, None, [1, 1], [0, 0], [1, 1], False, [0, 0],
                    1, [True, True, False]), 10)), flush=True)


def bn_grad(out_dir, dev, g):
    from paddle_tpu_torch.kernels import bn_grad as kbn

    libs = build(out_dir, "bn_grad", BN_VARIANTS)
    flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)

    flush_sum = torch.empty((), device=dev)

    def flush():
        flush_buf.zero_()

    def clean_flush():
        torch.sum(flush_buf, dim=0, out=flush_sum)

    for n, h, w, c, dt in BN_SHAPES:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        x = torch.randn(n, h, w, c, generator=g).to(dtype).to(dev)
        dy = torch.randn(n, h, w, c, generator=g).to(dtype).to(dev)
        sc = (torch.rand(c, generator=g) + 0.5).to(dev)
        m = n * h * w
        pl = kbn.plan(m, c, dtype, True, torch.cuda.get_device_properties(
            dev).multi_processor_count)
        print("%s %s: plan %s W %d G %d R %d BR %d S %d; one pass %.2f us, "
              "plan floor %.2f us" % (
                  [n, h, w, c], dt, pl.loader, pl.width, pl.groups,
                  pl.slabs, pl.tile_rows, pl.slots,
                  pl.one_pass_bytes / 3.35e6, pl.hbm_bytes / 3.35e6))
        for name, lib in libs.items():
            _build._libs["bn_grad"] = lib
            fn = lambda: kbn.bn_grad(x, dy, sc, 1e-5)  # noqa: E731
            print("%s %s %-10s warm %.2f us, flushed %.2f us, by a read "
                  "%.2f us" % (
                      [n, h, w, c], dt, name, 1e3 * time_ms(fn, 15),
                      1e3 * time_ms(fn, 15, flush),
                      1e3 * time_ms(fn, 15, clean_flush)), flush=True)
        xf = x.float().reshape(m, c)
        mean = xf.mean(0)
        inv = torch.rsqrt(xf.var(0, unbiased=False) + 1e-5)
        xr, dyr = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
        fn = lambda: torch.ops.aten.native_batch_norm_backward(  # noqa
            dyr, xr, sc, None, None, mean, inv, True, 1e-5,
            [True, True, True])
        print("%s %s %-10s warm %.2f us, flushed %.2f us, by a read %.2f "
              "us" % ([n, h, w, c], dt, "library", 1e3 * time_ms(fn, 15),
                      1e3 * time_ms(fn, 15, flush),
                      1e3 * time_ms(fn, 15, clean_flush)), flush=True)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    ts = []
    for _ in range(15):
        torch.cuda._sleep(1_000_000)
        a.record()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    print("the events alone: %.2f us" % (1e3 * sorted(ts)[len(ts) // 2]))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--lstm-bf16", action="store_true",
                      help="break down the bfloat16 B3 and B4 (the cluster "
                           "kernels) instead")
    mode.add_argument("--gru-bf16", action="store_true",
                      help="break down the bfloat16 B5 and B6 (the cluster "
                           "kernels) instead")
    mode.add_argument("--gru", action="store_true",
                      help="break down B5 (gru_fwd) instead of B3 and B4")
    mode.add_argument("--gru-bwd", action="store_true",
                      help="break down B6 (gru_bwd) instead")
    mode.add_argument("--decode", action="store_true",
                      help="break down B2 (flash_decode) instead")
    mode.add_argument("--flash-bf16", action="store_true",
                      help="break down the bfloat16 B1 (wgmma) instead")
    mode.add_argument("--conv1x1-bf16", action="store_true",
                      help="break down the bfloat16 B8 (wgmma) instead")
    mode.add_argument("--bn-grad", action="store_true",
                      help="break down B7 (bn_grad) instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("lstm_breakdown: no CUDA device")
    dev = torch.device("cuda", 0)
    out_dir = os.path.join(REPO, "build", "lstm_breakdown")
    os.makedirs(out_dir, exist_ok=True)
    g = torch.Generator().manual_seed(0)
    run = (decode if args.decode else gru if args.gru
           else gru_bwd if args.gru_bwd else flash_bf16 if args.flash_bf16
           else conv1x1_bf16 if args.conv1x1_bf16
           else bn_grad if args.bn_grad
           else lstm_bf16 if args.lstm_bf16
           else gru_bf16 if args.gru_bf16 else lstm)
    run(out_dir, dev, g)
    print("card:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
