"""Where the card's and the CPU's gradients of the stacked LSTM differ.

    python3 lstm_grad_check.py [--seed N]

Runs ``calc_gradient`` of the stacked LSTM's loss with respect to its
embedding's output (dict 30000, emb/hid 512, 3 layers, batch 64,
lengths 16..80; ``chip_smoke.calc_gradient_path``'s program) on the card
and prints:

* each B3 and B4 call the program makes, held against the plain version
  in float64 on that call's own inputs (recorded in the program), run
  again to the same bits, and whether the gradient op's recomputed
  forward got the forward's inputs;
* each row's largest gradient difference, card against the port's CPU
  run from the same weights, and the rows whose max pools pick other
  time steps on the two (``chip_smoke.max_pool_winners``);
* what a 1e-6 relative change of the embedding table moves the CPU's
  gradient by, and which rows' max pools it moves.

Needs one CUDA card; imports nothing of JAX.
"""

import argparse
import sys

import numpy as np
import torch


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("lstm_grad_check: no CUDA device")
    import chip_smoke as cs
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import layers, unique_name
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import lstm_cell as lc
    from paddle_tpu_torch.models.stacked_lstm import stacked_lstm_net

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load_all()
    print("card:", cs.card_line())
    with unique_name.guard():
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            words = layers.data("words", [1], dtype="int64", lod_level=1)
            label = layers.data("label", [1], dtype="int64")
            pred = stacked_lstm_net(words, cs.DICT, cs.CLASSES, cs.EMB,
                                    cs.HID, cs.STACKED)
            loss = layers.mean(layers.cross_entropy(pred, label))
            emb = next(op for op in prog.global_block().ops
                       if op.type == "lookup_table").outputs["Out"][0]
            (g,) = fluid.calc_gradient(loss, [emb])
    pooled = [op.inputs["X"][0] for op in prog.global_block().ops
              if op.type == "sequence_pool"]
    startup.random_seed = args.seed
    scope, exe = fluid.Scope(), fluid.Executor()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(args.seed)
    lens, ids, lab = cs.stacked_lstm_batch(rng, cs.LSTM_B, cs.LSTM_T,
                                           cs.MIN_LEN, cs.DICT)
    feed = {"words": ids, "label": lab}
    fetch = [g] + pooled

    calls = []
    kernels = {"fwd": (lc.lstm_forward, lc.lstm_forward_reference),
               "bwd": (lc.lstm_backward, lc.lstm_backward_reference)}

    def recording(kind):
        def run(*a):
            out = kernels[kind][0](*a)
            calls.append((kind, [t.detach().clone() for t in a],
                          [t.detach().clone() for t in out]))
            return out
        return run

    lc.lstm_forward, lc.lstm_backward = recording("fwd"), recording("bwd")
    try:
        card = exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)
    finally:
        lc.lstm_forward, lc.lstm_backward = (kernels["fwd"][0],
                                             kernels["bwd"][0])
    for k, (kind, ins, outs) in enumerate(calls):
        ref = kernels[kind][1](*[t.cpu().double() for t in ins])
        again = kernels[kind][0](*ins)
        errs = ["%.3g" % ((o.cpu().double() - r).abs().max().item()
                          / max(r.abs().max().item(), 1e-30))
                for o, r in zip(outs[:3], ref[:3])]
        same = [i for i, (kk, ii, _) in enumerate(calls)
                if kk == kind and i != k
                and all(torch.equal(x, y) for x, y in zip(ii, ins))]
        print("B%s call %d: outputs against float64 on its inputs %s x "
              "max; run again bitwise: %s; the same inputs as call(s) %s"
              % ("3" if kind == "fwd" else "4", k, errs,
                 all(torch.equal(o, a) for o, a in zip(outs, again)), same))

    cpu_scope = fluid.Scope()
    for n, t in scope.vars.items():
        cpu_scope.set_var(n, t.cpu())
    cpu_exe = fluid.Executor(fluid.CPUPlace())
    cpu = cpu_exe.run(prog, feed=feed, fetch_list=fetch, scope=cpu_scope)

    def rows_apart(a, b):
        d = np.abs(a[0].data - b[0].data).reshape(len(lens), -1).max(1)
        d /= np.abs(b[0].data).max()
        moved = sorted({int(r) for x, y in zip(a[1:], b[1:])
                        for r in np.nonzero((cs.max_pool_winners(x.data, lens)
                                             != cs.max_pool_winners(y.data,
                                                                    lens))
                                            .any(axis=(1, 2)))[0]})
        worst = np.argsort(-d)[:4]
        return ", ".join("row %d %.3g" % (r, d[r]) for r in worst), moved

    worst, moved = rows_apart(card, cpu)
    print("card against CPU: largest gradient difference a row (x "
          "max|g|): %s; rows whose max pools pick other steps: %s"
          % (worst, moved))
    table = cpu_scope.find_var("embedding_0.w_0")
    noise = torch.randn(table.shape, generator=torch.Generator()
                        .manual_seed(args.seed + 1))
    cpu_scope.set_var("embedding_0.w_0", table * (1 + 1e-6 * noise))
    moved_cpu = cpu_exe.run(prog, feed=feed, fetch_list=fetch,
                            scope=cpu_scope)
    worst, moved = rows_apart(moved_cpu, cpu)
    print("the CPU with the table changed by 1e-6: largest gradient "
          "difference a row (x max|g|): %s; rows whose max pools pick "
          "other steps: %s" % (worst, moved))


if __name__ == "__main__":
    sys.exit(main())
