"""Inference-time program optimization: batch-norm folding.

Capability parity: `python/paddle/fluid/inference_transpiler.py` — fuse an
inference-mode batch_norm into the preceding conv2d/mul by rescaling the
weights and adding a folded bias. The JAX package's transpiler, with the
same rewrite: the folded bias is named ``<weight>@BNFOLD_b`` (a
``unique_name``) and an ``elementwise_add`` takes the batch norm's place
and output, so the folded program's JSON is the JAX package's byte for
byte. The arithmetic runs in torch on the device the scope's tensors
live on (no host round trip of the weights), in their dtype.

The fold bumps the program's version, so its fingerprint moves: an
executor plan or a captured graph of the unfolded program is never
served for the folded one.
"""

import torch

from paddle_tpu_torch import unique_name
from paddle_tpu_torch.core import ir
from paddle_tpu_torch.core.scope import global_scope

__all__ = ["InferenceTranspiler"]


class InferenceTranspiler:
    def transpile(self, program, place=None, scope=None):
        """Fold batch_norm(is_test) ops into the conv2d/mul producing their
        input, IN PLACE on ``program`` and ``scope`` values. ``place`` is
        accepted for parity: the fold runs where the tensors are."""
        scope = scope or global_scope()
        block = program.global_block()

        def consumers(name, start):
            return [o for o in block.ops[start:]
                    if name in o.input_arg_names]

        i = 0
        while i < len(block.ops) - 1:
            op = block.ops[i]
            nxt = block.ops[i + 1]
            if (op.type in ("conv2d", "mul")
                    and nxt.type == "batch_norm"
                    and nxt.inputs["X"][0] == op.output_arg_names[0]
                    and len(consumers(op.output_arg_names[0], i + 1)) == 1):
                self._fold(block, scope, op, nxt, i)
            i += 1
        program._bump_version()
        return program

    def _fold(self, block, scope, op, bn, idx):
        w_slot = "Filter" if op.type == "conv2d" else "Y"
        w_name = op.inputs[w_slot][0]
        w = scope.find_var(w_name)

        def stat(slot):
            return scope.find_var(bn.inputs[slot][0])

        eps = bn.attrs.get("epsilon", 1e-5)
        factor = stat("Scale") / torch.sqrt(stat("Variance") + eps)
        if op.type == "conv2d":
            new_w = w * factor[:, None, None, None]
            bias_axis = 1  # channel axis of NCHW
        else:
            new_w = w * factor[None, :]
            bias_axis = -1
        new_b = (stat("Bias") - stat("Mean") * factor).to(w.dtype)
        scope.set_var(w_name, new_w.to(w.dtype))

        # conv writes straight into a temp; add the folded bias and write
        # the BN's output name so downstream consumers see the fused result
        bn_out = bn.outputs["Y"][0]
        b_name = unique_name.generate(w_name + "@BNFOLD_b")
        block.create_var(name=b_name, shape=list(new_b.shape),
                         dtype=str(new_b.dtype).replace("torch.", ""),
                         persistable=True)
        scope.set_var(b_name, new_b)
        add_op = ir.Operator(block, "elementwise_add",
                             {"X": [op.output_arg_names[0]],
                              "Y": [b_name]},
                             {"Out": [bn_out]},
                             {"axis": bias_axis})
        # replace the batch_norm with the bias add
        block.ops[idx + 1] = add_op
