"""Fluid-tier evaluators: program-embedded metric accumulators.

Capability parity: `python/paddle/fluid/evaluator.py` (Evaluator base,
ChunkEvaluator, Accuracy) — the pre-metrics-module API the book tests
use (`book/test_label_semantic_roles.py:185`), as the JAX package's
``evaluator.py`` builds it. Each evaluator appends its metric op to the
CURRENT main program plus in-place accumulation ops over persistable
counter state; ``reset`` zeroes the state in the scope, ``eval``
computes the pass-level result from it.

Accumulation is expressed as ordinary program ops whose outputs write
back the same persistable names, so the executor's write-back carries
them from step to step.
"""

import numpy as np
import torch

from paddle_tpu_torch import layers
from paddle_tpu_torch.core import ir
from paddle_tpu_torch.core.infer import torch_dtype
from paddle_tpu_torch.core.scope import global_scope
from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["Evaluator", "ChunkEvaluator", "Accuracy"]


def _scope_device(scope, name):
    """Where ``name``'s value lives in ``scope``: its tensor's device,
    else the device of the first tensor the scope holds, else the
    CPU (the startup program then writes the state where it runs)."""
    v = scope.find_var(name)
    if isinstance(v, torch.Tensor):
        return v.device
    s = scope
    while s is not None:
        for t in s.vars.values():
            if isinstance(t, torch.Tensor):
                return t.device
        s = s.parent
    return torch.device("cpu")


class Evaluator:
    """Base: tracks this evaluator's state var names."""

    def __init__(self, name=None):
        self.helper = LayerHelper(name or type(self).__name__.lower())
        self.states = []

    def _create_state(self, suffix, dtype="float32", shape=(1,)):
        block = ir.default_main_program().global_block()
        name = self.helper.name + "." + suffix
        var = block.create_var(name=name, shape=list(shape), dtype=dtype,
                               persistable=True)
        # the reference initializes the state in the STARTUP program
        # (evaluator.py _create_state -> startup fill_constant), so any
        # scope that runs startup gets the counters, a fresh Scope
        # entered after the build included
        startup = ir.default_startup_program().global_block()
        startup.create_var(name=name, shape=list(shape), dtype=dtype,
                           persistable=True)
        startup.append_op("fill_constant", {}, {"Out": [name]},
                          {"shape": list(shape), "dtype": dtype,
                           "value": 0.0})
        self.states.append(var)
        # the build-time scope too: the book flow constructs the
        # evaluator after startup already ran in some configs
        self._zero(var)
        return var

    def _accumulate(self, state, delta):
        """state += delta, written back in-program (stateful op)."""
        block = ir.default_main_program().current_block()
        block.append_op("elementwise_add",
                        {"X": [state.name], "Y": [delta.name]},
                        {"Out": [state.name]}, {"axis": -1})

    def _zero(self, var):
        scope = global_scope()
        scope.set_var(var.name, torch.zeros(
            tuple(var.shape), dtype=torch_dtype(var.dtype),
            device=_scope_device(scope, var.name)))

    def reset(self, executor=None, reset_program=None):
        for v in self.states:
            self._zero(v)

    def _state_value(self, var):
        return global_scope().find_var(var.name).detach().cpu().numpy()


class ChunkEvaluator(Evaluator):
    """Pass-level chunking precision/recall/F1 (reference evaluator.py
    ChunkEvaluator over chunk_eval_op). ``metrics`` are the PER-BATCH
    precision/recall/F1 vars; ``eval`` returns the accumulated pass
    numbers."""

    def __init__(self, input, label, chunk_scheme, num_chunk_types,
                 excluded_chunk_types=None):
        super().__init__("chunk_evaluator")
        (prec, rec, f1, n_inf, n_lab,
         n_cor) = layers.chunk_eval(
            input=input, label=label, chunk_scheme=chunk_scheme,
            num_chunk_types=num_chunk_types,
            excluded_chunk_types=excluded_chunk_types)
        self.metrics = [prec, rec, f1]
        self.num_infer_chunks = self._create_state("num_infer")
        self.num_label_chunks = self._create_state("num_label")
        self.num_correct_chunks = self._create_state("num_correct")
        for state, cnt in ((self.num_infer_chunks, n_inf),
                           (self.num_label_chunks, n_lab),
                           (self.num_correct_chunks, n_cor)):
            fcnt = layers.cast(cnt, "float32")
            self._accumulate(state, fcnt)

    def eval(self, executor=None, eval_program=None):
        n_inf = float(self._state_value(self.num_infer_chunks).sum())
        n_lab = float(self._state_value(self.num_label_chunks).sum())
        n_cor = float(self._state_value(self.num_correct_chunks).sum())
        precision = n_cor / n_inf if n_inf else 0.0
        recall = n_cor / n_lab if n_lab else 0.0
        f1 = (2 * precision * recall / (precision + recall)
              if n_cor else 0.0)
        return (np.array([precision], np.float32),
                np.array([recall], np.float32),
                np.array([f1], np.float32))


class Accuracy(Evaluator):
    """Pass-level accuracy (reference evaluator.py Accuracy): per-batch
    accuracy op + weighted accumulation."""

    def __init__(self, input, label, k=1):
        super().__init__("accuracy_evaluator")
        total = layers.create_tensor(dtype="int64")
        correct = layers.create_tensor(dtype="int64")
        acc = layers.accuracy(input=input, label=label, k=k,
                              correct=correct, total=total)
        self.metrics = [acc]
        self.total = self._create_state("total")
        self.correct = self._create_state("correct")
        self._accumulate(self.total, layers.cast(total, "float32"))
        self._accumulate(self.correct, layers.cast(correct, "float32"))

    def eval(self, executor=None, eval_program=None):
        total = float(self._state_value(self.total).sum())
        correct = float(self._state_value(self.correct).sum())
        return np.array([correct / total if total else 0.0], np.float32)
