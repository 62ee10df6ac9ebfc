"""v2 evaluator namespace.

Capability parity: `python/paddle/trainer_config_helpers/evaluators.py`
(the 16-name `paddle.v2.evaluator.*` surface backed by
`gserver/evaluators/Evaluator.cpp`). Redesigned: each evaluator call
appends metric ops into the CURRENT default program and registers the
resulting variable, and `v2.trainer.SGD` auto-fetches every registered
evaluator of its program each batch — the metric values land in
``event.EndIteration.metrics`` / ``SGD.test().metrics`` exactly where the
reference trainer surfaced its evaluator reports. Printer evaluators
additionally print their fetched value per batch (host-side, after the
step — the reference printed from inside the C++ forward).
"""

import numpy as np

from paddle_tpu_torch import layers as L
from paddle_tpu_torch.core import ir
from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = [
    "evaluator_base",
    "classification_error_evaluator",
    "auc_evaluator",
    "pnpair_evaluator",
    "precision_recall_evaluator",
    "ctc_error_evaluator",
    "chunk_evaluator",
    "sum_evaluator",
    "column_sum_evaluator",
    "value_printer_evaluator",
    "gradient_printer_evaluator",
    "maxid_printer_evaluator",
    "maxframe_printer_evaluator",
    "seqtext_printer_evaluator",
    "classification_error_printer_evaluator",
    "detection_map_evaluator",
]

# registry lives ON the Program (not a module dict keyed by id():
# that would pin every evaluator-bearing program in memory forever):
# program._v2_evaluators = [(var, name, print_fn|None)]

def registered_for(program):
    return list(getattr(program, "_v2_evaluators", []))


def _register(var, name, print_fn=None):
    prog = ir.default_main_program()
    if not hasattr(prog, "_v2_evaluators"):
        prog._v2_evaluators = []
    prog._v2_evaluators.append((var, name, print_fn))
    return var


def evaluator_base(input, type=None, name=None, **kwargs):
    """Catch-all of the reference base: register any variable as a
    fetched metric."""
    existing = getattr(ir.default_main_program(), "_v2_evaluators", [])
    return _register(input, name or "eval_%d" % len(existing))


def classification_error_evaluator(input, label, name=None, top_k=1,
                                   **kwargs):
    err = L.elementwise_sub(
        L.fill_constant([1], "float32", 1.0),
        L.accuracy(input, label, k=top_k))
    return _register(err, name or "classification_error")


def auc_evaluator(input, label, name=None, **kwargs):
    return _register(L.auc(input, label)[0], name or "auc")


def pnpair_evaluator(input, label, query_id, weight=None, name=None,
                     **kwargs):
    helper = LayerHelper("positive_negative_pair", name=name)
    pos = helper.create_variable_for_type_inference("float32")
    neg = helper.create_variable_for_type_inference("float32")
    neu = helper.create_variable_for_type_inference("float32")
    helper.append_op(
        type="positive_negative_pair",
        inputs={"Score": input, "Label": label, "QueryID": query_id},
        outputs={"PositivePair": pos, "NegativePair": neg,
                 "NeutralPair": neu})
    return _register(pos, name or "pnpair")


def precision_recall_evaluator(input, label, positive_label=None,
                               name=None, **kwargs):
    num_classes = int(input.shape[-1])
    helper = LayerHelper("precision_recall", name=name)
    idx = L.argmax(input, axis=-1)
    batch = helper.create_variable_for_type_inference("float32")
    accum = helper.create_variable_for_type_inference("float32")
    states = helper.create_variable_for_type_inference("float32")
    helper.append_op(
        type="precision_recall",
        inputs={"Indices": idx, "Labels": label},
        outputs={"BatchMetrics": batch, "AccumMetrics": accum,
                 "AccumStatesInfo": states},
        attrs={"class_number": num_classes})
    return _register(batch, name or "precision_recall")


def ctc_error_evaluator(input, label, name=None, **kwargs):
    dist, _ = L.edit_distance(input, label, normalized=True)
    return _register(L.mean(dist), name or "ctc_error")


def chunk_evaluator(input, label, chunk_scheme, num_chunk_types,
                    excluded_chunk_types=None, name=None, **kwargs):
    f1 = L.chunk_eval(input, label, chunk_scheme=chunk_scheme,
                      num_chunk_types=num_chunk_types,
                      excluded_chunk_types=excluded_chunk_types)[2]
    return _register(f1, name or "chunk_f1")


def sum_evaluator(input, name=None, **kwargs):
    return _register(L.reduce_sum(input), name or "sum")


def column_sum_evaluator(input, name=None, **kwargs):
    return _register(L.reduce_sum(input, dim=0), name or "column_sum")


def detection_map_evaluator(input, label, overlap_threshold=0.5,
                            name=None, **kwargs):
    return _register(L.detection_map(input, label,
                                     overlap_threshold=overlap_threshold),
                     name or "detection_map")


# ---- printer evaluators: fetch + host-side print per batch ----

def _printer(var, name, fmt):
    def print_fn(value):
        print(fmt(np.asarray(value)))
    return _register(var, name, print_fn)


def value_printer_evaluator(input, name=None, **kwargs):
    n = name or "value_printer"
    return _printer(input, n, lambda v: "%s: %s" % (n, v))


def gradient_printer_evaluator(input, name=None, **kwargs):
    # the traced step has no standalone grad tensor to peek at; print
    # the forward value like the reference does for inference-only runs
    n = name or "gradient_printer"
    return _printer(input, n, lambda v: "%s: %s" % (n, v))


def maxid_printer_evaluator(input, name=None, **kwargs):
    n = name or "maxid_printer"
    return _printer(L.argmax(input, axis=-1), n,
                    lambda v: "%s: %s" % (n, v))


def maxframe_printer_evaluator(input, name=None, **kwargs):
    n = name or "maxframe_printer"
    return _printer(L.reduce_max(input, dim=-1), n,
                    lambda v: "%s: %s" % (n, v))


def seqtext_printer_evaluator(input, result_file=None, id_input=None,
                              dict_file=None, name=None, **kwargs):
    n = name or "seqtext_printer"
    if result_file:
        def fmt(v):
            with open(result_file, "a") as f:
                f.write("%s\n" % np.asarray(v).tolist())
            return "%s -> %s" % (n, result_file)
    else:
        fmt = lambda v: "%s: %s" % (n, v)
    return _printer(input, n, fmt)


def classification_error_printer_evaluator(input, label, name=None,
                                           **kwargs):
    n = name or "classification_error_printer"
    err = L.elementwise_sub(L.fill_constant([1], "float32", 1.0),
                            L.accuracy(input, label))
    return _printer(err, n, lambda v: "%s: %s" % (n, float(v)))
