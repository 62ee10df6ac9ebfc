"""Shared batch->feed-dict conversion for the v2 trainer and inference
(reference python/paddle/v2/trainer.py DataFeeder usage)."""

import numpy as np

__all__ = ["build_feed", "data_layer_names"]


def data_layer_names(program):
    return [v.name for v in program.global_block().vars.values()
            if getattr(v, "is_data", False)]


def build_feed(program, data_names, batch, feeding=None):
    """batch: list of sample tuples; feeding: optional name->index map."""
    order = data_names
    if feeding is not None:
        order = [name for name, _ in
                 sorted(feeding.items(), key=lambda kv: kv[1])]
    feed = {}
    nfields = len(batch[0]) if batch else 0
    for i, name in enumerate(order):
        if i >= nfields:
            break
        vals = [sample[i] for sample in batch]
        var = program.global_block().var(name)
        if getattr(var, "lod_level", 0) > 0:
            seqs = []
            for v in vals:
                a = np.asarray(v)
                # scalar-per-timestep sequences declared with a trailing
                # feature dim (e.g. integer_value_sequence -> [-1,-1,1])
                if a.ndim + 2 == len(var.shape or []) + 1 and \
                        len(var.shape or []) > 2:
                    a = a.reshape((-1,) + tuple(var.shape[2:]))
                seqs.append(a)
            feed[name] = seqs
        else:
            arr = np.asarray(vals)
            if var.dtype in ("int64", "int32") and arr.ndim == 1:
                arr = arr.reshape(-1, 1)
            feed[name] = arr.astype(var.dtype)
    return feed
