"""Attr schemas for the hot op set, installed into the op registry.

The JAX package's schemas, copied: ``install`` registers the same rules
on the port's registry.

The verifier validates any attr PRESENT on an op against these rules
(``core.registry.set_attr_schema`` / ``attr_schema``); absent attrs
always pass because every lowering defaults them. Rules are types,
tuples of types, set enumerations, or predicates — deliberately
narrow where a wrong value would silently mislower (``data_layout``,
dim lists the layout pass remaps) and loose where the lowering itself
is tolerant.

Grad ops inherit their forward's schema (they carry the forward attrs
plus ``fwd_op_uid``, which every op accepts — backward.py stamps it).
"""

import numpy as np

from paddle_tpu_torch.core import registry

__all__ = ["install"]


def _int_list(v):
    """list/tuple of ints"""
    return isinstance(v, (list, tuple)) and all(
        isinstance(x, (int, np.integer)) and not isinstance(x, bool)
        for x in v)


def _int_or_list(v):
    """int or list of ints"""
    return (isinstance(v, (int, np.integer)) and not isinstance(v, bool)
            ) or _int_list(v)


_LAYOUTS = {"NCHW", "NHWC", "AnyLayout"}

# conv/pool geometry shared rules
_GEOM = {
    "strides": _int_list,
    "paddings": _int_list,
    "dilations": _int_list,
    "groups": int,
    "data_layout": _LAYOUTS,
}

_BN = {
    "epsilon": float,
    "momentum": float,
    "is_test": bool,
    "data_layout": _LAYOUTS,
}

_SCHEMAS = {
    "conv2d": _GEOM,
    "depthwise_conv2d": _GEOM,
    "conv2d_transpose": _GEOM,
    "batch_norm": _BN,
    "pool2d": {
        "pooling_type": {"max", "avg"},
        "ksize": _int_list,
        "strides": _int_list,
        "paddings": _int_list,
        "global_pooling": bool,
        "ceil_mode": bool,
        "exclusive": bool,
        "data_layout": _LAYOUTS,
    },
    "conv2d_bn_act": dict(_GEOM, **{
        "epsilon": float, "momentum": float, "is_test": bool,
        "act": {"relu"}, "with_residual": bool,
        "conv_type": {"conv2d", "depthwise_conv2d"},
    }),
    "mul": {"x_num_col_dims": int, "y_num_col_dims": int},
    "dropout": {"dropout_prob": float, "is_test": bool},
    "transpose": {"axis": _int_list},
    "reshape": {"shape": _int_list},
    "flatten": {"axis": int},
    "concat": {"axis": int},
    "split": {"axis": int, "num": int},
    "squeeze": {"axes": _int_list},
    "unsqueeze": {"axes": _int_list},
    "softmax": {"axis": int},
    "reduce_sum": {"dim": _int_or_list, "keep_dim": bool,
                   "reduce_all": bool},
    "reduce_mean": {"dim": _int_or_list, "keep_dim": bool,
                    "reduce_all": bool},
    "reduce_max": {"dim": _int_or_list, "keep_dim": bool,
                   "reduce_all": bool},
    "reduce_min": {"dim": _int_or_list, "keep_dim": bool,
                   "reduce_all": bool},
    "fill_constant": {"shape": _int_list, "dtype": str},
    "cast": {"out_dtype": str},
    "scale": {"scale": float, "bias": float},
    "lookup_table": {"is_sparse": bool, "padding_idx": int},
    "global_norm_clip": {"clip_norm": float},
    "fused_attention": {
        "causal": bool, "scale": float,
        "block_q": int, "block_k": int, "decode_block_k": int,
        "cache_mode": {"prefill", "decode"},
    },
    "elementwise_add": {"axis": int},
    "elementwise_sub": {"axis": int},
    "elementwise_mul": {"axis": int},
    "elementwise_div": {"axis": int},
    "elementwise_max": {"axis": int},
    "elementwise_min": {"axis": int},
    "elementwise_pow": {"axis": int},
    "pad": {"paddings": _int_list},
    "sgd": {}, "momentum": {"mu": float, "use_nesterov": bool},
    "adam": {"beta1": float, "beta2": float, "epsilon": float},
}

# the reduction tags the reductions/kernels passes plant — they land on
# batch_norm(_grad) and conv2d_bn_act(_grad) attrs. The port's passes
# write the JAX package's attr names (the tagged grads launch the CUDA
# batch-norm backward, kernels/bn_grad.py), so the schema keeps its name
_PALLAS_TAGS = {
    "use_pallas_reduction": bool,
    "pallas_interpret": bool,
    "pallas_tile": int,
}

_done = set()


def install():
    """Idempotently install the schemas into the registry. Called at
    every verification entry (cheap: a handful of dict lookups once
    installed) because op modules register lazily — an op type absent
    at one call is retried at the next, so import order never drops a
    schema."""
    for op_type, schema in _SCHEMAS.items():
        if op_type in _done or not registry.has(op_type):
            continue
        registry.set_attr_schema(op_type, schema)
        if op_type in ("batch_norm", "conv2d_bn_act"):
            registry.set_attr_schema(op_type, _PALLAS_TAGS)
        _done.add(op_type)
