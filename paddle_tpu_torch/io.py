"""Checkpointing and inference export.

Capability parity: `python/paddle/fluid/io.py` (save/load_vars/params/
persistables :66-245, save_inference_model :298, load_inference_model
:383), in the JAX package's on-disk format, so a model either package
saves loads in the other:

* ``__model__.json`` holds ``{"program", "feed_names", "fetch_names"}``:
  the pruned program's JSON (byte-identical to the JAX package's for
  the same program) and the names the server feeds and fetches;
* ``__params__.npz`` holds one numpy array per persistable variable,
  and a ``PackedSeq`` as ``name@DATA`` and ``name@LEN``. A caller's
  ``params_filename`` is written verbatim (no ``.npz`` appended).

``load_vars`` places each tensor on the executor's device. The JAX
package runs with 64-bit types off, so a variable it saved as int32
that the program declares int64 loads as int64. numpy has no bfloat16,
so a bfloat16 persistable cannot be saved (``save_vars`` raises).

The JAX package's StableHLO deployment artifacts
(``export_deployment`` / ``load_deployment``) are not ported.
"""

import json
import os

import numpy as np
import torch

from paddle_tpu_torch.core import ir
from paddle_tpu_torch.core.infer import _CANONICAL, torch_dtype
from paddle_tpu_torch.core.lower import PackedSeq
from paddle_tpu_torch.core.place import default_place
from paddle_tpu_torch.core.scope import global_scope

__all__ = ["save_vars", "save_params", "save_persistables", "load_vars",
           "load_params", "load_persistables", "save_inference_model",
           "load_inference_model", "get_inference_program",
           "get_parameter_value", "get_parameter_value_by_name"]


def _is_param(var):
    return isinstance(var, ir.Parameter)


def _is_persistable(var):
    return var.persistable


def _numpy(v):
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            raise TypeError("numpy has no bfloat16: a bfloat16 "
                            "persistable cannot be saved to .npz")
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    main_program = main_program or ir.default_main_program()
    if vars is None:
        vars = [v for v in main_program.list_vars() if predicate(v)]
    os.makedirs(dirname, exist_ok=True)
    scope = global_scope()
    blob = {}
    for v in vars:
        val = scope.find_var(v.name)
        if val is None:
            continue
        if isinstance(val, PackedSeq):
            blob[v.name + "@DATA"] = _numpy(val.data)
            blob[v.name + "@LEN"] = _numpy(val.lengths)
        else:
            blob[v.name] = _numpy(val)
    path = os.path.join(dirname, filename or "__params__.npz")
    # through a handle: np.savez(path) appends ".npz" to an
    # extension-less name, which breaks a caller's params_filename
    with open(path, "wb") as f:
        np.savez(f, **blob)
    return path


def save_params(executor, dirname, main_program=None, filename=None):
    return save_vars(executor, dirname, main_program, predicate=_is_param,
                     filename=filename)


def save_persistables(executor, dirname, main_program=None, filename=None):
    return save_vars(executor, dirname, main_program,
                     predicate=_is_persistable, filename=filename)


def _device(executor):
    if executor is not None and getattr(executor, "device", None) \
            is not None:
        return executor.device
    return default_place(None)


def _tensor(arr, declared, device):
    """``arr`` as a tensor on ``device``; an array the JAX package
    narrowed (int32 for a declared int64) widens to the declared
    dtype."""
    arr = np.asarray(arr)
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if declared is not None and arr.dtype.name != declared \
            and arr.dtype.name == _CANONICAL.get(declared):
        t = t.to(torch_dtype(declared))
    return t.to(device)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    main_program = main_program or ir.default_main_program()
    if vars is None:
        vars = [v for v in main_program.list_vars() if predicate(v)]
    path = os.path.join(dirname, filename or "__params__.npz")
    device = _device(executor)
    with np.load(path) as blob:
        scope = global_scope()
        for v in vars:
            declared = getattr(v, "dtype", None)
            if v.name in blob:
                scope.set_var(v.name, _tensor(blob[v.name], declared,
                                              device))
            elif v.name + "@DATA" in blob:
                scope.set_var(v.name, PackedSeq(
                    _tensor(blob[v.name + "@DATA"], declared, device),
                    _tensor(blob[v.name + "@LEN"], None, device)))


def load_params(executor, dirname, main_program=None, filename=None):
    load_vars(executor, dirname, main_program, predicate=_is_param,
              filename=filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    load_vars(executor, dirname, main_program, predicate=_is_persistable,
              filename=filename)


def _prune_for_inference(program, feed_names, fetch_names):
    """Keep only ops on a path from feeds to fetches (reference
    `framework/prune.cc` + Program.prune)."""
    pruned = program.clone(for_test=True)
    b0 = pruned.global_block()
    needed = set(fetch_names)
    keep = []
    for op in reversed(b0.ops):
        if any(n in needed for n in op.output_arg_names):
            keep.append(op)
            needed.update(op.input_arg_names)
    b0.ops = list(reversed(keep))
    return pruned


def get_inference_program(target_vars, main_program=None):
    """Prune the (guarded) main program down to ``target_vars``
    (reference `python/paddle/fluid/io.py get_inference_program`)."""
    main_program = main_program or ir.default_main_program()
    if isinstance(target_vars, (ir.Variable, str)):
        target_vars = [target_vars]
    fetch_names = [v.name if isinstance(v, ir.Variable) else str(v)
                   for v in target_vars]
    feed_names = [v.name for b in main_program.blocks
                  for v in b.vars.values() if getattr(v, "is_data", False)]
    return _prune_for_inference(main_program, feed_names, fetch_names)


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, export_for_deployment=True):
    main_program = main_program or ir.default_main_program()
    # the reference accepts a bare Variable / name for both arguments
    if isinstance(target_vars, (ir.Variable, str)):
        target_vars = [target_vars]
    if isinstance(feeded_var_names, str):
        feeded_var_names = [feeded_var_names]
    fetch_names = [v.name if isinstance(v, ir.Variable) else v
                   for v in target_vars]
    pruned = _prune_for_inference(main_program, feeded_var_names, fetch_names)
    os.makedirs(dirname, exist_ok=True)
    meta = {
        "program": pruned.to_dict(),
        "feed_names": list(feeded_var_names),
        "fetch_names": fetch_names,
    }
    with open(os.path.join(dirname, model_filename or "__model__.json"),
              "w") as f:
        json.dump(meta, f)
    save_persistables(executor, dirname, pruned, filename=params_filename)
    return fetch_names


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None):
    with open(os.path.join(dirname, model_filename or "__model__.json")) as f:
        meta = json.load(f)
    program = ir.Program.from_dict(meta["program"])
    load_persistables(executor, dirname, program, filename=params_filename)
    fetch_vars = [program.global_block().var(n) for n in meta["fetch_names"]]
    return program, meta["feed_names"], fetch_vars


def get_parameter_value(para, executor=None):
    return _numpy(global_scope().find_var(para.name))


def get_parameter_value_by_name(name, executor=None, program=None):
    return _numpy(global_scope().find_var(name))
