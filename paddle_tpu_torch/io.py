"""Save/load + inference export (reference: python/paddle/fluid/io.py —
save_persistables:441, load_persistables:657, save_inference_model:862,
load_inference_model:1014). Port of ``paddle_tpu/io.py`` for the native
on-disk format, which it shares with the JAX package byte for byte:
``__model__`` (the desc's JSON), ``__meta__.json`` (feed and fetch names)
and ``__combined__.npz`` (the persistables as numpy arrays). A directory
either package writes loads in the other. The reference-proto and AOT
formats, checkpoints and frozen models are later slices (ROADMAP Queue 1:
I/O and data, inference).
"""

import copy
import json
import os

import numpy as np
import torch

from paddle_tpu_torch.core.desc import ProgramDescData
from paddle_tpu_torch.framework import (
    OP_ROLE_KEY, Block, OpRole, Parameter, Program, Variable, _flip_is_test,
    default_main_program, program_from_desc,
)

__all__ = [
    "save_vars", "save_params", "save_persistables",
    "load_vars", "load_params", "load_persistables",
    "save_inference_model", "load_inference_model",
]

# written by the JAX package's AOT export; stale after a native re-save
_AOT_FILES = ("__aot__.stablehlo", "__aot_meta__.json")


def _is_persistable(var):
    return var.persistable


def _is_parameter(var):
    return isinstance(var, Parameter)


def _scope():
    from paddle_tpu_torch.executor import global_scope

    return global_scope()


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    main_program = main_program or default_main_program()
    if vars is None:
        vars = [v for v in main_program.list_vars() if predicate(v)]
    os.makedirs(dirname, exist_ok=True)
    scope = _scope()
    arrays = {}
    for v in vars:
        val = scope.get(v.name)
        if val is None:
            continue
        arrays[v.name] = (val.detach().cpu().numpy()
                          if isinstance(val, torch.Tensor) else np.asarray(val))
    np.savez(os.path.join(dirname, filename or "__combined__.npz"), **arrays)
    return list(arrays)


def save_params(executor, dirname, main_program=None, filename=None):
    return save_vars(executor, dirname, main_program,
                     predicate=_is_parameter, filename=filename)


def save_persistables(executor, dirname, main_program=None, filename=None):
    return save_vars(executor, dirname, main_program,
                     predicate=_is_persistable, filename=filename)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    """Load the npz arrays of ``vars`` into the global scope as tensors on
    the executor's device."""
    main_program = main_program or default_main_program()
    if vars is None:
        vars = [v for v in main_program.list_vars() if predicate(v)]
    scope = _scope()
    loaded = []
    with np.load(os.path.join(dirname, filename or "__combined__.npz")) as data:
        for v in vars:
            if v.name in data:
                scope.set(v.name, torch.from_numpy(data[v.name]).to(
                    executor.device))
                loaded.append(v.name)
    return loaded


def load_params(executor, dirname, main_program=None, filename=None):
    return load_vars(executor, dirname, main_program,
                     predicate=_is_parameter, filename=filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    return load_vars(executor, dirname, main_program,
                     predicate=_is_persistable, filename=filename)


def _prune_for_inference(program, feed_names, fetch_names):
    """Backward-slice the program to the ops needed for the fetches
    (io.py:159; reference: framework prune.cc via io.py:862)."""
    pruned = Program()
    src = program.desc.global_block()
    needed = set(fetch_names)
    keep = []
    for i in range(len(src.ops) - 1, -1, -1):
        op = src.ops[i]
        role = int(op.attrs.get(OP_ROLE_KEY, 0))
        if role & (OpRole.Backward | OpRole.Optimize):
            continue
        if any(n in needed for n in op.output_arg_names()):
            keep.append(i)
            needed.update(op.input_arg_names())
    keep.reverse()

    dst = pruned.desc.global_block()
    for name, vd in src.vars.items():
        dst.vars[name] = copy.deepcopy(vd)
    for i in keep:
        dst.ops.append(copy.deepcopy(src.ops[i]))
    pruned._bump_version()
    pruned.blocks = [Block(pruned, 0)]
    b = pruned.blocks[0]
    for name in dst.vars:
        v = Variable.__new__(Variable)
        v.block = b
        v.desc = dst.vars[name]
        b.vars[name] = v
    return pruned


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, export_for_deployment=True,
                         export_format="native", example_feeds=None):
    """(io.py:201) The native format only."""
    if export_format != "native":
        raise NotImplementedError(
            "save_inference_model(export_format=%r): the port writes the "
            "native format only; the reference-proto export and the AOT "
            "artifact are ROADMAP Queue 1, inference" % (export_format,))
    main_program = main_program or default_main_program()
    fetch_names = [v.name for v in target_vars]
    pruned = _prune_for_inference(main_program, feeded_var_names, fetch_names)
    _flip_is_test(pruned.desc)
    os.makedirs(dirname, exist_ok=True)
    with open(os.path.join(dirname, model_filename or "__model__"), "wb") as f:
        f.write(pruned.desc.serialize_to_string())
    meta = {"feed_names": feeded_var_names, "fetch_names": fetch_names}
    with open(os.path.join(dirname, "__meta__.json"), "w") as f:
        json.dump(meta, f)
    save_persistables(executor, dirname, main_program,
                      filename=params_filename)
    # a native re-save must not leave a stale AOT artifact beside it, or
    # the JAX package's predictor would serve the old weights baked in it
    for name in _AOT_FILES:
        path = os.path.join(dirname, name)
        if os.path.exists(path):
            os.remove(path)
    return fetch_names


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None, pserver_endpoints=None):
    """(io.py:318) Returns (program, feed_names, fetch_vars); the
    persistables land in the global scope on the executor's device."""
    if pserver_endpoints:
        raise NotImplementedError(
            "load_inference_model(pserver_endpoints=...): the parameter "
            "server is ROADMAP Queue 1, resilience and launch")
    with open(os.path.join(dirname, model_filename or "__model__"), "rb") as f:
        program = program_from_desc(ProgramDescData.parse_from_string(f.read()))
    program._is_test = True
    with open(os.path.join(dirname, "__meta__.json")) as f:
        meta = json.load(f)
    load_persistables(executor, dirname, program, filename=params_filename)
    fetch_vars = [program.global_block().var(n) for n in meta["fetch_names"]]
    return program, meta["feed_names"], fetch_vars
