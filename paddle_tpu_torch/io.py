"""Save/load + inference export (reference: python/paddle/fluid/io.py —
save_persistables:441, load_persistables:657, save_inference_model:862,
load_inference_model:1014). Port of ``paddle_tpu/io.py``:

* the native on-disk format, which it shares with the JAX package byte
  for byte: ``__model__`` (the desc's JSON), ``__meta__.json`` (feed and
  fetch names) and ``__combined__.npz`` (the persistables as numpy
  arrays). A directory either package writes loads in the other;
* ``save_inference_model(export_format="reference")``: the reference's
  own format (binary framework.proto ``__model__`` + one tensor stream a
  persistable) through ``compat.py``;
* async checkpoints: ``CheckpointManager`` (``checkpoint.py``),
  ``save_checkpoint_async`` and ``load_checkpoint``, which restores in
  place into the scope's tensors, so a captured step stays valid;
* frozen (and INT8-quantized) models: ``save_frozen_model`` and
  ``load_frozen_model``, the native layout with ``"frozen": true`` in
  the meta; int8 weights stay int8 in the ``.npz``, so a frozen INT8
  model either package saves loads in the other;
* ``save_inference_model(export_format="aot")``: the native files plus
  a ``torch.export`` artifact (``aot.py``), which the predictor runs
  without the front end.
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
    "CheckpointManager", "save_checkpoint_async", "load_checkpoint",
    "save_frozen_model", "load_frozen_model",
]

from paddle_tpu_torch.checkpoint import CheckpointManager  # noqa: E402

# the AOT artifact's files (aot.py, either package's); stale after a
# native re-save
_AOT_FILES = ("__aot__.stablehlo", "__aot_meta__.json")


def save_checkpoint_async(manager, step, main_program=None, scope=None,
                          blocking=False):
    """Async save of a program's persistables through a CheckpointManager
    (io.py:28; the same var selection as save_persistables). Returns the
    saved names at once: the step loop keeps training while the
    device-to-host transfer and the writes run on the manager's writer
    thread."""
    from paddle_tpu_torch import observability as obs

    main_program = main_program or default_main_program()
    scope = scope if scope is not None else _scope()
    arrays = {}
    for v in main_program.list_vars():
        if not v.persistable:
            continue
        val = scope.get(v.name)
        if val is not None:
            arrays[v.name] = val
    # the span covers exactly the step-thread cost of the save — the
    # on-device snapshot copies + queue handoff (checkpoint.py); the
    # transfer to the host and the file writes run on the writer thread
    with obs.span("ckpt.snapshot", step=int(step), n_vars=len(arrays)), \
            obs.time_block("ckpt.enqueue_ms"):
        manager.save(step, arrays, blocking=blocking)
    return sorted(arrays)


def load_checkpoint(manager, main_program=None, scope=None, step=None,
                    allow_partial=False, place=None):
    """Restore a CheckpointManager checkpoint into the scope; returns the
    restored step (io.py:60). A program persistable that is initialized
    in the scope but absent from the checkpoint raises (a silently
    half-restored model would train from an inconsistent state); pass
    ``allow_partial=True`` for deliberate surgery like warm-starting a
    grown model.

    Each value lands on the device of the scope's current tensor, copied
    IN PLACE where shape and dtype match, so a captured step keeps its
    graph (no recapture); elsewhere the scope gets a new tensor. A var the
    scope holds no tensor for lands on ``place`` (default ``CUDAPlace(0)``,
    which raises without CUDA). Integer values take the integer type the
    port holds, int64 where the scope has no tensor (the JAX package
    holds int64 vars as int32 with 64-bit types off). The copies run on
    the current stream, the one the engine replays on, so every step
    already dispatched, in a dispatch window too, runs before them; the
    window's records stay unread (a rollback discards them)."""
    main_program = main_program or default_main_program()
    scope = scope if scope is not None else _scope()
    step = manager.latest_step() if step is None else step
    data = manager.restore(step)
    wanted = {v.name for v in main_program.list_vars() if v.persistable}
    missing = sorted(n for n in wanted
                     if n not in data and scope.get(n) is not None)
    if missing and not allow_partial:
        raise KeyError(
            "checkpoint step %s lacks persistable var(s) %s; pass "
            "allow_partial=True to keep their current values"
            % (step, missing))
    for name, arr in data.items():
        if name in wanted:
            _restore_var(scope, name, arr, place)
    return step


def _restore_var(scope, name, arr, place):
    value = (arr if isinstance(arr, torch.Tensor)
             else torch.from_numpy(np.ascontiguousarray(arr)))
    cur = scope.get(name)
    if isinstance(cur, torch.Tensor):
        device, dtype = cur.device, cur.dtype
    else:
        cur = None
        from paddle_tpu_torch.platform import CUDAPlace

        device = (place or CUDAPlace(0)).torch_device()
        # the port's integer state is int64 at run time (its descs, like
        # the JAX package's, record it as INT32)
        dtype = torch.int64
    if value.dtype != dtype and _is_int(value.dtype) and _is_int(dtype):
        value = value.to(dtype)
    if (cur is not None and cur.shape == value.shape
            and cur.dtype == value.dtype):
        cur.copy_(value)
    else:
        scope.set(name, value.to(device))


def _is_int(dtype):
    return not (dtype.is_floating_point or dtype.is_complex
                or dtype == torch.bool)


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
    """(io.py:201) ``export_format="reference"`` writes the reference's
    on-disk format instead — binary framework.proto ``__model__`` +
    per-var tensor streams — through ``compat.py``, so reference tooling
    (and ``compat.load_reference_inference_model``) loads the model.
    ``"aot"`` writes the native files and, beside them, the
    ``torch.export`` artifact of the pruned program over the global
    scope's values, specialized to ``example_feeds`` (aot.py)."""
    if export_format == "reference":
        from paddle_tpu_torch import compat

        return compat.save_reference_inference_model(
            dirname, feeded_var_names, target_vars, executor,
            main_program=main_program,
            model_filename=model_filename or "__model__")
    if export_format not in ("native", "aot"):
        raise ValueError(
            "save_inference_model(export_format=%r): use 'native', "
            "'reference' or 'aot'" % (export_format,))
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
    if export_format == "aot":
        from paddle_tpu_torch.aot import export_aot

        export_aot(dirname, feeded_var_names, fetch_names, pruned, _scope(),
                   example_feeds or {})
    else:
        # a native re-save must not leave a stale AOT artifact beside
        # it, or a predictor would serve the old weights baked in it
        _remove_aot(dirname)
    return fetch_names


def _remove_aot(dirname):
    for name in _AOT_FILES:
        path = os.path.join(dirname, name)
        if os.path.exists(path):
            os.remove(path)


def save_frozen_model(dirname, program, feed_names, fetch_names,
                      scope=None, quant_meta=None):
    """Persist a frozen (and possibly INT8-quantized) program produced by
    ``inference.freeze_program`` / ``quantize_program`` (io.py:255):
    ``__model__`` desc bytes + ``__meta__.json`` + every persistable read
    from the GIVEN scope (freezing runs in a private scope, so the
    global-scope path of save_persistables would miss the folded/int8
    weights). ``quant_meta`` (e.g. a QuantReport summary) rides along in
    the meta JSON so tooling can tell a quantized artifact from an fp32
    one."""
    scope = scope if scope is not None else _scope()
    os.makedirs(dirname, exist_ok=True)
    with open(os.path.join(dirname, "__model__"), "wb") as f:
        f.write(program.desc.serialize_to_string())
    fetch_names = [f.name if hasattr(f, "name") else str(f)
                   for f in fetch_names]
    meta = {
        "feed_names": list(feed_names),
        "fetch_names": fetch_names,
        "frozen": True,
    }
    if quant_meta is not None:
        meta["quantization"] = quant_meta
    with open(os.path.join(dirname, "__meta__.json"), "w") as f:
        json.dump(meta, f)
    arrays = {}
    gb = program.desc.global_block()
    for name, vd in gb.vars.items():
        if not vd.persistable or name in ("feed", "fetch"):
            continue
        val = scope.get(name)
        if val is not None:
            arrays[name] = (val.detach().cpu().numpy()
                            if isinstance(val, torch.Tensor)
                            else np.asarray(val))
    np.savez(os.path.join(dirname, "__combined__.npz"), **arrays)
    _remove_aot(dirname)
    return sorted(arrays)


def load_frozen_model(dirname, scope=None, place=None):
    """Inverse of save_frozen_model (io.py:292); loads the params into the
    GIVEN scope (default global) as host arrays, which an executor moves
    to its device at their first use, or as tensors on ``place`` when
    given. Returns (program, feed_names, fetch_names, meta)."""
    scope = scope if scope is not None else _scope()
    with open(os.path.join(dirname, "__model__"), "rb") as f:
        program = program_from_desc(ProgramDescData.parse_from_string(f.read()))
    program._is_test = True
    with open(os.path.join(dirname, "__meta__.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(dirname, "__combined__.npz")) as data:
        for name in data.files:
            value = data[name]
            if place is not None:
                value = torch.from_numpy(value).to(place.torch_device())
            scope.set(name, value)
    return program, meta["feed_names"], meta["fetch_names"], meta


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None, pserver_endpoints=None):
    """(io.py:318) Returns (program, feed_names, fetch_vars); the
    persistables land in the global scope on the executor's device. With
    ``pserver_endpoints`` they are refreshed from the RUNNING pservers
    after the disk load (reference: io.py load_inference_model's
    endpoints path for distributed increment)."""
    with open(os.path.join(dirname, model_filename or "__model__"), "rb") as f:
        program = program_from_desc(ProgramDescData.parse_from_string(f.read()))
    program._is_test = True
    with open(os.path.join(dirname, "__meta__.json")) as f:
        meta = json.load(f)
    load_persistables(executor, dirname, program, filename=params_filename)
    if pserver_endpoints:
        _refresh_from_pservers(program, executor, list(pserver_endpoints))
    fetch_vars = [program.global_block().var(n) for n in meta["fetch_names"]]
    return program, meta["feed_names"], fetch_vars


def _refresh_from_pservers(program, executor, endpoints):
    """Each persistable of ``program`` a running pserver hosts, pulled
    into the global scope on the executor's device (a read-only client:
    it takes no trainer's completion slot)."""
    from paddle_tpu_torch.distributed.ps import PSClient, _assign

    scope = _scope()
    client = PSClient(endpoints)
    try:
        for name, vd in program.desc.global_block().vars.items():
            if not vd.persistable or name in ("feed", "fetch"):
                continue
            for ep in endpoints:
                try:
                    val = client.get_var(ep, name)
                except OSError:
                    # a server raises a typed RpcError for names it does
                    # not own (e.g. sliced params living under block
                    # names) — keep the disk-loaded value then
                    continue
                if len(val.shape) == 0:
                    continue
                _assign(scope, name, val, executor.device)
                break
    finally:
        client.close()
