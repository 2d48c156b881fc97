"""Device meshes — port of ``paddle_tpu/parallel/mesh.py``.

The reference's mesh is a mesh of devices that one process drives; here
it is a ``torch.distributed`` ``DeviceMesh`` of the world's ranks, one
process a rank (one card a rank under NCCL). The axis
names and their order are the reference's: the innermost axis maps to
adjacent ranks. A mesh is made once for each (device type, axes, ranks)
and reused, since making one creates its process groups on every rank.
"""

import contextlib
import threading

import numpy as np
import torch
import torch.distributed as dist

_default_mesh = None
_meshes = {}
_meshes_lock = threading.Lock()


def _ensure_world(device_type):
    """The process group this process's meshes live in: the launcher's
    world (``parallel.env``) when it names more than one process, else a
    one-rank group held in memory."""
    from paddle_tpu_torch.parallel import env

    if not dist.is_initialized():
        if env.get_world_info()["world_size"] > 1:
            env.init_distributed(device_type=device_type)
        else:
            env.init_single_process(device_type)


def _available_devices(device_type="cuda"):
    """The ranks meshes plan over: every rank of the world. (The elastic
    registry that drops lost devices is ROADMAP Queue 1 item 11.)"""
    _ensure_world(device_type)
    return list(range(dist.get_world_size()))


def make_mesh(axes, devices=None, device_type="cuda"):
    """``make_mesh({'dp': 2, 'tp': 4}) -> DeviceMesh`` over the first
    dp*tp ranks (``devices``, default every rank of the world), ordered
    so the innermost axis maps to adjacent ranks. ``device_type`` is
    ``cuda`` (the default: the card) or ``cpu``."""
    from torch.distributed.device_mesh import DeviceMesh

    if not axes:
        raise ValueError("axes must be a non-empty {name: size} dict")
    names = list(axes.keys())
    sizes = [int(axes[n]) for n in names]
    n_needed = int(np.prod(sizes))
    devices = list(devices if devices is not None
                   else _available_devices(device_type))
    if len(devices) < n_needed:
        raise ValueError(
            "mesh %r needs %d devices, have %d" % (axes, n_needed,
                                                   len(devices)))
    ranks = tuple(int(d) for d in devices[:n_needed])
    key = (device_type, tuple(names), tuple(sizes), ranks)
    with _meshes_lock:
        mesh = _meshes.get(key)
        if mesh is None:
            _ensure_world(device_type)
            mesh = DeviceMesh(device_type,
                              torch.tensor(ranks).reshape(sizes),
                              mesh_dim_names=tuple(names))
            _meshes[key] = mesh
    return mesh


def parse_mesh_spec(spec, devices=None):
    """``"dp=4,tp=2" -> {"dp": 4, "tp": 2}`` (the PADDLE_GPU_MESH
    grammar). ``"dp=-1"`` means every rank left over (of ``devices``,
    default the world's) and may appear on at most one axis."""
    axes = {}
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                "bad mesh spec %r: want name=size[,name=size...]" % spec)
        name, size = part.split("=", 1)
        axes[name.strip()] = int(size)
    if not axes:
        raise ValueError("empty mesh spec %r" % spec)
    wild = [n for n, s in axes.items() if s == -1]
    if len(wild) > 1:
        raise ValueError("mesh spec %r has more than one -1 axis" % spec)
    if wild:
        fixed = int(np.prod([s for s in axes.values() if s != -1]))
        n_dev = len(devices if devices is not None
                    else _available_devices())
        if n_dev % fixed:
            raise ValueError(
                "mesh spec %r: %d devices not divisible by fixed axes %d"
                % (spec, n_dev, fixed))
        axes[wild[0]] = n_dev // fixed
    return axes


def mesh_from_flag(device_type="cuda"):
    """The mesh the ``PADDLE_GPU_MESH`` flag declares (``dp=4,tp=2``, or
    ``dp=-1`` for every rank data-parallel) on ``device_type``, or None
    when the flag is unset: the entry to the mesh path with no code
    change."""
    from paddle_tpu_torch import flags

    spec = flags.get_flag("mesh")
    if not spec:
        return None
    devices = _available_devices(device_type)
    return make_mesh(parse_mesh_spec(spec, devices), devices=devices,
                     device_type=device_type)


def axis_sizes(mesh):
    """{axis name: size} of a mesh, in the mesh's order."""
    return {str(n): int(s) for n, s in zip(mesh.mesh_dim_names,
                                            mesh.mesh.shape)}


def mesh_signature(mesh):
    """Hashable identity of a mesh for the engine's cache key: the axis
    names with their sizes, the ranks in mesh order and the device type
    (two meshes of one shape over other ranks never share an entry)."""
    if mesh is None:
        return None
    return (tuple(axis_sizes(mesh).items()),
            tuple(int(r) for r in mesh.mesh.flatten().tolist()),
            str(mesh.device_type))


# --- SPMD lowering context -------------------------------------------------
# Set by the engine around a block run over a mesh, so mesh-aware lowerings
# (the flash dispatch's per-shard seed, ring attention's default mesh) see
# which axes exist without a mesh argument in every lowering's signature.
# Thread-local: a serving worker and a direct caller each see their own.
_spmd_ctx = threading.local()


@contextlib.contextmanager
def spmd_lowering(mesh, data_axes=("dp",)):
    """Declare the (mesh, data_axes) a block runs under. No-op when
    ``mesh`` is None."""
    if mesh is None:
        yield
        return
    prev = getattr(_spmd_ctx, "value", None)
    _spmd_ctx.value = (mesh, tuple(data_axes))
    try:
        yield
    finally:
        _spmd_ctx.value = prev


def current_spmd():
    """The active (mesh, data_axes) set by ``spmd_lowering``, or None
    outside any mesh run."""
    return getattr(_spmd_ctx, "value", None)


def set_default_mesh(mesh):
    global _default_mesh
    _default_mesh = mesh


def get_default_mesh(device_type="cuda"):
    """The ambient mesh: the one set with ``set_default_mesh``, else a
    1-D 'dp' mesh over every rank of the world."""
    if _default_mesh is not None:
        return _default_mesh
    return make_mesh({"dp": len(_available_devices(device_type))},
                     device_type=device_type)
