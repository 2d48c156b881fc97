"""AOT-serialized inference artifacts — port of ``paddle_tpu/aot.py``
(reference: inference/api/analysis_predictor.cc:391,734 — the deploy
path loads a frozen program and runs WITHOUT the Python front-end
re-building it).

The pruned inference program is lowered once (``engine/lowering.py``
``lower_block``), wrapped in a ``torch.nn.Module`` whose buffers are the
program's parameters, and exported with ``torch.export`` (the
reference exports StableHLO), specialized to ``example_feeds``' shapes
and to the device of the scope's values. The load path
(``AotPredictor``) runs the ``torch.export.load``-ed program directly:
no op registry, no Program, no re-lowering.

Artifact layout under the model dir, the reference's file names and
meta format:
    __aot__.stablehlo     torch.export.save of the exported program
                          (parameters embedded); the name is the
                          reference's, the payload a torch program, so
                          an artifact of either package does not load
                          in the other (the native files beside it do)
    __aot_meta__.json     {"feed_names": [...], "fetch_names": [...],
                           "feeds": {name: {"shape", "dtype"}}}

A lowering that reads a device value on the host (``.item()``,
``.tolist()``) cannot be exported; ``export_aot`` raises with the op's
error then.
"""

import io
import json
import os

import numpy as np
import torch

__all__ = ["export_aot", "AotPredictor", "has_aot_artifact",
           "remove_aot_artifact"]

_AOT_FILE = "__aot__.stablehlo"
_AOT_META = "__aot_meta__.json"


class _FrozenBlock(torch.nn.Module):
    """The lowered block with the program's state as buffers: the module
    ``torch.export`` traces."""

    def __init__(self, fn, state):
        super().__init__()
        self._fn = fn
        self._n = len(state)
        for i, t in enumerate(state):
            self.register_buffer("state_%d" % i, t)

    def forward(self, *feeds):
        state = [getattr(self, "state_%d" % i) for i in range(self._n)]
        fetches, _ = self._fn(list(feeds), state, (0, 0), None)
        return tuple(fetches)


def _device_of(scope, names):
    for n in names:
        v = scope.get(n)
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device("cpu")


def export_aot(dirname, feeded_var_names, fetch_names, program, scope,
               example_feeds, device=None):
    """Lower the (already pruned, is_test) ``program`` and serialize it.

    ``example_feeds``: {name: array-like} fixing each feed's shape and
    dtype — the exported program is specialized to these shapes, like
    the reference predictor's fixed-shape deployment artifacts, and to
    ``device`` (default: where the scope holds the program's state).
    """
    from paddle_tpu_torch.engine.lowering import BlockProgram, lower_block

    missing = [n for n in feeded_var_names if n not in example_feeds]
    if missing:
        raise ValueError(
            "export_format='aot' needs example_feeds for every feed var "
            "to fix the exported shapes; missing %s" % missing)

    bp = BlockProgram(program.desc.global_block(), list(feeded_var_names),
                      list(fetch_names), [])
    device = torch.device(device) if device is not None else _device_of(
        scope, bp.state_in_names)
    fn = lower_block(bp, device, is_test=True)
    state = []
    for n in bp.state_in_names:
        v = scope.get(n)
        if v is None:
            raise RuntimeError(
                "var %r has no value in the scope; run startup/load "
                "before exporting" % n)
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.ascontiguousarray(v))
        state.append(v.detach().to(device).clone())

    args = []
    meta_feeds = {}
    for n in feeded_var_names:
        a = example_feeds[n]
        a = (a.detach() if isinstance(a, torch.Tensor)
             else torch.from_numpy(np.ascontiguousarray(np.asarray(a))))
        args.append(a.to(device))
        meta_feeds[n] = {"shape": list(a.shape),
                         "dtype": str(a.dtype).replace("torch.", "")}

    with torch.no_grad():
        exported = torch.export.export(_FrozenBlock(fn, state), tuple(args),
                                       strict=False)
    os.makedirs(dirname, exist_ok=True)
    # through a buffer: torch.export names its archives *.pt2, the file
    # keeps the reference's name
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    with open(os.path.join(dirname, _AOT_FILE), "wb") as f:
        f.write(buf.getvalue())
    with open(os.path.join(dirname, _AOT_META), "w") as f:
        json.dump({"feed_names": list(feeded_var_names),
                   "fetch_names": list(fetch_names),
                   "feeds": meta_feeds}, f)
    return fetch_names


def has_aot_artifact(dirname):
    return (os.path.exists(os.path.join(dirname, _AOT_FILE))
            and os.path.exists(os.path.join(dirname, _AOT_META)))


def remove_aot_artifact(dirname):
    for f in (_AOT_FILE, _AOT_META):
        try:
            os.remove(os.path.join(dirname, f))
        except OSError:
            pass


class AotPredictor:
    """Executes a serialized AOT artifact — never touches the op
    registry or the Program machinery (the 'without the Python
    front-end' property of analysis_predictor.cc's load path)."""

    def __init__(self, dirname):
        with open(os.path.join(dirname, _AOT_META)) as f:
            self._meta = json.load(f)
        with open(os.path.join(dirname, _AOT_FILE), "rb") as f:
            self._exported = torch.export.load(io.BytesIO(f.read()))
        self._module = self._exported.module()
        devices = {t.device for t in list(self._exported.state_dict.values())
                   + list(self._exported.constants.values())
                   if isinstance(t, torch.Tensor)}
        self.device = devices.pop() if len(devices) == 1 \
            else torch.device("cpu")
        self.platforms = (self.device.type,)

    def runs_on(self, backend):
        """Whether the artifact was exported for ``backend`` ("cpu" or
        "cuda"): an exported program is device-specialized."""
        return backend in self.platforms

    @property
    def feed_names(self):
        return list(self._meta["feed_names"])

    @property
    def fetch_names(self):
        return list(self._meta["fetch_names"])

    def run(self, feed):
        """feed: {name: array-like} at the exported shapes/dtypes; returns
        numpy arrays."""
        args = []
        for n in self._meta["feed_names"]:
            spec = self._meta["feeds"][n]
            v = feed[n]
            if not isinstance(v, torch.Tensor):
                v = torch.from_numpy(np.ascontiguousarray(
                    np.asarray(v, dtype=np.dtype(spec["dtype"]))))
            if list(v.shape) != spec["shape"]:
                raise ValueError(
                    "feed %r shape %s != exported shape %s (the AOT "
                    "artifact is shape-specialized)"
                    % (n, list(v.shape), spec["shape"]))
            args.append(v.to(self.device, non_blocking=True))
        with torch.no_grad():
            outs = self._module(*args)
        return [o.detach().cpu().numpy() for o in outs]
