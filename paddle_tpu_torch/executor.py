"""Executor — the user-facing run loop (reference:
python/paddle/fluid/executor.py — Executor:262, run:451). Port of
``paddle_tpu/executor.py``: ``Executor``, ``global_scope`` and
``scope_guard``. ``Executor()`` runs on ``CUDAPlace(0)`` and raises when
CUDA is missing; a caller asks for the CPU with ``Executor(CPUPlace())``.
"""

import contextlib

import numpy as np
import torch

from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.engine.executor import Engine
from paddle_tpu_torch.framework import default_main_program
from paddle_tpu_torch.platform import default_place

_global_scope = Scope()


def global_scope():
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope):
    global _global_scope
    old = _global_scope
    _global_scope = scope
    try:
        yield
    finally:
        _global_scope = old


def _as_feed_dict(feed):
    if feed is None:
        return {}
    if isinstance(feed, dict):
        return {
            k: v if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in feed.items()
        }
    raise TypeError("feed must be a dict of name -> ndarray")


class Executor:
    def __init__(self, place=None):
        self.place = place if place is not None else default_place()
        self.engine = Engine(self.place)

    @property
    def device(self):
        return self.engine.device

    def close(self):
        """Graceful shutdown (reference: executor.py close)."""
        self.engine._blocks.clear()

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True, opt_level=None):
        """Run block 0 of ``program`` (default: the default main program)
        with ``feed`` {name: array}, returning the ``fetch_list`` values
        (numpy arrays, or device tensors with ``return_numpy=False``).
        The port runs the desc as given, which is ``opt_level`` 0; any other
        level raises."""
        scope = scope if scope is not None else global_scope()
        if program is None:
            program = default_main_program()
        fetch_names = [
            f.name if hasattr(f, "name") else str(f)
            for f in (fetch_list or [])
        ]
        return self.engine.run_block(
            program.desc, 0, scope,
            feed=_as_feed_dict(feed),
            fetch_list=fetch_names,
            is_test=getattr(program, "_is_test", False),
            return_numpy=return_numpy,
            seed=getattr(program, "random_seed", 0) or 0,
            opt_level=opt_level,
        )
