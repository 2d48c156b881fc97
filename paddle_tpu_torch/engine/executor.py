"""Engine: runs a block's ops eagerly on one device.

A minimal port of ``paddle_tpu/engine/executor.py`` ``Engine``: feeds go
numpy -> device tensors, persistable state is read from the scope and
(unless the program runs as a test program, or the caller passes
``state_writeback=False``) written back, fetches come back as numpy
arrays, and each run gets the (seed, run_counter) RNG pair of the
reference (executor.py:300-305, :1036). The JAX engine's executable
cache, transform passes, mesh path, dispatch window and telemetry are
later slices (ROADMAP Queue 1: the engine features); the only
per-program cache here is the analyzed ``BlockProgram``, which depends
only on the block, its feeds and its fetches.

An engine may be driven from several threads at once (a serving worker
beside a caller's direct run): the cache and the run counter are taken
under a lock, and each run keeps its values in its own environment.
"""

import collections
import threading

import numpy as np
import torch

from paddle_tpu_torch.core.types import convert_dtype_to_np
from paddle_tpu_torch.observability import health
from paddle_tpu_torch.engine.lowering import BlockProgram, lower_block

_BLOCK_CACHE_SIZE = 64


class Engine:
    """One engine per Executor, bound to one place's device."""

    def __init__(self, place):
        self.place = place
        self.device = place.torch_device()
        self._run_counter = 0
        self._blocks = collections.OrderedDict()
        self._lock = threading.Lock()

    def run_block(self, program_desc, block_idx, scope, feed=None,
                  fetch_list=None, is_test=False, return_numpy=True,
                  seed=0, opt_level=None, cache_key_extra=None,
                  donate_state=True, state_writeback=None):
        """Run block ``block_idx`` once. ``state_writeback`` (default:
        not ``is_test``) writes the persistable outputs back into the
        scope; ``False`` never does, as serving needs (the scope stays
        immutable under concurrent callers). ``donate_state`` is
        accepted for the JAX engine's signature: the port donates
        nothing yet (ROADMAP Queue 1 item 4). ``cache_key_extra`` is the
        JAX engine's per-bucket executable tag: accepted, and the seam
        for per-key state such as a captured CUDA graph (Queue 1 item
        4); the analysis it would key is the same for every tag, so
        nothing is cached under it yet."""
        if opt_level not in (None, 0):
            raise NotImplementedError(
                "opt_level=%r: the port runs the desc as given (level 0); "
                "the transform passes are ROADMAP Queue 1, analysis and "
                "transforms" % (opt_level,))
        feed = feed or {}
        fetch_list = list(fetch_list or [])
        block = program_desc.block(block_idx)
        feed_names = sorted(feed)
        bp = self._block_program(program_desc, block_idx, feed_names,
                                 fetch_list)
        feed_values = [self._feed_tensor(block, n, feed[n])
                       for n in feed_names]
        state_values = [self._state_value(scope, n)
                        for n in bp.state_in_names]
        with self._lock:
            self._run_counter += 1
            run_counter = self._run_counter
        fn = lower_block(bp, self.device, is_test=is_test, executor=self)
        with torch.no_grad():
            fetches, state_out = fn(feed_values, state_values,
                                    (int(seed), run_counter))
        if state_writeback is None:
            state_writeback = not is_test
        if state_writeback:
            for name, val in zip(bp.state_out_names, state_out):
                scope.set(name, val)
        # liveness: the heartbeat reports this counter
        health.note_step()
        if return_numpy:
            return [t.cpu().numpy() for t in fetches]
        return fetches

    def _block_program(self, program_desc, block_idx, feed_names,
                       fetch_list):
        key = (program_desc.cached_fingerprint(), block_idx,
               tuple(feed_names), tuple(fetch_list))
        with self._lock:
            bp = self._blocks.get(key)
            if bp is not None:
                self._blocks.move_to_end(key)
                return bp
        bp = BlockProgram(program_desc.block(block_idx), feed_names,
                          fetch_list)
        with self._lock:
            bp = self._blocks.setdefault(key, bp)
            if len(self._blocks) > _BLOCK_CACHE_SIZE:
                self._blocks.popitem(last=False)
        return bp

    def _feed_tensor(self, block, name, value):
        """Host value -> tensor on the device, coerced to the feed var's
        declared dtype; a tensor already on the device passes through."""
        if isinstance(value, torch.Tensor):
            return value.to(self.device)
        vd = block.find_var_recursive(name)
        if vd is not None and vd.dtype is not None:
            value = np.asarray(value, dtype=convert_dtype_to_np(vd.dtype))
        else:
            value = np.asarray(value)
        return torch.from_numpy(np.ascontiguousarray(value)).to(self.device)

    def _state_value(self, scope, name):
        val = scope.get(name)
        if val is None:
            raise RuntimeError(
                "Variable %r is used before initialization; run the startup "
                "program first (reference semantics: PADDLE_ENFORCE "
                "holder_ != nullptr, paddle/fluid/framework/tensor.h)" % name
            )
        if not isinstance(val, torch.Tensor):
            # a host array set into the scope moves to the device once
            val = torch.from_numpy(np.ascontiguousarray(val)).to(self.device)
            scope.set(name, val)
        elif val.device != self.device:
            raise RuntimeError(
                "Variable %r lives on %s but this executor runs on %s"
                % (name, val.device, self.device))
        return val
