"""Engine: runs a block on one device, from a cache of compiled blocks.

Port of ``paddle_tpu/engine/executor.py`` ``Engine``: feeds go numpy ->
device tensors, persistable state is read from the scope and (unless the
program runs as a test program, or the caller passes
``state_writeback=False``) written back, fetches come back as numpy
arrays, and each run gets the (seed, run_counter) RNG pair of the
reference (executor.py:300-305, :1036).

Where the JAX engine keeps one jitted executable per cache key
(``get_compiled``, :584), this engine keeps one ``CompiledBlock`` per key
in an LRU of ``executable_cache_size`` entries: the analyzed block, its
static feed buffers and its seed table and, on CUDA, one captured
``torch.cuda.CUDAGraph`` of the whole block. The key is the reference's,
restricted to what the port has: the program's fingerprint, the block,
the feeds' names, shapes and dtypes, the fetches, ``is_test``,
``donate_state``, ``amp`` and ``cache_key_extra``; the port adds
``state_writeback`` and whether the block is captured, which change what
the entry runs.

On CUDA the first run of a key runs eagerly, op by op, on a side stream
(the warm-up: it loads the kernel libraries, creates the cuBLAS handles
and grows the caching allocator); the second captures the block in one
graph and replays it; every later run replays it. The graphs of one
engine share one memory pool and replay one at a time. Feeds are copied
into the entry's static buffers, the run's dropout seeds into its seed
table (one host-to-device copy), and fetches out of the graph's outputs
before the call returns. With ``donate_state`` (the analogue of
``donate_argnums``, :1069) the persistable outputs are copied in place
into the scope's own tensors, inside the graph, so the scope keeps the
same tensors from step to step. A graph holds the addresses of the
tensors it was captured against; when the scope holds another tensor for
one of them (``scope.set``, ``convert.load_numpy_state``, a second
startup run) the entry captures again (``engine.recapture``). Whether a
block can be captured is read from its desc (``BlockProgram.capturable``);
a block that cannot, a run with ``donate_state=False`` that writes
state back, or any run of an engine whose ``cuda_graphs`` is off, runs
eagerly under its key (``engine.eager_runs``). On the
CPU the same entry runs its function over the same buffers, with no
graph.

``check_nan_inf`` checks every state and fetch tensor after the step and
raises with the reference's message (``_check_finite``, :1183).

A CUDA engine turns on cuDNN's deterministic algorithms and turns off its
autotuner (``_deterministic_cudnn``), so that repeated steps, and a
captured step against its eager run, agree bit for bit.

An engine may be driven from several threads at once (a serving worker
beside a caller's direct run): the caches and the run counter are taken
under a lock, an entry runs under its own lock, and the captured graphs
under the engine's, which covers the copy-in, the replay and the
copy-out.
"""

import collections
import threading

import numpy as np
import torch

from paddle_tpu_torch import flags
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.core.types import convert_dtype_to_np
from paddle_tpu_torch.engine.lowering import BlockProgram, lower_block
from paddle_tpu_torch.kernels import flash_attention as _fa
from paddle_tpu_torch.observability import health

_BLOCK_CACHE_SIZE = 64


class CompiledBlock:
    """One cache entry: a block lowered for one key, with its static feed
    buffers and seed table and, when ``capture`` is set, its CUDA graph
    (reference: ``CompiledBlock``, executor.py:48)."""

    def __init__(self, engine, block_program, feed_specs, is_test, amp,
                 donate_state, state_writeback, capture):
        self.engine = engine
        self.block_program = block_program
        self.device = engine.device
        self.fn = lower_block(block_program, engine.device, is_test=is_test,
                              executor=engine, amp=amp)
        self.donate_state = donate_state
        self.state_writeback = state_writeback
        self.capture = capture
        self.lock = threading.Lock()
        self.feed_bufs = [torch.empty(shape, dtype=dtype, device=self.device)
                          for _, shape, dtype in feed_specs]
        # a test run draws no seed (its dropout is off)
        slots = [] if is_test else block_program.rng_slots
        self.seed_buf = torch.zeros(len(slots), dtype=torch.int64,
                                    device=self.device)
        self.seeds = {rng_id: self.seed_buf[i]
                      for i, (rng_id, _) in enumerate(slots)}
        self.graph = None
        # what the graph returns (fetches, state outputs), in its pool
        self.outs = None
        # the scope tensors the graph was captured against
        self.bound = None
        # flash-kernel launches of one replay, recorded while capturing
        self.launches = None
        self.captures = 0
        self.replays = 0
        # (shape, dtype) of each state output, from the first (eager) run;
        # on CUDA the second run captures
        self._out_specs = None

    # -- one run -----------------------------------------------------------
    def run(self, scope, feed_values, rng_seed, return_numpy):
        """Run the block once; returns the fetches (numpy arrays, or
        tensors that no later run changes)."""
        step = rng_seed[1]
        if not self.capture:
            if self.device.type == "cuda":
                obs.inc("engine.eager_runs")
            with self.lock, obs.span("run", step=step), \
                    obs.time_block("engine.run_ms"):
                return self._run_eager(scope, feed_values, rng_seed,
                                       return_numpy)
        with self.engine._graph_lock:
            state, dsts = self._scope_tensors(scope)
            if not self._bindable(dsts):
                with obs.span("run", step=step), \
                        obs.time_block("engine.run_ms"):
                    return self._warm_up(scope, feed_values, rng_seed,
                                         return_numpy)
            if self.graph is None or any(
                    a is not b for a, b in zip(self.bound, state + dsts)):
                if self.graph is not None:
                    obs.inc("engine.recapture")
                # "compile" is the run that captures
                with obs.span("compile", step=step), \
                        obs.time_block("engine.compile_ms"):
                    self._capture(state, dsts, feed_values, rng_seed)
                    return self._replay(feed_values, rng_seed, return_numpy)
            with obs.span("run", step=step), \
                    obs.time_block("engine.run_ms"):
                return self._replay(feed_values, rng_seed, return_numpy)

    def _fill(self, feed_values, rng_seed):
        """Copy the run's feeds into the static buffers and its seeds into
        the seed table."""
        for buf, value in zip(self.feed_bufs, feed_values):
            if not isinstance(value, torch.Tensor):
                value = torch.from_numpy(value)
            buf.copy_(value)
        if self.seeds:
            values = self.block_program.seed_values(*rng_seed)
            self.seed_buf.copy_(torch.tensor(values, dtype=torch.int64))

    def _scope_tensors(self, scope):
        """(state inputs, write-back targets): the scope's tensors that the
        block reads, and those it writes in place (None where the scope
        holds none)."""
        state = [self.engine._state_value(scope, n)
                 for n in self.block_program.state_in_names]
        dsts = []
        if self.state_writeback and self.donate_state:
            dsts = [scope.get(n) for n in self.block_program.state_out_names]
        return state, dsts

    def _bindable(self, dsts):
        """Whether a graph may be captured now: after the warm-up run, with
        every write-back target a tensor on this device of the shape and
        dtype the block writes (the warm-up set them)."""
        if self._out_specs is None:
            return False
        return all(isinstance(d, torch.Tensor) and d.device == self.device
                   and (tuple(d.shape), d.dtype) == s
                   for d, s in zip(dsts, self._out_specs))

    def _body(self, state, dsts, rng_seed):
        """The block, then the fetches made safe from later runs and the
        state written back in place; returns (fetches, state outputs)."""
        fetches, state_out = self.fn(self.feed_bufs, state, rng_seed,
                                     self.seeds)
        held = {t.untyped_storage().data_ptr()
                for t in list(state) + self.feed_bufs
                + [d for d in dsts if isinstance(d, torch.Tensor)]}

        def unalias(t, dst=None):
            # a value living in a buffer that this or a later run writes
            # (a feed, a state tensor) is copied out first
            if t is dst or t.untyped_storage().data_ptr() not in held:
                return t
            return t.clone()

        fetches = [unalias(t) for t in fetches]
        if dsts:
            state_out = [unalias(v, d) for v, d in zip(state_out, dsts)]
            for i, (v, d) in enumerate(zip(state_out, dsts)):
                if v is d:
                    continue
                if (isinstance(d, torch.Tensor) and d.device == v.device
                        and d.shape == v.shape and d.dtype == v.dtype):
                    d.copy_(v)
                    state_out[i] = d
        return fetches, state_out

    def _run_eager(self, scope, feed_values, rng_seed, return_numpy):
        state, dsts = self._scope_tensors(scope)
        self._fill(feed_values, rng_seed)
        with torch.no_grad():
            fetches, state_out = self._body(state, dsts, rng_seed)
        self._out_specs = [(tuple(v.shape), v.dtype) for v in state_out]
        self._finish_state(scope, state_out, rng_seed)
        return self._fetch_out(fetches, rng_seed, return_numpy, copy=False)

    def _finish_state(self, scope, state_out, rng_seed):
        bp = self.block_program
        if self.engine.check_nan_inf:
            _check_finite(zip(bp.state_out_names, state_out),
                          step=rng_seed[1], kind="state")
        if not self.state_writeback:
            # a served program re-emits state it read unchanged; the
            # scope stays immutable under concurrent submitters
            return
        for name, val in zip(bp.state_out_names, state_out):
            if scope.get(name) is not val:
                scope.set(name, val)

    def _fetch_out(self, fetches, rng_seed, return_numpy, copy):
        if self.engine.check_nan_inf:
            _check_finite(zip(self.block_program.fetch_names, fetches),
                          step=rng_seed[1], kind="fetch")
        if return_numpy:
            return [_to_numpy(t) for t in fetches]
        if not copy:
            return fetches
        out = [t.clone() for t in fetches]
        # the next replay, from any thread, overwrites the graph's outputs
        torch.cuda.current_stream(self.device).synchronize()
        return out

    def _warm_up(self, scope, feed_values, rng_seed, return_numpy):
        """An eager run on a side stream, as a capture needs before it."""
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self._run_eager(scope, feed_values, rng_seed,
                                  return_numpy)
            side.synchronize()
        cur.wait_stream(side)
        if not return_numpy:
            for t in out:
                t.record_stream(cur)
        return out

    def _capture(self, state, dsts, feed_values, rng_seed):
        """Capture the block in one graph against the scope's tensors
        ``state`` and ``dsts``; a capture that fails raises."""
        self._fill(feed_values, rng_seed)
        self.graph = self.outs = self.bound = None
        graph = torch.cuda.CUDAGraph()
        # thread_local: other threads (the serving worker, a direct
        # caller) may run eagerly on the card while this one captures
        with _fa.record_launches() as launches, torch.no_grad():
            with torch.cuda.graph(graph, pool=self.engine._graph_pool(),
                                  capture_error_mode="thread_local"):
                outs = self._body(state, dsts, rng_seed)
        self.graph, self.outs, self.launches = graph, outs, dict(launches)
        self.bound = list(state) + list(dsts)
        self.captures += 1
        obs.inc("engine.captures")

    def _replay(self, feed_values, rng_seed, return_numpy):
        self._fill(feed_values, rng_seed)
        self.graph.replay()
        _fa.add_launches(self.launches)
        self.replays += 1
        obs.inc("engine.replays")
        fetches, state_out = self.outs
        if self.engine.check_nan_inf:
            _check_finite(zip(self.block_program.state_out_names, state_out),
                          step=rng_seed[1], kind="state")
        return self._fetch_out(fetches, rng_seed, return_numpy, copy=True)


class Engine:
    """One engine per Executor, bound to one place's device."""

    def __init__(self, place):
        self.place = place
        self.device = place.torch_device()
        self._run_counter = 0
        self._blocks = collections.OrderedDict()
        self._cache = collections.OrderedDict()
        self._lock = threading.Lock()
        self._graph_lock = threading.RLock()
        self._pool = None
        # on CUDA, capture each block that can be captured; False runs
        # every block eagerly, op by op (for comparing the two)
        self.cuda_graphs = True
        # debug guard (reference: FLAGS_check_nan_inf), read once
        self.check_nan_inf = bool(flags.get_flag("check_nan_inf"))
        if self.device.type == "cuda":
            _deterministic_cudnn()

    def _graph_pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def close(self):
        """Drop the cached blocks and their graphs."""
        with self._graph_lock, self._lock:
            self._cache.clear()
            self._blocks.clear()

    def run_block(self, program_desc, block_idx, scope, feed=None,
                  fetch_list=None, is_test=False, return_numpy=True,
                  seed=0, opt_level=None, cache_key_extra=None,
                  donate_state=True, state_writeback=None, amp=False):
        """Run block ``block_idx`` once. ``state_writeback`` (default:
        not ``is_test``) writes the persistable outputs back into the
        scope, in place with ``donate_state``; ``False`` never does, as
        serving needs (the scope stays immutable under concurrent
        callers). ``cache_key_extra`` tags the cache entry (the server's
        bucket: one graph per bucket); ``amp`` runs the ops under
        bfloat16 AMP."""
        with obs.span("step", step=self._run_counter + 1), \
                obs.time_block("engine.step_ms"):
            out = self._run_block_impl(
                program_desc, block_idx, scope, feed, fetch_list, is_test,
                return_numpy, seed, opt_level, cache_key_extra,
                donate_state, state_writeback, amp)
        # liveness: the heartbeat reports this counter
        health.note_step()
        return out

    def _run_block_impl(self, program_desc, block_idx, scope, feed,
                        fetch_list, is_test, return_numpy, seed, opt_level,
                        cache_key_extra, donate_state, state_writeback,
                        amp):
        if opt_level not in (None, 0):
            raise NotImplementedError(
                "opt_level=%r: the port runs the desc as given (level 0); "
                "the transform passes are ROADMAP Queue 1, analysis and "
                "transforms" % (opt_level,))
        feed = feed or {}
        fetch_list = list(fetch_list or [])
        if state_writeback is None:
            state_writeback = not is_test
        block = program_desc.block(block_idx)
        feed_names = sorted(feed)
        feed_values = [self._feed_value(block, n, feed[n])
                       for n in feed_names]
        compiled = self.get_compiled(
            program_desc, block_idx, feed_names, feed_values, fetch_list,
            bool(is_test), bool(donate_state), bool(amp), cache_key_extra,
            bool(state_writeback))
        with self._lock:
            self._run_counter += 1
            run_counter = self._run_counter
        return compiled.run(scope, feed_values, (int(seed), run_counter),
                            return_numpy)

    def get_compiled(self, program_desc, block_idx, feed_names, feed_values,
                     fetch_list, is_test, donate_state, amp,
                     cache_key_extra=None, state_writeback=True):
        """The cached ``CompiledBlock`` of one key, made on a miss; the
        least recently used entry goes past ``executable_cache_size``."""
        specs = tuple((n, tuple(v.shape), _torch_dtype(v))
                      for n, v in zip(feed_names, feed_values))
        bp = self._block_program(program_desc, block_idx, feed_names,
                                 fetch_list)
        capture = (self.device.type == "cuda"
                   and self.cuda_graphs
                   and bp.capturable
                   and (donate_state or not state_writeback))
        key = (program_desc.cached_fingerprint(), block_idx, specs,
               tuple(fetch_list), is_test, donate_state, amp,
               cache_key_extra, state_writeback, capture)
        with self._lock:
            compiled = self._cache.get(key)
            if compiled is not None:
                self._cache.move_to_end(key)
                obs.inc("engine.cache_hit")
                return compiled
        compiled = CompiledBlock(self, bp, specs, is_test, amp,
                                 donate_state, state_writeback, capture)
        with self._lock:
            if key in self._cache:
                obs.inc("engine.cache_hit")
                return self._cache[key]
            obs.inc("engine.cache_miss")
            self._cache[key] = compiled
            size = max(1, int(flags.get_flag("executable_cache_size")))
            while len(self._cache) > size:
                self._cache.popitem(last=False)
                obs.inc("engine.cache_evict")
        return compiled

    def _block_program(self, program_desc, block_idx, feed_names,
                       fetch_list):
        """The analyzed block, shared by every key with these feeds and
        fetches."""
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

    def _feed_value(self, block, name, value):
        """A feed as a numpy array (or a tensor) of the feed var's
        declared dtype, ready to copy into the entry's static buffer."""
        vd = block.find_var_recursive(name)
        declared = vd.dtype if vd is not None else None
        if isinstance(value, torch.Tensor):
            if declared is not None:
                dtype = _torch_dtype(np.empty(0, convert_dtype_to_np(
                    declared)))
                if value.dtype != dtype:
                    value = value.to(dtype)
            return value
        if declared is not None:
            return np.ascontiguousarray(np.asarray(
                value, dtype=convert_dtype_to_np(declared)))
        return np.ascontiguousarray(np.asarray(value))

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


def _deterministic_cudnn():
    """cuDNN's convolution grads may sum with float atomics, in an order
    that changes from run to run, and its autotuner may pick another
    algorithm for a captured run than for the eager one. The reference's
    steps repeat bit for bit, so the port's CUDA engines take cuDNN's
    deterministic algorithms and no autotuning (process-wide torch
    switches, read at every convolution)."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def _to_numpy(t):
    """A fetch as a numpy array; numpy has no bfloat16, so a bfloat16
    fetch comes back as float32 (exactly)."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _torch_dtype(value):
    if isinstance(value, torch.Tensor):
        return value.dtype
    return torch.from_numpy(np.empty(0, value.dtype)).dtype


def _check_finite(named_values, step=None, kind="tensor"):
    """Raise naming the FIRST non-finite float tensor with its shape,
    dtype, NaN/Inf counts and the step (reference: ``_check_finite``,
    executor.py:1183, and FLAGS_check_nan_inf, framework/operator.cc:972).
    One device reduction and one host read check every tensor; the trip
    is counted and recorded as an event before the raise."""
    named = [(n, v) for n, v in named_values
             if isinstance(v, torch.Tensor) and v.is_floating_point()]
    if not named:
        return
    ok = torch.stack([torch.isfinite(v).all() for _, v in named])
    if bool(ok.all()):
        return
    for (name, val), good in zip(named, ok.tolist()):
        if good:
            continue
        n_nan = int(torch.isnan(val).sum())
        n_inf = int(torch.isinf(val).sum())
        dtype = str(val.dtype).replace("torch.", "")
        obs.inc("engine.nan_inf_trips")
        obs.event("nan_inf_trip", var=name, kind=kind,
                  shape=str(tuple(val.shape)), dtype=dtype, step=step,
                  nan=n_nan, inf=n_inf)
        raise RuntimeError(
            "check_nan_inf: %s %r (shape %s, dtype %s) contains "
            "%d NaN / %d Inf value(s) after step %s (reference: "
            "FLAGS_check_nan_inf, framework/operator.cc:972)"
            % (kind, name, tuple(val.shape), dtype, n_nan, n_inf,
               "?" if step is None else step))
