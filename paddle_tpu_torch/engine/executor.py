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
``donate_state``, ``amp``, ``cache_key_extra``, ``opt_level``, the
memory budget (level 3) and the layout key; the port adds ``state_writeback`` and whether the engine may capture the
block, which change what the entry runs. A hit reads the key alone; the
transforms and the analysis of the block run at a miss.

The desc that runs is the one the transform pipeline returns
(``analysis.optimize_program``, the reference's cache-miss seam,
executor.py:670-687): at ``opt_level`` 1, the default, an unfused
attention composition becomes ``fused_attention`` and
``fused_attention_grad``, which launch the flash kernels. It runs once
for each (program, block, feeds, fetches, liveness roots, level), when
the block is first analyzed; the key stays the ORIGINAL desc's
fingerprint, and the block's seed table is sized from the desc that
runs. With ``verify`` (or the flag) the static verifier checks that desc
on every cache miss, before the block is lowered, and raises on ERROR
findings. The ``trace`` spans and ``engine.trace_ms`` time the transforms
and the analysis of the block; ``verify`` and ``engine.verify_ms`` the
verifier.

At ``opt_level`` 3 and up the memory budget (``analysis/memory.py``
``hbm_budget_bytes``) is part of the key, and at the miss the memory
planner runs on the transformed desc (crash-isolated, counted in
``memory.plan_crashes``); a training step
with no accumulation and no manual ``remat_segments`` lowers the plan's
remat segment count (auto-remat). On CUDA the entry's first run
measures its peak, ``torch.cuda.max_memory_allocated`` after
``reset_peak_memory_stats``, where the reference reads XLA's compiled
memory stats; a miss beyond ``replan_tolerance`` re-plans and rebuilds
the entry once (``_maybe_replan``), and the rebuilt entry captures anew.
Under the layout pass (``layout`` flag, or level 4) the key holds
(mode, ``id(scope)``) and the entry pins the scope, whose filters the
pass bakes OIHW -> HWIO as new tensors: a graph captured against the
old tensors never replays (reference: executor.py:622-641).

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

Fault injection (``resilience/faultinject.py``, ``PADDLE_GPU_FAULT_SPEC``)
has the reference's three engine seams, each one flag read when no spec
is set: ``compile`` at the cache miss, before the transforms (:664-669),
and ``step_fail`` and ``step_nan`` after the step, before the nan/inf
guard (:342-351). A captured step with ``donate_state`` has already
written its state into the scope's tensors, so ``step_nan`` fills those
with NaN in place (and the fetches), before the guard or, in a dispatch
window, before the deferred probes are enqueued: the guard trips at the
step the spec names. ``bitflip`` needs the SDC sentinel (ROADMAP Queue 1
item 11) and raises ``NotImplementedError`` when an entry fires.

``run_block`` also takes the reference's training-loop levers, each part
of the cache key: ``accumulate_steps=k`` (``lower_block_accumulated``: k
micro-batches, one update on the averaged grads), ``remat_segments=s``
(``lower_block_remat``: the forward in s checkpointed segments, the grads
from autograd), which cannot combine (the reference refuses it too), and
``dispatch_steps=N``: up to N steps in flight on the card, each run
returning ``DeferredFetch`` placeholders (``engine/pipeline.py``), the
window drained by ``sync()`` and dropped by ``discard_window()``. Both
lowerings are captured like the plain step. Feeds and the seed table go
to the card from pinned host memory without waiting (a copy from
pageable memory would make the host wait for the card before every
step), so a windowed loop enqueues the next step while the card runs
the last.

With the goodput flag up, an entry's model FLOPs are counted once, on its
first run, with ``FlopCounterMode`` (plus the flash kernels' own count),
and every run notes them; a run that builds an entry (its first run, a
capture) is charged to ``compile``.

Over a mesh (``run_block(mesh=...)``, a ``DeviceMesh`` of this process's
``torch.distributed`` world) an entry carries a ``parallel.plan.MeshPlan``
and its key the mesh's and the rule table's signatures: each rank keeps
its shard of the feeds in the static buffers, the block runs on
``DTensor``s (the scope holds the state at its planned placements), the
fetches come back whole. An entry over NCCL is captured as any other; one
over gloo runs eagerly (``engine.eager`` event: gloo cannot be captured).
At the miss the static SPMD analysis (``analysis/spmd.py``) plans the
entry's collectives on the desc that runs (span ``spmd-plan``, timer
``engine.spmd_plan_ms``, the ``spmd_plan`` event; a crash counts in
``spmd.plan_crashes``), the verifier gets the mesh, and under
``spmd_predict`` with metrics on the entry's first run holds the plan
against the collectives it issued (``spmd.prediction_delta``).

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
import contextlib
import gc
import threading

import numpy as np
import torch

from paddle_tpu_torch import flags
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.core.types import convert_dtype_to_np
from paddle_tpu_torch.engine.lowering import (
    BlockProgram, lower_block, lower_block_accumulated, lower_block_remat,
    remat_live_vars,
)
from paddle_tpu_torch.engine.pipeline import (
    DeferredFetch, DispatchWindow, _StepRecord, finite_probes, stage_fetches,
)
from paddle_tpu_torch.kernels import flash_attention as _fa
from paddle_tpu_torch.observability import goodput, health
from paddle_tpu_torch.resilience import faultinject

_BLOCK_CACHE_SIZE = 64

# captures in progress in this process, and whether the collector ran
# before the first of them: several engines (the threads of a pserver
# cluster) may capture at once, and the collector may run again only when
# the last of them ends
_gc_pause = {"depth": 0, "was_enabled": False}
_gc_pause_lock = threading.Lock()
# CUDA graph captures and graph destructions in this process, one at a
# time: torch 2.11's CUDA generator keeps the graphs captured on it in a
# set it does not lock (a graph registers at its capture and unregisters
# in its destructor), so engines capturing or dropping graphs in several
# threads at once (a pserver cluster's trainers and servers) corrupt it
# ("The graph should be registered to the state", an abort). Replays run
# concurrently; only the two ends of a graph's life wait for each other.
_graph_lifecycle = threading.RLock()


@contextlib.contextmanager
def _gc_paused():
    """Python's garbage collector off for the block, across threads: it
    comes back on when the last overlapping block ends, not when the first
    does."""
    with _gc_pause_lock:
        if _gc_pause["depth"] == 0:
            _gc_pause["was_enabled"] = gc.isenabled()
            gc.disable()
        _gc_pause["depth"] += 1
    try:
        yield
    finally:
        with _gc_pause_lock:
            _gc_pause["depth"] -= 1
            if _gc_pause["depth"] == 0 and _gc_pause["was_enabled"]:
                gc.enable()


class CompiledBlock:
    """One cache entry: a block lowered for one key, with its static feed
    buffers and seed table and, when ``capture`` is set, its CUDA graph
    (reference: ``CompiledBlock``, executor.py:48)."""

    def __init__(self, engine, block_program, feed_specs, is_test, amp,
                 donate_state, state_writeback, capture, accumulate_steps=1,
                 remat_segments=0, mesh_plan=None):
        self.engine = engine
        self.block_program = block_program
        self.device = engine.device
        self.accumulate_steps = accumulate_steps
        # over a mesh (parallel/plan.py): the feeds' placements, and the
        # local shapes of their buffers
        self.mesh_plan = mesh_plan
        self.feed_places = None
        if mesh_plan is not None:
            from paddle_tpu_torch.parallel.plan import local_chunk

            self.feed_places = [
                mesh_plan.feed_placements(torch.empty(shape, device="meta"))
                for _, shape, _ in feed_specs]
            self.feed_shapes = [tuple(shape) for _, shape, _ in feed_specs]
            feed_specs = [
                (n, tuple(local_chunk(torch.empty(shape, device="meta"),
                                      mesh_plan.mesh, pl).shape), dtype)
                for (n, shape, dtype), pl in zip(feed_specs,
                                                 self.feed_places)]
            self.fn = lower_block(block_program, engine.device,
                                  is_test=is_test, executor=engine, amp=amp,
                                  mesh_plan=mesh_plan)
        elif accumulate_steps > 1:
            self.fn = lower_block_accumulated(
                block_program, accumulate_steps, engine.device,
                is_test=is_test, executor=engine, amp=amp)
        elif remat_segments:
            self.fn = lower_block_remat(
                block_program, remat_segments, engine.device,
                is_test=is_test, executor=engine, amp=amp)
        else:
            self.fn = lower_block(block_program, engine.device,
                                  is_test=is_test, executor=engine, amp=amp)
        self.donate_state = donate_state
        self.state_writeback = state_writeback
        self.capture = capture
        self.lock = threading.Lock()
        self.feed_bufs = [torch.empty(shape, dtype=dtype, device=self.device)
                          for _, shape, dtype in feed_specs]
        # a test run draws no seed (its dropout is off); an accumulated
        # step has a row of seeds a micro-batch, then the step's own
        slots = [] if is_test else block_program.rng_slots
        rows = accumulate_steps + 1 if accumulate_steps > 1 else 1
        self.seed_buf = torch.zeros((rows, len(slots)), dtype=torch.int64,
                                    device=self.device)
        tables = [{rng_id: self.seed_buf[r, i]
                   for i, (rng_id, _) in enumerate(slots)}
                  for r in range(rows)]
        self.seeds = tables if accumulate_steps > 1 else tables[0]
        self._has_seeds = bool(slots)
        self.graph = None
        # what the graph returns (fetches, state outputs), in its pool
        self.outs = None
        # the scope tensors the graph was captured against
        self.bound = None
        # flash-kernel launches of one replay, recorded while capturing
        self.launches = None
        self.captures = 0
        self.replays = 0
        # model FLOPs of one run, counted on the first run with the
        # goodput flag up (None until then)
        self.flops = None
        # (shape, dtype) of each state output, from the first (eager) run;
        # on CUDA the second run captures
        self._out_specs = None
        # opt level 3 (reference: CompiledBlock, executor.py:67-98): the
        # analysis.memory plan this entry was built under and the remat
        # segment count it lowered; peak_bytes is the measured peak of
        # its first run on CUDA (torch.cuda.max_memory_allocated), which
        # the engine holds against plan.predicted_peak_bytes. replanned
        # bounds the measured-feedback loop to one rebuild an entry;
        # auto_remat_eligible mirrors the auto-remat guard; _rebuild
        # makes the entry again at another segment count; mem_budget is
        # the budget the plan was made against; _layout_scope pins the
        # scope whose id() is in the cache key under the layout pass
        self.remat_segments = remat_segments
        self.memory_plan = None
        self.peak_bytes = None
        self.replanned = False
        self.auto_remat_eligible = False
        self.mem_budget = None
        self._cache_key = None
        self._rebuild = None
        self._layout_scope = None
        # over a mesh (reference: executor.py:781-815): the static SPMD
        # analysis of the desc that runs (analysis/spmd.py), made at the
        # cache miss, and whether its prediction was held against the
        # first run's collectives (mesh_plan.record) yet
        self.spmd_plan = None
        self.spmd_checked = False

    # -- one run -----------------------------------------------------------
    def run(self, scope, feed_values, rng_seed, return_numpy, defer=False):
        """Run the block once; returns the fetches (numpy arrays, or
        tensors that no later run changes). With ``defer`` nothing waits
        for the card: returns (fetch tensors the caller owns, deferred nan
        probes) for the dispatch window."""
        step = rng_seed[1]
        if not self.capture:
            if self.device.type == "cuda":
                obs.inc("engine.eager_runs")
            with self.lock, obs.span("run", step=step), \
                    obs.time_block("engine.run_ms"):
                return self._run_eager(scope, feed_values, rng_seed,
                                       return_numpy, defer)
        with self.engine._graph_lock:
            state, dsts = self._scope_tensors(scope)
            if self.graph is not None and len(self.bound) == len(
                    state) + len(dsts) and all(
                        a is b for a, b in zip(self.bound, state + dsts)):
                # the tensors the graph was captured against: replay
                with obs.span("run", step=step), \
                        obs.time_block("engine.run_ms"):
                    return self._replay(feed_values, rng_seed, return_numpy,
                                        defer)
            if not self._bindable(dsts):
                with obs.span("run", step=step), \
                        obs.time_block("engine.run_ms"):
                    return self._warm_up(scope, feed_values, rng_seed,
                                         return_numpy, defer)
            if self.graph is None or any(
                    a is not b for a, b in zip(self.bound, state + dsts)):
                if self.graph is not None:
                    obs.inc("engine.recapture")
                # "compile" is the run that captures
                with obs.span("compile", step=step), \
                        obs.time_block("engine.compile_ms"):
                    self._capture(state, dsts, feed_values, rng_seed)
                    out = self._replay(feed_values, rng_seed, return_numpy,
                                       defer)
                goodput.mark("compile")
                return out
            with obs.span("run", step=step), \
                    obs.time_block("engine.run_ms"):
                return self._replay(feed_values, rng_seed, return_numpy,
                                    defer)

    def _fill(self, feed_values, rng_seed):
        """Copy the run's feeds into the static buffers and its seeds into
        the seed table. On CUDA a host value goes through pinned memory
        and is copied without waiting (torch waits for the card before a
        copy from pageable memory returns)."""
        cuda = self.device.type == "cuda"
        for i, (buf, value) in enumerate(zip(self.feed_bufs, feed_values)):
            if not isinstance(value, torch.Tensor):
                value = torch.from_numpy(value)
            if self.mesh_plan is not None:
                # every rank is fed the global batch and keeps its shard
                from paddle_tpu_torch.parallel.plan import local_chunk

                value = local_chunk(value, self.mesh_plan.mesh,
                                    self.feed_places[i]).contiguous()
            if cuda and not value.is_cuda:
                value = value.pin_memory()
            buf.copy_(value, non_blocking=cuda)
        if self._has_seeds:
            seed, counter = rng_seed
            bp = self.block_program
            k = self.accumulate_steps
            if k > 1:
                values = [bp.seed_values(seed, counter, micro=t)
                          for t in range(k)]
                values.append(bp.seed_values(seed, counter))
            else:
                values = [bp.seed_values(seed, counter)]
            host = torch.tensor(values, dtype=torch.int64)
            if cuda:
                host = host.pin_memory()
            self.seed_buf.copy_(host, non_blocking=cuda)

    def _scope_tensors(self, scope):
        """(state inputs, write-back targets): the scope's tensors that the
        block reads, and those it writes in place (None where the scope
        holds none). Over a mesh each state input is the scope's DTensor
        at its planned placement (placed on first use)."""
        if self.mesh_plan is not None:
            state = [self.engine._mesh_state_value(scope, n, self.mesh_plan)
                     for n in self.block_program.state_in_names]
        else:
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
        return all(isinstance(d, torch.Tensor)
                   and _local(d).device == self.device
                   and (tuple(d.shape), d.dtype) == s
                   for d, s in zip(dsts, self._out_specs))

    def _body(self, state, dsts, rng_seed):
        """The block, then the fetches made safe from later runs and the
        state written back in place; returns (fetches, state outputs).
        Over a mesh the block runs on DTensors (``_mesh_run``)."""
        if self.mesh_plan is not None:
            fetches, state_out = self._mesh_run(state, rng_seed)
        else:
            fetches, state_out = self.fn(self.feed_bufs, state, rng_seed,
                                         self.seeds)
        held = {_local(t).untyped_storage().data_ptr()
                for t in list(state) + self.feed_bufs
                + [d for d in dsts if isinstance(d, torch.Tensor)]}

        def unalias(t, dst=None):
            # a value living in a buffer that this or a later run writes
            # (a feed, a state tensor) is copied out first
            if t is dst or _local(t).untyped_storage().data_ptr() \
                    not in held:
                return t
            return t.clone()

        fetches = [unalias(t) for t in fetches]
        if dsts:
            state_out = [unalias(v, d) for v, d in zip(state_out, dsts)]
            for i, (v, d) in enumerate(zip(state_out, dsts)):
                if v is d:
                    continue
                if (isinstance(d, torch.Tensor) and _same_layout(d, v)
                        and d.shape == v.shape and d.dtype == v.dtype):
                    _local(d).copy_(_local(v))
                    state_out[i] = d
        return fetches, state_out

    def _mesh_run(self, state, rng_seed):
        """One run over the mesh: the feed buffers (each rank's shard)
        become DTensors at their placements, the block runs on DTensors
        with plain tensors taken as replicated, the fetches are gathered
        to their global values and each state output is put at its
        planned placement (a ZeRO-1 parameter's updated shard is
        all-gathered here)."""
        from torch.distributed.tensor.experimental import (
            implicit_replication,
        )

        from paddle_tpu_torch.parallel.mesh import spmd_lowering
        from paddle_tpu_torch.parallel.plan import from_shard, gather, place

        plan = self.mesh_plan
        bp = self.block_program
        feeds = [from_shard(buf, plan.mesh, pl, shape)
                 for buf, pl, shape in zip(self.feed_bufs, self.feed_places,
                                           self.feed_shapes)]
        plan.begin_run()
        with implicit_replication(), \
                spmd_lowering(plan.mesh, plan.data_axes):
            fetches, state_out = self.fn(feeds, state, rng_seed, self.seeds)
            out = []
            for n, t in zip(bp.fetch_names, fetches):
                with plan.logged("fetch", n):
                    out.append(gather(t))
            fetches = out
            out = []
            for n, v in zip(bp.state_out_names, state_out):
                with plan.logged("state", n):
                    out.append(place(v, plan.mesh,
                                     plan.state_placements(n))[0])
            state_out = out
        plan.end_run()
        if plan.unplanned:
            obs.inc("engine.mesh_redistribute", plan.unplanned)
        return fetches, state_out

    def _run_eager(self, scope, feed_values, rng_seed, return_numpy,
                   defer=False):
        state, dsts = self._scope_tensors(scope)
        self._fill(feed_values, rng_seed)
        first = self.flops is None and goodput.enabled()
        with torch.no_grad():
            if first:
                fetches, state_out = self._counted_body(state, dsts,
                                                        rng_seed)
            else:
                fetches, state_out = self._body(state, dsts, rng_seed)
        self._out_specs = [(tuple(v.shape), v.dtype) for v in state_out]
        if faultinject.active():
            fetches, state_out = _step_faults(rng_seed[1], fetches,
                                              state_out, dsts)
        self._finish_state(scope, state_out, rng_seed, check=not defer)
        if first:
            goodput.mark("compile")
        if defer:
            return self._deferred_out(fetches, state_out, copy=False)
        return self._fetch_out(fetches, rng_seed, return_numpy, copy=False)

    def _counted_body(self, state, dsts, rng_seed):
        """``_body`` under torch's FLOP counter and the flash kernels' own
        count; keeps the sum as the entry's FLOPs a run."""
        from torch.utils.flop_counter import FlopCounterMode

        counter = FlopCounterMode(display=False)
        with counter, _fa.count_flops() as kernel_flops:
            out = self._body(state, dsts, rng_seed)
        self.flops = float(counter.get_total_flops()) + kernel_flops[0]
        return out

    def _deferred_out(self, fetches, state_out, copy):
        """A windowed run's outputs: the deferred nan probes (enqueued, not
        read) and, with ``copy``, device clones of the fetches, which the
        next replay cannot overwrite."""
        bp = self.block_program
        probes = []
        if self.engine.check_nan_inf:
            probes = (finite_probes(zip(bp.state_out_names,
                                        [_local(v) for v in state_out]),
                                    kind="state")
                      + finite_probes(zip(bp.fetch_names, fetches),
                                      kind="fetch"))
        if copy:
            fetches = [t.clone() for t in fetches]
        return fetches, probes

    def _finish_state(self, scope, state_out, rng_seed, check=True):
        bp = self.block_program
        if check and self.engine.check_nan_inf:
            _check_finite(zip(bp.state_out_names,
                              [_local(v) for v in state_out]),
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

    def _warm_up(self, scope, feed_values, rng_seed, return_numpy,
                 defer=False):
        """An eager run on a side stream, as a capture needs before it."""
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self._run_eager(scope, feed_values, rng_seed,
                                  return_numpy, defer)
            side.synchronize()
        cur.wait_stream(side)
        tensors = out[0] if defer else (() if return_numpy else out)
        for t in tensors:
            t.record_stream(cur)
        return out

    def __del__(self):
        # the graph goes under the lifecycle lock (its destructor touches
        # the CUDA generator's graph set)
        if getattr(self, "graph", None) is not None:
            with _graph_lifecycle:
                self.graph = None

    def _capture(self, state, dsts, feed_values, rng_seed):
        """Capture the block in one graph against the scope's tensors
        ``state`` and ``dsts``; a capture that fails raises. Captures (and
        the release of the graph this one replaces) take the process-wide
        ``_graph_lifecycle`` lock."""
        with _graph_lifecycle:
            self._capture_locked(state, dsts, feed_values, rng_seed)

    def _capture_locked(self, state, dsts, feed_values, rng_seed):
        self._fill(feed_values, rng_seed)
        self.graph = self.outs = self.bound = None
        graph = torch.cuda.CUDAGraph()
        # thread_local: other threads (the serving worker, a direct
        # caller) may run eagerly on the card while this one captures;
        # the launches are recorded by the capture stream, which a
        # captured backward (remat) launches on from autograd's thread.
        # No garbage collection runs during the capture: one could free a
        # dead engine's graph, which CUDA refuses on a capturing thread,
        # and the capture would fail (torch no longer collects before it)
        with _gc_paused():
            with torch.no_grad():
                with torch.cuda.graph(graph, pool=self.engine._graph_pool(),
                                      capture_error_mode="thread_local"):
                    with _fa.record_launches(torch.cuda.current_stream(
                            self.device)) as launches:
                        outs = self._body(state, dsts, rng_seed)
        self.graph, self.outs, self.launches = graph, outs, dict(launches)
        self.bound = list(state) + list(dsts)
        self.captures += 1
        obs.inc("engine.captures")

    def _replay(self, feed_values, rng_seed, return_numpy, defer=False):
        self._fill(feed_values, rng_seed)
        self.graph.replay()
        _fa.add_launches(self.launches)
        self.replays += 1
        obs.inc("engine.replays")
        if self.mesh_plan is not None and self.mesh_plan.unplanned:
            # the captured step repeats the redistributions it recorded
            obs.inc("engine.mesh_redistribute", self.mesh_plan.unplanned)
        fetches, state_out = self.outs
        if faultinject.active():
            fetches, state_out = _step_faults(
                rng_seed[1], fetches, state_out,
                self.bound[len(self.block_program.state_in_names):])
        if defer:
            # a numpy fetch is copied to the host on this stream before
            # the next replay; a tensor fetch needs its own device copy
            return self._deferred_out(fetches, state_out,
                                      copy=not return_numpy)
        if self.engine.check_nan_inf:
            _check_finite(zip(self.block_program.state_out_names,
                              [_local(v) for v in state_out]),
                          step=rng_seed[1], kind="state")
        return self._fetch_out(fetches, rng_seed, return_numpy, copy=True)


class Engine:
    """One engine per Executor, bound to one place's device."""

    def __init__(self, place):
        self.place = place
        self.device = place.torch_device()
        self._run_counter = 0
        self._blocks = collections.OrderedDict()
        self._descs = collections.OrderedDict()
        self._cache = collections.OrderedDict()
        self._lock = threading.Lock()
        self._graph_lock = threading.RLock()
        self._pool = None
        # the async dispatch window (engine/pipeline.py): runs with
        # dispatch_steps > 1 enqueue here instead of reading their fetches
        self.window = DispatchWindow()
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
        """Drop the in-flight window (unread), the cached blocks and their
        graphs."""
        self.discard_window()
        with self._graph_lock, self._lock:
            self._cache.clear()
            self._blocks.clear()
            self._descs.clear()

    def sync(self):
        """Barrier: retire every in-flight windowed step (its deferred
        fetches resolve; deferred nan/inf verdicts raise here)."""
        self.window.sync()

    def discard_window(self):
        """Drop the in-flight window without reading or raising (the
        rollback path: stale deferred verdicts must not raise after the
        state was restored). Returns the number of steps dropped."""
        return self.window.discard()

    def run_block(self, program_desc, block_idx, scope, feed=None,
                  fetch_list=None, is_test=False, return_numpy=True,
                  seed=0, opt_level=None, cache_key_extra=None,
                  donate_state=True, state_writeback=None, amp=False,
                  accumulate_steps=1, remat_segments=0, dispatch_steps=1,
                  verify=None, mesh=None, shard_rules=None,
                  data_axes=("dp",)):
        """Run block ``block_idx`` once. ``opt_level`` (default: the flag,
        1) picks the transforms the desc goes through before it runs;
        ``verify`` (default: the flag) runs the static verifier on the
        desc that runs, at a cache miss. ``state_writeback`` (default:
        not ``is_test``) writes the persistable outputs back into the
        scope, in place with ``donate_state``; ``False`` never does, as
        serving needs (the scope stays immutable under concurrent
        callers). ``cache_key_extra`` tags the cache entry (the server's
        bucket: one graph per bucket); ``amp`` runs the ops under
        bfloat16 AMP. ``accumulate_steps`` and ``remat_segments`` pick
        the accumulated or rematerialized lowering; ``dispatch_steps``
        > 1 enqueues the step into the window and returns
        ``DeferredFetch`` placeholders (a run at depth 1 drains the
        window first). ``mesh`` (a ``DeviceMesh`` of this process's
        world, ``parallel.make_mesh``) runs the block over the mesh: the
        feeds split on their batch dim over ``data_axes``, the state laid
        out by ``shard_rules`` (``parallel.ShardingRules``; replicated
        without one) and, with the ``zero`` flag, the optimizer state
        sharded (ZeRO-1); the fetches come back whole on every rank."""
        dispatch_steps = max(1, int(dispatch_steps or 1))
        defer = dispatch_steps > 1
        if not defer and len(self.window):
            # a plain run after windowed ones: serialize first
            self.window.sync()
        with obs.span("step", step=self._run_counter + 1), \
                obs.time_block("engine.step_ms"):
            out = self._run_block_impl(
                program_desc, block_idx, scope, feed, fetch_list, is_test,
                return_numpy, seed, opt_level, cache_key_extra,
                donate_state, state_writeback, amp, int(accumulate_steps),
                int(remat_segments or 0), dispatch_steps, verify, mesh,
                shard_rules, tuple(data_axes))
        if not defer:
            # liveness: the heartbeat reports this counter; the windowed
            # path notes enqueue here and retire in the window
            health.note_step()
        return out

    def _run_block_impl(self, program_desc, block_idx, scope, feed,
                        fetch_list, is_test, return_numpy, seed, opt_level,
                        cache_key_extra, donate_state, state_writeback,
                        amp, accumulate_steps=1, remat_segments=0,
                        dispatch_steps=1, verify=None, mesh=None,
                        shard_rules=None, data_axes=("dp",)):
        if accumulate_steps < 1:
            raise ValueError("accumulate_steps must be >= 1, got %d"
                             % accumulate_steps)
        if accumulate_steps > 1 and remat_segments:
            raise NotImplementedError(
                "accumulate_steps and remat_segments cannot combine yet; "
                "pick one memory lever per program")
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
            bool(state_writeback), accumulate_steps, remat_segments,
            opt_level, verify, scope=scope, mesh=mesh,
            shard_rules=shard_rules, data_axes=data_axes)
        with self._lock:
            self._run_counter += 1
            run_counter = self._run_counter
        defer = dispatch_steps > 1
        # a planned entry's first run on the card measures its peak (the
        # eager warm-up, which holds the allocator's caching), in place of
        # the reference's compiled memory stats (executor.py:376-406); so
        # does a mesh entry's first run under spmd_predict
        predict = self._spmd_predicting(compiled)
        measure = ((compiled.memory_plan is not None or predict)
                   and compiled.peak_bytes is None
                   and self.device.type == "cuda")
        # (this thread's stream is waited for, never the whole device,
        # which CUDA refuses while another thread's engine captures)
        stream = torch.cuda.current_stream(self.device) if measure else None
        if measure:
            stream.synchronize()
            torch.cuda.reset_peak_memory_stats(self.device)
        out = compiled.run(scope, feed_values, (int(seed), run_counter),
                           return_numpy, defer)
        if measure:
            stream.synchronize()
            peak = int(torch.cuda.max_memory_allocated(self.device))
            if compiled.memory_plan is not None:
                self._note_peak(compiled, peak)
            else:
                compiled.peak_bytes = peak
        if predict:
            self._spmd_delta(compiled)
        if compiled.flops:
            goodput.note_flops(compiled.flops)
        if not defer:
            return out
        fetches, probes = out
        staged, event = stage_fetches(fetches, return_numpy)
        record = _StepRecord(run_counter, list(fetch_list), staged, event,
                             probes, return_numpy)
        record.placeholders = tuple(
            DeferredFetch(self.window, record, i, name=n)
            for i, n in enumerate(record.fetch_names))
        health.note_step_enqueued()
        # the enqueue half of the step's trace pair, named with its
        # ORIGINAL step (no-op unless this thread has an active trace)
        obs.reqtrace.step_event("step_enqueue", run_counter,
                                depth=len(self.window))
        self.window.push(record, depth=dispatch_steps)
        return list(record.placeholders)

    def get_compiled(self, program_desc, block_idx, feed_names, feed_values,
                     fetch_list, is_test, donate_state, amp,
                     cache_key_extra=None, state_writeback=True,
                     accumulate_steps=1, remat_segments=0, opt_level=None,
                     verify=None, scope=None, mesh=None, shard_rules=None,
                     data_axes=("dp",)):
        """The cached ``CompiledBlock`` of one key, made on a miss; the
        least recently used entry goes past ``executable_cache_size``.

        At ``opt_level`` 3 and up the memory budget is part of the key,
        and the memory plan runs on the desc the transforms return
        (reference: executor.py:622-720): crash-isolated (a planner that
        raises is counted in ``memory.plan_crashes`` and the entry runs
        as at level 2), its remat segment count lowered where the manual
        knob would be legal (a training step, no accumulation). Under the
        layout pass the key holds (mode, ``id(scope)``) and the entry
        pins ``scope``: the pass bakes filters into that scope.

        Over a mesh the key holds (``mesh_signature``, the rule table's
        signature, the data axes, ``zero``, ``grad_bucket_mb``), so two
        meshes, or two rule tables on one scope, never share an entry
        (reference: executor.py:599-621). Accumulation and remat are
        refused there, and level 3 plans no auto-remat. On the card an
        entry over a gloo group runs eagerly: gloo's collectives cannot
        be captured in a CUDA graph."""
        mesh_key = None
        zero, grad_bucket_mb = False, 0.0
        if mesh is not None:
            from paddle_tpu_torch.parallel.mesh import mesh_signature

            if str(mesh.device_type) != self.device.type:
                raise ValueError(
                    "mesh on %r devices, but this executor runs on %s"
                    % (mesh.device_type, self.device))
            if accumulate_steps > 1 or remat_segments:
                raise NotImplementedError(
                    "accumulate_steps and remat_segments are not supported "
                    "over a mesh; shard the state (ShardingRules, the zero "
                    "flag) for memory headroom instead")
            zero = bool(flags.get_flag("zero")) and not is_test
            grad_bucket_mb = (float(flags.get_flag("grad_bucket_mb"))
                              if zero else 0.0)
            mesh_key = (mesh_signature(mesh),
                        shard_rules.signature()
                        if shard_rules is not None else None,
                        tuple(data_axes), zero, grad_bucket_mb)
        opt_level = int(flags.get_flag("opt_level") if opt_level is None
                        else opt_level)
        specs = tuple((n, tuple(v.shape), _torch_dtype(v))
                      for n, v in zip(feed_names, feed_values))
        # whether the entry may be captured; it is when its block can be
        # too, which the rest of the key decides
        graphs = (self.device.type == "cuda" and self.cuda_graphs
                  and (donate_state or not state_writeback))
        mem_budget = None
        if opt_level >= 3:
            from paddle_tpu_torch.analysis import memory as memplan

            mem_budget = memplan.hbm_budget_bytes()
        layout_key = None
        if opt_level > 0:
            from paddle_tpu_torch.analysis.layout import (
                resolved_layout_mode)

            mode = resolved_layout_mode(opt_level)
            if mode is not None:
                layout_key = (mode, id(scope) if scope is not None else None)
        key = (program_desc.cached_fingerprint(), block_idx, specs,
               tuple(fetch_list), is_test, donate_state, amp,
               cache_key_extra, state_writeback, graphs, accumulate_steps,
               remat_segments, opt_level, mesh_key, mem_budget, layout_key)
        with self._lock:
            compiled = self._cache.get(key)
            if compiled is not None:
                self._cache.move_to_end(key)
                obs.inc("engine.cache_hit")
                return compiled
        if faultinject.active():
            # a transient compile failure at the cache miss, before the
            # transforms (reference: executor.py:664-669); nothing is
            # cached, so the caller's retry re-enters this path
            faultinject.fault_point("compile")
        run_desc = self._run_desc(program_desc, block_idx, feed_names,
                                  fetch_list, opt_level, scope, layout_key)
        memory_plan = None
        if opt_level >= 3:
            memory_plan = self._plan_memory(run_desc, feed_names,
                                            feed_values, fetch_list,
                                            mem_budget)
        eligible = bool(memory_plan is not None and not remat_segments
                        and accumulate_steps <= 1 and not is_test
                        and mesh is None)
        auto_remat = int(memory_plan.remat.n_segments) if eligible else 0
        if memory_plan is not None and obs.enabled():
            obs.event("memory_plan",
                      predicted_peak_bytes=int(
                          memory_plan.predicted_peak_bytes),
                      budget_bytes=mem_budget, remat_segments=auto_remat,
                      donated=len(memory_plan.donation.donate),
                      held=len(memory_plan.donation.held))
        if flags.get_flag("verify") if verify is None else verify:
            # once per cache entry, before lowering, on the desc that
            # runs: every rewrite the transforms made is verified too
            from paddle_tpu_torch.analysis import verify_program

            with obs.span("verify"), obs.time_block("engine.verify_ms"):
                verify_program(run_desc, feed_names=feed_names,
                               fetch_names=fetch_list, mesh=mesh,
                               shard_rules=shard_rules, data_axes=data_axes,
                               raise_on_error=True)
        spmd_plan = None
        if mesh is not None:
            spmd_plan = self._plan_spmd(run_desc, block_idx, mesh,
                                        shard_rules, data_axes, feed_names,
                                        feed_values, fetch_list, zero)

        def build(segments):
            # the entry at a segment count, over the same transformed desc
            extra_live = (remat_live_vars(run_desc.block(block_idx))
                          if segments else ())
            bp = self._block_program(program_desc, block_idx, feed_names,
                                     fetch_list, extra_live, opt_level,
                                     run_desc, layout_key)
            plan = None
            capture = graphs and bp.capturable
            if mesh is not None:
                from paddle_tpu_torch.parallel.plan import MeshPlan

                plan = MeshPlan(bp.block, mesh, shard_rules, data_axes,
                                zero, grad_bucket_mb, is_test)
                if capture and _mesh_backend(mesh) != "nccl":
                    capture = False
                    obs.event("engine.eager", reason=(
                        "collectives of backend %r cannot be captured in "
                        "a CUDA graph" % _mesh_backend(mesh)))
            return CompiledBlock(self, bp, specs, is_test, amp,
                                 donate_state, state_writeback, capture,
                                 accumulate_steps, segments, plan)

        try:
            compiled = build(remat_segments or auto_remat)
        except NotImplementedError:
            # the remat lowering refuses some programs (intermediate-grad
            # fetches, non-@GRAD optimizer inputs...): an auto-chosen plan
            # falls back to donation only; a knob the user set raises
            if not auto_remat:
                raise
            obs.inc("memory.autoremat_fallback")
            compiled = build(remat_segments)
        compiled.memory_plan = memory_plan
        compiled.spmd_plan = spmd_plan
        compiled.auto_remat_eligible = eligible
        compiled.mem_budget = mem_budget
        compiled._cache_key = key
        compiled._rebuild = build
        if layout_key is not None:
            compiled._layout_scope = scope
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

    def _run_desc(self, program_desc, block_idx, feed_names, fetch_list,
                  opt_level, scope, layout_key):
        """The desc that runs: what ``optimize_program`` returns (the
        original when nothing rewrote), shared by every key with these
        feeds, fetches, opt level and layout key. The layout pass bakes
        filters into ``scope``, which the cached desc pins."""
        key = (program_desc.cached_fingerprint(), block_idx,
               tuple(feed_names), tuple(fetch_list), opt_level, layout_key)
        with self._lock:
            hit = self._descs.get(key)
            if hit is not None:
                self._descs.move_to_end(key)
                return hit[0]
        run_desc = program_desc
        if opt_level > 0:
            from paddle_tpu_torch.analysis.transforms import (
                optimize_program)

            with obs.span("trace", block=block_idx, opt_level=opt_level), \
                    obs.time_block("engine.trace_ms"):
                run_desc, _ = optimize_program(
                    program_desc, level=opt_level, feed_names=feed_names,
                    fetch_names=fetch_list,
                    scope=scope if layout_key is not None else None)
        with self._lock:
            run_desc = self._descs.setdefault(
                key, (run_desc, scope if layout_key else None))[0]
            if len(self._descs) > _BLOCK_CACHE_SIZE:
                self._descs.popitem(last=False)
        return run_desc

    def _plan_spmd(self, run_desc, block_idx, mesh, shard_rules, data_axes,
                   feed_names, feed_values, fetch_list, zero):
        """The static SPMD plan of ``run_desc`` over ``mesh`` (reference:
        executor.py:781-815), crash-isolated like the memory planner: a
        crash is counted in ``spmd.plan_crashes`` and the plan is None."""
        from paddle_tpu_torch.analysis import spmd as spmd_analysis

        try:
            with obs.span("spmd-plan"), \
                    obs.time_block("engine.spmd_plan_ms"):
                plan = spmd_analysis.analyze_spmd(
                    run_desc, mesh=mesh, shard_rules=shard_rules,
                    data_axes=data_axes, feed_names=feed_names,
                    feed_shapes={n: tuple(v.shape) for n, v in
                                 zip(feed_names, feed_values)},
                    fetch_names=fetch_list, block_idx=block_idx,
                    zero1=zero)
            if obs.enabled():
                obs.event("spmd_plan", psums=plan.psum_count,
                          all_gathers=plan.all_gather_count,
                          collective_bytes=plan.total_bytes,
                          per_device_peak_bytes=int(
                              plan.per_device_peak_bytes))
            return plan
        except Exception:
            obs.inc("spmd.plan_crashes")
            return None

    def _spmd_predicting(self, compiled):
        """Whether this run of ``compiled`` is the one whose collectives
        the prediction is held against: its first, with a plan, under
        ``spmd_predict`` and metrics."""
        return (compiled.spmd_plan is not None and not compiled.spmd_checked
                and not compiled.spmd_plan.empty and obs.enabled()
                and bool(flags.get_flag("spmd_predict")))

    def _spmd_delta(self, compiled):
        """Hold the entry's SPMD plan against the collectives its first
        run issued (``MeshPlan.record``; reference: executor.py:407-449,
        which parses the executable's HLO): the ``spmd.*`` gauges and the
        ``spmd.prediction_delta`` event. A crash is counted in
        ``spmd.predict_crashes``."""
        compiled.spmd_checked = True
        plan = compiled.spmd_plan
        try:
            from paddle_tpu_torch.analysis import spmd as spmd_analysis

            meas = spmd_analysis.measured_collectives(
                compiled.mesh_plan.record)
            obs.set_gauge("spmd.predicted_psums", plan.psum_count)
            obs.set_gauge("spmd.measured_psums", meas["psum_count"])
            obs.set_gauge("spmd.predicted_collective_bytes",
                          plan.total_bytes)
            obs.set_gauge("spmd.measured_collective_bytes",
                          meas["total_bytes"])
            obs.event(
                "spmd.prediction_delta",
                psums_predicted=plan.psum_count,
                psums_measured=meas["psum_count"],
                all_gathers_predicted=plan.all_gather_count,
                all_gathers_measured=meas["all_gather_count"],
                bytes_predicted=plan.total_bytes,
                bytes_measured=meas["total_bytes"],
                bytes_delta=meas["total_bytes"] - plan.total_bytes,
                peak_bytes_predicted=int(plan.per_device_peak_bytes),
                peak_bytes_measured=int(compiled.peak_bytes or 0))
        except Exception:
            obs.inc("spmd.predict_crashes")

    def _plan_memory(self, run_desc, feed_names, feed_values, fetch_list,
                     budget):
        """The level-3 memory plan of ``run_desc``, or None when the
        planner raised (counted in ``memory.plan_crashes``: a planner bug
        degrades to the level-2 behaviour, as in the reference,
        executor.py:690-705)."""
        from paddle_tpu_torch.analysis import memory as memplan

        try:
            with obs.span("memory-plan"), \
                    obs.time_block("engine.memory_plan_ms"):
                return memplan.plan_memory(
                    run_desc,
                    feed_shapes={n: tuple(v.shape) for n, v in
                                 zip(feed_names, feed_values)},
                    fetch_names=fetch_list, budget_bytes=budget)
        except Exception:
            obs.inc("memory.plan_crashes")
            return None

    def _note_peak(self, compiled, measured):
        """Hold a planned entry's measured first-run peak against its
        prediction (the ``memory_plan_delta`` event and the
        ``hbm.plan_predicted_peak_bytes`` gauge), then re-plan if it
        missed (reference: executor.py:384-406)."""
        compiled.peak_bytes = measured
        predicted = int(compiled.memory_plan.predicted_peak_bytes)
        if obs.enabled():
            obs.set_gauge("hbm.plan_predicted_peak_bytes", predicted)
            obs.event("memory_plan_delta", predicted_bytes=predicted,
                      measured_bytes=measured,
                      delta_bytes=measured - predicted,
                      remat_segments=compiled.remat_segments,
                      donated=len(compiled.memory_plan.donation.donate))
        self._maybe_replan(compiled, measured)

    def _maybe_replan(self, compiled, measured_bytes):
        """Close the memory_plan_delta loop (reference: ``_maybe_replan``,
        executor.py:849-906): when the measured peak misses the plan's
        prediction beyond ``replan_tolerance``, re-run the segment search
        with the cost model rescaled by the measurement
        (analysis/memory.replan_segments) and rebuild the entry ONCE,
        swapping it into the cache so that the next step runs (and on
        the card captures) the corrected entry. Bounded: each entry
        re-plans at most once, and the replacement is itself marked
        re-planned."""
        from paddle_tpu_torch.analysis import memory as memplan

        tol = float(flags.get_flag("replan_tolerance"))
        plan = compiled.memory_plan
        if (tol <= 0 or compiled.replanned or plan is None
                or measured_bytes <= 0 or not compiled.mem_budget
                or not compiled.auto_remat_eligible
                or compiled._rebuild is None):
            return
        compiled.replanned = True  # one attempt per entry, hit or miss
        predicted = int(plan.predicted_peak_bytes)
        if predicted > 0 and abs(measured_bytes - predicted) <= \
                tol * predicted:
            return
        new_remat = memplan.replan_segments(
            plan, measured_bytes, compiled.mem_budget)
        if int(new_remat.n_segments) == int(compiled.remat_segments):
            if obs.enabled():
                obs.event("memory_replan_skipped",
                          measured_bytes=int(measured_bytes),
                          predicted_bytes=predicted,
                          remat_segments=int(compiled.remat_segments),
                          reason=new_remat.reason)
            return
        # never swap under in-flight windowed steps
        self.window.sync()
        try:
            with obs.span("replan"), obs.time_block("engine.replan_ms"):
                fresh = compiled._rebuild(int(new_remat.n_segments))
        except NotImplementedError:
            # the remat lowering's refusals: keep the entry we measured
            obs.inc("memory.replan_fallback")
            return
        # the rebuilt entry's first run measures its own peak; being
        # re-planned, it never re-plans again
        fresh.memory_plan = memplan.MemoryPlan(plan.liveness, plan.donation,
                                               new_remat)
        fresh.replanned = True
        fresh.mem_budget = compiled.mem_budget
        fresh._cache_key = compiled._cache_key
        fresh._rebuild = compiled._rebuild
        fresh._layout_scope = compiled._layout_scope
        key = compiled._cache_key
        with self._lock:
            if self._cache.get(key) is compiled:
                self._cache[key] = fresh
        obs.inc("memory.replan")
        if obs.enabled():
            obs.event("memory_replan",
                      measured_bytes=int(measured_bytes),
                      predicted_bytes=predicted,
                      old_segments=int(compiled.remat_segments),
                      new_segments=int(new_remat.n_segments),
                      est_peak_bytes=int(new_remat.est_peak_bytes),
                      reason=new_remat.reason)

    def _block_program(self, program_desc, block_idx, feed_names,
                       fetch_list, extra_live, opt_level, run_desc,
                       layout_key=None):
        """The analyzed block of ``run_desc`` (the desc ``_run_desc``
        returned for the original ``program_desc``), shared by every key
        with these feeds, fetches, liveness roots, opt level and layout
        key."""
        key = (program_desc.cached_fingerprint(), block_idx,
               tuple(feed_names), tuple(fetch_list), tuple(extra_live),
               opt_level, layout_key)
        with self._lock:
            bp = self._blocks.get(key)
            if bp is not None:
                self._blocks.move_to_end(key)
                return bp
        with obs.span("trace", block=block_idx, opt_level=opt_level), \
                obs.time_block("engine.trace_ms"):
            bp = BlockProgram(run_desc.block(block_idx), feed_names,
                              fetch_list, extra_live)
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

    def _mesh_state_value(self, scope, name, plan):
        """A state var as the DTensor the entry reads: the scope's value
        at its planned placement. A plain value (a startup run without a
        mesh, ``scope.set``) is split locally; a DTensor laid out
        otherwise (another rule table, another mesh) is redistributed and
        counted in ``engine.state_resharded`` (reference:
        executor.py:273-299). The scope keeps what the entry reads."""
        from paddle_tpu_torch.parallel.plan import place

        val = scope.get(name)
        if val is not None and plan.placed.get(name) is val:
            return val  # placed by an earlier run, untouched since
        val = self._state_value(scope, name, mesh=True)
        placed, moved = place(val, plan.mesh, plan.state_placements(name))
        plan.placed[name] = placed
        if placed is not val:
            scope.set(name, placed)
        if moved:
            obs.inc("engine.state_resharded")
            obs.event("engine.state_resharded", var=name,
                      placements=str(tuple(placed.placements)))
        return placed

    def _state_value(self, scope, name, mesh=False):
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
        elif not mesh and getattr(val, "placements", None) is not None:
            # a run without a mesh after one with: the scope takes the
            # whole value back (a gather, on every rank alike)
            val = val.full_tensor()
            scope.set(name, val)
            obs.inc("engine.state_resharded")
        elif _local(val).device != self.device:
            raise RuntimeError(
                "Variable %r lives on %s but this executor runs on %s"
                % (name, val.device, self.device))
        return val


def _local(t):
    """The tensor this rank holds: a DTensor's local shard, else ``t``."""
    to_local = getattr(t, "to_local", None)
    return to_local() if to_local is not None else t


def _same_layout(a, b):
    """Whether ``b`` may be copied into ``a`` in place: both plain tensors
    on one device, or DTensors on one mesh at one placement."""
    pa, pb = getattr(a, "placements", None), getattr(b, "placements", None)
    if pa is None or pb is None:
        return pa is pb and a.device == b.device
    return (a.device_mesh == b.device_mesh and tuple(pa) == tuple(pb)
            and _local(a).shape == _local(b).shape)


def _mesh_backend(mesh):
    import torch.distributed as dist

    return str(dist.get_backend(mesh.get_group(0))).lower()


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


def _step_faults(step, fetches, state_out, written):
    """The step seam's fault points (reference: executor.py:342-361), after
    the step and before the nan/inf guard: ``step_fail`` raises
    ``InjectedFault``; ``step_nan`` fills the float outputs with NaN, in
    place for ``written`` (the scope's own tensors, which the step has
    already updated) and in new tensors for the rest; ``bitflip`` raises
    ``NotImplementedError``. Returns (fetches, state outputs)."""
    faultinject.fault_point("step_fail", step=step)
    if faultinject.fault_point("step_nan", step=step):
        held = {id(t) for t in written}
        fetches = [_poison_nan(v, id(v) in held) for v in fetches]
        state_out = [_poison_nan(v, id(v) in held) for v in state_out]
    if faultinject.fault_point("bitflip", step=step):
        raise NotImplementedError(
            "fault point 'bitflip' fired at step %s: flipping a stored "
            "parameter's bit needs the SDC sentinel, which the port does "
            "not have yet (ROADMAP Queue 1 item 11)" % step)
    return fetches, state_out


def _poison_nan(val, in_place):
    """NaN-fill a float tensor (fault injection's step_nan; reference:
    ``_poison_nan``, executor.py:1172); other values pass through."""
    if not isinstance(val, torch.Tensor) or not val.is_floating_point():
        return val
    return val.mul_(float("nan")) if in_place else val * float("nan")


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
