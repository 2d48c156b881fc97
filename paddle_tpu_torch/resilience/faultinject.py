"""Deterministic fault injection at the engine seams.

Port of ``paddle_tpu/resilience/faultinject.py``, whole: the same
grammar, schedule, counters and exit codes. Fault tolerance is only
trustworthy if every recovery path is exercisable WITHOUT real hardware
faults (the discipline TensorFlow's fault-tolerance design demands —
PAPERS.md). This module plants named **fault points** at the seams —
compile (engine cache miss), step run, checkpoint write, worker
liveness — and a schedule parsed from ``PADDLE_GPU_FAULT_SPEC`` decides
which hit of which point fires, on which rank, in which incarnation of
a supervised job. Everything is counter-driven: the same spec against
the same program replays the same faults.

The port's engine plants ``compile``, ``step_fail`` and ``step_nan``
(``engine/executor.py``) and its ``CheckpointManager`` plants
``ckpt_write``. ``bitflip`` needs the SDC sentinel, and ``disk_fail``
and ``preempt`` the rollback step loop (ROADMAP Queue 1 item 11): the
engine's ``bitflip`` seam raises ``NotImplementedError`` when an entry
fires, rather than corrupt nothing.

Spec grammar (';'-separated entries)::

    spec  := entry (';' entry)*
    entry := point ['@' cond (':' cond)*]
    cond  := 'step' N   fire when the point's step (or hit count when
                        the seam passes none) equals N
           | N          shorthand for stepN
           | 'rank' N   only on worker rank N (PADDLE_TRAINER_ID)
           | 'restart' N  only in gang incarnation N (the supervisor
                          sets PADDLE_GPU_RESTART_COUNT; default 0, so
                          by default a fault does NOT re-fire after the
                          supervisor restarts the gang)
           | 'x' N      fire N times (default 1)
           | 'dev' N    payload parameter, not a match condition: which
                        addressable replica shard a ``bitflip`` corrupts
                        under a mesh (default 0; ignored elsewhere)

Examples: ``step_nan@7`` — poison the 7th step's outputs with NaN;
``worker_kill@rank1:step12`` — rank 1 hard-exits at step 12;
``compile@1;ckpt_write@20`` — the first compile and the step-20
checkpoint write each fail once (both absorbed by their retry paths).

Registered points and what firing does:

    step_nan     returns True to the engine, which multiplies the
                 step's float outputs by NaN (in place where the scope
                 holds them: a captured step has already written its
                 state into the scope's tensors) — the real nan/inf
                 guard then trips exactly as a numeric blow-up would
    step_fail    raises InjectedFault out of the step
    compile      raises InjectedFault from the cache-miss build
    ckpt_write   raises InjectedFault inside the checkpoint writer's
                 write attempt (absorbed by its retry; enough
                 repetitions fail the save)
    worker_kill  hard process exit with KILLED_EXIT_CODE — no cleanup,
                 no atexit: the closest a test gets to SIGKILL/preemption
    worker_hang  sleep forever WITHOUT exiting: the step loop wedges
                 while daemon threads (the health heartbeat) keep
                 running — a deadlocked collective's exact signature.
                 Only the supervisor's heartbeat watchdog
                 (observability/health.py) can clear it; restart-gated
                 like worker_kill so the respawned gang does not re-hang
    worker_loss  hard process exit with LOST_EXIT_CODE — a PERMANENT
                 loss (dead host, failed VM): restarting the same rank
                 is pointless, so the supervisor shrinks the gang to
                 the survivors (distributed/launch.py --max-shrinks)
                 instead of burning the restart budget
    disk_fail    returns True to the caller, which poisons its LOCAL
                 checkpoint root (the rollback step loop rmtree-s it) —
                 the dead-local-disk scenario checkpoint quorum restore
                 recovers from via a peer root's replica
    bitflip      returns the fired entry to the engine seam, which flips
                 ONE mantissa bit of a stored updated param
                 (resilience/sentinel.py apply_bitflip) — silent data
                 corruption: no exception, no NaN, nothing the nan/inf
                 guard can see. Only the SDC sentinel's
                 digest/replica/replay machinery catches it; with the
                 sentinel off it corrupts undetected BY DESIGN. Under a
                 mesh the flip lands on replica shard ``dev N``. An
                 ``x1`` entry is a transient (the sentinel's bit-exact
                 replay comes back clean); ``xN`` keeps re-firing at the
                 replay seam — a persistently flaky core, which the
                 replay vote blames
    preempt      returns the fired entry to the rollback step
                 loop, which treats it exactly like SIGTERM: drain the
                 dispatch window, blocking checkpoint, exit
                 PREEMPT_EXIT_CODE — the supervisor restarts the gang
                 WITHOUT spending restart budget (preemption is
                 scheduled capacity loss, not a fault)
"""

import os
import time

from paddle_tpu_torch import flags

__all__ = ["InjectedFault", "FaultEntry", "FaultSchedule", "KILLED_EXIT_CODE",
           "LOST_EXIT_CODE", "PREEMPT_EXIT_CODE", "active", "fault_point",
           "parse_fault_spec", "random_spec", "reset"]

KILLED_EXIT_CODE = 43
#: a PERMANENTLY lost worker (dead host): the supervisor must shrink
#: the gang over the survivors, not respawn this rank
LOST_EXIT_CODE = 45
#: a GRACEFULLY preempted worker (SIGTERM / scheduled eviction): it
#: drained its window and checkpointed before exiting, so the
#: supervisor restarts the gang without spending restart budget
PREEMPT_EXIT_CODE = 46

#: points that RETURN their fired entry (truthy) instead of raising —
#: the caller applies the corruption itself (the engine owns the arrays
#: to poison, the step loop owns the checkpoint root to destroy / the
#: preemption protocol to run)
POISON_POINTS = frozenset(["step_nan", "disk_fail", "bitflip", "preempt"])

KNOWN_POINTS = frozenset(
    ["step_nan", "step_fail", "compile", "ckpt_write", "worker_kill",
     "worker_hang", "worker_loss", "disk_fail", "bitflip", "preempt"])


class InjectedFault(RuntimeError):
    """A fault-injection entry fired at a raising fault point."""

    def __init__(self, point, step=None):
        self.point = point
        self.step = step
        super().__init__(
            "injected fault at point %r (step %s)" % (point, step))


class FaultEntry:
    def __init__(self, point, step=None, rank=None, restart=None, repeat=1,
                 dev=None):
        self.point = point
        self.step = step
        self.rank = rank
        self.restart = 0 if restart is None else restart
        self.repeat = repeat
        # payload, not a match condition: which replica shard a bitflip
        # corrupts under a mesh
        self.dev = 0 if dev is None else dev
        self.fired = 0

    def matches(self, step, rank, restart):
        if self.fired >= self.repeat:
            return False
        if self.rank is not None and rank != self.rank:
            return False
        if restart != self.restart:
            return False
        return self.step is None or step == self.step

    def __repr__(self):
        conds = []
        if self.rank is not None:
            conds.append("rank%d" % self.rank)
        if self.step is not None:
            conds.append("step%d" % self.step)
        if self.restart:
            conds.append("restart%d" % self.restart)
        if self.repeat != 1:
            conds.append("x%d" % self.repeat)
        if self.dev:
            conds.append("dev%d" % self.dev)
        return self.point + ("@" + ":".join(conds) if conds else "")


def parse_fault_spec(spec):
    """``spec`` string -> [FaultEntry]; raises ValueError with the
    offending entry named on any grammar violation."""
    entries = []
    for raw in spec.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        point, _, tail = raw.partition("@")
        point = point.strip()
        if point not in KNOWN_POINTS:
            raise ValueError(
                "unknown fault point %r in %r (known: %s)"
                % (point, raw, sorted(KNOWN_POINTS)))
        kw = {}
        for cond in (tail.split(":") if tail else []):
            cond = cond.strip()
            for prefix, key in (("step", "step"), ("rank", "rank"),
                                ("restart", "restart"), ("dev", "dev"),
                                ("x", "repeat")):
                if cond.startswith(prefix) and cond[len(prefix):].isdigit():
                    kw[key] = int(cond[len(prefix):])
                    break
            else:
                if cond.isdigit():           # bare N == stepN
                    kw["step"] = int(cond)
                else:
                    raise ValueError(
                        "bad fault condition %r in %r" % (cond, raw))
        entries.append(FaultEntry(point, **kw))
    return entries


def random_spec(seed, n_steps, nproc=1, kinds=("worker_kill", "step_nan")):
    """A seeded random-but-reproducible chaos schedule: one entry per
    kind, each at a random step in the middle 80% of the run (early
    enough to matter, late enough that a checkpoint exists), kills
    pinned to a random rank. Same seed -> same spec (tools/chaos_run)."""
    import random as _random

    rng = _random.Random(seed)
    lo, hi = max(1, n_steps // 10), max(2, (9 * n_steps) // 10)
    parts = []
    for kind in kinds:
        conds = ["step%d" % rng.randint(lo, hi)]
        if kind in ("worker_kill", "worker_hang", "worker_loss", "preempt",
                    "bitflip"):
            # liveness/silent-corruption kinds pin to ONE rank so the
            # rest of the gang observes the event instead of sharing it
            conds.insert(0, "rank%d" % rng.randrange(nproc))
        if kind == "bitflip":
            # coin-flip transient (x1: the replay comes back clean) vs
            # persistent (the replay vote must blame the core)
            conds.append("x%d" % rng.choice((1, 9)))
        parts.append(kind + "@" + ":".join(conds))
    return ";".join(parts)


class FaultSchedule:
    """Parsed spec + per-point hit counters. Rank comes from
    PADDLE_TRAINER_ID, incarnation from PADDLE_GPU_RESTART_COUNT (both
    read at construction — the launcher sets them per worker spawn)."""

    def __init__(self, spec, rank=None, restart=None):
        self.spec = spec
        self.entries = parse_fault_spec(spec)
        self.rank = (int(os.environ.get("PADDLE_TRAINER_ID", "0"))
                     if rank is None else int(rank))
        self.restart = (int(os.environ.get("PADDLE_GPU_RESTART_COUNT", "0"))
                        if restart is None else int(restart))
        self._hits = {}

    def check(self, point, step=None):
        """Record one hit of ``point``; return the FaultEntry that fires
        now, or None. With no explicit ``step`` from the seam the
        point's own hit count (1-based) stands in for it."""
        hits = self._hits.get(point, 0) + 1
        self._hits[point] = hits
        eff = hits if step is None else step
        for e in self.entries:
            if e.point == point and e.matches(eff, self.rank, self.restart):
                e.fired += 1
                return e
        return None


_schedule = None


def _get_schedule(spec):
    global _schedule
    if _schedule is None or _schedule.spec != spec:
        _schedule = FaultSchedule(spec)
    return _schedule


def reset():
    """Drop the cached schedule (test isolation; hit counters restart)."""
    global _schedule
    _schedule = None


def active():
    """True when a fault spec is configured — the one-read fast gate the
    engine checks before paying any schedule work."""
    return bool(flags.get_flag("fault_spec"))


def fault_point(name, step=None):
    """Declare one hit of fault point ``name``. Returns False when no
    entry fires; returns the fired FaultEntry (truthy) for poison-style
    points — callers that only need a boolean keep working, the bitflip
    seam reads the entry's ``dev``/``fired`` payload; raises
    InjectedFault for failure-style points; never returns for
    worker_kill."""
    spec = flags.get_flag("fault_spec")
    if not spec:
        return False
    entry = _get_schedule(spec).check(name, step)
    if entry is None:
        return False
    from paddle_tpu_torch import observability as obs

    obs.inc("faultinject.fired")
    obs.inc("faultinject.%s.fired" % name)
    obs.event("faultinject", point=name, step=step, entry=repr(entry))
    if name in ("worker_kill", "worker_loss"):
        # flush telemetry, then die the way a preempted worker dies:
        # immediately, skipping atexit/finally (os._exit) — siblings see
        # a vanished peer, the supervisor sees a non-zero exit. A
        # worker_loss exits with the PERMANENT code: this host is never
        # coming back, so the supervisor shrinks instead of respawning
        try:
            obs.flush_sink()
        except Exception:
            pass
        os._exit(KILLED_EXIT_CODE if name == "worker_kill"
                 else LOST_EXIT_CODE)
    if name == "worker_hang":
        # wedge the step loop forever WITHOUT exiting: the heartbeat
        # daemon keeps beating with a frozen step counter — exactly the
        # hung signature the supervisor's HealthMonitor must catch,
        # since no exit code will ever arrive
        try:
            obs.flush_sink()
        except Exception:
            pass
        while True:
            time.sleep(60.0)
    if name in POISON_POINTS:
        return entry
    raise InjectedFault(name, step)
