"""Op-level device profiling: lowering provenance -> torch.profiler
attribution -> roofline classification. Port of
``paddle_tpu/observability/opprof.py`` on ``torch.profiler``.

The engine runs a block op by op (``engine/lowering.py`` ``run_op``), so
the provenance the reference carries through XLA's ``op_name`` metadata
is here a host range: three stages, as in the reference.

1. **Provenance** (written by engine/lowering.py and the engine): each
   cache entry collects ``tag -> OpDesc`` (``pt.<op_type>.<block>_<idx>``,
   the reference's tags, the accumulated lowering's once-op offset
   included) when it is built. While a profiler session is active
   (``begin_session``, which ``profiler.start_profiler`` calls with the
   ``opprof`` flag up) every op's lowering runs inside
   ``torch.profiler.record_function(tag)``; outside a session nothing
   is entered, so an eager step pays one bool check an op. Transform
   passes stamp ``__src_ops__`` on ops they fuse or rewrite, so a tag
   expands back to its source op list.
2. **Attribution** (:func:`attribute`): the session's chrome-trace JSON
   (what ``torch.profiler`` exports) is read, and each device event (a
   kernel, a memcpy or a memset) is charged to the OUTERMOST tag range
   holding the host event that launched it (the launch's own thread
   first, then any thread: a ``torch.func.vjp`` backward launches from
   autograd's device thread while the op's thread waits inside its
   range). A CUDA-graph replay replays no host ranges, so a captured
   entry's first run in a session runs eagerly under the tag ranges
   (the range ``opprof.eager#<entry>`` around its body) and each replay
   (``opprof.replay#<entry>`` around the graph launch) is joined to that
   run by kernel order: the capture was taken from one stream, so the
   replay's kernels come in the eager run's order. The names must match
   one for one; a replay the profiler dropped launches from is joined
   as an in-order subsequence (``join.partial_replays``); one that does
   not match is left out of the table, which then stands on the eager
   run alone (``source`` ``"cuda-eager"``, the mismatch listed in
   ``join.mismatches``). There is no HLO, so ``hlo_op_map`` has no
   counterpart. Per-op FLOPs/bytes (``analysis.spmd.op_flops_bytes``)
   join in to give a roofline verdict per op: compute-bound /
   memory-bound, and comm-bound for the collectives' own lane (NCCL
   kernels, gloo ops), under ``PADDLE_GPU_PEAK_FLOPS`` and
   ``PADDLE_GPU_PEAK_MEMBW_BYTES``.
3. **Surfacing**: ``profiler.stop_profiler`` writes the attribution
   table into the run summary and a ``opprof_provenance.json`` sidecar
   next to the trace, so the trace attributes without the live process.

``source`` says where the times came from: ``"cuda"`` for captured
replays joined by kernel order (with the eager run they join to),
``"cuda-eager"`` for tagged eager ranges only, ``"cpu"`` on the CPU,
where the "device events" are the top-level aten ops (those no other
aten op on their thread encloses) and their host times.

The registry keeps the reference's keys: ``costs`` (tag -> op type,
FLOPs, bytes, source ops), ``collectives`` (from a mesh entry's
``parallel.plan.MeshPlan.record``: psums, bytes, instances a run),
``policy``, and, in place of the HLO instruction maps, ``instr_tags``
(entry label -> its tags in run order) and ``instr_kinds`` (entry label
-> "captured" or "eager").

The H100's profiler may drop device activity from a window (a launch,
a quarter of them, or all): :func:`window_issues` names an empty or
partial window, and ``profiler.profile_steps`` reruns such a window.
"""

import bisect
import glob
import hashlib
import json
import os
import re
import threading

SIDECAR_NAME = "opprof_provenance.json"
# the chrome-trace files a session writes under its trace directory
TRACE_SUFFIX = ".pt.trace.json"
# the host ranges around a cache entry's runs in a session: its eager
# body (a captured entry's tagged run), and a replay's graph launch
EAGER_RANGE = "opprof.eager#"
REPLAY_RANGE = "opprof.replay#"
POLICY = "outermost-range"

# pt.<op_type>.<block>_<idx> — op types are \w+ (incl. _grad suffixes)
_TAG_RE = re.compile(r"pt\.(\w+)\.(\d+)_(\d+)")

_DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
_LAUNCH_CATS = frozenset({"cuda_runtime", "cuda_driver"})
_COLLECTIVE_RE = re.compile(
    r"nccl|gloo|c10d::|all_?reduce|all_?gather|reduce_?scatter|"
    r"all_?to_?all|broadcast_", re.I)


def provenance_tag(op_type, block_idx, op_idx):
    """The range tag the lowering wraps op ``op_idx`` of block
    ``block_idx`` in: ``pt.<op_type>.<block>_<idx>``."""
    return "pt.%s.%d_%d" % (op_type, int(block_idx), int(op_idx))


def parse_tag(op_name):
    """Extract the canonical provenance tag from a range or event name
    (``.../pt.mul.0_3/...``). Returns the ``pt.<type>.<b>_<i>`` string,
    or None when the name carries no provenance."""
    if not op_name:
        return None
    m = _TAG_RE.search(op_name)
    if m is None:
        return None
    return "pt.%s.%s_%s" % (m.group(1), m.group(2), m.group(3))


def tag_op_type(tag):
    """The framework op type a tag encodes, or None."""
    m = _TAG_RE.search(tag or "")
    return m.group(1) if m else None


# -- profiler sessions --------------------------------------------------------
# Whether the lowering enters its tag ranges (a profiler session with the
# opprof flag up), and the session's number: a captured entry runs eagerly
# under the ranges once a session.
_SESSION = {"active": False, "id": 0}


def begin_session():
    """Start tagging (``profiler.start_profiler`` calls this) when the
    ``opprof`` flag is up; returns whether it tags."""
    from paddle_tpu_torch import flags

    _SESSION["id"] += 1
    _SESSION["active"] = bool(flags.get_flag("opprof"))
    return _SESSION["active"]


def end_session():
    _SESSION["active"] = False


def tagging():
    """True while a session tags: the lowering's one check an op."""
    return _SESSION["active"]


def session_id():
    return _SESSION["id"]


# -- process-level provenance registry ---------------------------------------
# Accumulates across every cache entry registered since the last reset: a
# profiled run typically builds startup and train-step entries, and all of
# them contribute to the same trace.
_LOCK = threading.Lock()
_REGISTRY = {
    "policy": POLICY,
    "instr_tags": {},   # entry label -> [tags in run order]
    "instr_kinds": {},  # entry label -> "captured" | "eager"
    "costs": {},        # tag -> {op_type, flops, bytes, src_ops}
    "collectives": {"hlo_psums": 0, "hlo_bytes": 0, "instances": 0},
}


def reset():
    with _LOCK:
        _REGISTRY["instr_tags"] = {}
        _REGISTRY["instr_kinds"] = {}
        _REGISTRY["costs"] = {}
        _REGISTRY["collectives"] = {
            "hlo_psums": 0, "hlo_bytes": 0, "instances": 0}


def registry_snapshot():
    with _LOCK:
        return {
            "policy": _REGISTRY["policy"],
            "instr_tags": {k: list(v)
                           for k, v in _REGISTRY["instr_tags"].items()},
            "instr_kinds": dict(_REGISTRY["instr_kinds"]),
            "costs": {t: dict(c) for t, c in _REGISTRY["costs"].items()},
            "collectives": dict(_REGISTRY["collectives"]),
        }


def register_entry(prov, block=None, feed_shapes=None, label=None,
                   kind="eager", collectives=None):
    """Record one cache entry's provenance: static FLOPs/bytes for every
    op its lowering tagged (``prov``: tag -> OpDesc, collected when the
    entry was built, so the tags match exactly what runs), under
    ``label`` with its ``kind``; ``collectives`` is a mesh entry's
    first-run record (``MeshPlan.record``), the comm lane's expected
    instances. Returns the number of ops registered."""
    from paddle_tpu_torch.analysis import spmd

    costs = {}
    for tag, op in (prov or {}).items():
        try:
            flops, nbytes = spmd.op_flops_bytes(
                op, block, feed_shapes=feed_shapes)
        except Exception:
            flops, nbytes = 0, 0
        src = op.attrs.get("__src_ops__")
        costs[tag] = {
            "op_type": op.type,
            "flops": int(flops),
            "bytes": int(nbytes),
            "src_ops": list(src) if src else [op.type],
        }
    measured = spmd.measured_collectives(collectives) if collectives \
        else {"psum_count": 0, "total_bytes": 0}
    with _LOCK:
        if label is not None:
            _REGISTRY["instr_tags"][str(label)] = list(costs)
            _REGISTRY["instr_kinds"][str(label)] = str(kind)
        _REGISTRY["costs"].update(costs)
        _REGISTRY["collectives"]["hlo_psums"] += int(
            measured.get("psum_count", 0))
        _REGISTRY["collectives"]["hlo_bytes"] += int(
            measured.get("total_bytes", 0))
        _REGISTRY["collectives"]["instances"] += len(collectives or ())
    return len(costs)


def save_sidecar(trace_dir):
    """Write the registry snapshot next to the traces so offline readers
    attribute without the process. Returns the sidecar path, or None when
    there is nothing to save."""
    snap = registry_snapshot()
    if not snap["instr_tags"] and not snap["costs"]:
        return None
    path = os.path.join(trace_dir, SIDECAR_NAME)
    try:
        os.makedirs(trace_dir, exist_ok=True)
        with open(path, "w") as f:
            json.dump(snap, f)
    except OSError:
        return None
    return path


def load_sidecar(trace_dir):
    if not os.path.isdir(trace_dir):
        trace_dir = os.path.dirname(trace_dir)
    path = os.path.join(trace_dir, SIDECAR_NAME)
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


# -- trace parsing ------------------------------------------------------------
def trace_files(trace_dir):
    """The chrome-trace files under ``trace_dir`` (or ``trace_dir``
    itself, a file)."""
    if os.path.isfile(trace_dir):
        return [trace_dir]
    return sorted(glob.glob("%s/**/*%s" % (trace_dir, TRACE_SUFFIX),
                            recursive=True))


def iter_planes(trace_dir):
    """Yield every non-empty DISTINCT trace (the parsed chrome-trace
    dict of one ``torch.profiler`` export) under ``trace_dir``:
    byte-identical files are read once. Raises FileNotFoundError when
    there is none."""
    files = trace_files(trace_dir)
    if not files:
        raise FileNotFoundError("no *%s under %s" % (TRACE_SUFFIX,
                                                     trace_dir))
    seen = set()
    for f in files:
        with open(f, "rb") as fh:
            raw = fh.read()
        digest = hashlib.sha256(raw).digest()
        if digest in seen:
            continue
        seen.add(digest)
        trace = json.loads(raw)
        if trace.get("traceEvents"):
            yield trace


def _slices(trace):
    return [e for e in trace.get("traceEvents", ())
            if e.get("ph") == "X" and "dur" in e]


def top_ops(trace_dir, top_n=25, group="op"):
    """Aggregate device time by raw kernel name from the traces' device
    events (the pre-provenance view; ``group='kind'`` collapses a
    templated name to its function)."""
    per = {}
    total = 0.0
    for trace in iter_planes(trace_dir):
        for e in _slices(trace):
            if e.get("cat") not in _DEVICE_CATS:
                continue
            name = e.get("name", "?")
            if group == "kind":
                name = re.split(r"[<(]", re.sub(r"^void\s+", "", name),
                                1)[0]
            ms = float(e["dur"]) / 1e3
            per[name] = per.get(name, 0.0) + ms
            total += ms
    rows = sorted(per.items(), key=lambda kv: -kv[1])[:top_n]
    return rows, total


class _Ranges:
    """Host ranges (start, end, label) per thread, each thread's kept to
    its outermost ranges, for lookups of the range holding a time."""

    def __init__(self, ranges):
        by_tid = {}
        for r in sorted(ranges, key=lambda r: (r[0], -r[1])):
            kept = by_tid.setdefault(r[3], [])
            if kept and r[0] < kept[-1][1] and r[1] <= kept[-1][1]:
                continue  # nested inside the thread's last range
            kept.append(r)
        self.by_tid = {t: (rs, [r[0] for r in rs])
                       for t, rs in by_tid.items()}
        every = sorted((r for rs in by_tid.values() for r in rs),
                       key=lambda r: r[0])
        self.every = (every, [r[0] for r in every])

    @staticmethod
    def _find(pair, t):
        rs, starts = pair
        i = bisect.bisect_right(starts, t) - 1
        # ranges of other threads overlap: look a few back
        for j in range(i, max(-1, i - 8), -1):
            if rs[j][0] <= t <= rs[j][1]:
                return rs[j]
        return None

    def holding(self, t, tid):
        """The range holding host time ``t``: on thread ``tid`` first,
        then on any thread."""
        own = self.by_tid.get(tid)
        hit = self._find(own, t) if own is not None else None
        return hit if hit is not None else self._find(self.every, t)


def _join(eager, replay):
    """Tags for the events of one replay from the eager run's sequence
    [(name, tag)]: by position when the names match one for one, by an
    in-order subsequence when the replay lacks launches; None when they
    do not match. Returns (tags, partial)."""
    names = [n for n, _ in eager]
    got = [n for n, _, _ in replay]
    if got == names:
        return [t for _, t in eager], False
    if len(got) < len(names):
        tags, i = [], 0
        for n in got:
            while i < len(names) and names[i] != n:
                i += 1
            if i == len(names):
                return None, False
            tags.append(eager[i][1])
            i += 1
        return tags, True
    return None, False


def _first_difference(eager, replay):
    for i, (a, b) in enumerate(zip(eager, replay)):
        if a[0] != b[0]:
            return i, a[0][:80], b[0][:80]
    return min(len(eager), len(replay)), None, None


def _index(trace):
    """A trace's slices sorted out: the tag ranges and the entry ranges
    (``_Ranges``), the launches by correlation and the host events by
    "External id" (each (ts, tid)), the device events, the aten ops."""
    tags, entries = [], []
    launches, external = {}, {}
    device, cpu_ops = [], []
    for e in _slices(trace):
        cat = e.get("cat")
        name = e.get("name", "")
        args = e.get("args") or {}
        ts = float(e["ts"])
        if cat in ("cpu_op", "user_annotation") \
                and args.get("External id") is not None:
            external[args["External id"]] = (ts, e.get("tid"))
        if cat == "user_annotation":
            r = (ts, ts + float(e["dur"]), name, e.get("tid"))
            if name.startswith((EAGER_RANGE, REPLAY_RANGE)):
                entries.append(r)
            elif _TAG_RE.fullmatch(name):
                tags.append(r)
        elif cat in _LAUNCH_CATS:
            if args.get("correlation") is not None:
                launches[args["correlation"]] = (ts, e.get("tid"))
        elif cat in _DEVICE_CATS:
            device.append(e)
        elif cat == "cpu_op":
            cpu_ops.append(e)
    return (_Ranges(tags), _Ranges(entries), launches, external, device,
            cpu_ops)


def _new_join():
    return {"replays": 0, "joined": 0, "partial_replays": 0,
            "mismatches": [], "excluded_ms": 0.0}


def _trace_events(trace):
    """One trace's device events [(name, ms, tag, is_collective)], its
    source, the join's record, and the most collectives a run issued."""
    tags, entries, launches, external, device, cpu_ops = _index(trace)
    if not device:
        return _cpu_events(cpu_ops, tags, entries)
    return _cuda_events(device, tags, entries, launches, external)


def _cpu_events(cpu_ops, tags, entries):
    """The CPU's: the top-level aten ops (no other aten op on their
    thread encloses them) and their host times; the comm lane's
    collectives counted a run (an entry range) at a time."""
    out, runs = [], {}
    for tid_ops in _by_tid(cpu_ops).values():
        last_end = None
        for e in sorted(tid_ops, key=lambda e: (float(e["ts"]),
                                                -float(e["dur"]))):
            ts, name = float(e["ts"]), e.get("name", "?")
            coll = bool(_COLLECTIVE_RE.search(name))
            if coll:
                run = entries.holding(ts, e.get("tid"))
                if run is not None:
                    runs[run] = runs.get(run, 0) + 1
            if last_end is not None and ts < last_end:
                continue  # inside an enclosing aten op
            last_end = ts + float(e["dur"])
            hit = tags.holding(ts, e.get("tid"))
            out.append((name, float(e["dur"]) / 1e3,
                        hit[2] if hit else None, coll))
    return out, "cpu", _new_join(), max(runs.values(), default=0)


def _cuda_events(device, tags, entries, launches, external):
    """The card's: each device event charged to the tag range holding its
    launch; a replay's events joined to its entry's first tagged eager
    run in the trace by kernel order (``_join``)."""
    out = []
    eager_seq = {}   # entry id -> [(name, tag)] of its first eager run
    eager_seen = {}  # entry id -> the range of that run
    replays = {}     # (entry id, range start) -> [(name, ms, collective)]
    runs = {}        # entry range -> collective events in it
    for e in sorted(device, key=lambda e: float(e["ts"])):
        name = e.get("name", "?")
        ms = float(e["dur"]) / 1e3
        coll = bool(_COLLECTIVE_RE.search(name))
        args = e.get("args") or {}
        launch = launches.get(args.get("correlation"))
        if launch is None:
            launch = external.get(args.get("External id"))
        tag = entry = None
        if launch is not None:
            hit = tags.holding(*launch)
            tag = hit[2] if hit else None
            entry = entries.holding(*launch)
        if entry is not None and coll:
            runs[entry] = runs.get(entry, 0) + 1
        if entry is not None and entry[2].startswith(REPLAY_RANGE):
            replays.setdefault((entry[2][len(REPLAY_RANGE):], entry[0]),
                               []).append((name, ms, coll))
            continue
        if entry is not None:
            eid = entry[2][len(EAGER_RANGE):]
            if eager_seen.setdefault(eid, entry) is entry:
                eager_seq.setdefault(eid, []).append((name, tag))
        out.append((name, ms, tag, coll))
    join = _new_join()
    for (eid, _), events in sorted(replays.items(), key=lambda kv: kv[0][1]):
        join["replays"] += 1
        eager = eager_seq.get(eid)
        tags_of, partial = (_join(eager, events) if eager
                            else (None, False))
        if tags_of is None:
            at, want, got = _first_difference(eager or [], events)
            join["mismatches"].append({
                "entry": eid, "eager_events": len(eager or ()),
                "replay_events": len(events), "first_difference": at,
                "eager": want, "replay": got})
            join["excluded_ms"] += sum(ms for _, ms, _ in events)
            continue
        join["joined"] += 1
        join["partial_replays"] += int(partial)
        out.extend((n, ms, t, c) for (n, ms, c), t in zip(events, tags_of))
    source = ("cuda" if join["replays"] and join["joined"] == join["replays"]
              else "cuda-eager")
    return out, source, join, max(runs.values(), default=0)


def _by_tid(events):
    out = {}
    for e in events:
        out.setdefault(e.get("tid"), []).append(e)
    return out


def device_op_events(trace_dir, known=None):
    """Collect the device events of the traces under ``trace_dir``:
    ``([(name, duration_ms, tag or None)], source)`` (``source`` as the
    module says; ``known`` is the reference's argument, unused: every
    event's tag comes from its launch's host range)."""
    events, sources = [], []
    for trace in iter_planes(trace_dir):
        evs, source, _, _ = _trace_events(trace)
        events.extend((n, ms, t) for n, ms, t, _ in evs)
        sources.append(source)
    return events, _merged_source(sources)


def _merged_source(sources):
    if not sources:
        return "cpu"
    if "cuda-eager" in sources:
        return "cuda-eager"
    return sources[0] if len(set(sources)) == 1 else "cuda"


# -- roofline -----------------------------------------------------------------
def classify(flops, nbytes, peak_flops=None, peak_membw=None):
    """Roofline verdict for one op from its static FLOPs/bytes:
    ``compute-bound`` when the arithmetic intensity (FLOPs/byte) sits at
    or above the machine ridge point ``peak_flops / peak_membw``,
    ``memory-bound`` below it, ``unknown`` when either peak is unset
    (``PADDLE_GPU_PEAK_FLOPS`` / ``PADDLE_GPU_PEAK_MEMBW_BYTES``) or
    the op moved no bytes. Collectives never reach here — they get the
    ``comm-bound`` lane in :func:`attribute`."""
    from paddle_tpu_torch import flags

    if peak_flops is None:
        peak_flops = float(flags.get_flag("peak_flops") or 0)
    if peak_membw is None:
        peak_membw = float(flags.get_flag("peak_membw_bytes") or 0)
    if not nbytes or peak_flops <= 0 or peak_membw <= 0:
        return "unknown"
    ridge = peak_flops / peak_membw
    return ("compute-bound" if (float(flops) / float(nbytes)) >= ridge
            else "memory-bound")


def attribute(trace_dir, sidecar=None, peak_flops=None, peak_membw=None):
    return attribute_events(trace_dir, sidecar, peak_flops, peak_membw)[0]


def attribute_events(trace_dir, sidecar=None, peak_flops=None,
                     peak_membw=None):
    """Join the traces' device events (``trace_dir``: a directory or one
    trace file) against the provenance sidecar (or, absent one, the live
    registry) into the per-op table::

        {"ops": {tag: {ms, events, op_type, src_ops, flops, bytes,
                       intensity, verdict, frac}},
         "total_ms", "attributed_ms", "unattributed_ms",
         "attributed_frac", "comm_ms", "collective_instances",
         "expected_collective_instances", "fusion_policy", "source",
         "join"}

    Every tag the registry knows appears in ``ops`` even at 0 ms (an op
    the transforms pruned, or one that launched nothing; "every
    ProgramDesc op in the table" still holds). Time of events under no
    tag lands in the explicit ``unattributed_ms`` bucket. Collectives
    form their own comm lane: their time is attributed (counted in
    ``attributed_frac``) but the verdict is ``comm-bound`` regardless of
    intensity; ``collective_instances`` is the most collectives one run
    of an entry issued. ``join`` is the replays' join record (replays,
    joined, partial_replays, mismatches, excluded_ms).

    ``attribute_events`` returns (the table, the device events it was
    made of: [(name, ms, tag or None)])."""
    sc = sidecar or load_sidecar(trace_dir) or registry_snapshot()
    costs = sc.get("costs", {})
    events, sources, instances = [], [], 0
    join = _new_join()
    for trace in iter_planes(trace_dir):
        evs, source, j, runs = _trace_events(trace)
        events.extend(evs)
        sources.append(source)
        instances = max(instances, runs)
        for k in ("replays", "joined", "partial_replays", "excluded_ms"):
            join[k] += j[k]
        join["mismatches"].extend(j["mismatches"])

    ops = {}
    for tag, c in costs.items():
        ops[tag] = {
            "ms": 0.0, "events": 0,
            "op_type": c.get("op_type") or tag_op_type(tag),
            "src_ops": c.get("src_ops", []),
            "flops": c.get("flops", 0), "bytes": c.get("bytes", 0),
        }
    total = attributed = comm_ms = unattributed = 0.0
    comm_tags = set()
    for name, ms, tag, is_coll in events:
        total += ms
        if is_coll:
            comm_ms += ms
        if tag is None:
            if is_coll:
                attributed += ms  # comm lane is its own attribution
            else:
                unattributed += ms
            continue
        attributed += ms
        row = ops.setdefault(tag, {
            "ms": 0.0, "events": 0, "op_type": tag_op_type(tag),
            "src_ops": [tag_op_type(tag)], "flops": 0, "bytes": 0,
        })
        row["ms"] += ms
        row["events"] += 1
        if is_coll:
            comm_tags.add(tag)

    for tag, row in ops.items():
        nb = row["bytes"]
        row["intensity"] = (float(row["flops"]) / nb) if nb else 0.0
        if tag in comm_tags:
            row["verdict"] = "comm-bound"
        else:
            row["verdict"] = classify(
                row["flops"], nb, peak_flops, peak_membw)
        row["frac"] = (row["ms"] / total) if total else 0.0

    return {
        "ops": ops,
        "total_ms": total,
        "attributed_ms": attributed,
        "unattributed_ms": unattributed,
        "attributed_frac": (attributed / total) if total else 0.0,
        "comm_ms": comm_ms,
        "collective_instances": instances,
        "expected_collective_instances": int(
            sc.get("collectives", {}).get("instances", 0)),
        "fusion_policy": sc.get("policy", POLICY),
        "source": _merged_source(sources),
        "join": join,
    }, [(n, ms, t) for n, ms, t, _ in events]


def gate_issues(table):
    """The roofline gate predicate: issue strings when the table is
    unusable (empty) or the comm lane disagrees with the registered
    collective schedule (the mesh entries' first-run record, the
    ``spmd.prediction_delta`` cross-check at op granularity). Empty
    list = gate passes."""
    issues = []
    hot = [t for t, r in table.get("ops", {}).items() if r["ms"] > 0]
    if not hot:
        issues.append("roofline table is empty: no device time "
                      "attributed to any provenance tag")
    expected = table.get("expected_collective_instances", 0)
    seen = table.get("collective_instances", 0)
    if seen and expected and seen != expected:
        issues.append(
            "collective lane disagrees with the registered collective "
            "schedule: a run issued %d collective(s), registration "
            "recorded %d" % (seen, expected))
    return issues


def window_issues(table):
    """Why a profiled window cannot stand as it is, for a rerun: it
    recorded no device activity, a replay lacks launches (the profiler
    dropped some), or a replay did not join its eager run. Empty list =
    the window is whole."""
    issues = []
    if table.get("total_ms", 0.0) <= 0:
        issues.append("the window recorded no device activity")
    join = table.get("join") or {}
    if join.get("partial_replays"):
        issues.append("%d replay(s) lack launches the profiler dropped"
                      % join["partial_replays"])
    if join.get("mismatches"):
        issues.append("%d replay(s) did not join their eager run"
                      % len(join["mismatches"]))
    return issues


def top_rows(table, top_k=15):
    """The table's hot rows, worst-first: ``[(tag, row)]`` sorted by
    device ms descending, zero-ms rows last (alphabetical)."""
    items = list(table.get("ops", {}).items())
    items.sort(key=lambda kv: (-kv[1]["ms"], kv[0]))
    return items[:top_k]
