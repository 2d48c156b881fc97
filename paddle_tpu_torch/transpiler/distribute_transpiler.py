"""DistributeTranspiler — port of
``paddle_tpu/transpiler/distribute_transpiler.py`` (reference:
python/paddle/fluid/transpiler/distribute_transpiler.py:161).

The reference rewrites programs for two transports: parameter-server
(param blocks sliced across pservers, trainer send/recv + barriers,
listen_and_serv optimizer blocks — :280-952) and collective "nccl2"
(:226-244, gen_nccl_id bootstrap). Here, as in the JAX package:

* collective mode ("nccl2", or ``trainers`` given as an endpoint list)
  needs NO program rewriting — the collective is the same program run
  over a mesh of the world's ranks; ``get_trainer_program`` returns the
  program unchanged. When ``current_endpoint`` names one of the
  endpoints, ``transpile`` joins this process to the world
  (``parallel.env.init_distributed``: the first endpoint is the
  rendezvous, ``trainer_id`` the rank), the part gen_nccl_id plays.
* "mesh" mode (``config.mode = "mesh"``) returns the program unchanged,
  to run under a mesh (``Executor.run(mesh=...)`` / ``PADDLE_GPU_MESH``):
  gradient reduction is the mesh path's all-reduce, not an RPC.
* pserver mode is reproduced structurally: params are round-robin
  assigned to pserver endpoints, the pserver program gets one optimizer
  sub-block per owned param (the listen_and_serv body), and the trainer
  program's optimizer ops for remote params are replaced by send/recv
  markers. The live RPC transport is ``paddle_tpu_torch.distributed``
  (``ParameterServer``, ``DistTrainer``). Every desc the transpiler
  makes is byte-identical to the JAX package's.
"""

from paddle_tpu_torch.core.desc import VarDescData
from paddle_tpu_torch.framework import OP_ROLE_KEY, OpRole


class DistributeTranspilerConfig:
    """(reference: distribute_transpiler.py:130)"""

    slice_var_up = True
    split_method = None
    min_block_size = 8192
    mode = "pserver"

    def __init__(self):
        self.slice_var_up = True
        self.split_method = None
        self.min_block_size = 8192


class RoundRobin:
    """(reference: ps_dispatcher.py RoundRobin)"""

    def __init__(self, pserver_endpoints):
        self._eps = list(pserver_endpoints)
        self._i = 0

    def dispatch(self, varlist):
        out = []
        for _ in varlist:
            out.append(self._eps[self._i % len(self._eps)])
            self._i += 1
        return out

    def reset(self):
        self._i = 0


class HashName:
    """(reference: ps_dispatcher.py HashName) — stable hash of the var
    name picks the endpoint, so re-transpiles agree without shared
    state."""

    def __init__(self, pserver_endpoints):
        self._eps = list(pserver_endpoints)

    @staticmethod
    def _hash_block(entry, total):
        import zlib

        name = entry[1] or entry[0] if isinstance(entry, tuple) else entry
        return zlib.crc32(str(name).encode("utf-8")) % total

    def dispatch(self, varlist):
        return [self._eps[self._hash_block(v, len(self._eps))]
                for v in varlist]

    def reset(self):
        pass


class DistributeTranspiler:
    def __init__(self, config=None):
        self.config = config or DistributeTranspilerConfig()
        self._mode = None
        self._param_to_ep = {}
        self._param_blocks = {}

    # -- entry point -------------------------------------------------------
    def transpile(self, trainer_id, program=None, pservers="", trainers=1,
                  sync_mode=True, startup_program=None, current_endpoint=""):
        from paddle_tpu_torch.framework import default_main_program

        self.trainer_id = trainer_id
        self.trainer_num = trainers
        self.sync_mode = sync_mode
        self.origin_program = program or default_main_program()
        self.origin_startup = startup_program
        self._dist_tables = {}

        if self.config.mode == "mesh":
            # mesh mode: no program rewriting AND no RPC transport —
            # gradient reduction is the mesh path's all-reduce over the
            # dp axis when the unchanged program is run with a mesh
            # (Executor.run(mesh=...), ParallelExecutor(
            # dist_strategy="mesh"), or the PADDLE_GPU_MESH flag). The
            # transpiler only validates that no pserver-specific feature
            # was requested.
            self._mode = "mesh"
            self._endpoints = []
            block = self.origin_program.desc.global_block()
            dist_tables = [
                op.inputs["W"][0] for op in block.ops
                if op.type == "lookup_table"
                and op.attrs.get("is_distributed", False)]
            if dist_tables:
                raise NotImplementedError(
                    "distributed lookup tables %s need the pserver "
                    "transport; mesh mode shards dense state only"
                    % sorted(set(dist_tables)))
            return

        if isinstance(trainers, str) or self.config.mode == "nccl2":
            # collective mode: endpoints string in `trainers`
            self._mode = "collective"
            self._endpoints = (
                trainers.split(",") if isinstance(trainers, str) else [])
            if current_endpoint and current_endpoint in self._endpoints:
                from paddle_tpu_torch.parallel.env import init_distributed

                init_distributed(coordinator_address=self._endpoints[0],
                                 num_processes=len(self._endpoints),
                                 process_id=int(trainer_id))
            return

        self._mode = "pserver"
        self.pserver_endpoints = [p for p in pservers.split(",") if p]

        # Distributed lookup tables (reference:
        # distribute_lookup_table.py:56 find_distributed_lookup_table):
        # embedding params marked is_distributed are row-sharded across ALL
        # pservers with runtime prefetch, not round-robin-assigned whole.
        self._dist_tables = {}
        block = self.origin_program.desc.global_block()
        for op in block.ops:
            if (op.type == "lookup_table"
                    and op.attrs.get("is_distributed", False)):
                wname = op.inputs["W"][0]
                vd = block.find_var_recursive(wname)
                vocab, dim = int(vd.shape[0]), int(vd.shape[1])
                self._dist_tables[wname] = {
                    "vocab": vocab,
                    "dim": dim,
                    "padding_idx": op.attrs.get("padding_idx", -1),
                    "shards": self._shard_ranges(vocab),
                }

        dispatcher = (self.config.split_method or RoundRobin)(
            self.pserver_endpoints)
        params = [
            p for p in self.origin_program.all_parameters()
            if p.name not in self._dist_tables
        ]
        # slice_var_up (reference: distribute_transpiler.py slice_variable
        # :130-152): split each param into >=min_block_size-element blocks
        # aligned on dim 0, round-robin the BLOCKS over pservers so one
        # big embedding doesn't pin a single server. self._param_blocks:
        # pname -> [(block_name, row_start, row_end, endpoint)], only for
        # params actually split (whole-var params stay in _param_to_ep).
        self._param_blocks = {}
        dispatch_units = []      # (pname, block_name_or_None, rows)
        for p in params:
            blocks = self._slice_rows(p)
            if blocks is None:
                dispatch_units.append((p.name, None, None))
            else:
                for bi, (r0, r1) in enumerate(blocks):
                    dispatch_units.append(
                        (p.name, "%s.block%d" % (p.name, bi), (r0, r1)))
        eps = dispatcher.dispatch(dispatch_units)
        self._param_to_ep = {}
        for (pname, bname, rows), ep in zip(dispatch_units, eps):
            if bname is None:
                self._param_to_ep[pname] = ep
            else:
                self._param_blocks.setdefault(pname, []).append(
                    (bname, rows[0], rows[1], ep))

    def _slice_rows(self, param):
        """Row ranges per block, or None when the param stays whole
        (reference slice_variable's numel/min_block_size formula, dim-0
        aligned)."""
        import math

        if not self.config.slice_var_up:
            return None
        shape = list(param.shape or [])
        if len(shape) == 0:
            return None
        numel = 1
        for d in shape:
            numel *= int(d)
        slice_count = len(self.pserver_endpoints)
        max_count = max(int(numel // float(self.config.min_block_size)), 1)
        split_count = min(max_count, slice_count)
        if split_count <= 1:
            return None
        dim1 = max(numel // int(shape[0]), 1)
        block_size = int(math.ceil(numel / float(split_count)))
        remains = block_size % dim1
        if remains != 0:
            block_size += dim1 - remains
        rows_per = block_size // dim1
        out = []
        r = 0
        while r < int(shape[0]):
            out.append((r, min(r + rows_per, int(shape[0]))))
            r += rows_per
        return out if len(out) > 1 else None

    def _shard_ranges(self, vocab):
        """Contiguous row ranges per pserver (reference splits by blocks via
        split_ids_op's mod sharding; contiguous keeps gathers local)."""
        n = len(self.pserver_endpoints)
        per = (vocab + n - 1) // n
        out = []
        for i, ep in enumerate(self.pserver_endpoints):
            start = min(i * per, vocab)
            end = min(start + per, vocab)
            out.append((ep, start, end))
        return out

    # -- collective / mesh -------------------------------------------------
    def get_trainer_program(self, wait_port=True):
        if self._mode in ("collective", "mesh"):
            return self.origin_program
        return self._build_trainer_program()

    # -- pserver -----------------------------------------------------------
    def _ops_for_param(self, pname):
        """Optimizer-role ops whose op_role_var mentions the param."""
        block = self.origin_program.desc.global_block()
        out = []
        for op in block.ops:
            role = int(op.attrs.get(OP_ROLE_KEY, 0))
            if not role & OpRole.Optimize:
                continue
            rv = op.attrs.get("op_role_var", [])
            if any(v == pname or v == pname + "@GRAD" for v in rv):
                out.append(op)
        return out

    def _build_trainer_program(self):
        """Trainer keeps forward+backward; optimizer ops for params owned by
        remote pservers are replaced by send/recv markers (reference:
        get_trainer_program:554). Distributed lookup tables additionally
        have their lookup/grad ops swapped for the prefetch pair
        (reference: distribute_lookup_table.py — the trainer never holds
        the table; DistTrainer does the prefetch/sparse-send RPC)."""
        trainer = self.origin_program.clone()
        block = trainer.desc.global_block()
        remote_params = set(self._param_to_ep) | set(self._param_blocks)
        new_ops = []
        sent = set()
        # per-lookup prefetch vars: a table looked up twice (shared-vocab
        # CTR embeddings) gets distinct prefetch/grad vars per lookup site
        self._pref_by_out = {}
        self._pref_count = {}
        for op in block.ops:
            role = int(op.attrs.get(OP_ROLE_KEY, 0))
            rv = op.attrs.get("op_role_var", [])
            owned = [v for v in rv if v in remote_params]
            if role & OpRole.Optimize and owned:
                pname = owned[0]
                if pname not in sent:
                    sent.add(pname)
                    if pname in self._param_blocks:
                        # one send per block: the trainer slices the grad
                        # rows (reference: send_op splitting VarBlocks)
                        for bname, r0, r1, ep in self._param_blocks[pname]:
                            new_ops.append(_marker_op(
                                "send", {"X": [pname + "@GRAD"]},
                                {"Out": []},
                                {"endpoints": [ep],
                                 "wire": bname + "@GRAD",
                                 "rows": [r0, r1],
                                 OP_ROLE_KEY: OpRole.RPC}))
                    else:
                        new_ops.append(_marker_op(
                            "send", {"X": [pname + "@GRAD"]},
                            {"Out": []},
                            {"endpoints": [self._param_to_ep[pname]],
                             OP_ROLE_KEY: OpRole.RPC}))
                continue
            if self._dist_tables:
                if (role & OpRole.Optimize
                        and any(v in self._dist_tables for v in rv)):
                    continue  # table updates happen on the shard owners
                if (op.type == "lookup_table"
                        and op.inputs["W"][0] in self._dist_tables):
                    new_ops.append(self._rewrite_dist_lookup(block, op))
                    continue
                if (op.type == "lookup_table_grad"
                        and op.inputs["W"][0] in self._dist_tables):
                    new_ops.append(self._rewrite_dist_lookup_grad(block, op))
                    continue
            new_ops.append(op)
        # recv updated params after the send barrier
        for pname, ep in self._param_to_ep.items():
            new_ops.append(_marker_op(
                "recv", {}, {"Out": [pname]},
                {"endpoints": [ep], OP_ROLE_KEY: OpRole.RPC}))
        for pname, blocks in self._param_blocks.items():
            for bname, r0, r1, ep in blocks:
                new_ops.append(_marker_op(
                    "recv", {}, {"Out": [pname]},
                    {"endpoints": [ep], "wire": bname,
                     "rows": [r0, r1], OP_ROLE_KEY: OpRole.RPC}))
        # The rewritten grad ops no longer produce the table's @GRAD
        # contribution vars. Backward's dedup `sum` over them is dropped;
        # any OTHER surviving consumer (gradient clip / regularization on
        # the table) has no gradient to read — fail loudly rather than
        # miscompute (the reference likewise keeps the distributed table
        # out of clip/regularization, distribute_lookup_table.py).
        if self._dist_tables:
            dangling = set()
            for wname in self._dist_tables:
                dangling.add(wname + "@GRAD")
                for vn in block.vars:
                    if vn.startswith(wname + "@GRAD@"):
                        dangling.add(vn)
            kept = []
            for op in new_ops:
                ins = set(op.input_arg_names())
                outs = set(op.output_arg_names())
                if (op.type == "sum" and outs and outs <= dangling
                        and ins <= dangling):
                    continue
                hit = ins & dangling
                if hit:
                    raise NotImplementedError(
                        "op %r consumes gradient %s of a distributed "
                        "lookup table; gradient clip/regularization on a "
                        "distributed table is not supported" %
                        (op.type, sorted(hit)))
                kept.append(op)
            new_ops = kept
        block.ops = new_ops
        # the table itself no longer exists trainer-side
        for wname in self._dist_tables:
            block.vars.pop(wname, None)
        trainer._bump_version()
        return trainer

    def table_state_var_names(self):
        """Names of each distributed table and its table-shaped optimizer
        state (Adam moments etc.) — state that lives only on shard owners
        and must never be materialized trainer-side."""
        src_block = self.origin_program.desc.global_block()
        out = set()
        for wname, info in self._dist_tables.items():
            out.add(wname)
            for op in self._ops_for_param(wname):
                for n in op.input_arg_names() + op.output_arg_names():
                    vd = src_block.find_var_recursive(n)
                    if (vd is not None and vd.shape is not None
                            and list(vd.shape) == [info["vocab"],
                                                   info["dim"]]):
                        out.add(n)
        return out

    def _new_prefetch_var(self, wname):
        k = self._pref_count.get(wname, 0)
        self._pref_count[wname] = k + 1
        return "%s@PREFETCH.%d" % (wname, k)

    def _ensure_var(self, block, name, shape):
        if name not in block.vars:
            block.vars[name] = VarDescData(name, shape=shape)

    def _rewrite_dist_lookup(self, block, op):
        wname = op.inputs["W"][0]
        info = self._dist_tables[wname]
        pref = self._new_prefetch_var(wname)
        self._pref_by_out[op.outputs["Out"][0]] = pref
        self._ensure_var(block, pref, [None, info["dim"]])
        return _marker_op(
            "distributed_lookup",
            {"Prefetched": [pref], "Ids": list(op.inputs["Ids"])},
            {"Out": list(op.outputs["Out"])},
            # per-site padding_idx: two lookups of one table may differ
            {"padding_idx": op.attrs.get("padding_idx", -1),
             "table_name": wname,
             OP_ROLE_KEY: int(op.attrs.get(OP_ROLE_KEY, 0))})

    def _rewrite_dist_lookup_grad(self, block, op):
        wname = op.inputs["W"][0]
        info = self._dist_tables[wname]
        # the grad op's Out@GRAD names the forward output's grad var;
        # strip the suffix to find which lookup site this differentiates
        og = op.inputs["Out@GRAD"][0]
        from paddle_tpu_torch.framework import grad_var_name

        out_name = og[:-len("@GRAD")] if og.endswith("@GRAD") else og
        pref = self._pref_by_out[out_name]
        gname = grad_var_name(pref)
        self._ensure_var(block, gname, [None, info["dim"]])
        return _marker_op(
            "distributed_lookup_grad",
            {"Ids": list(op.inputs["Ids"]),
             "Out@GRAD": list(op.inputs.get("Out@GRAD", []))},
            {"Prefetched@GRAD": [gname]},
            {"padding_idx": op.attrs.get("padding_idx", -1),
             "table_name": wname,
             OP_ROLE_KEY: int(op.attrs.get(OP_ROLE_KEY, 0))})

    def get_trainer_startup_program(self):
        """Trainer startup without the distributed tables' init — trainers
        must never materialize the full table (reference:
        distribute_transpiler delete_ops on the table init)."""
        if self.origin_startup is None or not self._dist_tables:
            return self.origin_startup
        drop = self.table_state_var_names()
        startup = self.origin_startup.clone()
        block = startup.desc.global_block()
        block.ops = [
            op for op in block.ops
            if not any(n in drop for n in op.output_arg_names())
        ]
        for n in drop:
            block.vars.pop(n, None)
        startup._bump_version()
        return startup

    def get_pserver_program(self, endpoint):
        """One optimizer sub-block per owned param under a listen_and_serv
        root (reference: get_pserver_program:674)."""
        from paddle_tpu_torch.framework import Program

        pserver = Program()
        # copy global vars the optimizer ops touch
        src_block = self.origin_program.desc.global_block()
        dst_block = pserver.desc.global_block()
        owned = [p for p, ep in self._param_to_ep.items() if ep == endpoint]
        opt_blocks = []
        block_grads = []   # grad var consumed by each block (async routing)
        for pname in owned:
            ops = self._ops_for_param(pname)
            sub = pserver.desc.append_block(0)
            _clone_ops_into(sub, ops, src_block, dst_block)
            opt_blocks.append(sub.idx)
            block_grads.append(pname + "@GRAD")

        # sliced params: one optimizer sub-block PER OWNED BLOCK, with the
        # param/grad/state vars renamed to block-unique names and
        # re-declared at the block's row count (reference:
        # _create_vars_from_blocklist + the per-block optimize blocks of
        # get_pserver_program:674; state slicing like _get_optimizer_input)
        sliced_blocks_attr = []
        prune_full = set()   # full-shape originals superseded by renames
        for pname, blocks in self._param_blocks.items():
            pd = src_block.find_var_recursive(pname)
            pshape = list(pd.shape)
            ops = self._ops_for_param(pname)
            for bname, r0, r1, ep in blocks:
                if ep != endpoint:
                    continue
                sub = pserver.desc.append_block(0)
                _clone_ops_into(sub, ops, src_block, dst_block)
                # rename every var the block WRITES (plus param + grad) so
                # two blocks of one param on this server never collide;
                # param-shaped renames also get the block's row count
                written = {pname, pname + "@GRAD"}
                for op in ops:
                    written.update(op.output_arg_names())
                suffix = bname[len(pname):]          # ".block%d"
                rename = {n: n + suffix for n in written
                          if src_block.find_var_recursive(n) is not None}
                rename[pname] = bname
                rename[pname + "@GRAD"] = bname + "@GRAD"
                for op in sub.ops:
                    for slot, names in op.inputs.items():
                        op.inputs[slot] = [rename.get(n, n) for n in names]
                    for slot, names in op.outputs.items():
                        op.outputs[slot] = [rename.get(n, n)
                                            for n in names]
                import copy as _copy

                for old, new in rename.items():
                    vd = dst_block.vars.get(old) or \
                        src_block.find_var_recursive(old)
                    nd = _copy.deepcopy(vd)
                    nd.name = new
                    if nd.shape is not None and list(nd.shape) == pshape:
                        nd.shape = [r1 - r0] + pshape[1:]
                    dst_block.vars[new] = nd
                sliced_blocks_attr.append({
                    "param": pname, "name": bname, "rows": [r0, r1],
                    "rename": dict(rename), "block": sub.idx,
                })
                opt_blocks.append(sub.idx)
                block_grads.append(bname + "@GRAD")
                prune_full.update(old for old, new in rename.items()
                                  if old != new)
        # drop the full-shape descs _clone_ops_into copied — no op on this
        # server references them after renaming, and a declared full-size
        # param would contradict the never-holds-the-whole-var contract
        for old in prune_full:
            dst_block.vars.pop(old, None)

        # Distributed lookup tables: every pserver owns one row-shard of
        # every table. The optimizer sub-block is the ORIGINAL optimizer op
        # fed by make_selected_rows assembling the wire (rows, values) into
        # a SelectedRows grad; table-shaped vars are re-declared at shard
        # shape (reference: the table optimize block of
        # distribute_transpiler.py:952 _create_table_optimize_block).
        dist_tables_attr = []
        for wname, info in self._dist_tables.items():
            shard = [s for s in info["shards"] if s[0] == endpoint]
            if not shard:
                continue
            _, start, end = shard[0]
            shard_rows = end - start
            ops = self._ops_for_param(wname)
            sub = pserver.desc.append_block(0)
            rows_v, vals_v = wname + "@GRAD@ROWS", wname + "@GRAD@VALUES"
            sub.ops.append(_marker_op(
                "make_selected_rows",
                {"Rows": [rows_v], "Values": [vals_v]},
                {"Out": [wname + "@GRAD"]},
                {"height": shard_rows, OP_ROLE_KEY: OpRole.Optimize}))
            dst_block.vars[rows_v] = VarDescData(rows_v, dtype="int64")
            dst_block.vars[vals_v] = VarDescData(vals_v)
            touched = _clone_ops_into(sub, ops, src_block, dst_block)
            # re-declare table-shaped state at shard shape
            sliced = set()
            for n in touched:
                nd = dst_block.vars[n]
                if (nd.shape is not None
                        and list(nd.shape) == [info["vocab"], info["dim"]]):
                    nd.shape = [shard_rows, info["dim"]]
                    sliced.add(n)
            dist_tables_attr.append({
                "name": wname, "start": start, "end": end,
                "vocab": info["vocab"], "block": sub.idx,
                "sliced": sorted(sliced),
            })
            opt_blocks.append(sub.idx)
            block_grads.append(wname + "@GRAD")

        dst_block.ops.append(_marker_op(
            "listen_and_serv", {}, {},
            {"endpoint": endpoint,
             "optimize_blocks": opt_blocks,
             "block_grads": block_grads,
             "Fanin": self.trainer_num,
             "sync_mode": self.sync_mode,
             "dist_tables": dist_tables_attr,
             "sliced_blocks": sliced_blocks_attr,
             OP_ROLE_KEY: OpRole.RPC}))
        pserver._bump_version()
        pserver.blocks = pserver.blocks[:1]
        from paddle_tpu_torch.framework import Block

        pserver.blocks = [Block.__new__(Block)]
        b = pserver.blocks[0]
        b.program = pserver
        b.desc = dst_block
        b.idx = 0
        b.ops = []
        b.vars = {}
        return pserver

    def get_startup_program(self, endpoint=None, pserver_program=None,
                            startup_program=None):
        """Pserver startup. For distributed lookup tables the init ops of
        table-shaped vars are rewritten to this endpoint's SHARD shape so
        no server ever materializes the whole table — the memory contract
        the sharding exists for (reference: get_startup_program:927 slices
        param init blocks the same way)."""
        base = startup_program or self.origin_startup
        if base is None or endpoint is None or not (
                self._dist_tables or self._param_blocks):
            return base
        if pserver_program is None:
            pserver_program = self.get_pserver_program(endpoint)
        lns = pserver_program.desc.global_block().ops[-1]
        resize = {}  # var -> shard rows
        for d in lns.attrs.get("dist_tables", []):
            for n in d["sliced"]:
                resize[n] = d["end"] - d["start"]
        startup = base.clone()
        block = startup.desc.global_block()
        # sliced param blocks: clone each renamed var's init op at the
        # block's row count and drop the full-var init (reference:
        # get_startup_program:927 slicing param init blocks)
        sliced = lns.attrs.get("sliced_blocks", [])
        drop_full = set()
        new_ops = []
        for d in sliced:
            r0, r1 = d["rows"]
            pd = self.origin_program.desc.global_block() \
                .find_var_recursive(d["param"])
            pshape = list(pd.shape)
            for old, new in d["rename"].items():
                drop_full.add(old)
                for op in block.ops:
                    if old in op.output_arg_names():
                        clone = _clone_op(op)
                        for slot, names in clone.outputs.items():
                            clone.outputs[slot] = [
                                new if n == old else n for n in names]
                        if "shape" in clone.attrs and list(
                                clone.attrs["shape"]) == pshape:
                            shp = list(clone.attrs["shape"])
                            shp[0] = r1 - r0
                            clone.attrs["shape"] = shp
                        new_ops.append(clone)
                        vd = block.vars.get(old)
                        if vd is not None:
                            import copy as _copy

                            nd = _copy.deepcopy(vd)
                            nd.name = new
                            if (nd.shape is not None
                                    and list(nd.shape) == pshape):
                                nd.shape = [r1 - r0] + pshape[1:]
                            block.vars[new] = nd
        if sliced:
            block.ops = [
                op for op in block.ops
                if not (set(op.output_arg_names()) & drop_full)
            ] + new_ops
        for op in block.ops:
            for n in op.output_arg_names():
                if n in resize and "shape" in op.attrs:
                    shape = list(op.attrs["shape"])
                    shape[0] = resize[n]
                    op.attrs["shape"] = shape
        for n, rows in resize.items():
            vd = block.vars.get(n)
            if vd is not None and vd.shape:
                vd.shape = [rows] + list(vd.shape[1:])
        startup._bump_version()
        return startup

    def get_pserver_programs(self, endpoint):
        pserver = self.get_pserver_program(endpoint)
        return (pserver, self.get_startup_program(endpoint, pserver))


def _clone_ops_into(sub, ops, src_block, dst_block):
    """Clone ops into a pserver sub-block, copying the var descs they
    touch into the root block; returns the touched var names."""
    import copy

    touched = []
    for op in ops:
        sub.ops.append(_clone_op(op))
        for n in op.input_arg_names() + op.output_arg_names():
            vd = src_block.find_var_recursive(n)
            if vd is None:
                continue
            if n not in dst_block.vars:
                dst_block.vars[n] = copy.deepcopy(vd)
            touched.append(n)
    return touched


def _marker_op(type_, inputs, outputs, attrs):
    from paddle_tpu_torch.core.desc import OpDesc

    return OpDesc(type_, inputs, outputs, attrs)


def _clone_op(op):
    from paddle_tpu_torch.core.desc import OpDesc

    return OpDesc(op.type, {k: list(v) for k, v in op.inputs.items()},
                  {k: list(v) for k, v in op.outputs.items()},
                  dict(op.attrs))
