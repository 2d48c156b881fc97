"""Ring attention: exact attention with the sequence axis split over the
``sp`` axis of a mesh. Port of ``paddle_tpu/parallel/ring_attention.py``.

Q/K/V are split along the sequence: rank ``idx`` of the ``sp`` group
holds block ``idx`` of each. At step ``i`` it contracts its Q block with
the K/V block of rank ``src = (idx - i) mod n`` through the flash forward
kernel at the step's global offsets (``idx*t``, ``src*t``), merges the
partial output into a float32 accumulator by the logaddexp of the
lse::

    lse' = logaddexp(lse, lse_i)
    o'   = o * exp(lse - lse') + o_i * exp(lse_i - lse')

and hands the K/V block to the next rank (``batch_isend_irecv`` on the
``sp`` group) while it computes. A causal step whose keys all lie after
its queries is skipped: its weight in the merge is exactly 0.

The backward is a ``torch.autograd.Function`` (the reference
differentiates its scan): from the merged output and the global lse, the
backward kernels give each step's exact dQ, dK and dV (with the global
lse, ``p = exp(s - lse)`` is the full row's softmax), dQ adds up on the
rank, and dK/dV ride the ring with their K/V block back to its owner.
This differs from the reference's scan BPTT only by rounding.

A step is a plain function of (local Q, the K/V block in hand): the
distributed ring (``ring_attention``) and ``ring_attention_blocks``, which
plays every rank in one process, run the same ``_fwd_step`` and
``_bwd_step``. ``use_flash=None`` dispatches on ``q.is_cuda``: the CUDA
kernels on the card, their plain versions on the CPU.
"""

import torch
import torch.distributed as dist

_NEG = -1e30


def reference_attention(q, k, v, causal=False, scale=None):
    """Plain attention oracle, [B, H, T, D]."""
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        T = q.shape[2]
        mask = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask[None, None], s, torch.full_like(s, _NEG))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v)


def _kernels(use_flash, q):
    from paddle_tpu_torch.kernels import flash_attention as fa

    flash = q.is_cuda if use_flash is None else bool(use_flash)
    if flash:
        return fa.flash_forward_cuda, fa.flash_backward_cuda
    return fa.attention_lse_plain, fa.attention_bwd_plain


def _skipped(causal, idx, src):
    return causal and src > idx


def _fwd_step(o, lse, q, k, v, idx, src, causal, scale, use_flash):
    """One forward step on rank ``idx`` holding block ``src``: the kernel at
    the step's global offsets, merged into (o, lse) in float32."""
    if _skipped(causal, idx, src):
        return o, lse
    t = q.shape[2]
    fwd, _ = _kernels(use_flash, q)
    o_i, lse_i = fwd(q, k, v, None, (idx * t, src * t), 0, causal, scale,
                     0.0)
    lse_new = torch.logaddexp(lse, lse_i)
    o = (o * torch.exp(lse - lse_new).unsqueeze(-1)
         + o_i.float() * torch.exp(lse_i - lse_new).unsqueeze(-1))
    return o, lse_new


def _bwd_step(dq, acc, q, k, v, out, lse, g, idx, src, causal, scale,
              use_flash):
    """One backward step: block ``src``'s exact contributions, dQ into
    ``dq`` and dK/dV into the accumulator ``acc`` [2, ...] (float32) that
    travels with the block."""
    if _skipped(causal, idx, src):
        return dq, acc
    t = q.shape[2]
    _, bwd = _kernels(use_flash, q)
    dq_i, dk_i, dv_i = bwd(q, k, v, out, lse, g, None, None,
                           (idx * t, src * t), 0, causal, scale, 0.0)
    return dq + dq_i.float(), acc + torch.stack([dk_i, dv_i]).float()


def _init(q):
    B, H, t, D = q.shape
    return (torch.zeros((B, H, t, D), dtype=torch.float32, device=q.device),
            torch.full((B, H, t), _NEG, dtype=torch.float32,
                       device=q.device))


def ring_attention_blocks(qs, ks, vs, causal=False, scale=None,
                          use_flash=None, grads=None):
    """Every rank of an ``n``-block ring played in one process: ``qs``,
    ``ks``, ``vs`` are the n sequence blocks ([B, H, t, D] each). Runs
    the same steps as ``ring_attention``, a rank's payload handed to the
    next rank after each step. Returns the output blocks and their lse;
    with ``grads`` (the output blocks' cotangents) also (dq, dk, dv)
    blocks from the ring's backward."""
    n = len(qs)
    qs = [q.contiguous() for q in qs]
    scale = scale if scale is not None else qs[0].shape[-1] ** -0.5
    state = [_init(q) for q in qs]
    kv = [torch.stack([k, v]) for k, v in zip(ks, vs)]
    for i in range(n):
        for idx in range(n):
            src = (idx - i) % n
            state[idx] = _fwd_step(*state[idx], qs[idx], kv[idx][0],
                                   kv[idx][1], idx, src, causal, scale,
                                   use_flash)
        kv = [kv[(idx - 1) % n] for idx in range(n)]
    outs = [o.to(q.dtype) for (o, _), q in zip(state, qs)]
    lses = [lse for _, lse in state]
    if grads is None:
        return outs, lses
    dqs = [torch.zeros_like(o) for o, _ in state]
    kv = [torch.stack([k, v]) for k, v in zip(ks, vs)]
    acc = [torch.zeros((2,) + tuple(k.shape), dtype=torch.float32,
                       device=k.device) for k in ks]
    for i in range(n):
        for idx in range(n):
            src = (idx - i) % n
            dqs[idx], acc[idx] = _bwd_step(
                dqs[idx], acc[idx], qs[idx], kv[idx][0], kv[idx][1],
                outs[idx], lses[idx],
                grads[idx].to(qs[idx].dtype).contiguous(), idx,
                src, causal, scale, use_flash)
        kv = [kv[(idx - 1) % n] for idx in range(n)]
        acc = [acc[(idx - 1) % n] for idx in range(n)]
    return (outs, lses,
            ([d.to(q.dtype) for d, q in zip(dqs, qs)],
             [a[0].to(k.dtype) for a, k in zip(acc, ks)],
             [a[1].to(v.dtype) for a, v in zip(acc, vs)]))


def _pass(payloads, group, idx, n):
    """Start sending each payload to the next rank of ``group`` and
    receiving the previous rank's; returns a callable that waits and
    gives the received tensors."""
    if payloads[0].is_cuda and \
            str(dist.get_backend(group)).lower() == "gloo":
        # gloo's send/recv move host memory only: it would abort the
        # process on a CUDA tensor
        raise NotImplementedError(
            "batch_isend_irecv: the gloo process group takes no CUDA "
            "tensors for send/recv; run the ring on NCCL (one card a "
            "rank) or on the CPU")
    nxt = dist.get_global_rank(group, (idx + 1) % n)
    prv = dist.get_global_rank(group, (idx - 1) % n)
    bufs = [torch.empty_like(p) for p in payloads]
    ops = []
    for p, b in zip(payloads, bufs):
        ops.append(dist.P2POp(dist.isend, p.contiguous(), nxt, group))
        ops.append(dist.P2POp(dist.irecv, b, prv, group))
    works = dist.batch_isend_irecv(ops)

    def wait():
        for w in works:
            w.wait()
        return bufs

    return wait


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, idx, n, causal, scale, use_flash):
        o, lse = _init(q)
        kv = torch.stack([k, v])
        for i in range(n):
            src = (idx - i) % n
            wait = _pass([kv], group, idx, n) if i + 1 < n else None
            o, lse = _fwd_step(o, lse, q, kv[0], kv[1], idx, src, causal,
                               scale, use_flash)
            if wait is not None:
                kv = wait()[0]
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (group, idx, n, causal, scale, use_flash)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        group, idx, n, causal, scale, use_flash = ctx.args
        g = g.to(q.dtype).contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        acc = torch.zeros((2,) + tuple(k.shape), dtype=torch.float32,
                          device=k.device)
        kv = torch.stack([k, v])
        for i in range(n):
            src = (idx - i) % n
            dq, acc = _bwd_step(dq, acc, q, kv[0], kv[1], out, lse, g, idx,
                                src, causal, scale, use_flash)
            if n > 1:
                # the accumulator goes on with its block; after n passes
                # each rank holds its own block's dK/dV
                payload = [kv, acc] if i + 1 < n else [acc]
                got = _pass(payload, group, idx, n)()
                if i + 1 < n:
                    kv, acc = got
                else:
                    acc = got[0]
        return (dq.to(q.dtype), acc[0].to(k.dtype), acc[1].to(v.dtype),
                None, None, None, None, None, None)


def _ring_local(q, k, v, group, idx, n, causal, scale, use_flash):
    """The ring on this rank's blocks [B, H, t, D]."""
    return _RingAttention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), group, idx, n, causal,
                                scale, use_flash)


def ring_attention(q, k, v, mesh=None, axis_name="sp", causal=False,
                   scale=None, batch_axis=None, use_flash=None):
    """Exact attention with the sequence axis split over ``axis_name``.

    q, k, v: [B, H, T, D], T divisible by the axis size; plain tensors
    (the same value on every rank: each rank takes its block, and the
    output is gathered back whole) or DTensors on ``mesh`` (laid out with
    T split over ``axis_name``, and the batch over ``batch_axis`` when
    given; the output stays so split). Differentiable.

    ``use_flash``: None (the CUDA kernels for CUDA tensors, their plain
    versions for CPU ones), True (the kernels) or False (the plain
    versions)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from paddle_tpu_torch.parallel.mesh import (axis_sizes, current_spmd,
                                                get_default_mesh)
    from paddle_tpu_torch.parallel.plan import from_shard

    if mesh is None:
        spmd = current_spmd()
        mesh = (spmd[0] if spmd is not None
                and axis_name in axis_sizes(spmd[0])
                else get_default_mesh(q.device.type))
    sizes = axis_sizes(mesh)
    if axis_name not in sizes:
        raise ValueError("mesh %r has no axis %r" % (sizes, axis_name))
    n = sizes[axis_name]
    if q.shape[2] % n:
        raise ValueError(
            "seq len %d not divisible by %s=%d" % (q.shape[2], axis_name, n))
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    names = list(sizes)
    sp_dim = names.index(axis_name)
    group = mesh.get_group(sp_dim)
    idx = mesh.get_local_rank(sp_dim)

    dtensor = isinstance(q, DTensor)
    if dtensor:
        # T over the ring's axis, the batch over batch_axis; a split of
        # the batch or the heads on another axis is kept
        target = []
        for name, pl in zip(names, q.placements):
            if name == axis_name:
                target.append(Shard(2))
            elif name == batch_axis:
                target.append(Shard(0))
            elif isinstance(pl, Shard) and pl.dim in (0, 1):
                target.append(pl)
            else:
                target.append(Replicate())
        target = tuple(target)
        blocks = [t.redistribute(mesh, target).to_local() for t in (q, k, v)]
        out = _ring_local(*blocks, group, idx, n, causal, scale, use_flash)
        return from_shard(out, mesh, target)

    spec = [Replicate()] * len(names)
    spec[sp_dim] = Shard(2)
    if batch_axis is not None:
        spec[names.index(batch_axis)] = Shard(0)
    blocks = [_take_block(t, mesh, spec) for t in (q, k, v)]
    out = _ring_local(*blocks, group, idx, n, causal, scale, use_flash)
    return _gather_blocks(out, mesh, spec)


class _TakeBlock(torch.autograd.Function):
    """This rank's block along one dim of one mesh axis, of a tensor that
    every rank holds whole; the backward all-gathers the blocks' grads,
    so every rank gets the whole grad."""

    @staticmethod
    def forward(ctx, x, group, n, dim, idx):
        ctx.args = (group, n, dim)
        return x.chunk(n, dim=dim)[idx].contiguous()

    @staticmethod
    def backward(ctx, g):
        group, n, dim = ctx.args
        parts = [torch.empty_like(g) for _ in range(n)]
        dist.all_gather(parts, g.contiguous(), group=group)
        return torch.cat(parts, dim=dim), None, None, None, None


def _take_block(x, mesh, spec):
    """``local_chunk`` of a whole tensor, differentiable."""
    from torch.distributed.tensor import Shard

    for mdim, pl in enumerate(spec):
        n = mesh.mesh.shape[mdim]
        if isinstance(pl, Shard) and n > 1:
            x = _TakeBlock.apply(x, mesh.get_group(mdim), n, pl.dim,
                                 mesh.get_local_rank(mdim))
    return x


class _GatherBlocks(torch.autograd.Function):
    """All-gather along one dim of one mesh axis; the backward takes this
    rank's slice of the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, x, group, n, dim, idx):
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        ctx.args = (n, dim, idx)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        n, dim, idx = ctx.args
        return g.chunk(n, dim=dim)[idx].contiguous(), None, None, None, None


def _gather_blocks(x, mesh, spec):
    """The whole tensor from each rank's block under ``spec`` (the inverse
    of ``local_chunk``), differentiable."""
    from torch.distributed.tensor import Shard

    for mdim in reversed(range(len(spec))):
        pl = spec[mdim]
        n = mesh.mesh.shape[mdim]
        if isinstance(pl, Shard) and n > 1:
            x = _GatherBlocks.apply(x, mesh.get_group(mdim), n, pl.dim,
                                    mesh.get_local_rank(mdim))
    return x
