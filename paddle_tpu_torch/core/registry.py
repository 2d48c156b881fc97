"""Operator registry: per-op torch lowering and RNG streams.

Port of ``paddle_tpu/core/registry.py`` with the same ``register_op`` /
``register_no_grad_op`` / ``OpInfo`` / ``OpRegistry`` / ``LowerContext``
contract, over torch tensors. A lowering ``fn(ctx, ins, attrs)`` takes
``ins`` as {slot: [torch.Tensor]} and returns {slot: [torch.Tensor]}; it
runs eagerly on the tensors' device, and on ``meta`` tensors for
build-time shape inference (``framework.infer_shapes_for_op``).

RNG keeps the reference's stream structure: one stream per
(program seed, engine run counter, op rng id) — ``fold_in(PRNGKey(seed),
run_counter)`` at ``paddle_tpu/engine/executor.py:1036`` then
``fold_in(key, rng_id)`` at ``paddle_tpu/core/registry.py:160`` — here a
``torch.Generator`` seeded with a splitmix64 mix of the three integers.
The bits differ from the reference's threefry; the structure (a fresh,
reproducible stream per op per run) is the same.

A dropout seed reaches an op as a 0-d int64 tensor on the device
(``LowerContext.seed``): a view into the run's seed table, which the
engine fills on the host before every run, eager or replayed, with the
values the op's stream draws (``draw_seed``). A captured CUDA graph
therefore reads a new seed at each replay instead of freezing the one of
its capture.

``amp_scope`` / ``amp_enabled`` are the reference's mixed-precision trace
mode (registry.py:19-33): while set, ``mul``, ``conv2d`` and
``fused_attention`` take bfloat16 operands (``ops/common.py``
``amp_cast``); state stays float32.
"""

import contextlib
import contextvars

import torch

# Mixed-precision mode: while set, GEMM, conv and attention lowerings
# compute in bfloat16, parameters staying float32 (master weights by
# construction, since program state is never cast).
_amp_mode = contextvars.ContextVar("paddle_gpu_amp", default=False)


def amp_enabled():
    return _amp_mode.get()


@contextlib.contextmanager
def amp_scope(enabled):
    token = _amp_mode.set(bool(enabled))
    try:
        yield
    finally:
        _amp_mode.reset(token)


class OpInfo:
    def __init__(self, type):
        self.type = type
        self.lower = None
        # grad_maker is kept for the training slice (append_backward)
        self.grad_maker = "default"  # "default" | None | callable
        # Inputs that never receive gradient (e.g. integer id tensors).
        self.no_grad_inputs = frozenset()
        # Whether lowering needs an RNG stream (dropout, random init ops).
        self.needs_rng = False
        # Forward OUTPUT slots the registered *_grad op consumes.
        self.grad_needs_outputs = ()
        # Stateful-output slots that alias an input slot.
        self.inplace_map = {}
        # Whether a CUDA graph may hold the lowering: false for one that
        # reads a device value back to the host or draws from a device
        # generator (a captured graph would freeze the draw); or a
        # function of the op desc, for an op that reads the host only
        # under some of its inputs
        self.capturable = True
        # A needs_rng op that draws one dropout seed a run, its slot in the
        # block's seed table: seed_range(attrs) is the seed's range [0, n)
        # under the op's attrs, or None where they draw no seed
        self.seed_range = None


class OpRegistry:
    _ops = {}

    @classmethod
    def register(cls, info):
        cls._ops[info.type] = info

    @classmethod
    def get(cls, type):
        if type not in cls._ops:
            raise KeyError("Operator %r is not registered" % type)
        return cls._ops[type]

    @classmethod
    def has(cls, type):
        return type in cls._ops

    @classmethod
    def all_types(cls):
        return sorted(cls._ops)


def register_op(type, grad=None, no_grad_inputs=(), needs_rng=False,
                inplace_map=None, grad_needs_outputs=(), capturable=True,
                seed_range=None):
    """Decorator registering ``fn`` as the torch lowering of op ``type``."""

    def deco(fn):
        info = OpInfo(type)
        info.lower = fn
        info.grad_maker = grad if grad is not None else "default"
        info.no_grad_inputs = frozenset(no_grad_inputs)
        info.needs_rng = needs_rng
        info.inplace_map = dict(inplace_map or {})
        info.grad_needs_outputs = tuple(grad_needs_outputs)
        info.capturable = capturable
        info.seed_range = seed_range
        OpRegistry.register(info)
        return fn

    return deco


def register_no_grad_op(type, needs_rng=False, inplace_map=None,
                        capturable=True, seed_range=None):
    """Op whose inputs never get gradients (casts to int, IO, init...)."""

    def deco(fn):
        info = OpInfo(type)
        info.lower = fn
        info.grad_maker = None
        info.needs_rng = needs_rng
        info.inplace_map = dict(inplace_map or {})
        info.capturable = capturable
        info.seed_range = seed_range
        OpRegistry.register(info)
        return fn

    return deco


_MASK64 = (1 << 64) - 1


def _splitmix64(x):
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def stream_seed(seed, run_counter, rng_id, micro=None):
    """63-bit seed of the (seed, run_counter, rng_id) stream; ``micro``
    (micro-batch t of an accumulated step) folds in before the op's id,
    as ``fold_in(key, t)`` does in the reference's scan
    (``engine/lowering.py:668``)."""
    h = _splitmix64(int(seed) & _MASK64)
    h = _splitmix64(h ^ (int(run_counter) & _MASK64))
    if micro is not None:
        h = _splitmix64(h ^ ((int(micro) + 1) & _MASK64))
    h = _splitmix64(h ^ (int(rng_id) & _MASK64))
    return h >> 1


def _stream_generator(seed, run_counter, rng_id, device="cpu"):
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, run_counter, rng_id))
    return gen


def draw_seed(seed, run_counter, rng_id, high, micro=None):
    """The dropout seed of op ``rng_id`` in run ``run_counter`` (and
    micro-batch ``micro`` of an accumulated step): one integer in
    [0, high) drawn on the host from the op's stream."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(stream_seed(seed, run_counter, rng_id, micro))
    return int(torch.randint(0, high, (), generator=gen))


class LowerContext:
    """Per-op context handed to lowerings.

    ``device`` is where the op's outputs are created (``meta`` during
    build-time shape inference); ``rng_seed`` is the (seed, run_counter)
    pair of the current engine run, or None when the op runs without RNG;
    ``seeds`` maps an op's RNG stream id to its entry of the run's seed
    table (a 0-d int64 tensor on the device), or is None outside an engine
    run.
    """

    def __init__(self, op, block, device, rng_seed=None, op_index=0,
                 is_test=False, executor=None, seeds=None):
        self.op = op
        self.block = block
        self.device = torch.device(device)
        self._rng_seed = rng_seed
        self.op_index = op_index
        self.is_test = is_test
        self.executor = executor
        self._seeds = seeds

    def attr(self, name, default=None):
        return self.op.attrs.get(name, default)

    def var_desc(self, name):
        return self.block.find_var_recursive(name)

    def rng(self, device=None):
        """A ``torch.Generator`` unique to this op instance within the run,
        on ``device`` (default: the op's device); None on ``meta`` (shape
        inference draws nothing). Scalars such as a kernel seed are drawn
        from a ``"cpu"`` stream so no device value is read back."""
        device = self.device if device is None else torch.device(device)
        if device.type == "meta":
            return None
        if self._rng_seed is None:
            raise RuntimeError(
                "Op %s needs RNG but block was lowered without a seed"
                % self.op.type)
        seed, run_counter = self._rng_seed
        return _stream_generator(seed, run_counter, self.op_index, device)

    def seed(self, high):
        """The op's dropout seed in [0, high): in an engine run, its entry
        of the run's seed table, a 0-d int64 tensor that ops read on the
        device; for a context made outside a run (build-time shape
        inference, a direct call of a lowering) the same value
        (``draw_seed``) as a Python int."""
        if self._seeds is not None:
            return self._seeds[self.op_index]
        if self._rng_seed is None:
            raise RuntimeError(
                "Op %s needs RNG but block was lowered without a seed"
                % self.op.type)
        seed, run_counter = self._rng_seed
        return draw_seed(seed, run_counter, self.op_index, high)
