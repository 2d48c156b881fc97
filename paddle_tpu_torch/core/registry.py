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
"""

import torch


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
                inplace_map=None, grad_needs_outputs=()):
    """Decorator registering ``fn`` as the torch lowering of op ``type``."""

    def deco(fn):
        info = OpInfo(type)
        info.lower = fn
        info.grad_maker = grad if grad is not None else "default"
        info.no_grad_inputs = frozenset(no_grad_inputs)
        info.needs_rng = needs_rng
        info.inplace_map = dict(inplace_map or {})
        info.grad_needs_outputs = tuple(grad_needs_outputs)
        OpRegistry.register(info)
        return fn

    return deco


def register_no_grad_op(type, **kwargs):
    """Op whose inputs never get gradients (casts to int, IO, init...)."""

    def deco(fn):
        info = OpInfo(type)
        info.lower = fn
        info.grad_maker = None
        info.needs_rng = kwargs.get("needs_rng", False)
        info.inplace_map = dict(kwargs.get("inplace_map") or {})
        OpRegistry.register(info)
        return fn

    return deco


_MASK64 = (1 << 64) - 1


def _splitmix64(x):
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def stream_seed(seed, run_counter, rng_id):
    """63-bit seed of the (seed, run_counter, rng_id) stream."""
    h = _splitmix64(int(seed) & _MASK64)
    h = _splitmix64(h ^ (int(run_counter) & _MASK64))
    h = _splitmix64(h ^ (int(rng_id) & _MASK64))
    return h >> 1


class LowerContext:
    """Per-op context handed to lowerings.

    ``device`` is where the op's outputs are created (``meta`` during
    build-time shape inference); ``rng_seed`` is the (seed, run_counter)
    pair of the current engine run, or None when the op runs without RNG.
    """

    def __init__(self, op, block, device, rng_seed=None, op_index=0,
                 is_test=False, executor=None):
        self.op = op
        self.block = block
        self.device = torch.device(device)
        self._rng_seed = rng_seed
        self.op_index = op_index
        self.is_test = is_test
        self.executor = executor

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
        gen = torch.Generator(device=device)
        gen.manual_seed(stream_seed(seed, run_counter, self.op_index))
        return gen
