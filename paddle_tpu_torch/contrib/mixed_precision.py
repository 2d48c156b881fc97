"""Mixed precision (bfloat16) training — port of
``paddle_tpu/contrib/mixed_precision.py``.

A program marked with ``enable_bf16`` (or minimized through a
``decorate``-d optimizer) runs its ops under the engine's AMP mode
(``core/registry.py`` ``amp_scope``): ``mul``, ``conv2d`` and
``fused_attention`` cast their float32 operands to bfloat16, which the
H100's tensor cores take (cuBLAS GEMMs and cuDNN convolutions
accumulating in float32, and the bfloat16 instances of the flash
kernels). A convolution's output stays bfloat16; batch norm, softmax and
global average pooling compute in float32 inside and return the
activation's dtype, so bfloat16 activations flow between ops
(``paddle_tpu/ops/nn_ops.py:33-43``). Parameters, batch norm's running
statistics and optimizer state stay float32, so they are the master
weights. bfloat16 has float32's exponent range, so no loss scaling is
needed.
"""


def enable_bf16(program):
    """Mark the program for bf16 compute (matmuls, attention); returns
    it."""
    program._amp = True
    return program


def disable_bf16(program):
    program._amp = False
    return program


class _DecoratedOptimizer:
    def __init__(self, optimizer):
        self._opt = optimizer

    def __getattr__(self, name):
        return getattr(self._opt, name)

    def minimize(self, loss, **kwargs):
        enable_bf16(loss.block.program)
        return self._opt.minimize(loss, **kwargs)


def decorate(optimizer, amp_lists=None, init_loss_scaling=1.0,
             use_dynamic_loss_scaling=False):
    """``fluid.contrib.mixed_precision.decorate``: wraps the optimizer so
    that ``minimize()`` turns on bf16 compute for the loss's program. The
    loss-scaling knobs are accepted and unused (bf16 needs none)."""
    return _DecoratedOptimizer(optimizer)
