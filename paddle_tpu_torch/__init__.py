"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The same Fluid-style Program/Block/Op IR, desc format and ``fluid`` API as
the JAX package, run by an engine that executes each op's torch lowering
eagerly on one NVIDIA card (Hopper, sm_90a), with the JAX package's Pallas
TPU kernels rewritten as hand-written CUDA kernels. The JAX package is the
reference; this package imports nothing of it. Which modules are ported so
far, and which are still to port, is in ROADMAP.md.

Entry point: ``import paddle_tpu_torch.fluid as fluid``.
"""

__version__ = "0.1.0"
