"""contrib — port of ``paddle_tpu/contrib/__init__.py`` for the subset the
port carries: ``mixed_precision`` (bfloat16 AMP). Quantization, the
decoder API and the statistics tools are later slices (ROADMAP Queue 1,
item 12)."""

from paddle_tpu_torch.contrib import mixed_precision  # noqa: F401
