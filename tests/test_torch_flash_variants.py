"""Every compile-time variant of ``tools/torch_flash_variants.py`` still
applies to the committed kernel sources: each string it replaces is found
exactly once, as the tool requires before it builds the variant on the
card."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import torch_flash_variants  # noqa: E402

CSRC = os.path.join(ROOT, "paddle_tpu_torch", "kernels", "csrc")


@pytest.mark.parametrize("name", sorted(torch_flash_variants.VARIANTS))
def test_variant_applies_once(name):
    texts = {}
    for fname, old, new in torch_flash_variants.VARIANTS[name]:
        if fname not in texts:
            with open(os.path.join(CSRC, fname)) as f:
                texts[fname] = f.read()
        assert texts[fname].count(old) == 1, (name, fname, old)
        texts[fname] = texts[fname].replace(old, new)
