"""Unique name generator (reference: python/paddle/fluid/unique_name.py).

Port of ``paddle_tpu/unique_name.py``, unchanged: the same keys give the
same names (``fc_0.w_0``), so weights carry across the two packages by
name."""

import contextlib
from collections import defaultdict


class UniqueNameGenerator:
    def __init__(self):
        self.ids = defaultdict(int)

    def __call__(self, key):
        tmp = self.ids[key]
        self.ids[key] += 1
        return "%s_%d" % (key, tmp)


generator = UniqueNameGenerator()


def generate(key):
    return generator(key)


def switch(new_generator=None):
    """Swap the global generator, returning the old one (reference:
    unique_name.py switch)."""
    global generator
    old = generator
    generator = new_generator or UniqueNameGenerator()
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    global generator
    old = generator
    generator = new_generator or UniqueNameGenerator()
    try:
        yield
    finally:
        generator = old
