"""Shared by the port's parity tests that build a ``py_func`` desc in
both packages.

``py_func``'s ``func_id`` is the length of a process-wide registry when
the callable is first registered (each package keeps its own), so a
test file that earlier registered callables in one package alone shifts
that package's ids in every later test of the same process (a pytest
worker runs many files). A test that compares the two packages' descs
calls ``_align_py_func_registries`` first.
"""

from paddle_tpu.ops import misc_ops as j_misc

from paddle_tpu_torch.ops import misc_ops as t_misc


def _align_py_func_registries():
    """Both packages' ``py_func`` registries as long, so the next
    callables get the same ids whatever other tests of the process
    registered."""
    while len(t_misc._PY_FUNC_REGISTRY) < len(j_misc._PY_FUNC_REGISTRY):
        t_misc.register_py_func(lambda a: a)
    while len(j_misc._PY_FUNC_REGISTRY) < len(t_misc._PY_FUNC_REGISTRY):
        j_misc.register_py_func(lambda a: a)
