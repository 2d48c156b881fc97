"""Hand-written GPU kernels of the port: CUDA C++ sources in ``csrc/``,
built by ``build.py``, each wrapped beside its plain torch version."""
