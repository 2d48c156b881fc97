"""Builds the port's CUDA kernels from the sources in ``csrc/``.

Each library is one ``nvcc`` call that compiles its sources for Hopper
(``sm_90a``) into a shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds). The build runs
at first use into ``kernels/_build/`` (listed in ``.gitignore``), under a
file name keyed by a hash of the sources and flags, so an edited source
is rebuilt and an unchanged one is reused. ``build_all`` starts one
``nvcc`` per library, all together, and waits for every one.

A first launch can come from any thread (a serving worker beside a
caller's direct run), so building and loading take one process-wide
lock: a second thread that asks for a library being built waits for that
build and loads its result, rather than starting a second ``nvcc`` into
the same temporary file (it is named by process, which threads share).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_HERE, "_build")

# library name -> its sources, relative to this directory
SOURCES = {
    "flash_fwd": ("csrc/flash_fwd.cu",),
    "flash_bwd_dq": ("csrc/flash_bwd_dq.cu",),
    "flash_bwd_dkv": ("csrc/flash_bwd_dkv.cu",),
}
# headers the sources include; each is part of every library's key
HEADERS = ("csrc/flash_common.cuh", "csrc/flash_mma.cuh")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_loaded = {}
# held across the build and the load of a library (re-entered by load)
_lock = threading.RLock()


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
            "kernels are built from source at first use")
    return path


def library_path(name):
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for rel in SOURCES[name] + HEADERS:
        with open(os.path.join(_HERE, rel), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, "%s-%s.so" % (name, h.hexdigest()[:16]))


def build_log(name):
    """The compiler's output (``-Xptxas=-v``: registers, shared memory,
    spills) from the build of ``name``, or '' if it was not built here."""
    path = library_path(name)[:-3] + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def build_all(names=None):
    """Build every library in ``names`` (default: all) that is not built
    yet, one ``nvcc`` each, all started together. Returns {name: seconds}
    for the libraries built by this call; raises on a failed build."""
    with _lock:
        return _build_all(names)


def _build_all(names):
    os.makedirs(BUILD_DIR, exist_ok=True)
    started = {}
    for name in names or SOURCES:
        path = library_path(name)
        if os.path.exists(path):
            continue
        tmp = "%s.%d.tmp" % (path, os.getpid())
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp]
        cmd += [os.path.join(_HERE, rel) for rel in SOURCES[name]]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, path, time.perf_counter())
    seconds, failed = {}, []
    for name, (proc, tmp, path, t0) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        with open(path[:-3] + ".log", "w") as f:
            f.write(log)
        if proc.returncode != 0:
            failed.append("%s (nvcc exit %d):\n%s"
                          % (name, proc.returncode, log))
            continue
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return seconds


def load(name):
    """The ctypes handle of library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        with _lock:
            lib = _loaded.get(name)
            if lib is None:
                build_all([name])
                lib = ctypes.CDLL(library_path(name))
                _loaded[name] = lib
    return lib
