"""First load of the port's kernel libraries from several threads at once
(paddle_tpu_torch/kernels/build.py ``load`` / ``build_all`` and
flash_attention.py ``_lib``), on the CPU against a stubbed ``nvcc`` and
``ctypes.CDLL``: the threads share one build (one ``nvcc``, no temporary
file left behind) and one handle, whose C signatures are declared once
before any thread can use it. The same race on the card, two threads
launching the forward on an empty build directory, is a check of
``chip_smoke.py``'s ``serve_batched`` phase."""

import os
import subprocess
import threading
import time
import types

import pytest

from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.kernels import flash_attention as fa

THREADS = 6


class _FakeNvcc:
    """Popen stand-in: writes its ``-o`` file after a pause, as nvcc
    would, and counts its runs."""

    runs = []

    def __init__(self, cmd, **kwargs):
        self.out = cmd[cmd.index("-o") + 1]
        self.returncode = None
        _FakeNvcc.runs.append(self.out)

    def communicate(self):
        time.sleep(0.2)
        with open(self.out, "wb") as f:
            f.write(b"\x7fELF stub")
        self.returncode = 0
        return "ptxas info    : Used 64 registers\n", None


class _FakeLib:
    def __init__(self, path):
        self.path = path


def _race(fn, n=THREADS):
    barrier = threading.Barrier(n)
    results, errors = [None] * n, []

    def worker(i):
        try:
            barrier.wait(timeout=30)
            results[i] = fn()
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errors, errors
    return results


@pytest.fixture
def stub_build(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    # the build module's own names, so no other code sees the stubs
    monkeypatch.setattr(build, "subprocess", types.SimpleNamespace(
        Popen=_FakeNvcc, PIPE=subprocess.PIPE, STDOUT=subprocess.STDOUT))
    monkeypatch.setattr(build, "ctypes", types.SimpleNamespace(
        CDLL=_FakeLib))
    _FakeNvcc.runs = []
    return tmp_path / "_build"


def test_load_from_threads_builds_once(stub_build):
    libs = _race(lambda: build.load("flash_fwd"))
    assert len(_FakeNvcc.runs) == 1
    assert all(lib is libs[0] for lib in libs)
    assert libs[0].path == build.library_path("flash_fwd")
    left = sorted(os.listdir(stub_build))
    assert not [n for n in left if n.endswith(".tmp")], left
    assert build.build_log("flash_fwd").startswith("ptxas info")
    # built: a later load and a later build_all start no nvcc
    assert build.load("flash_fwd") is libs[0]
    assert build.build_all(["flash_fwd"]) == {}
    assert len(_FakeNvcc.runs) == 1


def test_lib_declares_signatures_once_across_threads(monkeypatch):
    """``_lib`` hands out a handle only after its entry point's argtypes
    and restype are set, and loads it once."""
    loads = []

    class Fn:
        pass

    class Lib:
        def __init__(self):
            self.flash_fwd = Fn()
            self.flash_fwd_error_string = Fn()

    def fake_load(name):
        time.sleep(0.1)
        loads.append(name)
        return Lib()

    monkeypatch.setattr(fa, "_libs", {})
    monkeypatch.setattr(build, "load", fake_load)
    libs = _race(lambda: fa._lib("flash_fwd"))
    assert loads == ["flash_fwd"]
    assert all(lib is libs[0] for lib in libs)
    assert len(libs[0].flash_fwd.argtypes) == fa._N_POINTERS["flash_fwd"] \
        + len(fa._TAIL_ARGS)
    assert libs[0].flash_fwd_error_string.restype is not None
