"""chip_smoke.py's profiler helpers when a window drops device activity.

On the H100 a torch.profiler window can come back with no device activity
at all. ``profiled`` profiles such a window again, ``profile_kernels``
reruns windows with counts off, ``window_ms`` attributes a window's
launches to the calls that made them (restoring a dropped launch), and
``device_ms`` times a call by CUDA events when no window recorded its
kernel. The profiler and the card are stood in for here, so the logic
runs on the CPU."""

import importlib.util
import os
import types

import pytest
import torch
from torch.autograd import DeviceType
from torch.autograd.profiler_util import Kernel

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(__file__), os.pardir,
                               "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def _event(key, count, us):
    return types.SimpleNamespace(key=key, count=count,
                                 device_type=DeviceType.CUDA,
                                 self_device_time_total=us)


class _FakeProfile:
    """Stands in for torch.profiler.profile: the i-th window holds
    ``windows[i]`` (a list of key_averages events)."""

    windows = []
    opened = 0

    def __init__(self, activities=None):
        self.events_ = _FakeProfile.windows[_FakeProfile.opened]
        _FakeProfile.opened += 1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def events(self):
        return self.events_

    def key_averages(self):
        return self.events_


@pytest.fixture
def fake_profiler(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    monkeypatch.setattr(chip_smoke, "PARTIAL_PROFILES", [])
    monkeypatch.setattr(chip_smoke, "EVENT_TIMED", [])
    _FakeProfile.opened = 0
    return _FakeProfile


@pytest.mark.parametrize("empty", [1, chip_smoke.EMPTY_WINDOW_RETRIES])
def test_empty_windows_are_profiled_again(fake_profiler, empty):
    kernel = _event("flash_fwd_kernel<bf16>", 20, 200.0)
    fake_profiler.windows = [[]] * empty + [[kernel]]
    kernels = chip_smoke.profile_kernels(lambda: None, 20)
    assert fake_profiler.opened == empty + 1
    assert kernels["flash_fwd_kernel<bf16>"]["per_call"] == 1
    assert kernels["flash_fwd_kernel<bf16>"]["ms"] == pytest.approx(0.01)
    assert chip_smoke.PARTIAL_PROFILES == \
        [{"calls": 20, "odd_counts": []}] * empty


def test_last_partial_window_then_empty_keeps_kernels(fake_profiler):
    # two windows with a count off, then an empty one: the empty one is
    # profiled again, so the window returned still holds the kernel
    odd = [_event("flash_fwd_kernel<bf16>", 20, 200.0),
           _event("elementwise_kernel", 38, 38.0)]
    good = [_event("flash_fwd_kernel<bf16>", 20, 200.0)]
    fake_profiler.windows = [odd, odd, [], good]
    assert chip_smoke.device_ms(lambda: None, "flash_fwd", warmup=0) == \
        pytest.approx(0.01)
    assert chip_smoke.EVENT_TIMED == []


def test_device_ms_times_by_events_when_no_window_has_the_kernel(
        fake_profiler, monkeypatch):
    fake_profiler.windows = [[]] * (chip_smoke.EMPTY_WINDOW_RETRIES + 1) * 3
    monkeypatch.setattr(chip_smoke, "event_ms", lambda fn, n: 0.25)
    assert chip_smoke.device_ms(lambda: None, "flash_fwd", warmup=0) == 0.25
    assert chip_smoke.EVENT_TIMED == [["flash_fwd", 0.25, []]]

    _FakeProfile.opened = 0
    monkeypatch.setattr(chip_smoke, "event_ms", lambda fn, n: 0.0)
    with pytest.raises(RuntimeError, match="no device time of kernel"):
        chip_smoke.device_ms(lambda: None, "flash_fwd", warmup=0)


def _host(name, start, end, kernels=(), device_type=DeviceType.CPU):
    """A host event (or, with ``device_type``, a device-side copy of a
    label) spanning [start, end] us that launched ``kernels`` ((name,
    us) pairs)."""
    kernels = [Kernel(k, 0, us) for k, us in kernels]
    us = sum(k.duration for k in kernels)
    return types.SimpleNamespace(
        name=name, key=name, count=1, device_type=device_type,
        time_range=types.SimpleNamespace(start=start, end=end),
        kernels=kernels, self_device_time_total=us, device_time_total=us)


def _launches(name, kernel, us, times, start, step=1):
    """``times`` host events ``name`` from ``start``, ``step`` us apart,
    each launching ``kernel`` for ``us``."""
    return [_host(name, start + i * step, start + i * step + 0.5,
                  [(kernel, us)]) for i in range(times)]


def test_window_ms_counts_each_kernel_for_the_span_that_launched_it(
        fake_profiler, monkeypatch):
    """One window for every call: each launch counts for the label whose
    host span holds it, on any thread (a backward's launches from
    autograd's thread, a device-side copy of a label not added); a label
    without device time is timed by CUDA events; an empty window is
    profiled again."""
    kernel = _event("elementwise_kernel", 10, 100.0)
    window = ([kernel, _host("chip_smoke_call_0", 0, 100)]
              + _launches("cudaLaunchKernel", "fwd", 40.0, 5, 10)
              + [_host("autograd::engine::evaluate_function", 40, 60)]
              # another thread
              + _launches("cudaLaunchKernel", "bwd", 60.0, 5, 45)
              + [_host("chip_smoke_call_0", 0, 100, [("label", 9999.0)],
                       DeviceType.CUDA),
                 _host("chip_smoke_call_1", 150, 200),
                 # between the spans
                 _host("cudaMemsetAsync", 120, 121, [("memset", 50.0)])])
    fake_profiler.windows = [[], window]
    monkeypatch.setattr(chip_smoke, "event_ms", lambda fn, n: 0.25)
    calls = []
    out = chip_smoke.window_ms([(("a", "ms"), lambda: calls.append("a")),
                                (("b", "vjp_ms"), lambda: calls.append("b"))],
                               n=5, warmup=1)
    assert out == {("a", "ms"): pytest.approx(0.1), ("b", "vjp_ms"): 0.25}
    assert chip_smoke.EVENT_TIMED == [[str(("b", "vjp_ms")), 0.25, []]]
    assert fake_profiler.opened == 2
    # a warm-up each, then 5 calls each in every window run
    assert calls == ["a", "b"] + (["a"] * 5 + ["b"] * 5) * 2


def test_window_ms_restores_a_dropped_launch(fake_profiler):
    """A label's kernel one launch short of a multiple of the calls keeps
    its mean time a call (a dropped 60 ms launch does not take 12 ms off
    the label); a kernel further off counts its window time over the
    calls."""
    window = ([_event("conv_fwd", 1, 60e3), _host("chip_smoke_call_0", 0, 100)]
              + _launches("aten::conv", "conv_fwd", 60e3, 4, 10)
              + _launches("aten::add", "add", 10.0, 5, 50)
              + _launches("aten::nonzero", "scan", 20.0, 13, 60))
    fake_profiler.windows = [window]
    out = chip_smoke.window_ms([("vjp", lambda: None)], n=5, warmup=0)
    assert out == {"vjp": pytest.approx(60.0 + 0.01 + 13 * 0.02 / 5)}
    assert fake_profiler.opened == 1
    assert chip_smoke.EVENT_TIMED == []
