"""chip_smoke.py's profiler helpers when a window drops device activity.

On the H100 a torch.profiler window can come back with no device activity
at all. ``profiled`` profiles such a window again, ``profile_kernels``
reruns windows with counts off, and ``device_ms`` times a call by CUDA
events when no window recorded its kernel. The profiler and the card are
stood in for here, so the logic runs on the CPU."""

import importlib.util
import os
import types

import pytest
import torch
from torch.autograd import DeviceType

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
