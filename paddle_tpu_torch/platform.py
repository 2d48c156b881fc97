"""Places: device identity tags (reference: paddle/fluid/platform/place.h).

Port of ``paddle_tpu/platform.py``. The port's accelerator is an NVIDIA
card, so the Place variant is {CPUPlace, CUDAPlace}, each naming one
``torch.device`` (``CUDAPinnedPlace`` is a CPUPlace). The default place
is the card: ``default_place()`` is
``CUDAPlace(0)``, and turning a CUDAPlace into a device raises when CUDA
is missing. Nothing falls back to the CPU; a caller asks for it with
``CPUPlace()``.
"""

import torch


class Place:
    def __eq__(self, other):
        return type(self) is type(other) and self.__dict__ == other.__dict__

    def __hash__(self):
        return hash((type(self).__name__, tuple(sorted(self.__dict__.items()))))


class CPUPlace(Place):
    def __repr__(self):
        return "CPUPlace"

    def torch_device(self):
        return torch.device("cpu")


class CUDAPlace(Place):
    def __init__(self, device_id=0):
        self.device_id = int(device_id)

    def __repr__(self):
        return "CUDAPlace(%d)" % self.device_id

    def torch_device(self):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "%r: CUDA is not available to this process. The port runs "
                "on the card by default and never falls back; pass "
                "fluid.CPUPlace() (or AnalysisConfig.disable_gpu()) to run "
                "on the CPU." % self)
        if self.device_id >= torch.cuda.device_count():
            raise RuntimeError("%r: only %d CUDA device(s) visible"
                               % (self, torch.cuda.device_count()))
        return torch.device("cuda", self.device_id)


class CUDAPinnedPlace(CPUPlace):
    """Page-locked host memory (reference: platform/place.h
    CUDAPinnedPlace). A place for host-side feed buffers: it runs as the
    CPU (``PrefetchingFeeder`` pins its own staging buffers)."""

    def __repr__(self):
        return "CUDAPinnedPlace"


def is_compiled_with_cuda():
    return torch.backends.cuda.is_built()


def default_place():
    return CUDAPlace(0)
