"""Inference engine: AnalysisConfig/Predictor facade over the port's
executor (reference: paddle/fluid/inference/api/analysis_predictor.cc —
CreatePaddlePredictor:734, Run:183). Port of
``paddle_tpu/inference/predictor.py``: the predictor loads a native
model directory (``io.save_inference_model``, from either package) and
answers ``run`` on the card, or on the CPU after ``config.disable_gpu()``;
``serve()`` puts a continuous-batching ``InferenceServer`` (serving.py)
in front of it. On the card each input shape runs eagerly once, is
captured in a CUDA graph at its second run and replayed from then on
(``engine/executor.py``). The engine's transforms run at its default
``opt_level`` (1: an unfused attention is fused back onto the flash
kernels) unless ``config.switch_ir_optim(False)`` asks for level 0; the
continuous-batching server takes the same level.

``enable_mkldnn()`` / ``enable_tensorrt_engine()`` are the reference's
self-calibrating INT8 switch (predictor.py:36-50, 164-200): the first
``serving_calibration_batches`` live batches run in float32 and are
kept (one host copy a feed) as calibration data; then the program is
frozen (BN folded), calibrated, quantized and swapped in, so that its
convolutions and GEMMs run on the card's int8 tensor cores
(``ops/quant_ops.py``). A model directory holding the AOT artifact
(``aot.py``, ``export_format="aot"``) of the port, exported for the
predictor's device, runs through ``AotPredictor`` instead; an artifact
the port cannot load (the JAX package's StableHLO) leaves the predictor
on the native files beside it.
"""

import numpy as np
import torch

from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.executor import Executor, scope_guard
from paddle_tpu_torch.inference.serving import InferenceServer
from paddle_tpu_torch.io import load_inference_model
from paddle_tpu_torch.platform import CPUPlace, CUDAPlace


class AnalysisConfig:
    """(reference: paddle_analysis_config.h). The predictor runs on
    ``CUDAPlace(device_id)`` unless ``disable_gpu()`` was called; the
    MKLDNN/TensorRT low-precision knobs select the INT8 path."""

    def __init__(self, model_dir=None, params_file=None):
        self.model_dir = model_dir
        self.params_file = params_file
        self._use_gpu = True
        self._device_id = 0
        self._ir_optim = True
        self._int8 = False
        self._int8_announced = False

    def disable_gpu(self):
        self._use_gpu = False

    def enable_use_gpu(self, memory_pool_init_size_mb=0, device_id=0):
        self._use_gpu = True
        self._device_id = int(device_id)

    def place(self):
        return CUDAPlace(self._device_id) if self._use_gpu else CPUPlace()

    def switch_ir_optim(self, flag=True):
        """Toggle the transform pipeline for this predictor's runs:
        threaded to the engine's ``opt_level`` (0 when off)."""
        self._ir_optim = bool(flag)

    def enable_mkldnn(self):
        """The reference fork's MKL-DNN INT8 serving path: opts the
        predictor into post-training INT8 quantization (calibrate on the
        first live batches, then rewrite conv/fc/matmul to int8)."""
        self._request_int8("mkldnn")

    def enable_tensorrt_engine(self, **kwargs):
        """TensorRT parity knob: the same INT8 path as enable_mkldnn
        (precision_mode is honored as int8)."""
        self._request_int8("tensorrt")

    def _request_int8(self, api):
        from paddle_tpu_torch import observability as obs

        self._int8 = True
        if not self._int8_announced:
            obs.event("inference.int8_path_enabled", api=api)
            self._int8_announced = True


class PaddleTensor:
    """Plain container matching the reference's PaddleTensor."""

    def __init__(self, data=None, name=None):
        self.name = name
        self.data = np.asarray(data) if data is not None else None

    @property
    def shape(self):
        return list(self.data.shape) if self.data is not None else None


class AnalysisPredictor:
    def __init__(self, config):
        self.config = config
        self._aot = None
        self._calib_feeds = []
        if config.model_dir is not None:
            self._aot = _load_aot(config)
        if self._aot is not None:
            self._feed_names = self._aot.feed_names
            self._fetch_names = self._aot.fetch_names
            return
        self._exe = Executor(config.place())
        self._scope = Scope()
        with scope_guard(self._scope):
            (self._program, self._feed_names,
             fetch_vars) = load_inference_model(
                config.model_dir, self._exe,
                params_filename=config.params_file)
        self._fetch_names = [f.name for f in fetch_vars]

    @classmethod
    def from_frozen(cls, dirname=None, program=None, feed_names=None,
                    fetch_names=None, scope=None, config=None):
        """Build a predictor from a frozen artifact directory
        (io.save_frozen_model) or from an in-memory frozen program +
        feed/fetch lists + scope (reference: predictor.py:110-136)."""
        from paddle_tpu_torch.io import load_frozen_model

        self = cls.__new__(cls)
        self.config = config or AnalysisConfig()
        self._aot = None
        self._calib_feeds = []
        self._exe = Executor(self.config.place())
        self._scope = scope if scope is not None else Scope()
        if dirname is not None:
            (self._program, self._feed_names, self._fetch_names,
             _meta) = load_frozen_model(dirname, scope=self._scope)
        else:
            if program is None or feed_names is None or fetch_names is None:
                raise ValueError("from_frozen needs dirname= or all of "
                                 "program=/feed_names=/fetch_names=")
            self._program = program
            self._feed_names = list(feed_names)
            self._fetch_names = [
                f.name if hasattr(f, "name") else str(f)
                for f in fetch_names]
        return self

    def get_input_names(self):
        return list(self._feed_names)

    def get_output_names(self):
        return list(self._fetch_names)

    @property
    def _opt_level(self):
        # switch_ir_optim(False) forces level 0; True leaves the engine's
        # flag in charge (None)
        return None if self.config._ir_optim else 0

    def run(self, inputs):
        """inputs: list of PaddleTensor (positional by feed order) or dict
        name->array (or tensor). Returns list of PaddleTensor."""
        if isinstance(inputs, dict):
            feed = {k: v if isinstance(v, torch.Tensor) else np.asarray(v)
                    for k, v in inputs.items()}
        else:
            feed = {}
            for name, t in zip(self._feed_names, inputs):
                feed[t.name or name] = t.data
        if self._aot is not None:
            outs = self._aot.run(feed)
        else:
            if self.config._int8:
                self._maybe_quantize(feed)
            with scope_guard(self._scope):
                outs = self._exe.run(self._program, feed=feed,
                                     fetch_list=self._fetch_names,
                                     opt_level=self._opt_level)
        return [PaddleTensor(o, n) for o, n in zip(outs, self._fetch_names)]

    def _maybe_quantize(self, feed):
        """Self-calibrating INT8 (enable_mkldnn/enable_tensorrt_engine):
        the first ``serving_calibration_batches`` live batches run fp32
        and double as calibration data (one host copy a feed: a tensor on
        the card comes back in one transfer); then the program is frozen
        (BN folded), calibrated, quantized, and swapped in."""
        from paddle_tpu_torch import flags
        from paddle_tpu_torch import observability as obs

        if self._calib_feeds is None:
            return  # already swapped
        self._calib_feeds.append({k: _host_copy(v) for k, v in feed.items()})
        needed = int(flags.get_flag("serving_calibration_batches"))
        if len(self._calib_feeds) < needed:
            return
        from paddle_tpu_torch.inference.freeze import freeze_program
        from paddle_tpu_torch.inference.quantize import (
            calibrate_program,
            quantize_program,
        )

        with scope_guard(self._scope):
            frozen, _ = freeze_program(
                self._program, self._feed_names, self._fetch_names,
                scope=self._scope)
            stats = calibrate_program(frozen, self._calib_feeds,
                                      scope=self._scope, executor=self._exe,
                                      max_batches=needed)
            int8_prog, report = quantize_program(frozen, stats,
                                                 scope=self._scope)
        self._program = int8_prog
        self._calib_feeds = None
        self.quant_report = report
        obs.event("inference.int8_swapped",
                  quantized=len(report.quantized),
                  skipped=len(report.skipped))

    def serve(self, buckets=None, max_wait_ms=None, name="serving"):
        """Continuous-batching façade: an InferenceServer over this
        predictor's program, scope, and executor (reference:
        ``paddle_tpu/inference/predictor.py:208-221``). The caller starts
        it (context manager or ``.start()``). The server runs at the
        predictor's opt level."""
        if self._aot is not None:
            raise NotImplementedError(
                "serve() needs the native program path; the AOT artifact "
                "predictor has no desc to batch against")
        return InferenceServer(
            self._program, self._feed_names, self._fetch_names,
            scope=self._scope, executor=self._exe, buckets=buckets,
            max_wait_ms=max_wait_ms, name=name, opt_level=self._opt_level)


def create_paddle_predictor(config):
    """(reference: analysis_predictor.cc:734 factory)."""
    return AnalysisPredictor(config)


def _host_copy(value):
    """A kept calibration feed: a host numpy copy (one device-to-host
    transfer for a tensor on the card)."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.array(value, copy=True)


def _load_aot(config):
    """The ``AotPredictor`` of ``config.model_dir`` when it holds an
    artifact the port exported for the predictor's device, else None (no
    artifact, another device, or one the port cannot load: the JAX
    package's StableHLO payload)."""
    from paddle_tpu_torch.aot import AotPredictor, has_aot_artifact

    if not has_aot_artifact(config.model_dir):
        return None
    if config._use_gpu and not torch.cuda.is_available():
        # the native path raises for the missing card
        return None
    try:
        aot = AotPredictor(config.model_dir)
    except Exception:
        return None
    return aot if aot.runs_on("cuda" if config._use_gpu else "cpu") else None
