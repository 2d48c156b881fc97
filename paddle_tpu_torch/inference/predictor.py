"""Inference engine: AnalysisConfig/Predictor facade over the port's
executor (reference: paddle/fluid/inference/api/analysis_predictor.cc —
CreatePaddlePredictor:734, Run:183). Port of
``paddle_tpu/inference/predictor.py`` for the native path: the predictor
loads a native model directory (``io.save_inference_model``, from either
package) and answers ``run`` on the card, or on the CPU after
``config.disable_gpu()``; ``serve()`` puts a continuous-batching
``InferenceServer`` (serving.py) in front of it. On the card each input
shape runs eagerly once, is captured in a CUDA graph at its second run
and replayed from then on (``engine/executor.py``). The engine's
transforms run at its default ``opt_level`` (1: an unfused attention is
fused back onto the flash kernels) unless ``config.switch_ir_optim(False)``
asks for level 0; the continuous-batching server takes the same level.
INT8
(``enable_mkldnn``/``enable_tensorrt_engine``) is a later slice and
raises, naming its ROADMAP item.
"""

import numpy as np

from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.executor import Executor, scope_guard
from paddle_tpu_torch.inference.serving import InferenceServer
from paddle_tpu_torch.io import load_inference_model
from paddle_tpu_torch.platform import CPUPlace, CUDAPlace


class AnalysisConfig:
    """(reference: paddle_analysis_config.h). The predictor runs on
    ``CUDAPlace(device_id)`` unless ``disable_gpu()`` was called."""

    def __init__(self, model_dir=None, params_file=None):
        self.model_dir = model_dir
        self.params_file = params_file
        self._use_gpu = True
        self._device_id = 0
        self._ir_optim = True

    def disable_gpu(self):
        self._use_gpu = False

    def enable_use_gpu(self, device_id=0):
        self._use_gpu = True
        self._device_id = int(device_id)

    def place(self):
        return CUDAPlace(self._device_id) if self._use_gpu else CPUPlace()

    def switch_ir_optim(self, flag=True):
        """Toggle the transform pipeline for this predictor's runs:
        threaded to the engine's ``opt_level`` (0 when off)."""
        self._ir_optim = bool(flag)

    def enable_mkldnn(self):
        raise NotImplementedError(
            "enable_mkldnn: the INT8 serving path (freeze + post-training "
            "quantization) is ROADMAP Queue 1, inference")

    def enable_tensorrt_engine(self, **kwargs):
        raise NotImplementedError(
            "enable_tensorrt_engine: the INT8 serving path (freeze + "
            "post-training quantization) is ROADMAP Queue 1, inference")


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
        self._exe = Executor(config.place())
        self._scope = Scope()
        with scope_guard(self._scope):
            (self._program, self._feed_names,
             fetch_vars) = load_inference_model(
                config.model_dir, self._exe,
                params_filename=config.params_file)
        self._fetch_names = [f.name for f in fetch_vars]

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
        name->array. Returns list of PaddleTensor."""
        if isinstance(inputs, dict):
            feed = {k: np.asarray(v) for k, v in inputs.items()}
        else:
            feed = {}
            for name, t in zip(self._feed_names, inputs):
                feed[t.name or name] = t.data
        with scope_guard(self._scope):
            outs = self._exe.run(self._program, feed=feed,
                                 fetch_list=self._fetch_names,
                                 opt_level=self._opt_level)
        return [PaddleTensor(o, n) for o, n in zip(outs, self._fetch_names)]

    def serve(self, buckets=None, max_wait_ms=None, name="serving"):
        """Continuous-batching façade: an InferenceServer over this
        predictor's program, scope, and executor (reference:
        ``paddle_tpu/inference/predictor.py:208-221``). The caller starts
        it (context manager or ``.start()``). The server runs at the
        predictor's opt level."""
        return InferenceServer(
            self._program, self._feed_names, self._fetch_names,
            scope=self._scope, executor=self._exe, buckets=buckets,
            max_wait_ms=max_wait_ms, name=name, opt_level=self._opt_level)


def create_paddle_predictor(config):
    """(reference: analysis_predictor.cc:734 factory)."""
    return AnalysisPredictor(config)
