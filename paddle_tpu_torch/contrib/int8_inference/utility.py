"""Post-training INT8 calibration (reference:
python/paddle/fluid/contrib/int8_inference/utility.py Calibrator — the
fork's headline flow: run FP32 inference over a sample set, collect
activation ranges, emit an INT8 program)."""

import paddle_tpu_torch.fluid as fluid


class Calibrator:
    """Collects abs-max activation statistics by running the float program
    over calibration batches, then freezes an INT8 inference program.

    Backed by the real PTQ pipeline (inference/quantize.py):
    calibrate_program collects the ranges through the metrics registry
    and quantize_desc rewrites conv/fc/matmul in place — the whole
    program is kept (no fetch-cone pruning), so callers can still fetch
    training-side metrics like accuracy from the INT8 program."""

    def __init__(self, *args, **kwargs):
        # reference signature is (*args, **kwargs) (utility.py Calibrator)
        names = ["program", "scope", "exe", "feed_names", "fetch_list",
                 "algo"]
        params = dict(zip(names, args))
        params.update(kwargs)
        self.program = params.get("program")
        self.scope = params.get("scope")
        self.exe = params.get("exe")
        self.feed_names = params.get("feed_names")
        self.fetch_list = params.get("fetch_list")
        self.algo = params.get("algo", "abs_max")
        self._sampled = []
        self._frozen = None
        self._report = None  # QuantReport from the last freeze

    def calibrate_and_freeze(self, batches):
        """batches: iterable of feed dicts. Returns the INT8 program
        (``self.program``, rewritten in place per the reference
        contract)."""
        from paddle_tpu_torch.framework import rebind_program_desc
        from paddle_tpu_torch.inference.quantize import (
            calibrate_program,
            quantize_desc,
        )

        batches = list(batches)
        with fluid.scope_guard(self.scope):
            stats = calibrate_program(
                self.program, batches, scope=self.scope, executor=self.exe,
                max_batches=len(batches) or None)
            work = self.program.desc.clone()
            self._report = quantize_desc(work, self.scope, stats.ranges())
            rebind_program_desc(self.program, work)
        return self.program

    def sample_data(self, batches=None):
        """Collect calibration batches (reference: utility.py
        Calibrator.sample_data). Feed dicts accumulate until
        save_int8_model runs the calibrate-and-freeze flow."""
        if batches is not None:
            self._sampled.extend(batches)
        return len(self._sampled)

    def save_int8_model(self, dirname=None):
        """Run calibration over the sampled batches and freeze the INT8
        program (reference: utility.py Calibrator.save_int8_model);
        optionally save it via save_inference_model."""
        self._frozen = self.calibrate_and_freeze(self._sampled)
        if dirname is not None:
            import paddle_tpu_torch.io as ptio

            fetch_vars = [
                self.program.global_block().var(n)
                if isinstance(n, str) else n for n in self.fetch_list]
            ptio.save_inference_model(
                dirname, list(self.feed_names), fetch_vars, self.exe,
                main_program=self._frozen)
        return self._frozen
