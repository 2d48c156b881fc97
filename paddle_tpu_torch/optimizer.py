"""Optimizers — port of ``paddle_tpu/optimizer.py`` for the ``Optimizer``
base (:29-151), ``SGD`` (:154), ``Momentum`` (:171) and ``Adam`` (:261),
unchanged but for their imports (reference: python/paddle/fluid/
optimizer.py — Optimizer base with accumulators :0-409, SGD:410,
Momentum:457, Adam:717). Each appends update ops to the program
(``sgd``, ``momentum``, ``adam`` and the beta-power ``scale`` ops), with
the same accumulator names and startup init ops as the JAX package. The
other optimizers are listed in ROADMAP.md (Queue 1, the training path).
"""

from paddle_tpu_torch import clip as clip_mod
from paddle_tpu_torch import unique_name
from paddle_tpu_torch.backward import append_backward
from paddle_tpu_torch.framework import OpRole, Variable
from paddle_tpu_torch.initializer import ConstantInitializer
from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.regularizer import append_regularization_ops

__all__ = [
    "SGD", "Momentum", "Adam", "SGDOptimizer", "MomentumOptimizer",
    "AdamOptimizer", "Optimizer",
]


class Optimizer:
    def __init__(self, learning_rate, regularization=None, name=None):
        self._learning_rate = learning_rate
        self.regularization = regularization
        self._name = name
        self._accumulators = {}  # acc_name -> {param_name: var}
        self._lr_var = None
        self.helper = None

    # -- learning rate -----------------------------------------------------
    def _create_global_learning_rate(self):
        if isinstance(self._learning_rate, Variable):
            self._lr_var = self._learning_rate
            return
        if self._lr_var is not None:
            return
        helper = LayerHelper("learning_rate")
        self._lr_var = helper.create_global_variable(
            name=unique_name.generate("learning_rate"),
            shape=[1],
            dtype="float32",
            persistable=True,
        )
        helper.set_variable_initializer(
            self._lr_var, ConstantInitializer(float(self._learning_rate))
        )

    def _global_learning_rate(self):
        return self._lr_var

    def _create_param_lr(self, param_and_grad):
        param = param_and_grad[0]
        param_lr = getattr(param, "optimize_attr", {}).get("learning_rate", 1.0)
        if isinstance(param_lr, Variable):
            # a per-param LR variable (e.g. layers.append_LARS writes one)
            # multiplies the global LR in-program (reference:
            # optimizer.py _create_param_lr's Variable branch)
            helper = LayerHelper("param_lr")
            out = helper.create_variable_for_type_inference(
                dtype="float32")
            helper.append_op(
                type="elementwise_mul",
                inputs={"X": [self._lr_var], "Y": [param_lr]},
                outputs={"Out": [out]},
                attrs={"axis": -1},
            )
            return out
        if param_lr == 1.0:
            return self._lr_var
        helper = LayerHelper("param_lr")
        out = helper.create_variable_for_type_inference(dtype="float32")
        helper.append_op(
            type="scale",
            inputs={"X": [self._lr_var]},
            outputs={"Out": [out]},
            attrs={"scale": float(param_lr)},
        )
        return out

    # -- accumulators ------------------------------------------------------
    def _add_accumulator(self, name, param, dtype=None, fill_value=0.0,
                         shape=None):
        if name in self._accumulators and param.name in self._accumulators[name]:
            return self._accumulators[name][param.name]
        helper = LayerHelper(name)
        var = helper.create_global_variable(
            name=unique_name.generate("%s_%s" % (param.name, name)),
            shape=shape or list(param.shape),
            dtype=dtype or param.dtype,
            persistable=True,
        )
        helper.set_variable_initializer(var, ConstantInitializer(fill_value))
        self._accumulators.setdefault(name, {})[param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    def _create_accumulators(self, block, parameters):
        pass

    def _finish_update(self, block, parameters_and_grads):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    # -- main entry points (reference: optimizer.py:286,318,357) -----------
    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return append_backward(loss, parameter_list, no_grad_set, callbacks)

    def apply_gradients(self, params_grads):
        program = params_grads[0][0].block.program
        block = program.global_block()
        # All update machinery is Optimize-role: pruned from for_test clones
        # (reference: optimizer.py apply_gradients under _optimized_guard).
        with program._op_role_guard(OpRole.Optimize):
            self._create_global_learning_rate()

            params_grads = clip_mod.append_gradient_clip_ops(params_grads)
            params_grads = append_regularization_ops(
                params_grads, self.regularization
            )

            self._create_accumulators(block, [p for p, _ in params_grads])
            for param_and_grad in params_grads:
                if param_and_grad[1] is None:
                    continue
                with program._optimized_guard(param_and_grad):
                    self._append_optimize_op(block, param_and_grad)
            self._finish_update(block, params_grads)
        return params_grads

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(
            loss, startup_program, parameter_list, no_grad_set
        )
        optimize_ops = self.apply_gradients(params_grads)
        return optimize_ops, params_grads


class SGD(Optimizer):
    def __init__(self, learning_rate, regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        block.append_op(
            type="sgd",
            inputs={
                "Param": [param],
                "Grad": [grad],
                "LearningRate": [self._create_param_lr(param_and_grad)],
            },
            outputs={"ParamOut": [param]},
        )


class Momentum(Optimizer):
    def __init__(self, learning_rate, momentum, use_nesterov=False,
                 regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        velocity = self._get_accumulator("velocity", param)
        block.append_op(
            type="momentum",
            inputs={
                "Param": [param],
                "Grad": [grad],
                "Velocity": [velocity],
                "LearningRate": [self._create_param_lr(param_and_grad)],
            },
            outputs={"ParamOut": [param], "VelocityOut": [velocity]},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov},
        )


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, regularization=None, name=None,
                 lazy_mode=False):
        super().__init__(learning_rate, regularization, name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1,
                                  shape=[1])
            self._add_accumulator("beta2_pow_acc", p, fill_value=self._beta2,
                                  shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        m1 = self._get_accumulator("moment1", param)
        m2 = self._get_accumulator("moment2", param)
        b1p = self._get_accumulator("beta1_pow_acc", param)
        b2p = self._get_accumulator("beta2_pow_acc", param)
        block.append_op(
            type="adam",
            inputs={
                "Param": [param],
                "Grad": [grad],
                "Moment1": [m1],
                "Moment2": [m2],
                "Beta1Pow": [b1p],
                "Beta2Pow": [b2p],
                "LearningRate": [self._create_param_lr(param_and_grad)],
            },
            outputs={
                "ParamOut": [param],
                "Moment1Out": [m1],
                "Moment2Out": [m2],
            },
            attrs={
                "beta1": self._beta1,
                "beta2": self._beta2,
                "epsilon": self._epsilon,
            },
        )

    def _finish_update(self, block, parameters_and_grads):
        """Advance beta powers once per step, under _optimized_guard so the
        scale ops carry op_role_var and the DistributeTranspiler routes them
        to the owning pserver (reference: optimizer.py:855 Adam
        _finish_update wraps these in _optimized_guard([param, grad]))."""
        for param, grad in parameters_and_grads:
            if grad is None:
                continue
            b1p = self._get_accumulator("beta1_pow_acc", param)
            b2p = self._get_accumulator("beta2_pow_acc", param)
            with block.program._optimized_guard((param, grad)):
                block.append_op(
                    type="scale",
                    inputs={"X": [b1p]},
                    outputs={"Out": [b1p]},
                    attrs={"scale": self._beta1},
                )
                block.append_op(
                    type="scale",
                    inputs={"X": [b2p]},
                    outputs={"Out": [b2p]},
                    attrs={"scale": self._beta2},
                )


# Reference-style aliases (fluid.optimizer.SGDOptimizer etc.)
SGDOptimizer = SGD
MomentumOptimizer = Momentum
AdamOptimizer = Adam
