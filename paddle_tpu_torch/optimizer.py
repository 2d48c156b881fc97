"""Optimizers — port of ``paddle_tpu/optimizer.py``: the ``Optimizer``
base (:29-151), ``SGD`` (:154), ``Momentum`` (:171), ``LarsMomentum``
(:198), ``Adagrad`` (:232), ``Adam`` (:261), ``Adamax`` (:333),
``DecayedAdagrad`` (:389), ``Adadelta`` (:416), ``RMSProp`` (:449),
``Ftrl`` (:491) and ``ModelAverage`` (:524), unchanged but for their
imports and ``ModelAverage.apply``/``restore`` (reference:
python/paddle/fluid/optimizer.py). Each appends its update ops to the
program, with the same accumulator names and startup init ops as the JAX
package, so both front ends build the same descs.

``ModelAverage.apply`` swaps the averages into the scope's own tensors
in place (and ``restore`` copies the parameters back), so a captured
evaluation graph bound to those tensors reads the averages without a
new capture.
"""

import contextlib

from paddle_tpu_torch import clip as clip_mod
from paddle_tpu_torch import unique_name
from paddle_tpu_torch.backward import append_backward
from paddle_tpu_torch.framework import OpRole, Variable
from paddle_tpu_torch.initializer import ConstantInitializer
from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.regularizer import append_regularization_ops

__all__ = [
    "SGD", "Momentum", "LarsMomentum", "Adagrad", "Adam", "Adamax",
    "DecayedAdagrad", "Adadelta", "RMSProp", "Ftrl", "ModelAverage",
    "SGDOptimizer", "MomentumOptimizer", "LarsMomentumOptimizer",
    "AdagradOptimizer", "AdamOptimizer", "AdamaxOptimizer",
    "DecayedAdagradOptimizer", "AdadeltaOptimizer", "RMSPropOptimizer",
    "FtrlOptimizer", "Optimizer",
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


class LarsMomentum(Optimizer):
    """LARS (reference: optimizer.py:542, lars_momentum_op.cc)."""

    def __init__(self, learning_rate, momentum, lars_coeff=0.001,
                 lars_weight_decay=0.0005, regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        velocity = self._get_accumulator("velocity", param)
        block.append_op(
            type="lars_momentum",
            inputs={
                "Param": [param],
                "Grad": [grad],
                "Velocity": [velocity],
                "LearningRate": [self._create_param_lr(param_and_grad)],
            },
            outputs={"ParamOut": [param], "VelocityOut": [velocity]},
            attrs={
                "mu": self._momentum,
                "lars_coeff": self._lars_coeff,
                "lars_weight_decay": self._lars_weight_decay,
            },
        )


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, regularization=None,
                 name=None, initial_accumulator_value=0.0):
        super().__init__(learning_rate, regularization, name)
        self._epsilon = epsilon
        self._initial_accumulator_value = initial_accumulator_value

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(
                "moment", p,
                fill_value=self._initial_accumulator_value)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        moment = self._get_accumulator("moment", param)
        block.append_op(
            type="adagrad",
            inputs={
                "Param": [param],
                "Grad": [grad],
                "Moment": [moment],
                "LearningRate": [self._create_param_lr(param_and_grad)],
            },
            outputs={"ParamOut": [param], "MomentOut": [moment]},
            attrs={"epsilon": self._epsilon},
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


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1,
                                  shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        moment = self._get_accumulator("moment", param)
        inf_norm = self._get_accumulator("inf_norm", param)
        b1p = self._get_accumulator("beta1_pow_acc", param)
        block.append_op(
            type="adamax",
            inputs={
                "Param": [param],
                "Grad": [grad],
                "Moment": [moment],
                "InfNorm": [inf_norm],
                "Beta1Pow": [b1p],
                "LearningRate": [self._create_param_lr(param_and_grad)],
            },
            outputs={
                "ParamOut": [param],
                "MomentOut": [moment],
                "InfNormOut": [inf_norm],
            },
            attrs={
                "beta1": self._beta1,
                "beta2": self._beta2,
                "epsilon": self._epsilon,
            },
        )

    def _finish_update(self, block, parameters_and_grads):
        for param, grad in parameters_and_grads:
            if grad is None:
                continue
            b1p = self._get_accumulator("beta1_pow_acc", param)
            with block.program._optimized_guard((param, grad)):
                block.append_op(
                    type="scale",
                    inputs={"X": [b1p]},
                    outputs={"Out": [b1p]},
                    attrs={"scale": self._beta1},
                )


class DecayedAdagrad(Optimizer):
    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6,
                 regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self._decay = decay
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        moment = self._get_accumulator("moment", param)
        block.append_op(
            type="decayed_adagrad",
            inputs={
                "Param": [param],
                "Grad": [grad],
                "Moment": [moment],
                "LearningRate": [self._create_param_lr(param_and_grad)],
            },
            outputs={"ParamOut": [param], "MomentOut": [moment]},
            attrs={"decay": self._decay, "epsilon": self._epsilon},
        )


class Adadelta(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95,
                 regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self._epsilon = epsilon
        self._rho = rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("__avg_squared_grad", p)
            self._add_accumulator("__avg_squared_update", p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        asg = self._get_accumulator("__avg_squared_grad", param)
        asu = self._get_accumulator("__avg_squared_update", param)
        block.append_op(
            type="adadelta",
            inputs={
                "Param": [param],
                "Grad": [grad],
                "AvgSquaredGrad": [asg],
                "AvgSquaredUpdate": [asu],
            },
            outputs={
                "ParamOut": [param],
                "AvgSquaredGradOut": [asg],
                "AvgSquaredUpdateOut": [asu],
            },
            attrs={"epsilon": self._epsilon, "rho": self._rho},
        )


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("momentum", p)
            self._add_accumulator("mean_square", p)
            self._add_accumulator("mean_grad", p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        block.append_op(
            type="rmsprop",
            inputs={
                "Param": [param],
                "Grad": [grad],
                "Moment": [self._get_accumulator("momentum", param)],
                "MeanSquare": [self._get_accumulator("mean_square", param)],
                "MeanGrad": [self._get_accumulator("mean_grad", param)],
                "LearningRate": [self._create_param_lr(param_and_grad)],
            },
            outputs={
                "ParamOut": [param],
                "MomentOut": [self._get_accumulator("momentum", param)],
                "MeanSquareOut": [self._get_accumulator("mean_square", param)],
                "MeanGradOut": [self._get_accumulator("mean_grad", param)],
            },
            attrs={
                "decay": self._rho,
                "epsilon": self._epsilon,
                "momentum": self._momentum,
                "centered": self._centered,
            },
        )


class Ftrl(Optimizer):
    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self._l1 = l1
        self._l2 = l2
        self._lr_power = lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        block.append_op(
            type="ftrl",
            inputs={
                "Param": [param],
                "Grad": [grad],
                "SquaredAccumulator": [self._get_accumulator("squared", param)],
                "LinearAccumulator": [self._get_accumulator("linear", param)],
                "LearningRate": [self._create_param_lr(param_and_grad)],
            },
            outputs={
                "ParamOut": [param],
                "SquaredAccumOut": [self._get_accumulator("squared", param)],
                "LinearAccumOut": [self._get_accumulator("linear", param)],
            },
            attrs={"l1": self._l1, "l2": self._l2, "lr_power": self._lr_power},
        )


class ModelAverage(Optimizer):
    """Parameter averaging for evaluation (reference: optimizer.py:1484).
    Appends per-param accumulation ops to the CURRENT main program at
    construction (as the reference does); ``apply`` swaps params for
    their window averages in the scope, ``restore`` swaps back. The
    reference's three-tier sum folding is simplified to one restarting
    window of max_average_window steps."""

    def __init__(self, average_window_rate, min_average_window=10000,
                 max_average_window=10000, regularization=None, name=None):
        from paddle_tpu_torch.framework import default_main_program

        super().__init__(0.0, regularization, name)
        self.average_window = average_window_rate
        self.min_average_window = min_average_window
        self.max_average_window = max_average_window
        self._avg_params = []
        program = default_main_program()
        block = program.global_block()
        with program._op_role_guard(OpRole.Optimize):
            for p in program.all_parameters():
                if not p.trainable:
                    continue
                s = self._add_accumulator("ma_sum", p)
                c = self._add_accumulator("ma_cnt", p, shape=[1])
                old_s = self._add_accumulator("ma_old_sum", p)
                old_c = self._add_accumulator("ma_old_cnt", p, shape=[1])
                total = self._add_accumulator("ma_total", p, shape=[1])
                block.append_op(
                    type="model_average_accum",
                    inputs={"Param": [p], "Sum": [s], "Cnt": [c],
                            "OldSum": [old_s], "OldCnt": [old_c],
                            "Total": [total]},
                    outputs={"SumOut": [s], "CntOut": [c],
                             "OldSumOut": [old_s], "OldCntOut": [old_c],
                             "TotalOut": [total]},
                    attrs={
                        "average_window_rate": self.average_window,
                        "min_average_window": self.min_average_window,
                        "max_average_window": self.max_average_window,
                        "op_role_var": [p.name],
                    },
                )
                self._avg_params.append((p, s, c, old_s, old_c))
        self._stash = {}

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        raise NotImplementedError(
            "ModelAverage accumulates alongside another optimizer; use "
            "apply()/restore() around evaluation")

    @contextlib.contextmanager
    def apply(self, executor, need_restore=True):
        """Swap params for their averages (reference ModelAverage.apply,
        a context manager around evaluation): each parameter's tensor in
        the scope is overwritten in place by (Sum + OldSum) / (Cnt +
        OldCnt), computed on its device, after a copy is kept for
        ``restore``. A parameter whose window holds no update yet keeps
        its value."""
        import torch

        from paddle_tpu_torch.executor import global_scope

        scope = global_scope()
        self._stash = {}
        with torch.no_grad():
            for p, s, c, old_s, old_c in self._avg_params:
                cur = scope.get(p.name)
                vals = [scope.get(v.name) for v in (s, c, old_s, old_c)]
                if cur is None or any(v is None for v in vals):
                    continue
                cur_t = torch.as_tensor(cur)
                sv, cv, osv, ocv = (torch.as_tensor(v).to(cur_t.device)
                                    for v in vals)
                cnt = float((cv + ocv).reshape(-1)[0])
                if cnt < 1:
                    continue
                avg = ((sv + osv) / cnt).to(cur_t.dtype)
                self._stash[p.name] = cur_t.clone()
                if cur_t is cur:
                    cur.copy_(avg)
                else:
                    scope.set(p.name, avg)
        try:
            yield
        finally:
            if need_restore:
                self.restore(executor)

    def restore(self, executor):
        """Copy the parameters kept by ``apply`` back into the scope."""
        import torch

        from paddle_tpu_torch.executor import global_scope

        scope = global_scope()
        with torch.no_grad():
            for name, val in self._stash.items():
                cur = scope.get(name)
                if isinstance(cur, torch.Tensor) and cur.shape == val.shape:
                    cur.copy_(val)
                else:
                    scope.set(name, val)
        self._stash = {}


# Reference-style aliases (fluid.optimizer.SGDOptimizer etc.)
SGDOptimizer = SGD
MomentumOptimizer = Momentum
LarsMomentumOptimizer = LarsMomentum
AdagradOptimizer = Adagrad
AdamOptimizer = Adam
AdamaxOptimizer = Adamax
DecayedAdagradOptimizer = DecayedAdagrad
AdadeltaOptimizer = Adadelta
RMSPropOptimizer = RMSProp
FtrlOptimizer = Ftrl
