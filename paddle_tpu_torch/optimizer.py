"""Optimizer family.

The counterpart of ``paddle_tpu/optimizer.py``: the base class creates a
learning-rate variable and per-parameter accumulators, and ``minimize``
= append_backward + (regularize, clip) + per-param optimize ops. Every
class builds the same Program as in the JAX package and runs in the port
(ops/optimizer_ops.py): SGD, Momentum (with or without Nesterov),
Adagrad, Adam, Adamax, DecayedAdagrad, Adadelta, RMSProp, Ftrl, and
ModelAverage's windowed parameter sums.
"""

import torch


from .core import unique_name
from .core.backward import append_backward
from .core.program import Variable, default_main_program, default_startup_program
from .clip import append_gradient_clip_ops, error_clip_callback
from .initializer import ConstantInitializer
from .layers.layer_helper import LayerHelper
from .regularizer import append_regularization_ops


class Optimizer:
    def __init__(self, learning_rate, regularization=None, LARS_weight_decay=0.0):
        if not isinstance(learning_rate, (float, int, Variable)):
            raise TypeError("learning rate must be float or Variable")
        self._learning_rate = learning_rate
        self.regularization = regularization
        self._learning_rate_map = {}
        self._accumulators = {}       # name -> {param_name: var}
        self.helper = None
        self._global_step = None

    # -- lr ------------------------------------------------------------------
    def _create_global_learning_rate(self):
        prog = default_main_program()
        lr = self._learning_rate_map.get(prog)
        if lr is not None:
            return
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_map[prog] = self._learning_rate
            return
        from .layers import tensor as tensor_layers
        lr = tensor_layers.create_global_var(
            name=unique_name.generate("learning_rate"),
            shape=[1], value=float(self._learning_rate),
            dtype="float32", persistable=True)
        self._learning_rate_map[prog] = lr

    def _global_learning_rate(self, program=None):
        program = program or default_main_program()
        return self._learning_rate_map.get(program)

    def _create_param_lr(self, param_and_grad):
        param = param_and_grad[0]
        base = self._global_learning_rate()
        param_lr = getattr(param, "optimize_attr", {}).get("learning_rate", 1.0)
        if param_lr == 1.0:
            return base
        from .layers import math_ops
        return math_ops.scale_var(base, param_lr)

    # -- accumulators --------------------------------------------------------
    def _add_accumulator(self, name, param, dtype=None, fill_value=0.0,
                         shape=None):
        if name in self._accumulators and \
                param.name in self._accumulators[name]:
            raise Exception("accumulator %s for %s exists" % (name, param.name))
        self._accumulators.setdefault(name, {})
        helper = self.helper or LayerHelper("optimizer")
        var = helper.create_global_variable(
            name=unique_name.generate(param.name + "_" + name),
            persistable=True, dtype=dtype or param.dtype,
            shape=shape or param.shape)
        helper.set_variable_initializer(var, ConstantInitializer(fill_value))
        self._accumulators[name][param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    # -- subclass hooks ------------------------------------------------------
    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def _finish_update(self, block):
        pass

    # -- main entry ----------------------------------------------------------
    def _create_optimization_pass(self, parameters_and_grads, loss,
                                  startup_program=None):
        program = loss.block.program
        block = program.global_block()
        self.helper = LayerHelper(self.__class__.__name__,
                                  startup_program=startup_program)
        self._create_accumulators(
            block, [p for p, g in parameters_and_grads if g is not None])
        self._create_global_learning_rate()

        optimize_ops = []
        for param_and_grad in parameters_and_grads:
            if param_and_grad[1] is None:
                continue
            if getattr(param_and_grad[0], "trainable", True):
                optimize_ops.append(
                    self._append_optimize_op(block, param_and_grad))
        self._finish_update(block)
        return optimize_ops

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = append_backward(loss, parameter_list, no_grad_set,
                                       [error_clip_callback])
        params_grads = sorted(params_grads, key=lambda x: x[0].name)
        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        optimize_ops = self._create_optimization_pass(
            params_grads, loss, startup_program)
        return optimize_ops, params_grads

    def apply_gradients(self, params_grads):
        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)

        class _Loss:
            block = params_grads[0][0].block
        return self._create_optimization_pass(params_grads, _Loss)

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        return append_backward(loss, parameter_list, no_grad_set)


class SGDOptimizer(Optimizer):
    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            type="sgd",
            inputs={"Param": [p], "Grad": [g],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [p]})


class MomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum, use_nesterov=False, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        velocity = self._get_accumulator("velocity", p)
        return block.append_op(
            type="momentum",
            inputs={"Param": [p], "Grad": [g], "Velocity": [velocity],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [p], "VelocityOut": [velocity]},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov})


class AdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        moment = self._get_accumulator("moment", p)
        return block.append_op(
            type="adagrad",
            inputs={"Param": [p], "Grad": [g], "Moment": [moment],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [p], "MomentOut": [moment]},
            attrs={"epsilon": self._epsilon})


class AdamOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
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
        p, g = param_and_grad
        m1 = self._get_accumulator("moment1", p)
        m2 = self._get_accumulator("moment2", p)
        b1p = self._get_accumulator("beta1_pow_acc", p)
        b2p = self._get_accumulator("beta2_pow_acc", p)
        return block.append_op(
            type="adam",
            inputs={"Param": [p], "Grad": [g], "Moment1": [m1],
                    "Moment2": [m2], "Beta1Pow": [b1p], "Beta2Pow": [b2p],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [p], "Moment1Out": [m1],
                     "Moment2Out": [m2], "Beta1PowOut": [b1p],
                     "Beta2PowOut": [b2p]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon, "update_beta_pow": True})


class AdamaxOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
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
        p, g = param_and_grad
        moment = self._get_accumulator("moment", p)
        inf_norm = self._get_accumulator("inf_norm", p)
        b1p = self._get_accumulator("beta1_pow_acc", p)
        return block.append_op(
            type="adamax",
            inputs={"Param": [p], "Grad": [g], "Moment": [moment],
                    "InfNorm": [inf_norm], "Beta1Pow": [b1p],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [p], "MomentOut": [moment],
                     "InfNormOut": [inf_norm], "Beta1PowOut": [b1p]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon, "update_beta_pow": True})


class DecayedAdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._decay = decay
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        moment = self._get_accumulator("moment", p)
        return block.append_op(
            type="decayed_adagrad",
            inputs={"Param": [p], "Grad": [g], "Moment": [moment],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [p], "MomentOut": [moment]},
            attrs={"decay": self._decay, "epsilon": self._epsilon})


class AdadeltaOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon = epsilon
        self._rho = rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("__avg_squared_grad", p)
            self._add_accumulator("__avg_squared_update", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        asg = self._get_accumulator("__avg_squared_grad", p)
        asu = self._get_accumulator("__avg_squared_update", p)
        return block.append_op(
            type="adadelta",
            inputs={"Param": [p], "Grad": [g], "AvgSquaredGrad": [asg],
                    "AvgSquaredUpdate": [asu]},
            outputs={"ParamOut": [p], "AvgSquaredGradOut": [asg],
                     "AvgSquaredUpdateOut": [asu]},
            attrs={"epsilon": self._epsilon, "rho": self._rho})


class RMSPropOptimizer(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 **kw):
        super().__init__(learning_rate, **kw)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("momentum", p)
            self._add_accumulator("mean_square", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        mom = self._get_accumulator("momentum", p)
        ms = self._get_accumulator("mean_square", p)
        return block.append_op(
            type="rmsprop",
            inputs={"Param": [p], "Grad": [g], "Moment": [mom],
                    "MeanSquare": [ms],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [p], "MomentOut": [mom],
                     "MeanSquareOut": [ms]},
            attrs={"decay": self._rho, "epsilon": self._epsilon,
                   "momentum": self._momentum})


class FtrlOptimizer(Optimizer):
    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kw):
        super().__init__(learning_rate, **kw)
        self._l1 = l1
        self._l2 = l2
        self._lr_power = lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        sq = self._get_accumulator("squared", p)
        lin = self._get_accumulator("linear", p)
        return block.append_op(
            type="ftrl",
            inputs={"Param": [p], "Grad": [g], "SquaredAccumulator": [sq],
                    "LinearAccumulator": [lin],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [p], "SquaredAccumOut": [sq],
                     "LinearAccumOut": [lin]},
            attrs={"l1": self._l1, "l2": self._l2,
                   "lr_power": self._lr_power})



class ModelAverage(Optimizer):
    """Maintains a sliding-window average of parameters for evaluation
    (reference optimizer.py:812). apply()/restore() swap averaged weights in
    and out of the scope."""

    def __init__(self, average_window_rate, min_average_window=10000,
                 max_average_window=10000, **kw):
        super().__init__(0.0, **kw)
        self.average_window = average_window_rate
        self.min_average_window = min_average_window
        self.max_average_window = max_average_window
        self.params_grads = []
        prog = default_main_program()
        for param in prog.global_block().all_parameters():
            if getattr(param, "do_model_average", None) is not False:
                self.params_grads.append((param, None))
        self.helper = LayerHelper("model_average")
        self._create_accumulators(prog.global_block(),
                                  [p for p, _ in self.params_grads])
        for p, _ in self.params_grads:
            self._append_average_accumulate_op(p)

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("sum_1", p)
            self._add_accumulator("sum_2", p)
            self._add_accumulator("sum_3", p)
            self._add_accumulator("num_accumulates", p, dtype="int64",
                                  shape=[1])
            self._add_accumulator("old_num_accumulates", p, dtype="int64",
                                  shape=[1])
            self._add_accumulator("num_updates", p, dtype="int64", shape=[1])

    def _append_average_accumulate_op(self, param):
        s1 = self._get_accumulator("sum_1", param)
        s2 = self._get_accumulator("sum_2", param)
        s3 = self._get_accumulator("sum_3", param)
        na = self._get_accumulator("num_accumulates", param)
        ona = self._get_accumulator("old_num_accumulates", param)
        nu = self._get_accumulator("num_updates", param)
        default_main_program().global_block().append_op(
            type="average_accumulates",
            inputs={"param": [param], "in_sum_1": [s1], "in_sum_2": [s2],
                    "in_sum_3": [s3], "in_num_accumulates": [na],
                    "in_old_num_accumulates": [ona], "in_num_updates": [nu]},
            outputs={"out_sum_1": [s1], "out_sum_2": [s2], "out_sum_3": [s3],
                     "out_num_accumulates": [na],
                     "out_old_num_accumulates": [ona],
                     "out_num_updates": [nu]},
            attrs={"average_window": self.average_window,
                   "min_average_window": self.min_average_window,
                   "max_average_window": self.max_average_window})

    def apply(self, executor, need_restore=True, scope=None):
        """Swap the averaged values, (sum_1 + sum_2 + sum_3) /
        (num_accumulates + old_num_accumulates), into ``scope`` (the
        global scope by default) where the counts are positive, keeping
        the replaced tensors for ``restore``. The averages are computed
        on the tensors' device."""
        from .core.scope import global_scope
        scope = scope or global_scope()
        self._scope = scope
        self._backup = {}

        def value(name):
            return torch.as_tensor(
                scope.find_var(self._get_accumulator(name, p).name))

        for p, _ in self.params_grads:
            total = int(value("num_accumulates").reshape(-1)[0]) + \
                int(value("old_num_accumulates").reshape(-1)[0])
            if total <= 0:
                continue
            old = torch.as_tensor(scope.find_var(p.name))
            sums = value("sum_1") + value("sum_2") + value("sum_3")
            # a 0-dim tensor divisor: true division on the CPU and the card
            avg = sums / torch.full((), float(total), dtype=sums.dtype,
                                    device=sums.device)
            self._backup[p.name] = old
            scope.set(p.name, avg.to(old.dtype))

    def restore(self, executor=None):
        """Put back the tensors ``apply`` replaced."""
        scope = getattr(self, "_scope", None)
        for name, val in getattr(self, "_backup", {}).items():
            scope.set(name, val)
        self._backup = {}


# fluid-compatible aliases
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
