"""v2 optimizers (python/paddle/v2/optimizer.py parity): thin wrappers that
carry the config until the trainer appends the real fluid optimizer ops."""

from .. import optimizer as fluid_optimizer


class L2Regularization:
    """v2 paddle.optimizer.L2Regularization(rate=...) — maps onto the
    fluid L2Decay regularizer at optimizer-build time."""

    def __init__(self, rate=0.0):
        self.rate = float(rate)

    def to_fluid(self):
        from ..regularizer import L2Decay
        return L2Decay(self.rate) if self.rate else None


class ModelAverage:
    """Accepted for v2 script compatibility (sgd.py ModelAverage); the
    averaging window knobs have no fluid-side effect here."""

    def __init__(self, average_window=0.5, **kwargs):
        self.average_window = average_window


class Optimizer:
    def __init__(self, regularization=None, model_average=None, **kwargs):
        self._kwargs = kwargs
        self.regularization = regularization

    def _reg(self):
        r = self.regularization
        return r.to_fluid() if hasattr(r, "to_fluid") else r

    def _make(self):
        raise NotImplementedError

    def create_updater(self):
        return self._make()


class SGD(Optimizer):
    def __init__(self, learning_rate=0.01, **kwargs):
        super().__init__(**kwargs)
        self.learning_rate = learning_rate

    def _make(self):
        return fluid_optimizer.SGD(learning_rate=self.learning_rate,
                                   regularization=self._reg())


class Momentum(Optimizer):
    def __init__(self, momentum=0.9, learning_rate=0.01, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.learning_rate = learning_rate

    def _make(self):
        return fluid_optimizer.Momentum(learning_rate=self.learning_rate,
                                        momentum=self.momentum,
                                        regularization=self._reg())


class Adam(Optimizer):
    def __init__(self, learning_rate=1e-3, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.learning_rate = learning_rate
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _make(self):
        return fluid_optimizer.Adam(learning_rate=self.learning_rate,
                                    beta1=self.beta1, beta2=self.beta2,
                                    epsilon=self.epsilon,
                                    regularization=self._reg())


class AdaGrad(Optimizer):
    def __init__(self, learning_rate=0.01, epsilon=1e-6, **kwargs):
        super().__init__(**kwargs)
        self.learning_rate = learning_rate
        self.epsilon = epsilon

    def _make(self):
        return fluid_optimizer.Adagrad(learning_rate=self.learning_rate,
                                       epsilon=self.epsilon,
                                       regularization=self._reg())


class RMSProp(Optimizer):
    def __init__(self, learning_rate=0.01, rho=0.95, epsilon=1e-6,
                 **kwargs):
        super().__init__(**kwargs)
        self.learning_rate = learning_rate
        self.rho, self.epsilon = rho, epsilon

    def _make(self):
        return fluid_optimizer.RMSProp(learning_rate=self.learning_rate,
                                       rho=self.rho, epsilon=self.epsilon,
                                       regularization=self._reg())
