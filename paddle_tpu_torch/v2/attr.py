"""v2 attribute objects (python/paddle/v2/attr.py parity): scripts pass
paddle.attr.Param(...)/Extra(...) for initialization and per-layer
knobs. Mapped onto fluid ParamAttr where the fields translate; unknown
fields are accepted for script compatibility."""

from ..param_attr import ParamAttr


class Param:
    def __init__(self, name=None, initial_std=None, initial_mean=None,
                 learning_rate=None, l2_rate=None, **kwargs):
        self.name = name
        self.initial_std = initial_std
        self.initial_mean = initial_mean
        self.learning_rate = learning_rate
        self.l2_rate = l2_rate

    def to_param_attr(self):
        from ..initializer import Normal
        from ..regularizer import L2Decay
        init = None
        if self.initial_std is not None or self.initial_mean is not None:
            # explicit 0.0 must stay 0.0 (the stacked-LSTM book script
            # passes initial_std=0.0 for constant init)
            init = Normal(
                0.0 if self.initial_mean is None else self.initial_mean,
                0.01 if self.initial_std is None else self.initial_std)
        return ParamAttr(
            name=self.name, initializer=init,
            learning_rate=(self.learning_rate
                           if self.learning_rate is not None else 1.0),
            regularizer=(L2Decay(self.l2_rate)
                         if self.l2_rate else None))


class Extra:
    """Per-layer extras (drop_rate etc.) — accepted; drop_rate is
    honored by layers that take it."""

    def __init__(self, drop_rate=None, **kwargs):
        self.drop_rate = drop_rate


ParameterAttribute = Param
ExtraAttribute = Extra
__all__ = ["Param", "Extra", "ParameterAttribute", "ExtraAttribute"]
