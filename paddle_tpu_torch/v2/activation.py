"""v2 activation objects (python/paddle/v2/activation.py parity —
trainer_config_helpers.activations re-exported as classes). Layers map
these to fluid act names via type-name matching (v2/layer._act_name)."""


class BaseActivation:
    def __repr__(self):
        return type(self).__name__ + "()"


class Linear(BaseActivation):
    pass


class Relu(BaseActivation):
    pass


class Sigmoid(BaseActivation):
    pass


class Softmax(BaseActivation):
    pass


class Tanh(BaseActivation):
    pass


__all__ = ["Linear", "Relu", "Sigmoid", "Softmax", "Tanh"]
