"""paddle.v2-style high-level API over the fluid core (SURVEY.md M7); the
counterpart of ``paddle_tpu/v2/``, its modules copied over the port's
``layers``, ``nets``, ``optimizer``, ``DataFeeder``, ``Executor``,
``reader`` and ``dataset``.

Reference parity: python/paddle/v2/ — the legacy event-loop training API
(`SGD.train(reader, event_handler)`, v2/trainer.py:37,137), Parameters
tar save/load, layer aliases, data types, and `paddle.v2.infer`. The v2
stack in the reference wraps the same engine the fluid API drives; here
both front-ends share the Program/Executor core, so v2 and fluid layers
compose in one model.

The one seam is the device: ``init(use_gpu=...)`` records the choice
(True: the CUDA card, False: the CPU), and the trainer and ``infer`` run
there; without ``init``, or with ``use_gpu`` not given, they run on the
card. ``trainer.SGD(place=...)`` overrides it for one trainer.

Usage (reference book v2 shape):

    import paddle_tpu_torch.v2 as paddle
    paddle.init(use_gpu=True)
    images = paddle.layer.data("pixel", paddle.data_type.dense_vector(784))
    label = paddle.layer.data("label", paddle.data_type.integer_value(10))
    pred = paddle.layer.fc(images, 10, act="softmax")
    cost = paddle.layer.classification_cost(pred, label)
    parameters = paddle.parameters.create(cost)
    trainer = paddle.trainer.SGD(cost, parameters,
                                 paddle.optimizer.Momentum(momentum=0.9))
    trainer.train(paddle.batch(paddle.dataset.mnist.train(), 64),
                  num_passes=2, event_handler=handler)
"""

from .. import batch, reader, dataset  # noqa: F401  (reader plumbing)
from . import activation  # noqa: F401
from . import attr  # noqa: F401
from . import data_type  # noqa: F401
from . import event  # noqa: F401
from . import inference  # noqa: F401
from . import layer  # noqa: F401
from . import networks  # noqa: F401
from . import optimizer  # noqa: F401
from . import parameters as _parameters_mod
from . import plot  # noqa: F401
from . import pooling  # noqa: F401
from . import trainer  # noqa: F401
from .inference import infer  # noqa: F401

parameters = _parameters_mod


_use_gpu = None       # init's choice; None: the card


def init(use_gpu=None, trainer_count=1, **kwargs):
    """Process bootstrap (reference paddle.init → swig initPaddle): records
    the device the trainer and ``infer`` run on — ``use_gpu=True`` the
    CUDA card, ``False`` the CPU, not given the card."""
    global _use_gpu
    _use_gpu = use_gpu
    return None


def default_place():
    """The place ``init`` chose: ``CPUPlace()`` after ``init(use_gpu=
    False)``, else ``CUDAPlace(0)``."""
    from ..core.places import CPUPlace, CUDAPlace
    return CPUPlace() if _use_gpu is False else CUDAPlace(0)
