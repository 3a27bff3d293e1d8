"""Op lowerings and kernels of the port. Importing the package registers
every lowering (as ``paddle_tpu/ops/__init__.py`` does)."""

from . import activations  # noqa: F401
from . import beam_search  # noqa: F401
from . import control_flow  # noqa: F401
from . import conv  # noqa: F401
from . import crf_ctc  # noqa: F401
from . import detection_ops  # noqa: F401
from . import elementwise  # noqa: F401
from . import fused  # noqa: F401
from . import loss  # noqa: F401
from . import math  # noqa: F401
from . import metrics_ops  # noqa: F401
from . import nn  # noqa: F401
from . import optimizer_ops  # noqa: F401
from . import parallel_ops  # noqa: F401
from . import rnn_ops  # noqa: F401
from . import sequence_ops  # noqa: F401
from . import tensor_ops  # noqa: F401
