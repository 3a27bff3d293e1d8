"""v2 inference (python/paddle/v2/inference.py parity):
paddle.v2.infer(output_layer=..., parameters=..., input=...), on the
device ``paddle.init`` chose (the card by default)."""

import numpy as np

from ..core.executor import Executor
from ..core.scope import scope_guard
from ..data_feeder import DataFeeder
from .parameters import Parameters


def _feeds_some_op(program, name):
    return any(name in op.input_names
               for op in program.global_block().ops)


def infer(output_layer, parameters, input, feeding=None, field="value"):
    if not isinstance(parameters, Parameters):
        raise TypeError("parameters must be a paddle.v2 Parameters")
    # backward-slice to the output layer (framework Prune parity) so loss
    # labels and optimizer ops are neither required nor run at infer time
    program = output_layer.block.program.prune([output_layer])
    data_vars = [v for v in program.global_block().vars.values()
                 if getattr(v, "is_data", False)
                 and _feeds_some_op(program, v.name)]
    # drop label-style inputs the output does not depend on: keep feeds in
    # declaration order and feed only as many columns as the input rows have
    n_cols = len(input[0]) if input and isinstance(input[0],
                                                   (tuple, list)) else 1
    if input and not isinstance(input[0], (tuple, list)):
        input = [(x,) for x in input]
    if feeding:
        order = sorted(feeding, key=lambda n: feeding[n])
        by_name = {v.name: v for v in data_vars}
        data_vars = [by_name[n] for n in order]
    from . import default_place
    place = default_place()
    feeder = DataFeeder(data_vars[:n_cols], place, program=program)
    feed = feeder.feed(input)
    exe = Executor(place)
    with scope_guard(parameters._scope):
        out, = exe.run(program, feed=feed, fetch_list=[output_layer])
    return np.asarray(out)
