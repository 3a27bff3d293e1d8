"""v2 SGD trainer (python/paddle/v2/trainer.py:37,137 parity): combines a
cost layer, a Parameters dict and an optimizer into the classic
`trainer.train(reader, num_passes, event_handler)` event loop over the
fluid executor, on ``place`` or else the device ``paddle.init`` chose
(the card by default)."""

import numpy as np

from ..core.executor import Executor
from ..core.scope import scope_guard
from ..data_feeder import DataFeeder
from . import event as v2_event
from .optimizer import Optimizer as V2Optimizer
from .parameters import Parameters


def default_event_handler(event):
    pass


class SGD:
    """v2 trainer. `cost` is a fluid Variable (built via paddle.v2.layer or
    fluid.layers), `parameters` a v2 Parameters, `update_equation` a v2
    optimizer."""

    def __init__(self, cost, parameters, update_equation, extra_layers=None,
                 is_local=True, place=None):
        if not isinstance(parameters, Parameters):
            raise TypeError("parameters should be a paddle.v2 Parameters")
        if not isinstance(update_equation, V2Optimizer):
            raise TypeError("update equation parameter must be a "
                            "paddle.v2.optimizer.Optimizer")
        self.__cost__ = cost
        self.__parameters__ = parameters
        self.__program__ = cost.block.program
        # clone BEFORE optimizer ops are appended: the test-time program
        # computes the cost without updating parameters
        self.__test_program__ = self.__program__.clone()
        from ..core.program import program_guard, default_startup_program
        with program_guard(self.__program__):
            update_equation._make().minimize(cost)
        self.__startup__ = default_startup_program()
        if place is None:
            from . import default_place
            place = default_place()
        self.__exe__ = Executor(place)
        self.__started__ = False
        # feed order = data layers in creation order (v2 feeding maps
        # reader columns onto these names)
        self.__data_vars__ = [
            v for v in self.__program__.global_block().vars.values()
            if getattr(v, "is_data", False)]

    # ------------------------------------------------------------------
    def __ensure_startup__(self):
        if not self.__started__:
            with scope_guard(self.__parameters__._scope):
                self.__exe__.run(self.__startup__)
            self.__started__ = True

    def __feeder__(self, feeding):
        data_vars = self.__data_vars__
        if feeding:
            order = sorted(feeding, key=lambda n: feeding[n])
            by_name = {v.name: v for v in data_vars}
            data_vars = [by_name[n] for n in order]
        return DataFeeder(data_vars, self.__exe__.place,
                          program=self.__program__)

    def train(self, reader, num_passes=1, event_handler=None, feeding=None):
        """The reference event loop (v2/trainer.py:137): BeginPass →
        (BeginIteration → step → EndIteration)* → EndPass per pass."""
        event_handler = event_handler or default_event_handler
        self.__ensure_startup__()
        feeder = self.__feeder__(feeding)
        for pass_id in range(num_passes):
            event_handler(v2_event.BeginPass(pass_id))
            costs = []
            for batch_id, data_batch in enumerate(reader()):
                event_handler(v2_event.BeginIteration(pass_id, batch_id))
                feed = feeder.feed(data_batch)
                with scope_guard(self.__parameters__._scope):
                    cost_v, = self.__exe__.run(
                        self.__program__, feed=feed,
                        fetch_list=[self.__cost__])
                cost_v = float(np.asarray(cost_v).ravel()[0])
                costs.append(cost_v)
                event_handler(v2_event.EndIteration(
                    pass_id, batch_id, cost_v))
            event_handler(v2_event.EndPass(
                pass_id, cost=float(np.mean(costs)) if costs else None))

    def test(self, reader, feeding=None):
        """Evaluate the cost WITHOUT updating parameters (reference
        trainer.test): runs the pre-minimize clone of the program."""
        self.__ensure_startup__()
        feeder = self.__feeder__(feeding)
        costs = []
        for data_batch in reader():
            feed = feeder.feed(data_batch)
            with scope_guard(self.__parameters__._scope):
                cost_v, = self.__exe__.run(
                    self.__test_program__, feed=feed,
                    fetch_list=[self.__cost__.name])
            costs.append(float(np.asarray(cost_v).ravel()[0]))
        return v2_event.TestResult(
            cost=float(np.mean(costs)) if costs else None)

    def save_parameter_to_tar(self, f):
        self.__parameters__.to_tar(f)
