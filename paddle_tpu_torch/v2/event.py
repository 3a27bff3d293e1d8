"""v2 event system (python/paddle/v2/event.py parity): the trainer fires
these into the user's event_handler; handlers pattern-match with
isinstance, exactly like reference book v2 scripts."""


class WithMetric:
    def __init__(self, evaluator):
        self.evaluator = evaluator

    @property
    def metrics(self):
        return dict(self.evaluator or {})


class BeginPass:
    def __init__(self, pass_id):
        self.pass_id = pass_id


class EndPass(WithMetric):
    def __init__(self, pass_id, evaluator=None, cost=None):
        super().__init__(evaluator)
        self.pass_id = pass_id
        self.cost = cost


class BeginIteration:
    def __init__(self, pass_id, batch_id):
        self.pass_id = pass_id
        self.batch_id = batch_id


class EndForwardBackward:
    def __init__(self, pass_id, batch_id, gm=None):
        self.pass_id = pass_id
        self.batch_id = batch_id
        self.gm = gm


class EndIteration(WithMetric):
    def __init__(self, pass_id, batch_id, cost, evaluator=None):
        super().__init__(evaluator)
        self.pass_id = pass_id
        self.batch_id = batch_id
        self.cost = cost


class TestResult(WithMetric):
    def __init__(self, evaluator=None, cost=None):
        super().__init__(evaluator)
        self.cost = cost
