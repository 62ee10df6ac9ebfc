"""v2 training events (reference python/paddle/v2/event.py)."""

__all__ = ["BeginPass", "EndPass", "BeginIteration", "EndIteration",
           "TestResult"]


class WithMetric:
    def __init__(self, evaluator=None):
        self.evaluator = evaluator


class BeginPass:
    def __init__(self, pass_id):
        self.pass_id = pass_id


class EndPass(WithMetric):
    def __init__(self, pass_id, evaluator=None, gm=None):
        super().__init__(evaluator)
        self.pass_id = pass_id


class BeginIteration:
    def __init__(self, pass_id, batch_id):
        self.pass_id = pass_id
        self.batch_id = batch_id


class EndIteration(WithMetric):
    def __init__(self, pass_id, batch_id, cost, evaluator=None,
                 metrics=None):
        super().__init__(evaluator)
        self.pass_id = pass_id
        self.batch_id = batch_id
        self.cost = cost
        self.metrics = metrics or {}


class TestResult(WithMetric):
    def __init__(self, evaluator=None, cost=None, metrics=None):
        super().__init__(evaluator)
        self.cost = cost
        self.metrics = metrics or {}
