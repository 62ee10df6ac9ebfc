"""Python-side metric accumulators.

Capability parity: `python/paddle/fluid/metrics.py` (MetricBase :47,
CompositeMetric, Accuracy :131, ChunkEvaluator :172, EditDistance :213,
DetectionMAP :264, Auc :302), the JAX package's ``metrics.py`` name
for name: host-side accumulators over fetched numpy values.
"""

import numpy as np

__all__ = ["MetricBase", "CompositeMetric", "Accuracy", "ChunkEvaluator",
           "EditDistance", "Auc"]


class MetricBase:
    def __init__(self, name=None):
        self._name = name or self.__class__.__name__

    def reset(self):
        for k, v in self.__dict__.items():
            if k.startswith("_"):
                continue
            if isinstance(v, (int, float)):
                setattr(self, k, 0 if isinstance(v, int) else 0.0)

    def update(self, *args, **kwargs):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class CompositeMetric(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        self._metrics.append(metric)

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        return [m.eval() for m in self._metrics]


class Accuracy(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight=1):
        self.value += float(np.asarray(value).item()) * weight
        self.weight += weight

    def eval(self):
        return self.value / max(self.weight, 1e-12)


class ChunkEvaluator(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks, num_correct_chunks):
        self.num_infer_chunks += int(np.asarray(num_infer_chunks).item())
        self.num_label_chunks += int(np.asarray(num_label_chunks).item())
        self.num_correct_chunks += int(np.asarray(num_correct_chunks).item())

    def eval(self):
        precision = self.num_correct_chunks / self.num_infer_chunks \
            if self.num_infer_chunks else 0.0
        recall = self.num_correct_chunks / self.num_label_chunks \
            if self.num_label_chunks else 0.0
        f1 = 2 * precision * recall / (precision + recall) \
            if self.num_correct_chunks else 0.0
        return precision, recall, f1


class EditDistance(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        distances = np.asarray(distances)
        self.total_distance += float(distances.sum())
        self.seq_num += int(seq_num)
        self.instance_error += int((distances > 0).sum())

    def eval(self):
        avg = self.total_distance / max(self.seq_num, 1)
        rate = self.instance_error / max(self.seq_num, 1)
        return avg, rate


class Auc(MetricBase):
    def __init__(self, name=None, curve="ROC", num_thresholds=4095):
        super().__init__(name)
        self._num_thresholds = num_thresholds
        self.stat_pos = np.zeros(num_thresholds + 1)
        self.stat_neg = np.zeros(num_thresholds + 1)

    def update(self, preds, labels):
        preds = np.asarray(preds)
        labels = np.asarray(labels).reshape(-1)
        scores = preds[:, 1] if preds.ndim == 2 else preds.reshape(-1)
        nb = self._num_thresholds
        bins = np.clip((scores * nb).astype(int), 0, nb)
        for b, l in zip(bins, labels):
            if l:
                self.stat_pos[b] += 1
            else:
                self.stat_neg[b] += 1

    def eval(self):
        neg_below = np.cumsum(self.stat_neg) - self.stat_neg
        num = float((self.stat_pos * (neg_below + 0.5 * self.stat_neg)).sum())
        tot = self.stat_pos.sum() * self.stat_neg.sum()
        return num / tot if tot > 0 else 0.0
