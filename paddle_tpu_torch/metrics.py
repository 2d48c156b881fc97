"""Host-side streaming metric accumulators — a copy of
``paddle_tpu/metrics.py`` (reference: python/paddle/fluid/metrics.py),
numpy only: ``Accuracy``, ``Precision``, ``Recall``, ``Auc`` (the
``auc`` op's histograms and area, on the host), ``EditDistance``,
``ChunkEvaluator`` and ``CompositeMetric``. Users feed them what
``Executor.run`` fetches."""

import numpy as np

__all__ = ["MetricBase", "Accuracy", "ChunkEvaluator", "EditDistance",
           "Precision", "Recall", "Auc", "CompositeMetric"]


class MetricBase:
    def __init__(self, name=None):
        self._name = name or self.__class__.__name__

    def reset(self):
        for k in list(self.__dict__):
            if not k.startswith("_"):
                setattr(self, k, 0.0)

    def update(self, *args, **kwargs):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class Accuracy(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight):
        self.value += value * weight
        self.weight += weight

    def eval(self):
        if self.weight == 0:
            raise ValueError("no data in Accuracy metric")
        return self.value / self.weight


class Precision(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0.0
        self.fp = 0.0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype(int)
        labels = np.asarray(labels).astype(int)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fp += int(np.sum((preds == 1) & (labels == 0)))

    def eval(self):
        return self.tp / (self.tp + self.fp) if (self.tp + self.fp) else 0.0


class Recall(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0.0
        self.fn = 0.0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype(int)
        labels = np.asarray(labels).astype(int)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fn += int(np.sum((preds == 0) & (labels == 1)))

    def eval(self):
        return self.tp / (self.tp + self.fn) if (self.tp + self.fn) else 0.0


class Auc(MetricBase):
    def __init__(self, name=None, curve="ROC", num_thresholds=4095):
        super().__init__(name)
        self._num_thresholds = num_thresholds
        self._stat_pos = np.zeros(num_thresholds + 1)
        self._stat_neg = np.zeros(num_thresholds + 1)

    def reset(self):
        self._stat_pos[:] = 0
        self._stat_neg[:] = 0

    def update(self, preds, labels):
        preds = np.asarray(preds)
        labels = np.asarray(labels).reshape(-1)
        pos_prob = preds[:, 1] if preds.ndim == 2 else preds
        buckets = np.clip(
            (pos_prob * self._num_thresholds).astype(int), 0, self._num_thresholds
        )
        labels = labels.astype(bool)
        np.add.at(self._stat_pos, buckets[labels], 1)
        np.add.at(self._stat_neg, buckets[~labels], 1)

    def eval(self):
        tp = np.cumsum(self._stat_pos[::-1])
        fp = np.cumsum(self._stat_neg[::-1])
        tot_pos, tot_neg = tp[-1], fp[-1]
        if not tot_pos or not tot_neg:
            return 0.0
        tp_prev = np.concatenate([[0], tp[:-1]])
        fp_prev = np.concatenate([[0], fp[:-1]])
        area = np.sum((fp - fp_prev) * (tp + tp_prev) / 2.0)
        return float(area / (tot_pos * tot_neg))


class EditDistance(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        self.total_distance += float(np.sum(distances))
        self.seq_num += int(seq_num)
        self.instance_error += int(np.sum(np.asarray(distances) > 0))

    def eval(self):
        if self.seq_num == 0:
            raise ValueError("no data in EditDistance")
        return (
            self.total_distance / self.seq_num,
            self.instance_error / self.seq_num,
        )


class ChunkEvaluator(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks, num_correct_chunks):
        self.num_infer_chunks += int(num_infer_chunks)
        self.num_label_chunks += int(num_label_chunks)
        self.num_correct_chunks += int(num_correct_chunks)

    def eval(self):
        precision = (
            self.num_correct_chunks / self.num_infer_chunks
            if self.num_infer_chunks
            else 0.0
        )
        recall = (
            self.num_correct_chunks / self.num_label_chunks
            if self.num_label_chunks
            else 0.0
        )
        f1 = (
            2 * precision * recall / (precision + recall)
            if precision + recall
            else 0.0
        )
        return precision, recall, f1


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
