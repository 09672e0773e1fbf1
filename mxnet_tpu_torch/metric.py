"""Evaluation metrics (counterpart of mxnet_tpu/metric.py): the
``EvalMetric`` registry with Accuracy, TopKAccuracy, F1, Perplexity, MAE,
MSE, RMSE, CrossEntropy, NegativeLogLikelihood, PearsonCorrelation, Loss,
CustomMetric and CompositeEvalMetric, and the ``np`` helper. Updates
copy outputs to the host and compute with numpy, as the JAX package
does, so both packages' metrics agree on the same outputs.
"""
from __future__ import annotations

import math

import numpy

from .base import MXNetError, to_numpy

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy",
           "NegativeLogLikelihood", "PearsonCorrelation", "Loss", "Torch",
           "Caffe", "CustomMetric", "np", "create", "register"]

_METRIC_REGISTRY = {}


def register(klass, *aliases):
    _METRIC_REGISTRY[klass.__name__.lower()] = klass
    for a in aliases:
        _METRIC_REGISTRY[a.lower()] = klass
    return klass


def create(metric, *args, **kwargs):
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    if isinstance(metric, str):
        try:
            return _METRIC_REGISTRY[metric.lower()](*args, **kwargs)
        except KeyError:
            raise MXNetError(f"Metric must be either callable or in registry; "
                             f"got {metric!r}") from None
    raise TypeError(f"cannot create metric from {metric!r}")


def check_label_shapes(labels, preds, shape=0):
    if shape == 0:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = labels.shape, preds.shape
    if label_shape != pred_shape:
        raise ValueError(f"Shape of labels {label_shape} does not match shape "
                         f"of predictions {pred_shape}")


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"

    def get_config(self):
        config = self._kwargs.copy()
        config.update({
            "metric": self.__class__.__name__,
            "name": self.name,
            "output_names": self.output_names,
            "label_names": self.label_names})
        return config

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[name] for name in self.output_names]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[name] for name in self.label_names]
        else:
            label = list(label.values())
        self.update(label, pred)

    def update(self, labels, preds):
        raise NotImplementedError()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))


@register
class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)
        if metrics is None:
            metrics = []
        self.metrics = [create(i) for i in metrics]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        try:
            return self.metrics[index]
        except IndexError:
            return ValueError(f"Metric index {index} is out of range 0 and "
                              f"{len(self.metrics)}")

    def update_dict(self, labels, preds):
        if self.label_names is not None:
            labels = {name: label for name, label in labels.items()
                      if name in self.label_names}
        if self.output_names is not None:
            preds = {name: pred for name, pred in preds.items()
                     if name in self.output_names}
        for metric in self.metrics:
            metric.update_dict(labels, preds)

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        try:
            for metric in self.metrics:
                metric.reset()
        except AttributeError:
            pass

    def get(self):
        names = []
        values = []
        for metric in self.metrics:
            name, value = metric.get()
            if isinstance(name, str):
                name = [name]
            if isinstance(value, (float, int, numpy.generic)):
                value = [value]
            names.extend(name)
            values.extend(value)
        return (names, values)

    def get_config(self):
        config = super().get_config()
        config.update({"metrics": [i.get_config() for i in self.metrics]})
        return config


def _as_numpy(x):
    """Host numpy of an NDArray, a tensor or an array-like (one device to
    host copy a batch: the metric's sync point, as in the reference)."""
    return to_numpy(x)


@register
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, axis=axis, output_names=output_names,
                         label_names=label_names)
        self.axis = axis

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred_label in zip(labels, preds):
            pred_label = _as_numpy(pred_label)
            label = _as_numpy(label)
            if pred_label.ndim > label.ndim or (
                    pred_label.ndim == label.ndim and
                    pred_label.shape != label.shape):
                pred_label = numpy.argmax(pred_label, axis=self.axis)
            pred_label = pred_label.astype("int32")
            label = label.astype("int32")
            check_label_shapes(label.flat, pred_label.flat)
            self.sum_metric += (pred_label.flat == label.flat).sum()
            self.num_inst += len(pred_label.flat)


@register
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, top_k=top_k, output_names=output_names,
                         label_names=label_names)
        self.top_k = top_k
        assert self.top_k > 1, "Please use Accuracy if top_k is no more than 1"
        self.name += f"_{self.top_k}"

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred_label in zip(labels, preds):
            assert len(pred_label.shape) == 2, "Predictions should be 2 dims"
            pred_label = numpy.argsort(_as_numpy(pred_label).astype("float32"),
                                       axis=1)
            label = _as_numpy(label).astype("int32")
            check_label_shapes(label, pred_label)
            num_samples = pred_label.shape[0]
            num_dims = len(pred_label.shape)
            if num_dims == 1:
                self.sum_metric += (pred_label.flat == label.flat).sum()
            elif num_dims == 2:
                num_classes = pred_label.shape[1]
                top_k = min(num_classes, self.top_k)
                for j in range(top_k):
                    self.sum_metric += (
                        pred_label[:, num_classes - 1 - j].flat ==
                        label.flat).sum()
            self.num_inst += num_samples


@register
class F1(EvalMetric):
    def __init__(self, name="f1", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            pred = _as_numpy(pred)
            label = _as_numpy(label).astype("int32")
            pred_label = numpy.argmax(pred, axis=1)
            check_label_shapes(label, pred)
            if len(numpy.unique(label)) > 2:
                raise ValueError("F1 currently only supports binary "
                                 "classification.")
            true_positives, false_positives, false_negatives = 0., 0., 0.
            for y_pred, y_true in zip(pred_label, label):
                if y_pred == 1 and y_true == 1:
                    true_positives += 1.
                elif y_pred == 1 and y_true == 0:
                    false_positives += 1.
                elif y_pred == 0 and y_true == 1:
                    false_negatives += 1.
            if true_positives + false_positives > 0:
                precision = true_positives / (true_positives + false_positives)
            else:
                precision = 0.
            if true_positives + false_negatives > 0:
                recall = true_positives / (true_positives + false_negatives)
            else:
                recall = 0.
            if precision + recall > 0:
                f1_score = 2 * precision * recall / (precision + recall)
            else:
                f1_score = 0.
            self.sum_metric += f1_score
            self.num_inst += 1


@register
class Perplexity(EvalMetric):
    def __init__(self, ignore_label, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, ignore_label=ignore_label, axis=axis,
                         output_names=output_names, label_names=label_names)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        assert len(labels) == len(preds)
        loss = 0.
        num = 0
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            if self.axis not in (-1, pred.ndim - 1):
                pred = numpy.moveaxis(pred, self.axis, -1)
            assert label.size == pred.size / pred.shape[-1], \
                "shape mismatch"
            label = label.reshape((label.size,)).astype("int32")
            probs = pred.reshape(-1, pred.shape[-1])[
                numpy.arange(label.size), label]
            if self.ignore_label is not None:
                ignore = (label == self.ignore_label).astype(probs.dtype)
                probs = probs * (1 - ignore) + ignore
                num -= int(ignore.sum())
            loss -= numpy.sum(numpy.log(numpy.maximum(1e-10, probs)))
            num += label.size
        # accumulate raw NLL; exponentiate once in get() so multi-batch
        # perplexity is exp(global mean NLL), matching the reference
        self.sum_metric += loss
        self.num_inst += num

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


@register
class MAE(EvalMetric):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            if len(pred.shape) == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self.sum_metric += numpy.abs(label - pred).mean()
            self.num_inst += 1


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            if len(pred.shape) == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self.sum_metric += ((label - pred) ** 2.0).mean()
            self.num_inst += 1


@register
class RMSE(EvalMetric):
    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            if len(pred.shape) == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self.sum_metric += numpy.sqrt(((label - pred) ** 2.0).mean())
            self.num_inst += 1


@register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, eps=eps, output_names=output_names,
                         label_names=label_names)
        self.eps = eps

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            label = label.ravel()
            assert label.shape[0] == pred.shape[0]
            prob = pred[numpy.arange(label.shape[0]), numpy.int64(label)]
            self.sum_metric += (-numpy.log(prob + self.eps)).sum()
            self.num_inst += label.shape[0]


@register
class NegativeLogLikelihood(EvalMetric):
    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(name, eps=eps, output_names=output_names,
                         label_names=label_names)
        self.eps = eps

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            label = label.ravel()
            num_examples = pred.shape[0]
            assert label.shape[0] == num_examples, \
                (label.shape[0], num_examples)
            prob = pred[numpy.arange(num_examples, dtype=numpy.int64),
                        numpy.int64(label)]
            self.sum_metric += (-numpy.log(prob + self.eps)).sum()
            self.num_inst += num_examples


@register
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            check_label_shapes(label, pred, 1)
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            self.sum_metric += numpy.corrcoef(pred.ravel(),
                                              label.ravel())[0, 1]
            self.num_inst += 1


@register
class Loss(EvalMetric):
    """Mean of per-batch loss outputs (e.g. MakeLoss heads)."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    def update(self, _, preds):
        if not isinstance(preds, (list, tuple)):
            preds = [preds]
        for pred in preds:
            self.sum_metric += _as_numpy(pred).sum()
            self.num_inst += _as_numpy(pred).size


@register
class Torch(Loss):
    def __init__(self, name="torch", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class Caffe(Loss):
    def __init__(self, name="caffe", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class CustomMetric(EvalMetric):
    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = feval.__name__
            if name.find("<") != -1:
                name = f"custom({name})"
        super().__init__(name, feval=feval,
                         allow_extra_outputs=allow_extra_outputs,
                         output_names=output_names, label_names=label_names)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds)
        for pred, label in zip(preds, labels):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            reval = self._feval(label, pred)
            if isinstance(reval, tuple):
                (sum_metric, num_inst) = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1

    def get_config(self):
        raise NotImplementedError("CustomMetric cannot be serialized")


# short aliases matching the reference registry names
register(Accuracy, "acc")
register(TopKAccuracy, "top_k_accuracy", "top_k_acc")
register(CrossEntropy, "ce", "cross-entropy")
register(NegativeLogLikelihood, "nll_loss", "nll-loss")
register(PearsonCorrelation, "pearsonr")
register(MAE, "mae")
register(MSE, "mse")
register(RMSE, "rmse")


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """Wrap a numpy feval into a CustomMetric factory."""
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)
