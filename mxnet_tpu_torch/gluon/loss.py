"""Gluon losses (subset of mxnet_tpu/gluon/loss.py): the per-sample loss
after a mean over every axis but the batch axis, with ``weight`` and
``sample_weight`` scaling in ``Loss._finalize``."""
from __future__ import annotations

from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


class Loss(HybridBlock):
    """Base: holds the scalar ``weight`` and the batch axis; subclasses
    compute an elementwise loss and hand it to ``_finalize``."""

    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def extra_repr(self):
        return f"batch_axis={self._batch_axis}, w={self._weight}"

    def _finalize(self, loss, sample_weight):
        """sample_weight (broadcast) -> scalar weight -> per-sample mean."""
        if sample_weight is not None:
            loss = loss * sample_weight
        if self._weight is not None:
            if not isinstance(self._weight, (int, float)):
                raise TypeError("weight must be a number")
            loss = loss * self._weight
        batch = self._batch_axis % loss.ndim
        axes = [i for i in range(loss.ndim) if i != batch]
        return loss.mean(dim=axes) if axes else loss


class L2Loss(Loss):
    """0.5 * weight * (pred - label)^2."""

    def __init__(self, weight=1., batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        err = pred - label.reshape(pred.shape)
        return self._finalize(0.5 * err.square(), sample_weight)


class SoftmaxCrossEntropyLoss(Loss):
    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        logp = pred if self._from_logits \
            else F.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            nll = -F.pick(logp, label, axis=self._axis, keepdims=True)
        else:
            nll = -(logp * label.reshape(logp.shape)).sum(
                dim=self._axis, keepdim=True)
        return self._finalize(nll, sample_weight)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
