"""Gluon losses (counterpart of mxnet_tpu/gluon/loss.py): the same class
names, constructor arguments and output semantics (the per-sample loss
after a mean over every axis but the batch axis; ``weight`` and
``sample_weight`` scaling, in ``Loss._finalize``), over the registered
ops. ``CTCLoss`` raises: its ``CTCLoss`` op is not ported yet (ROADMAP
queue 1 item 17).
"""
from __future__ import annotations

from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "CTCLoss", "HuberLoss", "HingeLoss",
           "SquaredHingeLoss", "LogisticLoss", "TripletLoss"]


class Loss(HybridBlock):
    """Base: holds the scalar `weight` and the batch axis; subclasses
    compute an elementwise loss and hand it to `_finalize`."""

    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return (f"{self.__class__.__name__}(batch_axis={self._batch_axis}, "
                f"w={self._weight})")

    def _finalize(self, F, loss, sample_weight, mean=True):
        """sample_weight (broadcast) -> scalar weight -> per-sample mean."""
        if sample_weight is not None:
            loss = F.broadcast_mul(loss, sample_weight)
        if self._weight is not None:
            assert isinstance(self._weight, (int, float)), \
                "weight must be a number"
            loss = loss * self._weight
        if mean:
            loss = F.mean(loss, axis=self._batch_axis, exclude=True)
        return loss

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class L2Loss(Loss):
    """0.5 * weight * (pred - label)^2 (the 1/2 is reference-documented)."""

    def __init__(self, weight=1., batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        err = pred - F.reshape_like(label, pred)
        return self._finalize(F, 0.5 * F.square(err), sample_weight)


class L1Loss(Loss):
    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        err = pred - F.reshape_like(label, pred)
        return self._finalize(F, F.abs(err), sample_weight)


def _softplus(F, x):
    # Activation('softrelu') is torch's softplus, overflow-safe, so
    # log(1 + e^x) needs no max/abs splitting here
    return F.Activation(x, act_type="softrelu")


class SigmoidBinaryCrossEntropyLoss(Loss):
    """BCE on logits: softplus(x) - x*y == -[y log s(x) + (1-y) log(1-s(x))];
    on probabilities (from_sigmoid=True): the epsilon-guarded direct form."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = F.reshape_like(label, pred)
        if self._from_sigmoid:
            eps = 1e-12
            loss = -(label * F.log(pred + eps) +
                     (1. - label) * F.log(1. - pred + eps))
        else:
            loss = _softplus(F, pred) - pred * label
        return self._finalize(F, loss, sample_weight)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


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
            label = F.reshape_like(label, logp)
            nll = -F.sum(logp * label, axis=self._axis, keepdims=True)
        return self._finalize(F, nll, sample_weight)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    """KL(label || softmax(pred)) up to the constant entropy term —
    matches the reference's definition E_label[log label - logp]."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        logp = pred if self._from_logits \
            else F.log_softmax(pred, axis=self._axis)
        loss = label * (F.log(label + 1e-12) - logp)
        return self._finalize(F, loss, sample_weight)


class CTCLoss(Loss):
    """Connectionist temporal classification loss over the ``CTCLoss`` op
    (the reference's gluon contract: the blank is the LAST alphabet
    entry, labels are 0-based classes padded with -1)."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        assert layout in ("NTC", "TNC")
        assert label_layout in ("NT", "TN")
        self._layout = layout
        self._label_layout = label_layout
        batch_axis = label_layout.find("N")
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, pred_lengths=None,
                       label_lengths=None, sample_weight=None):
        if self._layout == "NTC":
            pred = F.swapaxes(pred, dim1=0, dim2=1)   # the op takes TNC
        if self._batch_axis == 1:
            label = F.swapaxes(label, dim1=0, dim2=1)
        args = [pred, label]
        if pred_lengths is not None:
            args.append(pred_lengths)
        if label_lengths is not None:
            args.append(label_lengths)
        loss = F.CTCLoss(*args,
                         use_data_lengths=pred_lengths is not None,
                         use_label_lengths=label_lengths is not None,
                         blank_label="last")
        return self._finalize(F, loss, sample_weight, mean=False)


class HuberLoss(Loss):
    """Quadratic inside |err| <= rho, linear outside (both branches scaled
    so they meet at rho with matching value)."""

    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        a = F.abs(pred - F.reshape_like(label, pred))
        quad = F.square(a) * (0.5 / self._rho)
        lin = a - 0.5 * self._rho
        return self._finalize(F, F.where(a > self._rho, lin, quad),
                              sample_weight)


class HingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        gap = self._margin - pred * F.reshape_like(label, pred)
        return self._finalize(F, F.relu(gap), sample_weight)


class SquaredHingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        gap = self._margin - pred * F.reshape_like(label, pred)
        return self._finalize(F, F.square(F.relu(gap)), sample_weight)


class LogisticLoss(Loss):
    """log(1 + e^{-pred*label}) for signed labels — algebraically the same
    BCE-on-logits softplus form after mapping labels to {0,1}."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        if label_format not in ("signed", "binary"):
            raise ValueError("label_format can only be signed or binary, "
                             f"recieved {label_format}.")
        self._label_format = label_format

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = F.reshape_like(label, pred)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0    # {-1,1} -> {0,1}
        loss = _softplus(F, pred) - pred * label
        return self._finalize(F, loss, sample_weight)


class TripletLoss(Loss):
    """relu(margin + ||a-p||^2 - ||a-n||^2), distances summed over
    non-batch axes before the hinge."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, positive, negative,
                       sample_weight=None):
        d_pos = F.square(pred - F.reshape_like(positive, pred))
        d_neg = F.square(pred - F.reshape_like(negative, pred))
        gap = F.sum(d_pos - d_neg, axis=self._batch_axis, exclude=True)
        return self._finalize(F, F.relu(gap + self._margin), sample_weight,
                              mean=False)
