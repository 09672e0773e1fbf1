"""Detection image iterator and box-aware augmenters (counterpart of
mxnet_tpu/image/detection.py: ImageDetIter, CreateDetAugmenter,
Det*Aug).

Labels use the packed format of MXNet's detection datasets: each image's
raw label is [header_width, object_width, (extra header...), obj0 ..
objN], where an object is (id, xmin, ymin, xmax, ymax, ...) with the
coordinates normalized to [0, 1]. The iterator pads the batch's labels
with -1 to a fixed (batch, max_objects, object_width), the shape
MultiBoxTarget takes. Images are decoded and augmented on the iterator's
``ctx`` (default: the card) with torch ops; boxes stay numpy on the host.
The draws are the JAX package's (``random``, in its order).
"""
from __future__ import annotations

import random as pyrandom

import numpy as np
import torch

from .. import io as io_mod
from .. import recordio
from ..base import MXNetError
from ..ndarray.ndarray import NDArray, array
from .image import (IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD, Augmenter,
                    CastAug, ColorNormalizeAug, ForceResizeAug, ImageIter,
                    ResizeAug, _tensor, imdecode, imresize)

__all__ = ["ImageDetIter", "CreateDetAugmenter", "DetAugmenter",
           "DetBorrowAug", "DetHorizontalFlipAug", "DetRandomCropAug",
           "DetRandomSelectAug"]


class DetAugmenter:
    """Augmenter transforming (image, label) jointly."""

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Lift an image-only Augmenter into the detection pipeline."""

    def __init__(self, augmenter):
        if not isinstance(augmenter, Augmenter):
            raise MXNetError("DetBorrowAug requires an image Augmenter")
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetHorizontalFlipAug(DetAugmenter):
    """Random horizontal flip mirroring the box x coordinates."""

    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, src, label):
        if pyrandom.random() < self.p:
            src = NDArray(_tensor(src).flip(1))
            label = label.copy()
            x1 = label[:, 1].copy()
            label[:, 1] = 1.0 - label[:, 3]
            label[:, 3] = 1.0 - x1
        return src, label


class DetRandomCropAug(DetAugmenter):
    """Random crop keeping boxes whose centres stay inside; coordinates
    are re-normalized to the crop."""

    def __init__(self, min_crop_scale=0.5, max_attempts=10, p=0.5):
        self.min_scale = min_crop_scale
        self.max_attempts = max_attempts
        self.p = p

    def __call__(self, src, label):
        if pyrandom.random() >= self.p:
            return src, label
        data = _tensor(src)
        h, w = data.shape[:2]
        for _ in range(self.max_attempts):
            s = pyrandom.uniform(self.min_scale, 1.0)
            cw, ch = int(w * s), int(h * s)
            x0 = pyrandom.randint(0, w - cw)
            y0 = pyrandom.randint(0, h - ch)
            fx0, fy0 = x0 / w, y0 / h
            fw, fh = cw / w, ch / h
            cx = (label[:, 1] + label[:, 3]) / 2
            cy = (label[:, 2] + label[:, 4]) / 2
            keep = ((cx > fx0) & (cx < fx0 + fw) &
                    (cy > fy0) & (cy < fy0 + fh))
            if not keep.any():
                continue
            new = label[keep].copy()
            new[:, 1] = np.clip((new[:, 1] - fx0) / fw, 0, 1)
            new[:, 3] = np.clip((new[:, 3] - fx0) / fw, 0, 1)
            new[:, 2] = np.clip((new[:, 2] - fy0) / fh, 0, 1)
            new[:, 4] = np.clip((new[:, 4] - fy0) / fh, 0, 1)
            return NDArray(data[y0:y0 + ch, x0:x0 + cw].clone()), new
        return src, label


class DetRandomSelectAug(DetAugmenter):
    """Randomly pick one of several augmenters (or skip)."""

    def __init__(self, aug_list, skip_prob=0.0):
        self.aug_list = list(aug_list)
        self.skip_prob = skip_prob

    def __call__(self, src, label):
        if pyrandom.random() < self.skip_prob or not self.aug_list:
            return src, label
        return pyrandom.choice(self.aug_list)(src, label)


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0.0, rand_mirror=False,
                       mean=None, std=None, min_crop_scale=0.5, **kwargs):
    """Detection augmenter pipeline (detection.py CreateDetAugmenter)."""
    auglist = []
    if resize > 0:
        auglist.append(DetBorrowAug(ResizeAug(resize)))
    if rand_crop > 0:
        auglist.append(DetRandomCropAug(min_crop_scale=min_crop_scale,
                                        p=rand_crop))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    auglist.append(DetBorrowAug(ForceResizeAug((data_shape[2],
                                                data_shape[1]))))
    auglist.append(DetBorrowAug(CastAug()))
    if mean is True:
        mean = IMAGENET_DEFAULT_MEAN
    if std is True:
        std = IMAGENET_DEFAULT_STD
    if mean is not None or std is not None:
        auglist.append(DetBorrowAug(ColorNormalizeAug(mean, std)))
    return auglist


class ImageDetIter(ImageIter):
    """ImageIter for detection labels (detection.py ImageDetIter)."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root=None, path_imgidx=None,
                 shuffle=False, part_index=0, num_parts=1, aug_list=None,
                 imglist=None, data_name="data", label_name="label",
                 ctx=None, **kwargs):
        if aug_list is None:
            aug_list = CreateDetAugmenter(data_shape, **{
                k: v for k, v in kwargs.items()
                if k in ("resize", "rand_crop", "rand_mirror", "mean",
                         "std", "min_crop_scale")})
        super().__init__(batch_size=batch_size, data_shape=data_shape,
                         path_imgrec=path_imgrec, path_imglist=path_imglist,
                         path_root=path_root, path_imgidx=path_imgidx,
                         shuffle=shuffle, part_index=part_index,
                         num_parts=num_parts, aug_list=[], imglist=imglist,
                         data_name=data_name, label_name=label_name,
                         label_width=1, ctx=ctx)
        self.det_auglist = aug_list
        # a first pass over the labels sizes the fixed label tensor
        self.max_objects, self.obj_width = self._measure_label_shape()
        self.provide_label = [io_mod.DataDesc(
            label_name, (batch_size, self.max_objects, self.obj_width))]
        self.reset()

    def _parse_label(self, raw):
        """Unpack [header_width, obj_width, ...header, objects...] into an
        (N, obj_width) float array."""
        raw = np.asarray(raw, np.float32).ravel()
        if raw.size < 2:
            raise MXNetError("detection label too short")
        header_width = int(raw[0])
        obj_width = int(raw[1])
        if header_width < 2 or obj_width < 5:
            raise MXNetError(
                f"invalid detection label header ({header_width}, "
                f"{obj_width}); need header>=2, object>=5")
        body = raw[header_width:]
        if body.size % obj_width != 0:
            raise MXNetError("label body not a multiple of object width")
        return body.reshape(-1, obj_width)

    def _iter_raw_labels(self):
        """Every raw label in the source (imglist or .rec records)."""
        if self.imglist is not None:
            for label, _ in self.imglist.values():
                yield label
        elif self.imgrec is not None:
            self.imgrec.reset()
            while True:
                s = self.imgrec.read()
                if s is None:
                    break
                header, _ = recordio.unpack(s)
                yield header.label
            self.imgrec.reset()

    def _measure_label_shape(self):
        max_obj, width = 1, 5
        for label in self._iter_raw_labels():
            parsed = self._parse_label(label)
            max_obj = max(max_obj, parsed.shape[0])
            width = max(width, parsed.shape[1])
        return max_obj, width

    def reshape(self, data_shape=None, label_shape=None):
        """Adjust provided shapes (used to sync train/val iters)."""
        if data_shape is not None:
            self.provide_data = [io_mod.DataDesc(
                self.provide_data[0].name,
                (self.batch_size,) + tuple(data_shape))]
            self.data_shape = tuple(data_shape)
            # retarget the resize stage, or images are resized to the old
            # shape and then again in next()
            for aug in self.det_auglist:
                if isinstance(aug, DetBorrowAug) and \
                        isinstance(aug.augmenter, ForceResizeAug):
                    aug.augmenter = ForceResizeAug((data_shape[2],
                                                    data_shape[1]))
        if label_shape is not None:
            self.max_objects, self.obj_width = label_shape
            self.provide_label = [io_mod.DataDesc(
                self.provide_label[0].name,
                (self.batch_size,) + tuple(label_shape))]

    def next(self):
        dev = self.ctx.torch_device()
        batch_data = torch.zeros((self.batch_size,) + self.data_shape,
                                 dtype=torch.float32, device=dev)
        batch_label = -np.ones(
            (self.batch_size, self.max_objects, self.obj_width), np.float32)
        i = 0
        try:
            while i < self.batch_size:
                raw_label, s = self.next_sample()
                img = imdecode(s, ctx=self.ctx)
                label = self._parse_label(raw_label)
                for aug in self.det_auglist:
                    img, label = aug(img, label)
                data = _tensor(img)
                if tuple(data.shape[:2]) != (self.data_shape[1],
                                             self.data_shape[2]):
                    data = _tensor(imresize(data, self.data_shape[2],
                                            self.data_shape[1]))
                batch_data[i] = data.to(torch.float32).permute(2, 0, 1)
                n = min(label.shape[0], self.max_objects)
                w_lab = min(label.shape[1], self.obj_width)
                batch_label[i, :n, :w_lab] = label[:n, :w_lab]
                i += 1
        except StopIteration:
            if i == 0:
                raise
        return io_mod.DataBatch(
            data=[NDArray(batch_data)],
            label=[array(batch_label, ctx=self.ctx)],
            pad=self.batch_size - i, index=None,
            provide_data=self.provide_data,
            provide_label=self.provide_label)

    def draw_next(self, color=(255, 0, 0), thickness=2, **kwargs):
        """Rendering the boxes needs OpenCV's drawing; as in the JAX
        package, this build does not render them."""
        raise MXNetError("draw_next requires OpenCV rendering — not "
                         "available in this build")
