"""Image decode, resize, crop, the augmenters and ``ImageIter``
(counterpart of mxnet_tpu/image/image.py).

Decoding follows ``ctx``: the card by default, where nvJPEG decodes into
device memory (``image.codec``), or the host with ``ctx=cpu()``, through
OpenCV and PIL where OpenCV is missing, as the JAX package. Images are
HWC NDArrays on that device, and every helper and augmenter keeps its
input's device: it works on the NDArray's tensor with torch ops.

Resizing needs no OpenCV: ``imresize`` computes OpenCV's resampling in
float64 (on the image's device): the same pixel-centre mapping
(``(d + 0.5) * scale - 0.5``), replicated borders, and the same kernels
for the ``interp`` codes 0 nearest, 1 bilinear, 2 bicubic (A = -0.75), 3
area, 4 Lanczos-4. An 8-bit image is rounded to the nearest integer at
the end, where OpenCV sums in fixed point: the two can differ by one
unit.

The random draws are the JAX package's, from the same generators in the
same order (``random`` for crops, flips, jitters and gray, ``np.random``
for the PCA lighting), so a seed gives its crops and flips.
"""
from __future__ import annotations

import json
import math
import os
import random as pyrandom

import numpy as np
import torch

from .. import io as io_mod
from .. import recordio
from ..base import MXNetError
from ..context import Context, current_context
from ..ndarray.ndarray import NDArray, array
from . import codec

__all__ = ["imdecode", "imread", "imresize", "resize_short", "fixed_crop",
           "random_crop", "center_crop", "color_normalize",
           "IMAGENET_DEFAULT_MEAN", "IMAGENET_DEFAULT_STD", "Augmenter",
           "ResizeAug", "ForceResizeAug", "RandomCropAug", "CenterCropAug",
           "HorizontalFlipAug", "CastAug", "ColorNormalizeAug",
           "BrightnessJitterAug", "ContrastJitterAug", "SaturationJitterAug",
           "LightingAug", "RandomGrayAug", "CreateAugmenter", "ImageIter"]

# ImageNet channel statistics of mean=True / std=True (the augmenter
# pipeline's and ImageRecordIter's)
IMAGENET_DEFAULT_MEAN = np.array([123.68, 116.28, 103.53])
IMAGENET_DEFAULT_STD = np.array([58.395, 57.12, 57.375])


def _tensor(src):
    """The tensor of an NDArray / tensor, or a host tensor of an array."""
    if isinstance(src, NDArray):
        return src._data
    if isinstance(src, torch.Tensor):
        return src
    return torch.from_numpy(np.ascontiguousarray(src))


def _device_of(ctx):
    ctx = Context(ctx) if ctx is not None else current_context()
    return ctx.torch_device()


def imdecode(buf, flag=1, to_rgb=True, out=None, ctx=None):
    """Decode an encoded image to an (H, W, C) uint8 NDArray on ``ctx``
    (default: the current context, the card): nvJPEG on the card (JPEG
    only), OpenCV or PIL on the host. ``flag`` 0 gives one gray channel;
    ``to_rgb`` False keeps BGR. ``out``: an NDArray to write into."""
    if isinstance(buf, NDArray):
        buf = buf.asnumpy().tobytes()
    dev = _device_of(ctx)
    if dev.type == "cpu":
        img = torch.from_numpy(np.ascontiguousarray(
            codec.host_imdecode(buf, flag, to_rgb)))
    else:
        img = codec.decode(buf, dev, 3 if flag else 1, to_rgb)
    if out is not None:
        out._data.copy_(img)
        return out
    return NDArray(img)


def imread(filename, flag=1, to_rgb=True, ctx=None):
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag=flag, to_rgb=to_rgb, ctx=ctx)


# -- resampling (OpenCV's, in float64) ---------------------------------------

def _cubic(x, a=-0.75):
    return np.stack([((a * (x + 1) - 5 * a) * (x + 1) + 8 * a) * (x + 1)
                     - 4 * a,
                     ((a + 2) * x - (a + 3)) * x * x + 1,
                     ((a + 2) * (1 - x) - (a + 3)) * (1 - x) * (1 - x) + 1],
                    -1)


def _lanczos4(x):
    t = x[:, None] + 3 - np.arange(8)
    w = np.sinc(t) * np.sinc(t / 4)
    return w / w.sum(1, keepdims=True)


def _area_weights(n_src, n_dst, shrink):
    """OpenCV's INTER_AREA as a (n_dst, n_src) matrix: each output cell
    averages the source cells it covers, in fractions, when both axes
    shrink; else bilinear with OpenCV's area mapping."""
    scale = n_src / n_dst
    w = np.zeros((n_dst, n_src))
    if not shrink:
        for d in range(n_dst):
            s = math.floor(d * scale)
            f = (d + 1) - (s + 1) / scale
            f = 0.0 if f <= 0 else f - math.floor(f)
            w[d, min(s, n_src - 1)] += 1 - f
            w[d, min(s + 1, n_src - 1)] += f
        return w
    for d in range(n_dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_src - f1)
        s1, s2 = math.ceil(f1), min(math.floor(f2), n_src - 1)
        s1 = min(s1, s2)
        if s1 - f1 > 1e-3:
            w[d, s1 - 1] += (s1 - f1) / cell
        w[d, s1:s2] += 1.0 / cell
        if f2 - s2 > 1e-3:
            w[d, s2] += min(min(f2 - s2, 1.0), cell) / cell
    return w


def _weights(n_src, n_dst, interp, shrink):
    """The (n_dst, n_src) resampling matrix of one axis (``shrink``: both
    axes shrink, which decides INTER_AREA's method)."""
    if interp == 3:
        return _area_weights(n_src, n_dst, shrink)
    scale = n_src / n_dst
    dst = np.arange(n_dst)
    w = np.zeros((n_dst, n_src))
    if interp == 0:
        w[dst, np.minimum(np.floor(dst * scale).astype(np.int64),
                          n_src - 1)] = 1.0
        return w
    f = (dst + 0.5) * scale - 0.5
    s = np.floor(f).astype(np.int64)
    f = f - s
    if interp == 2:
        taps, k = _cubic(f), 4
        taps = np.concatenate([taps, 1 - taps.sum(1, keepdims=True)], 1)
    elif interp == 4:
        taps, k = _lanczos4(f), 8
    else:
        # bilinear (any other code, as OpenCV's table lookup falls back)
        low, high = s < 0, s >= n_src - 1
        f = np.where(low | high, 0.0, f)
        s = np.where(low, 0, np.where(high, n_src - 1, s))
        taps, k = np.stack([1 - f, f], 1), 2
    idx = np.clip(s[:, None] + np.arange(k) - (k // 2 - 1), 0, n_src - 1)
    np.add.at(w, (np.repeat(dst, k), idx.reshape(-1)), taps.reshape(-1))
    return w


def imresize(src, w, h, interp=1):
    """``src`` (H, W[, C]) resampled to (h, w[, C]) with OpenCV's
    ``interp`` code on its device (numpy input: the host); an 8-bit image
    stays 8-bit."""
    data = _tensor(src)
    img = data[:, :, None] if data.dim() == 2 else data
    shrink = h <= img.shape[0] and w <= img.shape[1]
    wy = torch.from_numpy(_weights(img.shape[0], h, interp, shrink)).to(
        img.device)
    wx = torch.from_numpy(_weights(img.shape[1], w, interp, shrink)).to(
        img.device)
    out = torch.einsum("yh,hwc,xw->yxc", wy, img.to(torch.float64), wx)
    if not (data.dtype.is_floating_point or data.dtype.is_complex):
        info = torch.iinfo(data.dtype)
        out = torch.clamp(torch.round(out), info.min, info.max)
    return NDArray(out.to(data.dtype))


def resize_short(src, size, interp=2):
    """Resize so that the shorter side is ``size``, keeping the aspect
    ratio."""
    h, w = src.shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return imresize(src, new_w, new_h, interp=interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    """The (w, h) window at (x0, y0), resized to ``size`` when given."""
    data = _tensor(src)[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        return imresize(data, size[0], size[1], interp=interp)
    return NDArray(data.clone())


def random_crop(src, size, interp=2):
    """A ``size`` window at a random origin (``random.randint``), and its
    (x0, y0, w, h)."""
    h, w = src.shape[:2]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = pyrandom.randint(0, w - new_w)
    y0 = pyrandom.randint(0, h - new_h)
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    """The centred ``size`` window (resized when the image is smaller),
    and its (x0, y0, w, h)."""
    h, w = src.shape[:2]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def _stat(v, device):
    if v is None:
        return None
    if isinstance(v, NDArray):
        v = v.asnumpy()
    return torch.as_tensor(np.asarray(v, np.float32), device=device)


def color_normalize(src, mean, std=None):
    """``(src - mean) / std`` in float32."""
    data = _tensor(src).to(torch.float32)
    data = data - _stat(mean, data.device)
    std = _stat(std, data.device)
    if std is not None:
        data = data / std
    return NDArray(data)


# -- augmenters (image.py Augmenter registry) --------------------------------

class Augmenter:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if pyrandom.random() < self.p:
            return NDArray(_tensor(src).flip(1))
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        src = src if isinstance(src, NDArray) else NDArray(_tensor(src))
        return src.astype(self.typ)


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__(mean=mean, std=std)
        self.mean = np.asarray(mean, np.float32) if mean is not None else None
        self.std = np.asarray(std, np.float32) if std is not None else None

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


def _f32(src):
    return _tensor(src).to(torch.float32)


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + pyrandom.uniform(-self.brightness, self.brightness)
        return NDArray(_f32(src) * alpha)


_GRAY = (0.299, 0.587, 0.114)


class ContrastJitterAug(Augmenter):
    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast
        self.coef = np.array([[_GRAY]], np.float32)

    def __call__(self, src):
        data = _f32(src)
        alpha = 1.0 + pyrandom.uniform(-self.contrast, self.contrast)
        coef = torch.as_tensor(self.coef, device=data.device)
        gray = (data * coef).sum() * (3.0 / data.numel())
        return NDArray(data * alpha + gray * (1.0 - alpha))


class SaturationJitterAug(Augmenter):
    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation
        self.coef = np.array([[_GRAY]], np.float32)

    def __call__(self, src):
        data = _f32(src)
        alpha = 1.0 + pyrandom.uniform(-self.saturation, self.saturation)
        coef = torch.as_tensor(self.coef, device=data.device)
        gray = (data * coef).sum(dim=2, keepdim=True)
        return NDArray(data * alpha + gray * (1.0 - alpha))


class LightingAug(Augmenter):
    """PCA-based lighting jitter (AlexNet-style)."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval, np.float32)
        self.eigvec = np.asarray(eigvec, np.float32)

    def __call__(self, src):
        alpha = np.random.normal(0, self.alphastd, size=(3,))
        rgb = np.dot(self.eigvec * alpha, self.eigval)
        data = _f32(src)
        # the sum in float64 (numpy promotes), rounded once to float32
        return NDArray((data.to(torch.float64) + torch.as_tensor(
            rgb, device=data.device)).to(torch.float32))


class RandomGrayAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p
        self.coef = np.array([[[0.299], [0.587], [0.114]]], np.float32)

    def __call__(self, src):
        if pyrandom.random() < self.p:
            data = _f32(src)
            coef = torch.as_tensor(self.coef.reshape(3, 1),
                                   device=data.device)
            return NDArray((data @ coef).expand(data.shape).contiguous())
        return src


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """Standard augmenter pipeline factory (image.py CreateAugmenter)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness:
        auglist.append(BrightnessJitterAug(brightness))
    if contrast:
        auglist.append(ContrastJitterAug(contrast))
    if saturation:
        auglist.append(SaturationJitterAug(saturation))
    if pca_noise > 0:
        eigval = np.array([55.46, 4.794, 1.148])
        eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is True:
        mean = IMAGENET_DEFAULT_MEAN
    if std is True:
        std = IMAGENET_DEFAULT_STD
    if mean is not None or std is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


AUG_KEYS = ("resize", "rand_crop", "rand_resize", "rand_mirror", "mean",
            "std", "brightness", "contrast", "saturation", "hue",
            "pca_noise", "rand_gray", "inter_method")


class ImageIter(io_mod.DataIter):
    """Python image iterator over .rec files or an imglist
    (image.py ImageIter). Images are decoded and augmented on ``ctx``
    (default: the current context, the card) and batched there as
    float32 NCHW."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root=None,
                 path_imgidx=None, shuffle=False, part_index=0, num_parts=1,
                 aug_list=None, imglist=None, data_name="data",
                 label_name="softmax_label", ctx=None, **kwargs):
        super().__init__(batch_size)
        assert path_imgrec or path_imglist or (isinstance(imglist, list))
        self.ctx = Context(ctx) if ctx is not None else current_context()
        self.ctx.torch_device()          # the card: raises without one
        self.seq = None
        self.imgrec = None
        self.imglist = None
        if path_imgrec:
            if path_imgidx:
                self.imgrec = recordio.MXIndexedRecordIO(path_imgidx,
                                                         path_imgrec, "r")
                self.seq = list(self.imgrec.keys)
            else:
                self.imgrec = recordio.MXRecordIO(path_imgrec, "r")
        if path_imglist:
            with open(path_imglist) as fin:
                imglist = {}
                imgkeys = []
                for line in fin.readlines():
                    line = line.strip().split("\t")
                    label = np.array(line[1:-1], dtype=np.float32)
                    key = int(line[0])
                    imglist[key] = (label, line[-1])
                    imgkeys.append(key)
                self.imglist = imglist
                self.seq = imgkeys
        elif isinstance(imglist, list):
            result = {}
            imgkeys = []
            index = 1
            for img in imglist:
                key = str(index)
                index += 1
                if len(img) > 2:
                    label = np.array(img[:-1], dtype=np.float32)
                elif isinstance(img[0], (list, tuple, np.ndarray)):
                    label = np.array(img[0], dtype=np.float32)
                else:
                    label = np.array([img[0]], dtype=np.float32)
                result[key] = (label, img[-1])
                imgkeys.append(str(key))
            self.imglist = result
            self.seq = imgkeys
        self.path_root = path_root

        self.provide_data = [io_mod.DataDesc(
            data_name, (batch_size,) + tuple(data_shape))]
        if label_width > 1:
            self.provide_label = [io_mod.DataDesc(label_name,
                                                  (batch_size, label_width))]
        else:
            self.provide_label = [io_mod.DataDesc(label_name, (batch_size,))]
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.shuffle = shuffle
        if self.seq is not None and num_parts > 1:
            part = len(self.seq) // num_parts
            self.seq = self.seq[part_index * part:(part_index + 1) * part]
        if aug_list is None:
            self.auglist = CreateAugmenter(data_shape, **{
                k: v for k, v in kwargs.items() if k in AUG_KEYS})
        else:
            self.auglist = aug_list
        if self.seq is None and (shuffle or num_parts > 1):
            raise MXNetError(
                "ImageIter: shuffle/num_parts require path_imgidx or an "
                "imglist — a bare .rec file is sequential-only")
        self.cur = 0
        self.reset()

    def reset(self):
        if self.shuffle and self.seq is not None:
            pyrandom.shuffle(self.seq)
        if self.imgrec is not None and self.seq is None:
            self.imgrec.reset()
        self.cur = 0

    def next_sample(self):
        if self.seq is not None:
            if self.cur >= len(self.seq):
                raise StopIteration
            idx = self.seq[self.cur]
            self.cur += 1
            if self.imgrec is not None:
                s = self.imgrec.read_idx(idx)
                header, img = recordio.unpack(s)
                return header.label, img
            label, fname = self.imglist[idx]
            return label, self.read_image(fname)
        s = self.imgrec.read()
        if s is None:
            raise StopIteration
        header, img = recordio.unpack(s)
        return header.label, img

    def read_image(self, fname):
        with open(os.path.join(self.path_root or "", fname), "rb") as fin:
            return fin.read()

    def next(self):
        batch_size = self.batch_size
        c, h, w = self.data_shape
        dev = self.ctx.torch_device()
        batch_data = torch.zeros((batch_size, h, w, c), dtype=torch.float32,
                                 device=dev)
        batch_label = np.zeros((batch_size, self.label_width),
                               dtype=np.float32)
        i = 0
        try:
            while i < batch_size:
                label, s = self.next_sample()
                img = imdecode(s, ctx=self.ctx)
                for aug in self.auglist:
                    img = aug(img)
                batch_data[i] = _tensor(img)
                batch_label[i] = label
                i += 1
        except StopIteration:
            if i == 0:
                raise
        pad = batch_size - i
        data_nchw = batch_data.permute(0, 3, 1, 2).contiguous()
        label = batch_label[:, 0] if self.label_width == 1 else batch_label
        return io_mod.DataBatch(data=[NDArray(data_nchw)],
                                label=[array(label, ctx=self.ctx)], pad=pad,
                                provide_data=self.provide_data,
                                provide_label=self.provide_label)
