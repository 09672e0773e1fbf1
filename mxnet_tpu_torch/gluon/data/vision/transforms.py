"""Vision transforms (counterpart of
mxnet_tpu/gluon/data/vision/transforms.py): blocks over one HWC image
(``ToTensor`` makes it CHW float32 in [0, 1]). They run on the host, in
numpy, where the DataLoader's workers call them, and return host
NDArrays; the random ones draw from Python's ``random``, as the JAX
package's do."""
from __future__ import annotations

import numpy as np

from ...block import Block, HybridBlock
from ...nn.basic_layers import Sequential, HybridSequential
from ....context import cpu
from ....ndarray.ndarray import array

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize",
           "CenterCrop", "RandomResizedCrop", "RandomFlipLeftRight",
           "RandomFlipTopBottom", "RandomBrightness", "RandomContrast",
           "RandomSaturation"]


class Compose(Sequential):
    def __init__(self, transforms):
        super().__init__()
        transforms.append(None)
        hybrid = []
        for i in transforms:
            if isinstance(i, HybridBlock):
                hybrid.append(i)
                continue
            elif len(hybrid) == 1:
                self.add(hybrid[0])
                hybrid = []
            elif len(hybrid) > 1:
                hblock = HybridSequential()
                for j in hybrid:
                    hblock.add(j)
                self.add(hblock)
                hybrid = []
            if i is not None:
                self.add(i)


class Cast(HybridBlock):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def hybrid_forward(self, F, x):
        return F.Cast(x, dtype=self._dtype)


class ToTensor(Block):
    """HWC uint8 [0,255] → CHW float32 [0,1]."""

    def forward(self, x):
        data = x.asnumpy().astype(np.float32) / 255.0
        if data.ndim == 3:
            data = data.transpose(2, 0, 1)
        elif data.ndim == 4:
            data = data.transpose(0, 3, 1, 2)
        return array(data, ctx=cpu())


class Normalize(Block):
    def __init__(self, mean, std):
        super().__init__()
        self._mean = np.asarray(mean, np.float32)
        self._std = np.asarray(std, np.float32)

    def forward(self, x):
        data = x.asnumpy()
        mean = self._mean.reshape(-1, 1, 1)
        std = self._std.reshape(-1, 1, 1)
        return array((data - mean) / std, ctx=cpu())


class Resize(Block):
    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size if isinstance(size, (list, tuple)) else (size, size)
        self._keep = keep_ratio
        self._interpolation = interpolation

    def forward(self, x):
        from ....image import imresize, resize_short
        if self._keep:
            return resize_short(x, min(self._size))
        return imresize(x, self._size[0], self._size[1],
                        self._interpolation)


class CenterCrop(Block):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = size if isinstance(size, (list, tuple)) else (size, size)
        self._interpolation = interpolation

    def forward(self, x):
        from ....image import center_crop
        return center_crop(x, self._size, self._interpolation)[0]


class RandomResizedCrop(Block):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
                 interpolation=1):
        super().__init__()
        self._size = size if isinstance(size, (list, tuple)) else (size, size)
        self._scale = scale
        self._ratio = ratio
        self._interpolation = interpolation

    def forward(self, x):
        import random as pyrandom
        from ....image import fixed_crop
        h, w = x.shape[:2]
        area = h * w
        for _ in range(10):
            target_area = pyrandom.uniform(*self._scale) * area
            aspect = pyrandom.uniform(*self._ratio)
            new_w = int(round(np.sqrt(target_area * aspect)))
            new_h = int(round(np.sqrt(target_area / aspect)))
            if new_w <= w and new_h <= h:
                x0 = pyrandom.randint(0, w - new_w)
                y0 = pyrandom.randint(0, h - new_h)
                return fixed_crop(x, x0, y0, new_w, new_h, self._size,
                                  self._interpolation)
        from ....image import center_crop
        return center_crop(x, self._size, self._interpolation)[0]


class RandomFlipLeftRight(Block):
    def forward(self, x):
        import random as pyrandom
        if pyrandom.random() < 0.5:
            return array(x.asnumpy()[:, ::-1].copy(), ctx=cpu(),
                         dtype=x.dtype)
        return x


class RandomFlipTopBottom(Block):
    def forward(self, x):
        import random as pyrandom
        if pyrandom.random() < 0.5:
            return array(x.asnumpy()[::-1].copy(), ctx=cpu(),
                         dtype=x.dtype)
        return x


class RandomBrightness(Block):
    def __init__(self, brightness):
        super().__init__()
        self._args = max(0, 1 - brightness), 1 + brightness

    def forward(self, x):
        import random as pyrandom
        alpha = pyrandom.uniform(*self._args)
        return array(np.clip(x.asnumpy().astype(np.float32) * alpha, 0, 255)
                     .astype(x.dtype), ctx=cpu())


class RandomContrast(Block):
    def __init__(self, contrast):
        super().__init__()
        self._args = max(0, 1 - contrast), 1 + contrast

    def forward(self, x):
        import random as pyrandom
        alpha = pyrandom.uniform(*self._args)
        data = x.asnumpy().astype(np.float32)
        gray = data.mean()
        return array(np.clip(data * alpha + gray * (1 - alpha), 0, 255)
                     .astype(x.dtype), ctx=cpu())


class RandomSaturation(Block):
    def __init__(self, saturation):
        super().__init__()
        self._args = max(0, 1 - saturation), 1 + saturation

    def forward(self, x):
        import random as pyrandom
        alpha = pyrandom.uniform(*self._args)
        data = x.asnumpy().astype(np.float32)
        gray = data @ np.array([[0.299], [0.587], [0.114]], np.float32)
        return array(np.clip(data * alpha + gray * (1 - alpha), 0, 255)
                     .astype(x.dtype), ctx=cpu())
