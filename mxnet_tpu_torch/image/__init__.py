"""Image helpers of the port (counterpart of mxnet_tpu/image): only
those that ``gluon.data.vision.transforms`` calls."""
from .image import imresize, resize_short, fixed_crop, center_crop

__all__ = ["imresize", "resize_short", "fixed_crop", "center_crop"]
