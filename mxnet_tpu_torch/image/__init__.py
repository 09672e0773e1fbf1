"""mx.image: image decode, augmentation and the record iterators
(counterpart of mxnet_tpu/image). Decode runs on the card by default
(nvJPEG, ``codec``) or on the host with ``ctx=cpu()`` (OpenCV or PIL);
``ImageRecordIter``'s card route assembles its batches on the card with
the kernel of ``csrc/image_assemble.cu`` (``assemble``)."""
from .image import (imdecode, imresize, imread, resize_short, fixed_crop,
                    random_crop, center_crop, color_normalize, ImageIter,
                    CreateAugmenter, Augmenter, ResizeAug, ForceResizeAug,
                    RandomCropAug, CenterCropAug, HorizontalFlipAug,
                    ColorNormalizeAug, CastAug, BrightnessJitterAug,
                    ContrastJitterAug, SaturationJitterAug, LightingAug,
                    RandomGrayAug, IMAGENET_DEFAULT_MEAN,
                    IMAGENET_DEFAULT_STD)
from .io import ImageRecordIter
from .detection import (ImageDetIter, CreateDetAugmenter, DetAugmenter,
                        DetBorrowAug, DetHorizontalFlipAug, DetRandomCropAug,
                        DetRandomSelectAug)

__all__ = ["imdecode", "imresize", "imread", "resize_short", "fixed_crop",
           "random_crop", "center_crop", "color_normalize", "ImageIter",
           "CreateAugmenter", "ImageRecordIter", "Augmenter", "ResizeAug",
           "ForceResizeAug", "RandomCropAug", "CenterCropAug",
           "HorizontalFlipAug", "ColorNormalizeAug", "CastAug",
           "BrightnessJitterAug", "ContrastJitterAug", "SaturationJitterAug",
           "LightingAug", "RandomGrayAug", "IMAGENET_DEFAULT_MEAN",
           "IMAGENET_DEFAULT_STD", "ImageDetIter", "CreateDetAugmenter",
           "DetAugmenter", "DetBorrowAug", "DetHorizontalFlipAug",
           "DetRandomCropAug", "DetRandomSelectAug"]
