"""Data layer, as far as it is ported: augmentation on the device
(``device_pipeline``). Corpus subsetting and the infilling datasets are not
ported yet."""

from .device_pipeline import make_on_device_augment, random_mask_on_device

__all__ = ["make_on_device_augment", "random_mask_on_device"]
