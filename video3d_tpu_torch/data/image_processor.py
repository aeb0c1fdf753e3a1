"""SigLIP image preprocessing on the host (numpy + PIL).

Equivalent to the reference ``SigLipImageProcessor`` (siglip_encoder.py:34-67):
PIL bicubic resize to 384x384, rescale 1/255, normalize mean/std 0.5, CHW.
PIL is used for the resize so the resampling numerics match the reference
exactly (transformers' resize delegates to PIL).

The port's own copy of ``video3d_tpu/data/image_processor.py`` (the port imports
nothing of the JAX package).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np
from PIL import Image


class SigLipImageProcessor:
    def __init__(self, image_mean=(0.5, 0.5, 0.5), image_std=(0.5, 0.5, 0.5),
                 size=(384, 384), rescale_factor: float = 1 / 255):
        self.image_mean = np.asarray(image_mean, np.float32)
        self.image_std = np.asarray(image_std, np.float32)
        self.size = tuple(size)
        self.rescale_factor = rescale_factor
        self.crop_size: Dict[str, int] = {"height": size[0], "width": size[1]}

    def preprocess_one(self, image) -> np.ndarray:
        if isinstance(image, np.ndarray):
            image = Image.fromarray(image.astype(np.uint8))
        image = image.convert("RGB")
        if image.size != (self.size[1], self.size[0]):
            image = image.resize((self.size[1], self.size[0]), Image.BICUBIC)
        arr = np.asarray(image, np.float32) * self.rescale_factor   # (H, W, 3)
        arr = (arr - self.image_mean) / self.image_std
        return arr.transpose(2, 0, 1)                                # (3, H, W)

    def preprocess(self, images: Union[Image.Image, Sequence]) -> np.ndarray:
        """Images -> (N, 3, H, W) float32 normalized pixel values."""
        if isinstance(images, Image.Image):
            images = [images]
        return np.stack([self.preprocess_one(im) for im in images])
