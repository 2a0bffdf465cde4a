"""SimCLR-style photometric augmentation of training images (the port's own
copy of the JAX package's `data/augmentation.py`: numpy, PIL and scipy, the
same draws from the same `np.random.Generator`).

Reference: planercnn_transforms.py:183-191 (ColorJitter(0.8, 0.8, 0.8, 0.2)
with p 0.2, RandomGrayscale with p 0.2, GaussianBlur with sigma 0.1-2.0 and
p 0.5).
"""
from __future__ import annotations

import numpy as np


def _color_jitter(img: np.ndarray, rng: np.random.Generator,
                  brightness=0.8, contrast=0.8, saturation=0.8, hue=0.2) -> np.ndarray:
    from PIL import Image, ImageEnhance

    pil = Image.fromarray(img.astype(np.uint8))
    ops = [
        ("brightness", ImageEnhance.Brightness, brightness),
        ("contrast", ImageEnhance.Contrast, contrast),
        ("color", ImageEnhance.Color, saturation),
    ]
    order = rng.permutation(len(ops))
    for i in order:
        _, enh, mag = ops[i]
        factor = 1.0 + rng.uniform(-mag, mag)
        pil = enh(pil).enhance(max(factor, 0.0))
    if hue > 0:
        h = rng.uniform(-hue, hue)
        hsv = np.asarray(pil.convert("HSV"), np.int16)
        hsv[..., 0] = (hsv[..., 0] + int(h * 255)) % 256
        from PIL import Image as _I

        pil = _I.fromarray(hsv.astype(np.uint8), "HSV").convert("RGB")
    return np.asarray(pil, np.float32)


def _grayscale(img: np.ndarray) -> np.ndarray:
    g = img @ np.asarray([0.299, 0.587, 0.114], np.float32)
    return np.stack([g, g, g], axis=-1)


def _gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    from scipy import ndimage

    out = np.empty_like(img)
    for c in range(img.shape[-1]):
        out[..., c] = ndimage.gaussian_filter(img[..., c], sigma)
    return out


def simclr_augment(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """img: float32 RGB [H, W, 3] in [0, 255] -> augmented, same range."""
    if rng.random() < 0.2:
        img = _color_jitter(img, rng)
    if rng.random() < 0.2:
        img = _grayscale(img)
    if rng.random() < 0.5:
        img = _gaussian_blur(img, rng.uniform(0.1, 2.0))
    return np.clip(img, 0.0, 255.0).astype(np.float32)
