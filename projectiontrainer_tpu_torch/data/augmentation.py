"""CXR augmentation with the reference's transform semantics (the port's own copy of the
JAX package's ``data/augmentation.py``).

The five transforms and their sampling ranges and probabilities (reference:
augmentation.py:18-130): H-flip p=.5; scale 0.9-1.1 p=1 (zoom-in center-crop / zoom-out
zero-pad); shift ±10px reflect p=1; contrast 0.8-1.2 p=.3 (saturating uint8 scale);
elastic alpha 10-20 / sigma 2-3 p=.2 (gaussian-blurred uniform displacement, reflect).
Randomness flows through an explicit ``np.random.Generator``; the offline
dataset-expansion writer (:func:`expand_dataset`) mirrors
``process_images_with_pipeline`` (augmentation.py:159-222).

:func:`augment_and_preprocess_fast`, the path a training run takes, runs in the C++
pipeline (``runtime/native.py``) and needs neither cv2 nor scipy: the elastic fields
are blurred there too (``native.gaussian_blur``, cv2's ``GaussianBlur`` on float32).
The reference transforms (:func:`apply_pipeline`) and :func:`expand_dataset` use cv2
and scipy, imported inside the functions that call them.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Optional

import numpy as np

SHIFT_MIN, SHIFT_MAX = -10, 10
SCALE_MIN, SCALE_MAX = 0.9, 1.1
CONTRAST_MIN, CONTRAST_MAX = 0.8, 1.2
ELASTIC_ALPHA = (10, 20)
ELASTIC_SIGMA = (2, 3)


def flip_horizontal(image: np.ndarray) -> np.ndarray:
    import cv2

    return cv2.flip(image, 1)


def scale(image: np.ndarray, zoom: float) -> np.ndarray:
    """Zoom-in: resize up + center crop. Zoom-out: resize down + zero-pad to original."""
    import cv2

    h, w = image.shape[:2]
    if zoom == 1.0:
        return image.copy()
    nh, nw = int(h * zoom), int(w * zoom)
    resized = cv2.resize(image, (nw, nh), interpolation=cv2.INTER_LINEAR)
    if zoom > 1.0:
        cy, cx = nh // 2, nw // 2
        y0, x0 = max(0, cy - h // 2), max(0, cx - w // 2)
        out = resized[y0:y0 + h, x0:x0 + w]
        if out.shape[:2] != (h, w):
            out = cv2.resize(resized, (w, h), interpolation=cv2.INTER_LINEAR)
        return out
    dh, dw = h - nh, w - nw
    top, left = dh // 2, dw // 2
    out = cv2.copyMakeBorder(
        resized, top, dh - top, left, dw - left, cv2.BORDER_CONSTANT, value=[0, 0, 0]
    )
    if out.shape[:2] != (h, w):
        out = cv2.resize(out, (w, h), interpolation=cv2.INTER_LINEAR)
    return out


def shift(image: np.ndarray, dx: int, dy: int) -> np.ndarray:
    import cv2

    h, w = image.shape[:2]
    m = np.float32([[1, 0, dx], [0, 1, dy]])
    return cv2.warpAffine(image, m, (w, h), borderMode=cv2.BORDER_REFLECT_101)


def contrast(image: np.ndarray, factor: float) -> np.ndarray:
    import cv2

    return cv2.convertScaleAbs(image, alpha=factor, beta=0)


def elastic(image: np.ndarray, alpha: float, sigma: float,
            rng: Optional[np.random.Generator] = None) -> np.ndarray:
    import cv2
    from scipy.ndimage import map_coordinates

    rng = rng or np.random.default_rng()
    h, w = image.shape[:2]
    dx = cv2.GaussianBlur((rng.random((h, w)) * 2 - 1), (0, 0), sigma) * alpha
    dy = cv2.GaussianBlur((rng.random((h, w)) * 2 - 1), (0, 0), sigma) * alpha
    x, y = np.meshgrid(np.arange(w), np.arange(h))
    ix, iy = (x + dx).reshape(-1), (y + dy).reshape(-1)
    out = np.zeros_like(image)
    for c in range(image.shape[2]):
        out[..., c] = map_coordinates(
            image[..., c], [iy, ix], order=1, mode="reflect"
        ).reshape(h, w)
    return out


DEFAULT_PIPELINE = (
    ("flip", 0.5),
    ("scale", 1.0),
    ("shift", 1.0),
    ("contrast", 0.3),
    ("elastic", 0.2),
)


def apply_pipeline(
    image: np.ndarray,
    rng: Optional[np.random.Generator] = None,
    pipeline=DEFAULT_PIPELINE,
) -> np.ndarray:
    """Apply the augmentation pipeline to an RGB uint8 HWC image."""
    rng = rng or np.random.default_rng()
    out = image
    for name, prob in pipeline:
        if rng.random() >= prob:
            continue
        if name == "flip":
            out = flip_horizontal(out)
        elif name == "scale":
            out = scale(out, float(rng.uniform(SCALE_MIN, SCALE_MAX)))
        elif name == "shift":
            out = shift(out, int(rng.integers(SHIFT_MIN, SHIFT_MAX + 1)),
                        int(rng.integers(SHIFT_MIN, SHIFT_MAX + 1)))
        elif name == "contrast":
            out = contrast(out, float(rng.uniform(CONTRAST_MIN, CONTRAST_MAX)))
        elif name == "elastic":
            out = elastic(out, float(rng.uniform(*ELASTIC_ALPHA)),
                          float(rng.uniform(*ELASTIC_SIGMA)), rng=rng)
    return out


def augment_and_preprocess_fast(
    image: np.ndarray, size: int, rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Sampled augmentation + SigLIP preprocessing in ONE native pass.

    Samples the same parameter distribution, in the same order, as the JAX package's
    function. Non-elastic draws (80%) go through the C++ fused kernel
    (native.fused_preprocess: flip+zoom+shift+contrast+resize+normalize with no
    intermediates); elastic draws (p=0.2) blur their uniform displacement fields with
    native.gaussian_blur and go through native.fused_preprocess_elastic (full-res
    affine + scipy-parity elastic warp + resize+normalize).
    Returns float32 [size, size, 3] in [-1, 1].
    """
    from projectiontrainer_tpu_torch.runtime import native

    rng = rng or np.random.default_rng()
    do_flip = rng.random() < 0.5
    zoom = float(rng.uniform(SCALE_MIN, SCALE_MAX))
    dx = int(rng.integers(SHIFT_MIN, SHIFT_MAX + 1))
    dy = int(rng.integers(SHIFT_MIN, SHIFT_MAX + 1))
    do_contrast = rng.random() < 0.3
    alpha = float(rng.uniform(CONTRAST_MIN, CONTRAST_MAX)) if do_contrast else 1.0
    do_elastic = rng.random() < 0.2

    if do_elastic:
        e_alpha = float(rng.uniform(*ELASTIC_ALPHA))
        e_sigma = float(rng.uniform(*ELASTIC_SIGMA))
        h, w = image.shape[:2]
        dispx = native.gaussian_blur(
            rng.random((h, w), dtype=np.float32) * 2 - 1, e_sigma) * e_alpha
        dispy = native.gaussian_blur(
            rng.random((h, w), dtype=np.float32) * 2 - 1, e_sigma) * e_alpha
        return native.fused_preprocess_elastic(
            image, size, dispy, dispx, flip=do_flip, zoom=zoom, dx=dx, dy=dy,
            contrast=alpha,
        )

    return native.fused_preprocess(
        image, size, flip=do_flip, zoom=zoom, dx=dx, dy=dy, contrast=alpha
    )


def expand_dataset(
    input_json: str,
    image_root: str,
    output_image_dir: str,
    output_json: str,
    *,
    num_augmented_per_image: int = 1,
    seed: int = 0,
    pipeline=DEFAULT_PIPELINE,
) -> int:
    """Offline expansion: write augmented JPEGs + a new manifest including originals —
    the equivalent of the reference's ``process_images_with_pipeline``
    (augmentation.py:159-222). Returns the number of augmented images written."""
    import cv2

    with open(input_json) as f:
        samples = json.load(f)
    os.makedirs(output_image_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    out_samples = copy.deepcopy(samples)
    written = 0
    for sample in samples:
        src = os.path.join(image_root, sample["image"])
        img = cv2.imread(src)
        if img is None:
            continue
        base, ext = os.path.splitext(os.path.basename(sample["image"]))
        for k in range(num_augmented_per_image):
            aug = apply_pipeline(img, rng=rng, pipeline=pipeline)
            name = f"{base}_aug{k}{ext or '.jpg'}"
            cv2.imwrite(os.path.join(output_image_dir, name), aug)
            new_sample = dict(sample)
            new_sample["image"] = name
            out_samples.append(new_sample)
            written += 1
    with open(output_json, "w") as f:
        json.dump(out_samples, f, indent=2)
    return written
