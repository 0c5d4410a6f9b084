"""Host-side image preprocessing with SigLIP-processor parity (the port's own copy of
the JAX package's ``data/image.py``; PIL is imported inside the functions that decode
or resize, so that importing this module needs numpy only).

The reference path is PIL resize -> HF ``AutoProcessor`` (SiglipImageProcessor: resize,
rescale 1/255, normalize mean/std 0.5) — reference: Stage1/train_projection_stage1.py:103,
Stage2/dataset.py:96-101. Output here is **NHWC float32 in [-1, 1]** (the JAX package's layout;
HF's NCHW is transposed at import parity tests only).

Image file resolution replicates the reference's two-root + MIMIC-directory scheme
(Stage2/dataset.py:70-85, Stage1/train_projection_stage1.py:55-95): try primary root as a
file; if the path is a directory under the secondary root (MIMIC per-study dirs), use the
first ``.jpg`` inside; else fall back to the secondary root as a file path.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def resolve_image_path(
    name: str, image_root: str, image_root_2: Optional[str] = None
) -> str:
    primary = os.path.join(image_root, name)
    if os.path.exists(primary) and not os.path.isdir(primary):
        return primary
    if os.path.isdir(primary):
        jpgs = sorted(f for f in os.listdir(primary) if f.lower().endswith((".jpg", ".jpeg")))
        if jpgs:
            return os.path.join(primary, jpgs[0])
    if image_root_2:
        secondary = os.path.join(image_root_2, name)
        if os.path.isdir(secondary):
            jpgs = sorted(f for f in os.listdir(secondary) if f.lower().endswith((".jpg", ".jpeg")))
            if jpgs:
                return os.path.join(secondary, jpgs[0])
            raise FileNotFoundError(f"no .jpg in MIMIC directory {secondary}")
        if os.path.exists(secondary):
            return secondary
    raise FileNotFoundError(f"image {name!r} not found under {image_root} / {image_root_2}")


def load_image(path: str, *, draft_size: Optional[int] = None) -> "Image.Image":
    """Open an image as RGB. ``draft_size`` enables JPEG DCT-domain downscaling during
    decode (PIL ``draft``): the decoder emits at the smallest JPEG scale (1/2, 1/4,
    1/8) still >= draft_size, cutting decode time ~2-4x for large files. OFF by
    default — the decoded pixels differ slightly from a full decode + bicubic resize,
    so HF-processor preprocessing parity holds only without it. Opt in for
    throughput-bound training on very large source images."""
    from PIL import Image

    img = Image.open(path)
    if draft_size is not None:
        img.draft("RGB", (draft_size, draft_size))
    return img.convert("RGB")


def preprocess(
    image: "Image.Image | np.ndarray", size: int, *, rescale: float = 1.0 / 255.0,
    mean: float = 0.5, std: float = 0.5,
) -> np.ndarray:
    """PIL/array -> [size, size, 3] float32 normalized to [-1, 1] (SigLIP constants)."""
    from PIL import Image

    if isinstance(image, np.ndarray):
        image = Image.fromarray(image)
    if image.size != (size, size):
        image = image.resize((size, size), Image.BICUBIC)
    arr = np.asarray(image, dtype=np.float32) * rescale
    return (arr - mean) / std


def load_and_preprocess(
    name: str, size: int, image_root: str, image_root_2: Optional[str] = None,
    augment=None, rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    path = resolve_image_path(name, image_root, image_root_2)
    img = load_image(path)
    if augment is not None:
        arr = np.asarray(img)
        arr = augment(arr, rng=rng)
        return preprocess(arr, size)
    return preprocess(img, size)
