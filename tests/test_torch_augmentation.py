"""The port's augmentation (``projectiontrainer_tpu_torch/data/augmentation.py``) against
the JAX package's on the same seeds: the five reference transforms and
``apply_pipeline`` bit-equal (both call cv2 and scipy); the port's Gaussian blur of the
elastic fields (C++, in place of ``cv2.GaussianBlur``) within 1e-5 of cv2's;
``augment_and_preprocess_fast`` bit-equal on non-elastic draws and within one uint8
level on at most 0.1% of the pixels of an elastic draw; it runs with cv2 and scipy
hidden; ``expand_dataset`` writes the same manifest and images."""

import json
import sys

import cv2
import numpy as np
import pytest

from projectiontrainer_tpu import testing as T
from projectiontrainer_tpu.data import augmentation as JA
from projectiontrainer_tpu_torch.data import augmentation as A
from projectiontrainer_tpu_torch.runtime import native

ELASTIC_PIXEL_SHARE = 1e-3   # elastic draws: share of output values that may differ
ELASTIC_LEVEL = 2.0 / 255.0  # ... by at most one uint8 level after normalizing


def cxr_like(seed, h, w):
    """A gray chest-X-ray-like uint8 image stored as RGB: a bright body ellipse, dark
    lung fields, ribs and noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    cy, cx = h / 2, w / 2
    body = np.exp(-(((y - cy) / (0.48 * h)) ** 2 + ((x - cx) / (0.42 * w)) ** 2) ** 2)
    lungs = sum(np.exp(-(((y - 0.45 * h) / (0.25 * h)) ** 2
                         + ((x - side * w) / (0.12 * w)) ** 2)) for side in (0.33, 0.67))
    ribs = 0.08 * np.sin(y / h * 60.0 + np.sin(x / w * 3.0))
    img = 40 + 170 * body - 90 * lungs + 25 * ribs * body + rng.normal(0, 6, (h, w))
    gray = np.clip(img, 0, 255).astype(np.uint8)
    return np.repeat(gray[..., None], 3, axis=2)


@pytest.fixture(scope="module")
def image():
    return cxr_like(0, 96, 80)


@pytest.mark.parametrize("name", ["flip", "scale_in", "scale_out", "scale_one", "shift",
                                  "contrast", "elastic"])
def test_transform_matches_jax(image, name):
    calls = {
        "flip": lambda m: m.flip_horizontal(image),
        "scale_in": lambda m: m.scale(image, 1.07),
        "scale_out": lambda m: m.scale(image, 0.91),
        "scale_one": lambda m: m.scale(image, 1.0),
        "shift": lambda m: m.shift(image, -7, 4),
        "contrast": lambda m: m.contrast(image, 1.17),
        "elastic": lambda m: m.elastic(image, 15.0, 2.5, rng=np.random.default_rng(3)),
    }
    ours, theirs = calls[name](A), calls[name](JA)
    assert ours.shape == image.shape and ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("seed", range(6))
def test_apply_pipeline_matches_jax(image, seed):
    np.testing.assert_array_equal(A.apply_pipeline(image, rng=np.random.default_rng(seed)),
                                  JA.apply_pipeline(image, rng=np.random.default_rng(seed)))


@pytest.mark.parametrize("sigma", [2.0, 2.31, 2.77, 3.0])
def test_gaussian_blur_matches_cv2(sigma):
    plane = np.random.default_rng(int(sigma * 100)).random((1024, 1024), dtype=np.float32) * 2 - 1
    ours = native.gaussian_blur(plane, sigma)
    np.testing.assert_allclose(ours, cv2.GaussianBlur(plane, (0, 0), sigma), rtol=0, atol=1e-5)


def _draws_elastic(seed) -> bool:
    """Whether ``augment_and_preprocess_fast`` takes the elastic branch for ``seed``
    (the draws before it: flip, zoom, shift x2, contrast and its factor)."""
    rng = np.random.default_rng(seed)
    rng.random(), rng.uniform(A.SCALE_MIN, A.SCALE_MAX)
    rng.integers(A.SHIFT_MIN, A.SHIFT_MAX + 1), rng.integers(A.SHIFT_MIN, A.SHIFT_MAX + 1)
    if rng.random() < 0.3:
        rng.uniform(A.CONTRAST_MIN, A.CONTRAST_MAX)
    return rng.random() < 0.2


def test_augment_and_preprocess_fast_matches_jax():
    """64 seeds at 512 px from one 1024 x 960 source."""
    img = cxr_like(1, 1024, 960)
    n_elastic = 0
    for seed in range(64):
        ours = A.augment_and_preprocess_fast(img, 512, rng=np.random.default_rng(seed))
        theirs = JA.augment_and_preprocess_fast(img, 512, rng=np.random.default_rng(seed))
        assert ours.shape == (512, 512, 3) and ours.dtype == np.float32
        if _draws_elastic(seed):
            n_elastic += 1
            diff = np.abs(ours - theirs)
            assert (diff > 0).mean() <= ELASTIC_PIXEL_SHARE, seed
            assert diff.max() <= ELASTIC_LEVEL + 1e-6, seed
        else:
            np.testing.assert_array_equal(ours, theirs, err_msg=f"seed {seed}")
    assert 4 <= n_elastic <= 24  # p = 0.2 over 64 seeds: both branches are covered


def test_augment_and_preprocess_fast_needs_no_cv2_or_scipy(monkeypatch):
    img = cxr_like(2, 160, 144)
    seeds = [s for s in range(40) if _draws_elastic(s)][:2] + [0, 1]
    ref = [A.augment_and_preprocess_fast(img, 64, rng=np.random.default_rng(s)) for s in seeds]
    for name in ("cv2", "scipy", "scipy.ndimage"):
        monkeypatch.setitem(sys.modules, name, None)  # `import cv2` now raises
    with pytest.raises(ImportError):
        import cv2  # noqa: F401,F811
    for s, r in zip(seeds, ref):
        np.testing.assert_array_equal(
            A.augment_and_preprocess_fast(img, 64, rng=np.random.default_rng(s)), r)


def test_expand_dataset_matches_jax(tmp_path):
    root, manifest = T.synthetic_corpus(str(tmp_path / "corpus"), n=5, image_size=40)
    kw = dict(num_augmented_per_image=2, seed=4)
    n = A.expand_dataset(manifest, root, str(tmp_path / "ours"), str(tmp_path / "ours.json"),
                         **kw)
    m = JA.expand_dataset(manifest, root, str(tmp_path / "theirs"),
                          str(tmp_path / "theirs.json"), **kw)
    assert n == m == 10
    ours, theirs = (json.loads((tmp_path / f).read_text()) for f in ("ours.json", "theirs.json"))
    assert ours == theirs and len(ours) == 15
    for sample in ours[5:]:
        np.testing.assert_array_equal(cv2.imread(str(tmp_path / "ours" / sample["image"])),
                                      cv2.imread(str(tmp_path / "theirs" / sample["image"])))
