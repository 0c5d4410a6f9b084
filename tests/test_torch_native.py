"""The port's C++ host pipeline (``projectiontrainer_tpu_torch/runtime``) against the JAX
package's (``projectiontrainer_tpu/runtime``) on the same seeded uint8 inputs: every
shared function bit-equal (the same source, the same g++ flags). Each is also held
against its own plain numpy/cv2/scipy version with the tolerances of
``tests/test_native_runtime.py``, and a build that fails raises instead of falling back.
"""

import numpy as np
import pytest

from projectiontrainer_tpu.runtime import native as jnative
from projectiontrainer_tpu_torch.runtime import native

FUSED_CASES = [
    dict(),
    dict(flip=True),
    dict(zoom=1.08),
    dict(zoom=0.92),
    dict(dx=4.0, dy=-6.0),
    dict(contrast=1.15),
    dict(flip=True, zoom=1.05, dx=3.0, dy=2.0, contrast=0.9),
]
ELASTIC_CASES = [
    dict(),
    dict(flip=True, zoom=1.07, dx=3.0, dy=-2.0, contrast=1.1),
    dict(zoom=0.93, dx=-5.0, dy=4.0),
]


@pytest.fixture(scope="module", autouse=True)
def jax_native_built():
    assert jnative.native_available(), "the JAX package's native pipeline did not build"


def _u8(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


def _fields(seed, h, w, amp):
    rng = np.random.default_rng(seed)
    return ((rng.random((h, w), dtype=np.float32) * 2 - 1) * amp,
            (rng.random((h, w), dtype=np.float32) * 2 - 1) * amp)


def test_builds_into_build_native_by_source_hash():
    path = native.build()
    assert path.parent == native.BUILD_DIR and path.name.startswith("libptt_pipeline_")
    assert native.build() == path  # cached: the same source is not built again
    assert native._get_lib().ptt_num_threads() >= 1


@pytest.mark.parametrize("shape,size", [((37, 53, 3), 24), ((64, 64, 3), 96), ((1, 9, 3), 4)])
def test_resize_bilinear(shape, size):
    img = _u8(0, shape)
    ours = native.resize_bilinear(img, size)
    np.testing.assert_array_equal(ours, jnative.resize_bilinear(img, size))
    ref = native.resize_bilinear(img, size, plain=True)
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.parametrize("kwargs", FUSED_CASES, ids=str)
def test_fused_preprocess(kwargs):
    img = _u8(1, (48, 40, 3))
    ours = native.fused_preprocess(img, 32, **kwargs)
    np.testing.assert_array_equal(ours, jnative.fused_preprocess(img, 32, **kwargs))
    ref = native.fused_preprocess(img, 32, plain=True, **kwargs)
    assert ours.dtype == ref.dtype == np.float32
    # bilinear implementations differ in rounding; tolerance = ~1.5/255 in [-1,1]
    assert np.abs(ours - ref).max() < 0.02, kwargs


def test_fused_identity_matches_plain_preprocess():
    """With no augmentation on an already-square image, fused == resize+normalize."""
    from projectiontrainer_tpu_torch.data.image import preprocess

    img = _u8(2, (32, 32, 3))
    np.testing.assert_allclose(native.fused_preprocess(img, 32), preprocess(img, 32),
                               atol=0.008)


@pytest.mark.parametrize("amp", [3.0, 30.0])
def test_elastic_warp(amp):
    """Far out-of-bounds displacements too (amp 30 on a 45 x 38 image)."""
    img = _u8(4, (45, 38, 3))
    dispy, dispx = _fields(5, 45, 38, amp)
    ours = native.elastic_warp(img, dispy, dispx)
    np.testing.assert_array_equal(ours, jnative.elastic_warp(img, dispy, dispx))
    # float32 vs float64 coordinate math: allow 1 LSB on a tiny fraction of pixels
    diff = np.abs(ours.astype(int) - native.elastic_warp(img, dispy, dispx,
                                                         plain=True).astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.02


@pytest.mark.parametrize("kwargs", ELASTIC_CASES, ids=str)
def test_fused_preprocess_elastic(kwargs):
    img = _u8(5, (57, 49, 3))
    dispy, dispx = _fields(6, 57, 49, 12.0)
    ours = native.fused_preprocess_elastic(img, 32, dispy, dispx, **kwargs)
    np.testing.assert_array_equal(
        ours, jnative.fused_preprocess_elastic(img, 32, dispy, dispx, **kwargs))
    ref = native.fused_preprocess_elastic(img, 32, dispy, dispx, plain=True, **kwargs)
    # cv2.remap vs native bilinear rounding: ~2 LSB tolerance in [-1,1] units
    assert np.abs(ours - ref).max() < 0.025, kwargs


def test_fused_preprocess_batch():
    imgs = [_u8(10 + i, (40, 44, 3)) for i in range(5)]
    kw = dict(flips=[0, 1, 0, 1, 0], zooms=[1.0, 1.1, 0.9, 1.0, 1.05],
              dxs=[0, 3, -2, 1, 0], dys=[0, -4, 2, 0, 5], contrasts=[1, 1.1, 0.85, 1, 1.2])
    batch = native.fused_preprocess_batch(imgs, 24, **kw)
    assert batch.shape == (5, 24, 24, 3)
    np.testing.assert_array_equal(batch, jnative.fused_preprocess_batch(imgs, 24, **kw))
    for i in range(5):
        single = native.fused_preprocess(
            imgs[i], 24, flip=bool(kw["flips"][i]), zoom=kw["zooms"][i], dx=kw["dxs"][i],
            dy=kw["dys"][i], contrast=kw["contrasts"][i])
        np.testing.assert_array_equal(batch[i], single)
    assert np.abs(batch - native.fused_preprocess_batch(imgs, 24, plain=True, **kw)).max() < 0.02


@pytest.mark.parametrize("shape,sigma", [((96, 80), 2.0), ((64, 64), 2.6), ((30, 17), 3.0),
                                         ((5, 9000), 2.5)])
def test_gaussian_blur_matches_scipy_mirror(shape, sigma):
    """The plain version (scipy, mode='mirror' at cv2's radius) agrees; planes
    narrower than the kernel fold their reflection more than once, and a row wider
    than 8192 floats goes through the same padded-row loop."""
    plane = np.random.default_rng(7).random(shape, dtype=np.float32) * 2 - 1
    ours = native.gaussian_blur(plane, sigma)
    assert ours.shape == shape and ours.dtype == np.float32
    np.testing.assert_allclose(ours, native.gaussian_blur(plane, sigma, plain=True),
                               rtol=0, atol=1e-6)


def test_gaussian_blur_refuses_a_sigma_out_of_range():
    with pytest.raises(ValueError, match="sigma"):
        native.gaussian_blur(np.zeros((8, 8), np.float32), 40.0)


@pytest.mark.parametrize("case", ["gray_2d", "nine_channels", "fields_shape", "batch_channels",
                                  "batch_params", "plane_3d"])
def test_refuses_shapes_the_library_cannot_take(case):
    """Checked before a pointer reaches C++ (its samplers hold 8 channels a pixel)."""
    img = _u8(0, (12, 10, 3))
    calls = {
        "gray_2d": lambda: native.fused_preprocess(img[..., 0], 8),
        "nine_channels": lambda: native.resize_bilinear(_u8(0, (12, 10, 9)), 8),
        "fields_shape": lambda: native.elastic_warp(img, *_fields(1, 10, 12, 2.0)),
        "batch_channels": lambda: native.fused_preprocess_batch([img, img[..., :1]], 8),
        "batch_params": lambda: native.fused_preprocess_batch([img, img], 8, zooms=[1.0]),
        "plane_3d": lambda: native.gaussian_blur(np.zeros((4, 4, 2), np.float32), 2.0),
    }
    with pytest.raises(ValueError):
        calls[case]()


def _fresh_build(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_lib", None)


def test_missing_compiler_raises_instead_of_falling_back(monkeypatch, tmp_path):
    _fresh_build(monkeypatch, tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++ on it
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.fused_preprocess(_u8(0, (8, 8, 3)), 4)
    assert native._lib is None and not list((tmp_path / "native").glob("*.so"))


def test_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    _fresh_build(monkeypatch, tmp_path)
    broken = tmp_path / "pipeline.cpp"
    broken.write_text('extern "C" void resize_bilinear_u8( { }\n')
    monkeypatch.setattr(native, "SOURCE", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as info:
        native.resize_bilinear(_u8(0, (8, 8, 3)), 4)
    assert "error" in str(info.value)
