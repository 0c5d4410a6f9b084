"""ctypes bindings for the C++ host pipeline (``runtime/csrc/pipeline.cpp``), the port's
counterpart of the JAX package's ``runtime/native.py`` with the same functions and C
signatures.

The library is built at first use with ``g++ -O3 -march=native -fopenmp`` into
``build/native/`` at the root of the checkout, named by a hash of the source and the
flags (a changed source builds anew, an unchanged one loads the cached library). A
failed build raises with g++'s output: unlike the JAX package, nothing falls back to
numpy quietly. The numpy/cv2/scipy versions of each function stay as its plain
version, reached only by ``plain=True`` (the tests' oracles); cv2 and scipy are
imported inside them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "pipeline.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")
MAX_SIGMA = 31.0  # gaussian_blur_f32's kernel table holds 8 sigma + 1 taps up to 255

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libptt_pipeline_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the pipeline into ``build/native/`` unless the same source was built
    before; returns the library's path and raises with g++'s output on failure."""
    out = _library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: the host pipeline (runtime/csrc/pipeline.cpp) is "
                           "built from source at first use") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builds (feeder workers) all load one file
    return out


def _get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
    return _lib


def _declare(lib: ctypes.CDLL):
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int)
    lib.resize_bilinear_u8.argtypes = [u8p] + [ctypes.c_int] * 3 + [u8p] + [ctypes.c_int] * 2
    lib.flip_horizontal_u8.argtypes = [u8p] + [ctypes.c_int] * 3 + [u8p]
    lib.shift_reflect_u8.argtypes = [u8p] + [ctypes.c_int] * 5 + [u8p]
    lib.contrast_u8.argtypes = [u8p, ctypes.c_int, ctypes.c_float, u8p]
    lib.normalize_f32.argtypes = [u8p, ctypes.c_int] + [ctypes.c_float] * 3 + [f32p]
    lib.fused_preprocess.argtypes = (
        [u8p] + [ctypes.c_int] * 4 + [ctypes.c_float] * 4 + [ctypes.c_int]
        + [ctypes.c_float] * 3 + [f32p]
    )
    lib.elastic_warp_u8.argtypes = [u8p] + [ctypes.c_int] * 3 + [f32p, f32p, u8p]
    lib.fused_preprocess_elastic.argtypes = (
        [u8p] + [ctypes.c_int] * 4 + [ctypes.c_float] * 4 + [f32p, f32p]
        + [ctypes.c_int] + [ctypes.c_float] * 3 + [u8p, f32p]
    )
    lib.gaussian_blur_f32.argtypes = [f32p, ctypes.c_int, ctypes.c_int, ctypes.c_double,
                                      f32p, f32p]
    lib.fused_preprocess_batch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), i32p, i32p, ctypes.c_int, i32p, f32p, f32p,
        f32p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, f32p,
    ]
    lib.ptt_num_threads.restype = ctypes.c_int


def _hwc(img: np.ndarray) -> np.ndarray:
    """``img`` as a contiguous uint8 [H, W, C] array with 1 <= C <= 8 (the C++ samplers
    keep one pixel's channels in an array of 8)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or not 1 <= img.shape[2] <= 8 or 0 in img.shape:
        raise ValueError(f"expected a uint8 [H, W, C] image with 1-8 channels, got {img.shape}")
    return img


def _fields(dispy, dispx, h: int, w: int):
    dispy = np.ascontiguousarray(dispy, np.float32)
    dispx = np.ascontiguousarray(dispx, np.float32)
    if dispy.shape != (h, w) or dispx.shape != (h, w):
        raise ValueError(f"displacement fields {dispy.shape}, {dispx.shape} for a "
                         f"{h} x {w} image")
    return dispy, dispx


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


# ---------------------------------------------------------------------------- ops


def resize_bilinear(img: np.ndarray, size: int, *, plain: bool = False) -> np.ndarray:
    img = _hwc(img)
    h, w, c = img.shape
    if plain:
        import cv2

        return cv2.resize(img, (size, size), interpolation=cv2.INTER_LINEAR)
    lib = _get_lib()
    out = np.empty((size, size, c), np.uint8)
    lib.resize_bilinear_u8(_u8p(img), h, w, c, _u8p(out), size, size)
    return out


def fused_preprocess(
    img: np.ndarray, size: int, *, flip: bool = False, zoom: float = 1.0,
    dx: float = 0.0, dy: float = 0.0, contrast: float = 1.0,
    rescale: float = 1.0 / 255.0, mean: float = 0.5, std: float = 0.5, plain: bool = False,
) -> np.ndarray:
    """One-pass augment+preprocess: uint8 HWC -> float32 [size, size, C] in [-1, 1]."""
    img = _hwc(img)
    h, w, c = img.shape
    if plain:
        return _fused_fallback(img, size, flip, zoom, dx, dy, contrast, rescale, mean, std)
    lib = _get_lib()
    out = np.empty((size, size, c), np.float32)
    lib.fused_preprocess(
        _u8p(img), h, w, c, int(flip), float(zoom), float(dx), float(dy),
        float(contrast), size, rescale, mean, std, _f32p(out),
    )
    return out


def elastic_warp(img: np.ndarray, dispy: np.ndarray, dispx: np.ndarray, *,
                 plain: bool = False) -> np.ndarray:
    """scipy ``map_coordinates(..., order=1, mode='reflect')`` elastic warp:
    out(y, x) = img(y + dispy[y,x], x + dispx[y,x])."""
    img = _hwc(img)
    h, w, c = img.shape
    dispy, dispx = _fields(dispy, dispx, h, w)
    if plain:
        from scipy.ndimage import map_coordinates

        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        iy, ix = (ys + dispy).reshape(-1), (xs + dispx).reshape(-1)
        out = np.zeros_like(img)
        for k in range(c):
            out[..., k] = map_coordinates(
                img[..., k], [iy, ix], order=1, mode="reflect"
            ).reshape(h, w)
        return out
    lib = _get_lib()
    out = np.empty_like(img)
    lib.elastic_warp_u8(_u8p(img), h, w, c, _f32p(dispy), _f32p(dispx), _u8p(out))
    return out


def fused_preprocess_elastic(
    img: np.ndarray, size: int, dispy: np.ndarray, dispx: np.ndarray, *,
    flip: bool = False, zoom: float = 1.0, dx: float = 0.0, dy: float = 0.0,
    contrast: float = 1.0, rescale: float = 1.0 / 255.0, mean: float = 0.5,
    std: float = 0.5, plain: bool = False,
) -> np.ndarray:
    """Elastic variant of :func:`fused_preprocess`: affine+contrast at full res,
    elastic warp (scipy-reflect parity), bilinear resize + normalize — one native
    call. Returns float32 [size, size, C] in [-1, 1]."""
    img = _hwc(img)
    h, w, c = img.shape
    dispy, dispx = _fields(dispy, dispx, h, w)
    if plain:
        # numpy composition: full-res affine (the fused mapping at identity resize
        # grid) -> elastic warp -> bilinear resize + normalize
        full = _affine_contrast_fullres(img, bool(flip), float(zoom), float(dx),
                                        float(dy), float(contrast))
        warped = elastic_warp(full, dispy, dispx, plain=True)
        return _bilinear_resize_normalize(warped, size, rescale, mean, std)
    lib = _get_lib()
    out = np.empty((size, size, c), np.float32)
    tmp = np.empty((h, w, c), np.uint8)
    lib.fused_preprocess_elastic(
        _u8p(img), h, w, c, int(flip), float(zoom), float(dx), float(dy),
        float(contrast), _f32p(dispy), _f32p(dispx), size, rescale, mean, std,
        _u8p(tmp), _f32p(out),
    )
    return out


def gaussian_blur(plane: np.ndarray, sigma: float, *, plain: bool = False) -> np.ndarray:
    """``cv2.GaussianBlur(plane, (0, 0), sigma)`` of a float32 [H, W] plane: radius
    cvRound(8 sigma + 1) // 2, reflect-101 borders. The plain version is scipy's
    ``gaussian_filter`` at that radius with ``mode='mirror'`` (the same border)."""
    plane = np.ascontiguousarray(plane, np.float32)
    if plane.ndim != 2 or 0 in plane.shape:
        raise ValueError(f"expected a float32 [H, W] plane, got {plane.shape}")
    if not 0 < sigma <= MAX_SIGMA:
        raise ValueError(f"sigma {sigma} outside (0, {MAX_SIGMA}]")
    if plain:
        from scipy.ndimage import gaussian_filter

        radius = (int(np.rint(sigma * 8.0 + 1.0)) | 1) // 2
        return gaussian_filter(plane, sigma, mode="mirror", radius=radius)
    h, w = plane.shape
    lib = _get_lib()
    out = np.empty_like(plane)
    tmp = np.empty_like(plane)
    lib.gaussian_blur_f32(_f32p(plane), h, w, float(sigma), _f32p(tmp), _f32p(out))
    return out


def _affine_contrast_fullres(img, flip, zoom, dx, dy, contrast):
    """Full-res u8 affine+contrast — the fused mapping with an identity resize grid
    (numpy oracle for the native elastic path's pass 1)."""
    import cv2

    h, w, _ = img.shape
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    fy, fx = ys - dy, xs - dx
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    gy = (fy - cy) / zoom + cy
    gx = (fx - cx) / zoom + cx
    outside = (zoom < 1.0) & (
        (gy < -0.5) | (gy > h - 0.5) | (gx < -0.5) | (gx > w - 0.5)
    )
    gy = np.clip(gy, 0, h - 1)
    gx = np.clip(gx, 0, w - 1)
    if flip:
        gx = (w - 1) - gx
    sampled = cv2.remap(img, gx.astype(np.float32), gy.astype(np.float32),
                        cv2.INTER_LINEAR, borderMode=cv2.BORDER_REFLECT_101)
    out = np.clip(np.round(sampled.astype(np.float32) * contrast), 0, 255)
    out[outside] = 0
    return out.astype(np.uint8)


def _bilinear_resize_normalize(img, size, rescale, mean, std):
    """Clamped bilinear resize to u8 then normalize (numpy oracle for the native
    elastic path's final pass)."""
    h, w, c = img.shape
    ys = np.clip((np.arange(size, dtype=np.float32) + 0.5) * (h / size) - 0.5, 0, h - 1)
    xs = np.clip((np.arange(size, dtype=np.float32) + 0.5) * (w / size) - 0.5, 0, w - 1)
    y0 = ys.astype(np.int32)
    x0 = xs.astype(np.int32)
    ay, ax = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    f = img.astype(np.float32)
    top = f[y0][:, x0] + ax * (f[y0][:, x1] - f[y0][:, x0])
    bot = f[y1][:, x0] + ax * (f[y1][:, x1] - f[y1][:, x0])
    v = np.floor(np.clip(top + ay * (bot - top) + 0.5, 0, 255))
    return (v * rescale - mean) / std


def fused_preprocess_batch(
    imgs: list[np.ndarray], size: int, *, flips=None, zooms=None, dxs=None, dys=None,
    contrasts=None, rescale: float = 1.0 / 255.0, mean: float = 0.5, std: float = 0.5,
    plain: bool = False,
) -> np.ndarray:
    """OpenMP-parallel batch variant; per-image augmentation params."""
    n = len(imgs)
    flips = np.asarray(flips if flips is not None else np.zeros(n), np.int32)
    zooms = np.asarray(zooms if zooms is not None else np.ones(n), np.float32)
    dxs = np.asarray(dxs if dxs is not None else np.zeros(n), np.float32)
    dys = np.asarray(dys if dys is not None else np.zeros(n), np.float32)
    contrasts = np.asarray(contrasts if contrasts is not None else np.ones(n), np.float32)
    if plain:
        return np.stack([
            _fused_fallback(np.ascontiguousarray(im, np.uint8), size, bool(f), float(z),
                            float(dx), float(dy), float(ct), rescale, mean, std)
            for im, f, z, dx, dy, ct in zip(imgs, flips, zooms, dxs, dys, contrasts)
        ])
    lib = _get_lib()
    imgs = [_hwc(im) for im in imgs]
    c = imgs[0].shape[2]
    if any(im.shape[2] != c for im in imgs) or not all(
            len(a) == n for a in (flips, zooms, dxs, dys, contrasts)):
        raise ValueError("the batch's images must share their channel count, and each "
                         "parameter must have one value an image")
    hs = np.asarray([im.shape[0] for im in imgs], np.int32)
    ws = np.asarray([im.shape[1] for im in imgs], np.int32)
    ptrs = (ctypes.c_void_p * n)(*[im.ctypes.data for im in imgs])
    out = np.empty((n, size, size, c), np.float32)
    i32 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))  # noqa: E731
    lib.fused_preprocess_batch(
        ptrs, i32(hs), i32(ws), c, i32(flips), _f32p(zooms), _f32p(dxs), _f32p(dys),
        _f32p(contrasts), n, size, rescale, mean, std, _f32p(out),
    )
    return out


def _fused_fallback(img, size, flip, zoom, dx, dy, contrast, rescale, mean, std):
    """numpy/cv2 replication of the fused path (the parity oracle in tests)."""
    import cv2

    h, w, c = img.shape
    ys, xs = np.meshgrid(np.arange(size, dtype=np.float32),
                         np.arange(size, dtype=np.float32), indexing="ij")
    fy = (ys + 0.5) * (h / size) - 0.5 - dy
    fx = (xs + 0.5) * (w / size) - 0.5 - dx
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    gy = (fy - cy) / zoom + cy
    gx = (fx - cx) / zoom + cx
    outside = (zoom < 1.0) & (
        (gy < -0.5) | (gy > h - 0.5) | (gx < -0.5) | (gx > w - 0.5)
    )
    gy = np.clip(gy, 0, h - 1)
    gx = np.clip(gx, 0, w - 1)
    if flip:
        gx = (w - 1) - gx
    maps = (gx.astype(np.float32), gy.astype(np.float32))
    sampled = cv2.remap(img, maps[0], maps[1], cv2.INTER_LINEAR,
                        borderMode=cv2.BORDER_REFLECT_101).astype(np.float32)
    sampled = np.clip(np.round(sampled * contrast), 0, 255)
    sampled[outside] = 0.0
    return (sampled * rescale - mean) / std
