"""Host-side augmentation ops in numpy (port of
``worddiffusion_tpu/data/augment.py``, which calls PIL and OpenCV; the
card's machine has neither).

Each op is written out from the library routine the JAX op calls, on the
same ``np.random.Generator`` draws in the same order, so ``random_augment``
picks the same op with the same parameters:

- ``shear_x`` / ``shear_y``: PIL's ``transform(AFFINE)`` with NEAREST
  (``data.synthetic._affine_nearest``, the renderer's);
- ``erode`` / ``dilate``: PIL's ``MinFilter(3)`` / ``MaxFilter(3)``
  (``data.synthetic._rank3``, per band);
- ``rotate``: PIL's ``rotate(BILINEAR, fillcolor=255)`` (the generic
  transform's ``bilinear_filter32RGB``: doubles, truncated to uint8);
- ``blur``: PIL's ``GaussianBlur`` (``BoxBlur.c``: three extended box blurs
  each way, 8.24 fixed point);
- ``sharpness``: ``ImageEnhance.Sharpness`` (the SMOOTH 3x3 kernel in
  float32, then ``Image.blend``);
- ``random_perspective``: OpenCV's ``getPerspectiveTransform`` (an 8x8 LU
  solve, bitwise) and ``warpPerspective`` with INTER_LINEAR (OpenCV 5's
  float kernel; the one op that is not bitwise: within 1 on at most 0.05%
  of the values), border 255;
- ``noise``, ``random_erase``, ``vertical_line_eraser``: numpy, as the JAX
  ops.

All ops take and return uint8 HWC images. ``tests/test_torch_augment.py``
holds each against the JAX op.
"""

from __future__ import annotations

import math

import numpy as np

from .native import vertical_lines
from .synthetic import _affine_nearest, _rank3


def _per_band(img: np.ndarray, fn) -> np.ndarray:
    if img.ndim == 2:
        return fn(img)
    return np.stack([fn(img[..., c]) for c in range(img.shape[2])], axis=-1)


def noise(img: np.ndarray, rng: np.random.Generator, variability: float = 25.0) -> np.ndarray:
    deviation = variability * rng.random()
    out = img.astype(np.int32) + rng.normal(0, deviation, img.shape).astype(np.int32)
    return np.clip(out, 0, 255).astype(np.uint8)


def _pil_fill(img: np.ndarray, color: int = 255):
    """What PIL paints for ``fillcolor=color`` (an int) in ``img``'s mode: the
    value itself in "L", but in "RGB" the int is a packed pixel, so 255 is
    red, (255, 0, 0). The JAX ops pass 255 meaning white and get red borders
    on RGB crops; the port paints the same (ROADMAP C)."""
    if img.ndim == 2:
        return color
    packed = [(color >> (8 * i)) & 0xFF for i in range(img.shape[2])]
    return np.asarray(packed, np.uint8)


def shear_x(img: np.ndarray, factor: float) -> np.ndarray:
    return _affine_nearest(img, (1, factor, 0, 0, 1, 0), _pil_fill(img))


def shear_y(img: np.ndarray, factor: float) -> np.ndarray:
    return _affine_nearest(img, (1, 0, 0, factor, 1, 0), _pil_fill(img))


def erode(img: np.ndarray, cycles: int = 1) -> np.ndarray:
    for _ in range(cycles):
        img = _per_band(img, lambda b: _rank3(b, np.minimum))
    return img


def dilate(img: np.ndarray, cycles: int = 1) -> np.ndarray:
    for _ in range(cycles):
        img = _per_band(img, lambda b: _rank3(b, np.maximum))
    return img


def _smooth(band: np.ndarray) -> np.ndarray:
    """PIL's ``ImageFilter.SMOOTH`` (``Filter.c::ImagingFilter3x3``): the
    kernel (1 1 1 / 1 5 1 / 1 1 1) / 13 in float32, rows y+1, y, y-1 in
    that order, +0.5 and truncated; the border rows and columns copied."""
    f32 = np.float32
    k1, k5 = f32(1.0) / f32(13.0), f32(5.0) / f32(13.0)
    x = band.astype(f32)
    h, w = band.shape
    out = band.copy()
    if h < 3 or w < 3:
        return out

    def row(r, kc):  # (left*k1 + centre*kc) + right*k1, as the C macro
        return (r[:, :-2] * k1 + r[:, 1:-1] * kc) + r[:, 2:] * k1

    ss = f32(0.5) + row(x[2:], k1)
    ss = ss + row(x[1:-1], k5)
    ss = ss + row(x[:-2], k1)
    out[1:-1, 1:-1] = np.clip(ss, 0, 255).astype(np.uint8)
    return out


def _blend(im1: np.ndarray, im2: np.ndarray, alpha: float) -> np.ndarray:
    """``Image.blend(im1, im2, alpha)`` (``Blend.c``): float32, truncated;
    outside [0, 1] clipped to [0, 255]."""
    if alpha == 0.0:
        return im1.copy()
    if alpha == 1.0:
        return im2.copy()
    a = np.float32(alpha)
    v = im1.astype(np.float32) + a * (im2.astype(np.int32) - im1.astype(np.int32)).astype(
        np.float32)
    if 0.0 <= alpha <= 1.0:
        return v.astype(np.uint8)
    return np.clip(v, 0, 255).astype(np.uint8)


def sharpness(img: np.ndarray, factor: float) -> np.ndarray:
    return _blend(_per_band(img, _smooth), img, factor)


def _gaussian_blur_radius(radius: float, passes: int) -> np.float32:
    """``BoxBlur.c::_gaussian_blur_radius``: the extended box radius of
    ``passes`` box blurs with the Gaussian's variance, in C's float and
    double as the source mixes them."""
    f32 = np.float32
    sigma2 = f32(radius) * f32(radius) / f32(passes)
    big_l = f32(math.sqrt(12.0 * float(sigma2) + 1.0))
    small_l = f32(math.floor((float(big_l) - 1.0) / 2.0))
    a = (f32(2) * small_l + f32(1)) * (small_l * (small_l + f32(1)) - f32(3) * sigma2)
    a = a / (f32(6) * (sigma2 - (small_l + f32(1)) * (small_l + f32(1))))
    return small_l + a


def _box_blur_rows(x: np.ndarray, float_radius: np.float32) -> np.ndarray:
    """One ``ImagingHorizontalBoxBlur`` pass over the last axis of uint8
    ``x``: the sum over [i - r, i + r] times ww, plus the two pixels just
    outside it times fw (indices clamped to the row), in 8.24 fixed point,
    rounded."""
    r = int(float_radius)
    ww = int(np.float32(1 << 24) / (float_radius * np.float32(2) + np.float32(1)))
    fw = ((1 << 24) - (2 * r + 1) * ww) // 2
    n = x.shape[-1]
    xi = x.astype(np.int64)
    acc = np.zeros_like(xi)
    for k in range(-r, r + 1):
        acc += xi[..., np.clip(np.arange(n) + k, 0, n - 1)]
    far = (xi[..., np.clip(np.arange(n) - r - 1, 0, n - 1)]
           + xi[..., np.clip(np.arange(n) + r + 1, 0, n - 1)])
    bulk = (acc * ww + far * fw) & 0xFFFFFFFF  # UINT32 arithmetic
    return ((bulk + (1 << 23)) >> 24).astype(np.uint8)


def blur(img: np.ndarray, radius: float, passes: int = 3) -> np.ndarray:
    """``ImageFilter.GaussianBlur(radius)``: ``passes`` box blurs along x,
    then ``passes`` along y, each rounded to uint8."""
    r = _gaussian_blur_radius(radius, passes)
    if r == 0:
        return img.copy()
    x = np.moveaxis(img, 1, -1) if img.ndim == 3 else img  # [H, C, W]
    for _ in range(passes):
        x = _box_blur_rows(x, r)
    x = np.moveaxis(x, -1, 1) if img.ndim == 3 else x
    y = np.moveaxis(x, 0, -1)  # [W, (C,) H]
    for _ in range(passes):
        y = _box_blur_rows(y, r)
    return np.ascontiguousarray(np.moveaxis(y, -1, 0))


def _pil_rotate_matrix(deg: float, w: int, h: int) -> list:
    """``Image.rotate``'s inverse affine matrix about the centre."""
    angle = -math.radians(deg % 360.0)
    m = [round(math.cos(angle), 15), round(math.sin(angle), 15), 0.0,
         round(-math.sin(angle), 15), round(math.cos(angle), 15), 0.0]
    cx, cy = w / 2.0, h / 2.0
    m[2] = m[0] * -cx + m[1] * -cy + m[2] + cx
    m[5] = m[3] * -cx + m[4] * -cy + m[5] + cy
    return m


def _affine_bilinear(img: np.ndarray, a: list, fill: int = 255) -> np.ndarray:
    """PIL's generic ``transform(AFFINE, BILINEAR)``: the source point of
    pixel centre (x + 0.5, y + 0.5) in doubles; outside [0, size) it keeps
    ``fill``; else the 2x2 bilinear blend of the pixel centres around it
    (columns clamped, a row below the image dropped), truncated to uint8."""
    h, w = img.shape[:2]
    xs = np.arange(w, dtype=np.float64)[None] + 0.5
    ys = np.arange(h, dtype=np.float64)[:, None] + 0.5
    xin = a[0] * xs + a[1] * ys + a[2]
    yin = a[3] * xs + a[4] * ys + a[5]
    inside = (xin >= 0.0) & (xin < w) & (yin >= 0.0) & (yin < h)
    xin, yin = xin - 0.5, yin - 0.5
    x0, y0 = np.floor(xin), np.floor(yin)
    dx, dy = xin - x0, yin - y0
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    xa, xb = np.clip(x0, 0, w - 1), np.clip(x0 + 1, 0, w - 1)
    ya = np.clip(y0, 0, h - 1)
    has_b = (y0 + 1 >= 0) & (y0 + 1 < h)
    yb = np.clip(y0 + 1, 0, h - 1)
    f = img.astype(np.float64)
    if img.ndim == 3:
        dx, dy, inside, has_b = dx[..., None], dy[..., None], inside[..., None], has_b[..., None]
    v1 = f[ya, xa] + (f[ya, xb] - f[ya, xa]) * dx
    v2 = f[yb, xa] + (f[yb, xb] - f[yb, xa]) * dx
    v = np.where(has_b, v1 + (v2 - v1) * dy, v1)
    return np.where(inside, v.astype(np.uint8), _pil_fill(img, fill)).astype(np.uint8)


def rotate(img: np.ndarray, rng: np.random.Generator, max_deg: float = 3.0) -> np.ndarray:
    deg = float(rng.uniform(-max_deg, max_deg))
    if deg % 360.0 == 0.0:
        return img.copy()
    h, w = img.shape[:2]
    return _affine_bilinear(img, _pil_rotate_matrix(deg, w, h))


def _lu_solve(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """OpenCV's ``LUImpl`` (``cv::solve``, DECOMP_LU): Gaussian elimination
    with partial pivoting in doubles, in its operation order."""
    a, b = a.astype(np.float64).copy(), b.astype(np.float64).copy()
    m = a.shape[0]
    for i in range(m):
        k = i + int(np.argmax(np.abs(a[i:, i])))
        if k != i:
            a[[i, k], i:] = a[[k, i], i:]
            b[[i, k]] = b[[k, i]]
        d = -1.0 / a[i, i]
        for j in range(i + 1, m):
            alpha = a[j, i] * d
            a[j, i + 1:] += alpha * a[i, i + 1:]
            b[j] += alpha * b[i]
    for i in range(m - 1, -1, -1):
        s = b[i]
        for k in range(i + 1, m):
            s -= a[i, k] * b[k]
        b[i] = s / a[i, i]
    return b


def perspective_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """``cv2.getPerspectiveTransform`` of float32 point quads -> [3, 3]
    float64 (the products of two float32 coordinates in float32, as the
    C++ source forms them)."""
    src, dst = np.asarray(src, np.float32), np.asarray(dst, np.float32)
    a = np.zeros((8, 8))
    b = np.zeros(8)
    for i in range(4):
        a[i, 0] = a[i + 4, 3] = src[i, 0]
        a[i, 1] = a[i + 4, 4] = src[i, 1]
        a[i, 2] = a[i + 4, 5] = 1.0
        a[i, 6] = -(src[i, 0] * dst[i, 0])
        a[i, 7] = -(src[i, 1] * dst[i, 0])
        a[i + 4, 6] = -(src[i, 0] * dst[i, 1])
        a[i + 4, 7] = -(src[i, 1] * dst[i, 1])
        b[i], b[i + 4] = dst[i, 0], dst[i, 1]
    return np.append(_lu_solve(a, b), 1.0).reshape(3, 3)


def _invert3(m: np.ndarray) -> np.ndarray:
    """``cv::invert`` of a 3x3 double matrix (DECOMP_LU's closed form)."""
    s = m
    d = (s[0, 0] * (s[1, 1] * s[2, 2] - s[1, 2] * s[2, 1])
         - s[0, 1] * (s[1, 0] * s[2, 2] - s[1, 2] * s[2, 0])
         + s[0, 2] * (s[1, 0] * s[2, 1] - s[1, 1] * s[2, 0]))
    if d == 0.0:
        return np.zeros((3, 3))
    d = 1.0 / d
    return np.array([
        [(s[1, 1] * s[2, 2] - s[1, 2] * s[2, 1]) * d, (s[0, 2] * s[2, 1] - s[0, 1] * s[2, 2]) * d,
         (s[0, 1] * s[1, 2] - s[0, 2] * s[1, 1]) * d],
        [(s[1, 2] * s[2, 0] - s[1, 0] * s[2, 2]) * d, (s[0, 0] * s[2, 2] - s[0, 2] * s[2, 0]) * d,
         (s[0, 2] * s[1, 0] - s[0, 0] * s[1, 2]) * d],
        [(s[1, 0] * s[2, 1] - s[1, 1] * s[2, 0]) * d, (s[0, 1] * s[2, 0] - s[0, 0] * s[2, 1]) * d,
         (s[0, 0] * s[1, 1] - s[0, 1] * s[1, 0]) * d],
    ])


def _fma32(a, b, c) -> np.ndarray:
    """float32 ``fma(a, b, c)``: the product of two float32 is exact in
    float64, so one rounding, as the card's or the CPU's FMA unit does."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def warp_perspective(img: np.ndarray, m: np.ndarray, border: int = 255) -> np.ndarray:
    """``cv2.warpPerspective(img, m, (w, h), borderValue=border)`` with
    INTER_LINEAR as OpenCV 5 computes it (its float warp kernels): the
    inverse of ``m`` in doubles, then float32; each output pixel's source
    ``fma(M0, x, fma(M1, y, M2)) / fma(M6, x, fma(M7, y, M8))`` (and the same
    for y); the four taps around it (``border`` outside the image) blended
    by fused multiply-adds on the fractions, rounded half to even. Within 1
    of OpenCV on at most 0.05% of the values (``tests/test_torch_augment.py``:
    the vector kernel's remainder lanes round another way)."""
    h, w = img.shape[:2]
    M = _invert3(np.asarray(m, np.float64)).reshape(-1).astype(np.float32)
    ys = np.arange(h, dtype=np.float32)[:, None]
    xs = np.arange(w, dtype=np.float32)[None]
    W = _fma32(M[6], xs, _fma32(M[7], ys, M[8]))
    sx = (_fma32(M[0], xs, _fma32(M[1], ys, M[2])) / W).astype(np.float32)
    sy = (_fma32(M[3], xs, _fma32(M[4], ys, M[5])) / W).astype(np.float32)
    ix, iy = np.floor(sx), np.floor(sy)
    a = (sx - ix).astype(np.float32)
    b = (sy - iy).astype(np.float32)
    ix, iy = ix.astype(np.int64), iy.astype(np.int64)

    def tap(yy, xx):
        ok = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        v = img[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)].astype(np.float32)
        if img.ndim == 3:
            ok = ok[..., None]
        return np.where(ok, v, np.float32(border))

    if img.ndim == 3:
        a, b = a[..., None], b[..., None]
    p00, p01, p10, p11 = tap(iy, ix), tap(iy, ix + 1), tap(iy + 1, ix), tap(iy + 1, ix + 1)
    f0 = _fma32(a, p01 - p00, p00)
    f1 = _fma32(a, p11 - p10, p10)
    return np.clip(np.rint(_fma32(b, f1 - f0, f0)), 0, 255).astype(np.uint8)


def random_perspective(
    img: np.ndarray, rng: np.random.Generator, distortion: float = 0.5
) -> np.ndarray:
    h, w = img.shape[:2]
    dx = distortion * w / 2
    dy = distortion * h / 2
    src = np.float32([[0, 0], [w, 0], [w, h], [0, h]])
    dst = src + np.float32(
        [[rng.uniform(0, dx), rng.uniform(0, dy)],
         [-rng.uniform(0, dx), rng.uniform(0, dy)],
         [-rng.uniform(0, dx), -rng.uniform(0, dy)],
         [rng.uniform(0, dx), -rng.uniform(0, dy)]]
    )
    return warp_perspective(img, perspective_transform(src, dst))


def random_erase(
    img: np.ndarray, rng: np.random.Generator,
    area: tuple = (0.02, 0.2), aspect: tuple = (0.3, 3.3),
) -> np.ndarray:
    h, w = img.shape[:2]
    out = img.copy()
    for _ in range(10):
        target = rng.uniform(*area) * h * w
        ar = np.exp(rng.uniform(np.log(aspect[0]), np.log(aspect[1])))
        eh = int(round(np.sqrt(target * ar)))
        ew = int(round(np.sqrt(target / ar)))
        if eh < h and ew < w:
            y = int(rng.integers(0, h - eh))
            x = int(rng.integers(0, w - ew))
            out[y : y + eh, x : x + ew] = rng.integers(
                0, 256, (eh, ew) + img.shape[2:], dtype=np.uint8
            )
            return out
    return out


def vertical_line_eraser(
    img: np.ndarray, rng: np.random.Generator,
    num_lines: tuple = (10, 20), value: int = 255,
) -> np.ndarray:
    """Random vertical white lines over the word (reference
    ``dump_images``, ``trainModifyCondition.py:125-156``)."""
    out = np.ascontiguousarray(img.copy())
    n = int(rng.integers(num_lines[0], num_lines[1] + 1))
    xs = rng.integers(0, img.shape[1], n)
    if out.dtype == np.uint8 and out.ndim == 3:
        return vertical_lines(out, xs, value)
    out[:, xs] = value
    return out


DEFAULT_OPS = ("noise", "shear_x", "shear_y", "erode", "dilate", "blur",
               "rotate", "random_perspective", "random_erase")


def random_augment(
    img: np.ndarray, rng: np.random.Generator, ops: tuple = DEFAULT_OPS
) -> np.ndarray:
    """Apply one randomly chosen op with reference-ish parameters."""
    op = ops[int(rng.integers(0, len(ops)))]
    if op == "noise":
        return noise(img, rng)
    if op == "shear_x":
        return shear_x(img, float(rng.uniform(-0.3, 0.3)))
    if op == "shear_y":
        return shear_y(img, float(rng.uniform(-0.05, 0.05)))
    if op == "erode":
        return erode(img, 1)
    if op == "dilate":
        return dilate(img, 1)
    if op == "blur":
        return blur(img, float(rng.uniform(0.5, 1.5)))
    if op == "rotate":
        return rotate(img, rng)
    if op == "random_perspective":
        return random_perspective(img, rng, 0.3)
    if op == "random_erase":
        return random_erase(img, rng)
    return img
