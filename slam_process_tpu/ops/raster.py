"""Heatmap rasterization: blur -> normalize -> colormap, on device.

Replaces the render stage of ``excel_heatmap*.py``:

  * NaN-aware Gaussian blur (excel_heatmap.py:306-354): odd kernel of size
    max(3, ceil(6 sigma)), replicate ("edge") padding, per-pixel mask
    normalization ``sum(data*k*mask)/sum(k*mask)``; the reference runs an
    O(H*W*kh*kw) pure-Python loop, here it is two masked conv passes.
  * Shifted log color normalization (excel_heatmap.py:394-404): RSSI can be
    <= 0, so value' = value - min + 1e-6 and LogNorm over the shifted range.
  * Colormap LUT application with matplotlib index semantics
    (idx = clip(int(x * N), 0, N-1)); NaN cells -> fully transparent
    (cmap.set_bad((1,1,1,0)), excel_heatmap.py:431-433).

The whole pipeline is jittable and vmappable.
"""

from __future__ import annotations

import functools
import math
from pathlib import Path
from typing import Optional, Tuple

import numpy as np


@functools.lru_cache(maxsize=None)
def colormap_lut(name: str = "viridis", n: int = 256) -> np.ndarray:
    """[n, 4] float32 RGBA lookup table for a matplotlib colormap name.

    The device path's table (viridis, 256 entries) is committed in
    ``assets/viridis256.txt`` (``matplotlib.colormaps["viridis"]`` sampled
    at ``linspace(0, 1, 256)``), so rasterizing needs no matplotlib; other
    maps come from matplotlib itself.
    """
    if name == "viridis" and n == 256:
        path = Path(__file__).resolve().parents[1] / "assets" / "viridis256.txt"
        return np.loadtxt(path, dtype=np.float64).astype(np.float32)
    import matplotlib

    cmap = matplotlib.colormaps[name]
    return cmap(np.linspace(0.0, 1.0, n)).astype(np.float32)


def gaussian_kernel_np(sigma: float) -> np.ndarray:
    """2-D Gaussian kernel, size max(3, ceil(6 sigma)) forced odd, sum 1.

    Bit-for-bit the reference's construction (excel_heatmap.py:306-319).
    """
    if sigma <= 0:
        return np.array([[1.0]], dtype=np.float64)
    size = int(max(3, math.ceil(6 * sigma)))
    if size % 2 == 0:
        size += 1
    c = size // 2
    y, x = np.ogrid[-c : c + 1, -c : c + 1]
    k = np.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float64)


def blur_nan_aware_np(data: np.ndarray, sigma: float) -> np.ndarray:
    """Vectorized NaN-aware Gaussian blur (float64 oracle).

    Matches gaussian_blur_nan_aware (excel_heatmap.py:322-354): edge padding,
    weights masked by finiteness, output NaN where total weight ~ 0.
    """
    if sigma <= 0:
        return data
    k = gaussian_kernel_np(sigma)
    kh, kw = k.shape
    ph, pw = kh // 2, kw // 2
    mask = np.isfinite(data).astype(np.float64)
    filled = np.nan_to_num(data, nan=0.0)
    pd_ = np.pad(filled, ((ph, ph), (pw, pw)), mode="edge")
    pm = np.pad(mask, ((ph, ph), (pw, pw)), mode="edge")
    h, w = data.shape
    num = np.zeros((h, w))
    den = np.zeros((h, w))
    for dy in range(kh):
        for dx in range(kw):
            wgt = k[dy, dx]
            num += wgt * pd_[dy : dy + h, dx : dx + w] * pm[dy : dy + h, dx : dx + w]
            den += wgt * pm[dy : dy + h, dx : dx + w]
    with np.errstate(invalid="ignore"):
        out = np.where(den > 1e-12, num / np.maximum(den, 1e-300), np.nan)
    return out


@functools.lru_cache(maxsize=16)
def _blur_operator_np(n: int, sigma: float) -> np.ndarray:
    """Dense [n, n] row-blur operator: 1-D Gaussian taps with edge
    replication folded into the boundary columns.

    The reference's 2-D kernel (gaussian_kernel_np) is separable — the
    outer product of its (normalized) marginals — so the NaN-aware blur's
    two 2-D convs become ``K @ X @ K.T`` matmul chains (two tiny matmuls
    instead of conv ops at the 64x64 shape)."""
    k2 = gaussian_kernel_np(sigma)
    g = k2.sum(axis=0)                       # 1-D factor, sums to 1
    p = len(g) // 2
    op = np.zeros((n, n))
    rows = np.arange(n)
    for t in range(-p, p + 1):
        np.add.at(op, (rows, np.clip(rows + t, 0, n - 1)), g[t + p])
    return op


def blur_nan_aware_jax(data, sigma: float):
    """Jittable NaN-aware blur (separable operator matmuls over masked
    data; equals the 2-D conv formulation up to f32 accumulation order)."""
    import jax.numpy as jnp
    from jax import lax

    if sigma <= 0:
        return data
    op = jnp.asarray(_blur_operator_np(data.shape[-2], float(sigma)),
                     dtype=jnp.float32)
    op_t = (op.T if data.shape[-1] == data.shape[-2] else
            jnp.asarray(_blur_operator_np(data.shape[-1], float(sigma)),
                        dtype=jnp.float32).T)
    mask = jnp.isfinite(data).astype(jnp.float32)
    filled = jnp.nan_to_num(data, nan=0.0)

    def blur(x):
        # precision=HIGHEST: a default-precision matmul may run in bf16 or
        # TF32, and raw RSS spans 18 bits — the ~1e-3 relative error
        # explodes through the shifted-log norm for cells near the global
        # min (a cell 880 units above mn moved by a full 0.076 in t under
        # bf16; f32 matches the f64 oracle).
        return jnp.matmul(
            op, jnp.matmul(x, op_t, precision=lax.Precision.HIGHEST),
            precision=lax.Precision.HIGHEST)

    num = blur(filled * mask)
    den = blur(mask)
    return jnp.where(den > 1e-12, num / jnp.maximum(den, 1e-30), jnp.nan)


def shifted_log_norm(values, vmin: Optional[float] = None, vmax: Optional[float] = None):
    """Shifted LogNorm -> [0, 1] normalized values (NaN preserved).

    value' = value - nanmin + 1e-6; norm = (ln v' - ln v'min)/(ln v'max - ln
    v'min) clipped to [0, 1] (excel_heatmap.py:394-404 + matplotlib LogNorm).
    Explicit vmin/vmax are in the *unshifted* domain, like the reference CLI.
    """
    import jax.numpy as jnp

    xp = jnp if not isinstance(values, np.ndarray) else np
    finite = xp.isfinite(values)
    big = xp.where(finite, values, xp.inf)
    small = xp.where(finite, values, -xp.inf)
    data_min = xp.min(big)
    shifted = values - data_min + 1e-6
    lo = (vmin - data_min + 1e-6) if vmin is not None else 1e-6
    hi = (vmax - data_min + 1e-6) if vmax is not None else (xp.max(small) - data_min + 1e-6)
    lo = xp.maximum(lo, 1e-30)
    log_lo = xp.log(lo)
    log_hi = xp.log(hi)
    denom = xp.maximum(log_hi - log_lo, 1e-30)
    t = (xp.log(xp.maximum(shifted, 1e-30)) - log_lo) / denom
    t = xp.clip(t, 0.0, 1.0)
    return xp.where(finite, t, xp.nan)


def linear_norm(values, vmin: Optional[float] = None, vmax: Optional[float] = None):
    import jax.numpy as jnp

    xp = jnp if not isinstance(values, np.ndarray) else np
    finite = xp.isfinite(values)
    lo = vmin if vmin is not None else xp.min(xp.where(finite, values, xp.inf))
    hi = vmax if vmax is not None else xp.max(xp.where(finite, values, -xp.inf))
    t = (values - lo) / xp.maximum(hi - lo, 1e-30)
    t = xp.clip(t, 0.0, 1.0)
    return xp.where(finite, t, xp.nan)


def apply_colormap_float(norm_values, lut):
    """[0,1] (or NaN) values -> float RGBA with matplotlib index semantics.

    This float raster is the 1e-3 parity surface vs the reference's
    cmap(norm(data)) cell colors; NaN cells are fully transparent
    (premultiplied (0,0,0,0), matching cmap.set_bad((1,1,1,0)) composited).
    """
    import jax.numpy as jnp

    xp = jnp if not isinstance(norm_values, np.ndarray) else np
    n = lut.shape[0]
    finite = xp.isfinite(norm_values)
    x = xp.where(finite, norm_values, 0.0)
    idx = xp.clip((x * n).astype(xp.int32), 0, n - 1)
    rgba = lut[idx]
    return xp.where(finite[..., None], rgba, 0.0)


def to_u8(rgba_float):
    """Float RGBA -> u8 for PNG encoding (round-half-up)."""
    import jax.numpy as jnp

    xp = jnp if not isinstance(rgba_float, np.ndarray) else np
    return (rgba_float * 255.0 + 0.5).astype(xp.uint8)


def apply_colormap(norm_values, lut) -> "np.ndarray":
    """[0,1] (or NaN) values -> RGBA u8 (see apply_colormap_float)."""
    return to_u8(apply_colormap_float(norm_values, lut))


def rasterize(
    matrix,
    blur_sigma: float = 0.0,
    use_log: bool = True,
    vmin: Optional[float] = None,
    vmax: Optional[float] = None,
    lut=None,
    as_u8: bool = True,
) -> Tuple:
    """Full data-raster pipeline: blur -> norm -> colormap.

    Returns (rgba[H, W, 4] u8 (or float with as_u8=False), blurred_matrix).
    The float raster is the parity surface against the reference's
    pcolormesh cell colors (figure chrome is added by render/figures.py
    around this raster); u8 is the PNG-encoding form.
    """
    if lut is None:
        lut = colormap_lut("viridis")
    import jax.numpy as jnp

    is_np = isinstance(matrix, np.ndarray)
    blurred = blur_nan_aware_np(matrix, blur_sigma) if is_np else blur_nan_aware_jax(matrix, blur_sigma)
    if use_log:
        t = shifted_log_norm(blurred, vmin, vmax)
    else:
        t = linear_norm(blurred, vmin, vmax)
    lut_arr = lut if is_np else jnp.asarray(lut)
    rgba = apply_colormap_float(t, lut_arr)
    if as_u8:
        rgba = to_u8(rgba)
    return rgba, blurred
