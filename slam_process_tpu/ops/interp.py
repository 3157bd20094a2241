"""Interpolation kernels: RBF, separable bicubic spline, grid resampling.

Device replacements for the reference's scipy interpolation calls:

  * ``scipy.interpolate.Rbf(..., function='linear', smooth=s)``
    (heatmap_gemini_v1.py:250, v1-7.py:558, v3.py:231): kernel matrix
    A_ij = |x_i - x_j| with A -= s*I, nodes = solve(A, values), evaluation
    phi(dist(query, centers)) @ nodes.  At the reference's N = 4096 centers
    and 100x100 query grid this is one [N, N] solve + one [Q, N] matmul —
    both matmul work.  ``kernel='thin_plate'`` (phi = r^2 log r, phi(0)=0)
    covers heatmap_gemini_v1-3.py:441's ``function='thin_plate'``.
  * ``RectBivariateSpline`` upsampling (heatmap_gemini_v2.py:81-85):
    separable not-a-knot cubic-spline interpolation on the rectilinear
    angle grid (equivalence tested numerically in tests/test_interp.py).
"""

from __future__ import annotations

import numpy as np


def _rbf_phi(xp, r, kernel: str):
    if kernel == "linear":
        return r
    if kernel == "thin_plate":
        # scipy uses xlogy(r^2, r): exactly 0 at r = 0.
        return xp.where(r > 0, (r * r) * xp.log(xp.where(r > 0, r, 1.0)), 0.0)
    raise ValueError(f"unknown RBF kernel {kernel!r}")


def rbf_linear_fit(points: "np.ndarray", values, smooth: float = 0.0,
                   kernel: str = "linear"):
    """Fit scipy-Rbf-equivalent kernel weights.

    points: [N, D] node coordinates; values: [N].  Returns nodes [N].
    """
    import jax.numpy as jnp

    xp = jnp if not isinstance(points, np.ndarray) else np
    d = points[:, None, :] - points[None, :, :]
    r = xp.sqrt(xp.sum(d * d, axis=-1) + 1e-38)
    n = points.shape[0]
    A = _rbf_phi(xp, r, kernel) - xp.eye(n, dtype=r.dtype) * smooth
    return xp.linalg.solve(A, values)


def rbf_linear_eval(points, nodes, queries, kernel: str = "linear"):
    """Evaluate the fitted RBF at query coordinates [Q, D] -> [Q]."""
    import jax.numpy as jnp

    xp = jnp if not isinstance(points, np.ndarray) else np
    d = queries[:, None, :] - points[None, :, :]
    r = xp.sqrt(xp.sum(d * d, axis=-1) + 1e-38)
    return _rbf_phi(xp, r, kernel) @ nodes


def rbf_interpolate_grid(
    x_centers, y_centers, values_2d, grid_x, grid_y, smooth: float = 0.0,
    kernel: str = "linear",
):
    """The reference's renderer pattern: RBF over a (bs, ue) angle mesh.

    x_centers: [B] (AoD/BS angles), y_centers: [U] (AoA/UE angles),
    values_2d: [U, B] (UE-major, as rss_matrix), grid_x/grid_y: 1-D target
    axes.  Returns [len(grid_y), len(grid_x)] like Rbf(grid meshes).
    Matches Rbf(bs_mesh.flatten(), ue_mesh.flatten(), rss.flatten()).
    """
    import jax.numpy as jnp

    xp = jnp if not isinstance(values_2d, np.ndarray) else np
    bs_mesh, ue_mesh = xp.meshgrid(xp.asarray(x_centers), xp.asarray(y_centers))
    pts = xp.stack([bs_mesh.ravel(), ue_mesh.ravel()], axis=1)
    nodes = rbf_linear_fit(pts, xp.ravel(values_2d), smooth, kernel)
    gx, gy = xp.meshgrid(xp.asarray(grid_x), xp.asarray(grid_y))
    q = xp.stack([gx.ravel(), gy.ravel()], axis=1)
    out = rbf_linear_eval(pts, nodes, q, kernel)
    return out.reshape(len(grid_y), len(grid_x))


# ---------------------------------------------------------------------------
# Separable not-a-knot cubic spline (RectBivariateSpline s=0 equivalent)
# ---------------------------------------------------------------------------


def _spline_coth_matrix(x: np.ndarray):
    """Build the not-a-knot cubic-spline second-derivative system (host)."""
    n = len(x)
    h = np.diff(x)
    A = np.zeros((n, n))
    rhs_w = np.zeros((n, n))  # rhs = rhs_w @ y
    for i in range(1, n - 1):
        A[i, i - 1] = h[i - 1]
        A[i, i] = 2 * (h[i - 1] + h[i])
        A[i, i + 1] = h[i]
        rhs_w[i, i - 1] = 6 / h[i - 1]
        rhs_w[i, i] = -6 / h[i - 1] - 6 / h[i]
        rhs_w[i, i + 1] = 6 / h[i]
    # not-a-knot: third derivative continuous at x1 and x_{n-2}
    A[0, 0] = h[1]
    A[0, 1] = -(h[0] + h[1])
    A[0, 2] = h[0]
    A[-1, -3] = h[-1]
    A[-1, -2] = -(h[-2] + h[-1])
    A[-1, -1] = h[-2]
    return A, rhs_w


def cubic_spline_interp_matrix(x: np.ndarray, xq: np.ndarray) -> np.ndarray:
    """Dense [Q, N] matrix mapping samples y -> spline values at xq (host).

    Precomputed once per axis on host; evaluation on device is then a single
    matmul, so 2-D separable interpolation is ``Wy @ values @ Wx^T``.
    """
    x = np.asarray(x, dtype=np.float64)
    xq = np.asarray(xq, dtype=np.float64)
    n = len(x)
    if n < 4:
        raise ValueError("need >= 4 points for not-a-knot cubic spline")
    A, rhs_w = _spline_coth_matrix(x)
    M = np.linalg.solve(A, rhs_w)  # second derivatives = M @ y
    h = np.diff(x)
    idx = np.clip(np.searchsorted(x, xq, side="right") - 1, 0, n - 2)
    W = np.zeros((len(xq), n))
    for q, (j, xv) in enumerate(zip(idx, xq)):
        hj = h[j]
        a = (x[j + 1] - xv) / hj
        b = (xv - x[j]) / hj
        # s(x) = a*y_j + b*y_{j+1} + ((a^3-a) m_j + (b^3-b) m_{j+1}) h^2/6
        W[q, j] += a
        W[q, j + 1] += b
        W[q] += ((a**3 - a) * M[j] + (b**3 - b) * M[j + 1]) * hj * hj / 6.0
    return W


def bicubic_spline_resample(values_2d, x, y, xq, yq):
    """Separable cubic-spline resample of values[y, x] onto (yq, xq)."""
    import jax.numpy as jnp

    Wy = cubic_spline_interp_matrix(np.asarray(y), np.asarray(yq))
    Wx = cubic_spline_interp_matrix(np.asarray(x), np.asarray(xq))
    xp = jnp if not isinstance(values_2d, np.ndarray) else np
    Wy = xp.asarray(Wy, dtype=values_2d.dtype)
    Wx = xp.asarray(Wx, dtype=values_2d.dtype)
    return Wy @ values_2d @ Wx.T


def bilinear_resample(values_2d, x, y, xq, yq):
    """Bilinear resample (device-friendly; the plain-renderer fast path)."""
    import jax.numpy as jnp

    xp = jnp if not isinstance(values_2d, np.ndarray) else np
    x = xp.asarray(x)
    y = xp.asarray(y)
    xq = xp.asarray(xq)
    yq = xp.asarray(yq)
    jx = xp.clip(xp.searchsorted(x, xq, side="right") - 1, 0, len(x) - 2)
    jy = xp.clip(xp.searchsorted(y, yq, side="right") - 1, 0, len(y) - 2)
    tx = (xq - x[jx]) / (x[jx + 1] - x[jx])
    ty = (yq - y[jy]) / (y[jy + 1] - y[jy])
    tx = xp.clip(tx, 0.0, 1.0)
    ty = xp.clip(ty, 0.0, 1.0)
    v00 = values_2d[jy[:, None], jx[None, :]]
    v01 = values_2d[jy[:, None], jx[None, :] + 1]
    v10 = values_2d[jy[:, None] + 1, jx[None, :]]
    v11 = values_2d[jy[:, None] + 1, jx[None, :] + 1]
    return (
        v00 * (1 - ty[:, None]) * (1 - tx[None, :])
        + v01 * (1 - ty[:, None]) * tx[None, :]
        + v10 * ty[:, None] * (1 - tx[None, :])
        + v11 * ty[:, None] * tx[None, :]
    )
