"""Dense-dictionary OMP sparse deconvolution (heatmap_gemini_v1-2.py).

The reference materializes a [n_samples, Ga*Gd] dense dictionary of
separable Gaussian atoms, column-normalizes it, and runs sklearn
OrthogonalMatchingPursuit with n_nonzero_coefs=N_PATHS (v1-2.py:143-175).
Device formulation: never materialize the dictionary — atom columns are
separable, so

    column_norms^2[g, h] = sum_m rx^2[m, g] * tx^2[m, h]
    correlations[g, h]   = sum_m r[m] * rx[m, g] * tx[m, h]

are each ONE [Ga x M x Gd] two-matmul chain, and the LS refit runs on
the <=K selected columns only.  Matches sklearn to float tolerance
(tests/test_estimators.py) while using O(M*K) memory instead of O(M*Ga*Gd).

Defaults from the reference Config (v1-2.py:18-33): GRID_RES 0.5,
BEAM_WIDTH 1.4, N_PATHS 5, LOS_POWER_MARGIN 0.8.

``engine="device"`` runs :func:`omp_dense_jax`: the same two-matmul
correlation chain under ``lax.scan`` with static n_paths slots, an
|corr| argmax with a no-reselect mask (sklearn never reselects), and the LS
refit solved on the masked Gram of the <=K selected normalized atoms —
selection indices match the host/sklearn path exactly, coefficients to
float32 tolerance (tests/test_device_engines.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from slam_process_tpu.models.dictionary import gaussian_beam
from slam_process_tpu.models.registry import register


class DenseOmpPaths(NamedTuple):
    aoa: np.ndarray
    aod: np.ndarray
    power: np.ndarray       # coefficient in the reference's scale
    valid: np.ndarray


def omp_dense_np(
    meas_aoa: np.ndarray,     # [M] observed AoA per sample
    meas_aod: np.ndarray,     # [M]
    y: np.ndarray,            # [M] RSS values
    aoa_grid: np.ndarray,
    aod_grid: np.ndarray,
    beam_width: float = 1.4,
    n_paths: int = 5,
) -> DenseOmpPaths:
    """Separable OMP == sklearn OMP on the normalized dense dictionary.

    sklearn OMP selects argmax |D^T r|, refits LS on the selected columns,
    and returns coefficients in the *normalized* dictionary scale; the
    reference then keeps coefs > 0 (v1-2.py:178-180).
    """
    rx = gaussian_beam(meas_aoa[:, None], aoa_grid[None, :], beam_width)
    tx = gaussian_beam(meas_aod[:, None], aod_grid[None, :], beam_width)
    # Column norms of the implicit dictionary (for normalization).
    norms = np.sqrt(np.einsum("mg,mh->gh", rx**2, tx**2))
    norms = np.maximum(norms, 1e-300)

    Ga, Gd = len(aoa_grid), len(aod_grid)
    selected: list[tuple[int, int]] = []
    cols: list[np.ndarray] = []
    residual = y.astype(np.float64).copy()
    coefs = np.zeros(0)
    for _ in range(n_paths):
        corr = np.einsum("m,mg,mh->gh", residual, rx, tx) / norms
        corr_flat = np.abs(corr).ravel()
        for g, h in selected:          # sklearn never reselects a column
            corr_flat[g * Gd + h] = -np.inf
        j = int(np.argmax(corr_flat))
        g, h = j // Gd, j % Gd
        selected.append((g, h))
        cols.append(rx[:, g] * tx[:, h] / norms[g, h])
        A = np.stack(cols, axis=1)
        coefs, *_ = np.linalg.lstsq(A, y, rcond=None)
        residual = y - A @ coefs

    aoa = np.array([aoa_grid[g] for g, _ in selected])
    aod = np.array([aod_grid[h] for _, h in selected])
    valid = coefs > 0   # reference keeps positive coefficients only
    return DenseOmpPaths(aoa, aod, coefs, valid)


import functools as _functools


@_functools.lru_cache(maxsize=8)
def _jitted_omp_dense(n_paths: int):
    import functools

    import jax

    from slam_process_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    from slam_process_tpu.utils.precision import jit_highest

    return jit_highest(functools.partial(omp_dense_jax, n_paths=n_paths))


def omp_dense_jax(
    rx,        # jnp [M, Ga] gaussian_beam(meas_aoa, aoa_grid)
    tx,        # jnp [M, Gd]
    y,         # jnp [M]
    aoa_grid,  # jnp [Ga]
    aod_grid,  # jnp [Gd]
    n_paths: int = 5,
):
    """Jittable separable OMP == sklearn OMP selection on the implicit
    normalized dictionary.

    Per scan step: normalized correlations are ONE [Ga, M] x [M, Gd] matmul
    chain (``(rx * residual).T @ tx / norms``), argmax over |corr| with the
    already-selected atoms masked out, then an LS refit on the masked Gram
    of the selected unit-norm columns (zero columns of unselected slots are
    pinned by an identity block, so their coefficients are exactly 0).
    """
    import jax
    import jax.numpy as jnp

    K = n_paths
    M = y.shape[0]
    Gd = tx.shape[1]
    yf = y.astype(jnp.float32)

    norms = jnp.sqrt((rx * rx).T @ (tx * tx))          # [Ga, Gd] column norms
    # f32 underflow guard: an atom whose nearest measurement is >~8 sigma
    # away has norm ~exp(-64) < 1e-15; its squared products underflow to 0
    # in f32 while the numerator's may survive as subnormals, making the
    # normalized ratio explode and garbage corner atoms win the argmax
    # (observed on the real sessions).  Such atoms are numerically
    # unobservable — exclude them from selection.  Host/sklearn (float64)
    # could in principle normalize them honestly; on scenes whose selected
    # atoms are observable (every shipped session) the paths are identical.
    observable = norms > 1e-15
    norms = jnp.maximum(norms, 1e-30)

    def body(carry, _):
        residual, sel_g, sel_h, coeffs, nsel = carry
        corr = ((rx * residual[:, None]).T @ tx) / norms
        acorr = jnp.where(observable, jnp.abs(corr), -jnp.inf)
        # sklearn never reselects a column: mask the chosen atoms out.
        # (.max, not .set: unselected slots all alias index (0,0) and a
        # plain scatter-set could overwrite a real selection with False.)
        taken = jnp.zeros(acorr.shape, bool).at[sel_g, sel_h].max(
            jnp.arange(K) < nsel)
        flat_idx = jnp.argmax(jnp.where(taken, -jnp.inf, acorr))
        g, h = flat_idx // Gd, flat_idx % Gd

        sel_g2 = sel_g.at[nsel].set(g)
        sel_h2 = sel_h.at[nsel].set(h)
        nsel2 = nsel + 1

        active = jnp.arange(K) < nsel2
        # Normalized selected columns [M, K]; zero past nsel2.
        A = (rx[:, sel_g2] * tx[:, sel_h2] / norms[sel_g2, sel_h2][None, :]
             ) * active[None, :]
        G = A.T @ A + jnp.diag(1.0 - active.astype(jnp.float32))
        b = A.T @ yf
        coeffs2 = jnp.linalg.solve(G, b)
        residual2 = yf - A @ coeffs2
        return (residual2, sel_g2, sel_h2, coeffs2, nsel2), None

    init = (yf, jnp.zeros(K, jnp.int32), jnp.zeros(K, jnp.int32),
            jnp.zeros(K, jnp.float32), jnp.int32(0))
    (_, sel_g, sel_h, coeffs, _), _ = jax.lax.scan(body, init, None, length=K)

    return DenseOmpPaths(
        aoa=aoa_grid[sel_g],
        aod=aod_grid[sel_h],
        power=coeffs,
        valid=coeffs > 0,
    )


def run_omp_dense(
    meas_aoa: np.ndarray,
    meas_aod: np.ndarray,
    y: np.ndarray,
    aoa_grid: np.ndarray,
    aod_grid: np.ndarray,
    beam_width: float = 1.4,
    n_paths: int = 5,
    engine: str = "host",
) -> DenseOmpPaths:
    """One entry point for both engines (mirrors models/nn_omp.run_nn_omp)."""
    if engine == "device":
        import jax
        import jax.numpy as jnp

        rx = gaussian_beam(
            jnp.asarray(meas_aoa, jnp.float32)[:, None],
            jnp.asarray(aoa_grid, jnp.float32)[None, :], beam_width)
        tx = gaussian_beam(
            jnp.asarray(meas_aod, jnp.float32)[:, None],
            jnp.asarray(aod_grid, jnp.float32)[None, :], beam_width)
        out = _jitted_omp_dense(n_paths)(
            rx, tx, jnp.asarray(y, jnp.float32),
            jnp.asarray(aoa_grid, jnp.float32),
            jnp.asarray(aod_grid, jnp.float32))
        return jax.device_get(out)   # one batched pytree transfer
    if engine != "host":
        raise ValueError(f"unknown engine {engine!r}")
    return omp_dense_np(meas_aoa, meas_aod, y, aoa_grid, aod_grid,
                        beam_width, n_paths)


@register("omp_dense")
def _run_omp_dense(session, angle_file, output_path=None, **overrides):
    import pandas as pd

    from slam_process_tpu.io.angles import load_angle_lut

    if session.filtered is None:
        session.correct()
    ue, bs, rss = (session.filtered[:, i] for i in range(3))
    df = pd.DataFrame({"RxBeamID": ue, "TxBeamID": bs, "RSS": rss})
    grouped = df.groupby(["RxBeamID", "TxBeamID"])["RSS"].mean().reset_index()
    lut = load_angle_lut(angle_file)
    grouped["AoA"] = lut[grouped["RxBeamID"].astype(int)]
    grouped["AoD"] = lut[grouped["TxBeamID"].astype(int)]
    grouped = grouped.dropna(subset=["AoA", "AoD"])

    grid_res = overrides.get("grid_res", 0.5)
    beam_width = overrides.get("beam_width", 1.4)
    n_paths = overrides.get("max_paths", 5)
    los_margin = overrides.get("los_power_margin", 0.8)
    aoa_grid = np.arange(grouped["AoA"].min(), grouped["AoA"].max(), grid_res)
    aod_grid = np.arange(grouped["AoD"].min(), grouped["AoD"].max(), grid_res)

    paths = run_omp_dense(
        grouped["AoA"].values, grouped["AoD"].values, grouped["RSS"].values,
        aoa_grid, aod_grid, beam_width, n_paths,
        engine=overrides.get("engine", "host"),
    )
    keep = paths.valid
    out = pd.DataFrame({
        "AoA": paths.aoa[keep],
        "AoD": paths.aod[keep],
        "Power": paths.power[keep],
    })
    if not out.empty:
        max_p = out["Power"].max()
        out["Type"] = np.where(out["Power"] >= max_p * los_margin, "LoS", "NLoS")

    if output_path is not None:
        _plot_comparison(grouped, aoa_grid, aod_grid, out, beam_width,
                         output_path)
    return out


def _plot_comparison(grouped, aoa_grid, aod_grid, path_df, beam_width,
                     output_path):
    """Before/after dual panel (v1-2.py:243-307): linear-interp heatmap vs
    sparse impulse map blurred at sigma=1."""
    from pathlib import Path

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from scipy.interpolate import griddata
    from scipy.ndimage import gaussian_filter

    gx, gy = np.meshgrid(aod_grid, aoa_grid)
    grid_z0 = griddata(
        grouped[["AoD", "AoA"]].values, grouped["RSS"].values, (gx, gy),
        method="linear", fill_value=0,
    )

    clean = np.zeros((len(aoa_grid), len(aod_grid)))
    for _, row in path_df.iterrows():
        i = int(np.abs(aoa_grid - row["AoA"]).argmin())
        j = int(np.abs(aod_grid - row["AoD"]).argmin())
        clean[i, j] = row["Power"]
    if path_df.shape[0]:
        clean = gaussian_filter(clean, sigma=1.0)

    fig, axes = plt.subplots(1, 2, figsize=(18, 8))
    ext = [aod_grid.min(), aod_grid.max(), aoa_grid.min(), aoa_grid.max()]
    im1 = axes[0].imshow(grid_z0, extent=ext, origin="lower", aspect="auto",
                         cmap="viridis")
    axes[0].set_title("1. 原始插值热力图 (含旁瓣干扰)", fontsize=14,
                      fontweight="bold")
    axes[0].set_xlabel("AoD (出发角)", fontsize=12)
    axes[0].set_ylabel("AoA (到达角)", fontsize=12)
    fig.colorbar(im1, ax=axes[0], label="RSS (Linear Power)")
    axes[0].grid(alpha=0.3)

    im2 = axes[1].imshow(clean, extent=ext, origin="lower", aspect="auto",
                         cmap="inferno")
    axes[1].set_title(
        f"2. 稀疏重构热力图 (去噪与锐化)\n发现 {len(path_df)} 条显著路径",
        fontsize=14, fontweight="bold",
    )
    axes[1].set_xlabel("AoD (出发角)", fontsize=12)
    axes[1].set_ylabel("AoA (到达角)", fontsize=12)
    fig.colorbar(im2, ax=axes[1], label="RSS (Linear Power)")
    for label, color, marker, s in (("LoS", "red", "o", 200),
                                    ("NLoS", "cyan", "x", 100)):
        sub = path_df[path_df.get("Type", "") == label]
        if not sub.empty:
            axes[1].scatter(sub["AoD"], sub["AoA"], s=s, c=color,
                            marker=marker, linewidth=2, label=label)
    for _, row in path_df.iterrows():
        axes[1].text(row["AoD"] + 2, row["AoA"] + 2,
                     f"{row.get('Type', '?')}\n({row['AoD']:.1f}, "
                     f"{row['AoA']:.1f})",
                     color="white", fontsize=9, fontweight="bold")
    axes[1].legend(loc="upper right")
    axes[1].grid(alpha=0.2)
    fig.tight_layout()
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(output_path, dpi=300, bbox_inches="tight")
    plt.close(fig)
