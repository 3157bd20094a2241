"""SVD rank-1 decomposition estimator (heatmap_gemini_v2.py).

Pipeline (reference :42-144): raw [max_ue+1, max_bs+1] matrix initialized to
the observed min RSS and filled with per-pair means; BS angles from the
map, UE angles a linspace over the BS range; bicubic-spline upsample to a
90x180 grid (== RectBivariateSpline, see ops/interp); SVD of max(grid, 0);
rank chosen at 90% cumulative energy; each rank-1 component's |max| cell
becomes a path; first singular component = LoS, later ones NLoS when within
10x power (:179-184).  The SVD and spline-matmuls run on device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from slam_process_tpu.models.registry import register
from slam_process_tpu.ops.interp import bicubic_spline_resample


class SvdPaths(NamedTuple):
    aoa: np.ndarray
    aod: np.ndarray
    power: np.ndarray
    singular: np.ndarray
    valid: np.ndarray


def build_raw_matrix(ue, bs, rss, angle_lut: np.ndarray):
    """Reference build_heatmap_matrix semantics (v2.py:42-70)."""
    import pandas as pd

    df = pd.DataFrame({"UE_Beam": ue, "BS_Beam": bs, "RSS": rss})
    agg = df.groupby(["UE_Beam", "BS_Beam"], as_index=False)["RSS"].mean()
    max_ue = int(agg["UE_Beam"].max())
    max_bs = int(agg["BS_Beam"].max())
    min_rss = float(agg["RSS"].min())
    raw = np.full((max_ue + 1, max_bs + 1), min_rss)
    raw[agg["UE_Beam"].astype(int), agg["BS_Beam"].astype(int)] = agg["RSS"]
    bs_angles = np.array([
        angle_lut[i] if i < len(angle_lut) and np.isfinite(angle_lut[i]) else 0.0
        for i in range(max_bs + 1)
    ])
    ue_angles = np.linspace(bs_angles.min(), bs_angles.max(), max_ue + 1)
    return raw, ue_angles, bs_angles, min_rss


def svd_upsample(raw, ue_angles, bs_angles, min_rss,
                 n_ue: int = 90, n_bs: int = 180):
    grid_bs = np.linspace(bs_angles.min(), bs_angles.max(), n_bs)
    grid_ue = np.linspace(ue_angles.min(), ue_angles.max(), n_ue)
    su = np.argsort(ue_angles)
    sb = np.argsort(bs_angles)
    heat = bicubic_spline_resample(raw[su][:, sb], bs_angles[sb], ue_angles[su],
                                   grid_bs, grid_ue)
    heat = np.asarray(heat)
    heat[heat < min_rss] = min_rss
    return heat, grid_ue, grid_bs


def svd_paths(heat, grid_ue, grid_bs, energy_thresh: float = 0.90,
              max_rank: int = 16) -> SvdPaths:
    """Rank-1 peak extraction (device-friendly: one SVD + outer products)."""
    h = np.maximum(np.asarray(heat), 0.0)
    U, S, Vt = np.linalg.svd(h, full_matrices=False)
    cum = np.cumsum(S**2) / np.sum(S**2)
    rank = int(np.searchsorted(cum, energy_thresh)) + 1
    rank = min(rank, max_rank, len(S))
    aoa = np.zeros(max_rank)
    aod = np.zeros(max_rank)
    power = np.zeros(max_rank)
    for k in range(rank):
        comp = S[k] * np.outer(U[:, k], Vt[k])
        i, j = np.unravel_index(np.argmax(np.abs(comp)), comp.shape)
        aoa[k], aod[k] = grid_ue[i], grid_bs[j]
        power[k] = abs(comp[i, j])
    valid = np.arange(max_rank) < rank
    return SvdPaths(aoa, aod, power, S[:max_rank] if len(S) >= max_rank
                    else np.pad(S, (0, max_rank - len(S))), valid)


def svd_paths_jax(heat, grid_ue, grid_bs, energy_thresh: float = 0.90,
                  max_rank: int = 16) -> SvdPaths:
    """Jittable rank-1 peak extraction (jnp.linalg.svd + vmapped argmax).

    Device counterpart of ``svd_paths``: the SVD, the per-component outer
    products, and the |max|-cell searches all run on device; invalid slots
    (k >= rank) are zeroed exactly like the host oracle.
    """
    import jax
    import jax.numpy as jnp

    h = jnp.maximum(heat, 0.0)
    U, S, Vt = jnp.linalg.svd(h, full_matrices=False)
    cum = jnp.cumsum(S**2) / jnp.sum(S**2)
    rank = jnp.searchsorted(cum, energy_thresh) + 1
    rank = jnp.minimum(jnp.minimum(rank, max_rank), S.shape[0])
    n_cols = h.shape[1]

    def comp(k):
        c = S[k] * jnp.outer(U[:, k], Vt[k])
        flat = jnp.argmax(jnp.abs(c))
        i, j = flat // n_cols, flat % n_cols
        return grid_ue[i], grid_bs[j], jnp.abs(c[i, j])

    ks = jnp.arange(max_rank)
    aoa, aod, power = jax.vmap(comp)(ks)
    valid = ks < rank
    z = valid.astype(heat.dtype)
    sing = S[:max_rank] if S.shape[0] >= max_rank else jnp.pad(
        S, (0, max_rank - S.shape[0]))
    return SvdPaths(aoa * z, aod * z, power * z, sing, valid)


@register("svd")
def _run_svd(session, angle_file, output_path=None, **overrides):
    import pandas as pd

    from slam_process_tpu.io.angles import load_angle_lut

    if session.filtered is None:
        session.correct()
    ue, bs, rss = (session.filtered[:, i] for i in range(3))
    lut = load_angle_lut(angle_file)
    raw, ue_ang, bs_ang, min_rss = build_raw_matrix(ue, bs, rss, lut)
    if overrides.get("engine") == "device":
        import functools

        import jax
        import jax.numpy as jnp

        heat, grid_ue, grid_bs = svd_upsample(raw, ue_ang, bs_ang, min_rss)
        from slam_process_tpu.utils.cache import enable_persistent_cache
        enable_persistent_cache()
        from slam_process_tpu.utils.precision import jit_highest

        fn = jit_highest(functools.partial(
            svd_paths_jax,
            energy_thresh=overrides.get("energy_thresh", 0.90)))
        out = fn(jnp.asarray(heat, jnp.float32),
                 jnp.asarray(grid_ue, jnp.float32),
                 jnp.asarray(grid_bs, jnp.float32))
        # One batched pytree transfer.
        paths = jax.device_get(out)
    else:
        heat, grid_ue, grid_bs = svd_upsample(raw, ue_ang, bs_ang, min_rss)
        paths = svd_paths(heat, grid_ue, grid_bs,
                          overrides.get("energy_thresh", 0.90))

    if output_path is not None:
        _plot_svd(heat, grid_ue, grid_bs, paths, output_path)
    keep = paths.valid
    order = np.argsort(-paths.singular[keep], kind="stable")
    types = ["LoS"] + [
        "NLoS" if paths.power[keep][order][i] > 0.1 * paths.power[keep][order][0]
        else "weak"
        for i in range(1, keep.sum())
    ]
    return pd.DataFrame({
        "id": np.arange(keep.sum()),
        "AoA": paths.aoa[keep][order],
        "AoD": paths.aod[keep][order],
        "Power": paths.power[keep][order],
        "SingularValue": paths.singular[keep][order],
        "Type": types,
    })


def _plot_svd(heat, grid_ue, grid_bs, paths: SvdPaths, output_path):
    """classify_and_plot (v2.py:150-201): imshow dB + LoS star + NLoS x."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(12, 9))
    heat_db = 10 * np.log10(np.maximum(heat, 0) + 1e-9)
    extent = [grid_bs.min(), grid_bs.max(), grid_ue.min(), grid_ue.max()]
    plt.imshow(heat_db, aspect="auto", origin="lower", extent=extent,
               cmap="viridis")
    plt.colorbar(label="RSS (dB)")
    keep = np.nonzero(paths.valid)[0]
    if keep.size:
        order = keep[np.argsort(-paths.singular[keep], kind="stable")]
        los = order[0]
        plt.scatter(paths.aod[los], paths.aoa[los], c="white", marker="*",
                    s=300, label=f"LoS (AoD:{paths.aod[los]:.1f}, "
                                 f"AoA:{paths.aoa[los]:.1f})")
        for k in order[1:]:
            if paths.power[k] > paths.power[los] * 0.1:
                plt.scatter(paths.aod[k], paths.aoa[k], c="red", marker="x",
                            s=150, label=f"NLoS (Rank-{k})")
    plt.xlabel("Base Station AoD (Degree)")
    plt.ylabel("User Equipment AoA (Degree)")
    plt.title("AoA-AoD RSS Heatmap & Identified Multipath Components")
    plt.legend()
    plt.grid(True, alpha=0.3)
    from pathlib import Path

    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    plt.savefig(output_path, dpi=300, bbox_inches="tight")
    plt.close(fig)
    return output_path
