"""Scene assembly: frames -> per-sweep/ per-session mean-RSS intensity grids.

Replaces the reference's pandas pivot paths:

  * ``BeamDataProcessor.pivot_data`` (heatmap_gemini_v1-7.py:108-160):
    optional ln pre-transform (drop RSS<=0, RSS := ln RSS, *before* the
    mean), groupby(UE,BS).mean, pivot over *observed* beam ids, fillna with
    the global min of the aggregated means;
  * ``compute_rssi_matrix`` (excel_heatmap.py:272-300): pivot_table(mean)
    keyed by mapped angles, NaN kept for empty cells;
  * excel_heatmap_v2 keeps only FLAG==1 rows first (v2.py:165-166).

Device formulation: a (UE, BS) cell mean is a segment mean over frames,
written as two one-hot contractions

    sums[u, b]   = sum_f onehotUE[f, u] * rss[f] * onehotBS[f, b]
    counts[u, b] = sum_f onehotUE[f, u] * onehotBS[f, b]

i.e. ``(onehotUE * rss).T @ onehotBS`` and ``onehotUE.T @ onehotBS`` at
[F, 64] x [F, 64] instead of a scatter-add.  (The two have not been
measured against each other on the H100 — ROADMAP A7.)  The
full 64x64 grid is kept with occupancy masks so shapes stay static;
observed-submatrix extraction for the estimators happens on host (or via
masks downstream).

Note the beam->angle map is strictly increasing (beam_angle.xlsx), so the
reference's angle-keyed pivot orders rows/cols identically to id-keyed
pivoting; tests assert monotonicity and pandas-oracle equality.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from slam_process_tpu.config import SceneConfig

_DEFAULT = SceneConfig()

class IntensityGrid(NamedTuple):
    """Dense [n_beams, n_beams] intensity statistics, UE-major.

    ``mean`` is sums/counts with empty cells NaN (fill policy applied by
    ``fill_grid``).  ``row_mask``/``col_mask`` flag observed UE/BS ids.
    """

    mean: np.ndarray       # [U, B] f32/f64, NaN where count == 0
    counts: np.ndarray     # [U, B] i32
    row_mask: np.ndarray   # [U] bool — UE id observed
    col_mask: np.ndarray   # [B] bool — BS id observed
    fill_value: np.ndarray  # scalar: global min of observed cell means


# ---------------------------------------------------------------------------
# numpy host path (float64 oracle)
# ---------------------------------------------------------------------------


def intensity_grid_np(
    ue: np.ndarray,
    bs: np.ndarray,
    rss: np.ndarray,
    flag: Optional[np.ndarray] = None,
    cfg: SceneConfig = _DEFAULT,
) -> IntensityGrid:
    ue = np.asarray(ue, dtype=np.int64)
    bs = np.asarray(bs, dtype=np.int64)
    val = np.asarray(rss, dtype=np.float64)

    keep = (ue >= 0) & (ue < cfg.n_beams) & (bs >= 0) & (bs < cfg.n_beams)
    if cfg.flag_filter is not None and flag is not None:
        keep &= np.asarray(flag) == cfg.flag_filter
    if cfg.log_transform:
        keep &= val > 0
        val = np.where(keep, np.log(np.maximum(val, 1e-300)), 0.0)

    u, b, v = ue[keep], bs[keep], val[keep]
    sums = np.zeros((cfg.n_beams, cfg.n_beams), dtype=np.float64)
    counts = np.zeros((cfg.n_beams, cfg.n_beams), dtype=np.int64)
    np.add.at(sums, (u, b), v)
    np.add.at(counts, (u, b), 1)
    return grid_from_sums_np(sums, counts)


def grid_from_sums_np(sums: np.ndarray, counts: np.ndarray) -> IntensityGrid:
    """Finalize (sums, counts) accumulators into an IntensityGrid (host).

    Shared by the batch path above and the streaming accumulators so the
    NaN-empty-mean / observed-min-fill rule exists exactly once.
    """
    with np.errstate(invalid="ignore"):
        mean = np.where(counts > 0, sums / np.maximum(counts, 1), np.nan)
    row_mask = counts.sum(axis=1) > 0
    col_mask = counts.sum(axis=0) > 0
    observed = counts > 0
    fill = mean[observed].min() if observed.any() else np.nan
    return IntensityGrid(mean, counts.astype(np.int32), row_mask, col_mask,
                         np.float64(fill))


# ---------------------------------------------------------------------------
# JAX device path
# ---------------------------------------------------------------------------


def intensity_sums_jax(
    ue,                       # jnp [F] int32 (padded)
    bs,                       # jnp [F] int32
    rss,                      # jnp [F] f32 (raw RSS values)
    valid,                    # jnp [F] bool: real (non-padding) rows
    flag=None,                # jnp [F] int32, for flag_filter configs
    cfg: SceneConfig = _DEFAULT,
):
    """Jittable (sums, counts) accumulators via one-hot contractions.

    The streaming path folds these per-chunk partials into running device
    accumulators; the batch path finalizes them into a mean grid directly.
    Returns (sums [U, B] f32, counts [U, B] f32).
    """
    import jax.numpy as jnp

    keep = valid & (ue >= 0) & (ue < cfg.n_beams) & (bs >= 0) & (bs < cfg.n_beams)
    if cfg.flag_filter is not None and flag is not None:
        keep = keep & (flag == cfg.flag_filter)
    val = rss.astype(jnp.float32)
    if cfg.log_transform:
        keep = keep & (val > 0)
        val = jnp.log(jnp.maximum(val, 1e-30))

    kf = keep.astype(jnp.float32)
    onehot_ue = (ue[:, None] == jnp.arange(cfg.n_beams)[None, :]).astype(jnp.float32)
    onehot_bs = (bs[:, None] == jnp.arange(cfg.n_beams)[None, :]).astype(jnp.float32)
    onehot_ue = onehot_ue * kf[:, None]

    # precision=HIGHEST: raw RSS spans 18 bits; a reduced-precision pass
    # (bf16 or TF32) would drop mantissa bits in the weighted sum.  Counts
    # are exact in any precision (0/1 products, f32 accumulation).
    sums = jnp.einsum(
        "fu,f,fb->ub",
        onehot_ue,
        val,
        onehot_bs,
        preferred_element_type=jnp.float32,
        precision="highest",
    )
    counts = jnp.einsum(
        "fu,fb->ub", onehot_ue, onehot_bs, preferred_element_type=jnp.float32
    )
    return sums, counts


def intensity_grid_jax(
    ue,                       # jnp [F] int32 (padded)
    bs,                       # jnp [F] int32
    rss,                      # jnp [F] f32 (raw RSS values)
    valid,                    # jnp [F] bool: real (non-padding) rows
    flag=None,                # jnp [F] int32, for flag_filter configs
    cfg: SceneConfig = _DEFAULT,
):
    """Jittable intensity assembly via one-hot contractions.

    Returns an IntensityGrid of jnp arrays (mean has NaN in empty cells).
    """
    import jax.numpy as jnp

    sums, counts = intensity_sums_jax(ue, bs, rss, valid, flag, cfg)
    mean = jnp.where(counts > 0, sums / jnp.maximum(counts, 1.0), jnp.nan)
    row_mask = counts.sum(axis=1) > 0
    col_mask = counts.sum(axis=0) > 0
    observed = counts > 0
    fill = jnp.min(jnp.where(observed, mean, jnp.inf))
    return IntensityGrid(mean, counts.astype(jnp.int32), row_mask, col_mask, fill)


def intensity_per_sweep_sums_jax(
    ue,                       # jnp [F] int32 (padded)
    bs,                       # jnp [F] int32
    rss,                      # jnp [F] f32
    gid,                      # jnp [F] int32 sweep ids (0..max_sweeps-1)
    valid,                    # jnp [F] bool
    max_sweeps: int,
    cfg: SceneConfig = _DEFAULT,
):
    """Per-sweep (sums, counts) accumulators [S, U, B] (both f32).

    The raw-accumulator form of :func:`intensity_per_sweep_jax`; the
    streaming path needs sums so a sweep spanning chunk boundaries can
    fold its partials before the mean is taken.  Integer RSS sums are
    exact while they stay below 2^24 (HIGHEST precision, f32 accumulate).
    """
    import jax
    import jax.numpy as jnp

    keep = valid & (ue >= 0) & (ue < cfg.n_beams) & (bs >= 0) & (bs < cfg.n_beams)
    val = rss.astype(jnp.float32)
    if cfg.log_transform:
        keep = keep & (val > 0)
        val = jnp.log(jnp.maximum(val, 1e-30))

    kf = keep.astype(jnp.float32)
    oh_u = (ue[:, None] == jnp.arange(cfg.n_beams)[None, :]).astype(jnp.float32)
    oh_b = (bs[:, None] == jnp.arange(cfg.n_beams)[None, :]).astype(jnp.float32)

    # Scan over sweeps: per sweep the cell stats are the session einsum with
    # a sweep-membership weight folded into the UE one-hot.  Peak memory
    # stays at [F, n_beams] instead of [F, S * n_beams].  Sums and counts
    # come from ONE einsum (the value operand stacks [val, 1]): the scan
    # body is bandwidth-bound on the [F, n_beams] one-hots, and two
    # separate contractions read them twice.
    vx = jnp.stack([val, jnp.ones_like(val)], axis=1)   # [F, 2]

    def one_sweep(_, s):
        w = (gid == s).astype(jnp.float32) * kf
        ohu = oh_u * w[:, None]
        sc = jnp.einsum("fu,fx,fb->xub", ohu, vx, oh_b,
                        preferred_element_type=jnp.float32,
                        precision="highest")
        return None, (sc[0], sc[1])

    _, (sums, counts) = jax.lax.scan(one_sweep, None,
                                     jnp.arange(max_sweeps, dtype=gid.dtype))
    return sums, counts


def intensity_per_sweep_jax(
    ue,                       # jnp [F] int32 (padded)
    bs,                       # jnp [F] int32
    rss,                      # jnp [F] f32
    gid,                      # jnp [F] int32 sweep ids (0..max_sweeps-1)
    valid,                    # jnp [F] bool
    max_sweeps: int,
    cfg: SceneConfig = _DEFAULT,
):
    """Per-sweep intensity tensor [S, U, B] via one 3-way one-hot contraction.

    The SURVEY design keeps the session as ``intensity[S, 64, 64]`` so
    renders/estimators can ``vmap`` across sweeps; this assembles it with a
    single einsum over (frame -> sweep) x (frame -> ue) x (frame -> bs)
    one-hots, [F, S]x[F, U]x[F, B].
    Returns (mean [S, U, B] with NaN empties, counts [S, U, B] i32).
    """
    import jax.numpy as jnp

    sums, counts = intensity_per_sweep_sums_jax(
        ue, bs, rss, gid, valid, max_sweeps, cfg)
    mean = jnp.where(counts > 0, sums / jnp.maximum(counts, 1.0), jnp.nan)
    return mean, counts.astype(jnp.int32)


def fill_grid(grid: IntensityGrid, cfg: SceneConfig = _DEFAULT):
    """Apply the fill policy: empty observed-row/col cells -> global min.

    Mirrors pivot.fillna(min) (heatmap_gemini_v1-7.py:132-133): only cells
    inside the observed row x col submatrix exist in the reference pivot;
    unobserved rows/cols stay NaN here and are dropped by ``compact_grid``.
    """
    import jax.numpy as jnp

    xp = jnp if not isinstance(grid.mean, np.ndarray) else np
    if not cfg.fill_with_min or cfg.keep_nan:
        return grid.mean
    inside = grid.row_mask[:, None] & grid.col_mask[None, :]
    empty = xp.isnan(grid.mean)
    return xp.where(inside & empty, grid.fill_value, grid.mean)


def compact_grid(grid: IntensityGrid, filled, angle_lut: np.ndarray):
    """Host-side: extract the observed+mapped submatrix and angle vectors.

    This reproduces the reference's pivot exactly: rows = sorted observed UE
    ids with a finite angle, cols = sorted observed BS ids likewise
    (heatmap_gemini_v1-7.py:139-154 drops unmapped ids after pivoting).
    Returns (matrix[U', B'], ue_angles, bs_angles, ue_ids, bs_ids).
    """
    filled = np.asarray(filled)
    row_mask = np.asarray(grid.row_mask) & np.isfinite(angle_lut)
    col_mask = np.asarray(grid.col_mask) & np.isfinite(angle_lut)
    ue_ids = np.nonzero(row_mask)[0]
    bs_ids = np.nonzero(col_mask)[0]
    matrix = filled[np.ix_(ue_ids, bs_ids)]
    return matrix, angle_lut[ue_ids], angle_lut[bs_ids], ue_ids, bs_ids
