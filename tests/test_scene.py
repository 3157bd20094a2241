"""Scene assembly tests: pandas-oracle equality, jax==numpy, golden data."""

import numpy as np
import pandas as pd
import pytest

from slam_process_tpu.config import SceneConfig
from slam_process_tpu.ops.correct import correct_frames_np
from slam_process_tpu.ops.scene import (
    compact_grid,
    fill_grid,
    intensity_grid_jax,
    intensity_grid_np,
)
from tests.conftest import BEAM_ANGLE


def pandas_pivot_oracle(ue, bs, rss, log_transform=False):
    """The reference pivot_data semantics via pandas (the oracle)."""
    df = pd.DataFrame({"UE_Beam": ue, "BS_Beam": bs, "RSS": rss})
    if log_transform:
        df = df[df["RSS"] > 0].copy()
        df["RSS"] = np.log(df["RSS"])
    df_avg = df.groupby(["UE_Beam", "BS_Beam"])["RSS"].mean().reset_index()
    pivot = df_avg.pivot(index="UE_Beam", columns="BS_Beam", values="RSS")
    min_rss = df_avg["RSS"].min()
    pivot = pivot.fillna(min_rss)
    return pivot.values, pivot.index.values, pivot.columns.values


def random_frames(rng, n=5000, full=False):
    ue = rng.integers(0, 64, n)
    bs = rng.integers(0, 64, n) if full else rng.integers(10, 40, n)
    rss = rng.integers(1, 1 << 18, n)
    return ue, bs, rss


@pytest.mark.parametrize("log_transform", [False, True])
def test_pivot_matches_pandas(log_transform):
    rng = np.random.default_rng(5)
    ue, bs, rss = random_frames(rng)
    grid = intensity_grid_np(ue, bs, rss, cfg=SceneConfig(log_transform=log_transform))
    filled = fill_grid(grid, SceneConfig(log_transform=log_transform))
    lut = np.arange(64, dtype=np.float32)  # identity angle map for the test
    matrix, ue_ang, bs_ang, ue_ids, bs_ids = compact_grid(grid, filled, lut)

    ref_m, ref_ue, ref_bs = pandas_pivot_oracle(ue, bs, rss, log_transform)
    np.testing.assert_array_equal(ue_ids, ref_ue)
    np.testing.assert_array_equal(bs_ids, ref_bs)
    np.testing.assert_allclose(matrix, ref_m, rtol=0, atol=1e-12)


def test_keep_nan_variant_matches_pivot_table():
    # excel_heatmap path: NaN empty cells, no fill (excel_heatmap.py:272-300).
    rng = np.random.default_rng(6)
    ue, bs, rss = random_frames(rng, n=800)
    cfg = SceneConfig(keep_nan=True, fill_with_min=False)
    grid = intensity_grid_np(ue, bs, rss, cfg=cfg)
    filled = fill_grid(grid, cfg)
    lut = np.arange(64, dtype=np.float32)
    matrix, *_ = compact_grid(grid, filled, lut)

    df = pd.DataFrame({"u": ue, "b": bs, "r": rss.astype(float)})
    pivot = pd.pivot_table(df, index="u", columns="b", values="r", aggfunc="mean")
    np.testing.assert_allclose(matrix, pivot.values, rtol=0, atol=1e-12)


def test_flag_filter_variant():
    # excel_heatmap_v2: FLAG==1 rows only.
    rng = np.random.default_rng(7)
    ue, bs, rss = random_frames(rng, n=2000)
    flag = rng.integers(0, 2, 2000)
    cfg = SceneConfig(flag_filter=1)
    grid = intensity_grid_np(ue, bs, rss, flag=flag, cfg=cfg)
    ref = intensity_grid_np(ue[flag == 1], bs[flag == 1], rss[flag == 1])
    np.testing.assert_array_equal(grid.counts, ref.counts)
    np.testing.assert_allclose(
        np.nan_to_num(grid.mean), np.nan_to_num(ref.mean), atol=1e-12
    )


@pytest.mark.parametrize("log_transform", [False, True])
def test_jax_matches_np(log_transform):
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(8)
    ue, bs, rss = random_frames(rng, n=3000)
    cfg = SceneConfig(log_transform=log_transform)
    ref = intensity_grid_np(ue, bs, rss, cfg=cfg)

    pad = 100
    uep = np.concatenate([ue, np.zeros(pad, np.int64)]).astype(np.int32)
    bsp = np.concatenate([bs, np.zeros(pad, np.int64)]).astype(np.int32)
    rssp = np.concatenate([rss, np.zeros(pad, np.int64)]).astype(np.float32)
    valid = np.arange(len(uep)) < len(ue)

    fn = jax.jit(lambda u, b, r, v: intensity_grid_jax(u, b, r, v, cfg=cfg))
    grid = fn(jnp.asarray(uep), jnp.asarray(bsp), jnp.asarray(rssp),
              jnp.asarray(valid))
    np.testing.assert_array_equal(np.asarray(grid.counts), ref.counts)
    ours = np.asarray(grid.mean)
    # f32 device path vs f64 oracle: ~1e-5 relative is expected (log + sum
    # ordering); the pipeline parity budget is 1e-3 on the final raster.
    np.testing.assert_allclose(
        np.nan_to_num(ours), np.nan_to_num(ref.mean), rtol=3e-5, atol=3e-4
    )
    np.testing.assert_allclose(float(grid.fill_value), ref.fill_value, rtol=3e-5)
    np.testing.assert_array_equal(np.asarray(grid.row_mask), ref.row_mask)


def test_angle_map_strictly_increasing(angle_lut64):
    # Justifies id-keyed pivoting == the reference's angle-keyed pivoting.
    assert np.all(np.isfinite(angle_lut64))
    assert np.all(np.diff(angle_lut64) > 0)
    assert angle_lut64[0] == pytest.approx(-43.6, abs=0.05)
    assert angle_lut64[-1] == pytest.approx(45.0, abs=0.05)


def test_golden_session_pivot(filtered_golden_020606, angle_lut64):
    ue, bs, rss, _clk = (filtered_golden_020606[:, i] for i in range(4))
    cfg = SceneConfig(log_transform=True)
    grid = intensity_grid_np(ue, bs, rss, cfg=cfg)
    filled = fill_grid(grid, cfg)
    matrix, ue_ang, bs_ang, ue_ids, bs_ids = compact_grid(grid, filled, angle_lut64)

    ref_m, ref_ue, ref_bs = pandas_pivot_oracle(ue, bs, rss, log_transform=True)
    np.testing.assert_array_equal(ue_ids, ref_ue)
    np.testing.assert_array_equal(bs_ids, ref_bs)
    np.testing.assert_allclose(matrix, ref_m, atol=1e-12)
    assert matrix.shape[0] == len(ue_ang) and matrix.shape[1] == len(bs_ang)


def test_per_sweep_intensity():
    import jax
    import jax.numpy as jnp

    from slam_process_tpu.ops.scene import intensity_per_sweep_jax

    rng = np.random.default_rng(60)
    n, S = 4000, 6
    ue = rng.integers(0, 64, n)
    bs = rng.integers(0, 64, n)
    rss = rng.integers(1, 1 << 18, n).astype(np.float64)
    gid = np.sort(rng.integers(0, S, n))
    valid = np.ones(n, dtype=bool)
    valid[::17] = False

    fn = jax.jit(lambda *a: intensity_per_sweep_jax(*a, max_sweeps=S))
    mean, counts = fn(jnp.asarray(ue, jnp.int32), jnp.asarray(bs, jnp.int32),
                      jnp.asarray(rss, jnp.float32), jnp.asarray(gid, jnp.int32),
                      jnp.asarray(valid))
    mean, counts = np.asarray(mean), np.asarray(counts)

    for s in range(S):
        m = valid & (gid == s)
        ref = intensity_grid_np(ue[m], bs[m], rss[m])
        np.testing.assert_array_equal(counts[s], ref.counts)
        np.testing.assert_allclose(np.nan_to_num(mean[s]),
                                   np.nan_to_num(ref.mean), rtol=3e-5,
                                   atol=3e-4)


def test_per_sweep_vmapped_raster(small_log_bytes):
    """Per-sweep grids feed the vmapped XLA raster (blur, norm, colormap)."""
    import jax
    import jax.numpy as jnp

    from slam_process_tpu.ops.correct import correct_frames_np, detect_groups_np
    from slam_process_tpu.ops.decode import decode_frames_np
    from slam_process_tpu.ops.raster import (
        apply_colormap_float,
        blur_nan_aware_jax,
        colormap_lut,
        shifted_log_norm,
    )
    from slam_process_tpu.ops.scene import intensity_per_sweep_jax

    frames = decode_frames_np(small_log_bytes).frames
    res = correct_frames_np(frames)
    filt = res.filtered
    gid = detect_groups_np(filt[:, 0])
    S = int(gid.max()) + 1
    mean, counts = intensity_per_sweep_jax(
        jnp.asarray(filt[:, 0], jnp.int32), jnp.asarray(filt[:, 1], jnp.int32),
        jnp.asarray(filt[:, 2], jnp.float32), jnp.asarray(gid, jnp.int32),
        jnp.ones(len(filt), dtype=bool), max_sweeps=S,
    )
    lut = jnp.asarray(colormap_lut("viridis"))

    def one(m):
        t = shifted_log_norm(blur_nan_aware_jax(m, 1.0))
        return apply_colormap_float(t, lut), t

    rgba, t = jax.jit(jax.vmap(one))(jnp.transpose(mean, (0, 2, 1)))
    assert rgba.shape == (S, 64, 64, 4)
    # every sweep raster has signal
    assert all(np.isfinite(np.asarray(t)[s]).any() for s in range(S))
