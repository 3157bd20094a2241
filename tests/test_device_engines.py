"""engine="device" parity for the extended estimator families.

Every estimator family has a jitted device path: nn_omp/sm_sic are
covered in tests/test_estimators.py; this file
covers svd, fusion, peak_picking, and lasso_refine against their float64
host oracles on a real session.
"""

import numpy as np
import pandas as pd
import pytest


@pytest.fixture(scope="module")
def session():
    from slam_process_tpu.pipeline.session import Session
    from tests.conftest import FILTERED_2026_02_06

    return Session.from_filtered_xlsx(FILTERED_2026_02_06)


def _run(name, session, **kw):
    from slam_process_tpu.models import run_estimator
    from tests.conftest import BEAM_ANGLE

    return run_estimator(name, session, BEAM_ANGLE, None, **kw)


def test_svd_paths_jax_matches_host(filtered_golden_020606, angle_lut64):
    import jax
    import jax.numpy as jnp

    from slam_process_tpu.models.svd_est import (
        build_raw_matrix,
        svd_paths,
        svd_paths_jax,
        svd_upsample,
    )

    ue, bs, rss = (filtered_golden_020606[:, i] for i in range(3))
    raw, ue_ang, bs_ang, min_rss = build_raw_matrix(ue, bs, rss, angle_lut64)
    heat, gue, gbs = svd_upsample(raw, ue_ang, bs_ang, min_rss)
    ref = svd_paths(heat, gue, gbs)
    out = jax.jit(svd_paths_jax)(jnp.asarray(heat, jnp.float32),
                                 jnp.asarray(gue, jnp.float32),
                                 jnp.asarray(gbs, jnp.float32))
    np.testing.assert_array_equal(np.asarray(out.valid), ref.valid)
    kept = ref.valid
    np.testing.assert_allclose(np.asarray(out.aoa)[kept], ref.aoa[kept],
                               atol=1e-3)
    np.testing.assert_allclose(np.asarray(out.aod)[kept], ref.aod[kept],
                               atol=1e-3)
    np.testing.assert_allclose(np.asarray(out.power)[kept], ref.power[kept],
                               rtol=1e-3)
    np.testing.assert_allclose(np.asarray(out.singular)[kept],
                               ref.singular[kept], rtol=1e-3)


@pytest.mark.parametrize("name,sort_cols,value_cols", [
    ("svd", ["AoA", "AoD"], ["Power", "SingularValue"]),
    ("fusion", ["aoa", "aod"], ["metric"]),
    ("peak_picking", ["AoA", "AoD"], ["Power"]),
    ("lasso_refine", ["AoA", "AoD"], ["Power"]),
    ("nn_omp_v13", ["AoA", "AoD"], ["Power"]),
    ("nn_omp_v14", ["AoA", "AoD"], ["Power"]),
    ("nn_omp_v15", ["AoA", "AoD"], ["Power"]),
    ("nn_omp_v16", ["AoA", "AoD"], ["Power"]),
    ("omp_dense", ["AoA", "AoD"], ["Power"]),
])
def test_device_engine_matches_host(name, sort_cols, value_cols, session):
    host = _run(name, session)
    dev = _run(name, session, engine="device")
    assert len(host) == len(dev), (host, dev)
    # Sort on the angles rounded to the 0.1-degree grid: two paths can
    # share an AoA up to float jitter, which must not reorder the rows.
    h, d = (df.loc[df[sort_cols].round(1).sort_values(sort_cols).index]
            .reset_index(drop=True) for df in (host, dev))
    for col in sort_cols:
        np.testing.assert_allclose(
            np.asarray(d[col], float), np.asarray(h[col], float), atol=0.11,
            err_msg=f"{name}: {col}")
    for col in value_cols:
        np.testing.assert_allclose(
            np.asarray(d[col], float), np.asarray(h[col], float), rtol=2e-3,
            err_msg=f"{name}: {col}")
    # Path-type labels must agree exactly.
    tcol = "Type" if "Type" in host.columns else ("type" if "type" in
                                                  host.columns else None)
    if tcol is not None:
        assert list(h[tcol]) == list(d[tcol]), name


def test_fusion_nlos_jax_matches_np(filtered_golden_020606, angle_lut64):
    import jax
    import jax.numpy as jnp

    from slam_process_tpu.config import DictionaryConfig, SceneConfig
    from slam_process_tpu.models.dictionary import make_dictionary
    from slam_process_tpu.models.fusion import fusion_nlos_jax, fusion_nlos_np
    from slam_process_tpu.ops.scene import (
        compact_grid,
        fill_grid,
        intensity_grid_np,
    )

    ue, bs, rss = (filtered_golden_020606[:, i] for i in range(3))
    grid = intensity_grid_np(ue, bs, rss, cfg=SceneConfig())
    filled = fill_grid(grid, SceneConfig())
    matrix, ue_ang, bs_ang, _, _ = compact_grid(grid, filled, angle_lut64)
    d = make_dictionary(ue_ang, bs_ang,
                        DictionaryConfig(grid_res=0.5, beam_width=1.4,
                                         grid_kind="arange_inclusive"))
    ref = fusion_nlos_np(d, matrix, 10.0, -5.0)
    a, dd, m, v = jax.jit(fusion_nlos_jax)(
        jnp.asarray(d.phi_rx, jnp.float32), jnp.asarray(d.phi_tx, jnp.float32),
        jnp.asarray(d.aoa_grid, jnp.float32), jnp.asarray(d.aod_grid, jnp.float32),
        jnp.asarray(matrix, jnp.float32),
        jnp.float32(10.0), jnp.float32(-5.0), jnp.bool_(True),
    )
    kept = np.nonzero(np.asarray(v))[0]
    assert len(kept) == len(ref)
    np.testing.assert_allclose(np.asarray(a)[kept], ref["aoa"].values, atol=0.51)
    np.testing.assert_allclose(np.asarray(dd)[kept], ref["aod"].values, atol=0.51)
    np.testing.assert_allclose(np.asarray(m)[kept], ref["metric"].values,
                               rtol=1e-3)


def test_refine_patches_device_matches_host(filtered_golden_020606, angle_lut64):
    from slam_process_tpu.models.lasso_refine import (
        make_heatmap_interpolated,
        refine_patches,
        refine_patches_device,
    )
    from slam_process_tpu.ops.peaks import peak_regions_np

    ue, bs, rss = (filtered_golden_020606[:, i] for i in range(3))
    df = pd.DataFrame({"UE": ue, "BS": bs, "RSS": rss * 1.0})
    df["AoA"] = angle_lut64[df["UE"].astype(int)]
    df["AoD"] = angle_lut64[df["BS"].astype(int)]
    df = df.dropna(subset=["AoA", "AoD"])
    agg = df.groupby(["UE", "BS", "AoA", "AoD"]).RSS.mean().reset_index()

    aoa_grid, aod_grid, heat = make_heatmap_interpolated(
        agg["AoA"].values, agg["AoD"].values, agg["RSS"].values)
    peaks = peak_regions_np(heat, 65.0)
    host = refine_patches(agg["AoA"].values, agg["AoD"].values,
                          agg["RSS"].values, aoa_grid, aod_grid, heat, peaks)
    dev = refine_patches_device(agg["AoA"].values, agg["AoD"].values,
                                agg["RSS"].values, aoa_grid, aod_grid,
                                heat.shape, peaks)
    scale = max(np.abs(host).max(), 1.0)
    np.testing.assert_allclose(dev / scale, host / scale, atol=2e-3)


def test_omp_dense_jax_matches_np_synthetic():
    """Selection indices == host (== sklearn) on random separable scenes."""
    import jax
    import jax.numpy as jnp

    from slam_process_tpu.models.dictionary import gaussian_beam
    from slam_process_tpu.models.omp_dense import omp_dense_jax, omp_dense_np

    from slam_process_tpu.models.omp_dense import DenseOmpPaths  # noqa: F401

    rng = np.random.default_rng(11)
    for trial in range(3):
        # Dense beam-grid sampling (like the real UE x BS sessions): every
        # dictionary atom has nearby measurements, so column norms are
        # healthy and the selection landscape has clear winners.  (Sparse
        # random 2-D sampling makes normalized OMP dominated by
        # single-measurement spike atoms with near-tied correlations —
        # legitimately precision-chaotic for float32 and float64 alike.)
        ga = np.linspace(-29, 29, 12 + trial)
        gd = np.linspace(-19, 24, 10 + trial)
        meas_aoa, meas_aod = (x.ravel() for x in np.meshgrid(ga, gd))
        m = meas_aoa.size
        aoa_grid = np.arange(-30.0, 30.0, 0.5)
        aod_grid = np.arange(-20.0, 25.0, 0.5)
        # Planted separable atoms + small noise.
        y = rng.random(m) * 0.05
        for _ in range(4):
            ca = rng.uniform(-28, 28)
            cd = rng.uniform(-18, 23)
            y = y + rng.uniform(1.0, 3.0) * (
                gaussian_beam(meas_aoa, ca, 1.4)
                * gaussian_beam(meas_aod, cd, 1.4))

        ref = omp_dense_np(meas_aoa, meas_aod, y, aoa_grid, aod_grid)
        rx = gaussian_beam(
            jnp.asarray(meas_aoa, jnp.float32)[:, None],
            jnp.asarray(aoa_grid, jnp.float32)[None, :], 1.4)
        tx = gaussian_beam(
            jnp.asarray(meas_aod, jnp.float32)[:, None],
            jnp.asarray(aod_grid, jnp.float32)[None, :], 1.4)
        out = jax.jit(omp_dense_jax, static_argnames="n_paths")(
            rx, tx, jnp.asarray(y, jnp.float32),
            jnp.asarray(aoa_grid, jnp.float32),
            jnp.asarray(aod_grid, jnp.float32))
        np.testing.assert_allclose(np.asarray(out.aoa), ref.aoa, atol=1e-5,
                                   err_msg=f"trial {trial}")
        np.testing.assert_allclose(np.asarray(out.aod), ref.aod, atol=1e-5,
                                   err_msg=f"trial {trial}")
        np.testing.assert_allclose(np.asarray(out.power), ref.power,
                                   rtol=2e-3, atol=1e-5,
                                   err_msg=f"trial {trial}")
        np.testing.assert_array_equal(np.asarray(out.valid), ref.valid,
                                      err_msg=f"trial {trial}")


def test_geometric_device_engine_warns(session):
    with pytest.warns(RuntimeWarning, match="no device engine"):
        _run("geometric", session, engine="device")
