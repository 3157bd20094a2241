"""Extended estimator families vs reference-module oracles."""

import numpy as np
import pytest

from slam_process_tpu.config import DictionaryConfig, SmSicConfig
from slam_process_tpu.models.dictionary import make_dictionary
from slam_process_tpu.ops.scene import compact_grid, fill_grid, intensity_grid_np
from slam_process_tpu.config import SceneConfig


def _load_reference(name, path):
    """The reference repository's script ``path``; skips without it."""
    from tests.conftest import REFERENCE, load_reference_module

    if REFERENCE is None or not (REFERENCE / path).is_file():
        pytest.skip(f"needs the reference repository's {path} "
                    "(set SLAM_PROCESS_REFERENCE to its checkout)")
    return load_reference_module(name, path)


@pytest.fixture(scope="module")
def scene_plain_091211(filtered_golden_020606, angle_lut64):
    ue, bs, rss = (filtered_golden_020606[:, i] for i in range(3))
    grid = intensity_grid_np(ue, bs, rss, cfg=SceneConfig())
    filled = fill_grid(grid, SceneConfig())
    return compact_grid(grid, filled, angle_lut64)


def test_sm_sic_matches_reference(scene_plain_091211):
    from slam_process_tpu.models.sm_sic import sm_sic_np

    matrix, ue_ang, bs_ang, _, _ = scene_plain_091211
    ref = _load_reference("ref_v3", "heatmap_gemini_v3.py")
    est = ref.SpatialMaskingEstimator(beam_width_deg=10.0)
    est.construct_dictionary(ue_ang.astype(np.float64),
                             bs_ang.astype(np.float64), grid_res=0.5)
    ref_paths = est.estimate_paths_sm_sic(matrix.astype(np.float64),
                                          max_paths=3,
                                          proximity_mask_radius=2.0,
                                          cross_mask_width=5.0)

    cfg = SmSicConfig(max_paths=3, beam_width=10.0, grid_res=0.5)
    d = make_dictionary(ue_ang, bs_ang,
                        DictionaryConfig(grid_res=0.5, beam_width=10.0,
                                         grid_kind="arange_inclusive"))
    ours = sm_sic_np(d, matrix, cfg)
    kept = np.nonzero(ours.valid)[0]
    assert len(kept) == len(ref_paths)
    np.testing.assert_allclose(ours.aoa[kept], ref_paths["aoa"].values, atol=1e-9)
    np.testing.assert_allclose(ours.aod[kept], ref_paths["aod"].values, atol=1e-9)
    np.testing.assert_allclose(ours.metric[kept], ref_paths["metric"].values,
                               rtol=1e-9)
    assert list(np.where(ours.is_los[kept], "LoS", "NLoS")) == \
        list(ref_paths["type"].values)


def test_sm_sic_jax_matches_np(scene_plain_091211):
    import jax
    import jax.numpy as jnp

    from slam_process_tpu.models.sm_sic import sm_sic_jax, sm_sic_np

    matrix, ue_ang, bs_ang, _, _ = scene_plain_091211
    cfg = SmSicConfig(max_paths=3, beam_width=10.0, grid_res=0.5)
    d = make_dictionary(ue_ang, bs_ang,
                        DictionaryConfig(grid_res=0.5, beam_width=10.0,
                                         grid_kind="arange_inclusive"))
    ref = sm_sic_np(d, matrix, cfg)
    fn = jax.jit(lambda *a: sm_sic_jax(*a, cfg=cfg))
    ours = fn(jnp.asarray(d.phi_rx, jnp.float32), jnp.asarray(d.phi_tx, jnp.float32),
              jnp.asarray(d.aoa_grid, jnp.float32), jnp.asarray(d.aod_grid, jnp.float32),
              jnp.asarray(matrix, jnp.float32))
    np.testing.assert_array_equal(np.asarray(ours.valid), ref.valid)
    kept = ref.valid
    np.testing.assert_allclose(np.asarray(ours.aoa)[kept], ref.aoa[kept], atol=1e-4)
    np.testing.assert_allclose(np.asarray(ours.aod)[kept], ref.aod[kept], atol=1e-4)
    np.testing.assert_allclose(np.asarray(ours.metric)[kept], ref.metric[kept],
                               rtol=1e-4)


@pytest.mark.slow
def test_run_estimator_sm_sic_end_to_end(tmp_path, angle_lut64):
    from slam_process_tpu.models import run_estimator
    from slam_process_tpu.pipeline.session import Session
    from tests.conftest import BEAM_ANGLE, FILTERED_2026_02_06

    s = Session.from_filtered_xlsx(FILTERED_2026_02_06)
    df = run_estimator("sm_sic", s, BEAM_ANGLE, tmp_path / "smsic.png")
    assert (tmp_path / "smsic.png").stat().st_size > 10_000
    assert (df["type"] == "LoS").sum() == 1


def test_svd_matches_reference(filtered_golden_020606, angle_lut64):
    from slam_process_tpu.models.svd_est import (
        build_raw_matrix,
        svd_paths,
        svd_upsample,
    )

    ue, bs, rss = (filtered_golden_020606[:, i] for i in range(3))
    raw, ue_ang, bs_ang, min_rss = build_raw_matrix(ue, bs, rss, angle_lut64)
    heat, gue, gbs = svd_upsample(raw, ue_ang, bs_ang, min_rss)

    ref = _load_reference("ref_v2", "heatmap_gemini_v2.py")
    # Reference heatmap via its own RectBivariateSpline path.
    from scipy.interpolate import RectBivariateSpline

    su, sb = np.argsort(ue_ang), np.argsort(bs_ang)
    interp = RectBivariateSpline(ue_ang[su], bs_ang[sb], raw[su][:, sb])
    ref_heat = interp(np.linspace(ue_ang.min(), ue_ang.max(), 90),
                      np.linspace(bs_ang.min(), bs_ang.max(), 180))
    ref_heat[ref_heat < min_rss] = min_rss
    np.testing.assert_allclose(heat, ref_heat, rtol=1e-10, atol=1e-8)

    ref_paths = ref.svd_angle_estimator(ref_heat, gue, gbs)
    ours = svd_paths(heat, gue, gbs)
    kept = np.nonzero(ours.valid)[0]
    assert len(kept) == len(ref_paths)
    for k, rp in enumerate(ref_paths):
        assert ours.aoa[k] == pytest.approx(rp["AoA"], abs=1e-9)
        assert ours.aod[k] == pytest.approx(rp["AoD"], abs=1e-9)
        assert ours.power[k] == pytest.approx(rp["Power"], rel=1e-9)


def test_omp_dense_matches_sklearn():
    from sklearn.linear_model import OrthogonalMatchingPursuit
    from sklearn.preprocessing import normalize

    from slam_process_tpu.models.dictionary import gaussian_beam
    from slam_process_tpu.models.omp_dense import omp_dense_np

    rng = np.random.default_rng(20)
    # Small scene so the dense dictionary is cheap for the oracle.
    ua = np.linspace(-20, 20, 12)
    ub = np.linspace(-20, 20, 10)
    AU, AB = np.meshgrid(ua, ub, indexing="ij")
    meas_aoa, meas_aod = AU.ravel(), AB.ravel()
    y = (3.0 * gaussian_beam(meas_aoa, -5.0, 4.0) * gaussian_beam(meas_aod, 8.0, 4.0)
         + 1.0 * gaussian_beam(meas_aoa, 12.0, 4.0) * gaussian_beam(meas_aod, -15.0, 4.0)
         + 0.05 * rng.normal(size=meas_aoa.shape))
    aoa_grid = np.arange(-20, 20, 2.0)
    aod_grid = np.arange(-20, 20, 2.0)

    D = np.zeros((len(y), len(aoa_grid) * len(aod_grid)))
    coords = []
    c = 0
    for g in aoa_grid:
        for h in aod_grid:
            D[:, c] = (gaussian_beam(meas_aoa, g, 4.0)
                       * gaussian_beam(meas_aod, h, 4.0))
            coords.append((g, h))
            c += 1
    Dn = normalize(D, axis=0)
    omp = OrthogonalMatchingPursuit(n_nonzero_coefs=4, fit_intercept=False)
    omp.fit(Dn, y)
    ref_active = {coords[i]: omp.coef_[i]
                  for i in np.nonzero(omp.coef_)[0]}

    ours = omp_dense_np(meas_aoa, meas_aod, y, aoa_grid, aod_grid,
                        beam_width=4.0, n_paths=4)
    got = {(ours.aoa[i], ours.aod[i]): ours.power[i] for i in range(4)}
    assert set(map(tuple, got)) == set(ref_active)
    for key, val in ref_active.items():
        assert got[key] == pytest.approx(val, rel=1e-6)


def test_lasso_matches_sklearn():
    from sklearn.linear_model import Lasso

    from slam_process_tpu.ops.lasso import lasso_positive_jax, lasso_positive_np

    rng = np.random.default_rng(21)
    X = np.abs(rng.normal(size=(60, 15)))
    y = X @ np.abs(rng.normal(size=15) * (rng.random(15) < 0.4)) \
        + 0.01 * rng.normal(size=60)
    # The reference uses sklearn defaults (fit_intercept=True).
    ref = Lasso(alpha=0.1, positive=True, max_iter=5000).fit(X, y).coef_
    ours = lasso_positive_np(X, y, 0.1, n_sweeps=5000)
    np.testing.assert_allclose(ours, ref, atol=1e-4)

    import jax
    import jax.numpy as jnp

    jours = jax.jit(lambda a, b: lasso_positive_jax(a, b, 0.1, 500))(
        jnp.asarray(X), jnp.asarray(y))
    np.testing.assert_allclose(np.asarray(jours), ref, atol=5e-4)


def test_savgol_matches_scipy():
    from scipy.signal import savgol_filter

    from slam_process_tpu.ops.peaks import savgol_rows

    rng = np.random.default_rng(22)
    data = rng.normal(size=(5, 40))
    ref = savgol_filter(data, 7, 2, axis=1)
    ours = savgol_rows(data, 7, 2)
    np.testing.assert_allclose(ours, ref, atol=1e-10)


def test_cross_region_classifier_matches_reference():
    import pandas as pd

    from slam_process_tpu.models.classifiers import (
        LABEL_NAMES,
        classify_cross_region,
    )

    ref = _load_reference("ref_v15", "heatmap_gemini_v1-5.py")
    rng = np.random.default_rng(23)
    for trial in range(5):
        k = 12
        aoa = rng.uniform(-40, 40, k)
        aod = rng.uniform(-40, 40, k)
        power = np.abs(rng.normal(size=k)) * 10 + 0.1
        df = pd.DataFrame({"AoA": aoa, "AoD": aod, "Power": power,
                           "PathType": "Unknown"})
        clf = ref.PathClassifier(df, sidelobe_width_aoa=10.0,
                                 sidelobe_width_aod=10.0,
                                 nlos_power_thresh_db=3.0,
                                 nlos_min_angle_sep=15.0)
        ref_out = clf.classify_paths()

        ours = classify_cross_region(aoa, aod, power,
                                     np.ones(k, dtype=bool),
                                     sidelobe_width_aoa=10.0,
                                     sidelobe_width_aod=10.0,
                                     nlos_power_thresh_db=3.0,
                                     nlos_min_angle_sep=15.0)
        our_labels = [LABEL_NAMES[int(l)] for l in ours.label]
        assert our_labels == list(ref_out["PathType"].values), f"trial {trial}"


def test_fusion_nlos_matches_reference(filtered_golden_020606, angle_lut64):
    from slam_process_tpu.config import DictionaryConfig
    from slam_process_tpu.models.dictionary import make_dictionary
    from slam_process_tpu.models.fusion import fusion_nlos_np
    from slam_process_tpu.ops.scene import compact_grid, fill_grid, intensity_grid_np

    ue, bs, rss = (filtered_golden_020606[:, i] for i in range(3))
    grid = intensity_grid_np(ue, bs, rss, cfg=SceneConfig())
    filled = fill_grid(grid, SceneConfig())
    matrix, ue_ang, bs_ang, _, _ = compact_grid(grid, filled, angle_lut64)

    ref = _load_reference("ref_v4", "heatmap_gemini_v4.py")
    est = ref.NLoSEstimator(beam_width_deg=1.4)
    est.construct_dictionary(ue_ang.astype(np.float64),
                             bs_ang.astype(np.float64), grid_res=0.5)
    los = {"AoA": 5.0, "AoD": -10.0}
    ref_df = est.estimate_nlos_paths(matrix.astype(np.float64), los,
                                     max_paths=3, proximity_mask_radius=10.0,
                                     cross_mask_width=10.0)

    d = make_dictionary(ue_ang, bs_ang,
                        DictionaryConfig(grid_res=0.5, beam_width=1.4,
                                         grid_kind="arange_inclusive"))
    ours = fusion_nlos_np(d, matrix, 5.0, -10.0, max_paths=3,
                          proximity=10.0, cross=10.0)
    assert len(ours) == len(ref_df)
    np.testing.assert_allclose(ours["aoa"].values, ref_df["aoa"].values,
                               atol=1e-9)
    np.testing.assert_allclose(ours["metric"].values, ref_df["metric"].values,
                               rtol=1e-9)


def test_preprocess_modes():
    from slam_process_tpu.models.preprocess import preprocess_power

    rng = np.random.default_rng(24)
    data = np.abs(rng.normal(size=(32, 32))) * 100 + 1
    for method in ("none", "log", "power", "quantile", "adaptive"):
        out = preprocess_power(data, method)
        assert out.shape == data.shape
        assert np.all(np.isfinite(out))
    # power/adaptive preserve the original value range envelope
    out = preprocess_power(data, "power")
    assert out.min() >= data.min() - 1e-9 and out.max() <= data.max() + 1e-9


def test_preprocess_matches_reference(scene_plain_091211):
    """All four modes value-exact vs the LIVE reference implementation
    (heatmap_gemini_v1-3.py:119-197, ``_preprocess_power_data`` — a pure
    function of its ``data`` argument, callable unbound)."""
    from slam_process_tpu.models.preprocess import preprocess_power

    ref = _load_reference("ref_v13", "heatmap_gemini_v1-3.py")
    oracle = ref.BeamDataProcessor._preprocess_power_data

    matrix = np.asarray(scene_plain_091211[0], dtype=np.float64)
    rng = np.random.default_rng(7)
    cases = [
        matrix,                                       # the real 091211 scene
        np.abs(rng.normal(size=(32, 48))) * 500 + 3,  # generic positive
        rng.normal(size=(16, 16)) * 40 - 100,         # negative values
        rng.integers(0, 5, size=(24, 24)).astype(float),  # heavy ties
    ]
    for data in cases:
        for method in ("log", "power", "quantile", "adaptive"):
            ours = preprocess_power(data, method)
            want = oracle(None, data.copy(), method=method)
            np.testing.assert_allclose(
                ours, np.asarray(want, dtype=np.float64),
                rtol=1e-12, atol=1e-12,
                err_msg=f"method={method} shape={data.shape}")


def test_v13_compare_plot_direct(tmp_path):
    """Fast structural check of the compare_visualizations dual panel:
    drives _compare_plot directly on a small synthetic scene (the full
    estimator-driven render — a 4096-center thin-plate solve per panel —
    is the slow-lane test below)."""
    from PIL import Image

    from slam_process_tpu.models.classifiers import LOS, ClassifiedPaths
    from slam_process_tpu.models.nn_omp_v13 import _compare_plot
    from slam_process_tpu.models.preprocess import preprocess_power

    rng = np.random.default_rng(11)
    ue = np.linspace(-40.0, 40.0, 12)
    bs = np.linspace(-40.0, 40.0, 12)
    mat = np.abs(rng.normal(size=(12, 12))) * 100 + 5
    classified = ClassifiedPaths(
        np.array([3.0]), np.array([-7.0]), np.array([1.0]),
        np.array([LOS], dtype=np.int32), np.array([True]))
    out = tmp_path / "cmp.png"
    _compare_plot(mat, preprocess_power(mat, "adaptive"), ue, bs,
                  classified, out, "adaptive")
    assert out.exists() and out.stat().st_size > 10_000
    w, h = Image.open(out).size
    assert w > 1.8 * h, (w, h)


@pytest.mark.slow
def test_v13_compare_figure(tmp_path, angle_lut64):
    """nn_omp_v13 renders the compare_visualizations dual panel
    (heatmap_gemini_v1-3.py:420-470): original vs optimized, side by side."""
    from PIL import Image

    from slam_process_tpu.models import run_estimator
    from slam_process_tpu.pipeline.session import Session
    from tests.conftest import BEAM_ANGLE, FILTERED_2026_02_06

    s = Session.from_filtered_xlsx(FILTERED_2026_02_06)
    out = tmp_path / "v13_comparison.png"
    df = run_estimator("nn_omp_v13", s, BEAM_ANGLE, out, grid_res=0.5,
                       max_paths=3)
    assert out.exists() and out.stat().st_size > 10_000
    assert len(df) >= 1
    w, h = Image.open(out).size
    # 1x2 panels on a 20x8 figure: distinctly wider than tall.
    assert w > 1.8 * h, (w, h)


def test_fusion_plot_direct(tmp_path):
    """Fast structural check of v4's fused-contour figure: drives
    render.estimation.fusion_plot directly on a small synthetic scene
    (the estimator-driven render is the slow-lane test below)."""
    from PIL import Image

    from slam_process_tpu.render.estimation import fusion_plot

    rng = np.random.default_rng(12)
    ue = np.linspace(-40.0, 40.0, 12)
    bs = np.linspace(-40.0, 40.0, 12)
    mat = np.abs(rng.normal(size=(12, 12))) * 100 + 5
    out = tmp_path / "fusion.png"
    fusion_plot(mat, ue, bs, [(-7.0, 3.0)], [(10.0, -12.0), (18.0, 6.0)],
                out, grid_n=60, dpi=150)
    assert out.exists() and out.stat().st_size > 10_000
    w, h = Image.open(out).size
    assert 0.9 < w / h < 1.6, (w, h)


@pytest.mark.slow
def test_fusion_figure(tmp_path, angle_lut64):
    """The fusion estimator renders v4's bespoke fused-contour figure
    (heatmap_gemini_v4.py:375-460), not the generic v1-7 style."""
    from PIL import Image

    from slam_process_tpu.models import run_estimator
    from slam_process_tpu.pipeline.session import Session
    from tests.conftest import BEAM_ANGLE, FILTERED_2026_02_06

    s = Session.from_filtered_xlsx(FILTERED_2026_02_06)
    out = tmp_path / "fusion.png"
    df = run_estimator("fusion", s, BEAM_ANGLE, out, grid_res=0.5)
    assert out.exists() and out.stat().st_size > 10_000
    assert (df["type"] == "LoS").sum() <= 1
    w, h = Image.open(out).size
    # Single 12x10 panel: near-square, slightly wider with the colorbar.
    assert 0.9 < w / h < 1.6, (w, h)


def test_estimator_device_engine(tmp_path):
    """engine='device' routes through the jitted estimators and agrees."""
    from slam_process_tpu.models import run_estimator
    from slam_process_tpu.pipeline.session import Session
    from tests.conftest import BEAM_ANGLE, FILTERED_2026_02_06

    s = Session.from_filtered_xlsx(FILTERED_2026_02_06)
    host = run_estimator("sm_sic", s, BEAM_ANGLE, None)
    dev = run_estimator("sm_sic", s, BEAM_ANGLE, None, engine="device")
    assert list(host["type"]) == list(dev["type"])
    np.testing.assert_allclose(host["aoa"], dev["aoa"], atol=1e-4)

    host2 = run_estimator("nn_omp", s, BEAM_ANGLE, None, grid_res=0.5,
                          max_paths=6)
    dev2 = run_estimator("nn_omp", s, BEAM_ANGLE, None, grid_res=0.5,
                         max_paths=6, engine="device")
    assert list(host2["PathType"]) == list(dev2["PathType"])
    np.testing.assert_allclose(host2["AoA"], dev2["AoA"], atol=1e-3)
