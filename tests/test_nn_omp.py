"""NN-OMP estimator tests: NNLS vs scipy, jax==np, reference-module oracle."""

import numpy as np
import pytest

from slam_process_tpu.config import DictionaryConfig, OmpConfig, SceneConfig
from slam_process_tpu.models.dictionary import gaussian_beam, make_dictionary
from slam_process_tpu.models.nn_omp import nn_omp_jax, nn_omp_np
from slam_process_tpu.ops.scene import compact_grid, fill_grid, intensity_grid_np


def _load_reference(name, path):
    """The reference repository's script ``path``; skips without it."""
    from tests.conftest import REFERENCE, load_reference_module

    if REFERENCE is None or not (REFERENCE / path).is_file():
        pytest.skip(f"needs the reference repository's {path} "
                    "(set SLAM_PROCESS_REFERENCE to its checkout)")
    return load_reference_module(name, path)


@pytest.fixture(scope="module")
def scene_091211(filtered_golden_020606, angle_lut64):
    ue, bs, rss = (filtered_golden_020606[:, i] for i in range(3))
    cfg = SceneConfig(log_transform=True)
    grid = intensity_grid_np(ue, bs, rss, cfg=cfg)
    filled = fill_grid(grid, cfg)
    return compact_grid(grid, filled, angle_lut64)


def test_nnls_matches_scipy_f32():
    import jax
    import jax.numpy as jnp
    from scipy.optimize import nnls as scipy_nnls

    from slam_process_tpu.ops.nnls import nnls

    rng = np.random.default_rng(1)
    for _ in range(10):
        M, K = 300, int(rng.integers(2, 15))
        A = np.abs(rng.normal(size=(M, K)))
        y = rng.normal(size=M) + 2.0
        x_ref, _ = scipy_nnls(A, y)
        x_ours, _ = jax.jit(nnls)(jnp.asarray(A, jnp.float32),
                                  jnp.asarray(y, jnp.float32))
        np.testing.assert_allclose(np.asarray(x_ours), x_ref, rtol=2e-3,
                                   atol=2e-3)


def test_nnls_gram_gauss_jordan_matches_lu_k20():
    """The K>3 Gauss-Jordan subproblem solve (ops/nnls.py, the session
    estimator's hot path) reaches the same NNLS optimum as the forced-LU
    path and scipy, including near-collinear atom pairs (the degenerate
    regime the zero-pivot guard covers)."""
    import functools

    import jax
    import jax.numpy as jnp
    from scipy.optimize import nnls as scipy_nnls

    from slam_process_tpu.ops.nnls import nnls_gram

    K, M = 20, 256
    f_gj = jax.jit(functools.partial(nnls_gram, solver="auto"))
    f_lu = jax.jit(functools.partial(nnls_gram, solver="lu"))
    rng = np.random.default_rng(7)
    for trial in range(8):
        A = np.abs(rng.normal(size=(M, K))) + 0.01
        if trial % 2 == 0:   # near-collinear pair
            A[:, 1] = A[:, 0] * (1 + 1e-6 * rng.normal(size=M))
        y = np.abs(rng.normal(size=M))
        G = jnp.asarray((A.T @ A), jnp.float32)
        b = jnp.asarray(A.T @ y, jnp.float32)
        x_ref, _ = scipy_nnls(A, y)
        f_ref = np.linalg.norm(A @ x_ref - y)
        for fn in (f_gj, f_lu):
            x = np.asarray(fn(G, b)[0])
            assert np.all(x >= 0)
            # Unique optimum => compare objective values, not coordinates
            # (collinear columns make x non-unique).
            assert np.linalg.norm(A @ x - y) <= f_ref * (1 + 1e-5)


def test_nnls_gram_warm_start_matches_cold():
    """Warm-started Lawson-Hanson (the OMP refit pattern: G/b grow by one
    atom, previous (x, passive) resumes) reaches the same optimum as a
    cold start and scipy — the equivalence the warm-started estimator
    scan carries rest on."""
    import functools

    import jax
    import jax.numpy as jnp
    from scipy.optimize import nnls as scipy_nnls

    from slam_process_tpu.ops.nnls import nnls_gram

    K, M = 12, 256
    f = jax.jit(functools.partial(nnls_gram, solver="auto"))
    rng = np.random.default_rng(13)
    for trial in range(6):
        A = np.abs(rng.normal(size=(M, K))) + 0.01
        y = np.abs(rng.normal(size=M))
        # Simulate the OMP growth pattern: atoms arrive one at a time
        # (zero columns for future slots), each refit warm-started from
        # the previous solution.
        x_warm = jnp.zeros(K, jnp.float32)
        p_warm = jnp.zeros(K, bool)
        order = rng.permutation(K)
        for n in range(1, K + 1):
            sel = order[:n]
            An = np.zeros_like(A)
            An[:, sel] = A[:, sel]
            G = jnp.asarray(An.T @ An, jnp.float32)
            b = jnp.asarray(An.T @ y, jnp.float32)
            x_warm, p_warm = f(G, b, x0=x_warm, P0=p_warm)
            x_cold = np.asarray(f(G, b)[0])
            x_ref, _ = scipy_nnls(An[:, sel], y)
            f_ref = np.linalg.norm(An[:, sel] @ x_ref - y)
            xw = np.asarray(x_warm)
            assert np.all(xw >= 0)
            assert np.linalg.norm(An @ xw - y) <= f_ref * (1 + 1e-5)
            assert np.linalg.norm(An @ x_cold - y) <= f_ref * (1 + 1e-5)
            np.testing.assert_allclose(xw, x_cold, rtol=5e-4, atol=5e-4)


def test_synthetic_two_path_recovery():
    # Plant two Gaussian path blobs; NN-OMP must recover both angle pairs.
    ue_ang = np.linspace(-40, 40, 32)
    bs_ang = np.linspace(-40, 40, 32)
    truth = [(-12.0, 7.0, 1.0), (18.0, -21.0, 0.4)]
    mat = np.zeros((32, 32))
    for a_aoa, a_aod, p in truth:
        mat += p * np.outer(
            gaussian_beam(ue_ang, a_aoa, 3.0), gaussian_beam(bs_ang, a_aod, 3.0)
        )
    d = make_dictionary(ue_ang, bs_ang,
                        DictionaryConfig(grid_res=0.5, beam_width=3.0))
    paths = nn_omp_np(d, mat, OmpConfig(max_paths=4, min_power_ratio=0.01))
    got = sorted(
        [(paths.aoa[i], paths.aod[i]) for i in range(4) if paths.valid[i]],
        key=lambda t: -paths.power[list(paths.aoa).index(t[0])],
    )
    assert len(got) >= 2
    assert abs(got[0][0] - truth[0][0]) < 1.0 and abs(got[0][1] - truth[0][1]) < 1.0


def test_oracle_reference_v17_pipeline(scene_091211):
    """Run the actual reference MultipathEstimator (from the reference repository) on
    the same scene and demand identical atom selection + coefficients."""
    matrix, ue_ang, bs_ang, _, _ = scene_091211
    ref = _load_reference("ref_v17", "heatmap_gemini_v1-7.py")
    est = ref.MultipathEstimator(ue_ang.astype(np.float64),
                                 bs_ang.astype(np.float64),
                                 matrix.astype(np.float64))
    est.construct_dictionary(grid_res=0.1, beam_width=1.4)
    ref_paths = est.estimate_paths_nn_omp(max_paths=20, min_power_ratio=0.0003)

    d = make_dictionary(ue_ang, bs_ang,
                        DictionaryConfig(grid_res=0.1, beam_width=1.4,
                                         grid_kind="linspace"))
    ours = nn_omp_np(d, matrix, OmpConfig(max_paths=20, min_power_ratio=3e-4))
    kept = np.nonzero(ours.valid)[0]
    assert len(kept) == len(ref_paths)
    np.testing.assert_allclose(ours.aoa[kept], ref_paths["AoA"].values, atol=1e-9)
    np.testing.assert_allclose(ours.aod[kept], ref_paths["AoD"].values, atol=1e-9)
    np.testing.assert_allclose(ours.power[kept], ref_paths["Power"].values,
                               rtol=1e-8)


def test_oracle_reference_v17_classifier(scene_091211):
    from slam_process_tpu.config import ClassifierConfig
    from slam_process_tpu.models.classifiers import LABEL_NAMES, classify_advanced

    matrix, ue_ang, bs_ang, _, _ = scene_091211
    d = make_dictionary(ue_ang, bs_ang,
                        DictionaryConfig(grid_res=0.1, beam_width=1.4))
    paths = nn_omp_np(d, matrix, OmpConfig(max_paths=20, min_power_ratio=3e-4))

    ref = _load_reference("ref_v17c", "heatmap_gemini_v1-7.py")
    import pandas as pd

    kept = np.nonzero(paths.valid)[0]
    df = pd.DataFrame({
        "AoA": paths.aoa[kept], "AoD": paths.aod[kept],
        "Power": paths.power[kept], "PathType": "Unknown",
    })
    clf = ref.AdvancedPathClassifier(
        df, sidelobe_width_aoa=5, sidelobe_width_aod=5,
        nlos_power_thresh_db=0.01, nlos_angle_separation=15,
        sidelobe_power_ratio_db=0.15,
    )
    ref_out = clf.classify_paths()

    ours = classify_advanced(paths.aoa, paths.aod, paths.power, paths.valid,
                             ClassifierConfig())
    our_labels = [LABEL_NAMES[int(l)] for l in ours.label[kept]]
    assert our_labels == list(ref_out["PathType"].values)


def test_oracle_reference_v1_pipeline(small_filtered_golden, angle_lut64):
    """v1 flavor (golden pic/ config): no log transform, arange grids."""
    ue, bs, rss = (small_filtered_golden[:, i] for i in range(3))
    grid = intensity_grid_np(ue, bs, rss, cfg=SceneConfig())
    filled = fill_grid(grid, SceneConfig())
    matrix, ue_ang, bs_ang, _, _ = compact_grid(grid, filled, angle_lut64)

    ref = _load_reference("ref_v1", "heatmap_gemini_v1.py")
    est = ref.MultipathEstimator(ue_ang.astype(np.float64),
                                 bs_ang.astype(np.float64),
                                 matrix.astype(np.float64))
    est.construct_dictionary()
    ref_paths = est.estimate_paths_nn_omp(max_paths=3)

    d = make_dictionary(ue_ang, bs_ang,
                        DictionaryConfig(grid_res=0.1, beam_width=1.4,
                                         grid_kind="arange"))
    ours = nn_omp_np(d, matrix, OmpConfig(max_paths=3),
                     keep_rule="positive", stop_nonpositive=False)
    kept = np.nonzero(ours.valid)[0]
    assert len(kept) == len(ref_paths)
    np.testing.assert_allclose(ours.aoa[kept], ref_paths["AoA"].values, atol=1e-9)
    np.testing.assert_allclose(ours.power[kept], ref_paths["Power"].values,
                               rtol=1e-8)


def test_jax_matches_np_atom_sequence(scene_091211):
    import jax
    import jax.numpy as jnp

    matrix, ue_ang, bs_ang, _, _ = scene_091211
    d = make_dictionary(ue_ang, bs_ang,
                        DictionaryConfig(grid_res=0.5, beam_width=1.4))
    cfg = OmpConfig(max_paths=8, min_power_ratio=3e-4)
    ref = nn_omp_np(d, matrix, cfg)

    fn = jax.jit(lambda *a: nn_omp_jax(*a, cfg=cfg))
    ours = fn(jnp.asarray(d.phi_rx, jnp.float32),
              jnp.asarray(d.phi_tx, jnp.float32),
              jnp.asarray(d.aoa_grid, jnp.float32),
              jnp.asarray(d.aod_grid, jnp.float32),
              jnp.asarray(matrix, jnp.float32))
    n = int(ours.n_iters)
    assert n == ref.n_iters
    np.testing.assert_array_equal(np.asarray(ours.aoa_idx)[:n], ref.aoa_idx[:n])
    np.testing.assert_array_equal(np.asarray(ours.aod_idx)[:n], ref.aod_idx[:n])
    np.testing.assert_allclose(np.asarray(ours.power)[:n], ref.power[:n],
                               rtol=5e-3, atol=1e-4)
