"""Per-sweep batched estimation on device (Session.sweep_paths).

Oracle: for each sweep, the host pipeline — per-sweep pivot (mean per
(UE, BS) cell over that sweep's filtered rows), session-level compact
submatrix, per-sweep min fill — then nn_omp_np.  The device path vmaps
nn_omp_jax over the [S, U', B'] tensor; with a mesh, sweeps shard over
'data' and the dictionary grid over 'model'.
"""

import numpy as np
import pytest

from slam_process_tpu.config import DictionaryConfig, OmpConfig, SceneConfig


@pytest.fixture(scope="module")
def session():
    from slam_process_tpu.pipeline.session import Session
    from tests.conftest import FILTERED_2026_02_06

    return Session.from_filtered_xlsx(FILTERED_2026_02_06)


@pytest.fixture(scope="module")
def host_oracle(session, angle_lut64):
    from slam_process_tpu.models.dictionary import make_dictionary
    from slam_process_tpu.models.nn_omp import nn_omp_np
    from slam_process_tpu.ops.correct import detect_groups_np
    from slam_process_tpu.ops.scene import intensity_grid_np

    filtered = session.filtered
    gid = detect_groups_np(filtered[:, 0])
    n_sweeps = int(gid.max()) + 1

    grid_all = intensity_grid_np(filtered[:, 0], filtered[:, 1],
                                 filtered[:, 2], cfg=SceneConfig())
    row_mask = np.asarray(grid_all.row_mask) & np.isfinite(angle_lut64)
    col_mask = np.asarray(grid_all.col_mask) & np.isfinite(angle_lut64)
    ue_ids, bs_ids = np.nonzero(row_mask)[0], np.nonzero(col_mask)[0]
    ue_ang, bs_ang = angle_lut64[ue_ids], angle_lut64[bs_ids]
    d = make_dictionary(ue_ang, bs_ang,
                        DictionaryConfig(grid_res=0.1, beam_width=1.4,
                                         grid_kind="linspace"))

    results = []
    for s in range(n_sweeps):
        rows = filtered[gid == s]
        g = intensity_grid_np(rows[:, 0], rows[:, 1], rows[:, 2],
                              cfg=SceneConfig())
        sub = np.asarray(g.mean)[np.ix_(ue_ids, bs_ids)]
        finite = np.isfinite(sub)
        if not finite.any():
            results.append(None)
            continue
        sub = np.where(finite, sub, sub[finite].min())
        results.append(nn_omp_np(d, sub, OmpConfig(max_paths=3),
                                 keep_rule="positive",
                                 stop_nonpositive=False))
    return results


def _check(paths, sweep_valid, host_oracle):
    assert len(sweep_valid) == len(host_oracle)
    n_checked = 0
    for s, ref in enumerate(host_oracle):
        assert sweep_valid[s] == (ref is not None)
        if ref is None:
            continue
        np.testing.assert_array_equal(paths.valid[s], ref.valid)
        kept = ref.valid
        np.testing.assert_allclose(paths.aoa[s][kept], ref.aoa[kept],
                                   atol=0.11)
        np.testing.assert_allclose(paths.aod[s][kept], ref.aod[kept],
                                   atol=0.11)
        np.testing.assert_allclose(paths.power[s][kept], ref.power[kept],
                                   rtol=5e-2)
        n_checked += 1
    assert n_checked >= 3   # the real log has many non-empty sweeps


def test_sweep_paths_matches_per_sweep_host_oracle(session, host_oracle):
    from tests.conftest import BEAM_ANGLE

    paths, sweep_valid = session.sweep_paths(BEAM_ANGLE)
    _check(paths, sweep_valid, host_oracle)


def test_sweep_paths_sharded_matches_unsharded(session, host_oracle):
    from slam_process_tpu.parallel.mesh import make_mesh
    from tests.conftest import BEAM_ANGLE

    mesh = make_mesh((4, 2), ("data", "model"))
    paths, sweep_valid = session.sweep_paths(BEAM_ANGLE, mesh=mesh)
    _check(paths, sweep_valid, host_oracle)
    ref_paths, _ = session.sweep_paths(BEAM_ANGLE)
    for name in ("aoa", "aod", "power", "valid"):
        np.testing.assert_allclose(
            getattr(paths, name).astype(np.float64),
            getattr(ref_paths, name).astype(np.float64),
            atol=1e-5, err_msg=name)


def test_sweep_paths_sm_sic_runs(session):
    from tests.conftest import BEAM_ANGLE

    paths, sweep_valid = session.sweep_paths(BEAM_ANGLE, estimator="sm_sic")
    assert paths.aoa.shape[0] == len(sweep_valid)
    assert paths.valid[sweep_valid].any()


def test_per_sweep_cli(tmp_path):
    """cli estimate --per-sweep writes the per-sweep paths table."""
    from slam_process_tpu.io.xlsx import read_xlsx_table
    from slam_process_tpu.pipeline.cli import main
    from tests.conftest import BEAM_ANGLE, FILTERED_2026_02_06

    out = tmp_path / "sweeps.xlsx"
    rc = main(["estimate", "--input", str(FILTERED_2026_02_06),
               "--mapping", str(BEAM_ANGLE), "--per-sweep",
               "--output", str(out)])
    assert rc == 0
    names, data = read_xlsx_table(out)
    assert names == ["Sweep", "CLK", "Path", "AoA", "AoD", "Power"]
    assert len(data) >= 3
    assert np.all(data[:, 5] > 0)
    # CLK anchors are the first kept frame per sweep.  A generated
    # capture's clock runs forward and wraps the 30-bit counter every few
    # sweeps; sweep_times unwraps each wrap onto a monotone axis (the
    # small-decrease rule is unit-tested in tests/test_tracking.py).
    per_sweep = {int(r[0]): int(r[1]) for r in data}
    clks = [per_sweep[k] for k in sorted(per_sweep)]
    assert all(c >= 0 for c in clks)
    assert all(b > a for a, b in zip(clks, clks[1:]))
    assert max(clks) >= 1 << 30          # at least one wrap unwrapped


def test_sweep_memo_invalidated_on_recorrect(small_log_bytes):
    """Re-running correct() must drop the sweep-estimation memo: results
    after the data changes reflect the NEW filtered table, never stale
    prep keyed on a recycled array id."""
    from slam_process_tpu.ops.decode import decode_frames_np
    from slam_process_tpu.pipeline.session import Session
    from tests.conftest import BEAM_ANGLE

    s = Session("memo_check")
    s.frames = decode_frames_np(small_log_bytes).frames
    s.correct()
    paths_full, valid_full = s.sweep_paths(BEAM_ANGLE)

    # Shrink the session to its first half and re-correct: fewer sweeps.
    s.frames = s.frames[: len(s.frames) // 2]
    s.correct()
    paths_half, valid_half = s.sweep_paths(BEAM_ANGLE)
    assert len(valid_half) < len(valid_full)

    # And it must equal a fresh session over the same data.
    f = Session("memo_fresh")
    f.frames = s.frames
    f.correct()
    paths_ref, valid_ref = f.sweep_paths(BEAM_ANGLE)
    np.testing.assert_array_equal(valid_half, valid_ref)
    np.testing.assert_array_equal(paths_half.aoa_idx, paths_ref.aoa_idx)
    np.testing.assert_array_equal(paths_half.aod_idx, paths_ref.aod_idx)


def test_sweep_paths_dataset_matches_per_session(session):
    """sweep_paths_dataset (dataset-common padded shapes, one compiled
    estimator) == each session's own sweep_paths, on sessions of very
    different sizes."""
    from slam_process_tpu.pipeline.session import Session, sweep_paths_dataset
    from tests.conftest import BEAM_ANGLE, SMALL_FILTERED

    sessions = [Session.from_filtered_xlsx(SMALL_FILTERED), session]
    batched = sweep_paths_dataset(sessions, BEAM_ANGLE)
    for s, (paths_b, valid_b) in zip(sessions, batched):
        paths_r, valid_r = s.sweep_paths(BEAM_ANGLE)
        np.testing.assert_array_equal(valid_b, valid_r)
        np.testing.assert_array_equal(paths_b.aoa_idx, paths_r.aoa_idx)
        np.testing.assert_array_equal(paths_b.aod_idx, paths_r.aod_idx)
        np.testing.assert_array_equal(paths_b.valid, paths_r.valid)
        ok = np.asarray(paths_r.valid)
        np.testing.assert_allclose(np.asarray(paths_b.power)[ok],
                                   np.asarray(paths_r.power)[ok],
                                   rtol=2e-4, atol=1e-6)
