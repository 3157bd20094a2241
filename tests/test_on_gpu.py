"""On-card numerics sentinels (the ``gpu`` lane).

The CPU lane is hermetic but blind to accelerator-only numerics: a matmul
that runs at reduced precision (bf16, or TF32 on the H100's tensor cores)
moved raster cells across colormap bins and flipped the estimator's first
selected atom against the float64 oracle, and both passed every CPU test.
This file makes those checks a test lane:

    SLAM_PROCESS_TPU_TEST_GPU=1 python -m pytest tests -m gpu

Every test asserts against a float64 host oracle, on generated captures
(tests/conftest.py), with the production programs compiled for the card.
Each test skips unless JAX's default backend is the GPU.
"""

import numpy as np
import pytest

pytestmark = [pytest.mark.gpu, pytest.mark.usefixtures("require_gpu")]


@pytest.fixture(scope="module")
def decoded(small_log_bytes):
    from slam_process_tpu.ops.correct import correct_frames_np
    from slam_process_tpu.ops.decode import decode_frames_np

    dec = decode_frames_np(small_log_bytes)
    return dec, correct_frames_np(dec.frames)


def test_device_pipeline_matches_host_on_chip(small_log_bytes, decoded):
    """decode+correct on the card == numpy, frame- and row-exact."""
    import jax

    from slam_process_tpu.pipeline.device import run_session_on_device

    dec, res = decoded
    out = run_session_on_device(small_log_bytes)
    n, frames, fv, corrected, keep = jax.device_get(
        (out.n_frames, out.frames, out.frame_valid, out.corrected_bs,
         out.keep))
    n = int(n)
    assert n == dec.valid
    fv = fv.astype(bool)
    assert int(fv.sum()) == n
    np.testing.assert_array_equal(frames[fv], dec.frames)
    filtered = np.stack(
        [frames[keep, 1], corrected[keep],
         frames[keep, 3], frames[keep, 4]], axis=1)
    np.testing.assert_array_equal(filtered, res.filtered)


def test_norm_raster_matches_f64_oracle_on_chip(small_log_bytes, decoded):
    """norm_t vs the float64 oracle at <= 1e-4 (the blur-precision
    sentinel: a bf16 blur regressed this to 8.6e-4)."""
    import jax

    from slam_process_tpu.config import SceneConfig
    from slam_process_tpu.ops.raster import blur_nan_aware_np, shifted_log_norm
    from slam_process_tpu.ops.scene import fill_grid, intensity_grid_np
    from slam_process_tpu.pipeline.device import run_session_on_device

    _, res = decoded
    cfg = SceneConfig(keep_nan=True, fill_with_min=False)
    grid = intensity_grid_np(res.filtered[:, 0], res.filtered[:, 1],
                             res.filtered[:, 2], cfg=cfg)
    matrix = fill_grid(grid, cfg).T
    oracle_t = np.asarray(shifted_log_norm(blur_nan_aware_np(matrix, 1.0)))

    out = run_session_on_device(small_log_bytes)
    ours_t = np.asarray(jax.device_get(out.norm_t), dtype=np.float64)
    both = np.isfinite(oracle_t) & np.isfinite(ours_t)
    assert float(np.max(np.abs(ours_t[both] - oracle_t[both]))) < 1e-4


def test_nn_omp_device_engine_matches_oracle_on_chip(decoded, angle_lut64):
    """The flagship v1-7 NN-OMP on the card: the selection sequence must
    equal the float64 host oracle's (the reduced-precision argmax
    sentinel)."""
    from slam_process_tpu.config import DictionaryConfig, OmpConfig
    from slam_process_tpu.models.dictionary import make_dictionary
    from slam_process_tpu.models.nn_omp import nn_omp_np, run_nn_omp
    from slam_process_tpu.ops.scene import compact_grid, fill_grid, intensity_grid_np
    from slam_process_tpu.config import SceneConfig

    _, res = decoded
    cfg_s = SceneConfig(log_transform=True)
    grid = intensity_grid_np(res.filtered[:, 0], res.filtered[:, 1],
                             res.filtered[:, 2], cfg=cfg_s)
    filled = fill_grid(grid, cfg_s)
    matrix, ue_ang, bs_ang, _, _ = compact_grid(grid, filled, angle_lut64)
    cfg = OmpConfig(max_paths=20, min_power_ratio=0.0003)
    d = make_dictionary(ue_ang, bs_ang,
                        DictionaryConfig(grid_res=0.1, beam_width=1.4,
                                         grid_kind="linspace"))
    ref = nn_omp_np(d, matrix, cfg, keep_rule="ratio", stop_nonpositive=True)
    out = run_nn_omp(d, matrix, cfg, keep_rule="ratio",
                     stop_nonpositive=True, engine="device")
    n = int(ref.n_iters)
    assert int(out.n_iters) == n
    np.testing.assert_array_equal(np.asarray(out.aoa_idx)[:n], ref.aoa_idx[:n])
    np.testing.assert_array_equal(np.asarray(out.aod_idx)[:n], ref.aod_idx[:n])
    np.testing.assert_allclose(np.asarray(out.power)[:n], ref.power[:n],
                               rtol=2e-3, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(out.valid), ref.valid)


def test_device_streaming_emit_parity_on_chip(small_log_bytes, decoded):
    """Emit-ring streaming on the card: exact filtered-rows parity."""
    from slam_process_tpu.parallel.streaming_device import replay_log_device

    dec, res = decoded
    s = replay_log_device(small_log_bytes, chunk_bytes=1 << 16,
                          collect_filtered=True)
    assert s.n_frames == dec.valid
    np.testing.assert_array_equal(s.filtered, res.filtered)


def test_sweep_paths_selection_matches_oracle_on_chip(small_log_bytes):
    """Per-sweep Gram-domain NN-OMP on the card: every sweep's selected
    grid indices must equal the float64 per-sweep host oracle's (the same
    argmax failure class as the session-level sentinel, on the
    vmapped-and-bucketed path)."""
    from slam_process_tpu.config import DictionaryConfig, OmpConfig, SceneConfig
    from slam_process_tpu.models.dictionary import make_dictionary
    from slam_process_tpu.models.nn_omp import nn_omp_np
    from slam_process_tpu.ops.correct import correct_frames_np, detect_groups_np
    from slam_process_tpu.ops.decode import decode_frames_np
    from slam_process_tpu.io.angles import load_angle_lut
    from slam_process_tpu.ops.scene import intensity_grid_np
    from slam_process_tpu.pipeline.session import Session
    from tests.conftest import BEAM_ANGLE

    s = Session("gpu_sweeps")
    s.frames = decode_frames_np(small_log_bytes).frames
    s.correct()
    paths, sweep_valid = s.sweep_paths(BEAM_ANGLE)

    lut = load_angle_lut(BEAM_ANGLE)
    filtered = s.filtered
    gid = detect_groups_np(filtered[:, 0])
    grid_all = intensity_grid_np(filtered[:, 0], filtered[:, 1],
                                 filtered[:, 2], cfg=SceneConfig())
    row_mask = np.asarray(grid_all.row_mask) & np.isfinite(lut)
    col_mask = np.asarray(grid_all.col_mask) & np.isfinite(lut)
    ue_ids, bs_ids = np.nonzero(row_mask)[0], np.nonzero(col_mask)[0]
    d = make_dictionary(lut[ue_ids], lut[bs_ids],
                        DictionaryConfig(grid_res=0.1, beam_width=1.4,
                                         grid_kind="linspace"))
    checked = 0
    for sweep in np.nonzero(sweep_valid)[0]:
        rows = filtered[gid == sweep]
        g = intensity_grid_np(rows[:, 0], rows[:, 1], rows[:, 2],
                              cfg=SceneConfig())
        sub = np.asarray(g.mean)[np.ix_(ue_ids, bs_ids)]
        finite = np.isfinite(sub)
        sub = np.where(finite, sub, sub[finite].min())
        ref = nn_omp_np(d, sub, OmpConfig(max_paths=3),
                        keep_rule="positive", stop_nonpositive=False)
        n = int(ref.n_iters)
        np.testing.assert_array_equal(
            np.asarray(paths.aoa_idx[sweep])[:n], ref.aoa_idx[:n])
        np.testing.assert_array_equal(
            np.asarray(paths.aod_idx[sweep])[:n], ref.aod_idx[:n])
        checked += 1
    assert checked >= 5


def test_device_tokenize_on_chip(small_log_bytes):
    """The on-card stride-3 tokenizer (deinterleave matmul, bf16 x bf16 ->
    f32) must be byte-exact vs the reference tokenizer, and the fused text
    pipeline must equal the byte pipeline.  The bf16 deinterleave relies
    on small-integer exactness through cuBLAS — a property only the card
    can certify."""
    import jax

    from slam_process_tpu.io.hexlog import tokenize_hex
    from slam_process_tpu.ops.tokenize import tokenize_device
    from slam_process_tpu.pipeline.device import (
        run_session_from_text,
        run_session_on_device,
    )
    from tests.conftest import SMALL_LOG

    data = SMALL_LOG.read_bytes()
    got, used_device = tokenize_device(data)
    assert used_device
    np.testing.assert_array_equal(got, tokenize_hex(data))

    res = run_session_from_text(data)
    assert bool(res.tokenize_regular)
    ref = run_session_on_device(tokenize_hex(data))
    a, b = jax.device_get((res.out, ref))
    assert int(a.n_frames) == int(b.n_frames)
    assert int(a.n_kept) == int(b.n_kept)
    np.testing.assert_array_equal(np.asarray(a.counts),
                                  np.asarray(b.counts))


def test_streaming_online_paths_on_chip(small_log_bytes):
    """ONLINE in-stream estimation + tracking on the card == the offline
    flagship on the same beam set (selection indices exact; the estimator
    argmax is the known reduced-precision flip hazard)."""
    from slam_process_tpu.parallel.streaming_device import (
        DeviceStreamingSession,
        make_paths_spec,
    )
    from slam_process_tpu.ops.decode import decode_frames_np
    from slam_process_tpu.pipeline.session import Session
    from tests.conftest import BEAM_ANGLE

    spec = make_paths_spec(BEAM_ANGLE)
    s = DeviceStreamingSession(chunk_bytes=1 << 18, collect_paths=spec)
    for off in range(0, len(small_log_bytes), 1 << 18):
        s.feed(small_log_bytes[off:off + (1 << 18)])
    s.finalize()
    paths, valid = s.sweep_paths()
    tracks, times, vel = s.path_tracks()

    sess = Session("oracle")
    sess.frames = decode_frames_np(small_log_bytes).frames
    op, ov = sess.sweep_paths(BEAM_ANGLE,
                              beam_ids=(spec[0].ue_ids, spec[0].bs_ids))
    otr, ott, ovel = sess.path_tracks(
        BEAM_ANGLE, beam_ids=(spec[0].ue_ids, spec[0].bs_ids))
    np.testing.assert_array_equal(valid, ov)
    np.testing.assert_array_equal(np.asarray(paths.aoa_idx),
                                  np.asarray(op.aoa_idx))
    np.testing.assert_array_equal(np.asarray(paths.aod_idx),
                                  np.asarray(op.aod_idx))
    np.testing.assert_array_equal(np.asarray(paths.valid),
                                  np.asarray(op.valid))
    np.testing.assert_array_equal(tracks.observed, otr.observed)
    np.testing.assert_array_equal(times, ott)


def test_track_columns_windowed_reads_on_chip(small_log_bytes):
    """The incremental ring-slice reads behind the live --events feed
    (`track_columns(lo, hi)`) return exactly the batch track tensors'
    columns when the rings live on the card, across windowed reads and
    re-reads."""
    from slam_process_tpu.parallel.streaming_device import (
        DeviceStreamingSession,
        make_paths_spec,
    )
    from tests.conftest import BEAM_ANGLE

    spec = make_paths_spec(BEAM_ANGLE)
    s = DeviceStreamingSession(chunk_bytes=1 << 18, collect_paths=spec)
    for off in range(0, len(small_log_bytes), 1 << 18):
        s.feed(small_log_bytes[off:off + (1 << 18)])
    s.finalize()
    n = s.n_sweeps_closed
    assert n > 3
    tracks, _times, _vel = s.path_tracks()
    parts = [s.track_columns(lo, min(lo + 3, n)) for lo in range(0, n, 3)]
    aoa = np.concatenate([p[0] for p in parts])
    obs = np.concatenate([p[3] for p in parts])
    raw = np.concatenate([p[4] for p in parts])
    np.testing.assert_array_equal(aoa.T, tracks.pos_aoa)
    np.testing.assert_array_equal(obs.T, tracks.observed)
    a2, _d2, _p2, o2, raw2 = s.track_columns(0, n)
    np.testing.assert_array_equal(a2.T, tracks.pos_aoa)
    np.testing.assert_array_equal(raw2, raw)
