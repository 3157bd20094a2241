"""Online streaming estimation + tracking == offline batch, exactly.

The round-3 gap: the unbounded-stream axis stopped at the intensity grid —
paths/tracks existed only as offline batch passes.  These tests pin the
online path (DeviceStreamingSession(collect_paths=...), estimation running
INSIDE the jitted step as sweeps close) to the offline flagship
(Session.sweep_paths / path_tracks) on the same beam set: every estimator
output leaf, the sweep-validity vector, the unwrapped CLK anchors, the
track tensors, and the velocity fits must be EXACTLY equal at multiple
chunk sizes.
"""


import numpy as np
import pytest

from slam_process_tpu.io import read_hex_log
from slam_process_tpu.ops.decode import decode_frames_np
from slam_process_tpu.parallel.streaming_device import (
    DeviceStreamingSession,
    make_paths_spec,
)
from slam_process_tpu.pipeline.session import Session
from tests.conftest import BEAM_ANGLE, DEBUGDOC, LOG_NAMES, SMALL_LOG


def _replay(raw, spec, chunk_bytes, **kw):
    s = DeviceStreamingSession(chunk_bytes=chunk_bytes, collect_paths=spec,
                               **kw)
    for off in range(0, len(raw), chunk_bytes):
        s.feed(raw[off:off + chunk_bytes])
    s.finalize()
    return s


def _offline(raw, spec, estimator="nn_omp", **overrides):
    sess = Session("offline")
    sess.frames = decode_frames_np(raw).frames
    beam_ids = (spec.ue_ids, spec.bs_ids)
    paths, valid = sess.sweep_paths(BEAM_ANGLE, estimator=estimator,
                                    beam_ids=beam_ids, **overrides)
    times = sess.sweep_times(len(valid))
    tracks, ttimes, vel = sess.path_tracks(BEAM_ANGLE, estimator=estimator,
                                           beam_ids=beam_ids, **overrides)
    return paths, valid, times, tracks, ttimes, vel


def _assert_stream_equals_offline(s, offline):
    paths, valid = s.sweep_paths()
    times = s.sweep_times()
    tracks, t2, vel = s.path_tracks()
    opaths, ovalid, otimes, otracks, ott, ovel = offline
    assert s.n_sweeps_closed == len(ovalid)
    np.testing.assert_array_equal(valid, ovalid)
    np.testing.assert_array_equal(times, otimes)
    for name in opaths._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(paths, name)),
            np.asarray(getattr(opaths, name)), err_msg=name)
    for name in ("pos_aoa", "pos_aod", "power", "observed", "created"):
        np.testing.assert_array_equal(
            np.asarray(getattr(tracks, name)),
            np.asarray(getattr(otracks, name)), err_msg=name)
    assert int(tracks.n_tracks) == int(otracks.n_tracks)
    np.testing.assert_array_equal(t2, ott)
    for v_s, v_o in zip(vel, ovel):
        np.testing.assert_array_equal(np.asarray(v_s), np.asarray(v_o))


@pytest.mark.parametrize("chunk", [
    pytest.param(1 << 16, marks=pytest.mark.slow), 1 << 20])
def test_online_paths_match_offline_small_log(chunk):
    raw = read_hex_log(SMALL_LOG)
    spec = make_paths_spec(BEAM_ANGLE)
    s = _replay(raw, spec, chunk)
    _assert_stream_equals_offline(s, _offline(raw, spec[0]))


@pytest.mark.slow
def test_online_paths_sm_sic_matches_offline():
    raw = read_hex_log(SMALL_LOG)
    spec = make_paths_spec(BEAM_ANGLE, estimator="sm_sic")
    s = _replay(raw, spec, 1 << 18)
    _assert_stream_equals_offline(
        s, _offline(raw, spec[0], estimator="sm_sic"))


@pytest.mark.slow
def test_online_paths_estimator_overrides_flow():
    """v1-7-style overrides (keep_rule/stop_nonpositive/max_paths) reach
    the in-step estimator identically to the offline path."""
    raw = read_hex_log(SMALL_LOG)
    kw = dict(max_paths=5, keep_rule="ratio", stop_nonpositive=True)
    spec = make_paths_spec(BEAM_ANGLE, **kw)
    s = _replay(raw, spec, 1 << 18)
    _assert_stream_equals_offline(s, _offline(raw, spec[0], **kw))


@pytest.mark.slow
def test_capacity_overflow_raises_not_truncates():
    raw = read_hex_log(SMALL_LOG)
    spec, dicts = make_paths_spec(BEAM_ANGLE, capacity=2)
    s = _replay(raw, (spec, dicts), 1 << 18)
    assert s.n_frames > 0
    with pytest.raises(RuntimeError, match="overflow"):
        s.sweep_paths()
    with pytest.raises(RuntimeError, match="overflow"):
        s.path_tracks()


@pytest.mark.slow
def test_s_step_overflow_raises():
    """More sweeps closing in one step than s_step allows must flag, not
    silently mis-estimate."""
    raw = read_hex_log(SMALL_LOG)
    spec, dicts = make_paths_spec(BEAM_ANGLE, s_step=1)
    s = _replay(raw, (spec, dicts), 1 << 20)   # whole log in one step
    with pytest.raises(RuntimeError, match="overflow"):
        s.sweep_paths()


def test_junk_only_stream_yields_no_sweeps():
    spec = make_paths_spec(BEAM_ANGLE)
    s = DeviceStreamingSession(chunk_bytes=1 << 16, collect_paths=spec)
    s.feed(np.zeros(4096, np.uint8))
    s.finalize()
    paths, valid = s.sweep_paths()
    assert s.n_sweeps_closed == 0
    assert len(valid) == 0
    tracks, times, vel = s.path_tracks()
    assert int(tracks.n_tracks) == 0
    assert len(times) == 0


def test_without_collect_paths_accessors_raise():
    s = DeviceStreamingSession(chunk_bytes=1 << 16)
    with pytest.raises(ValueError, match="collect_paths"):
        s.sweep_paths()
    with pytest.raises(ValueError, match="collect_paths"):
        s.path_tracks()


@pytest.mark.slow
@pytest.mark.parametrize("path", [str(DEBUGDOC / n) for n in LOG_NAMES])
def test_online_paths_match_offline_all_logs(path):
    raw = read_hex_log(path)
    spec = make_paths_spec(BEAM_ANGLE)
    for chunk in (1 << 18, 1 << 20):
        s = _replay(raw, spec, chunk)
        _assert_stream_equals_offline(s, _offline(raw, spec[0]))


@pytest.mark.slow
def test_multi_stream_online_paths_match_single_stream():
    """MultiStreamingSession(collect_paths=...): S live streams with
    ONLINE estimation+tracking in ONE vmapped program == S independent
    single-stream sessions, exactly (paths, valid, times, tracks,
    velocities), at mismatched per-stream lengths."""
    from slam_process_tpu.parallel.streaming_device import (
        MultiStreamingSession,
    )

    logs = [SMALL_LOG,
            DEBUGDOC / "Serial Debug 2026-02-06 091351.txt"]
    raws = [read_hex_log(p) for p in logs]
    spec_args = make_paths_spec(BEAM_ANGLE, s_step=8)
    chunk = 1 << 16

    singles = [_replay(r, spec_args, chunk) for r in raws]

    ms = MultiStreamingSession(n_streams=2, chunk_bytes=chunk,
                               collect_paths=spec_args)
    n_rounds = max(-(-len(r) // chunk) for r in raws)
    for k in range(n_rounds):
        ms.feed([r[k * chunk:(k + 1) * chunk] for r in raws])
    ms.finalize()

    for i, single in enumerate(singles):
        sp, sv = single.sweep_paths()
        mp, mv = ms.stream_paths(i)
        np.testing.assert_array_equal(mv, sv)
        for name in sp._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(mp, name)),
                np.asarray(getattr(sp, name)), err_msg=f"{i}:{name}")
        st, stt, svel = single.path_tracks()
        mt, mtt, mvel = ms.stream_tracks(i)
        np.testing.assert_array_equal(mtt, stt)
        for name in ("pos_aoa", "pos_aod", "power", "observed", "created"):
            np.testing.assert_array_equal(
                np.asarray(getattr(mt, name)),
                np.asarray(getattr(st, name)), err_msg=f"{i}:{name}")
        assert int(mt.n_tracks) == int(st.n_tracks)
        for a, b in zip(mvel, svel):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("chunk", [1 << 14, 1 << 17])
def test_host_online_paths_match_offline(chunk):
    """The HOST engine's online estimation (StreamingSession(
    collect_paths=...), estimating each kept-sweep as it closes with
    O(sweeps) memory) equals the offline flagship exactly — the no-accelerator
    counterpart of the device engine's collect_paths contract."""
    from slam_process_tpu.parallel.streaming import StreamingSession

    raw = read_hex_log(SMALL_LOG)
    spec = make_paths_spec(BEAM_ANGLE)
    s = StreamingSession(collect_paths=spec)
    for off in range(0, len(raw), chunk):
        s.feed(raw[off:off + chunk])
    s.finalize()
    _assert_stream_equals_offline(s, _offline(raw, spec[0]))


def test_host_online_paths_checkpoint_resume(tmp_path):
    """Host online-estimation state (open sweep accumulators, closed-sweep
    rings, kept-UE carry) survives a checkpoint mid-stream."""
    from slam_process_tpu.parallel.streaming import StreamingSession

    raw = read_hex_log(SMALL_LOG)
    spec = make_paths_spec(BEAM_ANGLE, grid_res=1.0)
    chunk = 1 << 15

    full = StreamingSession(collect_paths=spec)
    for off in range(0, len(raw), chunk):
        full.feed(raw[off:off + chunk])
    full.finalize()

    part = StreamingSession(collect_paths=spec)
    split = 90_007
    part.feed(raw[:split])
    ckpt = tmp_path / "host_paths.ckpt"
    part.save_checkpoint(ckpt)
    resumed = StreamingSession.restore(ckpt)
    for off in range(split, len(raw), chunk):
        resumed.feed(raw[off:off + chunk])
    resumed.finalize()

    pa, va = resumed.sweep_paths()
    pb, vb = full.sweep_paths()
    np.testing.assert_array_equal(va, vb)
    for name in pa._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(pa, name)),
            np.asarray(getattr(pb, name)), err_msg=name)
    np.testing.assert_array_equal(resumed.sweep_times(), full.sweep_times())
    ta, tta, vela = resumed.path_tracks()
    tb, ttb, velb = full.path_tracks()
    np.testing.assert_array_equal(tta, ttb)
    for name in ("pos_aoa", "pos_aod", "power", "observed", "created"):
        np.testing.assert_array_equal(
            np.asarray(getattr(ta, name)),
            np.asarray(getattr(tb, name)), err_msg=name)


@pytest.mark.parametrize("engine", ["device", "host"])
def test_track_columns_equal_batch_tracks(engine):
    """``track_columns(lo, hi)`` — the incremental read behind the live
    --events feed — returns exactly the batch ``path_tracks`` tensors'
    columns on BOTH engines, in windowed reads (state carried across
    calls) and regardless of read order."""
    raw = read_hex_log(SMALL_LOG)
    spec = make_paths_spec(BEAM_ANGLE)
    if engine == "device":
        s = _replay(raw, spec, chunk_bytes=1 << 16)
    else:
        from slam_process_tpu.parallel.streaming import StreamingSession

        s = StreamingSession(collect_paths=spec)
        for off in range(0, len(raw), 1 << 16):
            s.feed(raw[off:off + (1 << 16)])
        s.finalize()

    n = s.n_sweeps_closed
    assert n > 3
    tracks, times, _ = s.path_tracks()

    # Windowed incremental reads concatenate to the full history.
    parts = [s.track_columns(lo, min(lo + 3, n)) for lo in range(0, n, 3)]
    aoa = np.concatenate([p[0] for p in parts])
    aod = np.concatenate([p[1] for p in parts])
    power = np.concatenate([p[2] for p in parts])
    obs = np.concatenate([p[3] for p in parts])
    np.testing.assert_array_equal(aoa.T, tracks.pos_aoa)
    np.testing.assert_array_equal(aod.T, tracks.pos_aod)
    np.testing.assert_array_equal(power.T, tracks.power)
    np.testing.assert_array_equal(obs.T, tracks.observed)

    # Re-reads of an earlier window return the same columns (cached /
    # ring-resident — no recompute drift).
    a2, d2, p2, o2, _t2 = s.track_columns(0, n)
    np.testing.assert_array_equal(a2.T, tracks.pos_aoa)
    np.testing.assert_array_equal(o2.T, tracks.observed)
