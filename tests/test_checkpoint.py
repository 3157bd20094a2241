"""Mid-stream checkpoint/resume of the device streaming state machine.

SURVEY §5.4: the reference's only durable state is its .xlsx stage
artifacts — fine for file-to-file batch reruns, useless for an unbounded
live capture, whose bytes cannot be re-fed after a crash.  These tests pin
the contract of ``DeviceStreamingSession.save_checkpoint/restore`` (and the
multi-stream variant): a stream interrupted at an ARBITRARY byte position,
checkpointed to disk, and resumed in a fresh session must produce results
EXACTLY equal to an uninterrupted run — grids, counts, emitted rows, online
per-sweep paths, CLK anchors, tracks, and velocity fits alike.
"""

import numpy as np
import pytest

from slam_process_tpu.parallel.streaming_device import (
    DeviceStreamingSession,
    MultiStreamingSession,
    make_paths_spec,
)
from tests.conftest import BEAM_ANGLE


def _feed_all(sess, raw, chunk):
    for off in range(0, len(raw), chunk):
        sess.feed(raw[off:off + chunk])
    sess.finalize()
    return sess


def _assert_sessions_equal(a, b, *, paths=False, filtered=False):
    assert a.n_frames == b.n_frames
    assert a.n_kept == b.n_kept
    assert a.n_groups == b.n_groups
    ga, gb = a.intensity(), b.intensity()
    np.testing.assert_array_equal(ga.mean, gb.mean)
    np.testing.assert_array_equal(ga.counts, gb.counts)
    if filtered:
        np.testing.assert_array_equal(a.filtered, b.filtered)
    if paths:
        pa, va = a.sweep_paths()
        pb, vb = b.sweep_paths()
        np.testing.assert_array_equal(va, vb)
        for name in pa._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(pa, name)),
                np.asarray(getattr(pb, name)), err_msg=name)
        np.testing.assert_array_equal(a.sweep_times(), b.sweep_times())
        ta, tta, vela = a.path_tracks()
        tb, ttb, velb = b.path_tracks()
        np.testing.assert_array_equal(tta, ttb)
        for name in ("pos_aoa", "pos_aod", "power", "observed", "created"):
            np.testing.assert_array_equal(
                np.asarray(getattr(ta, name)),
                np.asarray(getattr(tb, name)), err_msg=name)
        assert int(ta.n_tracks) == int(tb.n_tracks)
        for x, y in zip(vela, velb):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("split", [
    pytest.param(150_001, marks=pytest.mark.slow), 37])
def test_checkpoint_resume_equals_uninterrupted(small_log_bytes, tmp_path,
                                                split):
    """Interrupt at an arbitrary (non-chunk-aligned) byte position, with
    every stateful feature armed: emit ring, online estimation, tracker.
    ``split=37`` checkpoints while the whole prefix still sits in the
    host byte carry (nothing has reached the device yet)."""
    chunk = 1 << 16
    spec = make_paths_spec(BEAM_ANGLE, grid_res=1.0)
    raw = small_log_bytes

    full = _feed_all(
        DeviceStreamingSession(chunk_bytes=chunk, collect_filtered=True,
                               collect_paths=spec), raw, chunk)

    part = DeviceStreamingSession(chunk_bytes=chunk, collect_filtered=True,
                                  collect_paths=spec)
    part.feed(raw[:split])
    ckpt = tmp_path / "stream.ckpt"     # no .npz suffix on purpose
    part.save_checkpoint(ckpt)

    resumed = DeviceStreamingSession.restore(ckpt)
    assert resumed.chunk_bytes == chunk
    assert resumed.collect_filtered
    for off in range(split, len(raw), chunk):
        resumed.feed(raw[off:off + chunk])
    resumed.finalize()

    _assert_sessions_equal(resumed, full, paths=True, filtered=True)


@pytest.mark.slow
def test_checkpoint_resume_across_emit_growth(small_log_bytes, tmp_path):
    """The auto-growing emit ring survives a checkpoint: growth state
    (current capacity + host-side bound) round-trips, and growth that
    happens AFTER the restore still never overflows."""
    from slam_process_tpu.ops.correct import correct_frames_np
    from slam_process_tpu.ops.decode import decode_frames_np

    stream = np.concatenate([small_log_bytes] * 3)
    chunk = 1 << 15

    def shrunk():
        s = DeviceStreamingSession(chunk_bytes=chunk, collect_filtered=True)
        s._ecap = 1 << 10
        s._state = s._state._replace(
            emit_buf=np.zeros((s._emit_alloc(), 4), np.int32))
        s._build_programs()
        return s

    full = _feed_all(shrunk(), stream, chunk)

    part = shrunk()
    split = len(stream) // 3 + 11        # after at least one growth
    for off in range(0, split, chunk):
        part.feed(stream[off:min(off + chunk, split)])
    grown_ecap = part._ecap
    assert grown_ecap > 1 << 10, "growth must precede the checkpoint"
    ckpt = tmp_path / "grown.ckpt"
    part.save_checkpoint(ckpt)

    resumed = DeviceStreamingSession.restore(ckpt)
    assert resumed._ecap == grown_ecap and resumed._emit_auto
    for off in range(split, len(stream), chunk):
        resumed.feed(stream[off:off + chunk])
    resumed.finalize()

    _assert_sessions_equal(resumed, full, filtered=True)
    res = correct_frames_np(decode_frames_np(stream).frames)
    np.testing.assert_array_equal(resumed.filtered, res.filtered)


@pytest.mark.slow
def test_checkpoint_kind_mismatch_raises(small_log_bytes, tmp_path):
    single = DeviceStreamingSession(chunk_bytes=1 << 15)
    single.feed(small_log_bytes[: 1 << 15])
    p1 = tmp_path / "single.ckpt"
    single.save_checkpoint(p1)
    with pytest.raises(ValueError, match="not a MultiStreamingSession"):
        MultiStreamingSession.restore(p1)

    multi = MultiStreamingSession(2, chunk_bytes=1 << 15)
    multi.feed([small_log_bytes[: 1 << 15]] * 2)
    p2 = tmp_path / "multi.ckpt"
    multi.save_checkpoint(p2)
    with pytest.raises(ValueError, match="not a DeviceStreamingSession"):
        DeviceStreamingSession.restore(p2)


def test_checkpoint_leaf_mismatch_raises(small_log_bytes, tmp_path):
    """A checkpoint whose state layout disagrees with its own recorded
    configuration (e.g. written by a different build) fails loudly."""
    import pickle

    s = DeviceStreamingSession(chunk_bytes=1 << 15, group_capacity=512)
    s.feed(small_log_bytes[: 1 << 15])
    ckpt = tmp_path / "tampered.ckpt"
    s.save_checkpoint(ckpt)

    with np.load(ckpt, allow_pickle=False) as z:
        payload = dict(z)
    meta = pickle.loads(payload["meta"].tobytes())
    meta["group_capacity"] = 1024        # state leaves stay 512-shaped
    payload["meta"] = np.frombuffer(pickle.dumps(meta, protocol=4),
                                    dtype=np.uint8)
    with open(ckpt, "wb") as f:
        np.savez(f, **payload)
    with pytest.raises(ValueError, match="leaf"):
        DeviceStreamingSession.restore(ckpt)


@pytest.mark.slow
def test_multi_stream_checkpoint_resume(small_log_bytes, tmp_path):
    """Two live streams at different positions checkpoint and resume as
    one state; per-stream results equal the uninterrupted multi run."""
    chunk = 1 << 15
    spec = make_paths_spec(BEAM_ANGLE, grid_res=1.0, s_step=16)
    streams = [small_log_bytes[: 120_000], small_log_bytes[60_000: 200_000]]
    ecap = 1 << 15

    def rounds(feeds):
        n = max(len(x) for x in feeds)
        for off in range(0, n, chunk):
            yield [x[off:off + chunk] for x in feeds]

    full = MultiStreamingSession(2, chunk_bytes=chunk, collect_paths=spec,
                                 emit_capacity=ecap)
    for r in rounds(streams):
        full.feed(r)
    full.finalize()

    part = MultiStreamingSession(2, chunk_bytes=chunk, collect_paths=spec,
                                 emit_capacity=ecap)
    halves = [x[: 70_001] for x in streams]      # unaligned split
    for r in rounds(halves):
        part.feed(r)
    ckpt = tmp_path / "multi.ckpt"
    part.save_checkpoint(ckpt)

    resumed = MultiStreamingSession.restore(ckpt)
    rests = [x[70_001:] for x in streams]
    for r in rounds(rests):
        resumed.feed(r)
    resumed.finalize()

    ra, rb = resumed.results(), full.results()
    for x, y in zip(ra, rb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    for i in range(2):
        np.testing.assert_array_equal(resumed.stream_filtered(i),
                                      full.stream_filtered(i))
        pa, va = resumed.stream_paths(i)
        pb, vb = full.stream_paths(i)
        np.testing.assert_array_equal(va, vb)
        for name in pa._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(pa, name)),
                np.asarray(getattr(pb, name)), err_msg=f"{name}[{i}]")
        ta, tta, vela = resumed.stream_tracks(i)
        tb, ttb, velb = full.stream_tracks(i)
        np.testing.assert_array_equal(tta, ttb)
        for name in ("pos_aoa", "pos_aod", "power", "observed", "created"):
            np.testing.assert_array_equal(
                np.asarray(getattr(ta, name)),
                np.asarray(getattr(tb, name)), err_msg=f"{name}[{i}]")


def test_checkpoint_extra_roundtrip_and_finalized_guard(small_log_bytes,
                                                        tmp_path):
    s = DeviceStreamingSession(chunk_bytes=1 << 15)
    s.feed(small_log_bytes[: 1 << 15])
    ckpt = tmp_path / "extra.ckpt"
    s.save_checkpoint(ckpt, extra={"pos": 1234, "text_carry": b"1A"})
    r = DeviceStreamingSession.restore(ckpt)
    assert r.checkpoint_extra == {"pos": 1234, "text_carry": b"1A"}

    r.finalize()
    with pytest.raises(RuntimeError, match="already finalized"):
        r.feed(small_log_bytes[:100])
    # finalized state round-trips too (post-mortem reads)
    ckpt2 = tmp_path / "final.ckpt"
    r.save_checkpoint(ckpt2)
    r2 = DeviceStreamingSession.restore(ckpt2)
    assert r2.n_frames == r.n_frames
    with pytest.raises(RuntimeError, match="already finalized"):
        r2.feed(small_log_bytes[:100])

    m = MultiStreamingSession(2, chunk_bytes=1 << 15)
    m.finalize()
    with pytest.raises(RuntimeError, match="already finalized"):
        m.feed([b"", b""])


def test_host_streaming_checkpoint_resume(small_log_bytes, tmp_path):
    """The host-engine session (no accelerator) checkpoints and resumes with the
    same exact-parity contract as the device engine."""
    from slam_process_tpu.parallel.streaming import StreamingSession

    chunk = 1 << 15
    raw = small_log_bytes

    full = StreamingSession()
    for off in range(0, len(raw), chunk):
        full.feed(raw[off:off + chunk])
    full.finalize()

    part = StreamingSession()
    split = 100_003
    part.feed(raw[:split])
    ckpt = tmp_path / "host.ckpt"
    part.save_checkpoint(ckpt, extra={"pos": split})

    resumed = StreamingSession.restore(ckpt)
    assert resumed.checkpoint_extra == {"pos": split}
    for off in range(split, len(raw), chunk):
        resumed.feed(raw[off:off + chunk])
    resumed.finalize()

    assert resumed.n_frames == full.n_frames
    assert resumed.n_kept == full.n_kept
    assert resumed.n_groups == full.n_groups
    np.testing.assert_array_equal(resumed.filtered, full.filtered)
    ga, gb = resumed.intensity(), full.intensity()
    np.testing.assert_array_equal(ga.mean, gb.mean)
    np.testing.assert_array_equal(ga.counts, gb.counts)

    resumed2 = StreamingSession.restore(ckpt)
    resumed2.finalize()
    with pytest.raises(RuntimeError, match="already finalized"):
        resumed2.feed(raw[:100])

    # Engine mismatch fails loudly in both directions.
    with pytest.raises(ValueError, match="not a DeviceStreamingSession"):
        DeviceStreamingSession.restore(ckpt)
    dev = DeviceStreamingSession(chunk_bytes=1 << 15)
    dev.feed(raw[: 1 << 15])
    dckpt = tmp_path / "dev.ckpt"
    dev.save_checkpoint(dckpt)
    with pytest.raises(ValueError, match="not a StreamingSession"):
        StreamingSession.restore(dckpt)
