"""Device-resident streaming replay: chunked == offline exact parity.

Counterpart of tests/test_streaming.py for the on-device state machine
(parallel/streaming_device.py): decode counts, filtered rows, and the
intensity accumulators must match the offline host pipeline at every chunk
size, including the log_transform scene config.
"""

import numpy as np
import pytest

from slam_process_tpu.config import PipelineConfig, SceneConfig


@pytest.fixture(scope="module")
def offline(small_log_bytes):
    from slam_process_tpu.ops.correct import correct_frames_np
    from slam_process_tpu.ops.decode import decode_frames_np

    dec = decode_frames_np(small_log_bytes)
    res = correct_frames_np(dec.frames)
    return dec, res


@pytest.mark.parametrize("chunk_bytes", [
    pytest.param(4097, marks=pytest.mark.slow), 1 << 16,
    pytest.param(1 << 20, marks=pytest.mark.slow)])
def test_device_streaming_matches_offline(small_log_bytes, offline, chunk_bytes):
    from slam_process_tpu.parallel.streaming_device import replay_log_device

    dec, res = offline
    s = replay_log_device(small_log_bytes, chunk_bytes=chunk_bytes,
                          collect_filtered=True)
    assert not s.overflow
    assert s.n_frames == dec.valid
    assert s.n_kept == len(res.filtered)
    np.testing.assert_array_equal(s.filtered, res.filtered)

    from slam_process_tpu.ops.scene import intensity_grid_np

    grid = intensity_grid_np(
        res.filtered[:, 0], res.filtered[:, 1], res.filtered[:, 2],
        cfg=SceneConfig(keep_nan=True, fill_with_min=False),
    )
    ours = s.intensity()
    np.testing.assert_array_equal(ours.counts, grid.counts)
    np.testing.assert_allclose(ours.mean, grid.mean, rtol=1e-5, atol=1e-2,
                               equal_nan=True)


def test_device_streaming_group_count_matches_offline(small_log_bytes, offline):
    from slam_process_tpu.ops.correct import detect_groups_np
    from slam_process_tpu.parallel.streaming_device import replay_log_device

    dec, _ = offline
    n_groups = int(detect_groups_np(dec.frames[:, 1])[-1]) + 1
    s = replay_log_device(small_log_bytes, chunk_bytes=1 << 16)
    assert s.n_groups == n_groups


@pytest.mark.slow
def test_device_streaming_log_transform(small_log_bytes, offline):
    """SceneConfig.log_transform folds ln(RSS) with the RSS<=0 drop rule."""
    from slam_process_tpu.ops.scene import intensity_grid_np
    from slam_process_tpu.parallel.streaming_device import replay_log_device

    _, res = offline
    cfg = PipelineConfig(scene=SceneConfig(log_transform=True))
    s = replay_log_device(small_log_bytes, chunk_bytes=1 << 16, config=cfg)
    grid = intensity_grid_np(
        res.filtered[:, 0], res.filtered[:, 1], res.filtered[:, 2],
        cfg=SceneConfig(log_transform=True),
    )
    ours = s.intensity()
    np.testing.assert_array_equal(ours.counts, grid.counts)
    np.testing.assert_allclose(ours.mean, grid.mean, rtol=1e-5, atol=1e-5,
                               equal_nan=True)


def test_host_streaming_log_transform(small_log_bytes, offline):
    """The host state machine honors log_transform too (advisor finding)."""
    from slam_process_tpu.ops.scene import intensity_grid_np
    from slam_process_tpu.parallel.streaming import replay_log

    _, res = offline
    cfg = PipelineConfig(scene=SceneConfig(log_transform=True))
    s = replay_log(small_log_bytes, chunk_bytes=1 << 16, config=cfg)
    grid = intensity_grid_np(
        res.filtered[:, 0], res.filtered[:, 1], res.filtered[:, 2],
        cfg=SceneConfig(log_transform=True),
    )
    ours = s.intensity()
    np.testing.assert_array_equal(ours.counts, grid.counts)
    np.testing.assert_allclose(ours.mean, grid.mean, rtol=1e-12, atol=0,
                               equal_nan=True)


def test_device_streaming_fuzz_adversarial_streams():
    """Random noise + valid frames + truncation, random chunk splits:
    chunked == offline on every stream (the §5.2 sanitizer-style sweep)."""
    from slam_process_tpu.config import PipelineConfig
    from slam_process_tpu.ops.correct import correct_frames_np
    from slam_process_tpu.ops.decode import decode_frames_np
    from slam_process_tpu.parallel.streaming_device import (
        DeviceStreamingSession,
    )

    rng = np.random.default_rng(77)

    def frame(flag, ue, bs, rss, clk):
        b = [0xCC if flag else 0x33, ue & 0x3F, 0xC0 | (bs & 0x3F)]
        b += [0x40 | ((clk >> (6 * k)) & 0x3F) for k in range(5)]
        b += [0x80 | ((rss >> (6 * k)) & 0x3F) for k in range(3)]
        return b

    for trial in range(4):
        out = []
        clk = 10_000
        prev_rss = 500
        for _ in range(int(rng.integers(50, 400))):
            r = rng.random()
            if r < 0.25:                      # garbage burst
                out += rng.integers(0, 256, size=int(rng.integers(1, 30))
                                    ).tolist()
            elif r < 0.35:                    # truncated frame prefix
                f = frame(0, int(rng.integers(64)), 0x3F,
                          int(rng.integers(1 << 18)), clk)
                out += f[: int(rng.integers(1, 10))]
            else:                             # valid frame
                clk += int(rng.integers(30_000, 90_000))
                rss = int(rng.integers(1, 1 << 18))
                if rng.random() < 0.2:        # baseline pair candidate
                    out += frame(1, int(rng.integers(64)),
                                 int(rng.integers(64)), prev_rss, clk)
                else:
                    out += frame(0, int(rng.integers(64)), 0x3F, rss, clk)
                prev_rss = rss
        raw = np.asarray(out, dtype=np.uint8)

        dec = decode_frames_np(raw)
        res = correct_frames_np(dec.frames) if dec.valid else None

        s = DeviceStreamingSession(chunk_bytes=1024, group_capacity=2048,
                                   collect_filtered=True)
        off = 0
        while off < len(raw):
            step = int(rng.integers(1, 700))
            s.feed(raw[off : off + step])
            off += step
        s.finalize()

        assert s.n_frames == dec.valid, f"trial {trial}"
        if res is not None:
            assert s.n_kept == len(res.filtered), f"trial {trial}"
            np.testing.assert_array_equal(s.filtered, res.filtered,
                                          err_msg=f"trial {trial}")


def test_device_streaming_overflow_warns():
    """Exceeding a static bound must warn when results are consumed
    (capacity overruns silently truncate counts/grids otherwise)."""
    from slam_process_tpu.parallel.streaming_device import (
        DeviceStreamingSession,
    )

    def frame(ue, rss, clk):
        b = [0x33, ue & 0x3F, 0xC0 | 0x3F]
        b += [0x40 | ((clk >> (6 * k)) & 0x3F) for k in range(5)]
        b += [0x80 | ((rss >> (6 * k)) & 0x3F) for k in range(3)]
        return b

    # One monotone-UE group of 64 frames: group_capacity=16 overflows.
    out = []
    for i in range(64):
        out += frame(i % 64, 100 + i, 10_000 + 61_000 * i)
    raw = np.asarray(out, dtype=np.uint8)

    s = DeviceStreamingSession(chunk_bytes=256, group_capacity=16)
    s.feed(raw)
    s.finalize()
    with pytest.warns(RuntimeWarning, match="capacity exceeded"):
        _ = s.n_frames
    # Warned once; further reads stay quiet.
    assert s.n_kept >= 0


def test_big_open_group_straddles_window_boundary():
    """Regression (round 4): the shipped dataset's largest UE sweep group
    is 4,361 frames — above the old group_capacity=4096 default.  When
    such a group straddled a chunk-window edge, the carry silently
    dropped its tail (128 kept rows lost on log "…114913" at 1 MiB
    chunks; chunk-phase dependent, so most replays passed).  Synthesize
    a >4096-frame group forced across many window edges and require
    exact offline parity under the DEFAULT bounds."""
    from slam_process_tpu.ops.correct import correct_frames_np
    from slam_process_tpu.ops.decode import decode_frames_np
    from slam_process_tpu.parallel.streaming_device import (
        DeviceStreamingSession,
    )

    def frame(ue, rss, clk):
        b = [0x33, ue & 0x3F, 0xC0 | 0x3F]
        b += [0x40 | ((clk >> (6 * k)) & 0x3F) for k in range(5)]
        b += [0x80 | ((rss >> (6 * k)) & 0x3F) for k in range(3)]
        return b

    out = []
    for i in range(40):                       # small leading group
        out += frame(i % 64, 50 + i, 1_000 + 700 * i)
    big = 4_500                               # > the old 4096 default
    for i in range(big):                      # one huge monotone-UE group
        out += frame(i * 64 // big, 100 + i % 200, 40_000 + 700 * i)
    for i in range(40):                       # trailing group closes it
        out += frame(i % 64, 60 + i, 4_000_000 + 700 * i)
    raw = np.asarray(out, dtype=np.uint8)

    dec = decode_frames_np(raw)
    res = correct_frames_np(dec.frames)

    # 16 KiB windows: the 49.5 KB big group straddles several edges.
    s = DeviceStreamingSession(chunk_bytes=1 << 14, collect_filtered=True)
    s.feed(raw)
    s.finalize()
    assert not s.overflow
    assert s.n_frames == dec.valid
    np.testing.assert_array_equal(s.filtered, res.filtered)


@pytest.mark.slow
def test_log4_default_bounds_exact():
    """A capture whose sweep groups hold ~4.2k frames (above the old fixed
    default), pinned at the bench configuration (1 MiB chunks, default
    bounds)."""
    from slam_process_tpu.io import synth
    from slam_process_tpu.ops.correct import correct_frames_np
    from slam_process_tpu.ops.decode import decode_frames_np
    from slam_process_tpu.parallel.streaming_device import replay_log_device

    raw = synth.capture(4, 12500, 3).wire
    s = replay_log_device(raw, chunk_bytes=1 << 20, collect_filtered=True)
    assert not s.overflow
    dec = decode_frames_np(raw)
    res = correct_frames_np(dec.frames)
    assert s.n_frames == dec.valid
    np.testing.assert_array_equal(s.filtered, res.filtered)


def test_decode_jax_n_valid_masks_nonzero_padding():
    """n_valid must reject frames in the padded tail even when the padding
    bytes themselves form a decodable frame (explicit masking, not
    padding-inertness)."""
    import jax.numpy as jnp

    from slam_process_tpu.ops.decode import decode_frames_jax

    def frame(ue, rss, clk):
        b = [0x33, ue & 0x3F, 0xC0 | 0x3F]
        b += [0x40 | ((clk >> (6 * k)) & 0x3F) for k in range(5)]
        b += [0x80 | ((rss >> (6 * k)) & 0x3F) for k in range(3)]
        return b

    real = frame(3, 123, 50_000)
    ghost = frame(9, 999, 60_000)          # lives entirely in the "padding"
    buf = jnp.asarray(real + ghost, dtype=jnp.uint8)

    frames, count = decode_frames_jax(buf, capacity=4, n_valid=jnp.int32(11))
    assert int(count) == 1
    assert int(frames[0, 1]) == 3

    frames2, count2 = decode_frames_jax(buf, capacity=4)
    assert int(count2) == 2                # unmasked: both decode


@pytest.mark.slow
def test_device_streaming_emit_ring_overflow_raises(small_log_bytes):
    """A too-small emit ring means the exported table would be silently
    truncated — reading `filtered` must raise, not return partial data;
    the counts/grids stay intact and readable."""
    from slam_process_tpu.parallel.streaming_device import replay_log_device

    s = replay_log_device(small_log_bytes, chunk_bytes=1 << 16,
                          collect_filtered=True, emit_capacity=64)
    with pytest.raises(RuntimeError, match="emit ring overflowed"):
        s.filtered
    # The aggregate results are unaffected by the ring cap.
    assert s.n_frames > 64
    assert np.isfinite(s.intensity().mean).any()


def test_emit_ring_auto_grows_for_long_streams(small_log_bytes):
    """Default emit mode (no emit_capacity given) must export ANY stream
    without manual tuning: the ring auto-grows on a host-side conservative
    bound (no device reads in the feed loop).  Forced here with a tiny
    initial capacity via a long concatenated stream; parity oracle is the
    host decode+correct of the same concatenation."""
    from slam_process_tpu.ops.correct import correct_frames_np
    from slam_process_tpu.ops.decode import decode_frames_np
    from slam_process_tpu.parallel.streaming_device import (
        DeviceStreamingSession,
    )

    stream = np.concatenate([small_log_bytes] * 3)
    s = DeviceStreamingSession(chunk_bytes=1 << 15, collect_filtered=True)
    s._ecap = 1 << 10                      # shrink the initial ring so the
    s._state = s._state._replace(          # growth path actually runs
        emit_buf=np.zeros((s._emit_alloc(), 4), np.int32))
    s._build_programs()
    for off in range(0, len(stream), 1 << 15):
        s.feed(stream[off:off + (1 << 15)])
    s.finalize()
    got = s.filtered

    frames = decode_frames_np(stream).frames
    res = correct_frames_np(frames)
    assert len(got) == len(res.filtered)
    np.testing.assert_array_equal(got, res.filtered)
    assert s._ecap > 1 << 10, "growth must have happened"


@pytest.mark.slow
def test_emit_dataset_scale_single_stream():
    """One stream larger than the old fixed default (262,144 rows kept):
    every log concatenated, default auto-capacity, exact export parity."""
    from slam_process_tpu.io import synth
    from slam_process_tpu.ops.correct import correct_frames_np
    from slam_process_tpu.ops.decode import decode_frames_np
    from slam_process_tpu.parallel.streaming_device import (
        DeviceStreamingSession,
    )

    stream = np.concatenate([synth.capture(seed, 100_000, 30).wire
                             for seed in range(3)])
    s = DeviceStreamingSession(chunk_bytes=1 << 20, collect_filtered=True)
    for off in range(0, len(stream), 1 << 20):
        s.feed(stream[off:off + (1 << 20)])
    s.finalize()
    got = s.filtered
    assert len(got) > (1 << 18), "stream must exceed the old fixed default"

    frames = decode_frames_np(stream).frames
    res = correct_frames_np(frames)
    np.testing.assert_array_equal(got, res.filtered)
