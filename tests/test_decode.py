"""Decoder tests: wire-format units, greedy==mask theorem, golden parity."""

import numpy as np
import pytest

from slam_process_tpu.io import read_hex_log
from slam_process_tpu.ops.decode import (
    decode_frames_greedy_np,
    decode_frames_jax,
    decode_frames_np,
    frame_capacity,
    frame_start_mask,
)
from tests.conftest import DEBUGDOC, LOG_NAMES


def make_frame(flag=0x33, ue=5, bs=0x3F, clk=12345, rss=54321):
    """Hand-build one 11-byte frame per serial_hex_to_excel_v3.py:60-97."""
    out = [flag, 0x00 | (ue & 0x3F), 0xC0 | (bs & 0x3F)]
    for k in range(5):
        out.append(0x40 | ((clk >> (6 * k)) & 0x3F))
    for k in range(3):
        out.append(0x80 | ((rss >> (6 * k)) & 0x3F))
    return out


def test_single_frame_fields():
    b = np.array(make_frame(flag=0xCC, ue=7, bs=9, clk=0x2345_6789 & 0x3FFFFFFF,
                            rss=0x2ABCD & 0x3FFFF), dtype=np.uint8)
    res = decode_frames_np(b)
    assert res.valid == 1 and res.discarded == 0
    flag, ue, bs, rss, clk = res.frames[0]
    assert (flag, ue, bs) == (1, 7, 9)
    assert clk == 0x23456789 & 0x3FFFFFFF
    assert rss == 0x2ABCD & 0x3FFFF


def test_flag_values():
    b33 = np.array(make_frame(flag=0x33), dtype=np.uint8)
    bcc = np.array(make_frame(flag=0xCC), dtype=np.uint8)
    assert decode_frames_np(b33).frames[0, 0] == 0
    assert decode_frames_np(bcc).frames[0, 0] == 1


def test_resync_on_corrupt_tag():
    # A flag byte whose UE tag byte is wrong forces +1 resync, then a good
    # frame is still found.
    good = make_frame(ue=3)
    b = np.array([0x33, 0xFF] + good, dtype=np.uint8)  # 0xFF is not UE class
    res = decode_frames_np(b)
    assert res.valid == 1
    assert res.frames[0, 1] == 3
    assert res.discarded == 1  # the corrupt flag at position 0


def test_truncated_tail_discard_and_break():
    good = make_frame()
    b = np.array(good + [0x33, 0x00], dtype=np.uint8)  # flag with <11 left
    res = decode_frames_np(b)
    assert res.valid == 1
    assert res.discarded == 1


def test_interior_flag_bytes_not_frames():
    # UE byte 0x33 and BS byte 0xCC are legal field values AND flag bytes;
    # they must not spawn frames inside a taken frame.
    b = np.array(make_frame(ue=0x33 & 0x3F, bs=0x0C) * 3, dtype=np.uint8)
    assert b[1] == 0x33 and b[2] == 0xCC
    res = decode_frames_np(b)
    assert res.valid == 3
    assert res.discarded == 0


def test_greedy_equals_mask_random():
    rng = np.random.default_rng(42)
    for _ in range(30):
        # Mix of random junk and real frames to stress resync behavior.
        chunks = []
        for _ in range(rng.integers(1, 20)):
            if rng.random() < 0.5:
                chunks.extend(make_frame(ue=int(rng.integers(64)),
                                         bs=int(rng.integers(64)),
                                         clk=int(rng.integers(1 << 30)),
                                         rss=int(rng.integers(1 << 18))))
            else:
                chunks.extend(rng.integers(0, 256, rng.integers(1, 30)).tolist())
        b = np.array(chunks, dtype=np.uint8)
        fast = decode_frames_np(b)
        slow = decode_frames_greedy_np(b)
        np.testing.assert_array_equal(fast.frames, slow.frames)
        assert fast.valid == slow.valid
        assert fast.discarded == slow.discarded


def test_min_start_spacing_theorem(small_log_bytes):
    ok = frame_start_mask(small_log_bytes)
    starts = np.nonzero(ok)[0]
    assert np.all(np.diff(starts) >= 11)


def test_golden_parity_small_log(small_log_bytes, small_parsed_golden):
    res = decode_frames_np(small_log_bytes)
    assert res.frames.shape == small_parsed_golden.shape
    np.testing.assert_array_equal(res.frames, small_parsed_golden)


def test_golden_parity_020606(parsed_golden_020606):
    b = read_hex_log(DEBUGDOC / "Serial Debug 2026-02-06 091211.txt",
                     engine="numpy")
    res = decode_frames_np(b)
    np.testing.assert_array_equal(res.frames, parsed_golden_020606)


def test_jax_decode_matches_np(small_log_bytes):
    import jax
    import jax.numpy as jnp

    b = small_log_bytes
    cap = frame_capacity(len(b))
    fn = jax.jit(lambda x: decode_frames_jax(x, capacity=cap))
    frames, count = fn(jnp.asarray(b))
    ref = decode_frames_np(b)
    count = int(count)
    assert count == ref.valid
    np.testing.assert_array_equal(np.asarray(frames)[:count], ref.frames)
    # Padding rows are zero-filled.
    assert not np.any(np.asarray(frames)[count:])


def test_decode_rows_matches_np(small_log_bytes):
    """Gather-free masked-row decode: packing the valid rows reproduces the
    dense numpy decode exactly, and invalid rows are all-zero."""
    import jax.numpy as jnp

    from slam_process_tpu.ops.decode import decode_rows_jax

    rows, valid, count = decode_rows_jax(jnp.asarray(small_log_bytes))
    ref = decode_frames_np(small_log_bytes)
    rows = np.asarray(rows)
    valid = np.asarray(valid)
    assert int(count) == ref.valid
    assert int(valid.sum()) == ref.valid
    np.testing.assert_array_equal(rows[valid], ref.frames)
    assert not np.any(rows[~valid])
    assert rows.shape[0] == -(-len(small_log_bytes) // 11)


def test_decode_rows_greedy_equivalence_synthetic():
    import jax.numpy as jnp

    from slam_process_tpu.ops.decode import decode_rows_jax

    rng = np.random.default_rng(13)
    chunks = []
    for _ in range(60):
        if rng.random() < 0.6:
            chunks.extend(make_frame(ue=int(rng.integers(64))))
        else:
            chunks.extend(rng.integers(0, 256, rng.integers(1, 25)).tolist())
    b = np.array(chunks, dtype=np.uint8)
    rows, valid, count = decode_rows_jax(jnp.asarray(b))
    ref = decode_frames_greedy_np(b)
    assert int(count) == ref.valid
    np.testing.assert_array_equal(np.asarray(rows)[np.asarray(valid)],
                                  ref.frames)


def test_jax_decode_greedy_equivalence_synthetic():
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    chunks = []
    for _ in range(50):
        if rng.random() < 0.6:
            chunks.extend(make_frame(ue=int(rng.integers(64))))
        else:
            chunks.extend(rng.integers(0, 256, rng.integers(1, 25)).tolist())
    b = np.array(chunks, dtype=np.uint8)
    frames, count = decode_frames_jax(jnp.asarray(b), capacity=frame_capacity(len(b)))
    ref = decode_frames_greedy_np(b)
    assert int(count) == ref.valid
    np.testing.assert_array_equal(np.asarray(frames)[: ref.valid], ref.frames)


@pytest.mark.slow
@pytest.mark.parametrize(
    "log", LOG_NAMES, ids=lambda s: s[-20:-4]
)
def test_all_logs_decode_and_spacing(log):
    b = read_hex_log(DEBUGDOC / log, engine="numpy")
    ok = frame_start_mask(b)
    starts = np.nonzero(ok)[0]
    assert np.all(np.diff(starts) >= 11)
    res = decode_frames_np(b)
    assert res.valid == starts.size
    assert res.valid > 10_000


def test_decode_rows_n_valid_boundary():
    """n_valid masking: a frame needs its FULL 11-byte window inside
    b[:n_valid] — exactly at the boundary decodes, one byte short does
    not, and bytes past n_valid never produce frames even when they hold
    a valid frame."""
    import jax.numpy as jnp

    from slam_process_tpu.ops.decode import decode_rows_jax

    f1 = make_frame(ue=1, clk=1000)
    f2 = make_frame(ue=2, clk=2000)
    b = np.array(f1 + f2, dtype=np.uint8)

    # Full window of frame 1 exactly inside: decodes.
    _, valid, count = decode_rows_jax(jnp.asarray(b), n_valid=jnp.int32(11))
    assert int(count) == 1
    # One byte short: rejected.
    _, _, count = decode_rows_jax(jnp.asarray(b), n_valid=jnp.int32(10))
    assert int(count) == 0
    # Frame 2 is real data but lies past n_valid: never decoded.
    rows, valid, count = decode_rows_jax(jnp.asarray(b),
                                         n_valid=jnp.int32(12))
    assert int(count) == 1
    np.testing.assert_array_equal(
        np.asarray(rows)[np.asarray(valid)][:, 1], [1])


def test_decode_rows_empty_and_all_junk():
    import jax.numpy as jnp

    from slam_process_tpu.ops.decode import decode_rows_jax

    rows, valid, count = decode_rows_jax(jnp.zeros(33, jnp.uint8))
    assert int(count) == 0 and not np.asarray(valid).any()
    assert not np.any(np.asarray(rows))
