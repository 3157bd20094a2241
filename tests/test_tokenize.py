"""Device stride-3 tokenizer: equivalence with the reference tokenizer and
fallback behavior on every stream shape that can break the stride assumption.
"""


import numpy as np
import pytest

from slam_process_tpu.io.hexlog import tokenize_hex_reference
from slam_process_tpu.ops.tokenize import (
    prepare_text,
    stride3_offset,
    text_bucket,
    tokenize_device,
    tokenize_stride3_jax,
)
from tests.conftest import DEBUGDOC, LOG_NAMES, SMALL_LOG


def _device_tok(data: bytes):
    return tokenize_device(data)


def test_small_log_matches_reference():
    data = SMALL_LOG.read_bytes()
    got, used_device = _device_tok(data)
    assert used_device, "shipped logs are stride-3 regular"
    ref = tokenize_hex_reference(data)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.slow
@pytest.mark.parametrize("path", [str(DEBUGDOC / n) for n in LOG_NAMES])
def test_all_logs_match_reference(path):
    data = open(path, "rb").read()
    got, used_device = _device_tok(data)
    assert used_device
    np.testing.assert_array_equal(got, tokenize_hex_reference(data))


def _assert_equiv(data: bytes, expect_device: bool):
    got, used_device = _device_tok(data)
    assert used_device == expect_device
    np.testing.assert_array_equal(got, tokenize_hex_reference(data))


def test_junk_prefix_like_shipped_logs():
    _assert_equiv("\xab ".encode("utf-8") + b"33 00 FF 74 5C", True)


def test_plain_regular_stream_tail_variants():
    _assert_equiv(b"33 00 FF", True)        # rem == 2: no trailing separator
    _assert_equiv(b"33 00 FF ", True)       # rem == 0
    _assert_equiv(b"33 00 FF 7", True)      # rem == 1: lone-char token skipped
    _assert_equiv(b"33 00 FF \n", True)     # newline separator then pad


def test_0x_prefixed_tokens_take_fallback():
    # 4-char tokens break the stride; the flag must catch it mid-stream.
    _assert_equiv(b"33 00 0x41 74", False)
    # ... and at the head (stride3_offset finds the 0x token first; the
    # 'x' fails the hex check on device).
    _assert_equiv(b"0x33 00 FF", False)


def test_double_space_takes_fallback():
    _assert_equiv(b"33 00  FF 74", False)


def test_mid_stream_junk_takes_fallback():
    _assert_equiv(b"33 00 ZZ 74 5C", False)
    _assert_equiv(b"33 00 F 74 5C", False)
    _assert_equiv(b"33 00 FF1 74", False)


def test_junk_only_and_empty_streams():
    _assert_equiv(b"", False)
    _assert_equiv(b"zz yy \xc2\xab", False)


def test_long_junk_head_takes_fallback():
    # First valid token beyond the scan window -> host path, still correct.
    data = b"z" * 5000 + b" 33 00 FF"
    assert stride3_offset(data) is None
    _assert_equiv(data, False)


def test_run_truncated_by_scan_window_is_not_misparsed():
    # A 2-hex-digit PREFIX of a longer run straddling the window boundary
    # must not be taken as a token start.
    data = b"z" * 4095 + b"33" + b"3 " + b"41 42"
    _assert_equiv(data, False)


def test_fuzz_regular_streams_match_reference():
    rng = np.random.default_rng(0)
    for _ in range(10):
        n = int(rng.integers(1, 300))
        toks = rng.integers(0, 256, n)
        data = b" ".join(b"%02X" % int(v) for v in toks)
        if rng.integers(2):
            data = "\xab ".encode("utf-8") + data
        if rng.integers(2):
            data += b" "
        _assert_equiv(data, True)


def test_prepare_text_and_bucket_invariants():
    data = b"33 00 FF"
    p = stride3_offset(data)
    assert p == 0
    target = text_bucket(len(data))
    assert target % 3 == 0 and target >= len(data)
    text, n_text = prepare_text(data, p, target)
    assert n_text == len(data)
    assert (text[n_text:] == 0x20).all()


def test_stride3_jax_zeroes_padding_tokens():
    import jax
    import jax.numpy as jnp

    data = b"CC 01 C1 41 41 41 41 41 81 81 81 "
    text, n_text = prepare_text(data, 0, 66)
    b, n_tok, regular = jax.jit(tokenize_stride3_jax)(
        jnp.asarray(text), jnp.int32(n_text))
    assert bool(regular) and int(n_tok) == 11
    b = np.asarray(b)
    np.testing.assert_array_equal(b[:11], tokenize_hex_reference(data))
    assert (b[11:] == 0).all(), "padding must decode to inert non-flag bytes"


def test_fused_text_pipeline_matches_byte_pipeline():
    from slam_process_tpu.io.hexlog import tokenize_hex
    from slam_process_tpu.pipeline.device import (
        run_session_from_text, run_session_on_device,
    )

    data = SMALL_LOG.read_bytes()
    res = run_session_from_text(data)
    assert bool(res.tokenize_regular)
    byte_out = run_session_on_device(tokenize_hex(data))
    assert int(res.out.n_frames) == int(byte_out.n_frames)
    assert int(res.out.n_kept) == int(byte_out.n_kept)
    np.testing.assert_array_equal(
        np.asarray(res.out.counts), np.asarray(byte_out.counts))
    ours = np.asarray(res.out.mean_grid)
    theirs = np.asarray(byte_out.mean_grid)
    both = np.isfinite(ours) & np.isfinite(theirs)
    assert (np.isfinite(ours) == np.isfinite(theirs)).all()
    np.testing.assert_allclose(ours[both], theirs[both], rtol=0, atol=0)


def test_fused_text_pipeline_fallback_on_irregular_stream():
    from slam_process_tpu.pipeline.device import run_session_from_text

    # Mid-stream 0x token: device flag trips, host fallback result returned.
    data = b"CC 01 C1 41 41 41 0x41 41 81 81 81"
    res = run_session_from_text(data)
    assert not bool(res.tokenize_regular)
    assert int(res.out.n_frames) == 1
