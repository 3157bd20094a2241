"""Native hexscan vs numpy tokenizer equivalence + performance sanity."""

import time

import numpy as np
import pytest

from slam_process_tpu.io.hexlog import tokenize_hex
from tests.conftest import DEBUGDOC, LOG_NAMES, SMALL_LOG

hexscan = pytest.importorskip("slam_process_tpu.runtime.hexscan")

if not hexscan.available():
    pytest.skip("no C toolchain available", allow_module_level=True)


def test_native_matches_numpy_on_log():
    data = SMALL_LOG.read_bytes()
    np.testing.assert_array_equal(hexscan.tokenize(data), tokenize_hex(data))


def test_native_edge_cases():
    cases = [
        b"", b" ", b"3", b"33", b"0x33 0XAB", b"GG zz 12",
        b"\xc2\xab 33 00 FF", b"ab\ncd\tef  ", b"123 4567 0xZZ 0x1",
    ]
    for data in cases:
        np.testing.assert_array_equal(
            hexscan.tokenize(data), tokenize_hex(data), err_msg=repr(data)
        )


def test_native_random_token_streams():
    rng = np.random.default_rng(40)
    tokens = [b"33", b"ff", b"AB", b"0x7f", b"0", b"123", b"GG", b"\xc2\xab"]
    seps = [b" ", b"\t", b"\n", b"\r\n"]
    for _ in range(10):
        data = b"".join(
            tokens[rng.integers(len(tokens))] + seps[rng.integers(len(seps))]
            for _ in range(int(rng.integers(100, 400)))
        )
        np.testing.assert_array_equal(hexscan.tokenize(data), tokenize_hex(data))


def test_native_simd_blocks_and_resync():
    """Streams long enough for the AVX-512 block path (192-byte blocks),
    with mid-stream irregularities that force scalar resync at every
    alignment: the SIMD fast path must bail for one token and re-engage
    at the next whitespace boundary, never mis-emitting."""
    rng = np.random.default_rng(7)
    # Pure regular long stream (multiple blocks + odd tail).
    for n_tok in (64, 65, 640, 641, 1000):
        vals = rng.integers(0, 256, n_tok)
        data = b" ".join(b"%02X" % int(v) for v in vals)
        for suffix in (b"", b" ", b"\n"):
            np.testing.assert_array_equal(
                hexscan.tokenize(data + suffix), tokenize_hex(data + suffix))
    # Junk planted at every offset inside a block span.
    base = b" ".join(b"%02X" % int(v) for v in rng.integers(0, 256, 256)) + b" "
    for pos in range(0, 384, 7):
        for junk in (b"zz ", b"0x41 ", b"1 ", b"  ", b"\xc2\xab "):
            data = base[:pos] + junk + base[pos:]
            np.testing.assert_array_equal(
                hexscan.tokenize(data), tokenize_hex(data),
                err_msg=f"pos={pos} junk={junk!r}")


@pytest.mark.slow
def test_native_all_logs_and_speed():
    total_bytes = 0
    t_native = 0.0
    for p in (DEBUGDOC / n for n in LOG_NAMES):
        data = p.read_bytes()
        total_bytes += len(data)
        t0 = time.perf_counter()
        nat = hexscan.tokenize(data)
        t_native += time.perf_counter() - t0
        np.testing.assert_array_equal(nat, tokenize_hex(data))
    rate = total_bytes / t_native / 1e6
    assert rate > 200, f"native tokenizer too slow: {rate:.0f} MB/s"
