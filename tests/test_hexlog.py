"""Tokenizer unit tests + byte-level vs reference-semantics equivalence."""

import numpy as np
import pytest

from slam_process_tpu.io.hexlog import tokenize_hex, tokenize_hex_reference
from tests.conftest import DEBUGDOC, LOG_NAMES


def test_basic_tokens():
    data = b"33 00 FF 74\n58 40"
    out = tokenize_hex(data)
    assert out.tolist() == [0x33, 0x00, 0xFF, 0x74, 0x58, 0x40]


def test_junk_tokens_skipped():
    # Guillemet junk (as in the shipped logs), 1/3-char tokens, non-hex.
    data = b"\xc2\xab 33 0 123 GG 7f"
    assert tokenize_hex(data).tolist() == [0x33, 0x7F]


def test_0x_prefix_accepted():
    data = b"0x33 0XAB cc"
    assert tokenize_hex(data).tolist() == [0x33, 0xAB, 0xCC]


def test_mixed_case_and_whitespace():
    data = b"  aB\tCd \r\n eF "
    assert tokenize_hex(data).tolist() == [0xAB, 0xCD, 0xEF]


def test_equivalence_random_valid_utf8():
    # Byte-level tokenization can only match the reference's
    # decode(errors='ignore') path on valid UTF-8 input, which is what real
    # logs are; random token streams (including the guillemet junk marker)
    # must agree exactly.
    rng = np.random.default_rng(0)
    tokens = [b"33", b"ff", b"AB", b"0x7f", b"0", b"123", b"GG", b"x", b"\xc2\xab"]
    seps = [b" ", b"\t", b"\n", b"\r\n", b"  "]
    for _ in range(20):
        n = int(rng.integers(200, 600))
        data = b"".join(
            tokens[rng.integers(len(tokens))] + seps[rng.integers(len(seps))]
            for _ in range(n)
        )
        np.testing.assert_array_equal(
            tokenize_hex(data), tokenize_hex_reference(data)
        )


@pytest.mark.parametrize(
    "log", LOG_NAMES, ids=lambda s: s[-20:-4]
)
def test_equivalence_on_shipped_logs(log):
    data = (DEBUGDOC / log).read_bytes()
    fast = tokenize_hex(data)
    ref = tokenize_hex_reference(data)
    np.testing.assert_array_equal(fast, ref)


def test_xlsx_roundtrip_fuzz(tmp_path):
    """Random numeric tables round-trip through the minimal xlsx layer."""
    from slam_process_tpu.io.xlsx import read_xlsx_table, write_xlsx_table

    rng = np.random.default_rng(70)
    for trial in range(5):
        rows = int(rng.integers(1, 200))
        cols = int(rng.integers(1, 8))
        data = rng.normal(size=(rows, cols)) * 10.0 ** float(rng.integers(-3, 6))
        if rng.random() < 0.5:
            data = np.rint(data)
        data[rng.random(data.shape) < 0.1] = np.nan
        names = [f"col<&>{i}" for i in range(cols)]  # needs XML escaping
        p = write_xlsx_table(tmp_path / f"t{trial}.xlsx", names, data)
        rnames, rdata = read_xlsx_table(p)
        assert rnames == names
        np.testing.assert_allclose(
            np.nan_to_num(rdata, nan=-1), np.nan_to_num(data, nan=-1),
            rtol=1e-15, atol=0,
        )


def test_parsed_reader_nan_guard(tmp_path):
    """NaN FLAG -> 0; rows with other NaN cells are dropped, not poisoned."""
    from slam_process_tpu.io.schemas import read_parsed_table
    from slam_process_tpu.io.xlsx import write_xlsx_table
    from slam_process_tpu.io.schemas import PARSED_COLUMNS

    data = np.array([
        [np.nan, 1, 2, 3, 4],      # NaN FLAG -> row kept with FLAG 0
        [1, 2, np.nan, 4, 5],      # NaN BS -> dropped
        [0, 5, 6, 7, 8],
    ])
    p = write_xlsx_table(tmp_path / "p.xlsx", PARSED_COLUMNS, data)
    out = read_parsed_table(p)
    assert out.shape == (2, 5)
    assert out[0].tolist() == [0, 1, 2, 3, 4]
    assert out[1].tolist() == [0, 5, 6, 7, 8]


def test_xlsx_permission_fallback(tmp_path, monkeypatch):
    """Locked target retries once to <stem>_out.xlsx (reference parity:
    serial_hex_to_excel.py:114-118)."""
    import zipfile as _zipfile
    from pathlib import Path

    from slam_process_tpu.io import xlsx as xlsx_mod
    from slam_process_tpu.io.xlsx import read_xlsx_table, write_xlsx_table

    target = tmp_path / "locked.xlsx"
    real_zip = _zipfile.ZipFile

    class DenyTarget:
        ZIP_DEFLATED = _zipfile.ZIP_DEFLATED

        @staticmethod
        def ZipFile(path, *a, **k):
            if Path(path).name == "locked.xlsx":
                raise PermissionError(13, "Permission denied", str(path))
            return real_zip(path, *a, **k)

    monkeypatch.setattr(xlsx_mod, "zipfile", DenyTarget)
    data = np.array([[1.0, 2.0], [3.0, 4.0]])
    out = write_xlsx_table(target, ["a", "b"], data)
    assert out == tmp_path / "locked_out.xlsx"
    names, rdata = read_xlsx_table(out)
    assert names == ["a", "b"]
    np.testing.assert_array_equal(rdata, data)
