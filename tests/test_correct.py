"""Corrector tests: the 5 reference behavioral specs, jax==numpy, golden parity."""

import numpy as np
import pytest

from slam_process_tpu.config import CorrectConfig
from slam_process_tpu.io import read_hex_log
from slam_process_tpu.ops.correct import (
    compact_filtered,
    correct_frames_jax,
    correct_frames_np,
    detect_groups_np,
    identify_baselines_np,
)
from slam_process_tpu.ops.decode import decode_frames_np
from tests.conftest import DEBUGDOC, LOG_NAMES

CYCLE, TOL, MOD = 61_000, 500, 64


def make_group():
    """The reference's synthetic sweep (bs_beam_correction.py:208-220)."""
    clk0 = 1_000_000
    rss = 42
    rows = [
        (0, 0, 10, rss, clk0),
        (1, 1, 12, rss, clk0 + 100),
        (0, 2, 99, rss, clk0 + CYCLE + 50),
        (0, 3, 99, rss, clk0 + 2 * CYCLE - 480),
        (0, 4, 99, rss, clk0 + 3 * CYCLE + 600),
        (0, 5, 99, rss, clk0 - CYCLE + 100),
    ]
    return np.asarray(rows, dtype=np.int64)


def test_baseline_identification():
    f = make_group()
    gid = detect_groups_np(f[:, 1])
    b_gid, clk_b, bs_b = identify_baselines_np(f[:, 0], f[:, 3], f[:, 2], f[:, 4], gid)
    assert len(b_gid) == 1
    assert clk_b[0] == f[0, 4]
    assert bs_b[0] == f[1, 2]


def test_correction_logic():
    f = make_group()
    res = correct_frames_np(f)
    assert res.corrected_bs[1] == f[1, 2]          # FLAG=1 keeps its BS
    assert res.corrected_bs[2] == (12 + 1) % MOD
    assert res.corrected_bs[3] == (12 + 2) % MOD


def test_boundary_tolerance():
    clk0 = 5_000_000
    f = np.asarray(
        [
            (0, 0, 3, 7, clk0),
            (1, 1, 8, 7, clk0 + 10),
            (0, 2, 0, 7, clk0 + CYCLE + TOL),
            (0, 3, 0, 7, clk0 + CYCLE + TOL + 1),
        ],
        dtype=np.int64,
    )
    res = correct_frames_np(f)
    assert res.corrected_bs[2] == (8 + 1) % MOD
    assert res.corrected_bs[3] == f[3, 2]          # out of tolerance: raw BS


def test_negative_diff():
    clk0 = 7_000_000
    f = np.asarray(
        [
            (0, 0, 60, 13, clk0),
            (1, 1, 5, 13, clk0 + 1),
            (0, 2, 0, 13, clk0 - CYCLE + 10),
        ],
        dtype=np.int64,
    )
    res = correct_frames_np(f)
    assert res.corrected_bs[2] == (5 - 1) % MOD


def test_filter_only_corrected_rows():
    clk0 = 2_000_000
    f = np.asarray(
        [
            (0, 0, 10, 21, clk0),
            (1, 1, 12, 21, clk0 + 50),
            (0, 2, 99, 21, clk0 + CYCLE + 20),
            (0, 3, 99, 21, clk0 + CYCLE + TOL + 10),
        ],
        dtype=np.int64,
    )
    res = correct_frames_np(f)
    # NOTE: the reference's embedded test asserts 1 filtered row, but the
    # reference IMPLEMENTATION itself emits 2 (verified by running
    # `bs_beam_correction.py --run-tests`, which fails 2 != 1): row 0 is a
    # FLAG=0 row at d=0 from the baseline (resid 0 <= TOL), so it is
    # corrected too.  We match the implementation (which produced the golden
    # _filtered artifacts), not the stale test.
    assert res.filtered.shape == (2, 4)
    assert res.filtered[0].tolist() == [0, 12, 21, clk0]
    assert res.filtered[1].tolist() == [2, 13, 21, clk0 + CYCLE + 20]


def test_min_residual_baseline_selection():
    # Two baselines; the closer-residual one must win; tie -> first baseline.
    clk0 = 1_000_000
    f = np.asarray(
        [
            (0, 0, 10, 5, clk0),
            (1, 1, 12, 5, clk0 + 100),         # baseline A: clk_b=clk0, bs=12
            (0, 2, 99, 6, clk0 + 200),
            (1, 3, 30, 6, clk0 + 300),          # baseline B: clk_b=clk0+200, bs=30
            (0, 4, 99, 7, clk0 + CYCLE + 190),  # resid A=190, resid B=10 -> B
            (0, 5, 99, 8, clk0 + CYCLE + 100),  # resid A=100, resid B=100 ->A first
        ],
        dtype=np.int64,
    )
    res = correct_frames_np(f)
    assert res.corrected_bs[4] == (30 + 1) % MOD
    assert res.corrected_bs[5] == (12 + 1) % MOD


def test_group_boundary_isolation():
    # Baselines do not leak across sweep groups (UE decrease).
    clk0 = 1_000_000
    f = np.asarray(
        [
            (0, 0, 10, 5, clk0),
            (1, 1, 12, 5, clk0 + 100),
            (0, 0, 99, 6, clk0 + CYCLE + 10),  # new group (UE 1 -> 0), no baseline
        ],
        dtype=np.int64,
    )
    res = correct_frames_np(f)
    gid = detect_groups_np(f[:, 1])
    assert gid.tolist() == [0, 0, 1]
    assert res.corrected_bs[2] == 99  # uncorrected fallback
    # Only row 0 (group 0, corrected at d=0) survives the filter; the
    # group-1 row has no baseline and is dropped.
    assert res.filtered.shape[0] == 1
    assert res.filtered[0, 0] == 0


def test_jax_matches_np_synthetic():
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    rows = []
    clk = 1_000_000
    for _ in range(8):  # 8 sweeps
        prev_rss = None
        for ue in range(0, 64, int(rng.integers(1, 4))):
            clk += int(rng.integers(800, 1300))
            rss = int(rng.integers(1, 1 << 18))
            if rng.random() < 0.08 and prev_rss is not None:
                rows.append((1, ue, int(rng.integers(64)), prev_rss, clk))
            else:
                rows.append((0, ue, 63, rss, clk))
            prev_rss = rows[-1][3]
    f = np.asarray(rows, dtype=np.int64)
    ref = correct_frames_np(f)

    pad = 32  # test padding discipline
    fp = np.concatenate([f, np.zeros((pad, 5), np.int64)]).astype(np.int32)
    fn = jax.jit(
        lambda x, c: correct_frames_jax(x, c, max_groups=32, max_baselines_per_group=64)
    )
    corrected, keep, overflow = fn(jnp.asarray(fp), jnp.int32(len(f)))
    assert not bool(overflow)
    np.testing.assert_array_equal(np.asarray(corrected)[: len(f)], ref.corrected_bs)
    np.testing.assert_array_equal(np.asarray(keep)[: len(f)], ref.keep)
    assert not np.any(np.asarray(keep)[len(f):])
    filt = compact_filtered(fp, corrected, keep)
    np.testing.assert_array_equal(filt, ref.filtered)


@pytest.fixture(scope="module")
def decoded_small(small_log_bytes):
    return decode_frames_np(small_log_bytes).frames


def test_golden_filtered_parity_164520(decoded_small, small_filtered_golden):
    res = correct_frames_np(decoded_small)
    assert res.filtered.shape == small_filtered_golden.shape
    np.testing.assert_array_equal(res.filtered, small_filtered_golden)


def test_golden_filtered_parity_020606(parsed_golden_020606, filtered_golden_020606):
    res = correct_frames_np(parsed_golden_020606)
    assert res.filtered.shape == filtered_golden_020606.shape
    np.testing.assert_array_equal(res.filtered, filtered_golden_020606)


def test_jax_golden_parity_020606(parsed_golden_020606, filtered_golden_020606):
    import jax
    import jax.numpy as jnp

    f = parsed_golden_020606
    fn = jax.jit(lambda x, c: correct_frames_jax(x, c))
    corrected, keep, _overflow = fn(jnp.asarray(f, dtype=jnp.int32), jnp.int32(len(f)))
    filt = compact_filtered(f, corrected, keep)
    np.testing.assert_array_equal(filt, filtered_golden_020606)


@pytest.mark.slow
@pytest.mark.parametrize(
    "log", LOG_NAMES, ids=lambda s: s[-20:-4]
)
def test_all_logs_filtered_parity(log):
    from slam_process_tpu.io.schemas import read_filtered_table

    stem = log.replace("256-0x16-", "").replace(".txt", "")
    golden_path = DEBUGDOC / f"{stem}_filtered.xlsx"
    if not golden_path.exists():
        pytest.skip("no shipped filtered artifact")
    b = read_hex_log(DEBUGDOC / log, engine="numpy")
    frames = decode_frames_np(b).frames
    res = correct_frames_np(frames)
    golden = read_filtered_table(golden_path)
    assert res.filtered.shape == golden.shape
    np.testing.assert_array_equal(res.filtered, golden)


def test_jax_overflow_detection():
    import jax
    import jax.numpy as jnp

    # 6 sweeps of 2 rows -> overflows max_groups=4.
    rows = []
    clk = 1_000_000
    for g in range(6):
        clk += 2000
        rows.append((0, 0, 63, 5, clk))
        clk += 2000
        rows.append((0, 1, 63, 5, clk))
    f = np.asarray(rows, dtype=np.int32)
    fn = jax.jit(lambda x, c: correct_frames_jax(x, c, max_groups=4,
                                                 max_baselines_per_group=8))
    _, _, overflow = fn(jnp.asarray(f), jnp.int32(len(f)))
    assert bool(overflow)

    # Baseline overflow: 4 baselines in one group with bmax=2.  Each
    # (FLAG=0, FLAG=1) pair with equal RSS and increasing UE is a baseline.
    rows = []
    for i in range(4):
        rows.append((0, 2 * i, 10, 5 + i, clk + 100 * i))
        rows.append((1, 2 * i + 1, 12, 5 + i, clk + 100 * i + 50))
    f = np.asarray(rows, dtype=np.int32)
    fn2 = jax.jit(lambda x, c: correct_frames_jax(x, c, max_groups=8,
                                                  max_baselines_per_group=2))
    _, _, overflow2 = fn2(jnp.asarray(f), jnp.int32(len(f)))
    assert bool(overflow2)


def _gen_adversarial_frames(rng):
    """Adversarial frame generator: single-row groups, groups that are ALL
    baseline markers, equal-RSS chains (consecutive baseline candidates),
    CLK values straddling the 30-bit wrap, and exact-TOL residuals."""
    rows = []
    clk = int(rng.integers(0, 1 << 30))
    prev_rss = 777
    for _g in range(int(rng.integers(3, 20))):
        style = rng.random()
        n_rows = 1 if style < 0.15 else int(rng.integers(2, 40))
        ue = 0
        for i in range(n_rows):
            ue = min(63, ue + int(rng.integers(0, 3)))
            # CLK: mostly near-cycle steps, sometimes exact-TOL edges,
            # sometimes wild jumps (incl. wrapping the 30-bit counter).
            r = rng.random()
            if r < 0.6:
                clk += 61_000 + int(rng.integers(-400, 400))
            elif r < 0.75:
                clk += 61_000 + (500 if rng.random() < 0.5 else 501)
            else:
                clk = int(rng.integers(0, 1 << 30))
            rss = int(rng.integers(0, 1 << 18))
            if style >= 0.85 or rng.random() < 0.25:
                # baseline candidate: FLAG=1 with the previous row's RSS
                # (sometimes a chain of them; only 0->1 transitions count)
                rows.append((1, ue, int(rng.integers(64)), prev_rss, clk))
            else:
                rows.append((0, ue, 63, rss, clk))
            prev_rss = rows[-1][3]
        # force the group boundary: next group's first UE below current
        ue_start = 0
    return np.asarray(rows, dtype=np.int64)


@pytest.mark.parametrize("seed", [11, 12, 13, 14, 15])
def test_jax_matches_np_adversarial_fuzz(seed):
    """The jitted corrector must match the host oracle bit-for-bit on
    corrected/keep/filtered under the adversarial generator."""
    import jax
    import jax.numpy as jnp

    f = _gen_adversarial_frames(np.random.default_rng(seed))
    ref = correct_frames_np(f)

    fp = np.concatenate([f, np.zeros((17, 5), np.int64)]).astype(np.int32)
    fn = jax.jit(lambda x, c: correct_frames_jax(
        x, c, max_groups=64, max_baselines_per_group=64))
    corrected, keep, overflow = fn(jnp.asarray(fp), jnp.int32(len(f)))
    assert not bool(overflow)
    np.testing.assert_array_equal(np.asarray(corrected)[: len(f)],
                                  ref.corrected_bs)
    np.testing.assert_array_equal(np.asarray(keep)[: len(f)], ref.keep)
    filt = compact_filtered(fp, corrected, keep)
    np.testing.assert_array_equal(filt, ref.filtered)


@pytest.mark.parametrize("seed", [31, 32, 33, 34])
def test_rows_layout_matches_np_adversarial_fuzz(seed):
    """correct_rows_jax on the MASKED-ROW layout (frames scattered at
    random positions with gaps, decode_rows_jax's gather-free output shape)
    must equal the host oracle at the valid positions and never keep an
    invalid row."""
    import jax
    import jax.numpy as jnp

    from slam_process_tpu.ops.correct import correct_rows_jax

    rng = np.random.default_rng(seed)
    f = _gen_adversarial_frames(rng)
    ref = correct_frames_np(f)

    # Scatter into a 2-4x larger masked-row array at increasing positions.
    r = len(f) * int(rng.integers(2, 5)) + int(rng.integers(0, 7))
    pos = np.sort(rng.choice(r, size=len(f), replace=False))
    rows = np.zeros((r, 5), dtype=np.int32)
    # Poison invalid rows with junk fields: they must never influence the
    # result (only `valid` gates them).
    rows[:, :] = rng.integers(0, 1 << 18, size=(r, 5))
    rows[:, 0] = rng.integers(0, 2, size=r)
    valid = np.zeros(r, dtype=bool)
    rows[pos] = f.astype(np.int32)
    valid[pos] = True

    fn = jax.jit(lambda x, v: correct_rows_jax(
        x, v, max_groups=64, max_baselines_per_group=64))
    corrected, keep, overflow = fn(jnp.asarray(rows), jnp.asarray(valid))
    corrected = np.asarray(corrected)
    keep = np.asarray(keep)
    assert not bool(overflow)
    assert not np.any(keep & ~valid), "kept an invalid row"
    np.testing.assert_array_equal(corrected[pos], ref.corrected_bs)
    np.testing.assert_array_equal(keep[pos], ref.keep)
    filt = compact_filtered(rows, corrected, keep)
    np.testing.assert_array_equal(filt, ref.filtered)


def test_rows_layout_all_invalid():
    """correct_rows_jax on an all-invalid table: nothing kept, nothing
    corrected, no overflow — junk field values never leak through."""
    import jax
    import jax.numpy as jnp

    from slam_process_tpu.ops.correct import correct_rows_jax

    rng = np.random.default_rng(0)
    rows = rng.integers(0, 1 << 20, (64, 5)).astype(np.int32)
    corrected, keep, overflow = jax.jit(
        lambda x, v: correct_rows_jax(x, v, max_groups=8,
                                      max_baselines_per_group=8)
    )(jnp.asarray(rows), jnp.zeros(64, bool))
    assert not np.asarray(keep).any()
    assert not bool(overflow)
    np.testing.assert_array_equal(np.asarray(corrected), rows[:, 2])


def test_rows_layout_single_valid_row():
    """One lone frame: opens a group, no baseline possible, kept=False
    (FLAG=0 rows without a correction are filtered, matching the
    reference's corrected-rows-only output)."""
    import jax.numpy as jnp

    from slam_process_tpu.ops.correct import correct_rows_jax

    rows = np.zeros((16, 5), np.int32)
    rows[7] = [0, 3, 63, 500, 12345]
    valid = np.zeros(16, bool)
    valid[7] = True
    corrected, keep, overflow = correct_rows_jax(
        jnp.asarray(rows), jnp.asarray(valid), max_groups=4,
        max_baselines_per_group=4)
    assert not np.asarray(keep).any()
    assert not bool(overflow)


def test_cli_run_tests_self_test(capsys):
    """cli correct --run-tests is a drop-in for the reference's
    bs_beam_correction.py --run-tests (whose own suite is stale —
    REFERENCE_NOTES §1; ours matches the implementation semantics)."""
    from slam_process_tpu.ops.correct import self_test

    assert self_test(verbose=False) is True

    from slam_process_tpu.pipeline.cli import main

    with pytest.raises(SystemExit) as e:
        main(["correct", "--run-tests"])
    assert e.value.code == 0
