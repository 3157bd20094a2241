"""The seeded capture generator (io/synth.py) against the in-repo oracles.

A generated capture must be what the testbed's serial dumps are: v3 frames
as hex text that the reference tokenizer and decoder read back exactly, a
61,000-tick BS dwell, 2-4% baseline markers, junk and broken frames that
force resync — and its planted truth must be recoverable by the corrector.
"""

import numpy as np
import pytest

from slam_process_tpu.config import CorrectConfig
from slam_process_tpu.io import synth
from slam_process_tpu.io.hexlog import tokenize_hex, tokenize_hex_reference
from slam_process_tpu.ops.correct import correct_frames_np, detect_groups_np
from slam_process_tpu.ops.decode import decode_frames_np


@pytest.fixture(scope="module")
def cap():
    return synth.capture(7, 6000, 3)


def test_same_seed_same_bytes():
    a, b = synth.capture(3, 3000, 2), synth.capture(3, 3000, 2)
    assert a.name == b.name
    np.testing.assert_array_equal(a.wire, b.wire)
    np.testing.assert_array_equal(a.frames, b.frames)
    assert not np.array_equal(a.wire, synth.capture(4, 3000, 2).wire)


def test_text_round_trips_through_the_reference_tokenizer(cap):
    text = cap.text()
    assert text.startswith("« ".encode())            # the dumps' junk head
    np.testing.assert_array_equal(tokenize_hex(text), cap.wire)
    np.testing.assert_array_equal(tokenize_hex_reference(text), cap.wire)


def test_wire_decodes_to_the_planted_frame_table(cap):
    dec = decode_frames_np(cap.wire)
    assert dec.valid == len(cap.frames) == 6000
    np.testing.assert_array_equal(dec.frames, cap.frames)


def test_broken_frames_force_resync():
    c = synth.capture(1, 20000, 6, broken_rate=5e-3)
    assert len(c.wire) > 11 * len(c.frames)          # extra prefix bytes
    dec = decode_frames_np(c.wire)
    assert dec.discarded > 0
    np.testing.assert_array_equal(dec.frames, c.frames)


def test_wire_statistics(cap):
    flag, ue, bs, rss, clk = (cap.frames[:, i] for i in range(5))
    bl = flag == 1
    assert 0.02 <= bl.mean() <= 0.04 + 1e-3
    # A baseline repeats the previous frame's RSS and carries the true BS.
    idx = np.nonzero(bl)[0]
    np.testing.assert_array_equal(rss[idx], rss[idx - 1])
    assert np.all(flag[idx - 1] == 0)
    np.testing.assert_array_equal(bs[idx], cap.true_bs[idx])
    assert np.all(bs[~bl] == 0x3F)
    # BS dwell: consecutive normal frames step by whole 61,000-tick cycles
    # plus jitter well inside the corrector's tolerance (few outliers).
    cyc = CorrectConfig().cycle
    n = np.nonzero(~bl)[0]
    d = np.diff(clk[n]) % (1 << synth.CLK_BITS)
    off = (d + cyc // 2) % cyc - cyc // 2
    assert np.mean(np.abs(off) <= 2 * 450) > 0.98
    # UE sweeps ascend within a sweep group and reset between groups.
    assert detect_groups_np(ue).max() + 1 == 3
    assert np.all((0 <= ue) & (ue < 64)) and np.all(rss >= 1)


def test_planted_bs_truth_is_recovered_by_the_corrector(cap):
    res = correct_frames_np(cap.frames)
    kept = res.keep
    assert kept.sum() > 0.9 * np.sum(cap.frames[:, 0] == 0)
    np.testing.assert_array_equal(res.corrected_bs[kept], cap.true_bs[kept])


def test_planted_paths_dominate_the_intensity_grid(cap):
    """The strongest observed cell lies near the strongest planted path."""
    from slam_process_tpu.io.angles import BEAM_ANGLES_DEG
    from slam_process_tpu.ops.scene import intensity_grid_np

    f = correct_frames_np(cap.frames).filtered
    g = intensity_grid_np(f[:, 0], f[:, 1], f[:, 2])
    u, b = np.unravel_index(np.nanargmax(g.mean), g.mean.shape)
    strongest = int(np.argmax(cap.truth.gain[0]))
    assert abs(BEAM_ANGLES_DEG[u] - cap.truth.aoa[0, strongest]) < 3.0
    assert abs(BEAM_ANGLES_DEG[b] - cap.truth.aod[0, strongest]) < 3.0


def test_archive_shape_is_the_reference_archives():
    shape = synth.ARCHIVE_SHAPE
    assert len(shape) == 19
    assert sum(f for f, _ in shape) == 1_072_720
    assert min(f for f, _ in shape) == 18_630
    assert max(f for f, _ in shape) == 100_280
    assert {s for _, s in shape} >= {8, 58}


@pytest.mark.parametrize("n_frames, n_sweeps", [(18630, 8), (100280, 58)])
def test_archive_extremes_stay_inside_the_corrector_bounds(n_frames, n_sweeps):
    """The largest sweep groups and baseline counts of the archive's
    extreme captures fit the streaming corrector's default bounds."""
    c = synth.capture(n_sweeps, n_frames, n_sweeps)
    gid = detect_groups_np(c.frames[:, 1])
    assert gid.max() + 1 == n_sweeps <= 128
    assert np.bincount(gid[c.frames[:, 0] == 1]).max() <= 192
    assert np.bincount(gid).max() <= 8192


def test_capture_rejects_impossible_density():
    with pytest.raises(ValueError):
        synth.capture(0, 20000, 2)          # > 4096 slots per sweep


def test_angle_table_and_mapping_round_trip(tmp_path):
    from slam_process_tpu.io.angles import (
        BEAM_ANGLES_DEG,
        load_angle_lut,
        write_angle_map,
    )

    assert len(BEAM_ANGLES_DEG) == 64
    assert BEAM_ANGLES_DEG[0] == pytest.approx(-43.6)
    assert BEAM_ANGLES_DEG[-1] == pytest.approx(45.0)
    assert np.all(np.diff(BEAM_ANGLES_DEG) > 1.3)
    assert np.all(np.diff(BEAM_ANGLES_DEG) <= 1.5 + 1e-6)
    lut = load_angle_lut(write_angle_map(tmp_path / "map.xlsx"))
    np.testing.assert_allclose(lut, BEAM_ANGLES_DEG, atol=1e-6)


def test_write_capture_names_and_bytes(tmp_path):
    from slam_process_tpu.io import read_hex_log

    c = synth.capture(2, 2000, 1, name="Serial Debug 2026-03-01 101010.txt")
    p = synth.write_capture(tmp_path, c)
    assert p.name == c.name
    np.testing.assert_array_equal(read_hex_log(p), c.wire)
