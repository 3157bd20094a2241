"""Seeded capture generator: serial dumps with the testbed's wire format.

The engine's users feed it hex dumps of the 64x64-beam testbed's serial
link (11-byte v3 frames, SURVEY §2.1).  This module writes such dumps from
a seed, so every test, benchmark and on-device check has an input — and a
ground truth — without any file from outside the repository.

What a generated capture holds, and why (SURVEY §2.1, §2.8, §6):

* the v3 frame (FLAG/UE/BS/CLK x5/RSS x3 tag classes) written as
  whitespace-separated uppercase hex tokens, 16 per line, after the
  2-byte UTF-8 guillemet junk token every shipped dump opens with;
* the BS beam advancing one step every 61,000 CLK ticks (mod 64) with
  Gaussian tick jitter, and a few outlier frames whose jitter exceeds
  the corrector's +-500 tolerance (uncorrectable, dropped by the filter);
* UE sweeps 0..63 with each UE beam held for one full BS cycle, and each
  (UE, BS-step) slot reaching the log with the probability that gives
  the capture its frame count (lost frames on the serial link);
* FLAG=0xCC baseline frames (2-4% of frames) that repeat the previous
  frame's RSS and carry that frame's true BS index;
* broken frames: truncated frame prefixes directly followed by a whole
  frame, which force the decoder's byte resync but never decode;
* RSS drawn from a few planted paths through the estimators' own
  separable Gaussian beam model (models/dictionary.gaussian_beam, FWHM
  1.4 deg), drifting across sweeps, plus a noise floor — so estimators
  have real work and a known truth.  Captures of 8+ sweeps also plant one
  of each scene change the change detector reports: a path death and a
  birth at mid-capture, a 4-degree jump, and a LoS blockage on the last
  sweep.

``archive(seed)`` yields 19 captures with the reference archive's shape:
1,072,720 frames in all, 18,630-100,280 frames and 8-58 sweeps per capture
(BASELINE.md).  The archive publishes only the total, the extremes and a
few per-file counts (18,630; 28,313; 100,234; 100,280); the other
per-capture counts in ``ARCHIVE_SHAPE`` are assumed.  Every capture
stays inside the device corrector's static bounds (at most 58 sweep
groups and 4% baselines of at most ~3.9k frames per sweep).
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, List, NamedTuple, Tuple, Union

import numpy as np

from slam_process_tpu.config import CorrectConfig, DictionaryConfig
from slam_process_tpu.io.angles import BEAM_ANGLES_DEG

N_BEAMS = 64
CLK_BITS = 30
RSS_MAX = (1 << 18) - 1

#: (frames, sweeps) per capture of the reference archive's shape.
ARCHIVE_SHAPE: Tuple[Tuple[int, int], ...] = (
    (18630, 8), (28313, 10), (30137, 11), (41088, 14), (42565, 15),
    (43738, 15), (44821, 16), (44963, 16), (52036, 18), (53174, 19),
    (54999, 19), (60999, 21), (68497, 23), (69562, 24), (70765, 24),
    (73370, 25), (74549, 26), (100234, 30), (100280, 58),
)

_TOKEN_TEXT = np.frombuffer(
    b"".join(f"{v:02X} ".encode() for v in range(256)), np.uint8
).reshape(256, 3)
_JUNK_HEAD = "« ".encode("utf-8")      # the dumps' leading guillemet


class PlantedPaths(NamedTuple):
    """Ground truth: the paths each sweep's RSS was drawn from."""

    aoa: np.ndarray     # [S, P] deg (UE side)
    aod: np.ndarray     # [S, P] deg (BS side)
    gain: np.ndarray    # [S, P] linear RSS amplitude (0 = path absent)


class Capture(NamedTuple):
    name: str               # file name with a session timestamp
    wire: np.ndarray        # [N] uint8 byte stream (broken frames included)
    frames: np.ndarray      # [F, 5] int64 (flag, ue, bs, rss, clk) on the wire
    true_bs: np.ndarray     # [F] int64 the BS beam each frame was taken at
    truth: PlantedPaths

    def text(self) -> bytes:
        """The capture as the serial dump's hex text."""
        return to_text(self.wire)


def to_text(wire: np.ndarray) -> bytes:
    """Hex dump text: a junk head token, then ``"XX "`` tokens, 16 a line."""
    t = _TOKEN_TEXT[np.asarray(wire, np.uint8)].copy()
    t[15::16, 2] = ord("\n")
    return _JUNK_HEAD + t.tobytes()


def _encode(flag, ue, bs, rss, clk) -> np.ndarray:
    """[F] fields -> [F, 11] uint8 v3 frames."""
    f = np.empty((len(flag), 11), np.uint8)
    f[:, 0] = np.where(flag == 1, 0xCC, 0x33)
    f[:, 1] = ue & 0x3F
    f[:, 2] = 0xC0 | (bs & 0x3F)
    for k in range(5):
        f[:, 3 + k] = 0x40 | ((clk >> (6 * k)) & 0x3F)
    for k in range(3):
        f[:, 8 + k] = 0x80 | ((rss >> (6 * k)) & 0x3F)
    return f


def _sweep_sizes(rng, n_frames: int, n_sweeps: int) -> np.ndarray:
    w = rng.uniform(0.85, 1.15, n_sweeps)
    sizes = np.floor(w / w.sum() * n_frames).astype(np.int64)
    sizes[: n_frames - sizes.sum()] += 1
    return sizes


def _planted_paths(rng, n_sweeps: int, n_paths: int) -> PlantedPaths:
    lo, hi = float(BEAM_ANGLES_DEG[0]) + 6.0, float(BEAM_ANGLES_DEG[-1]) - 6.0
    # Paths start at least 12 deg apart (beyond the tracker's gate), so
    # each planted path is its own track.
    start = rng.uniform(lo, hi, (64, 2))
    keep = [0]
    for i in range(1, len(start)):
        if len(keep) == n_paths + 1:
            break
        if np.all(np.hypot(*(start[keep] - start[i]).T) > 12.0):
            keep.append(i)
    aoa0, aod0 = start[keep].T
    drift = rng.uniform(-0.15, 0.15, (2, len(keep)))       # deg per sweep
    s = np.arange(n_sweeps)[:, None]
    aoa = np.clip(aoa0 + drift[0] * s, lo, hi)
    aod = np.clip(aod0 + drift[1] * s, lo, hi)
    # One strong (LoS-like) path, the rest 6-14 dB below it.
    gain0 = 150_000.0 * np.concatenate(
        [[1.0], 10 ** (-rng.uniform(6, 14, len(keep) - 1) / 20)])
    gain = np.broadcast_to(gain0, (n_sweeps, len(keep))).copy()
    gain[:, n_paths:] = 0.0                 # the spare path starts absent
    if n_sweeps >= 8 and n_paths >= 3:
        # Scene changes for the change detector: the weakest path dies
        # and the spare one is born at mid-capture, the second path jumps
        # 4 deg three quarters in, and the strong path is blocked (-20 dB)
        # on the last sweep, handing dominance to the second path.
        mid, late = n_sweeps // 2, (3 * n_sweeps) // 4
        gain[mid:, n_paths - 1] = 0.0
        gain[mid:, n_paths] = gain0[n_paths - 1]
        aoa[late:, 1] = np.clip(aoa[late:, 1] + 4.0, lo, hi)
        gain[n_sweeps - 1, 0] *= 0.1
    return PlantedPaths(aoa, aod, gain)


def _mean_rss(truth: PlantedPaths, s: np.ndarray, ue: np.ndarray,
              bs: np.ndarray, floor: float) -> np.ndarray:
    from slam_process_tpu.models.dictionary import gaussian_beam

    width = DictionaryConfig().beam_width
    ang = BEAM_ANGLES_DEG.astype(np.float64)
    g_u = gaussian_beam(ang[ue][:, None], truth.aoa[s], width)    # [F, P]
    g_b = gaussian_beam(ang[bs][:, None], truth.aod[s], width)
    return floor + np.sum(truth.gain[s] * g_u * g_b, axis=1)


def capture(seed: int, n_frames: int, n_sweeps: int, *, name: str = None,
            n_paths: int = 3, broken_rate: float = 1e-3,
            outlier_rate: float = 5e-3) -> Capture:
    """One capture of ``n_frames`` valid frames over ``n_sweeps`` sweeps.

    ``n_frames`` counts every decodable frame, baseline markers included;
    broken frames come on top.  The same arguments give the same bytes.
    """
    cfg = CorrectConfig()
    per_sweep_max = N_BEAMS * N_BEAMS
    if not 0 < n_sweeps <= n_frames <= int(per_sweep_max * 1.02) * n_sweeps:
        raise ValueError(f"cannot fit {n_frames} frames in {n_sweeps} sweeps")
    rng = np.random.default_rng(seed)
    bl_rate = rng.uniform(0.02, 0.04)
    sizes = _sweep_sizes(rng, n_frames, n_sweeps)
    # Baselines per sweep: at least one, so every sweep can be corrected.
    n_bl = np.maximum(1, np.round(sizes * bl_rate).astype(np.int64))
    n_norm = sizes - n_bl
    if np.any(n_norm > per_sweep_max) or np.any(n_bl > n_norm):
        raise ValueError("sweep too dense for the 64x64 slot grid")

    # Normal frames: a sorted subset of each sweep's 4096 (UE, step) slots.
    slot_parts, sweep_parts = [], []
    for s in range(n_sweeps):
        slot_parts.append(np.sort(rng.choice(per_sweep_max, n_norm[s],
                                             replace=False)))
        sweep_parts.append(np.full(n_norm[s], s, np.int64))
    slot = np.concatenate(slot_parts)
    sweep = np.concatenate(sweep_parts)
    ue = slot // N_BEAMS
    step = sweep * per_sweep_max + slot            # global BS step index
    bs0 = int(rng.integers(N_BEAMS))
    true_bs = (bs0 + step) % N_BEAMS

    truth = _planted_paths(rng, n_sweeps, n_paths)
    mean = _mean_rss(truth, sweep, ue, true_bs, floor=2_000.0)
    noisy = mean * np.exp(rng.normal(0.0, 0.05, len(mean)))
    rss = np.clip(np.round(noisy + rng.normal(0.0, 40.0, len(mean))),
                  1, RSS_MAX).astype(np.int64)

    # Baselines follow randomly chosen normal frames (never two in a row,
    # never after an outlier) within each sweep.
    starts = np.concatenate([[0], np.cumsum(n_norm)[:-1]])
    bl_after = np.concatenate([
        st + np.sort(rng.choice(n, k, replace=False))
        for st, n, k in zip(starts, n_norm, n_bl)])
    is_anchor = np.zeros(len(slot), bool)
    is_anchor[bl_after] = True

    jitter = np.clip(np.round(rng.normal(0.0, 120.0, len(slot))), -450, 450)
    outlier = (rng.random(len(slot)) < outlier_rate) & ~is_anchor
    jitter[outlier] = (rng.choice([-1, 1], outlier.sum())
                       * rng.integers(cfg.tol + 100, 3 * cfg.tol, outlier.sum()))
    t0 = int(rng.integers(1 << CLK_BITS))
    clk = (t0 + step * cfg.cycle + jitter.astype(np.int64)) % (1 << CLK_BITS)

    # Interleave: each anchor frame is followed by its baseline marker.
    n_total = len(slot) + len(bl_after)
    pos = np.arange(len(slot)) + np.cumsum(is_anchor) - is_anchor
    bl_pos = pos[bl_after] + 1
    frames = np.zeros((n_total, 5), np.int64)
    tbs = np.zeros(n_total, np.int64)
    frames[pos] = np.stack([np.zeros_like(ue), ue,
                            np.full_like(ue, 0x3F), rss, clk], axis=1)
    tbs[pos] = true_bs
    bl_clk = (clk[bl_after] + rng.integers(200, 2000, len(bl_after))) % (
        1 << CLK_BITS)
    frames[bl_pos] = np.stack([np.ones_like(bl_after), ue[bl_after],
                               true_bs[bl_after], rss[bl_after], bl_clk],
                              axis=1)
    tbs[bl_pos] = true_bs[bl_after]

    # Broken frames: a 1..10-byte prefix of a random frame right before a
    # whole frame.  The next frame's UE byte (class 00) can never sit at a
    # prefix offset that needs class 00 except offset 1, so no window that
    # starts inside a prefix validates — the decoded table equals `frames`.
    enc = _encode(*(frames[:, i] for i in range(5)))
    n_broken = int(rng.binomial(n_total, broken_rate))
    before = np.sort(rng.choice(np.arange(1, n_total), n_broken, replace=False))
    cut = rng.integers(1, 11, n_broken)
    src = rng.integers(0, n_total, n_broken)
    pieces: List[np.ndarray] = []
    prev = 0
    for b, c, sidx in zip(before, cut, src):
        pieces.append(enc[prev:b].reshape(-1))
        pieces.append(enc[sidx, :c])
        prev = b
    pieces.append(enc[prev:].reshape(-1))
    wire = np.concatenate(pieces).astype(np.uint8)

    if name is None:
        name = f"Serial Debug 2026-01-01 {seed % 1_000_000:06d}.txt"
    return Capture(name, wire, frames, tbs, truth)


def archive(seed: int = 0) -> Iterator[Capture]:
    """The 19 captures of the reference archive's shape (~1.07 M frames)."""
    for i, (n_frames, n_sweeps) in enumerate(ARCHIVE_SHAPE):
        hhmmss = f"{(9 + i // 2) % 24:02d}{(i * 7) % 60:02d}{(seed * 13 + i) % 60:02d}"
        yield capture(seed * 1000 + i, n_frames, n_sweeps,
                      name=f"Serial Debug 2026-02-{1 + i:02d} {hhmmss}.txt")


def write_capture(directory: Union[str, Path], cap: Capture) -> Path:
    path = Path(directory) / cap.name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(cap.text())
    return path


#: Where :func:`default_archive` writes (inside the checkout, git-ignored).
DEFAULT_ARCHIVE_ROOT = Path(__file__).resolve().parents[2] / "build"


def default_archive(seed: int = 0) -> Tuple[Path, Path]:
    """``(data_dir, mapping)``: the archive written once under ``build/``.

    ``data_dir`` holds the 19 dumps and, for the first capture, its
    ``_filtered.xlsx`` table (the host corrector's output); ``mapping`` is
    the built-in beam-angle table as a mapping ``.xlsx``.
    """
    from slam_process_tpu.io.angles import write_angle_map
    from slam_process_tpu.io.schemas import write_filtered_table
    from slam_process_tpu.ops.correct import correct_frames_np

    directory = DEFAULT_ARCHIVE_ROOT / f"archive-seed{seed}"
    mapping = directory / "beam_angle.xlsx"
    done = directory / ".complete"
    if not done.exists():
        for i, cap in enumerate(archive(seed)):
            write_capture(directory, cap)
            if i == 0:
                write_filtered_table(
                    directory / f"{cap.name[:-4]}_filtered.xlsx",
                    correct_frames_np(cap.frames).filtered)
        write_angle_map(mapping)
        done.touch()
    return directory, mapping
