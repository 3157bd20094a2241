"""Data-parallel frame decoder for the 11-byte v3 wire format.

The reference decodes with a sequential byte cursor + 1-byte resync
(serial_hex_to_excel_v3.py:41-103): at position i, if byte[i] is a flag
(0xCC/0x33) and the next 10 bytes carry the right 2-bit tag classes
(UE=00, BS=11, CLK x5=01, RSS x3=10) a frame is emitted and the cursor
jumps +11; otherwise it advances +1.

Parallel formulation — a theorem about this wire format makes the greedy
resync embarrassingly parallel:

    Two valid frame starts can never be closer than 11 bytes.

Proof sketch: suppose ok[i] and ok[j] with 0 < j-i < 11.  Frame i fixes the
tag class of byte j: offsets 1..10 have classes (00,11,01,01,01,01,01,10,
10,10).  ok[j] needs byte j to be 0xCC (class 11) or 0x33 (class 00), so
only offsets 1 (0x33) or 2 (0xCC) are candidates; but then frame j's UE byte
(offset j+1) lands on a byte frame i constrains to class 11 (for j=i+1) or
01 (for j=i+2) while UE requires class 00 — contradiction.  Hence valid
starts are >=11 apart, the greedy cursor reaches every one of them, and

    emitted frames == ALL positions with a fully valid 11-byte window.

So the decode is one vectorized mask + gather — no scan, no DFA carry.  The
numpy path below additionally reproduces the reference's discard counter and
truncated-tail break semantics exactly; the JAX path is the device kernel
(static shapes, frame-capacity padding) used by the batched/streaming
pipelines.  tests/test_decode.py asserts mask==greedy on every shipped log.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

from slam_process_tpu.config import DecodeConfig

_DEFAULT = DecodeConfig()

# Tag classes for frame offsets 1..10 (UE, BS, CLK x5, RSS x3).
_OFFSET_TAGS = (0b00, 0b11, 0b01, 0b01, 0b01, 0b01, 0b01, 0b10, 0b10, 0b10)


def frame_start_mask(b: np.ndarray, cfg: DecodeConfig = _DEFAULT) -> np.ndarray:
    """Vectorized validity mask: ok[i] == frame starts at byte i.

    Positions within 10 bytes of the end are always False (a full frame
    does not fit).
    """
    b = np.asarray(b, dtype=np.uint8)
    n = b.shape[0]
    ok = (b == cfg.flag_true) | (b == cfg.flag_false)
    top = (b >> 6).astype(np.uint8)
    for d, tag in enumerate(_OFFSET_TAGS, start=1):
        m = max(n - d, 0)  # buffers shorter than the frame are all-False
        shifted = np.zeros(n, dtype=bool)
        shifted[:m] = top[d : d + m] == tag
        ok &= shifted
    return ok


def extract_fields(b: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """Gather frame fields at the given start indices.

    Returns frames[F, 5] int64: (FLAG, UE, BS, RSS, CLK).
    CLK is five little-endian 6-bit limbs -> 30-bit counter
    (serial_hex_to_excel_v3.py:93-95); RSS is three limbs -> 18 bits (:97).
    """
    b = np.asarray(b, dtype=np.int64)
    w = b[starts[:, None] + np.arange(11)]
    flag = (w[:, 0] == _DEFAULT.flag_true).astype(np.int64)
    ue = w[:, 1] & 0x3F
    bs = w[:, 2] & 0x3F
    clk = np.zeros(len(starts), dtype=np.int64)
    for k in range(5):
        clk |= (w[:, 3 + k] & 0x3F) << (6 * k)
    rss = (w[:, 8] & 0x3F) | ((w[:, 9] & 0x3F) << 6) | ((w[:, 10] & 0x3F) << 12)
    return np.stack([flag, ue, bs, rss, clk], axis=1)


class DecodeResult(NamedTuple):
    frames: np.ndarray      # [F, 5] int64 (flag, ue, bs, rss, clk)
    valid: int              # == F
    discarded: int          # reference-parity discard counter


def decode_frames_np(b: np.ndarray, cfg: DecodeConfig = _DEFAULT) -> DecodeResult:
    """Host (numpy) decode with exact reference counter semantics.

    The discard counter counts cursor-visited flag bytes that fail the tag
    checks; a visited flag byte within 10 bytes of the end counts once and
    stops the parse (serial_hex_to_excel_v3.py:53-57 'break').  Visited ==
    not covered by an emitted frame (see module docstring).
    """
    b = np.asarray(b, dtype=np.uint8)
    n = b.shape[0]
    ok = frame_start_mask(b, cfg)
    starts = np.nonzero(ok)[0]
    frames = extract_fields(b, starts) if starts.size else np.zeros((0, 5), np.int64)

    # --- reference-parity discard counting (host only, cheap) -------------
    isflag = (b == cfg.flag_true) | (b == cfg.flag_false)
    covered = np.zeros(n + 1, dtype=np.int32)
    if starts.size:
        covered[starts] += 1
        covered[np.minimum(starts + cfg.frame_len, n)] -= 1
    visited = np.cumsum(covered[:n]) == 0
    visited_flags = isflag & visited
    # Truncated tail: the FIRST visited flag with < frame_len bytes left
    # counts one discard and breaks the loop.
    tail_lo = max(n - cfg.frame_len + 1, 0)
    tail_hits = np.nonzero(visited_flags[tail_lo:])[0]
    if tail_hits.size:
        break_at = tail_lo + tail_hits[0]
        discarded = int(np.count_nonzero(visited_flags[:break_at] & ~ok[:break_at])) + 1
    else:
        discarded = int(np.count_nonzero(visited_flags & ~ok))
    return DecodeResult(frames, int(starts.size), discarded)


def decode_frames_greedy_np(
    b: np.ndarray, cfg: DecodeConfig = _DEFAULT
) -> DecodeResult:
    """Literal sequential-cursor decode (slow; oracle for equivalence tests)."""
    b = np.asarray(b, dtype=np.uint8)
    n = b.shape[0]
    ok = frame_start_mask(b, cfg)
    isflag = (b == cfg.flag_true) | (b == cfg.flag_false)
    starts = []
    discarded = 0
    i = 0
    while i < n:
        if not isflag[i]:
            i += 1
            continue
        if i + cfg.frame_len > n:
            discarded += 1
            break
        if ok[i]:
            starts.append(i)
            i += cfg.frame_len
        else:
            discarded += 1
            i += 1
    starts = np.asarray(starts, dtype=np.int64)
    frames = extract_fields(b, starts) if starts.size else np.zeros((0, 5), np.int64)
    return DecodeResult(frames, len(starts), discarded)


# ---------------------------------------------------------------------------
# JAX / device path
# ---------------------------------------------------------------------------
#
# The obvious formulation is nonzero() over all byte positions + an 11-wide
# window gather per frame.  The >=11-spacing theorem gives a gather-free
# formulation instead:
#
#     a block of 11 consecutive byte positions contains AT MOST ONE valid
#     frame start (two starts are >= 11 apart),
#
# so reshaping the position axis to [R, 11] rows makes per-row reduction
# (sum of per-position field values masked by ok) extract every frame with
# pure vector ops.  Frame fields are computed AT EVERY POSITION first via
# 10 static shifted slices (elementwise, memory-rate).  decode_rows_jax returns this
# masked-row layout [R, 5] + valid[R]; decode_frames_jax densifies it with
# one [capacity]-row compaction gather for callers that need the packed
# table.
#
# The per-row reduction itself is NOT done with a [N] -> [R, 11] reshape:
# 11 does not divide a 128-lane register tile, so that reshape can be a
# cross-lane retiling copy.  Instead the masked field values are
# packed into FOUR <=18-bit integer channels, the position axis is padded
# to a multiple of 1408 = 11 * 128 (the same layout trick as the
# tokenizer's [*, 384] deinterleave), and the per-row sums become ONE
# constant [1408, 128] block-diagonal matmul.  (Not yet measured against a
# plain reshape-sum on the GPU — ROADMAP A7.)  Exactness: every channel
# value is an integer <= 2^18 (f32-exact), the weights are {0, 1}, and
# each 11-block holds at most one valid start (the spacing theorem), so
# each output element is a sum of ONE exact product — HIGHEST precision
# keeps the product from rounding through bf16 or TF32.


def decode_rows_jax(
    b,  # jnp.ndarray uint8 [N]
    cfg: DecodeConfig = _DEFAULT,
    n_valid=None,  # optional jnp scalar: only b[:n_valid] holds real bytes
) -> Tuple:
    """Gather-free jittable decode to the masked-row layout.

    Returns (rows[R, 5] int32, valid[R] bool, count int32) with
    R = ceil(N / 11): row r holds the frame starting in byte block
    [11r, 11r+11) if any (``valid[r]``), zeros otherwise.  Frames appear
    in stream order with gaps; all downstream stages that process frames
    positionally with a validity mask (ops.correct.correct_rows_jax,
    scene scatter) consume this directly — no compaction gather at all.

    ``n_valid`` masks decode to frames that lie fully inside
    ``b[:n_valid]`` (start positions with ``p + frame_len > n_valid`` are
    rejected), for callers whose padding bytes are not inert.
    """
    import jax
    import jax.numpy as jnp

    b = b.astype(jnp.uint8)
    n = b.shape[0]
    ok = (b == cfg.flag_true) | (b == cfg.flag_false)
    top = (b >> 6).astype(jnp.uint8)
    pad_top = jnp.concatenate([top, jnp.full((10,), 255, dtype=jnp.uint8)])
    for d, tag in enumerate(_OFFSET_TAGS, start=1):
        ok = ok & (jax_slice(pad_top, d, n) == tag)
    if n_valid is not None:
        ok = ok & (jnp.arange(n) + cfg.frame_len <= n_valid)

    # Per-position field values from static shifted slices (no gathers).
    pad_b = jnp.concatenate([b, jnp.zeros((10,), dtype=jnp.uint8)])
    sh = [b.astype(jnp.int32)] + [
        jax_slice(pad_b, d, n).astype(jnp.int32) for d in range(1, 11)
    ]
    flag_v = (b == cfg.flag_true).astype(jnp.int32)
    ue_v = sh[1] & 0x3F
    bs_v = sh[2] & 0x3F
    clk_v = (
        (sh[3] & 0x3F)
        | ((sh[4] & 0x3F) << 6)
        | ((sh[5] & 0x3F) << 12)
        | ((sh[6] & 0x3F) << 18)
        | ((sh[7] & 0x3F) << 24)
    )
    rss_v = (sh[8] & 0x3F) | ((sh[9] & 0x3F) << 6) | ((sh[10] & 0x3F) << 12)

    # Row reduction: <= 1 valid start per 11-position row, so a masked sum
    # per row IS the frame (zeros when the row has no start).  Done as one
    # block-diagonal matmul in a lane-aligned [M, 1408] layout — see the
    # module comment above for the layout/exactness argument.
    r = -(-n // 11)
    oki = ok.astype(jnp.int32)
    packed_v = (oki << 14) | (flag_v << 12) | (ue_v << 6) | bs_v   # <= 2^15
    chans = jnp.stack(
        [
            packed_v * oki,
            rss_v * oki,                    # <= 2^18
            (clk_v & 0x7FFF) * oki,         # clk low limb,  <= 2^15
            (clk_v >> 15) * oki,            # clk high limb, <= 2^15
        ]
    )
    m_blocks = -(-n // 1408)
    np_pos = m_blocks * 1408
    if np_pos != n:
        chans = jnp.pad(chans, ((0, 0), (0, np_pos - n)))
    x = chans.reshape(4, m_blocks, 1408).astype(jnp.float32)
    jj = np.arange(1408)
    bd = np.zeros((1408, 128), np.float32)
    bd[jj, jj // 11] = 1.0
    out = jnp.einsum(
        "cmj,jk->cmk",
        x,
        jnp.asarray(bd),
        precision=jax.lax.Precision.HIGHEST,
    )
    out = out.reshape(4, m_blocks * 128)[:, :r].astype(jnp.int32)
    packed, rss_r, clk_lo, clk_hi = out[0], out[1], out[2], out[3]
    rows = jnp.stack(
        [
            (packed >> 12) & 1,
            (packed >> 6) & 0x3F,
            packed & 0x3F,
            rss_r,
            clk_lo | (clk_hi << 15),
        ],
        axis=1,
    )
    valid = (packed >> 14) == 1
    count = jnp.sum(oki)
    return rows, valid, count


def decode_frames_jax(
    b,  # jnp.ndarray uint8 [N]
    capacity: int,
    cfg: DecodeConfig = _DEFAULT,
    n_valid=None,  # optional jnp scalar: only b[:n_valid] holds real bytes
) -> Tuple:
    """Jittable decode: byte tensor -> densely packed frame tensor.

    Returns (frames[capacity, 5] int32, count int32).  Rows past ``count``
    are zero-filled; ``capacity`` must be static (N // 11 + 1 always fits by
    the >=11-spacing theorem).  Built on decode_rows_jax + one compaction
    gather of [capacity] 5-field rows (11x fewer gathered elements than the
    original per-position formulation; prefer the rows layout itself where
    the consumer can take a validity mask).
    """
    import jax.numpy as jnp

    rows, valid, count = decode_rows_jax(b, cfg=cfg, n_valid=n_valid)
    r = rows.shape[0]
    starts_row = jnp.nonzero(valid, size=capacity, fill_value=r)[0]
    rows_pad = jnp.concatenate([rows, jnp.zeros((1, 5), jnp.int32)])
    frames = rows_pad[starts_row]
    return frames, count


def jax_slice(padded, d: int, n: int):
    """padded[d : d + n] with a static window (helper for shifted compares)."""
    import jax.lax as lax

    return lax.dynamic_slice_in_dim(padded, d, n)


def frame_capacity(n_bytes: int, cfg: DecodeConfig = _DEFAULT) -> int:
    """Static frame-count upper bound for a byte-stream length."""
    return n_bytes // cfg.frame_len + 1
