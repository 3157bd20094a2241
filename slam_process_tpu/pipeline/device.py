"""The fused on-device session pipeline: bytes -> frames -> filtered ->
intensity -> raster, as one jittable function.

This is the engine's hot path (BASELINE.json "batched session" /
"streaming replay" configs): the only host work is file I/O and hex
tokenization; everything from the byte tensor onward happens on device with
static shapes.  One compiled executable serves every log via byte-capacity
bucketing.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

from slam_process_tpu.config import CorrectConfig, DecodeConfig, SceneConfig
from slam_process_tpu.ops.correct import correct_rows_jax
from slam_process_tpu.ops.decode import decode_rows_jax, frame_capacity
from slam_process_tpu.ops.raster import colormap_lut


class DeviceSessionOut(NamedTuple):
    frames: "np.ndarray"        # [R, 5] i32 MASKED-ROW layout (see below)
    frame_valid: "np.ndarray"   # [R] bool: which rows hold real frames
    n_frames: "np.ndarray"      # scalar i32 (== frame_valid.sum())
    corrected_bs: "np.ndarray"  # [R] i32
    keep: "np.ndarray"          # [R] bool
    correct_overflow: "np.ndarray"  # scalar bool: static bounds exceeded
    n_kept: "np.ndarray"        # scalar i32
    mean_grid: "np.ndarray"     # [64, 64] f32 UE-major (NaN empty)
    counts: "np.ndarray"        # [64, 64] i32
    rgba: "np.ndarray"          # [64, 64, 4] f32 AoD x AoA raster
    blurred: "np.ndarray"       # [64, 64] f32
    norm_t: "np.ndarray"        # [64, 64] f32 normalized (pre-colormap) raster

    # Masked-row layout: row r carries the frame whose start byte lies in
    # block [11r, 11r+11) if any (frame_valid[r]); frames appear in stream
    # order with gaps.  This is decode_rows_jax's gather-free output — the
    # dense [:n_frames] packing would cost a [cap]-row compaction gather
    # per session; hosts compact
    # with frames[frame_valid] when they need the packed table.


def session_pipeline(
    byte_tensor,            # jnp [N] uint8 (padded with non-flag bytes)
    n_bytes,                # jnp scalar i32 (unused: padding is inert)
    lut,                    # jnp [256, 4] f32 colormap LUT
    *,
    capacity: int,          # kept for bucket identity; rows layout is N/11

    blur_sigma: float = 1.0,
    use_log: bool = True,
    log_transform_scene: bool = False,
    max_groups: int = 256,
    max_baselines_per_group: int = 256,
    decode_cfg: DecodeConfig = DecodeConfig(),
    correct_cfg: CorrectConfig = CorrectConfig(),
) -> DeviceSessionOut:
    """Full per-session pipeline body (jit/shard_map-able).

    Padding discipline: pad the byte tensor with 0x00 (never a flag byte),
    so padded regions decode to nothing.
    """
    import jax.numpy as jnp

    from slam_process_tpu.ops.scene import fill_grid, intensity_grid_jax

    frames, valid, count = decode_rows_jax(byte_tensor, cfg=decode_cfg)
    corrected_bs, keep, overflow = correct_rows_jax(
        frames, valid, max_groups=max_groups,
        max_baselines_per_group=max_baselines_per_group, cfg=correct_cfg,
    )

    scene_cfg = SceneConfig(keep_nan=True, fill_with_min=False,
                            log_transform=log_transform_scene)
    grid = intensity_grid_jax(
        frames[:, 1], corrected_bs, frames[:, 3].astype(jnp.float32), keep,
        cfg=scene_cfg,
    )
    # Raster in AoD x AoA orientation (BS rows), as excel_heatmap does.
    from slam_process_tpu.ops.raster import (
        apply_colormap_float,
        blur_nan_aware_jax,
        linear_norm,
        shifted_log_norm,
    )

    matrix = fill_grid(grid, scene_cfg).T
    blurred = blur_nan_aware_jax(matrix, blur_sigma)
    norm_t = shifted_log_norm(blurred) if use_log else linear_norm(blurred)
    rgba = apply_colormap_float(norm_t, lut)
    return DeviceSessionOut(
        frames=frames,
        frame_valid=valid,
        n_frames=count,
        corrected_bs=corrected_bs,
        keep=keep,
        correct_overflow=overflow,
        n_kept=jnp.sum(keep.astype(jnp.int32)),
        mean_grid=grid.mean,
        counts=grid.counts,
        rgba=rgba,
        blurred=blurred,
        norm_t=norm_t,
    )


@functools.lru_cache(maxsize=32)
def compiled_session_pipeline(n_bytes_padded: int, blur_sigma: float = 1.0,
                              use_log: bool = True, max_groups: int = 256,
                              max_baselines_per_group: int = 256):
    """A jitted pipeline for one byte-capacity bucket.

    ``max_groups``/``max_baselines_per_group`` are the corrector's static
    capacity bounds; the corrector's [F, Bmax] score planes scale with
    them, so callers that know their data (bench: the dataset maxes at 58
    groups / 93 baselines) pass tight bounds.  Overflow is flagged in the
    output and Session falls back to the host path."""
    import jax

    cap = frame_capacity(n_bytes_padded)
    fn = functools.partial(session_pipeline, capacity=cap,
                           blur_sigma=blur_sigma, use_log=use_log,
                           max_groups=max_groups,
                           max_baselines_per_group=max_baselines_per_group)
    from slam_process_tpu.utils.cache import enable_persistent_cache
    enable_persistent_cache()
    return jax.jit(fn)


def pad_bytes(raw: np.ndarray, target: int) -> np.ndarray:
    """Pad a byte stream to a bucket size with inert (non-flag) bytes."""
    out = np.zeros(target, dtype=np.uint8)
    out[: len(raw)] = raw
    return out


def bucket_size(n: int, quantum: int = 1 << 18) -> int:
    """Round a byte length up to a bucket to bound recompilation count.

    Every per-frame stage (decode row reduction, corrector score planes)
    scales with the PADDED length, so the quantum trades padding waste
    against executable count: at 256 KiB the reference dataset pads 1.23x
    across 5 compiled shapes (1 MiB padded 1.84x across 2 — measured 33%
    of the pass's device time); the persistent compilation cache makes the
    extra executables a one-time cost."""
    return ((n + quantum - 1) // quantum) * quantum


# ---------------------------------------------------------------------------
# Text-ingest path: raw LOG TEXT is the only host->device traffic; the
# stride-3 tokenizer (ops/tokenize.py) fuses into the same jit program as
# decode+correct+render, so no host core tokenizes.
# ---------------------------------------------------------------------------


class TextSessionOut(NamedTuple):
    out: DeviceSessionOut
    tokenize_regular: "np.ndarray"  # scalar bool: stride-3 proof flag held
    n_tokens: "np.ndarray"          # scalar i32


def session_pipeline_from_text(
    text_tensor,            # jnp [M] uint8, M % 3 == 0, whitespace-padded
    n_text,                 # jnp scalar i32: real body byte count
    lut,                    # jnp [256, 4] f32 colormap LUT
    *,
    capacity: int,
    blur_sigma: float = 1.0,
    use_log: bool = True,
    log_transform_scene: bool = False,
    max_groups: int = 256,
    max_baselines_per_group: int = 256,
    decode_cfg: DecodeConfig = DecodeConfig(),
    correct_cfg: CorrectConfig = CorrectConfig(),
) -> TextSessionOut:
    """Fused text -> raster pipeline body (jit-able).

    The caller must have established the stride3_offset precondition (no
    valid token before the body, body starts a token run); the returned
    ``tokenize_regular`` flag certifies the on-device half of the
    equivalence proof.  Results are only trustworthy when it is True —
    run_session_from_text re-runs via the host tokenizer otherwise.
    """
    from slam_process_tpu.ops.tokenize import tokenize_stride3_jax

    b, n_tok, regular = tokenize_stride3_jax(text_tensor, n_text)
    out = session_pipeline(
        b, n_tok, lut, capacity=capacity, blur_sigma=blur_sigma,
        use_log=use_log, log_transform_scene=log_transform_scene,
        max_groups=max_groups,
        max_baselines_per_group=max_baselines_per_group,
        decode_cfg=decode_cfg, correct_cfg=correct_cfg,
    )
    return TextSessionOut(out=out, tokenize_regular=regular, n_tokens=n_tok)


@functools.lru_cache(maxsize=32)
def compiled_text_session_pipeline(n_text_padded: int, blur_sigma: float = 1.0,
                                   use_log: bool = True, max_groups: int = 256,
                                   max_baselines_per_group: int = 256):
    """A jitted text-ingest pipeline for one text-capacity bucket."""
    import jax

    cap = frame_capacity(n_text_padded // 3)
    fn = functools.partial(session_pipeline_from_text, capacity=cap,
                           blur_sigma=blur_sigma, use_log=use_log,
                           max_groups=max_groups,
                           max_baselines_per_group=max_baselines_per_group)
    from slam_process_tpu.utils.cache import enable_persistent_cache
    enable_persistent_cache()
    return jax.jit(fn)


def run_session_from_text(data: bytes, blur_sigma: float = 1.0,
                          use_log: bool = True, max_groups: int = 256,
                          max_baselines_per_group: int = 256,
                          check: bool = True):
    """Raw log file contents -> device pipeline outputs via device tokenize.

    Host work is limited to the O(head) stride3_offset scan and one padded
    buffer copy.  With ``check=True`` (the default) the stride-proof flag
    is read and an irregular stream transparently re-runs through the host
    tokenizer path — callers get correct results either way.  Performance
    paths (bench) pass ``check=False`` and audit the flags in batch.

    Returns TextSessionOut; when the host fallback was taken,
    ``tokenize_regular`` is a host-side False and ``out`` comes from
    run_session_on_device.
    """
    import jax.numpy as jnp

    from slam_process_tpu.ops.tokenize import (
        prepare_text, stride3_offset, text_bucket,
    )

    def _fallback():
        from slam_process_tpu.io.hexlog import tokenize_hex

        raw = tokenize_hex(data)
        out = run_session_on_device(
            raw, blur_sigma, use_log, max_groups, max_baselines_per_group)
        return TextSessionOut(out=out,
                              tokenize_regular=np.asarray(False),
                              n_tokens=np.asarray(len(raw), np.int32))

    p = stride3_offset(data)
    if p is None:
        return _fallback()
    text, n_text = prepare_text(data, p, text_bucket(len(data) - p))
    fn = compiled_text_session_pipeline(len(text), blur_sigma, use_log,
                                        max_groups, max_baselines_per_group)
    lut = jnp.asarray(colormap_lut("viridis"))
    res = fn(jnp.asarray(text), jnp.int32(n_text), lut)
    if check and not bool(res.tokenize_regular):
        return _fallback()
    return res


def run_session_on_device(raw_bytes: np.ndarray, blur_sigma: float = 1.0,
                          use_log: bool = True, max_groups: int = 256,
                          max_baselines_per_group: int = 256,
                          ) -> DeviceSessionOut:
    """Convenience host wrapper: tokenized bytes -> device pipeline outputs."""
    import jax.numpy as jnp

    n = bucket_size(len(raw_bytes))
    fn = compiled_session_pipeline(n, blur_sigma, use_log, max_groups,
                                   max_baselines_per_group)
    lut = jnp.asarray(colormap_lut("viridis"))
    padded = jnp.asarray(pad_bytes(raw_bytes, n))
    return fn(padded, jnp.int32(len(raw_bytes)), lut)
