"""Batched multi-session pipeline with mesh sharding.

BASELINE.json's "batched session" config: all debugDoc logs decoded +
corrected + rendered in one device program.  Sessions are padded to a
common byte capacity and stacked to [S, N]; the whole per-session pipeline
is vmapped over S and sharded across the ``data`` mesh axis, with the
intensity/raster outputs sharding constrained so XLA keeps everything local
until the (tiny) global statistics, which reduce across devices.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence

import numpy as np

from slam_process_tpu.ops.decode import frame_capacity
from slam_process_tpu.pipeline.device import pad_bytes, session_pipeline


class SessionSummaryOut(NamedTuple):
    """Per-session results without the [S, capacity] frame tensors."""

    n_frames: "np.ndarray"          # [S] i32
    correct_overflow: "np.ndarray"  # [S] bool
    n_kept: "np.ndarray"            # [S] i32
    mean_grid: "np.ndarray"         # [S, 64, 64] f32
    counts: "np.ndarray"            # [S, 64, 64] i32
    rgba: "np.ndarray"              # [S, 64, 64, 4] f32
    blurred: "np.ndarray"           # [S, 64, 64] f32
    norm_t: "np.ndarray"            # [S, 64, 64] f32


@functools.lru_cache(maxsize=32)
def batched_session_pipeline(
    mesh,
    n_bytes_padded: int,
    blur_sigma: float = 1.0,
    use_log: bool = True,
    # ~2x the dataset's measured maxima (58 groups/log, 93 baselines/
    # group) — the old 64/128 defaults left 10%/38% headroom against the
    # corrector's silent-truncation overflow (same audit that resized the
    # streaming session's bounds in round 4; see streaming_device.py).
    max_groups: int = 128,
    max_baselines_per_group: int = 192,
    outputs: str = "full",
    session_axis: str = "vmap",
):
    """Build a jitted [S, N]-batched pipeline sharded over mesh axis 'data'.

    Cached per (mesh, bucket, config): a fresh ``jax.jit`` object per call
    would retrace on every invocation even at repeated shapes (the
    per-bucket grouped runner calls this once per bucket per call).

    Returns fn(byte_batch[S, N] u8, n_bytes[S] i32, lut[256,4] f32) ->
    DeviceSessionOut with a leading S axis on every field.

    ``session_axis='scan'`` maps the per-session body over S with
    ``lax.map`` instead of ``vmap``: the compiled code is single-session
    sized regardless of S (on the 19-log archive the vmapped executable
    serializes to ~49 MB), at the cost of strictly sequential
    per-session execution.  On a mesh keep ``vmap``, whose leading axis
    shards over 'data' with no cross-step sequencing.

    ``outputs='summary'`` drops the [S, capacity] per-frame tensors
    (frames/keep/corrected_bs) from the return value, keeping only the
    per-session grids/rasters/scalars: a resident hot loop returns only
    what it consumes.
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    cap = frame_capacity(n_bytes_padded)
    body = functools.partial(
        session_pipeline,
        capacity=cap,
        blur_sigma=blur_sigma,
        use_log=use_log,
        max_groups=max_groups,
        max_baselines_per_group=max_baselines_per_group,
    )
    if outputs not in ("full", "summary"):
        raise ValueError(f"outputs must be 'full' or 'summary', got {outputs!r}")
    if session_axis not in ("vmap", "scan"):
        raise ValueError(
            f"session_axis must be 'vmap' or 'scan', got {session_axis!r}")

    def batched(byte_batch, n_bytes, lut):
        if session_axis == "scan":
            out = jax.lax.map(lambda a: body(a[0], a[1], lut),
                              (byte_batch, n_bytes))
        else:
            out = jax.vmap(body, in_axes=(0, 0, None))(byte_batch, n_bytes, lut)
        # Keep per-session tensors sharded over 'data' end to end.
        out = jax.tree.map(
            lambda x: jax.lax.with_sharding_constraint(
                x, NamedSharding(mesh, P("data", *([None] * (x.ndim - 1))))
            ),
            out,
        )
        if outputs == "summary":
            return SessionSummaryOut(
                n_frames=out.n_frames,
                correct_overflow=out.correct_overflow,
                n_kept=out.n_kept,
                mean_grid=out.mean_grid,
                counts=out.counts,
                rgba=out.rgba,
                blurred=out.blurred,
                norm_t=out.norm_t,
            )
        return out

    from slam_process_tpu.utils.cache import enable_persistent_cache
    enable_persistent_cache()
    if mesh.devices.size == 1:
        # Single device: every sharding is equivalent — let jit take the
        # inputs as they come.
        return jax.jit(batched)
    in_shardings = (
        NamedSharding(mesh, P("data", None)),
        NamedSharding(mesh, P("data")),
        NamedSharding(mesh, P()),
    )
    return jax.jit(batched, in_shardings=in_shardings)


def stack_sessions(raw_list: Sequence[np.ndarray], n_bytes_padded: Optional[int] = None):
    """Stack tokenized sessions into a padded [S, N] u8 batch + lengths."""
    if n_bytes_padded is None:
        n_bytes_padded = max(len(r) for r in raw_list)
    batch = np.stack([pad_bytes(r, n_bytes_padded) for r in raw_list])
    lengths = np.asarray([len(r) for r in raw_list], dtype=np.int32)
    return batch, lengths


def run_dataset_batched_grouped(
    mesh,
    raw_list: Sequence[np.ndarray],
    quantum: int = 1 << 18,
    **pipeline_kwargs,
):
    """The batched multi-chip layout WITHOUT uniform-padding waste.

    ``batched_session_pipeline`` pads every session to the dataset max
    (2.6x the real bytes on the reference dataset — every per-frame stage
    scales with the padded length).  Here sessions group by their byte
    bucket (pipeline.device.bucket_size), each group padded to a multiple
    of the mesh's 'data'-axis size with empty sessions (zero bytes decode
    to zero frames), and one sharded batched program runs per bucket —
    the same data-parallel layout at per-session padding cost.

    Returns ``[(indices, SessionSummaryOut), ...]`` — one entry per
    bucket group, each output carrying a leading S axis whose first
    ``len(indices)`` rows are the sessions at those input positions
    (trailing rows are the empty padding sessions).  Dispatches are
    async and the outputs stay on device: eagerly slicing a sharded
    output per session would dispatch a gather per leaf, so callers
    split after their own ``device_get``.
    """
    from slam_process_tpu.ops.raster import colormap_lut
    from slam_process_tpu.pipeline.device import bucket_size

    import jax.numpy as jnp

    dp = mesh.shape.get("data", 1)
    groups: dict = {}
    for i, r in enumerate(raw_list):
        groups.setdefault(bucket_size(len(r), quantum), []).append(i)

    lut = jnp.asarray(colormap_lut("viridis"))
    results = []
    for bucket, idxs in sorted(groups.items()):
        sessions = [raw_list[i] for i in idxs]
        pad_n = (-len(sessions)) % dp
        sessions = sessions + [np.zeros(0, np.uint8)] * pad_n
        batch, lengths = stack_sessions(sessions, bucket)
        fn = batched_session_pipeline(mesh, bucket, outputs="summary",
                                      **pipeline_kwargs)
        results.append((idxs, fn(batch, lengths, lut)))
    return results


def run_dataset(mesh, raw_list: Sequence[np.ndarray], **pipeline_kwargs):
    """Convenience consumer for the grouped multi-chip layout: run every
    session through the per-bucket sharded programs, do ONE device_get of
    the padded bucket outputs, and return per-session
    ``SessionSummaryOut`` namedtuples in input order.

    This is the production entry point for "process this whole dataset on
    the mesh" — ``run_dataset_batched_grouped`` stays the low-level form
    for callers that want to keep results on device (e.g. bench's
    device-plane windows); the splitting here happens host-side after the
    single transfer, so no per-leaf gathers dispatch.
    """
    import jax

    grouped = run_dataset_batched_grouped(mesh, raw_list, **pipeline_kwargs)
    host = jax.device_get([out for _idxs, out in grouped])
    results: list = [None] * len(raw_list)
    for (idxs, _), out in zip(grouped, host):
        for row, orig in enumerate(idxs):
            results[orig] = jax.tree.map(lambda x: x[row], out)
    bad = [i for i, r in enumerate(results) if bool(r.correct_overflow)]
    if bad:
        import warnings

        warnings.warn(
            f"corrector capacity exceeded on sessions {bad}: their rows "
            "were silently truncated — re-run with larger max_groups/"
            "max_baselines_per_group", RuntimeWarning, stacklevel=2)
    return results
